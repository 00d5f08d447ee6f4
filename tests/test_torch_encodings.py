"""Parity: the port's SE(2) Fourier encoding and its projection kernel's
plain version against the JAX reference, on the CPU.

Tolerance atol 1e-5 / rtol 1e-4 in float32 (the reference's own kernel
tolerance, tests/test_kernels.py): both sides run the same f32 formulas,
and only the libraries' sin/cos and summation order differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import encodings as jenc  # noqa: E402
from repro.core import fourier as jfourier  # noqa: E402
from repro.kernels.se2_project import se2_fourier_project as jax_project  # noqa: E402
from repro_torch.core import encodings as tenc  # noqa: E402
from repro_torch.core import fourier as tfourier  # noqa: E402
from repro_torch.kernels import se2_project as tproj  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)

ENCS = {
    "hd6_F8": dict(head_dim=6, num_terms=8),
    "hd12_F18": dict(head_dim=12, num_terms=18),
    "hd24_F12": dict(head_dim=24, num_terms=12),
    "hd24_F12_adaptive": dict(head_dim=24, num_terms=12,
                              adaptive_terms=True),
}


def _inputs(seed, lead, head_dim, extent=3.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (head_dim,)).astype(np.float32)
    pose = np.concatenate(
        [rng.uniform(-extent, extent, lead + (2,)),
         rng.uniform(-np.pi, np.pi, lead + (1,))], -1).astype(np.float32)
    return x, pose


def _pair(name):
    return jenc.SE2Fourier(**ENCS[name]), tenc.SE2Fourier(**ENCS[name])


@pytest.mark.parametrize("name", sorted(ENCS))
@pytest.mark.parametrize("method", ["transform_q", "transform_k",
                                    "transform_v", "apply_phi"])
def test_se2_fourier_transforms_match_reference(name, method):
    je, te = _pair(name)
    x, pose = _inputs(sorted(ENCS).index(name), (2, 3, 5),
                      ENCS[name]["head_dim"])
    args = (x, pose) if method != "apply_phi" else (pose, x)  # (p_rel, vec)
    want = getattr(je, method)(*map(jnp.asarray, args))
    got = getattr(te, method)(*map(torch.from_numpy, args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(ENCS))
def test_se2_fourier_untransform_matches_reference(name):
    je, te = _pair(name)
    rng = np.random.default_rng(11)
    o = rng.normal(size=(2, 3, 5, je.expanded_dim)).astype(np.float32)
    _, pose = _inputs(12, (2, 3, 5), 6)
    want = je.untransform_out(jnp.asarray(o), jnp.asarray(pose))
    got = te.untransform_out(torch.from_numpy(o), torch.from_numpy(pose))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert te.block_terms() == je.block_terms()
    assert te.expanded_dim == je.expanded_dim


def test_fourier_pieces_match_reference():
    rng = np.random.default_rng(3)
    z = rng.uniform(-np.pi, np.pi, (7,)).astype(np.float32)
    x, y = rng.uniform(-2, 2, (2, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tfourier.eval_basis(torch.from_numpy(z), 12).numpy(),
        np.asarray(jfourier.eval_basis(jnp.asarray(z), 12)), **TOL)
    for got, want in zip(
            tfourier.xy_coefficients(torch.from_numpy(x), torch.from_numpy(y),
                                     12),
            jfourier.xy_coefficients(jnp.asarray(x), jnp.asarray(y), 12)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("head_dim,num_terms,tokens,block_t", [
    (6, 8, 16, 8),
    (12, 18, 100, 32),
    (24, 12, 64, 64),
])
@pytest.mark.parametrize("mode", ["q", "k"])
def test_plain_projection_matches_pallas_kernel(head_dim, num_terms, tokens,
                                                block_t, mode):
    """The port's wrapper on CPU tensors (its plain version) against the
    reference's Pallas kernel in interpret mode."""
    x, pose = _inputs(6, (tokens,), head_dim)
    je = jenc.SE2Fourier(head_dim=head_dim, num_terms=num_terms)
    te = tenc.SE2Fourier(head_dim=head_dim, num_terms=num_terms)
    want = jax_project(jnp.asarray(x), jnp.asarray(pose), je, mode,
                       block_t=block_t, interpret=True)
    got = tproj.se2_fourier_project(torch.from_numpy(x),
                                    torch.from_numpy(pose), te, mode)
    assert got.shape == (tokens, te.expanded_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["q", "k"])
def test_projection_shares_pose_across_heads(mode):
    """(B, H, n, d) with a (B, n, 3) pose == the flat (T, d) call with the
    pose repeated per head (the layout the kernel reads by index)."""
    te = tenc.SE2Fourier(head_dim=24, num_terms=12)
    x, _ = _inputs(9, (2, 3, 4), 24)
    _, pose = _inputs(10, (2, 4), 24)
    got = tproj.se2_fourier_project(torch.from_numpy(x),
                                    torch.from_numpy(pose), te, mode)
    flat_pose = np.broadcast_to(pose[:, None], (2, 3, 4, 3)).reshape(-1, 3)
    want = tproj.se2_fourier_project(torch.from_numpy(x.reshape(-1, 24)),
                                     torch.from_numpy(flat_pose.copy()),
                                     te, mode)
    np.testing.assert_array_equal(got.reshape(-1, te.expanded_dim).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("name", ["absolute", "rope2d", "se2_repr"])
def test_unported_encodings_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tenc.make_encoding(name, 24)
    with pytest.raises(ValueError):
        tenc.make_encoding("nope", 24)
