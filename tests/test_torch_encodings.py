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


# the five encodings as the model builds them (AgentSimConfig's defaults)
ALL = {"absolute": {}, "rope1d": {}, "rope2d": dict(max_freq=1.0, base=100.0),
       "se2_repr": dict(min_scale=0.25, max_scale=1.0),
       "se2_fourier": dict(num_terms=12)}
EXACT_TOL = dict(atol=1e-6, rtol=0)


def _any_pose(seed, lead, pose_dim):
    """Poses of each kind: a scalar coordinate up to 64 (rope1d), (x, y)
    within +-3 (rope2d), SE(2) poses within +-3 at any heading."""
    rng = np.random.default_rng(seed)
    if pose_dim == 1:
        return rng.uniform(0, 64, lead + (1,)).astype(np.float32)
    if pose_dim == 2:
        return rng.uniform(-3, 3, lead + (2,)).astype(np.float32)
    return _inputs(seed, lead, 6)[1]


@pytest.mark.parametrize("method", ["transform_q", "transform_k",
                                    "transform_v", "untransform_out",
                                    "apply_phi"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_every_encoding_matches_reference(name, method):
    """Each transform of each encoding within 1e-6 abs in float32 (the
    same formulas on both sides; values up to about 8). se2_fourier's
    ``untransform_out`` contracts 2F products a pair in another order than
    the reference (all blocks at once), so it is held to 1e-6 abs plus
    1e-6 of the value (values up to 10: some 3 ulp)."""
    je = jenc.make_encoding(name, 24, **ALL[name])
    te = tenc.make_encoding(name, 24, **ALL[name])
    rng = np.random.default_rng(sorted(ALL).index(name))
    width = te.expanded_dim if method == "untransform_out" else 24
    x = rng.normal(size=(2, 3, 5, width)).astype(np.float32)
    pose = _any_pose(5, (2, 3, 5), te.pose_dim)
    args = (x, pose) if method != "apply_phi" else (pose, x)
    want = getattr(je, method)(*map(jnp.asarray, args))
    got = getattr(te, method)(*map(torch.from_numpy, args))
    assert got.shape == want.shape and got.dtype == torch.float32
    tol = dict(EXACT_TOL)
    if (name, method) == ("se2_fourier", "untransform_out"):
        tol["rtol"] = 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert (te.expanded_dim, te.expanded_v_dim, te.transforms_values,
            te.pose_dim) == (je.expanded_dim, je.expanded_v_dim,
                             je.transforms_values, je.pose_dim)


@pytest.mark.parametrize("name", ["rope1d", "rope2d", "se2_repr"])
def test_encodings_keep_float64_and_compute_bfloat16_in_float32(name):
    """float64 computes in float64 (to 1e-12 of the float32 result's
    exact counterpart); bfloat16 computes in float32 and rounds once."""
    te = tenc.make_encoding(name, 24, **ALL[name])
    x = np.random.default_rng(1).normal(size=(4, 24))
    pose = _any_pose(2, (4,), te.pose_dim).astype(np.float64)
    wide = te.transform_q(torch.from_numpy(x), torch.from_numpy(pose))
    assert wide.dtype == torch.float64
    f32 = te.transform_q(torch.from_numpy(x).float(),
                         torch.from_numpy(pose).float())
    np.testing.assert_allclose(wide.numpy(), f32.numpy(), atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = te.transform_q(xb, torch.from_numpy(pose).float())
    assert got.dtype == torch.bfloat16
    want = te.transform_q(xb.float(), torch.from_numpy(pose).float())
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("name", sorted(ALL))
def test_every_encoding_builds(name):
    enc = tenc.make_encoding(name, 24, **ALL[name])
    assert enc.name == name and enc.head_dim == 24
    assert type(enc).__name__ == type(
        jenc.make_encoding(name, 24, **ALL[name])).__name__
    assert tenc.ENCODINGS[name] is type(enc)


def test_unknown_encoding_raises():
    with pytest.raises(ValueError, match="unknown encoding"):
        tenc.make_encoding("nope", 24)
    with pytest.raises(ValueError, match="divisible by 4"):
        tenc.make_encoding("rope2d", 18)
    with pytest.raises(ValueError, match="divisible by 3"):
        tenc.make_encoding("se2_repr", 20)
