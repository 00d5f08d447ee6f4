"""The SE(2) projection's transpose and its autograd Functions, on the CPU.

``se2_project_t_plain`` is held to the JAX reference: for "q" to
``SE2Fourier.untransform_out``, and for both modes to ``jax.vjp`` of
``transform_q`` / ``transform_k`` (the projection is linear in x, so its
vector-Jacobian product is the transposed projection). Tolerance atol 1e-5
/ rtol 1e-4 in float32, as tests/test_torch_encodings.py: both sides run
f32 formulas that differ only in summation order and the libraries'
sin/cos. In float64 the adjoint identity <P x, g> = <x, P^T g> and
``torch.autograd.gradcheck`` of both Functions hold to float64 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import encodings as jenc  # noqa: E402
from repro_torch.core import encodings as tenc  # noqa: E402
from repro_torch.kernels import se2_project as sp  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)

ENCS = {
    "hd12_F5": dict(head_dim=12, num_terms=5),
    "hd18_F12": dict(head_dim=18, num_terms=12),
    "hd24_F12": dict(head_dim=24, num_terms=12),
    "hd48_F18": dict(head_dim=48, num_terms=18),
    "hd24_F12_adaptive": dict(head_dim=24, num_terms=12,
                              adaptive_terms=True),
}
LEAD = (2, 3, 5)


def _inputs(seed, enc, width, dtype=np.float32):
    """x (2, 3, 5, width) and a pose (2, 5, 3) shared by the 3 heads."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=LEAD + (width,)).astype(dtype)
    pose = np.concatenate(
        [rng.uniform(-3.0, 3.0, (2, 5, 2)),
         rng.uniform(-np.pi, np.pi, (2, 5, 1))], -1).astype(dtype)
    return x, pose


def _jax_transform(enc, mode):
    return enc.transform_q if mode == "q" else enc.transform_k


@pytest.mark.parametrize("name", sorted(ENCS))
@pytest.mark.parametrize("mode", ["q", "k"])
def test_transposed_plain_matches_jax_vjp(name, mode):
    je, te = jenc.SE2Fourier(**ENCS[name]), tenc.SE2Fourier(**ENCS[name])
    x, pose = _inputs(sorted(ENCS).index(name), te, te.head_dim)
    g, _ = _inputs(40 + sorted(ENCS).index(name), te, te.expanded_dim)
    jpose = jnp.asarray(pose)[:, None]
    _, vjp = jax.vjp(lambda v: _jax_transform(je, mode)(v, jpose),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = sp.se2_project_t_plain(torch.from_numpy(g), torch.from_numpy(pose),
                                 te, mode)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(ENCS))
def test_transposed_q_plain_matches_untransform_out(name):
    je, te = jenc.SE2Fourier(**ENCS[name]), tenc.SE2Fourier(**ENCS[name])
    g, pose = _inputs(7, te, te.expanded_dim)
    want = je.untransform_out(jnp.asarray(g), jnp.asarray(pose)[:, None])
    got = sp.se2_fourier_project_t(torch.from_numpy(g),
                                   torch.from_numpy(pose), te, "q")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(ENCS))
@pytest.mark.parametrize("mode", ["q", "k"])
def test_adjoint_identity_float64(name, mode):
    te = tenc.SE2Fourier(**ENCS[name])
    x, pose = _inputs(3, te, te.head_dim, np.float64)
    g, _ = _inputs(4, te, te.expanded_dim, np.float64)
    x, pose, g = map(torch.from_numpy, (x, pose, g))
    px = sp.se2_project_plain(x, pose, te, mode)
    ptg = sp.se2_project_t_plain(g, pose, te, mode)
    assert px.dtype == ptg.dtype == torch.float64
    lhs, rhs = float((px * g).sum()), float((x * ptg).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("mode", ["q", "k"])
def test_project_functions_gradcheck_float64(mode, transposed):
    te = tenc.SE2Fourier(head_dim=12, num_terms=5)
    width = te.expanded_dim if transposed else te.head_dim
    x, pose = _inputs(5, te, width, np.float64)
    x = torch.from_numpy(x[:, :, :3]).requires_grad_(True)
    pose = torch.from_numpy(pose[:, :3])
    fn = sp.se2_fourier_project_t if transposed else sp.se2_fourier_project
    assert torch.autograd.gradcheck(lambda v: fn(v, pose, te, mode), (x,))
    assert torch.autograd.gradgradcheck(lambda v: fn(v, pose, te, mode), (x,))


@pytest.mark.parametrize("mode", ["q", "k"])
def test_each_direction_is_the_others_gradient(mode):
    """The autograd gradient of one direction is the other direction's
    plain version, bitwise: no recompute under autograd."""
    te = tenc.SE2Fourier(head_dim=24, num_terms=12)
    x, pose = _inputs(8, te, te.head_dim)
    g, _ = _inputs(9, te, te.expanded_dim)
    x, pose, g = map(torch.from_numpy, (x, pose, g))
    x.requires_grad_(True)
    (gx,) = torch.autograd.grad(sp.se2_fourier_project(x, pose, te, mode),
                                x, g)
    assert torch.equal(gx, sp.se2_project_t_plain(g, pose, te, mode))
    g.requires_grad_(True)
    (gg,) = torch.autograd.grad(sp.se2_fourier_project_t(g, pose, te, mode),
                                g, x.detach())
    assert torch.equal(gg, sp.se2_project_plain(x.detach(), pose, te, mode))


@pytest.mark.parametrize("mode", ["q", "k"])
def test_transposed_shares_pose_across_heads(mode):
    """(B, H, n, c) with a (B, n, 3) pose == the flat (T, c) call with the
    pose repeated per head (the layout the kernel reads by index)."""
    te = tenc.SE2Fourier(head_dim=18, num_terms=5)
    g, pose = _inputs(10, te, te.expanded_dim)
    got = sp.se2_fourier_project_t(torch.from_numpy(g),
                                   torch.from_numpy(pose), te, mode)
    flat_pose = np.broadcast_to(pose[:, None], LEAD + (3,)).reshape(-1, 3)
    want = sp.se2_fourier_project_t(
        torch.from_numpy(g.reshape(-1, te.expanded_dim)),
        torch.from_numpy(flat_pose.copy()), te, mode)
    np.testing.assert_array_equal(got.reshape(-1, te.head_dim).numpy(),
                                  want.numpy())


def test_bad_mode_raises():
    te = tenc.SE2Fourier(head_dim=6, num_terms=4)
    x = torch.zeros((2, te.expanded_dim))
    with pytest.raises(ValueError, match="mode"):
        sp.se2_fourier_project_t(x, torch.zeros((2, 3)), te, "v")
    with pytest.raises(ValueError, match="mode"):
        sp.se2_project_t_plain(x, torch.zeros((2, 3)), te, "v")
