"""Parity: the port's SE(2) group operations (``repro_torch.core.se2``)
against the JAX reference, on the CPU, and the group laws.

Tolerance 1e-6 abs in float32: both sides run the same formulas and differ
only in the libraries' sin/cos and in fused multiply-adds. The group laws
hold to float32 round-off: composed positions reach |x| ~ 15, where one
ulp is 9.5e-7, so 1e-5 allows some ten roundings.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import se2 as jse2  # noqa: E402
from repro_torch.core import se2 as tse2  # noqa: E402

TOL = dict(atol=1e-6, rtol=0)
LAW_TOL = dict(atol=1e-5, rtol=0)


def _poses(seed, lead, extent=5.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-extent, extent, lead + (2,)),
                           rng.uniform(-np.pi, np.pi, lead + (1,))],
                          -1).astype(np.float32)


def _both(fn_name, *arrays):
    want = getattr(jse2, fn_name)(*map(jnp.asarray, arrays))
    got = getattr(tse2, fn_name)(*(torch.from_numpy(np.array(a))
                                   for a in arrays))
    return got.numpy(), np.asarray(want)


def _angle_close(a, b, atol):
    """Angles equal modulo 2 pi (a wrapped angle near -pi may come out
    near +pi on the other side)."""
    d = np.angle(np.exp(1j * (a.astype(np.float64) - b)))
    assert np.abs(d).max() <= atol, np.abs(d).max()


@pytest.mark.parametrize("fn_name,arity", [
    ("compose", 2), ("inverse", 1), ("relative", 2), ("matrix", 1),
    ("transform_points", 2)])
def test_group_ops_match_reference(fn_name, arity):
    p1, p2 = _poses(0, (4, 7)), _poses(1, (4, 7))
    if fn_name == "transform_points":
        args = (p1, p2[..., :2])
    else:
        args = (p1, p2)[:arity]
    got, want = _both(fn_name, *args)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TOL)


def test_relative_broadcasts_to_the_pairwise_grid():
    pn, pm = _poses(2, (2, 5)), _poses(3, (2, 6))
    got, want = _both("relative", pn[:, :, None, :], pm[:, None, :, :])
    assert got.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_rot2_from_matrix_identity_match_reference():
    p = _poses(4, (9,))
    got, want = _both("rot2", p[:, 2])
    np.testing.assert_allclose(got, want, **TOL)
    m = np.asarray(jse2.matrix(jnp.asarray(p)))
    got, want = _both("from_matrix", m)
    np.testing.assert_allclose(got[:, :2], want[:, :2], **TOL)
    _angle_close(got[:, 2], want[:, 2], 1e-6)
    _angle_close(got[:, 2], p[:, 2], 1e-6)
    ident = tse2.identity((2, 3))
    assert ident.shape == (2, 3, 3) and ident.dtype == torch.float32
    np.testing.assert_array_equal(ident.numpy(),
                                  np.asarray(jse2.identity((2, 3))))


def test_wrap_angle_matches_reference_at_the_edges():
    """``%`` on tensors takes the divisor's sign, as ``jnp``'s does: the
    same wrapped values at +-pi, at multiples of 2 pi and far out."""
    pi = np.float32(np.pi)
    theta = np.array([-pi, pi, 0.0, 2 * pi, -2 * pi, 4 * pi, -4 * pi,
                      3 * pi, -3 * pi, 1e-7, -1e-7, 100.0, -100.0,
                      np.nextafter(pi, np.float32(0)),
                      np.nextafter(-pi, np.float32(0))], dtype=np.float32)
    got, want = _both("wrap_angle", theta)
    np.testing.assert_array_equal(got, want)
    assert (got >= -pi).all() and (got < pi + 1e-6).all()
    wide = theta.astype(np.float64)
    np.testing.assert_array_equal(
        tse2.wrap_angle(torch.from_numpy(wide)).numpy(),
        (wide + np.pi) % (2 * np.pi) - np.pi)


def test_group_laws():
    a, b, c = (torch.from_numpy(_poses(s, (50,))) for s in (5, 6, 7))
    e = tse2.identity((50,))
    # associativity, identity, inverse
    lhs = tse2.compose(tse2.compose(a, b), c)
    rhs = tse2.compose(a, tse2.compose(b, c))
    np.testing.assert_allclose(lhs[:, :2].numpy(), rhs[:, :2].numpy(),
                               **LAW_TOL)
    _angle_close(lhs[:, 2].numpy(), rhs[:, 2].numpy(), 1e-6)
    for got in (tse2.compose(e, a), tse2.compose(a, e)):
        np.testing.assert_allclose(got.numpy(), a.numpy(), **LAW_TOL)
    for got in (tse2.compose(tse2.inverse(a), a),
                tse2.compose(a, tse2.inverse(a))):
        np.testing.assert_allclose(got[:, :2].numpy(), 0.0, **LAW_TOL)
        _angle_close(got[:, 2].numpy(), np.zeros(50), 1e-6)
    # relative is p_n^{-1} p_m, invariant to a common left transform
    rel = tse2.relative(a, b)
    np.testing.assert_allclose(
        rel.numpy(), tse2.compose(tse2.inverse(a), b).numpy(), **LAW_TOL)
    moved = tse2.relative(tse2.compose(c, a), tse2.compose(c, b))
    np.testing.assert_allclose(moved[:, :2].numpy(), rel[:, :2].numpy(),
                               **LAW_TOL)
    _angle_close(moved[:, 2].numpy(), rel[:, 2].numpy(), 1e-6)
    # matrix is a homomorphism, and acts on points as transform_points
    np.testing.assert_allclose(
        tse2.matrix(tse2.compose(a, b)).numpy(),
        (tse2.matrix(a) @ tse2.matrix(b)).numpy(), atol=1e-5)
    pts = b[:, :2]
    hom = torch.cat([pts, torch.ones(50, 1)], -1)[..., None]
    np.testing.assert_allclose(
        tse2.transform_points(a, pts).numpy(),
        (tse2.matrix(a) @ hom)[:, :2, 0].numpy(), **LAW_TOL)
    np.testing.assert_allclose(
        tse2.matrix(a)[:, :2, :2].numpy(), tse2.rot2(a[:, 2]).numpy(),
        atol=0)
