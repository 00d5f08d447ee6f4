"""Parity: the port's Algorithms 1 and 2 (``repro_torch.core.attention``)
against the JAX reference, on the CPU, and against each other.

The encodings and inputs are tests/test_encodings.py's, and so are the
tolerances between the algorithms: 2e-5 for the exact encodings, 5e-3 for
se2_fourier's Fourier truncation; the invariance gaps 1e-4 and 2e-2.
Port against reference, one algorithm: 2e-5 abs / 2e-4 rel (float32 sums
in another order). Algorithm 2 runs with the plain attention
(``sdpa_reference``) and with ``flash_sdpa``, which on the CPU runs the
flash kernels' plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as jatt  # noqa: E402
from repro.core import encodings as jenc  # noqa: E402
from repro_torch.core import attention as tatt  # noqa: E402
from repro_torch.core import encodings as tenc  # noqa: E402

ENCS = {
    "rope1d": dict(head_dim=32),
    "rope2d": dict(head_dim=32, max_freq=0.5),
    "se2_repr": dict(head_dim=30),
    "se2_fourier": dict(head_dim=30, num_terms=20),
}
PORT_TOL = dict(atol=2e-5, rtol=2e-4)
SDPA = {"reference": tatt.sdpa_reference, "flash": tatt.flash_sdpa}


def _pair(name):
    return (jenc.make_encoding(name, **ENCS[name]),
            tenc.make_encoding(name, **ENCS[name]))


def _qkv(rng, n, m, d, lead=()):
    return tuple(rng.normal(size=lead + (s, d)).astype(np.float32)
                 for s in (n, m, m))


def _poses(enc, rng, n, lead=()):
    if enc.pose_dim == 1:
        return rng.uniform(0, 64, lead + (n, 1)).astype(np.float32)
    if enc.pose_dim == 2:
        return rng.uniform(-4, 4, lead + (n, 2)).astype(np.float32)
    return np.concatenate([rng.uniform(-3, 3, lead + (n, 2)),
                           rng.uniform(-np.pi, np.pi, lead + (n, 1))],
                          -1).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("algorithm", ["quadratic", "linear"])
@pytest.mark.parametrize("name", sorted(ENCS))
def test_algorithms_match_reference(name, algorithm, masked):
    je, te = _pair(name)
    rng = np.random.default_rng(0)
    n, m = 9, 13
    args = _qkv(rng, n, m, je.head_dim) + (_poses(je, rng, n),
                                           _poses(je, rng, m))
    mask = None
    if masked:
        mask = rng.uniform(size=(n, m)) > 0.4
        mask[:, 0] = True
    fn = f"relative_attention_{algorithm}"
    want = getattr(jatt, fn)(je, *_j(*args),
                             mask=None if mask is None else jnp.asarray(mask))
    got = getattr(tatt, fn)(te, *_t(*args),
                            mask=None if mask is None else torch.from_numpy(
                                mask))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PORT_TOL)


def test_sdpa_reference_matches_reference():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 6, 10, 16, lead=(2,))
    mask = rng.uniform(size=(2, 6, 10)) > 0.3
    mask[..., 0] = True
    for mk in (None, mask):
        want = jatt.sdpa_reference(*_j(q, k, v), mask=None if mk is None
                                   else jnp.asarray(mk), scale=0.3)
        got = tatt.sdpa_reference(*_t(q, k, v), mask=None if mk is None
                                  else torch.from_numpy(mk), scale=0.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PORT_TOL)


@pytest.mark.parametrize("sdpa", sorted(SDPA))
@pytest.mark.parametrize("name", sorted(ENCS))
def test_linear_matches_quadratic(name, sdpa):
    """Algorithm 2 == Algorithm 1 (to the Fourier tolerance for
    se2_fourier), with batch and head dims in front."""
    _, te = _pair(name)
    rng = np.random.default_rng(0)
    n, m = 9, 13
    q, k, v = _t(*_qkv(rng, n, m, te.head_dim, lead=(2, 3)))
    pq, pk = _t(_poses(te, rng, n, lead=(2, 1)), _poses(te, rng, m,
                                                      lead=(2, 1)))
    lin = tatt.relative_attention_linear(te, q, k, v, pq, pk,
                                         sdpa_fn=SDPA[sdpa])
    # Algorithm 1 broadcasts the pair grid against k's head dim
    quad = tatt.relative_attention_quadratic(
        te, q, k, v, pq.expand(2, 3, n, -1), pk.expand(2, 3, m, -1))
    tol = 5e-3 if name == "se2_fourier" else 2e-5
    assert lin.shape == quad.shape == (2, 3, n, te.head_dim)
    np.testing.assert_allclose(lin.numpy(), quad.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("sdpa", sorted(SDPA))
@pytest.mark.parametrize("name", sorted(ENCS))
def test_fold_scale_equivalent(name, sdpa):
    """The paper's verbatim scaling (c/d)^{1/4} == the explicit 1/sqrt(d),
    and the port's folded form agrees with the reference's."""
    je, te = _pair(name)
    rng = np.random.default_rng(1)
    args = _qkv(rng, 6, 8, te.head_dim) + (_poses(te, rng, 6),
                                           _poses(te, rng, 8))
    a = tatt.relative_attention_linear(te, *_t(*args), sdpa_fn=SDPA[sdpa])
    b = tatt.relative_attention_linear(te, *_t(*args), sdpa_fn=SDPA[sdpa],
                                       fold_scale=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    want = jatt.relative_attention_linear(je, *_j(*args), fold_scale=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), **PORT_TOL)


@pytest.mark.parametrize("name", sorted(ENCS))
def test_masking(name):
    """Keys no query may attend do not move the output (both
    algorithms)."""
    _, te = _pair(name)
    rng = np.random.default_rng(2)
    n, m = 5, 11
    q, k, v = _qkv(rng, n, m, te.head_dim)
    pq, pk = _t(_poses(te, rng, n), _poses(te, rng, m))
    mask = rng.uniform(size=(n, m)) > 0.3
    mask[:, 0] = True
    mask[:, 8:] = False
    keep = mask.any(axis=0)[:, None]
    noise = rng.normal(size=k.shape).astype(np.float32) * 10
    k2, v2 = np.where(keep, k, k + noise), np.where(keep, v, v + noise)
    tmask = torch.from_numpy(mask)
    for fn in (tatt.relative_attention_linear,
               tatt.relative_attention_quadratic):
        out = fn(te, *_t(q, k, v), pq, pk, mask=tmask)
        out2 = fn(te, *_t(q, k2, v2), pq, pk, mask=tmask)
        np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=1e-5)


@pytest.mark.parametrize("sdpa", sorted(SDPA))
@pytest.mark.parametrize("name,tol", [
    ("rope1d", 1e-4), ("rope2d", 1e-4), ("se2_repr", 1e-4),
    ("se2_fourier", 2e-2)])
def test_invariance(name, tol, sdpa):
    """The output under a global transform of every pose (paper Eq. 2),
    tests/test_encodings.py's inputs and bounds; the port's gap within
    1e-5 of the reference's."""
    je, te = _pair(name)
    rng = np.random.default_rng(3)
    n, m = 8, 12
    q, k, v = _qkv(rng, n, m, te.head_dim)
    if te.pose_dim == 3:
        pq = _poses(te, rng, n)
        pk = _poses(te, rng, m)
        # the reference test draws radius 2: rescale the positions
        pq[:, :2] *= 2 / 3
        pk[:, :2] *= 2 / 3
        z = np.asarray([1.0, -0.5, 0.8], np.float32)
    elif te.pose_dim == 2:
        pq = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
        pk = rng.uniform(-3, 3, (m, 2)).astype(np.float32)
        z = np.asarray([11.0, -7.0], np.float32)
    else:
        pq = rng.uniform(0, 32, (n, 1)).astype(np.float32)
        pk = rng.uniform(0, 32, (m, 1)).astype(np.float32)
        z = np.asarray([100.0], np.float32)
    gap = float(tatt.invariance_gap(te, *_t(q, k, v, pq, pk, z),
                                    sdpa_fn=SDPA[sdpa]))
    assert gap < tol, gap
    want = float(jatt.invariance_gap(je, *_j(q, k, v, pq, pk, z)))
    assert abs(gap - want) < 1e-5, (gap, want)
    quad = float(tatt.invariance_gap(te, *_t(q, k, v, pq, pk, z),
                                     linear=False))
    assert quad < tol, quad


def test_flash_sdpa_refuses_a_mask():
    q = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="no mask"):
        tatt.flash_sdpa(q, q, q, mask=torch.ones((4, 4), dtype=torch.bool))
