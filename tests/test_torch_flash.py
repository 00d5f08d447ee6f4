"""Parity: the port's flash-attention forward and backward (their plain
versions, which the wrappers run for CPU tensors) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

* forward ``(out, lse)`` against ``flash_attention_fwd(..., interpret=True,
  return_lse=True)`` on block-aligned shapes and against
  ``ops.flash_attention(..., interpret=True)`` on the rest of a subset of
  tests/test_kernels.py's ``SHAPE_SWEEP``, its mask variants, segment ids
  and times; tolerances tests/test_kernels.py:25-27 (lse 1e-5, :228);
* the backward, ``flash_bwd_plain`` and autograd through
  ``ops.attention(impl="plain")``, against the reference's Pallas backward
  (``bwd_impl="pallas"``) on the ``GRAD_CASES`` matrix at
  tests/test_kernels.py:162-163's tolerances;
* the gradient oracle ``mha_grads_reference`` against the reference's.

Shapes stay at S <= 64 with blocks of 16 (interpret mode is slow).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as tfab  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BLOCK = 16
FWD_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-3),
            "bfloat16": dict(atol=1e-2, rtol=4e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

SHAPES = {
    # b, hq, hkv, sq, sk, d, dv: tests/test_kernels.py SHAPE_SWEEP rows
    "aligned": (1, 1, 1, 32, 32, 32, 32),
    "gqa_ragged": (1, 4, 2, 48, 80, 32, 32),
    "mqa_unaligned": (2, 8, 1, 33, 65, 16, 16),
    "dv_ne_d": (1, 2, 2, 64, 64, 24, 40),
}
MASKS = {
    "causal": dict(causal=True),
    "window": dict(window=24),
    "causal_window": dict(causal=True, window=16),
    "softcap": dict(softcap=30.0),
    "causal_softcap": dict(causal=True, softcap=50.0),
}
GRAD_CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "window": dict(window=24),
    "causal_window": dict(causal=True, window=16),
    "softcap": dict(softcap=20.0),
    "causal_softcap": dict(causal=True, softcap=30.0),
}


def _qkv(seed, b, hq, hkv, sq, sk, d, dv, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, hq, sq, dv))]
    jarrs = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    # the same (rounded) values on both sides
    tarrs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jarrs]
    return jarrs, tarrs, rng


def _scene_masks(rng, b, s):
    """Block-causal times and segment ids with -1 (padding) tokens."""
    times = np.sort(rng.integers(0, 8, size=(b, s)), -1).astype(np.int32)
    seg = np.where(rng.random((b, s)) < 0.15, -1, 0).astype(np.int32)
    return dict(causal=True, q_times=times, k_times=times,
                q_segment_ids=seg, k_segment_ids=seg)


def _split(kw):
    """(jax kwargs, torch kwargs) from numpy-valued kwargs."""
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_forward_matches_pallas_shape_sweep(shape, dtype):
    (jq, jk, jv, _), (tq, tk, tv, _), _ = _qkv(sorted(SHAPES).index(shape),
                                              *SHAPES[shape], dtype=dtype)
    want = jops.flash_attention(jq, jk, jv, block_q=BLOCK, block_k=BLOCK,
                                interpret=True)
    out, lse = tfa.flash_fwd_plain(tq, tk, tv)
    assert out.dtype == tv.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(jref.lse_reference(jq, jk)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mask", sorted(MASKS) + ["segments", "times"])
def test_plain_forward_and_lse_match_pallas_kernel(mask):
    """Against the raw Pallas forward with its lse output (aligned)."""
    (jq, jk, jv, _), (tq, tk, tv, _), rng = _qkv(3, 2, 4, 2, 64, 64, 32, 32)
    if mask == "segments":
        seg = rng.integers(0, 3, size=(2, 64)).astype(np.int32)
        kw = dict(q_segment_ids=seg, k_segment_ids=seg)
    elif mask == "times":
        kw = _scene_masks(rng, 2, 64)
    else:
        kw = MASKS[mask]
    jkw, tkw = _split(kw)
    want, want_lse = jfa.flash_attention_fwd(
        jq, jk, jv, block_q=BLOCK, block_k=BLOCK, interpret=True,
        return_lse=True, **jkw)
    out, lse = tfa.flash_fwd_plain(tq, tk, tv, **tkw)
    np.testing.assert_allclose(_np(out), _np(want), **FWD_TOL["float32"])
    live = np.asarray(jref.mha_reference(
        jq, jk, jnp.ones_like(jv[..., :1]), **jkw))[..., 0] > 0.5
    np.testing.assert_allclose(_np(lse)[live], _np(want_lse)[live],
                               atol=1e-5, rtol=1e-5)
    # rows with no live key: output 0 in both
    np.testing.assert_array_equal(_np(out)[~live], 0.0)


def _pallas_grads(jq, jk, jv, jg, **kw):
    def loss(q, k, v):
        o = jops.flash_attention(q, k, v, block_q=BLOCK, block_k=BLOCK,
                                 interpret=True, bwd_impl="pallas", **kw)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))
    return jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)


def _autograd_plain(tq, tk, tv, tg, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tops.attention(*leaves, impl="plain", **kw)
    return out, torch.autograd.grad((out.float() * tg.float()).sum(), leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_pallas_feature_matrix(case, dtype):
    kw = GRAD_CASES[case]
    (jq, jk, jv, jg), (tq, tk, tv, tg), _ = _qkv(
        sorted(GRAD_CASES).index(case), 2, 4, 2, 64, 64, 32, 32, dtype)
    want = _pallas_grads(jq, jk, jv, jg, **kw)
    out, got = _autograd_plain(tq, tk, tv, tg, **kw)
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, **kw)
    direct = tfab.flash_bwd_plain(tq, tk, tv, o, lse, tg, **kw)
    for name, a, b_, w in zip(("dq", "dk", "dv"), got, direct, want):
        assert a.dtype == b_.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(a), _np(w), **GRAD_TOL[dtype],
                                   err_msg=f"{name} autograd")
        np.testing.assert_allclose(_np(b_), _np(w), **GRAD_TOL[dtype],
                                   err_msg=f"{name} flash_bwd_plain")


@pytest.mark.parametrize("shape", ["gqa_ragged", "mqa_unaligned",
                                   "dv_ne_d"])
def test_plain_backward_matches_pallas_shape_sweep(shape):
    (jq, jk, jv, jg), (tq, tk, tv, tg), _ = _qkv(
        7 + sorted(SHAPES).index(shape), *SHAPES[shape])
    want = _pallas_grads(jq, jk, jv, jg, causal=True)
    _, got = _autograd_plain(tq, tk, tv, tg, causal=True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(w), **GRAD_TOL["float32"],
                                   err_msg=name)


def test_plain_backward_matches_pallas_scene_masks():
    """Block-causal times with -1 segments: the agent-sim model's masks;
    padded rows get zero gradients."""
    (jq, jk, jv, jg), (tq, tk, tv, tg), rng = _qkv(11, 2, 2, 2, 64, 64, 32,
                                                   32)
    kw = _scene_masks(rng, 2, 64)
    jkw, tkw = _split(kw)
    want = _pallas_grads(jq, jk, jv, jg, **jkw)
    _, got = _autograd_plain(tq, tk, tv, tg, **tkw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(w), **GRAD_TOL["float32"],
                                   err_msg=name)
    dead = kw["q_segment_ids"] < 0
    assert np.all(_np(got[0]).transpose(0, 2, 1, 3)[dead] == 0.0)


@pytest.mark.parametrize("case", ["causal_window", "softcap"])
def test_grads_reference_matches_reference_oracle(case):
    kw = GRAD_CASES[case]
    (jq, jk, jv, jg), (tq, tk, tv, tg), _ = _qkv(21, 1, 4, 2, 40, 40, 16, 24)
    want = jref.mha_grads_reference(jq, jk, jv, jg, **kw)
    got = tref.mha_grads_reference(tq, tk, tv, tg, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_ref_and_plain_impls_agree_through_autograd():
    """attention(impl="ref") and impl="plain" give the same output and
    gradients with every mask term on (window, softcap, times, segments)."""
    _, (tq, tk, tv, tg), rng = _qkv(5, 2, 4, 2, 48, 48, 24, 24)
    kw = _split(_scene_masks(rng, 2, 48))[1]
    kw.update(window=3, softcap=25.0)
    outs = {}
    for impl in ("ref", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        out = tops.attention(*leaves, impl=impl, **kw)
        outs[impl] = [out] + list(torch.autograd.grad(
            (out * tg).sum(), leaves))
    for a, b_ in zip(outs["plain"], outs["ref"]):
        np.testing.assert_allclose(_np(a), _np(b_), atol=1e-5, rtol=1e-4)


def test_auto_impl_runs_plain_versions_on_the_cpu():
    _, (tq, tk, tv, _), _ = _qkv(6, 1, 2, 2, 16, 16, 8, 8)
    got = tops.attention(tq, tk, tv, impl="auto", causal=True)
    want = tops.attention(tq, tk, tv, impl="plain", causal=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.attention(tq, tk, tv, impl="xla")
