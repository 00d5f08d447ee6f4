"""Parity: the port's int8 cache codec and its decode paths against the
JAX reference, on the CPU.

The port's decode wrapper on CPU tensors runs its plain version (the port
of ``decode_ragged_xla``); it is held to the reference's Pallas decode
kernel (interpret mode) and to the reference oracle ``mha_reference`` over
the matrix of tests/test_decode.py: cursor {0, 1, block-1, block, full,
ragged} x feature {times, segments, GQA} x cache dtype {f32, bf16, int8},
on a layer-stacked cache. Tolerances are tests/test_decode.py's own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BLOCK = 16
LAYERS, LAYER = 2, 1

FEATS = {
    "plain": dict(times=False, segments=False, hkv="mha"),
    "times": dict(times=True, segments=False, hkv="mha"),
    "seg_times": dict(times=True, segments=True, hkv="mha"),
    "gqa": dict(times=False, segments=False, hkv="gqa"),
    "gqa_seg_times": dict(times=True, segments=True, hkv="gqa"),
}
CURSORS = {
    "zero": lambda b, s: np.zeros(b, np.int32),
    "one": lambda b, s: np.ones(b, np.int32),
    "block_minus_1": lambda b, s: np.full(b, BLOCK - 1, np.int32),
    "block": lambda b, s: np.full(b, BLOCK, np.int32),
    "full": lambda b, s: np.full(b, s, np.int32),
    "ragged": lambda b, s: np.asarray([s - 7, BLOCK + 1][:b], np.int32),
}
TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
       "bfloat16": dict(atol=8e-3, rtol=8e-3),
       "int8": dict(atol=2e-4, rtol=2e-3)}


def _case(feat, cache_dtype, seed):
    """numpy inputs; the cache is layer-stacked (L, B, Hkv, S, d)."""
    rng = np.random.default_rng(seed)
    b, s, sq, d = 2, 48, 4, 12
    hq, hkv = (4, 2) if FEATS[feat]["hkv"] == "gqa" else (2, 2)
    case = dict(
        q=rng.normal(size=(b, hq, sq, d)).astype(np.float32),
        k=rng.normal(size=(LAYERS, b, hkv, s, d)).astype(np.float32),
        v=rng.normal(size=(LAYERS, b, hkv, s, d)).astype(np.float32))
    kw = {}
    if FEATS[feat]["times"]:
        kw["k_times"] = np.sort(rng.integers(0, 6, size=(b, s)),
                                -1).astype(np.int32)
        kw["q_times"] = np.full((b, sq), 6, np.int32)
    if FEATS[feat]["segments"]:
        kw["q_segment_ids"] = rng.integers(0, 2, (b, sq)).astype(np.int32)
        kw["k_segment_ids"] = rng.integers(-1, 2, (b, s)).astype(np.int32)
    return case, kw


def _jax_cache(case, cache_dtype):
    """(k, v, k_scale, v_scale, k_oracle, v_oracle) as the reference
    stores and dequantizes them."""
    k, v = jnp.asarray(case["k"]), jnp.asarray(case["v"])
    if cache_dtype == "int8":
        (kq, ks), (vq, vs) = jfd.quantize_kv(k), jfd.quantize_kv(v)
        return (kq, vq, ks, vs, jfd.dequantize_kv(kq, ks),
                jfd.dequantize_kv(vq, vs))
    if cache_dtype == "bfloat16":
        k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
        return k, v, None, None, k.astype(jnp.float32), v.astype(jnp.float32)
    return k, v, None, None, k, v


def _to_torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


@jax.jit
def _pallas_decode(q, k, v, kvl, ks, vs, kw):
    """The reference's Pallas decode kernel in interpret mode, jitted: the
    cursors are traced, so the cursor cases share one compilation."""
    return jfd.flash_decode(q, k, v, kvl, k_scale=ks, v_scale=vs,
                            block_k=BLOCK, num_splits=2, interpret=True,
                            layer=LAYER, **kw)


@pytest.mark.parametrize("cache_dtype", sorted(TOL))
@pytest.mark.parametrize("feat", sorted(FEATS))
@pytest.mark.parametrize("cursor", sorted(CURSORS))
def test_decode_parity_matrix(cursor, feat, cache_dtype):
    seed = sorted(CURSORS).index(cursor) * 31 + sorted(FEATS).index(feat)
    case, kw = _case(feat, cache_dtype, seed)
    b, s = case["q"].shape[0], case["k"].shape[3]
    kvl = CURSORS[cursor](b, s)
    jk, jv, jks, jvs, k_or, v_or = _jax_cache(case, cache_dtype)
    jkw = {key: jnp.asarray(val) for key, val in kw.items()}
    oracle = np.asarray(jref.mha_reference(
        jnp.asarray(case["q"]), k_or[LAYER], v_or[LAYER],
        causal="q_times" in kw, kv_length=jnp.asarray(kvl), **jkw),
        np.float32)
    pallas = np.asarray(_pallas_decode(
        jnp.asarray(case["q"]), jk, jv, jnp.asarray(kvl), jks, jvs, jkw))

    tkw = {key: torch.from_numpy(val) for key, val in kw.items()}
    common = dict(kv_length=torch.from_numpy(kvl), layer=LAYER,
                  k_scale=_to_torch(jks), v_scale=_to_torch(jvs), **tkw)
    tq, tk, tv = torch.from_numpy(case["q"]), _to_torch(jk), _to_torch(jv)
    got = {impl: tops.decode_attention(tq, tk, tv, impl=impl, **common)
           for impl in ("auto", "ref")}
    # the plain version's block loop at the matrix's block size
    got["plain_blocked"] = tfd.decode_plain(tq, tk, tv, block_k=BLOCK,
                                            **common)
    for impl, out in got.items():
        out = out.float().numpy()
        msg = f"{impl} {cursor}/{feat}/{cache_dtype}"
        np.testing.assert_allclose(out, oracle, **TOL[cache_dtype],
                                   err_msg=msg + " vs mha_reference")
        np.testing.assert_allclose(out, pallas, **TOL[cache_dtype],
                                   err_msg=msg + " vs Pallas kernel")


@pytest.mark.parametrize("cache_dtype", sorted(TOL))
def test_stale_nan_rows_past_cursor_stay_unreachable(cache_dtype):
    """Rows past the cursor holding NaN (and segment ids claiming
    validity) leave the output exactly as a clean cache gives it."""
    case, kw = _case("gqa_seg_times", cache_dtype, 5)
    kvl = np.asarray([30, 9], np.int32)
    tkw = {key: torch.from_numpy(val) for key, val in kw.items()}
    jk, jv, jks, jvs, _, _ = _jax_cache(case, cache_dtype)
    tk, tv, tks, tvs = map(_to_torch, (jk, jv, jks, jvs))
    common = dict(kv_length=torch.from_numpy(kvl), layer=LAYER, **tkw)
    clean = tops.decode_attention(torch.from_numpy(case["q"]), tk, tv,
                                  k_scale=tks, v_scale=tvs, **common)
    stale = torch.arange(tk.shape[3])[None, :] >= torch.from_numpy(kvl)[:, None]
    tkw["k_segment_ids"] = torch.where(stale, 0, tkw["k_segment_ids"])
    common.update(tkw)
    if cache_dtype == "int8":
        nan = torch.tensor(float("nan"))
        tks = torch.where(stale[None, :, None], nan, tks)
        tvs = torch.where(stale[None, :, None], nan, tvs)
    else:
        sel = stale[None, :, None, :, None]
        tk = torch.where(sel, float("nan"), tk.float()).to(tk.dtype)
        tv = torch.where(sel, float("nan"), tv.float()).to(tv.dtype)
    for impl in ("plain", "ref"):
        got = tops.decode_attention(torch.from_numpy(case["q"]), tk, tv,
                                    k_scale=tks, v_scale=tvs, impl=impl,
                                    **common)
        assert torch.isfinite(got).all(), impl
        np.testing.assert_allclose(got.float().numpy(), clean.float().numpy(),
                                   **TOL[cache_dtype], err_msg=impl)


def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(scale=3.0, size=(2, 3, 17, 200)).astype(np.float32)
    x[0, 0, 0] = 0.0                      # all-zero row: eps scale
    x[1, 2, 3, :5] = [127.5, -0.5, 0.5, 1.5, 2.5]  # round-half-to-even
    jq, js = jfd.quantize_kv(jnp.asarray(x))
    tq, ts = tfd.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tfd.dequantize_kv(tq, ts).numpy(),
        np.asarray(jfd.dequantize_kv(jq, js)))


@pytest.mark.parametrize("feat", sorted(FEATS))
def test_mha_reference_matches_reference(feat):
    case, kw = _case(feat, "float32", 3)
    kvl = np.asarray([40, 21], np.int32)
    k, v = case["k"][LAYER], case["v"][LAYER]
    want = jref.mha_reference(
        jnp.asarray(case["q"]), jnp.asarray(k), jnp.asarray(v),
        causal="q_times" in kw, kv_length=jnp.asarray(kvl),
        **{key: jnp.asarray(val) for key, val in kw.items()})
    got = tref.mha_reference(
        torch.from_numpy(case["q"]), torch.from_numpy(k), torch.from_numpy(v),
        causal="q_times" in kw, kv_length=torch.from_numpy(kvl),
        **{key: torch.from_numpy(val) for key, val in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_unknown_impls_raise():
    q = torch.zeros(1, 1, 1, 4)
    k = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="impl"):
        tops.decode_attention(q, k, k, kv_length=torch.ones(1, dtype=torch.int32),
                              impl="xla")
    with pytest.raises(ValueError, match="impl"):
        tops.attention(q, k, k, impl="xla")
