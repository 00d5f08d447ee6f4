"""gemma2-27b's attention in the port against the JAX package on the CPU.

The decode's plain version with a sliding window and a softcap against
the port's O(S^2) oracle and the reference's chunked path (the way the
reference decodes gemma2); reduced gemma2 (window 16, sequences of 40 so
that the window bites): the forward, the decode against the port's own
prefill and against the reference's decode with float32, bf16 and int8
caches; the (local, global) pair groups carried both ways; the full config
counted on the meta device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import TransformerLM as JLM  # noqa: E402
from repro_torch import configs, params  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.nn.module import count_params  # noqa: E402
from repro_torch.nn.transformer import LayerPair, build_model  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model is small: one intra-op thread runs it faster than
    a pool contending with the test workers (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ARCH = "gemma2-27b"
FWD_TOL = dict(atol=1e-4, rtol=1e-3)
# tests/test_archs_smoke.py:118-120
DECODE_TOL = dict(atol=2e-3, rtol=2e-2)
# a bf16 cache rounds K and V that the two packages computed an ulp apart
# to bf16 (2^-9 relative): the port's bf16 decode tolerance
# (chip_smoke.DECODE_TOL["bfloat16"])
BF16_TOL = dict(atol=8e-3, rtol=8e-3)
B, S = 2, 40


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _decode_case(seed, *, b=2, hq=4, hkv=2, s=96, d=16, sq=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(dtype)
    k = rng.normal(size=(b, hkv, s, d)).astype(dtype)
    v = rng.normal(size=(b, hkv, s, d)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("window,softcap", [(10, 2.0), (10, None),
                                            (None, 5.0), (200, 2.0)])
def test_decode_plain_window_softcap_matches_oracles(window, softcap):
    """Sq = 3 rows a slot at the last positions before its cursor (a
    window of 200 exceeds every cursor): against the port's O(S^2) oracle
    at per-slot cursors, and against the reference's chunked path (its
    gemma2 decode) at one cursor, the rows past it NaN."""
    q, k, v = _decode_case(1)
    sq, s = q.shape[2], k.shape[2]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    k_times = torch.arange(s, dtype=torch.int32)[None].expand(B, s)
    for cursors in ([57, 96], [70, 70]):
        kvl = torch.tensor(cursors, dtype=torch.int32)
        q_times = (kvl[:, None] - sq + torch.arange(sq)).to(torch.int32)
        got = fd.decode_plain(tq, tk, tv, kvl, q_times=q_times,
                              k_times=k_times, window=window,
                              softcap=softcap, block_k=32)
        want = tref.mha_reference(tq, tk, tv, causal=True, window=window,
                                  softcap=softcap, q_times=q_times,
                                  k_times=k_times, kv_length=kvl)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
    cursor = 70
    kn, vn = k.copy(), v.copy()
    kn[:, :, cursor:], vn[:, :, cursor:] = np.nan, np.nan
    kvl = torch.full((B,), cursor, dtype=torch.int32)
    q_times = (kvl[:, None] - sq + torch.arange(sq)).to(torch.int32)
    got = fd.decode_plain(tq, torch.from_numpy(kn), torch.from_numpy(vn),
                          kvl, q_times=q_times, k_times=k_times,
                          window=window, softcap=softcap)
    want = jref.mha_chunked(jnp.asarray(q), jnp.asarray(k[:, :, :cursor]),
                            jnp.asarray(v[:, :, :cursor]), causal=True,
                            window=window, softcap=softcap,
                            q_offset=cursor - sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_window_needs_times():
    q, k, v = (torch.from_numpy(x) for x in _decode_case(2))
    with pytest.raises(ValueError, match="needs q_times"):
        fd.decode_plain(q, k, v, torch.tensor([5, 6]), window=4)


def pair(seed=0, **overrides):
    cfg = jconfigs.get_config(ARCH).reduced(dtype="float32", **overrides)
    jm = JLM(cfg)
    jp = jmodule.init_params(jm.specs(), jax.random.key(seed))
    tm = build_model(configs.get_config(ARCH).reduced(dtype="float32",
                                                      **overrides),
                     device="cpu")
    tm.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                       strict=True)
    return cfg, jm, jp, tm


def test_gemma2_config_builds_with_its_structure():
    cfg = configs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    want = jmodule.count_params(JLM(jconfigs.get_config(ARCH)).specs())
    assert count_params(model) == want
    group = model.groups[0]
    assert len(group) == cfg.num_layers // 2
    assert all(isinstance(p, LayerPair) for p in group)
    a, b = group[0].a.attn, group[0].b.attn
    assert (a.window, b.window) == (cfg.window, None)
    assert a.softcap == b.softcap == cfg.attn_softcap
    assert a._scale() == cfg.query_scale ** -0.5
    assert group[0].a.post_norms and model.embedding.scale_by_sqrt_dim


def test_forward_matches_reference():
    cfg, jm, jp, tm = pair(seed=1)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, _, _ = jax.jit(lambda jp, t: jm(jp, t, remat=False))(
        jp, jnp.asarray(toks))
    # the final softcap bounds the logits
    assert float(jnp.abs(want).max()) <= cfg.final_softcap
    for impl in ("auto", "chunked"):
        tm.impl = impl
        got, aux, _ = tm(torch.from_numpy(toks))
        np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL,
                                   err_msg=f"impl={impl}")


def _decode_tokenwise(model, toks, cache, vector, prompt=8):
    """Logits of every position: the first ``prompt`` tokens as one chunk
    (the window and causality through the times), then a token a step."""
    first, _, cache = model(toks[:, :prompt], cache=cache, cache_index=0)
    outs = [first]
    for i in range(prompt, toks.shape[1]):
        idx = torch.full((toks.shape[0],), i) if vector else i
        lg, _, cache = model(toks[:, i:i + 1], cache=cache, cache_index=idx)
        outs.append(lg)
    return torch.cat(outs, 1)


def _reference_tokenwise(jm, jp, toks, cache, prompt=8):
    first, _, cache = jax.jit(
        lambda jp, t, c: jm(jp, t, cache=c, cache_index=0, remat=False))(
        jp, toks[:, :prompt], cache)
    step = jax.jit(lambda jp, t, c, i: jm(jp, t, cache=c, cache_index=i,
                                          remat=False))
    outs = [first]
    for i in range(prompt, toks.shape[1]):
        lg, _, cache = step(jp, toks[:, i:i + 1], cache, jnp.int32(i))
        outs.append(lg)
    return jnp.concatenate(outs, 1)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_decode_matches_prefill_and_reference(cache_dtype):
    """The port's decode (plain decode kernel with the window and the
    softcap, int and vector cursors; and its "chunked" path) against its
    own full forward (float32 caches) and the reference's decode over a
    cache of the same dtype."""
    cfg, jm, jp, tm = pair(seed=2)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    tt = torch.from_numpy(toks)
    max_len = S + 3
    full, _, _ = tm(tt)
    want = _reference_tokenwise(jm, jp, jnp.asarray(toks),
                                jm.init_cache(B, max_len,
                                              getattr(jnp, cache_dtype)))
    for impl, vector in (("auto", False), ("auto", True), ("chunked", True)):
        tm.impl = impl
        got = _decode_tokenwise(tm, tt, tm.init_cache(B, max_len,
                                                      cache_dtype), vector)
        what = f"{cache_dtype} impl={impl} vector={vector}"
        if cache_dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(full), **DECODE_TOL,
                                       err_msg=what)
        np.testing.assert_allclose(
            _np(got), _np(want), err_msg=what + " vs the reference",
            **(BF16_TOL if cache_dtype == "bfloat16" else DECODE_TOL))


@pytest.mark.parametrize("layers", [2, 4])
def test_pair_groups_round_trip(layers):
    """One pair (unstacked) and two (stacked over pairs), both ways,
    bitwise; the port's names carry the pair's half."""
    cfg = jconfigs.get_config(ARCH).reduced(dtype="float32",
                                            num_layers=layers)
    tree = jax.tree.map(np.asarray, jmodule.init_params(
        JLM(cfg).specs(), jax.random.key(5)))
    flat = params.from_reference(tree)
    assert ("groups.0.1.b.attn.q.kernel" in flat) == (layers == 4)
    assert "groups.0.0.a.post_norm_mlp.scale" in flat
    tm = build_model(configs.get_config(ARCH).reduced(
        dtype="float32", num_layers=layers), device="cpu")
    tm.load_state_dict(flat, strict=True)
    back = params.to_reference(tm)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert params.reference_leaf("groups.0.1.a.attn.q.kernel") == \
        "group0.a.attn.q.kernel"
