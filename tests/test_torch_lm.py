"""The port's LM stack against the JAX package on the CPU.

Configs and parameter counts, the activations, ``mha_chunked``, the
stacked cache writes, the full forward of stablelm-3b, phi4-mini-3.8b,
granite-20b, internvl2-26b (with its prefix) and the MoE configs
deepseek-v2-lite-16b (MLA) and kimi-k2-1t-a32b (reduced, float32; the
aux loss too), token-by-token decode against prefill with float32 and
int8 caches (MLA's int8 cache raises), the prefill and serve steps and
``lm_loss``. Weights cross over
through ``params.from_reference``. The reference runs its default
``"chunked"`` attention; the port runs ``impl="auto"`` (the kernels' plain
versions on the CPU) and ``impl="chunked"``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import TransformerLM as JLM  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs, params  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402
from repro_torch.nn.module import count_params  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

DENSE = ("stablelm-3b", "phi4-mini-3.8b", "granite-20b", "internvl2-26b")
MOE = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")
UNPORTED = ("hymba-1.5b", "whisper-base", "rwkv6-7b")
# the reference's own counts of the MoE configs' specs
MOE_COUNTS = {"deepseek-v2-lite-16b": 15_706_484_224,
              "kimi-k2-1t-a32b": 1_028_298_994_688}
FWD_TOL = dict(atol=1e-4, rtol=1e-3)
# tests/test_archs_smoke.py:118-120
DECODE_TOL = dict(atol=2e-3, rtol=2e-2)
B, S = 2, 8


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def pair(arch, seed=0, impl=None, **overrides):
    """(cfg, reference model, reference params, port model) at the reduced
    float32 config, the port holding the reference's weights."""
    cfg = jconfigs.get_config(arch).reduced(dtype="float32", **overrides)
    jm = JLM(cfg)
    jp = jmodule.init_params(jm.specs(), jax.random.key(seed))
    tcfg = configs.get_config(arch).reduced(dtype="float32", **overrides)
    tm = build_model(tcfg, impl, device="cpu")
    tm.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                       strict=True)
    return cfg, jm, jp, tm


def inputs(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    prefix = None
    if cfg.vision_prefix:
        prefix = rng.normal(size=(B, cfg.vision_prefix, cfg.d_model)
                            ).astype(np.float32)
    return toks, prefix


def as_torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_config_matches_reference(arch):
    want = dataclasses.asdict(jconfigs.get_config(arch))
    got = dataclasses.asdict(configs.get_config(arch))
    assert got == want
    assert configs.get_config(arch).padded_vocab == \
        jconfigs.get_config(arch).padded_vocab
    assert dataclasses.asdict(configs.get_config(arch).reduced()) == \
        dataclasses.asdict(jconfigs.get_config(arch).reduced())


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_count_params_on_meta(arch):
    """Full width, nothing allocated: the reference's count of its specs."""
    model = build_model(configs.get_config(arch), device="meta")
    want = jmodule.count_params(JLM(jconfigs.get_config(arch)).specs())
    assert count_params(model) == want
    if arch == "phi4-mini-3.8b":
        assert want == 3_836_021_760
    if arch in MOE_COUNTS:
        assert want == MOE_COUNTS[arch]


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_family_raises(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        build_model(configs.get_config(arch), device="meta")


def test_activations_match_jax():
    x = np.linspace(-6.0, 6.0, 1001, dtype=np.float32)
    for name in ("gelu", "gelu_tanh", "silu", "relu", "relu2"):
        got = tlayers.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
        want = np.asarray(jlayers.ACTIVATIONS[name](jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
    # the reference's "gelu" is jax.nn.gelu's default, the tanh form
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("offset", ["scalar", "vector"])
def test_mha_chunked_matches_reference(offset):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 600, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 600, 16)).astype(np.float32)
    off = 300 if offset == "scalar" else np.array([7, 590], np.int32)
    kvl = np.array([305, 596], np.int32)
    kw = dict(causal=True, scale=0.3, kv_length=kvl)
    want = jref.mha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_offset=jnp.asarray(off), **kw)
    toff = off if offset == "scalar" else torch.from_numpy(off)
    got = tref.mha_chunked(*map(torch.from_numpy, (q, k, v)), q_offset=toff,
                           **dict(kw, kv_length=torch.from_numpy(kvl)))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)
    oracle = tref.mha_reference(*map(torch.from_numpy, (q, k, v)),
                                q_offset=toff,
                                **dict(kw, kv_length=torch.from_numpy(kvl)))
    np.testing.assert_allclose(_np(got), _np(oracle), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("index", [0, 13, 15, "vector"])
def test_cache_update_matches_reference(index):
    """A scalar index clamps as dynamic_update_slice does (n = 3 rows at
    13 or 15 land at [13, 16)); a vector index writes one row a slot and
    drops a row past the cache, as the reference's scatter does."""
    rng = np.random.default_rng(4)
    cache = rng.normal(size=(3, 2, 16, 4)).astype(np.float32)
    n = 1 if index == "vector" else 3
    new = rng.normal(size=(3, 2, n, 4)).astype(np.float32)
    idx = np.array([5, 16, 0], np.int32) if index == "vector" else index
    want = jattn._cache_update(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(idx))
    buf = torch.from_numpy(cache.copy())[None]
    tidx = torch.from_numpy(idx) if index == "vector" else idx
    step = tattn.cache_step(tidx, n, 3, 16, "cpu")
    tattn._cache_update(buf, 0, torch.from_numpy(new), step)
    np.testing.assert_array_equal(buf[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_matches_reference(arch):
    cfg, jm, jp, tm = pair(arch)
    toks, prefix = inputs(cfg, 1)
    want, want_aux, _ = jax.jit(lambda jp, t, pre: jm(
        jp, t, remat=False, prefix_embeds=pre))(
        jp, jnp.asarray(toks), None if prefix is None else jnp.asarray(prefix))
    for impl in ("auto", "chunked"):
        tm.impl = impl
        got, aux, cache = tm(torch.from_numpy(toks),
                             prefix_embeds=as_torch(prefix))
        assert cache is None
        if arch in MOE:
            assert float(aux) > 0.0
            np.testing.assert_allclose(float(aux), float(want_aux), **FWD_TOL)
        else:
            assert float(aux) == float(want_aux) == 0.0
        np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL,
                                   err_msg=f"{arch} impl={impl}")


def _decode_tokenwise(model, toks, prefix, cache, vector):
    """Logits of each token position from a decode over ``cache``: the
    prefix (if any) and the first token as one chunk, then a token a step
    (an int index, or a (B,) index tensor)."""
    p = 0 if prefix is None else prefix.shape[1]
    first, _, cache = model(toks[:, :1], prefix_embeds=prefix, cache=cache,
                            cache_index=0)
    outs = [first[:, p:]]
    for i in range(1, toks.shape[1]):
        idx = torch.full((toks.shape[0],), p + i) if vector else p + i
        lg, _, cache = model(toks[:, i:i + 1], cache=cache, cache_index=idx)
        outs.append(lg)
    return torch.cat(outs, 1)


def _reference_tokenwise(jm, jp, toks, prefix, cache):
    p = 0 if prefix is None else prefix.shape[1]
    first, _, cache = jax.jit(
        lambda jp, t, pre, c: jm(jp, t, prefix_embeds=pre, cache=c,
                                 cache_index=0, remat=False))(
        jp, toks[:, :1], prefix, cache)
    step = jax.jit(lambda jp, t, c, i: jm(jp, t, cache=c, cache_index=i,
                                          remat=False))
    outs = [first[:, p:]]
    for i in range(1, toks.shape[1]):
        lg, _, cache = step(jp, toks[:, i:i + 1], cache, jnp.int32(p + i))
        outs.append(lg)
    return jnp.concatenate(outs, 1)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_decode_matches_prefill(arch, cache_dtype):
    """Token-by-token decode (the port's kernels' plain versions, int and
    vector cursors; and its "chunked" path) against the full forward; an
    int8 cache is also held to the reference's int8 run of the same
    prompts. MLA (deepseek) has no int8 cache: asking for one raises."""
    cfg, jm, jp, tm = pair(arch, seed=2)
    if cfg.attention_kind == "mla" and cache_dtype == "int8":
        with pytest.raises(NotImplementedError, match="int8"):
            tm.init_cache(B, S, cache_dtype)
        return
    toks, prefix = inputs(cfg, 2)
    tt, tp = torch.from_numpy(toks), as_torch(prefix)
    p = 0 if prefix is None else prefix.shape[1]
    max_len = p + S + 3
    full, _, _ = tm(tt, prefix_embeds=tp)
    full = full[:, p:]
    jcache = jm.init_cache(B, max_len, getattr(jnp, cache_dtype))
    want = _reference_tokenwise(jm, jp, jnp.asarray(toks),
                                None if prefix is None
                                else jnp.asarray(prefix), jcache)
    for impl, vector in (("auto", False), ("auto", True), ("chunked", True)):
        tm.impl = impl
        got = _decode_tokenwise(tm, tt, tp, tm.init_cache(B, max_len,
                                                          cache_dtype),
                                vector)
        what = f"{arch} {cache_dtype} impl={impl} vector={vector}"
        if cache_dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(full), **DECODE_TOL,
                                       err_msg=what)
        np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL,
                                   err_msg=what + " vs the reference")


def test_params_round_trip_lm():
    """Stacked groups and a group of one layer, both ways, bitwise."""
    for layers in (2, 1):
        cfg = jconfigs.get_config("granite-20b").reduced(
            dtype="float32", num_layers=layers)
        tree = jax.tree.map(np.asarray, jmodule.init_params(
            JLM(cfg).specs(), jax.random.key(5)))
        flat = params.from_reference(tree)
        assert ("groups.0.1.attn.q.bias" in flat) == (layers == 2)
        assert "pos_embedding.embedding" in flat and "lm_head.kernel" in flat
        back = params.to_reference(flat)
        jax.tree.map(np.testing.assert_array_equal, back, tree)
        assert params.reference_leaf("groups.0.1.mlp.up.kernel") == \
            "group0.mlp.up.kernel"


def test_steps_and_loss_match_reference():
    cfg, jm, jp, tm = pair("phi4-mini-3.8b", seed=6)
    toks, _ = inputs(cfg, 6)
    want = jax.jit(jsteps.make_prefill_step(cfg))(
        jp, {"tokens": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)
    jcache = jm.init_cache(B, 12, jnp.float32)
    tcache = tm.init_cache(B, 12, torch.float32)
    jserve = jax.jit(jsteps.make_serve_step(cfg))
    tserve = tsteps.make_serve_step(tm)
    for i in range(3):
        wl, jcache = jserve(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        gl, tcache = tserve(tcache, torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(gl), _np(wl), **DECODE_TOL)
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(B, S, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (B, S)).astype(np.int32)
    mask = rng.random((B, S)) < 0.6
    for m in (None, mask):
        want = jsteps.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                              None if m is None else jnp.asarray(m))
        got = tsteps.lm_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), as_torch(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
