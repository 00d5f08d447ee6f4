"""Parity: the port's agent-sim model against the JAX reference on shared
weights, on the CPU.

A 2-layer model (d_model 48, head_dim 24) of each Table-I encoding
(absolute, rope2d, se2_repr, se2_fourier) with the reference's weights
carried across by ``repro_torch.params.from_reference``: full forward
logits, and prefill plus every ``step`` against the reference's prefill
and ``step`` per tick, on freeform scenes at their metric poses (the
absolute baseline's pose embedding reads them raw). Tolerances are
tests/test_decode.py's: atol 2e-4 / rtol 2e-3 in f32, and atol = rtol =
8e-2 for an int8 cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import scenarios as jscen  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402

SCEN = jscen.ScenarioConfig(num_map=6, num_agents=3, num_steps=5)
T_HIST = 2
TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
       "int8": dict(atol=8e-2, rtol=8e-2)}
CFG = dict(d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
           num_actions=SCEN.num_actions, fourier_terms=8)


ENCODINGS = ["absolute", "rope2d", "se2_fourier", "se2_repr"]


@pytest.fixture(scope="module", params=ENCODINGS)
def models(request):
    jcfg = jsim.AgentSimConfig(**CFG, encoding=request.param,
                               attn_impl="ref")
    jmodel = jsim.AgentSimModel(jcfg)
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(0))
    tmodel = tsim.AgentSimModel(
        tsim.AgentSimConfig(**CFG, encoding=request.param), device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _batch(invalid):
    b = jscen.generate_batch(0, 0, 2, SCEN)
    if invalid:
        b["agent_valid"] = b["agent_valid"].copy()
        b["agent_valid"][0, 2:, -1] = False     # one agent drops out
        b["map_valid"] = b["map_valid"].copy()
        b["map_valid"][1, -2:] = False          # padded map tokens
    return b


def _t(arr):
    return torch.from_numpy(np.array(arr))


@pytest.mark.parametrize("invalid", [False, True])
def test_full_forward_matches_reference(models, invalid):
    jmodel, jparams, tmodel = models
    batch = _batch(invalid)
    want, _ = jmodel(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tmodel({k: _t(v) for k, v in batch.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_prefill_and_steps_match_reference(models, cache_dtype, invalid):
    jmodel, jparams, tmodel = models
    batch = _batch(invalid)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    b = batch["map_feats"].shape[0]
    max_len = SCEN.num_map + SCEN.num_steps * SCEN.num_agents
    hist = lambda d: {k: (v[:, :T_HIST] if k.startswith("agent") else v)  # noqa
                      for k, v in d.items()}
    jcache = jmodel.init_cache(b, max_len, dtype=cache_dtype)
    tcache = tmodel.init_cache(b, max_len, dtype=cache_dtype)
    want, jcache = jmodel.prefill(jparams, jcache, hist(jb), impl="xla")
    got, tcache = tmodel.prefill(tcache, hist(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL[cache_dtype], err_msg="prefill")
    for t in range(T_HIST, SCEN.num_steps):
        want, jcache = jmodel.step(
            jparams, jcache, jb["agent_feats"][:, t], jb["agent_pose"][:, t],
            jb["agent_valid"][:, t], jnp.full((b,), t, jnp.int32), impl="xla")
        got, tcache = tmodel.step(
            tcache, tb["agent_feats"][:, t], tb["agent_pose"][:, t],
            tb["agent_valid"][:, t], torch.full((b,), t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[cache_dtype], err_msg=f"step {t}")
    assert tcache["cursor"].tolist() == [max_len] * b
    for key in ("times", "seg"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    if cache_dtype == "int8":
        assert tcache["k"].dtype == torch.int8 and "v_scale" in tcache


def test_cached_decode_matches_full_forward(models):
    """The port on its own: prefill + steps reproduce its full forward
    (the soundness of caching phi_k-transformed rows)."""
    _, _, tmodel = models
    tb = {k: _t(v) for k, v in _batch(True).items()}
    full = tmodel(tb)
    cache = tmodel.init_cache(2, 64)
    got, cache = tmodel.prefill(
        cache, {k: (v[:, :1] if k.startswith("agent") else v)
                for k, v in tb.items()})
    np.testing.assert_allclose(got.numpy(), full[:, :1].numpy(),
                               **TOL["float32"])
    for t in range(1, SCEN.num_steps):
        lt, cache = tmodel.step(cache, tb["agent_feats"][:, t],
                                tb["agent_pose"][:, t],
                                tb["agent_valid"][:, t],
                                torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(lt.numpy(), full[:, t].numpy(),
                                   **TOL["float32"], err_msg=f"step {t}")


def test_action_nll_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 3, 63)).astype(np.float32)
    actions = rng.integers(0, 63, (2, 5, 3)).astype(np.int32)
    valid = rng.random((2, 5, 3)) < 0.7
    want = jsim.action_nll(jnp.asarray(logits), jnp.asarray(actions),
                           jnp.asarray(valid))
    got = tsim.action_nll(_t(logits), _t(actions), _t(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_parameter_count_matches_reference(models):
    jmodel, _, tmodel = models
    assert sum(p.numel() for p in tmodel.parameters()) == \
        jmodule.count_params(jmodel.specs())
    assert tmodel.blocks[0].attn.cache_dims == jmodel.attn.cache_dims
    assert hasattr(tmodel, "pose_proj") == (jmodel.cfg.encoding ==
                                            "absolute")
