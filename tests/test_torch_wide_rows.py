"""Rows wider than 256, on the CPU: se2_fourier at head_dim 36 (c = 300).

The reference takes any head_dim divisible by 6; at head_dim 36 the
cached rows are 300 wide, past the 256 columns the port's attention
kernels keep in registers, so on the card they run balanced column
windows (``csrc/mma_tf32.cuh``; held to their plain versions at c = 300
and 500 in ``tests/test_torch_cuda.py``). Here the model is held to the
reference at ``attn_impl="ref"`` and ``"flash"`` (Pallas in interpret
mode): the full forward, prefill plus every step (``tests/test_decode.py``'s
float32 tolerance, atol 2e-4 / rtol 2e-3), and a free-running rollout
against the reference engine's (a lane may part only at a near-tie, as in
``tests/test_torch_rollout.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs  # noqa: E402
from repro import scenarios as jscen  # noqa: E402
from repro.data import scenarios as jdata  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.runtime.rollout import RolloutEngine as JaxEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch import scenarios as tscen  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime import rollout as trollout  # noqa: E402
from test_torch_serving_utils import diverged_lanes, score_gaps  # noqa: E402

SCEN_KW = dict(num_map=6, num_agents=3, num_steps=5)
T_HIST = 2
TOL = dict(atol=2e-4, rtol=2e-3)
CFG = dict(d_model=72, num_layers=2, num_heads=2, head_dim=36, d_ff=144,
           fourier_terms=12)


@pytest.fixture(scope="module")
def setup():
    scen_j = jscen.ScenarioConfig(**SCEN_KW)
    scen_t = tscen.ScenarioConfig(**SCEN_KW)
    jcfg = dict(**CFG, num_actions=scen_j.num_actions)
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(**jcfg))
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(5))
    tmodel = tsim.AgentSimModel(tsim.AgentSimConfig(**jcfg), device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    return scen_j, scen_t, jcfg, jparams, tmodel


def test_cached_rows_are_300_wide(setup):
    tmodel = setup[4]
    assert tmodel.blocks[0].attn.cache_dims == (300, 300)


@pytest.mark.parametrize("ref_impl", ["ref", "flash"])
def test_head_dim_36_model_matches_reference(setup, ref_impl):
    scen_j, _, jcfg, jparams, tmodel = setup
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(**jcfg,
                                                    attn_impl=ref_impl))
    batch = jdata.generate_batch(0, 0, 2, scen_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    want, _ = jmodel(jparams, jb)
    np.testing.assert_allclose(tmodel(tb).numpy(), np.asarray(want), **TOL,
                               err_msg="full forward")
    b = batch["map_feats"].shape[0]
    max_len = scen_j.num_map + scen_j.num_steps * scen_j.num_agents
    hist = lambda d: {k: (v[:, :T_HIST] if k.startswith("agent") else v)  # noqa
                      for k, v in d.items()}
    want, jcache = jmodel.prefill(jparams, jmodel.init_cache(b, max_len),
                                  hist(jb), impl="flash_decode"
                                  if ref_impl == "flash" else "xla")
    got, tcache = tmodel.prefill(tmodel.init_cache(b, max_len), hist(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg="prefill")
    for t in range(T_HIST, scen_j.num_steps):
        want, jcache = jmodel.step(
            jparams, jcache, jb["agent_feats"][:, t], jb["agent_pose"][:, t],
            jb["agent_valid"][:, t], jnp.full((b,), t, jnp.int32), impl="xla")
        got, tcache = tmodel.step(
            tcache, tb["agent_feats"][:, t], tb["agent_pose"][:, t],
            tb["agent_valid"][:, t], torch.full((b,), t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")


def test_head_dim_36_rollout_matches_reference(setup):
    scen_j, scen_t, jcfg, jparams, tmodel = setup
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(**jcfg,
                                                    decode_impl="xla"))
    scenes = [tscen.generate_scene("freeform", 1, i, scen_t)
              for i in range(3)]
    n_samples, seed = 2, 11
    jeng = JaxEngine(jmodel, jparams, scen_j, num_slots=4, registry=obs.NULL)
    want = jeng.run([s.tensors for s in scenes], t_hist=T_HIST,
                    n_samples=n_samples, seed=seed)
    teng = trollout.RolloutEngine(tmodel, scen_t, device="cpu", num_slots=4)
    got = teng.run(scenes, t_hist=T_HIST, n_samples=n_samples, seed=seed)
    gaps = score_gaps(tmodel, scen_t, scenes, T_HIST, n_samples, seed)
    diverged = diverged_lanes(teng.last_actions, jeng.last_actions, gaps)
    for si in range(len(scenes)):
        for ki in range(n_samples):
            upto = diverged.get((si, ki), got.shape[2])
            np.testing.assert_allclose(got[si, ki, :upto], want[si, ki, :upto],
                                       atol=1e-4, err_msg=f"lane {si}, {ki}")
    assert len(diverged) <= 1, f"lanes {diverged} diverged at near-ties"
