"""Row widths that are not a multiple of 4, on the CPU.

se2_fourier caches rows 50 * head_dim / 6 wide. The reference takes any
head_dim divisible by 6 (``src/repro/core/encodings.py:331``); at head_dim
18 the cached rows are 150 wide, which the port's kernels take since they
copy rows in 8- or 4-byte units where a row does not start 16-byte
aligned. Here a head_dim-18 model is held to the reference at
``attn_impl="ref"`` and ``"flash"`` (Pallas in interpret mode): the full
forward, and prefill plus every step against the reference's, at
``tests/test_decode.py``'s float32 tolerance (atol 2e-4, rtol 2e-3). And
the port's ``serve_sim`` launcher builds at its defaults the model the
reference's ``launch/serve_sim.py`` builds: head_dim 18, not rounded up to
a multiple of 12. The kernels themselves at these widths are held to their
plain versions on the card (``tests/test_torch_cuda.py``).
"""
import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import scenarios as jscen  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.launch import serve_sim as tserve  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCEN = jscen.ScenarioConfig(num_map=6, num_agents=3, num_steps=5)
T_HIST = 2
TOL = dict(atol=2e-4, rtol=2e-3)
CFG = dict(d_model=36, num_layers=2, num_heads=2, head_dim=18, d_ff=72,
           num_actions=SCEN.num_actions, fourier_terms=12)


@pytest.fixture(scope="module")
def tmodel_and_params():
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(**CFG))
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(3))
    tmodel = tsim.AgentSimModel(tsim.AgentSimConfig(**CFG), device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    return tmodel, jparams


def test_cached_rows_are_150_wide(tmodel_and_params):
    tmodel, _ = tmodel_and_params
    assert tmodel.blocks[0].attn.cache_dims == (150, 150)
    assert tmodel.init_cache(1, 8)["k"].shape[-1] == 150


@pytest.mark.parametrize("ref_impl", ["ref", "flash"])
def test_head_dim_18_model_matches_reference(tmodel_and_params, ref_impl):
    tmodel, jparams = tmodel_and_params
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(**CFG,
                                                    attn_impl=ref_impl))
    batch = jscen.generate_batch(0, 0, 2, SCEN)
    batch["agent_valid"] = batch["agent_valid"].copy()
    batch["agent_valid"][0, 2:, -1] = False
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    want, _ = jmodel(jparams, jb)
    np.testing.assert_allclose(tmodel(tb).numpy(), np.asarray(want), **TOL,
                               err_msg="full forward")
    b = batch["map_feats"].shape[0]
    max_len = SCEN.num_map + SCEN.num_steps * SCEN.num_agents
    hist = lambda d: {k: (v[:, :T_HIST] if k.startswith("agent") else v)  # noqa
                      for k, v in d.items()}
    jcache = jmodel.init_cache(b, max_len)
    tcache = tmodel.init_cache(b, max_len)
    want, jcache = jmodel.prefill(jparams, jcache, hist(jb),
                                  impl="flash_decode" if ref_impl == "flash"
                                  else "xla")
    got, tcache = tmodel.prefill(tcache, hist(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg="prefill")
    jstep = jax.jit(jmodel.step, static_argnames=("impl",))
    for t in range(T_HIST, SCEN.num_steps):
        want, jcache = jstep(
            jparams, jcache, jb["agent_feats"][:, t], jb["agent_pose"][:, t],
            jb["agent_valid"][:, t], jnp.full((b,), t, jnp.int32), impl="xla")
        got, tcache = tmodel.step(
            tcache, tb["agent_feats"][:, t], tb["agent_pose"][:, t],
            tb["agent_valid"][:, t], torch.full((b,), t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")


def _reference_serve_sim():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_sim", ROOT / "launch" / "serve_sim.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("argv", [[], ["--d-model", "96", "--heads", "8"],
                                  ["--encoding", "rope2d"]])
def test_serve_sim_builds_the_reference_model(argv):
    """The launcher's flags through both ``build`` functions give the same
    model config (the port's adds only its device); at the defaults,
    head_dim 18 (d_model 64 / 4 heads = 16, rounded up to a multiple of
    6), a 150-wide cached row."""
    args = tserve.build_parser().parse_args(argv + ["--device", "cpu"])
    _, tmodel = tserve.build(args)
    _, jmodel, _ = _reference_serve_sim().build(argparse.Namespace(**vars(
        args)))
    got, want = vars(tmodel.cfg), vars(jmodel.cfg)
    for key, value in want.items():
        if key in ("attn_impl", "decode_impl"):
            continue                     # the backends' defaults differ
        assert got[key] == value, key
    if not argv:
        assert tmodel.cfg.head_dim == 18
        assert tmodel.blocks[0].attn.cache_dims == (150, 150)
