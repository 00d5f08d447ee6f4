"""Parity at ``dtype="bfloat16"``: the port's agent-sim model against the
JAX reference at the same setting, on shared weights, on the CPU.

A 2-layer model (d_model 48, head_dim 24, F = 8) of each Table-I encoding,
weights carried across by ``repro_torch.params.from_reference``: the full
forward, prefill and every ``step`` (bf16 cache, the default), the port's
cached decode against its own full forward, and one train step's loss and
float32 gradients.

Tolerance: the reference's own for bf16, atol = rtol = 8e-2
(``tests/test_decode.py:306-307``). The two frameworks round bf16 in
different places (XLA may fuse a chain of bf16 ops into one float32
computation, PyTorch's CPU kernels round each op's output), so the outputs
agree to bf16's few digits, not bitwise. Gradients are compared per tensor
against 8e-2 of the reference's largest |g| in that tensor, for the same
reason.
"""
import dataclasses

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
from repro_torch.training import steps as tsteps  # noqa: E402

SCEN = jscen.ScenarioConfig(num_map=6, num_agents=3, num_steps=5)
T_HIST = 2
TOL = dict(atol=8e-2, rtol=8e-2)
CFG = dict(d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
           num_actions=SCEN.num_actions, fourier_terms=8, dtype="bfloat16")
ENCODINGS = ["absolute", "rope2d", "se2_fourier", "se2_repr"]


@pytest.fixture(scope="module", params=ENCODINGS)
def models(request):
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(
        **CFG, encoding=request.param, attn_impl="ref"))
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(0))
    tmodel = tsim.AgentSimModel(
        tsim.AgentSimConfig(**CFG, encoding=request.param), device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _batch(actions=False):
    b = jscen.generate_batch(0, 0, 2, SCEN)
    b["agent_valid"] = b["agent_valid"].copy()
    b["agent_valid"][0, 2:, -1] = False         # one agent drops out
    if actions:
        rng = np.random.default_rng(4)
        b["actions"] = rng.integers(0, SCEN.num_actions,
                                    b["agent_valid"].shape).astype(np.int32)
    return b


def _f32(x):
    return np.asarray(x, np.float32)


def test_compute_dtype_and_cache_default(models):
    """bf16 logits out of every path, float32 parameters kept, the cache
    in the compute dtype by default, as the reference's."""
    jmodel, _, tmodel = models
    assert tmodel.cfg.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    tcache = tmodel.init_cache(2, 32)
    jcache = jmodel.init_cache(2, 32)
    assert tcache["k"].dtype == torch.bfloat16 == tcache["v"].dtype
    assert jcache["k"].dtype == jnp.bfloat16
    got = tmodel({k: torch.from_numpy(np.asarray(v))
                  for k, v in _batch().items()})
    assert got.dtype == torch.bfloat16


def test_full_forward_prefill_and_steps_match_reference(models):
    jmodel, jparams, tmodel = models
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    want, _ = jmodel(jparams, jb)
    full = tmodel(tb)
    np.testing.assert_allclose(_f32(full.float()), _f32(want), **TOL,
                               err_msg="full forward")
    b = batch["map_feats"].shape[0]
    max_len = SCEN.num_map + SCEN.num_steps * SCEN.num_agents
    hist = lambda d: {k: (v[:, :T_HIST] if k.startswith("agent") else v)  # noqa
                      for k, v in d.items()}
    jcache = jmodel.init_cache(b, max_len)
    tcache = tmodel.init_cache(b, max_len)
    want, jcache = jmodel.prefill(jparams, jcache, hist(jb), impl="xla")
    got, tcache = tmodel.prefill(tcache, hist(tb))
    np.testing.assert_allclose(_f32(got.float()), _f32(want), **TOL,
                               err_msg="prefill")
    # the port's cached decode against its own full forward too
    np.testing.assert_allclose(_f32(got.float()),
                               _f32(full[:, :T_HIST].float()), **TOL,
                               err_msg="prefill vs full forward")
    jstep = jax.jit(jmodel.step, static_argnames=("impl",))
    for t in range(T_HIST, SCEN.num_steps):
        want, jcache = jstep(
            jparams, jcache, jb["agent_feats"][:, t], jb["agent_pose"][:, t],
            jb["agent_valid"][:, t], jnp.full((b,), t, jnp.int32), impl="xla")
        got, tcache = tmodel.step(
            tcache, tb["agent_feats"][:, t], tb["agent_pose"][:, t],
            tb["agent_valid"][:, t], torch.full((b,), t, dtype=torch.int32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got.float()), _f32(want), **TOL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_f32(got.float()),
                                   _f32(full[:, t].float()), **TOL,
                                   err_msg=f"step {t} vs full forward")


def test_train_step_loss_and_grads_match_reference(models):
    """One train step's loss and its gradients: the forward on the
    parameters cast to bf16 (``cast_params`` / ``params.cast``), the
    gradients float32 in both packages."""
    jmodel, jparams, tmodel = models
    jmodel = jsim.AgentSimModel(dataclasses.replace(jmodel.cfg,
                                                    attn_impl="ref"))
    batch = _batch(actions=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p32):
        p = jmodule.cast_params(p32, jnp.bfloat16)
        logits, aux = jmodel(p, jb)
        return jsim.action_nll(logits, jb["actions"],
                               jb["agent_valid"]) + aux

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    model = tsim.AgentSimModel(tmodel.cfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    step = tsteps.make_sim_train_step(model, tsteps.bc_optimizer(3e-3, 10))
    grads, metrics = step.grads(batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               **TOL)
    want = tparams.from_reference(jax.tree.map(np.asarray, want_grads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        w = want[name].numpy().astype(np.float32)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, atol=8e-2 * scale, rtol=0,
                                   err_msg=name)
