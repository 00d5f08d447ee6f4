"""Parity: the port's fault-tolerant ``Trainer`` against the JAX package's,
from shared weights, at the reference's own small trainer config
(``tests/test_trainer_server.py:107-118``: 2 layers, d_model 32, 2 heads x
12, se2_fourier, batch 2 of mixed-family scenes, 8 map + 6 x 3 agent
tokens, ``chain(clip_by_global_norm(1), adamw(3e-3))``).

* 6 steps: the loss histories agree within LOSS_RTOL;
* a resume across the packages: 5 steps in one package, a checkpoint, 5
  more in the other, against the JAX package's straight 10 steps;
* a NaN-skipped step leaves the parameters and the optimizer state bitwise
  as they were;
* the port alone: the NaN halt, preemption, the eval hook's cadence with a
  bitwise-equal history, and telemetry on and off.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.data.pipeline import ShardedIterator as JIterator  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JConfig  # noqa: E402
from repro.scenarios import ScenarioConfig as JScenario  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.data import ShardedIterator  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime import RolloutEngine  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.scenarios import registry as tregistry  # noqa: E402
from repro_torch.scenarios.core import ScenarioConfig  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

SCEN_ARGS = dict(num_map=8, num_agents=3, num_steps=6)
MODEL_ARGS = dict(d_model=32, num_layers=2, num_heads=2, head_dim=12,
                  d_ff=64, encoding="se2_fourier")
LR = 3e-3
# The reference's own resume tolerances (tests/test_trainer_server.py:
# 145-149). Both packages sum float32 in another order (the port's plain
# flash forward and backward against the reference's oracle), so AdamW's
# near-sign updates could in principle flip a weight whose gradient is
# float32 noise; on this config over 10 steps the losses agree to 1.7e-7
# relative and the weights to 1.6e-7 (CPU), far inside both.
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6


def _jax_everything(ckpt_dir, total_steps, seed=0):
    scen = JScenario(**SCEN_ARGS)
    model = jsim.AgentSimModel(jsim.AgentSimConfig(
        num_actions=scen.num_actions, attn_impl="ref", **MODEL_ARGS))
    params = jmodule.init_params(model.specs(), jax.random.key(seed))
    opt = joptim.chain(joptim.clip_by_global_norm(1.0), joptim.adamw(LR))
    step = jax.jit(jsteps.make_sim_train_step(model, opt))
    data = JIterator(jdata.make_batch_fn(scen), batch_size=2, seed=0)
    return JTrainer(step, params, opt.init(params), data, str(ckpt_dir),
                    JConfig(total_steps=total_steps, ckpt_every=5,
                            log_every=100))


def _port_everything(ckpt_dir, total_steps, jparams=None, registry=None,
                     **cfg):
    scen = ScenarioConfig(**SCEN_ARGS)
    model = tsim.AgentSimModel(tsim.AgentSimConfig(
        num_actions=scen.num_actions, **MODEL_ARGS), device="cpu")
    if jparams is not None:
        model.load_state_dict(tparams.from_reference(
            jax.tree.map(np.asarray, jparams)))
    opt = toptim.chain(toptim.clip_by_global_norm(1.0), toptim.adamw(LR))
    step = tsteps.make_sim_train_step(model, opt)
    data = ShardedIterator(tdata.make_batch_fn(scen), batch_size=2, seed=0)
    config = TrainerConfig(total_steps=total_steps, ckpt_every=5,
                           log_every=100)
    for k, v in cfg.items():
        setattr(config, k, v)
    return Trainer(step, model, opt.init(dict(model.named_parameters())),
                   data, str(ckpt_dir), config, registry=registry)


def _close(*trainers):
    for tr in trainers:
        tr.data.close()


def _state_copy(tr):
    params = {k: v.clone() for k, v in tr.model.state_dict().items()}
    return params, tr.opt_state[1]["step"], {
        m: {k: v.clone() for k, v in tr.opt_state[1][m].items()}
        for m in ("mu", "nu")}


def _assert_bitwise(a, b):
    assert a[1] == b[1]
    for x, y in ((a[0], b[0]), (a[2]["mu"], b[2]["mu"]),
                 (a[2]["nu"], b[2]["nu"])):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_trainer_loss_history_matches_reference(tmp_path):
    jtr = _jax_everything(tmp_path / "jax", 6)
    ttr = _port_everything(tmp_path / "torch", 6, jtr.params)
    jout, tout = jtr.run(), ttr.run()
    assert jout["status"] == tout["status"] == "done"
    assert ttr.step == jtr.step == 6 and ttr.data.cursor == jtr.data.cursor
    np.testing.assert_allclose(ttr.history, jtr.history, rtol=LOSS_RTOL)
    _close(jtr, ttr)


def _port_params_as_reference(tr):
    return jax.tree_util.tree_flatten_with_path(
        tparams.to_reference(tr.model))[0]


def test_resume_across_packages_matches_straight_run(tmp_path):
    """JAX trains 5 steps and checkpoints; the port restores and trains 5
    more; the result matches the JAX package's straight 10 steps. Then
    the other way: the port's 5 steps restored by the JAX trainer."""
    full = _jax_everything(tmp_path / "full", 10)
    full.run()
    # JAX -> port
    first = _jax_everything(tmp_path / "a", 5)
    first.run()
    second = _port_everything(tmp_path / "a", 10)
    assert second.restore_if_available()
    assert second.step == 5 and second.data.cursor == 5
    second.run()
    np.testing.assert_allclose(second.history, full.history[5:],
                               rtol=LOSS_RTOL)
    want = dict(jax.tree_util.tree_flatten_with_path(full.params)[0])
    for path, got in _port_params_as_reference(second):
        np.testing.assert_allclose(got, np.asarray(want[path]),
                                   atol=PARAM_ATOL, err_msg=str(path))
    # port -> JAX
    port_first = _port_everything(tmp_path / "b", 5, full_start(tmp_path))
    port_first.run()
    jax_second = _jax_everything(tmp_path / "b", 10)
    assert jax_second.restore_if_available()
    assert jax_second.step == 5 and jax_second.data.cursor == 5
    jax_second.run()
    np.testing.assert_allclose(jax_second.history, full.history[5:],
                               rtol=LOSS_RTOL)
    _close(full, first, second, port_first, jax_second)


def full_start(tmp_path):
    tr = _jax_everything(tmp_path / "start", 0)
    tr.data.close()
    return tr.params


def test_port_resume_is_exact(tmp_path):
    """Kill-and-resume within the port: the same data order and bitwise
    the same parameters and history as a straight run."""
    jparams = full_start(tmp_path)
    full = _port_everything(tmp_path / "full", 10, jparams)
    full.run()
    a = _port_everything(tmp_path / "r", 5, jparams)
    a.run()
    b = _port_everything(tmp_path / "r", 10)
    assert b.restore_if_available() and b.step == 5
    b.run()
    assert b.history == full.history[5:]
    _assert_bitwise(_state_copy(b), _state_copy(full))
    _close(full, a, b)


class _NaNAt:
    """Poisons the loss of host call ``at`` and checks, at the next call,
    that the trainer left the parameters and optimizer state bitwise as
    they were before the poisoned step."""

    def __init__(self, tr, at):
        self.tr, self.at, self.calls = tr, at, 0
        self.inner = tr.step_fn
        self.update = self.inner.update
        self.before = None
        self.checked = False

    def grads(self, batch):
        if self.calls == self.at:
            self.before = _state_copy(self.tr)
        if self.calls == self.at + 1:
            _assert_bitwise(_state_copy(self.tr), self.before)
            self.checked = True
        g, metrics = self.inner.grads(batch)
        if self.calls == self.at:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        self.calls += 1
        return g, metrics


def test_nan_skipped_step_leaves_state_bitwise_unchanged(tmp_path):
    tr = _port_everything(tmp_path, 6, full_start(tmp_path))
    tr.step_fn = _NaNAt(tr, at=3)
    out = tr.run()
    assert out == {"status": "done", "step": 6, "final_loss": tr.history[-1],
                   "nan_skipped": 1}
    assert tr.step_fn.checked and len(tr.history) == 5
    assert tr.obs.counter("trainer.nan_skipped").value >= 1
    tr.data.close()


def test_nan_halt_saves_tagged_checkpoint(tmp_path):
    tr = _port_everything(tmp_path, 10, max_consecutive_nans=3)
    inner = tr.step_fn

    class Always:
        update = inner.update

        @staticmethod
        def grads(batch):
            g, m = inner.grads(batch)
            return g, dict(m, loss=float("nan"))

    before = _state_copy(tr)
    tr.step_fn = Always
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        tr.run()
    _assert_bitwise(_state_copy(tr), before)
    assert tr.ckpt.restore(fallback=True)[1]["halt_reason"] == "nan"
    again = _port_everything(tmp_path, 10)
    with pytest.raises(RuntimeError, match="--force"):
        again.restore_if_available()
    # the halting step is not counted: steps 0 and 1 skipped, 2 halted
    assert again.restore_if_available(force=True) and again.step == 2
    _close(tr, again)


def test_preemption_checkpoints_and_resumes(tmp_path):
    tr = _port_everything(tmp_path, 10)
    tr.should_stop = lambda: tr.step >= 3
    out = tr.run()
    assert out["status"] == "preempted" and out["step"] == 3
    assert tr.ckpt.latest_step() == 3
    again = _port_everything(tmp_path, 10)
    assert again.restore_if_available() and again.step == 3
    assert again.data.cursor == 3
    _close(tr, again)


def test_eval_hook_cadence_leaves_training_bitwise_unchanged(tmp_path):
    """The hook rolls the model out (its parameters require gradients) and
    scores it open-loop; the history stays bitwise that of a run without
    a hook, and telemetry off changes nothing either."""
    calls = []
    tr = _port_everything(tmp_path / "a", 10, ckpt_every=100, eval_every=4)
    scen = ScenarioConfig(**SCEN_ARGS)
    engine = RolloutEngine(tr.model, scen, num_slots=2, device="cpu")
    holdout = tdata.holdout_batches(scen, 2, 1)
    scenes = [tregistry.generate_scene("highway", 5, i, scen)
              for i in range(2)]

    def eval_cb(step, model):
        assert model is tr.model
        engine.run(scenes, t_hist=3, n_samples=2, seed=step)
        tsteps.open_loop_metrics(model, holdout)
        calls.append(step)

    tr.eval_cb = eval_cb
    tr.run()
    assert calls == [4, 8]
    ref = _port_everything(tmp_path / "b", 10, ckpt_every=100,
                           registry=obs.NULL)
    ref.run()
    assert tr.history == ref.history
    _assert_bitwise(_state_copy(tr), _state_copy(ref))
    names = [e["name"] for e in tr.obs.events()]
    assert names.count("trainer.eval") == 2
    assert not [e for e in ref.obs.events()]
    _close(tr, ref)


def test_metrics_callback_reports_nan_skips(tmp_path):
    seen = []
    tr = _port_everything(tmp_path, 4, full_start(tmp_path), log_every=2)
    tr.metrics_cb = lambda s, m: seen.append((s, m))
    tr.step_fn = _NaNAt(tr, at=0)
    tr.run()
    # the skipped step advances the step count, so logs land at 2 and 4
    assert [s for s, _ in seen] == [2, 4]
    assert seen[-1][1]["nan_skipped_total"] == 1
    assert math.isfinite(seen[-1][1]["loss"])
    assert set(seen[-1][1]) >= {"loss", "grad_norm", "accuracy",
                                "sec_per_step", "nan_consecutive"}
    tr.data.close()
