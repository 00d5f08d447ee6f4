"""Checkpoints across the two packages, and the port's manager contracts.

* A checkpoint of the JAX trainer's tree (reference params + AdamW state)
  restores CRC-verified in the port's manager and converts into the port's
  model and optimizer state; the port trainer's checkpoint restores in
  the JAX manager with the reference's tree and dtypes.
* The aliasing trap: the port's train step writes parameters in place, so
  an async save followed at once by an in-place step must still restore
  the saved values (the write is held back until after the step).
* Fallback past truncated, bit-rotted and manifest-less steps (the
  reference's ``repro.chaos`` corruptions), the ``halt_reason`` refusal,
  and a write error surfacing at ``wait()`` and at the next ``save()``.
"""
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import chaos  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    CheckpointWriteError)
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                         opt_state_from_reference,
                                         opt_state_to_reference)
from repro_torch.training import steps as tsteps  # noqa: E402

ARCH = "sim-se2-fourier"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, arr in want.items():
        g = got[path]
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(arr).dtype, path
        np.testing.assert_array_equal(g, arr, err_msg=str(path))


@pytest.fixture(scope="module")
def trained_reference():
    """The JAX trainer's checkpoint tree after two real BC steps (so the
    moments and the step are non-trivial), and the port's model."""
    jarch = jconfigs.get_sim_arch(ARCH).reduced(num_layers=2)
    tarch = tconfigs.get_sim_arch(ARCH).reduced(num_layers=2)
    scen = tarch.scenario_config()
    jmodel = jsim.AgentSimModel(jarch.agent_sim_config())
    params = jmodule.init_params(jmodel.specs(), jax.random.key(1))
    opt = jsteps.bc_optimizer(3e-3, 10)
    state = opt.init(params)
    step = jax.jit(jsteps.make_sim_train_step(jmodel, opt))
    from repro.training import data as jdata
    for i in range(2):
        batch = jdata.make_sim_batch(0, 2 * i, 2, jarch.scenario_config(),
                                     families=("freeform",))
        params, state, _ = step(params, state, batch)
    return {"params": _np(params), "opt_state": _np(state)}, tarch, scen


def test_reference_checkpoint_restores_in_the_port(tmp_path,
                                                   trained_reference):
    tree, tarch, _ = trained_reference
    JManager(str(tmp_path), async_save=False).save(
        2, tree, extra={"step": 2, "data": {"cursor": 2}})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.verify(2) is None                  # CRC32 per array
    got, extra = mgr.restore(fallback=True)
    assert extra["step"] == 2 and mgr.last_restore_report["skipped"] == []
    _assert_trees_equal(got, tree)
    on_dev, _ = mgr.restore(2, device="cpu")
    _assert_trees_equal(on_dev, tree)
    # into the port's model and optimizer state
    model = tsim.AgentSimModel(tarch.agent_sim_config(), device="cpu")
    model.load_state_dict(tparams.from_reference(on_dev["params"]))
    opt = tsteps.bc_optimizer(3e-3, 10)
    like = opt.init(dict(model.named_parameters()))
    state = opt_state_from_reference(on_dev["opt_state"], like, "cpu")
    assert state[0] == () and state[1]["step"] == 2
    assert isinstance(state[1]["step"], int)
    for moment in ("mu", "nu"):
        assert sorted(state[1][moment]) == sorted(like[1][moment])
        for name, t in state[1][moment].items():
            assert t.dtype == torch.float32 and t.device.type == "cpu"
    _assert_trees_equal({"params": tparams.to_reference(model),
                         "opt_state": opt_state_to_reference(state)}, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path,
                                                   trained_reference):
    tree, tarch, _ = trained_reference
    model = tsim.AgentSimModel(tarch.agent_sim_config(), device="cpu")
    model.load_state_dict(tparams.from_reference(tree["params"]))
    opt = tsteps.bc_optimizer(3e-3, 10)
    state = opt_state_from_reference(
        tree["opt_state"], opt.init(dict(model.named_parameters())), "cpu")

    class Data:
        def state_dict(self):
            return {"cursor": 2}

    tr = Trainer(None, model, state, Data(), str(tmp_path))
    tr.step = 2
    tr._save()
    tr.ckpt.wait()
    mgr = JManager(str(tmp_path))
    assert mgr.verify(2) is None
    got, extra = mgr.restore(fallback=True)
    assert extra == {"step": 2, "data": {"cursor": 2}}
    _assert_trees_equal(got, tree)
    assert got["opt_state"][1]["step"].dtype == np.int32
    assert got["opt_state"][1]["step"].shape == ()


def test_named_tensor_dicts_round_trip(trained_reference):
    tree = trained_reference[0]["opt_state"][1]["mu"]
    named = tparams.from_reference(tree)
    assert all(t.dtype == torch.float32 for t in named.values())
    back = tparams.to_reference(named)
    _assert_trees_equal(back, tree)
    # the arrays are copies: changing the tensors leaves them be
    first = next(iter(named.values()))
    before = {k: v.copy() for k, v in _leaves(back).items()}
    first.add_(1.0)
    for path, arr in _leaves(back).items():
        np.testing.assert_array_equal(arr, before[path])


def _slow_hook(delay):
    def hook(step, attempt):
        time.sleep(delay)
    return hook


@pytest.mark.parametrize("leaf", ["tensor", "reference_tree"])
def test_async_save_then_in_place_step_restores_saved_values(tmp_path, leaf):
    """The write is held 0.3 s on the background thread while the
    caller writes its tensors in place, as the next train step does."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    blocks = [torch.ones(5), torch.full((5,), 2.0)]
    want = {"w": w.numpy().copy(), "blocks": {"b": np.stack(
        [b.numpy().copy() for b in blocks])}}
    named = {"w": w, "blocks.0.b": blocks[0], "blocks.1.b": blocks[1]}
    tree = (tparams.reference_tensors(named) if leaf == "tensor" else
            {"w": w.numpy(), "blocks": {"b": tparams.reference_tensors(
                named)["blocks"]["b"]}})
    mgr = CheckpointManager(str(tmp_path), io_hook=_slow_hook(0.3))
    mgr.save(1, {"params": tree}, extra={"step": 1})
    assert mgr._pending is not None and mgr._pending.is_alive()
    with torch.no_grad():                         # the next step
        w.add_(100.0)
        for b in blocks:
            b.mul_(-3.0)
    mgr.wait()
    got, _ = CheckpointManager(str(tmp_path)).restore(1)
    _assert_trees_equal(got["params"], want)


def _save_two(d):
    mgr = CheckpointManager(str(d), async_save=False)
    for step in (1, 2):
        mgr.save(step, {"w": torch.full((4, 5), float(step)),
                        "n": np.asarray(step, np.int32)},
                 extra={"step": step})
    return mgr


@pytest.mark.parametrize("mode", ["truncate_checkpoint_npz",
                                  "bitflip_checkpoint_array",
                                  "drop_checkpoint_manifest"])
def test_corrupt_latest_falls_back_with_reason(tmp_path, mode):
    _save_two(tmp_path)
    assert chaos.corrupt_checkpoint(str(tmp_path), mode)["step"] == 2
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.verify(2) is not None and mgr.verify(1) is None
    tree, extra = mgr.restore(fallback=True)
    assert extra["step"] == 1
    np.testing.assert_array_equal(tree["w"], np.full((4, 5), 1.0, np.float32))
    rep = mgr.last_restore_report
    assert rep["step"] == 1 and [s["step"] for s in rep["skipped"]] == [2]
    assert rep["skipped"][0]["reason"]
    with pytest.raises(IOError):
        mgr.restore(2)                             # strict, explicit step


def test_every_step_corrupt_raises(tmp_path):
    _save_two(tmp_path)
    chaos.corrupt_checkpoint(str(tmp_path), "truncate_checkpoint_npz", step=2)
    chaos.corrupt_checkpoint(str(tmp_path), "drop_checkpoint_manifest",
                             step=1)
    with pytest.raises(IOError, match="no checkpoint passed"):
        CheckpointManager(str(tmp_path)).restore(fallback=True)
    tree, extra = CheckpointManager(str(tmp_path / "empty")).restore(
        fallback=True)
    assert tree is None and extra is None


def test_stale_tmp_swept_and_keep_last_k(tmp_path):
    _save_two(tmp_path)
    chaos.corrupt_checkpoint(str(tmp_path), "stale_checkpoint_tmp")
    mgr = CheckpointManager(str(tmp_path), async_save=False, keep=2)
    assert mgr.available_steps() == [1, 2]
    for step in (2, 3, 4):                         # includes a re-save
        mgr.save(step, {"w": torch.zeros(2)}, extra={"step": step})
    assert mgr.available_steps() == [3, 4]
    assert all(mgr.verify(s) is None for s in (3, 4))


def test_write_error_surfaces_at_wait_and_next_save(tmp_path):
    plan = chaos.FaultPlan(
        [chaos.Fault("fail_async_save_io", at=0, count=10 ** 6)])
    mgr = CheckpointManager(str(tmp_path), save_retries=1, retry_backoff=0.01,
                            io_hook=chaos.checkpoint_io_hook(plan))
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(CheckpointWriteError):
        mgr.wait()
    assert mgr.latest_step() is None               # nothing half-published
    mgr.save(2, {"w": torch.ones(3)})
    deadline = time.time() + 10
    while mgr._pending.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(CheckpointWriteError):
        mgr.save(3, {"w": torch.ones(3)})          # surfaced here, not lost
    mgr.io_hook = None
    mgr.save(4, {"w": torch.ones(3)}, extra={"step": 4})
    mgr.wait()
    assert mgr.verify(4) is None


def test_transient_write_error_retries_to_success(tmp_path):
    plan = chaos.FaultPlan([chaos.Fault("fail_async_save_io", at=0, count=2)])
    mgr = CheckpointManager(str(tmp_path), save_retries=2, retry_backoff=0.01,
                            io_hook=chaos.checkpoint_io_hook(plan))
    mgr.save(5, {"w": torch.arange(4.0)}, extra={"step": 5})
    mgr.wait()
    assert plan.fired_counts()["fail_async_save_io"] == 2
    np.testing.assert_array_equal(mgr.restore(5)[0]["w"], np.arange(4.0))


class _Tiny(torch.nn.Module):
    """A one-tensor model with the trainer's interface: ``device`` and a
    step whose loss is always NaN (or always 0.5)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2), requires_grad=False)

    @property
    def device(self):
        return self.w.device


class _Step:
    def __init__(self, loss):
        self.loss = loss

    def grads(self, batch):
        return {}, {"loss": self.loss}

    def update(self, opt_state, grads):
        return opt_state


class _ListData:
    def __init__(self):
        self.cursor = 0

    def __next__(self):
        self.cursor += 1
        return {}

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, s):
        self.cursor = int(s["cursor"])


def _trainer(tmp_path, loss, **cfg):
    return Trainer(_Step(loss), _Tiny(), (), _ListData(), str(tmp_path),
                   TrainerConfig(**cfg))


def test_halt_checkpoint_refuses_blind_resume(tmp_path):
    tr = _trainer(tmp_path, math.nan, total_steps=10, ckpt_every=100,
                  max_consecutive_nans=2)
    with pytest.raises(FloatingPointError):
        tr.run()
    _, extra = JManager(str(tmp_path)).restore(fallback=True)
    assert extra["halt_reason"] == "nan"
    with pytest.raises(RuntimeError, match="--force"):
        _trainer(tmp_path, 0.5, total_steps=10).restore_if_available()
    tr3 = _trainer(tmp_path, 0.5, total_steps=10)
    assert tr3.restore_if_available(force=True) and tr3.step == 1


def test_trainer_fallback_counts_skipped_steps(tmp_path):
    _trainer(tmp_path, 0.5, total_steps=4, ckpt_every=2).run()
    chaos.corrupt_checkpoint(str(tmp_path), "truncate_checkpoint_npz")
    tr = _trainer(tmp_path, 0.5, total_steps=4)
    assert tr.restore_if_available() and tr.step == 2
    assert tr.data.cursor == 2
    assert tr.obs.counter("trainer.ckpt_fallback").value >= 1

