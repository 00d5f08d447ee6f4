"""Fault-tolerant training loop (port of ``repro/runtime/trainer.py``).

  restore-or-init -> [data.next -> step -> monitors -> periodic ckpt] -> final ckpt

The model holds the parameters and the step updates them in place, so the
loop runs the step in its two halves (:class:`TrainStep`, which the sim's
and the LM's step builders return): the gradients and metrics, then, only
when the loss is finite, the update.
A skipped step leaves the parameters and the optimizer state bitwise as
they were, as the reference's discarded arrays do, and costs no host
synchronisation beyond the loss read the loop pays anyway.

Fault-tolerance contract, as in the reference:
  * **checkpoint/restart**: every ``ckpt_every`` steps the trainer saves
    the parameters, the optimizer state, the data cursor and the step, in
    the reference's tree layout (``{"params": tree, "opt_state": ((),
    {"step", "mu", "nu"})}``), so a checkpoint restores in either package.
    A killed-and-relaunched run resumes with the same data order and
    parameter trajectory.
  * **verified restore with fallback**: restore walks back past corrupt
    checkpoints to the newest one whose CRC32 manifest verifies; a
    NaN-halt checkpoint is tagged ``halt_reason`` and refuses a blind
    resume without ``force``.
  * **NaN guard**: non-finite losses skip the update; a run of them halts
    with ``FloatingPointError``.
  * **step timing**: rolling step-time medians (:class:`StepTimer`).
  * **preemption hook**: ``should_stop`` is polled each step; when it
    fires the trainer checkpoints and returns ``"preempted"``.
  * **periodic eval**: every ``eval_every`` steps ``eval_cb(step, model)``
    runs; it must only read the model, so resume is unaffected.

Across ranks (a ``torch.distributed`` process group up) every rank runs
the same loop on a replica of the parameters, with a step that reduces
over the ranks (``make_sim_dp_train_step``, or ``make_sim_train_step(...,
group=)``), so every rank reads the same loss and skips or updates alike.
Rank 0 writes the checkpoints (:class:`CheckpointManager`); every rank
restores onto its own device, and its data cursor resumes from the same
step (each rank keeps its own ``host_rank``). The reference's
``param_shardings`` places restored parameters on a mesh; the port's
parameters are replicated, so the model's device stands in for it.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import ShardedIterator
from repro_torch.params import (from_reference, is_stacked,
                                reference_groups, reference_tensors)
from repro_torch.runtime.monitor import NaNGuard, StepTimer

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """One update in two halves, so that a caller can read the loss between
    them and drop the update (the trainer's non-finite gate).

    ``grads(batch) -> (grads, metrics)`` computes the gradients and the
    metrics and changes nothing; ``update(opt_state, grads) -> opt_state``
    steps the optimizer and writes the parameters in place
    (:func:`repro_torch.optim.step_in_place`: it consumes ``grads`` and
    ``opt_state``). Calling the object runs both: ``step(opt_state, batch)
    -> (opt_state, metrics)``."""
    grads: Callable[[Dict[str, Any]], Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]]
    update: Callable[[Any, Dict[str, torch.Tensor]], Any]

    def __call__(self, opt_state, batch):
        grads, metrics = self.grads(batch)
        return self.update(opt_state, grads), metrics


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    keep_checkpoints: int = 3
    max_consecutive_nans: int = 5
    eval_every: int = 0            # 0 disables the periodic eval callback


def _named_tensors(node) -> bool:
    """A dict of tensors named like the model's parameters (``mu``)."""
    return isinstance(node, dict) and not any(
        isinstance(v, (dict, tuple, int)) for v in node.values())


#: the per-parameter statistics of adafactor's ``v``
_SLOTS = frozenset({"v", "vr", "vc"})


def _named_slots(node) -> bool:
    """A dict of per-parameter slot dicts, named like the model's
    parameters (adafactor's ``v``: ``{name: {"vr", "vc"} or {"v"}}``)."""
    return isinstance(node, dict) and bool(node) and all(
        isinstance(v, dict) and v and set(v) <= _SLOTS and _named_tensors(v)
        for v in node.values())


def _flat_slots(node):
    return {f"{n}.{k}": t for n, slots in node.items()
            for k, t in slots.items()}


def opt_state_to_reference(state):
    """The port's optimizer state in the reference's layout: tuples stay
    tuples, an int step becomes a 0-d int32 array, and a dict of tensors
    named like the model's parameters (AdamW's ``mu``, ``nu``), or of
    per-parameter slot dicts (adafactor's ``v``), becomes the reference's
    tree (a slot dict is the leaf of its parameter's path)."""
    if isinstance(state, tuple):
        return tuple(opt_state_to_reference(s) for s in state)
    if isinstance(state, int):
        return np.asarray(state, np.int32)
    if _named_tensors(state):
        return reference_tensors(state)
    if _named_slots(state):
        return reference_tensors(_flat_slots(state))
    if isinstance(state, dict):
        return {k: opt_state_to_reference(v) for k, v in state.items()}
    return state


def opt_state_from_reference(tree, like, device):
    """Inverse of :func:`opt_state_to_reference`, shaped by ``like`` (a
    state of the same optimizer, e.g. ``optimizer.init(params)``): the
    step comes back as an int and each named tensor dict as float32
    tensors on ``device``."""
    if isinstance(like, tuple):
        return tuple(opt_state_from_reference(t, l, device)
                     for t, l in zip(tree, like))
    if isinstance(like, int):
        return int(tree)
    if _named_tensors(like):
        flat = from_reference(tree, device=device)
        if sorted(flat) != sorted(like):
            raise IOError(f"optimizer state mismatch on restore: "
                          f"{sorted(set(flat) ^ set(like))[:5]}")
        return {k: flat[k].to(like[k].dtype) for k in like}
    if _named_slots(like):
        return _slots_from_reference(tree, like, device)
    if isinstance(like, dict):
        return {k: opt_state_from_reference(tree[k], v, device)
                for k, v in like.items()}
    return tree


def _slots_from_reference(tree, like, device):
    """Adafactor's per-parameter slots from the reference's tree: each
    parameter's slots read at its reference leaf's path, a stacked leaf's
    at the parameter's layer (:func:`repro_torch.params.reference_groups`
    says which leaves are stacked)."""
    def at(path):
        node = tree
        for key in path.split("."):
            node = node[key]
        return node

    out = {}
    try:
        for leaf, names in reference_groups(like).items():
            stacked = is_stacked(leaf, names)
            for i, n in enumerate(names):
                out[n] = {}
                for k, t in like[n].items():
                    arr = at(f"{leaf}.{k}")
                    arr = arr[i] if stacked else arr
                    out[n][k] = (
                        arr.detach().to(device, t.dtype, copy=True)
                        if isinstance(arr, torch.Tensor) else torch.tensor(
                            np.asarray(arr), dtype=t.dtype, device=device))
                    if out[n][k].shape != t.shape:
                        raise IOError(f"optimizer state {n}.{k}: shape "
                                      f"{tuple(out[n][k].shape)} != "
                                      f"{tuple(t.shape)}")
    except (KeyError, TypeError) as e:
        raise IOError(f"optimizer state mismatch on restore: {e}") from e
    return out


class Trainer:
    """``step_fn`` is a :class:`TrainStep` over ``model``, whose
    parameters it updates in place: a sim model's or an LM's (the
    ``make_*train_step`` builders). ``opt_state`` is the
    optimizer's state for them (AdamW's, adafactor's, in chains). The
    checkpoint holds the parameters in the reference's tree (an LM's
    ``group{g}`` trees, gemma2's pairs included), so it restores in either
    package."""

    def __init__(self, step_fn, model, opt_state,
                 data: ShardedIterator, ckpt_dir: str,
                 config: TrainerConfig = TrainerConfig(),
                 metrics_cb: Optional[Callable[[int, Dict], None]] = None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 eval_cb: Optional[Callable[[int, Any], None]] = None,
                 registry: Optional[obs.Registry] = None,
                 flight: Optional[obs.FlightRecorder] = None):
        self.obs = registry if registry is not None else obs.get_registry()
        # postmortem flight recorder: dumped on NaN-halt / preemption
        self.flight = flight
        if flight is not None:
            flight.add_provider("trainer", self._flight_state)
        self.step_fn = step_fn
        self.model = model
        self.opt_state = opt_state
        self.data = data
        self.config = config
        self.ckpt = CheckpointManager(ckpt_dir, keep=config.keep_checkpoints)
        self.metrics_cb = metrics_cb or (lambda s, m: None)
        self.should_stop = should_stop or (lambda: False)
        self.eval_cb = eval_cb
        self.step = 0
        self.timer = StepTimer()
        self.nan_guard = NaNGuard(config.max_consecutive_nans)
        self.history: list = []

    def _flight_state(self) -> Dict[str, Any]:
        """Host-side trainer state for the flight recorder: the loss tail
        and NaN accounting the postmortem view leads with."""
        return {"step": self.step,
                "nan_consecutive": self.nan_guard.consecutive,
                "nan_skipped_total": self.nan_guard.total_skipped,
                "step_time_median_s": self.timer.median,
                "loss_tail": [float(v) for v in self.history[-20:]]}

    # ------------------------------------------------------------------
    def restore_if_available(self, force: bool = False) -> bool:
        """Restore from the newest checkpoint that passes verification
        (CRC32 + structure); every step walked over is counted in
        ``trainer.ckpt_fallback`` and surfaced as a ``trainer.ckpt_skipped``
        event. A checkpoint tagged ``halt_reason`` is refused without
        ``force=True`` (launcher: ``--force``): resuming the params and
        data cursor that just diverged replays the same divergence.

        The parameters are copied into the model; the optimizer state's
        moments land as float32 tensors on the model's device."""
        dev = self.model.device
        tree, extra = self.ckpt.restore(fallback=True, device=dev)
        if tree is None:
            return False
        report = self.ckpt.last_restore_report
        for s in report.get("skipped", ()):
            self.obs.counter("trainer.ckpt_fallback").inc()
            self.obs.event("trainer.ckpt_skipped", step=s["step"],
                           reason=s["reason"])
        halt_reason = (extra or {}).get("halt_reason")
        if halt_reason and not force:
            raise RuntimeError(
                f"checkpoint at step {int(extra['step'])} was saved by a "
                f"'{halt_reason}' halt; resuming it replays the same "
                f"divergence (same params, same data cursor). Pass "
                f"force=True (launcher: --force) to resume anyway.")
        self.opt_state = opt_state_from_reference(tree["opt_state"],
                                                  self.opt_state, dev)
        self.model.load_state_dict(from_reference(tree["params"],
                                                  device=dev))
        self.step = int(extra["step"])
        self.data.load_state_dict(extra["data"])
        log.info("restored from step %d%s", self.step,
                 f" (skipped {len(report['skipped'])} corrupt checkpoint(s))"
                 if report.get("skipped") else "")
        return True

    def checkpoint_tree(self):
        """What a checkpoint holds, in the reference's layout (tensors)."""
        return {"params": reference_tensors(self.model.state_dict()),
                "opt_state": opt_state_to_reference(self.opt_state)}

    def _save(self, halt_reason: Optional[str] = None):
        extra = {"step": self.step, "data": self.data.state_dict()}
        if halt_reason is not None:
            # tag the checkpoint with why the run died so a relaunch can
            # refuse to blindly resume into the same divergence
            extra["halt_reason"] = halt_reason
        with self.obs.span("trainer.checkpoint"):
            self.ckpt.save(self.step, self.checkpoint_tree(), extra=extra)

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        cfg = self.config
        while self.step < cfg.total_steps:
            if self.should_stop():
                log.warning("preemption requested; checkpointing at step %d",
                            self.step)
                if self.flight is not None:
                    log.warning("flight-recorder bundle: %s",
                                self.flight.dump(reason="preempted",
                                                 step=self.step))
                self._save()
                self.ckpt.wait()
                return {"status": "preempted", "step": self.step,
                        "nan_skipped": self.nan_guard.total_skipped}
            batch = next(self.data)
            self.timer.start()
            # the step span covers the gradients, the loss read (the one
            # host sync of the step, as in the reference) and the update
            with self.obs.span("trainer.step"):
                grads, metrics = self.step_fn.grads(batch)
                loss = float(metrics["loss"])
                verdict = self.nan_guard.check(loss)
                if verdict == "ok":
                    self.opt_state = self.step_fn.update(self.opt_state,
                                                         grads)
            self.timer.stop()
            if verdict == "halt":
                self.obs.event("trainer.halt", step=self.step,
                               consecutive=self.nan_guard.consecutive)
                if self.flight is not None:
                    log.error("flight-recorder bundle: %s",
                              self.flight.dump(reason="nan_halt",
                                               step=self.step, loss=loss))
                self._save(halt_reason="nan")
                self.ckpt.wait()
                raise FloatingPointError(
                    f"{self.nan_guard.consecutive} consecutive non-finite "
                    f"losses at step {self.step}")
            if verdict == "skip":
                log.warning("non-finite loss at step %d; update skipped",
                            self.step)
                self.obs.counter("trainer.nan_skipped").inc()
                self.step += 1
                continue
            self.step += 1
            self.history.append(loss)
            if self.step % cfg.log_every == 0:
                self.obs.gauge("trainer.step_time_median_s") \
                    .set(self.timer.median)
                self.metrics_cb(self.step, {
                    **{k: float(v) for k, v in metrics.items()},
                    "sec_per_step": self.timer.median,
                    # a run that silently discarded N steps must not look
                    # identical to a clean one
                    "nan_skipped_total": self.nan_guard.total_skipped,
                    "nan_consecutive": self.nan_guard.consecutive})
            if self.step % cfg.ckpt_every == 0:
                self._save()
            # periodic evaluation: reads the model only, so it cannot
            # perturb the resume contract
            if (cfg.eval_every and self.eval_cb is not None
                    and self.step % cfg.eval_every == 0):
                with self.obs.span("trainer.eval"):
                    self.eval_cb(self.step, self.model)
        self._save()
        self.ckpt.wait()
        return {"status": "done", "step": self.step,
                "final_loss": self.history[-1] if self.history else None,
                "nan_skipped": self.nan_guard.total_skipped}
