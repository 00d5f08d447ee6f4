"""Fault injectors: make a :class:`~repro_torch.chaos.plan.FaultPlan` real
(port of ``repro/chaos/inject.py``).

Two families:

* **At-rest corruption** (:func:`corrupt_checkpoint`) mutates a
  checkpoint directory the way real failures do — a truncated
  ``arrays.npz`` (crashed writer / torn copy), a flipped bit in one
  stored array (disk rot; CRC catches it), a deleted ``manifest.json``,
  a leftover ``step_*.tmp`` from a writer that died mid-save. All
  randomness comes from ``plan.rng``, so the same plan corrupts the
  same byte.

* **In-flight wrappers** hand a component a seam the plan fires
  through: :func:`checkpoint_io_hook` raises ``OSError`` out of
  scheduled save attempts (drills ``CheckpointManager``'s bounded
  retry), :func:`flaky_make_batch` raises out of scheduled produce
  calls (drills ``ShardedIterator``'s worker-error propagation), and
  :func:`poison_server_slot` writes non-finite poses/logits into one
  ``SimServer`` slot (drills quarantine). Each wrapper keeps its own
  :class:`~repro_torch.chaos.plan.Clock`, so ``Fault.at`` indexes that
  injector's calls and nothing depends on wall time.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.chaos.plan import Clock, FaultPlan

__all__ = ["corrupt_checkpoint", "checkpoint_io_hook", "flaky_make_batch",
           "poison_server_slot", "ChaosInjectionError"]


class ChaosInjectionError(RuntimeError):
    """Raised when an injector cannot apply its scheduled fault (e.g. no
    checkpoint exists to corrupt) — a drill misconfiguration, never a
    component failure."""


# -- at-rest checkpoint corruption -------------------------------------------

def _manifest_steps(directory: str):
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, name,
                                                "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _pick_step(directory: str, step: Optional[int]) -> int:
    steps = _manifest_steps(directory)
    if not steps:
        raise ChaosInjectionError(
            f"no checkpoints under {directory} to corrupt")
    if step is None:
        return steps[-1]
    if step not in steps:
        raise ChaosInjectionError(
            f"step {step} not present under {directory} (have {steps})")
    return step


def _truncate_npz(directory: str, step: int,
                  plan: FaultPlan) -> Dict[str, Any]:
    path = os.path.join(_step_dir(directory, step), "arrays.npz")
    size = os.path.getsize(path)
    # cut somewhere inside the payload: a torn write never respects the
    # zip structure, so neither do we
    keep = int(plan.rng(salt=step).integers(1, max(2, size // 2)))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return {"file": path, "orig_bytes": size, "kept_bytes": keep}


def _bitflip_array(directory: str, step: int,
                   plan: FaultPlan) -> Dict[str, Any]:
    path = os.path.join(_step_dir(directory, step), "arrays.npz")
    with np.load(path) as z:
        arrs = {k: np.array(z[k]) for k in z.files}
    victims = sorted(k for k, v in arrs.items() if v.nbytes > 0)
    if not victims:
        raise ChaosInjectionError(f"{path} holds no non-empty arrays")
    rng = plan.rng(salt=step + 1)
    key = victims[int(rng.integers(len(victims)))]
    buf = bytearray(arrs[key].tobytes())
    byte = int(rng.integers(len(buf)))
    bit = int(rng.integers(8))
    buf[byte] ^= 1 << bit
    arrs[key] = np.frombuffer(bytes(buf), dtype=arrs[key].dtype) \
        .reshape(arrs[key].shape)
    np.savez(path, **arrs)
    return {"file": path, "key": key, "byte": byte, "bit": bit}


def _drop_manifest(directory: str, step: int,
                   plan: FaultPlan) -> Dict[str, Any]:
    path = os.path.join(_step_dir(directory, step), "manifest.json")
    os.remove(path)
    return {"file": path}


def _stale_tmp(directory: str, step: int, plan: FaultPlan) -> Dict[str, Any]:
    """Leave the debris of a writer that died mid-save: a ``.tmp`` step
    dir holding a half-written arrays.npz and no manifest."""
    tmp = _step_dir(directory, step) + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    junk = plan.rng(salt=step + 2).integers(0, 256, 333).astype(np.uint8)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(junk.tobytes())
    return {"dir": tmp}


_CORRUPTIONS = {
    "truncate_checkpoint_npz": _truncate_npz,
    "bitflip_checkpoint_array": _bitflip_array,
    "drop_checkpoint_manifest": _drop_manifest,
    "stale_checkpoint_tmp": _stale_tmp,
}


def corrupt_checkpoint(directory: str, mode: str, *,
                       step: Optional[int] = None,
                       plan: Optional[FaultPlan] = None) -> Dict[str, Any]:
    """Apply one at-rest corruption ``mode`` (a checkpoint fault kind
    from :data:`~repro_torch.chaos.plan.FAULT_KINDS`) to ``directory``.

    ``step=None`` targets the newest manifest-complete checkpoint —
    except ``stale_checkpoint_tmp``, which plants its debris at
    ``latest + 1`` (the save that "died"). Returns a JSON-able record of
    exactly what was damaged, and logs the firing on ``plan``.
    """
    if mode not in _CORRUPTIONS:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         f"known: {sorted(_CORRUPTIONS)}")
    plan = plan if plan is not None else FaultPlan(seed=0)
    if mode == "stale_checkpoint_tmp":
        steps = _manifest_steps(directory)
        step = step if step is not None else (steps[-1] + 1 if steps else 0)
    else:
        step = _pick_step(directory, step)
    detail = _CORRUPTIONS[mode](directory, step, plan)
    plan.fired.append({"kind": mode, "clock": step, "target": 0,
                       "param": 0.0, **detail})
    return {"mode": mode, "step": step, **detail}


# -- in-flight injector wrappers ---------------------------------------------

def checkpoint_io_hook(plan: FaultPlan) -> Callable[[int, int], None]:
    """An ``io_hook`` for :class:`~repro_torch.checkpoint.CheckpointManager`:
    raises ``OSError`` on write attempts covered by a
    ``fail_async_save_io`` fault. The clock counts write *attempts*
    across all saves (retries included), so ``Fault(at=0, count=2)``
    with ``save_retries >= 2`` is a transient outage the manager rides
    out, while a large ``count`` is a dead disk."""
    clock = Clock()

    def hook(step: int, attempt: int) -> None:
        c = clock.next()
        if plan.fires("fail_async_save_io", c, step=step,
                      attempt=attempt) is not None:
            raise OSError(
                f"chaos: injected async-save IO failure "
                f"(attempt clock {c}, step {step}, attempt {attempt})")

    return hook


def flaky_make_batch(make_batch: Callable[[int, int, int], Dict[str, Any]],
                     plan: FaultPlan) -> Callable[[int, int, int],
                                                  Dict[str, Any]]:
    """Wrap a ``make_batch`` so scheduled produce calls raise — the
    data-worker kill drill. The clock counts calls into ``make_batch``
    (worker retries included): ``count <= worker_retries`` is a
    transient blip the iterator retries through; a larger ``count``
    must surface as ``DataWorkerError`` from ``__next__``."""
    clock = Clock()

    def wrapped(seed: int, start_index: int, batch_size: int):
        c = clock.next()
        if plan.fires("kill_data_worker", c, seed=seed,
                      start_index=start_index) is not None:
            raise RuntimeError(
                f"chaos: injected data-worker failure (produce call {c}, "
                f"start_index {start_index})")
        return make_batch(seed, start_index, batch_size)

    return wrapped


def poison_server_slot(server, slot: int, *,
                       plan: Optional[FaultPlan] = None,
                       tick: Optional[int] = None) -> None:
    """Overwrite slot ``slot``'s poses and logits with NaN, in place in the
    server's state tensors — the numerically poisoned lane. From the next
    tick on, every pose that slot emits is non-finite; the server's
    drain-side health check must quarantine it while healthy slots stay
    bit-identical."""
    for key in ("pose", "logits"):
        server.state[key][slot] = float("nan")
    if plan is not None:
        plan.fired.append({"kind": "poison_slot_nan",
                           "clock": int(tick if tick is not None else -1),
                           "target": int(slot), "param": 0.0})
