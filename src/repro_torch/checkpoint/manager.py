"""Checkpointing: atomic, async, keep-last-k, portable, verified.

Port of ``repro/checkpoint/manager.py`` with the same on-disk format:
``step_<n>/arrays.npz`` plus a JSON manifest, so either package reads
the other's checkpoints.

  * **atomic**  — written to ``step_<n>.tmp`` then ``os.replace``d into
    place; a crash mid-write never corrupts the latest checkpoint, and
    any ``*.tmp`` debris such a crash leaves behind is swept at startup.
  * **async**   — ``save`` snapshots the (host) arrays and hands the disk
    I/O to a background thread; the train loop only blocks if a previous
    save is still in flight (one outstanding save, like Orbax). A write
    that fails is retried with backoff (transient IO), and a save that
    dies anyway is **captured and re-raised** at the next ``wait()`` /
    ``save()`` instead of evaporating in the daemon thread.
  * **verified** — the manifest carries a CRC32 per stored array;
    ``verify`` recomputes them (plus structural checks) and ``restore``
    with ``fallback=True`` walks back to the newest checkpoint that
    passes, reporting every step it skipped and why. A truncated or
    bit-rotted latest checkpoint costs ``ckpt_every`` steps of rework,
    not the run.
  * **host copy** — ``save`` copies every leaf to host memory on the
    calling thread before it returns: the port's train step writes the
    parameters in place, so a view of them (``t.numpy()`` on the CPU)
    would change under the background writer. Tensors of one dtype are
    gathered into one buffer and copied with one transfer, so a save
    from the card waits for it once (:func:`_to_host`).
  * **portable** — arrays are stored whole; ``restore(device=...)`` puts
    every leaf on a device as a tensor. The port replicates its
    parameters on every rank, so ``device`` stands in for the reference's
    ``shardings``: each rank restores onto its own device. A checkpoint in
    the reference's tree layout restores in either package.
  * **across ranks** — with a ``torch.distributed`` process group up,
    rank 0 alone snapshots and writes (every rank holds the same
    replicated state), and every ``wait()`` ends in a barrier, so no rank
    passes a ``wait()`` or a later ``save()`` before the write it follows
    has landed.
  * **self-describing** — the manifest stores the flattened key paths, so
    restore validates structure and reports missing/unexpected keys.

The reference's failure drills (``repro.chaos``, which hooks ``io_hook``)
are not ported yet (ROADMAP A10); ``docs/robustness.md`` states the
contracts.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("repro_torch.checkpoint")


class CheckpointWriteError(IOError):
    """An async save failed after its bounded retries; re-raised on the
    training thread at the next ``wait()`` or ``save()``."""


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        if not tree:
            return {"/".join(path + ("__empty_dict__",)): np.zeros(0)}
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        if not tree:
            return {"/".join(path + ("__empty_tuple__",)): np.zeros(0)}
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, path + (f"#{i}",)))
        return out
    return {"/".join(path): tree}


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and set(node) == {"__empty_tuple__"}:
            return ()
        if isinstance(node, dict) and set(node) == {"__empty_dict__"}:
            return {}
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _to_host(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Numpy copies of every leaf, owned by the result and taken now.

    Tensors are grouped by dtype and concatenated on their device, then
    copied to the host in one transfer each: from the card this is where
    a save waits for the step that produced the tensors. The arrays are
    views into those host buffers, which alias nothing of the caller's.
    Other leaves (numpy arrays, Python numbers) are copied with
    ``np.array``."""
    host: Dict[str, np.ndarray] = {}
    groups: Dict[Any, List[str]] = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(k)
        else:
            host[k] = np.array(v)
    for keys in groups.values():
        parts = [flat[k].detach().reshape(-1) for k in keys]
        buf = torch.cat(parts).cpu().numpy() if len(parts) > 1 else \
            parts[0].to("cpu", copy=True).numpy()
        start = 0
        for k, t in zip(keys, parts):
            host[k] = buf[start:start + t.numel()].reshape(flat[k].shape)
            start += t.numel()
    return host


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 *, save_retries: int = 2, retry_backoff: float = 0.05,
                 io_hook: Optional[Callable[[int, int], None]] = None):
        """``save_retries``: extra write attempts after a failed one
        (``OSError``), with exponential backoff ``retry_backoff * 2**i``
        seconds between attempts. ``io_hook(step, attempt)``: called at
        the start of every write attempt — the fault-injection seam
        (``repro.chaos.checkpoint_io_hook``); an exception it raises is
        indistinguishable from a real IO failure."""
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.save_retries = int(save_retries)
        self.retry_backoff = float(retry_backoff)
        self.io_hook = io_hook
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        #: filled by every ``restore(fallback=True)``: the step restored
        #: plus the corrupt steps walked over, each with its reason
        self.last_restore_report: Dict[str, Any] = {}
        # rank 0 writes (and sweeps); the others only read
        self.writer = not _distributed() or dist.get_rank() == 0
        if self.writer:
            self._cleanup_stale_tmp()

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _cleanup_stale_tmp(self):
        """Sweep ``*.tmp`` debris left by a writer that died mid-save (or
        mid-GC). Their content is by construction incomplete — the final
        rename never ran — so deleting them can only reclaim space."""
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                path = os.path.join(self.directory, name)
                log.warning("removing stale checkpoint temp %s", path)
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    try:
                        os.remove(path)
                    except OSError:
                        pass

    def available_steps(self) -> List[int]:
        """Steps with a manifest-complete directory, ascending (no
        content verification — see :meth:`verify`)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                manifest = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(manifest):
                    steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return max(steps) if steps else None

    def _candidate_steps(self) -> List[int]:
        """Every non-tmp step directory, even manifest-less ones — the
        fallback walk must *report* a checkpoint whose manifest was lost,
        not pretend the step never existed."""
        steps = set()
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.isdir(os.path.join(self.directory, name)):
                try:
                    steps.add(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def wait(self):
        """Block until the in-flight save lands — and surface its error
        if it died: a checkpoint the caller believes exists but doesn't
        is exactly the silent failure mode this layer exists to kill."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if _distributed():
            dist.barrier()
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise CheckpointWriteError(
                f"async checkpoint save failed after "
                f"{self.save_retries + 1} attempts: {err}") from err

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None):
        """Snapshot to host memory now (:func:`_to_host`, a copy that the
        caller may change at once), write to disk (a)synchronously.

        Raises a :class:`CheckpointWriteError` from the *previous* save
        if that one failed (via the ``wait()`` below) — an async
        failure is surfaced one save late at worst, never swallowed.
        Across ranks only rank 0 writes; the others pass the barrier.
        """
        if not self.writer:
            self.wait()
            return
        flat = _flatten(tree)
        host = _to_host(flat)
        crcs = {k: _crc(v) for k, v in host.items()}
        self.wait()

        def write():
            last: Optional[BaseException] = None
            for attempt in range(self.save_retries + 1):
                try:
                    self._write_once(step, host, crcs, extra, attempt)
                    return
                except OSError as e:
                    last = e
                    log.warning(
                        "checkpoint save step %d attempt %d/%d failed: %s",
                        step, attempt + 1, self.save_retries + 1, e)
                    if attempt < self.save_retries:
                        time.sleep(self.retry_backoff * (2 ** attempt))
                except BaseException as e:   # non-IO: don't retry
                    last = e
                    break
            self._save_error = last

        if self.async_save:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()
            self.wait()

    def _write_once(self, step: int, host: Dict[str, np.ndarray],
                    crcs: Dict[str, int], extra: Optional[Dict[str, Any]],
                    attempt: int):
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        if self.io_hook is not None:
            self.io_hook(step, attempt)
        if os.path.exists(tmp):             # debris from a failed attempt
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "keys": sorted(host),
            "crc32": crcs,
            "time": time.time(),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            # Re-saving an existing step: never rmtree the live dir and
            # then replace — between those two a concurrent reader sees
            # the step half-deleted or vanished, and if anything
            # re-creates ``final`` the replace dies on ENOTEMPTY.
            # Rename the old dir aside (atomic; readers keep a coherent
            # old view), swing the new one in, then delete the orphan.
            old = final + ".old.tmp"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.available_steps()[:-self.keep]:
            # rename-then-delete: a reader listing the directory never
            # sees a manifest-complete step dir with half its arrays
            # already unlinked (.tmp names are invisible to readers)
            live = self._step_dir(s)
            trash = live + ".gc.tmp"
            try:
                os.replace(live, trash)
            except OSError:
                continue
            shutil.rmtree(trash, ignore_errors=True)

    # ------------------------------------------------------------------
    def verify(self, step: int) -> Optional[str]:
        """Integrity-check one checkpoint; returns None if it passes or
        a one-line reason: manifest missing/unreadable, arrays.npz
        missing/truncated/unreadable, key mismatch, or a per-array CRC32
        mismatch. Pre-CRC (legacy) manifests pass on the structural
        checks alone."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return f"manifest missing/unreadable: {e}"
        crcs = manifest.get("crc32")
        try:
            with np.load(os.path.join(d, "arrays.npz")) as z:
                if sorted(z.files) != manifest.get("keys"):
                    return "key mismatch between manifest and arrays.npz"
                for k in z.files:
                    arr = z[k]          # full decompress: torn files fail here
                    if crcs is not None and _crc(arr) != crcs.get(k):
                        return f"crc32 mismatch on array {k!r}"
        except Exception as e:  # noqa: BLE001 — any load failure is corrupt
            return f"arrays.npz unreadable: {type(e).__name__}: {e}"
        return None

    def restore(self, step: Optional[int] = None, device=None,
                strict: bool = True, fallback: bool = False):
        """Returns (tree, extra). The leaves are numpy arrays, or with
        ``device`` tensors on that device.

        ``fallback=True`` (with ``step=None``): instead of trusting the
        newest directory, walk newest -> oldest and restore the first
        checkpoint that passes :meth:`verify`; every corrupt step walked
        over is logged and recorded in :attr:`last_restore_report` as
        ``{"step": restored, "skipped": [{"step", "reason"}, ...]}``.
        Raises ``IOError`` only when *no* checkpoint verifies. With an
        explicit ``step``, corruption raises (the caller asked for that
        exact payload)."""
        if step is None:
            if fallback:
                return self._restore_fallback(device, strict)
            step = self.latest_step()
        if step is None:
            return None, None
        if strict:
            reason = self.verify(step)
            if reason is not None:
                raise IOError(
                    f"checkpoint {self._step_dir(step)} corrupt: {reason}")
        return self._load(step, device, strict)

    def _restore_fallback(self, device, strict: bool):
        skipped: List[Dict[str, Any]] = []
        for step in reversed(self._candidate_steps()):
            reason = self.verify(step)
            if reason is None:
                self.last_restore_report = {"step": step, "skipped": skipped}
                for s in skipped:
                    log.warning(
                        "checkpoint step %d failed verification (%s); "
                        "fell back past it", s["step"], s["reason"])
                if skipped:
                    log.warning("restoring from fallback step %d", step)
                return self._load(step, device, strict)
            skipped.append({"step": step, "reason": reason})
        if skipped:
            raise IOError(
                "no checkpoint passed verification; tried "
                + "; ".join(f"step {s['step']}: {s['reason']}"
                            for s in skipped))
        self.last_restore_report = {"step": None, "skipped": []}
        return None, None

    def _load(self, step: int, device, strict: bool):
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        if strict and sorted(flat) != manifest["keys"]:
            raise IOError(f"checkpoint {d} corrupt: key mismatch")
        if device is not None:
            flat = {k: torch.from_numpy(v).to(device) for k, v in flat.items()}
        return _unflatten(flat), manifest.get("extra", {})
