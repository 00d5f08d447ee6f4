"""Fleet-scope telemetry: per-rank identity, rank trace files, merging.

Each rank in a fleet run owns its own :class:`~repro_torch.obs.Registry`,
stamped with its coordinates (:func:`stamp_identity`) and exported to a
per-rank trace file (:func:`write_rank_trace`, one
``rank00000.trace.jsonl`` per process under ``--telemetry-dir``).
:func:`merge_traces` then folds N such files into ONE Perfetto-loadable
timeline:

* every rank becomes its own named track (``pid`` remapped to the rank,
  with ``process_name`` / ``process_sort_index`` metadata so Perfetto
  shows ``rank 0``, ``rank 1``, ... top-to-bottom);
* per-rank monotonic clocks are aligned onto a shared axis using the
  wall-clock ``epoch`` each registry stamps at creation (offset =
  ``(epoch_rank - min_epoch)`` — NTP-grade alignment, which is what a
  straggler investigation needs; sub-ms skew is not promised);
* ``straggler.flagged`` events (recorded by ``StragglerPolicy`` on the
  rank that ran the evaluation) are re-emitted as overlay instants *on
  the flagged rank's own track*, so the slow rank is visually marked;
* the per-rank registry snapshots are merged into one snapshot whose
  instruments carry a ``rank`` label, so ``obs_report`` renders per-rank
  tables from the merged file exactly as it does for a single trace.

Merging is pure host-side JSON shuffling, no device touch;
:func:`stamp_process_identity` asks ``torch.distributed`` for the rank
when a process group is up, and is rank 0 of 1 otherwise. (Copy of
``repro/obs/fleet.py``; the reference asks ``jax.process_index``.)
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.export import SNAPSHOT_EVENT, read_chrome_trace, \
    write_chrome_trace, write_event_array
from repro_torch.obs.registry import Registry

__all__ = ["stamp_identity", "stamp_process_identity", "rank_trace_path",
           "write_rank_trace", "discover_rank_traces", "merge_traces",
           "MergeError"]

_RANK_FILE_RE = re.compile(r"rank(\d+)\.trace\.jsonl$")

#: overlay event name drawn on a flagged rank's own track after a merge
STRAGGLER_OVERLAY = "straggler.straggling"


class MergeError(ValueError):
    """A per-rank trace is unusable (unparseable / no embedded snapshot)."""


def stamp_identity(registry: Registry, *, rank: int, **coords) -> Registry:
    """Stamp fleet coordinates onto a registry. ``rank`` is the global
    process index; pod/data mesh coordinates ride along as extra keys."""
    return registry.set_identity(rank=int(rank), **coords)


def stamp_process_identity(registry: Registry, **coords) -> Registry:
    """Stamp this process's own coordinates: its ``torch.distributed``
    rank and world size when a process group is initialised, else rank 0
    of 1 (lazy torch import)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return stamp_identity(registry, rank=rank, world=world, **coords)


def rank_trace_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank{int(rank):05d}.trace.jsonl")


def write_rank_trace(registry: Registry, directory: str, *,
                     process_name: str = "repro") -> str:
    """Export one rank's trace to its slot under ``directory`` (created
    if needed); the rank comes from the registry's stamped identity."""
    os.makedirs(directory, exist_ok=True)
    rank = int(registry.identity.get("rank", 0))
    return write_chrome_trace(registry, rank_trace_path(directory, rank),
                              process_name=process_name)


def discover_rank_traces(directory: str) -> List[str]:
    paths = sorted(p for p in glob.glob(os.path.join(directory, "*"))
                   if _RANK_FILE_RE.search(p))
    if not paths:
        raise MergeError(f"no rank*.trace.jsonl files under {directory!r}")
    return paths


def _load_rank(path: str, fallback_rank: int) -> Dict[str, Any]:
    try:
        events = read_chrome_trace(path)
    except Exception as e:                      # unparseable / truncated
        raise MergeError(f"cannot parse {path!r}: {e}") from e
    if not events:
        raise MergeError(f"{path!r} is empty")
    snap: Optional[Dict[str, Any]] = None
    for ev in reversed(events):
        if ev.get("name") == SNAPSHOT_EVENT:
            snap = ev.get("args", {}).get("snapshot")
            break
    if snap is None:
        raise MergeError(f"{path!r} has no embedded registry snapshot "
                         f"({SNAPSHOT_EVENT} event)")
    identity = snap.get("identity") or {}
    m = _RANK_FILE_RE.search(path)
    rank = int(identity.get("rank",
                            m.group(1) if m else fallback_rank))
    return {"path": path, "events": events, "snapshot": snap,
            "identity": identity, "rank": rank,
            "epoch": snap.get("epoch")}


def _rank_label(rank: int, identity: Dict[str, Any]) -> str:
    extras = ", ".join(f"{k}={identity[k]}" for k in sorted(identity)
                       if k not in ("rank",))
    return f"rank {rank}" + (f" ({extras})" if extras else "")


def merge_traces(paths: Sequence[str], out_path: str) -> Dict[str, Any]:
    """Merge per-rank trace files into one timeline at ``out_path``;
    returns a summary dict (ranks, event count, overlay count)."""
    ranks = [_load_rank(p, i) for i, p in enumerate(paths)]
    ranks.sort(key=lambda r: r["rank"])
    seen = [r["rank"] for r in ranks]
    if len(set(seen)) != len(seen):
        raise MergeError(f"duplicate ranks across inputs: {seen}")

    epochs = [r["epoch"] for r in ranks if isinstance(r["epoch"], (int, float))]
    epoch0 = min(epochs) if epochs else None

    merged: List[Dict[str, Any]] = []
    flag_events: List[Dict[str, Any]] = []
    for r in ranks:
        rank = r["rank"]
        off_us = ((r["epoch"] - epoch0) * 1e6
                  if epoch0 is not None and
                  isinstance(r["epoch"], (int, float)) else 0.0)
        merged.append({"name": "process_name", "ph": "M", "pid": rank,
                       "args": {"name": _rank_label(rank, r["identity"]),
                                "identity": r["identity"]}})
        merged.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                       "args": {"sort_index": rank}})
        for ev in r["events"]:
            if ev.get("ph") == "M" or ev.get("name") == SNAPSHOT_EVENT:
                continue
            ev = dict(ev)
            ev["pid"] = rank
            ev["ts"] = float(ev.get("ts", 0.0)) + off_us
            merged.append(ev)
            if ev.get("name") == "straggler.flagged":
                flag_events.append(ev)

    # overlay each flag on the flagged rank's own track
    overlays = 0
    valid = set(seen)
    for ev in flag_events:
        flagged = str(ev.get("args", {}).get("ranks", ""))
        for tok in filter(None, (t.strip() for t in flagged.split(","))):
            try:
                fr = int(tok)
            except ValueError:
                continue
            if fr not in valid:
                continue
            merged.append({
                "name": STRAGGLER_OVERLAY, "ph": "i", "s": "p",
                "pid": fr, "tid": 0, "ts": ev["ts"],
                "args": {"flagged_by_rank": ev["pid"],
                         **{k: v for k, v in ev.get("args", {}).items()
                            if k != "ranks"}}})
            overlays += 1

    combined: Dict[str, Any] = {
        "counters": [], "gauges": [], "histograms": [],
        "dropped_events": 0, "epoch": epoch0,
        "identity": {"merged_ranks": seen}}
    for r in ranks:
        snap = r["snapshot"]
        combined["dropped_events"] += int(snap.get("dropped_events", 0))
        for kind in ("counters", "gauges", "histograms"):
            for inst in snap.get(kind, []):
                inst = dict(inst)
                inst["labels"] = {"rank": str(r["rank"]),
                                  **(inst.get("labels") or {})}
                combined[kind].append(inst)
    merged.append({"name": SNAPSHOT_EVENT, "ph": "i", "s": "p",
                   "pid": seen[0], "tid": 0, "ts": 0.0,
                   "args": {"snapshot": combined}})

    write_event_array(out_path, merged)
    return {"out": out_path, "ranks": seen, "events": len(merged),
            "straggler_overlays": overlays}
