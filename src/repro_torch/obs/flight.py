"""Postmortem flight recorder: one JSON bundle of "what was happening".

When a run dies — Trainer NaN-halt, SIGTERM preemption, or an operator
asking a live ``SimServer`` (the reference's; not ported yet) for
``dump_postmortem()`` — the question is always the same: what was the
system doing in the seconds before? The registry already holds the
answer in bounded memory (the trace-event ring + instrument aggregates);
this module packages it, together with component state providers (per-
slot SimServer phase/cursor/scene ids, Trainer loss tail) and the
compiled-cost tables, into a single self-contained JSON bundle that
``python -m repro_torch.launch.obs_report --postmortem`` renders.

Zero-sync contract: a dump reads host-side python state only — the
trace ring, instrument snapshots, and whatever the registered providers
return from their own host bookkeeping. Nothing here blocks on a device
value; a dump is safe from a signal-driven shutdown path. Writes are
atomic (temp file + rename) so a dying process never leaves a torn
bundle behind.

Copy of ``repro/obs/flight.py`` (no JAX); ``tests/test_torch_obs.py`` holds
it to the original.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.export import _sanitize_tree
from repro_torch.obs.registry import Registry, get_registry

__all__ = ["FlightRecorder", "BUNDLE_KIND"]

#: ``kind`` tag identifying a flight-recorder bundle on disk
BUNDLE_KIND = "repro.flight_recorder"

#: default number of most-recent trace events preserved in a bundle
DEFAULT_LAST_K = 2048


class FlightRecorder:
    """Bounded postmortem capture over a registry + state providers.

    ``add_provider(name, fn)`` registers a zero-arg callable returning
    JSON-able host state (components register themselves: SimServer its
    per-slot table, Trainer its step/NaN/loss tail). ``dump(reason=...)``
    snapshots everything into one bundle file. A provider that raises is
    recorded as an error entry instead of killing the dump — a postmortem
    path must never add its own crash.
    """

    def __init__(self, registry: Optional[Registry] = None, *,
                 out_path: Optional[str] = None,
                 last_k: int = DEFAULT_LAST_K):
        self.obs = registry if registry is not None else get_registry()
        self.out_path = out_path
        self.last_k = int(last_k)
        self._providers: Dict[str, Callable[[], Any]] = {}

    def add_provider(self, name: str, fn: Callable[[], Any]
                     ) -> "FlightRecorder":
        self._providers[name] = fn
        return self

    def bundle(self, reason: str = "manual", **context) -> Dict[str, Any]:
        """Assemble the postmortem bundle (pure host state, no I/O)."""
        events: List[Dict[str, Any]] = self.obs.events()
        state: Dict[str, Any] = {}
        for name, fn in self._providers.items():
            try:
                state[name] = fn()
            except Exception as e:      # noqa: BLE001 — never crash a dump
                state[name] = {"error": f"{type(e).__name__}: {e}"}
        return _sanitize_tree({
            "kind": BUNDLE_KIND,
            "version": 1,
            "reason": reason,
            "wall_time_unix": time.time(),
            "identity": dict(self.obs.identity),
            "context": context,
            "state": state,
            "snapshot": self.obs.snapshot(),
            "trace_events_total": len(events) + self.obs.dropped_events,
            "events": events[-self.last_k:],
        })

    def dump(self, reason: str = "manual", path: Optional[str] = None,
             **context) -> str:
        """Write the bundle as JSON (atomically); returns the path."""
        path = path or self.out_path
        if path is None:
            raise ValueError("FlightRecorder.dump needs a path (constructor "
                             "out_path= or dump(path=...))")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        b = self.bundle(reason, **context)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(b, f, indent=1, allow_nan=False)
            f.write("\n")
        os.replace(tmp, path)
        return path
