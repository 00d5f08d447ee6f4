"""Deterministic fault plans: *when* and *what* breaks, decided up front
(copy of ``repro/chaos/plan.py``).

A :class:`FaultPlan` is a seeded, fully explicit schedule of faults —
"truncate the latest checkpoint after save #2", "fail the async-save
write twice, then let it through", "poison slot 1's poses with NaN at
tick 7", "kill the data worker from produce-call 3 onward". The plan is
pure data: nothing fires until a component-side injector (``inject.py``)
or the drill runner (``repro_torch.launch.chaos``) asks
``fires(kind, clock)`` — and every firing is recorded, so a drill can
assert afterwards that the faults it scripted actually went off (a chaos
suite whose faults silently missed their window proves nothing).

Determinism contract: the same ``FaultPlan(faults, seed=s)`` produces
the same firings against the same sequence of clock queries, and every
randomized corruption detail (which array a bitflip hits, which byte) is
drawn from ``plan.rng(salt)`` — ``np.random.default_rng(seed ^ salt)``
— never from global RNG state. Two runs of a drill are bit-identical,
which is what lets the recovery invariants demand bit-exactness.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Fault", "FaultPlan", "FAULT_KINDS", "Clock"]

#: The fault vocabulary. Checkpoint-corruption kinds are applied to
#: at-rest checkpoint directories by ``inject.corrupt_checkpoint``; the
#: IO/worker/slot/tick kinds fire through injector wrappers against a
#: per-injector call clock.
FAULT_KINDS = (
    "truncate_checkpoint_npz",     # arrays.npz cut short mid-file
    "bitflip_checkpoint_array",    # one flipped bit in one stored array
    "drop_checkpoint_manifest",    # manifest.json deleted
    "stale_checkpoint_tmp",        # a crashed writer's step_*.tmp left behind
    "fail_async_save_io",          # OSError out of the save thread's write
    "poison_slot_nan",             # non-finite poses/logits in one slot
    "kill_data_worker",            # make_batch raises in the worker thread
    "delay_tick",                  # injected latency on the serve tick
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``at``: the injector-local clock value (save attempt, produce call,
    server tick, ...) at which the fault starts firing. ``count``: how
    many consecutive clock values it covers — ``count=2`` on
    ``fail_async_save_io`` is a transient outage two write attempts
    wide; a huge count is a hard persistent failure. ``target``: kind-
    specific victim (slot index for ``poison_slot_nan``; ignored
    elsewhere). ``param``: kind-specific magnitude (seconds for
    ``delay_tick``).
    """
    kind: str
    at: int
    count: int = 1
    target: int = 0
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"need at >= 0 and count >= 1, got "
                             f"(at={self.at}, count={self.count})")

    def covers(self, clock: int) -> bool:
        return self.at <= clock < self.at + self.count


class Clock:
    """A monotone injector-local clock: each ``next()`` is one query."""

    def __init__(self):
        self.n = 0

    def next(self) -> int:
        v = self.n
        self.n += 1
        return v


class FaultPlan:
    """A seeded, schedulable set of :class:`Fault`\\ s plus a firing log."""

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.kind, f.at, f.target)))
        self.seed = int(seed)
        self.fired: List[Dict[str, Any]] = []

    # -- construction helpers ------------------------------------------------
    @classmethod
    def single(cls, kind: str, at: int = 0, *, count: int = 1,
               target: int = 0, param: float = 0.0,
               seed: int = 0) -> "FaultPlan":
        return cls([Fault(kind, at, count=count, target=target,
                          param=param)], seed=seed)

    def rng(self, salt: int = 0) -> np.random.Generator:
        """Deterministic per-purpose RNG (corruption byte choice etc.)."""
        return np.random.default_rng(np.uint64(self.seed) ^ np.uint64(salt))

    # -- querying ------------------------------------------------------------
    def for_kind(self, kind: str) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.kind == kind)

    def fires(self, kind: str, clock: int,
              target: Optional[int] = None, **context) -> Optional[Fault]:
        """The scheduled fault covering ``(kind, clock[, target])``, or
        None. A hit is appended to :attr:`fired` together with any
        injector-supplied context, so drills can assert their faults
        actually triggered where they meant to."""
        for f in self.for_kind(kind):
            if f.covers(clock) and (target is None or f.target == target):
                self.fired.append({"kind": kind, "clock": int(clock),
                                   "target": f.target, "param": f.param,
                                   **context})
                return f
        return None

    # -- reporting -----------------------------------------------------------
    def fired_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.fired:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return out

    def summary(self) -> Dict[str, Any]:
        """JSON-able plan + firing log (lands in drill records/bundles)."""
        return {
            "seed": self.seed,
            "scheduled": [dataclasses.asdict(f) for f in self.faults],
            "fired": list(self.fired),
            "fired_counts": self.fired_counts(),
        }
