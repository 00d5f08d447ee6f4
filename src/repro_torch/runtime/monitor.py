"""Run-health monitors: step timing / straggler detection / NaN guards.

On a real multi-pod deployment each host runs this monitor; step times are
periodically all-gathered (host-side, out of the jit path) and hosts whose
rolling median exceeds ``straggler_factor`` x the fleet median are flagged
for the cluster scheduler to drain-and-replace. Here the fleet is one
process, but the policy object, its thresholds, and its decision output are
the production ones and are unit-tested directly.

Copy of ``repro/runtime/monitor.py`` (no JAX); ``tests/test_torch_obs.py`` holds
it to the original.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional

from repro_torch import obs


@dataclasses.dataclass
class StepTimer:
    window: int = 50

    def __post_init__(self):
        self.times: Deque[float] = collections.deque(maxlen=self.window)
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """NaN-safe: ``stop`` without a matching ``start`` (retry paths
        re-entering the loop after an exception, or a double-stop) returns
        NaN and records nothing, instead of raising ``TypeError`` on
        ``None - float`` or double-counting one interval as two samples.
        ``_t0`` is consumed by the stop, so each ``start`` yields at most
        one sample."""
        if self._t0 is None:
            return float("nan")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.times.append(dt)
        return dt

    @property
    def count(self) -> int:
        """Samples currently in the rolling window (feeds
        :meth:`StragglerPolicy.evaluate`'s per-rank ``counts`` gate)."""
        return len(self.times)

    @property
    def median(self) -> float:
        """Rolling median over the window — the LOWER middle for even
        windows, matching the fleet baseline's :func:`_lower_median`: the
        upper-middle pick made an even-window rank report a systematically
        pessimistic median to the same :class:`StragglerPolicy` that
        compares it against lower-median fleet baselines."""
        if not self.times:
            return float("nan")
        return _lower_median(sorted(self.times))


def _lower_median(sorted_vals: List[float]) -> float:
    """Median that takes the LOWER middle for even-length inputs.

    The fleet baseline must not be dragged up by the straggler itself:
    with the upper-middle pick (``vals[n // 2]``) a 2-rank fleet's
    "median" IS the slow rank, so ``slow > factor * slow`` never holds
    and a 2-host straggler is structurally unflaggable. The lower middle
    keeps the baseline at the healthy rank (and is the exact median for
    odd fleets).
    """
    return sorted_vals[(len(sorted_vals) - 1) // 2]


@dataclasses.dataclass
class StragglerPolicy:
    """Flags ranks whose rolling median step time is anomalously slow.

    ``registry``: telemetry home (``None`` = the process default,
    ``obs.NULL`` = off). Every evaluation exports the per-rank medians /
    sample counts it saw as ``straggler.rank_median_s`` /
    ``straggler.rank_samples`` gauges, and a non-empty decision lands as
    a ``straggler.flagged`` instant event — so a drain-and-replace
    trigger is visible in the same Perfetto timeline as the step spans
    it acted on.
    """

    straggler_factor: float = 1.5
    min_samples: int = 10
    registry: Optional[obs.Registry] = None

    def _reg(self) -> obs.Registry:
        return self.registry if self.registry is not None \
            else obs.get_registry()

    def evaluate(self, medians: Dict[int, float],
                 counts: Optional[Dict[int, int]] = None) -> List[int]:
        """medians: rank -> rolling median step seconds; counts: rank ->
        number of step samples behind that median (e.g.
        ``StepTimer.count``). Returns flagged ranks (candidates for
        preemptive replacement / checkpoint-evict).

        A rank participates — on either side of the comparison — only
        once its median rests on at least ``min_samples`` steps:
        flagging a host off a single noisy step (or letting that step
        define the fleet baseline) churns replacements for free. When
        ``counts`` is omitted the fleet as a whole must carry
        ``min_samples`` finite medians before any flag is raised.
        """
        def warmed(r: int) -> bool:
            return counts is None or counts.get(r, 0) >= self.min_samples

        reg = self._reg()
        for r, v in medians.items():
            reg.gauge("straggler.rank_median_s", rank=r).set(v)
            if counts is not None:
                reg.gauge("straggler.rank_samples", rank=r) \
                   .set(counts.get(r, 0))
        eligible = {r: v for r, v in medians.items()
                    if math.isfinite(v) and warmed(r)}
        if not eligible or (counts is None
                            and len(eligible) < self.min_samples):
            return []
        fleet = _lower_median(sorted(eligible.values()))
        flagged = [r for r, v in eligible.items()
                   if v > self.straggler_factor * fleet]
        if flagged:
            reg.counter("straggler.flag_decisions").inc()
            reg.event("straggler.flagged",
                      ranks=",".join(str(r) for r in sorted(flagged)),
                      fleet_median_s=fleet,
                      factor=self.straggler_factor)
        return flagged

    def evaluate_timers(self, timers: Dict[int, "StepTimer"]) -> List[int]:
        """Convenience wrapper: derive (medians, counts) from per-rank
        :class:`StepTimer`\\ s — the host-side all-gather payload."""
        return self.evaluate({r: t.median for r, t in timers.items()},
                             {r: t.count for r, t in timers.items()})


@dataclasses.dataclass
class NaNGuard:
    """Skip-and-count policy for non-finite losses; halt after a run of them.

    Transient non-finite steps (a bad batch, a flaky host) are skipped —
    the params/opt-state update for that step is discarded. ``max_consecutive``
    non-finite steps in a row aborts the run (systematic divergence).
    """

    max_consecutive: int = 5

    def __post_init__(self):
        self.consecutive = 0
        self.total_skipped = 0

    def check(self, loss: float) -> str:
        """Returns 'ok' | 'skip' | 'halt'."""
        if math.isfinite(loss):
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        self.total_skipped += 1
        if self.consecutive >= self.max_consecutive:
            return "halt"
        return "skip"
