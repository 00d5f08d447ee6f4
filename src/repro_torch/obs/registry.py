"""Zero-sync telemetry registry: counters, gauges, log-bucket histograms,
and monotonic-clock spans.

Design rules (the "zero-sync" contract — see ``docs/observability.md``):

* **Instrumentation never forces a device sync.** Every sample a metric
  ingests is a plain host ``float``/``int`` that the instrumented code
  already had — wall-clock deltas from ``time.perf_counter``, queue
  lengths, slot occupancy computed from host-side bookkeeping, byte
  counts derived from array *shape metadata*. Calling
  ``block_until_ready`` / ``float(device_array)`` from inside an
  instrument is a bug; on-device scalars must ride the output pytrees the
  pipelined drain already materializes, and get recorded *then*.

* **Disabled means free.** ``Registry(enabled=False)`` (or the module
  :data:`NULL` singleton) hands out no-op instruments and a shared no-op
  span context, so a hot loop instrumented unconditionally costs a dict
  lookup and nothing else when telemetry is off. The obs-on/obs-off
  bit-parity tests and the serve-bench overhead gate keep the *enabled*
  cost honest too.

* **Aggregates in bounded memory.** Histograms are log-bucketed
  (:data:`Histogram.buckets_per_doubling` buckets per power of two), so
  a week of tick latencies costs the same few hundred ints as a minute;
  the raw per-event record lives in the bounded trace-event ring instead
  (see :meth:`Registry.span` / ``repro_torch.obs.export``).

Spans measure **host wall-clock between enter and exit** — for code that
only *dispatches* async device work, that is dispatch + whatever the
caller awaited, by design: the host pipeline is the thing being watched.
Device-side truth comes from the optional ``torch.profiler`` integration
(``--profile-dir`` on the launchers).

Copy of ``repro/obs/registry.py`` (no JAX); ``tests/test_torch_obs.py`` holds
it to the original.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "NULL",
           "get_registry", "set_registry"]

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, Any]) -> LabelsKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (events, skips, compilations).

    Thread-safe: ``inc`` may race between the SimServer drain thread and
    the submitting thread, so the read-modify-write is held under a
    per-instrument lock (plain ``+=`` on a float is *not* atomic across
    the bytecode boundary).
    """

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: LabelsKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "counter", "name": self.name,
                "labels": dict(self.labels), "value": self.value}


class Gauge:
    """Last-write-wins sampled value (occupancy, resident slots, bytes).

    Thread-safe; last writer wins by definition, the lock just keeps the
    float() conversion and store from interleaving with snapshots."""

    __slots__ = ("name", "labels", "value", "_lock")

    def __init__(self, name: str, labels: LabelsKey = ()):
        self.name = name
        self.labels = labels
        self.value = float("nan")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "gauge", "name": self.name,
                "labels": dict(self.labels), "value": self.value}


class Histogram:
    """Log-bucketed histogram over positive floats, O(1) memory per decade.

    Bucket ``i`` covers ``[2**(i/B), 2**((i+1)/B))`` with
    ``B = buckets_per_doubling``; a recorded value lands in
    ``floor(log2(v) * B)``. Percentiles are reconstructed from the bucket
    holding the target rank, reported at its *geometric midpoint*, so the
    worst-case relative error of any quantile is
    ``2**(1/(2B)) - 1`` (:attr:`max_rel_error`, ~1.1% at the default
    B=32) — plus whatever rank-interpolation difference a tiny sample
    count carries vs ``np.percentile``. Zero / negative samples count in
    a dedicated underflow bucket and sort below every positive bucket.

    Also usable standalone (outside a :class:`Registry`) as the shared
    percentile helper — ``benchmarks/serve_bench.py`` and
    ``poisson_drive`` aggregate tick latencies through it instead of
    keeping raw lists.
    """

    __slots__ = ("name", "labels", "buckets_per_doubling", "count", "sum",
                 "min", "max", "zero_count", "buckets", "_lock")

    def __init__(self, name: str = "", labels: LabelsKey = (),
                 buckets_per_doubling: int = 32):
        self.name = name
        self.labels = labels
        self.buckets_per_doubling = buckets_per_doubling
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.zero_count = 0
        self.buckets: Dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def max_rel_error(self) -> float:
        """Worst-case relative error of a bucketed quantile estimate."""
        return 2.0 ** (1.0 / (2 * self.buckets_per_doubling)) - 1.0

    def record(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v <= 0.0:
                self.zero_count += 1
                return
            i = math.floor(math.log2(v) * self.buckets_per_doubling)
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def _bucket_mid(self, i: int) -> float:
        return 2.0 ** ((i + 0.5) / self.buckets_per_doubling)

    def percentile(self, q: float) -> float:
        """Quantile ``q`` in [0, 100] at the owning bucket's geometric
        midpoint (exact-sample extremes for q at/beyond the ends)."""
        if self.count == 0:
            return float("nan")
        # nearest-rank on the bucket CDF; rank is 1-based
        rank = max(1, math.ceil(q / 100.0 * self.count))
        if rank == 1 and self.zero_count == 0:
            return self.min                 # exact extreme samples
        if rank == self.count:
            return self.max
        if rank <= self.zero_count:
            return min(self.min, 0.0)
        seen = self.zero_count
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                # clamp to the observed envelope so p0/p100 are exact
                return min(max(self._bucket_mid(i), self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "histogram", "name": self.name,
                "labels": dict(self.labels), "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else float("nan"),
                "max": self.max if self.count else float("nan"),
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99),
                "buckets_per_doubling": self.buckets_per_doubling,
                "zero_count": self.zero_count,
                "buckets": {str(i): n for i, n in sorted(self.buckets.items())}}


class _Span:
    """Reusable timed region: records duration into ``<name>.seconds`` and
    appends one complete ("ph": "X") trace event on exit."""

    __slots__ = ("_reg", "name", "labels", "_t0")

    def __init__(self, reg: "Registry", name: str, labels: Dict[str, Any]):
        self._reg = reg
        self.name = name
        self.labels = labels
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._reg.observe_span(self.name, self._t0, time.perf_counter(),
                               **self.labels)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for disabled registries."""

    __slots__ = ()
    name = ""
    labels: LabelsKey = ()
    count = 0
    sum = 0.0
    value = 0.0
    max_rel_error = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return float("nan")


_NULL_SPAN = _NullSpan()
_NULL_INSTRUMENT = _NullInstrument()

#: default capacity of the bounded trace-event ring. At ~10 spans per
#: service tick this holds hours of serving; older events are dropped
#: (counted in ``dropped_events``) rather than growing without bound.
TRACE_CAPACITY = 200_000


class Registry:
    """Process-wide home for instruments plus a bounded trace-event ring.

    Handing out instruments is idempotent per ``(kind, name, labels)`` —
    hot loops may either cache the handle or re-look it up every tick
    (one dict hit). All instruments are host-side pure-python; nothing
    here ever touches a device value.

    Instrument creation and the trace ring are guarded by a registry
    lock, and each instrument locks its own mutation, so drain /
    pipelining threads may record concurrently without lost samples.

    ``identity`` carries fleet coordinates (rank / process_index / pod /
    data, see ``repro_torch.obs.fleet``); ``epoch`` anchors the monotonic span
    clock (``t0``) to wall time so per-rank traces from different
    processes can be merged onto one timeline.
    """

    def __init__(self, enabled: bool = True,
                 trace_capacity: int = TRACE_CAPACITY):
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.epoch = time.time()
        self.pid = os.getpid()
        self.identity: Dict[str, Any] = {}
        self._instruments: Dict[Tuple[str, str, LabelsKey], Any] = {}
        self._events: List[Dict[str, Any]] = []
        self._cap = trace_capacity
        self.dropped_events = 0
        self._lock = threading.RLock()

    def set_identity(self, **coords) -> "Registry":
        """Stamp fleet coordinates (``rank=3, pod=1, data=1, ...``) into
        this registry; they ride every snapshot and exported trace."""
        with self._lock:
            self.identity.update(coords)
        return self

    @staticmethod
    def tid() -> int:
        return threading.get_ident() % 1_000_000

    # -- instruments --------------------------------------------------------

    def _get(self, kind: str, cls, name: str, labels: Dict[str, Any]):
        if not self.enabled:
            return _NULL_INSTRUMENT
        key = (kind, name, _labels_key(labels))
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, key[2])
                    self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels)

    # -- spans / events ------------------------------------------------------

    def span(self, name: str, **labels):
        """``with registry.span("sim_server.tick"): ...`` — a monotonic
        wall-clock region; duration lands in the ``<name>.seconds``
        histogram and as one Chrome trace event."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, labels)

    def observe_span(self, name: str, t0: float, t1: float,
                     **labels) -> None:
        """Record an already-measured ``perf_counter`` interval as if it
        had run under :meth:`span` — for callers that only know after the
        fact whether an interval should count (e.g. idle service ticks
        are measured but not recorded)."""
        if not self.enabled:
            return
        self.histogram(name + ".seconds", **labels).record(t1 - t0)
        self._push_event({
            "name": name, "ph": "X", "pid": self.pid, "tid": self.tid(),
            "ts": (t0 - self.t0) * 1e6, "dur": (t1 - t0) * 1e6,
            **({"args": labels} if labels else {})})

    def event(self, name: str, **labels) -> None:
        """Instant event (straggler flagged, slot evicted, run halted)."""
        if not self.enabled:
            return
        self._push_event({
            "name": name, "ph": "i", "s": "p", "pid": self.pid,
            "tid": self.tid(),
            "ts": (time.perf_counter() - self.t0) * 1e6,
            **({"args": labels} if labels else {})})

    def _push_event(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self._cap:
                # drop the oldest half in one slice instead of per-event pops
                drop = self._cap // 2
                del self._events[:drop]
                self.dropped_events += drop
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    # -- snapshots -----------------------------------------------------------

    def instruments(self) -> Iterator[Any]:
        return iter(self._instruments.values())

    def snapshot(self) -> Dict[str, Any]:
        """Host-side aggregate view: every instrument's current state.
        Safe to call anywhere — reads python state only, no device sync."""
        with self._lock:
            out: Dict[str, Any] = {
                "counters": [], "gauges": [], "histograms": [],
                "dropped_events": self.dropped_events,
                "identity": dict(self.identity), "epoch": self.epoch}
            insts = sorted(self._instruments.items())
        for (kind, _, _), inst in insts:
            out[kind + "s"].append(inst.snapshot())
        return out


#: disabled singleton: pass ``registry=obs.NULL`` to switch a component's
#: telemetry off entirely (the no-perturbation tests drive both paths).
NULL = Registry(enabled=False)

_default = Registry()
_default_lock = threading.Lock()


def get_registry() -> Registry:
    """The process-wide default registry every component falls back to."""
    return _default


def set_registry(reg: Registry) -> Registry:
    """Swap the process default (tests / embedders); returns the old one."""
    global _default
    with _default_lock:
        old, _default = _default, reg
    return old
