"""Telemetry exporters: Chrome trace-event JSONL (Perfetto) + Prometheus.

Two serializations of one :class:`repro_torch.obs.Registry`:

* :func:`write_chrome_trace` — the Trace Event format
  (https://ui.perfetto.dev loads it directly). The file is a valid JSON
  array written one event per line, so it doubles as JSONL: stripping
  the bracket lines and trailing commas leaves one ``json.loads``-able
  object per line (:func:`read_chrome_trace` does exactly that). The
  registry's final aggregate snapshot rides along as a single
  ``repro.registry_snapshot`` instant event, so one file carries both
  the timeline and the counters/gauges/histograms —
  ``python -m repro_torch.launch.obs_report`` renders either view from it.

* :func:`prometheus_text` — the Prometheus text exposition format
  (counters / gauges verbatim; log-bucket histograms as classic
  cumulative ``_bucket{le=...}`` series with powers-of-2^(1/B) bounds),
  ready to serve from a ``/metrics`` endpoint or push to a gateway.

Copy of ``repro/obs/export.py`` (no JAX); ``tests/test_torch_obs.py`` holds
it to the original.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List

from repro_torch.obs.registry import Registry

__all__ = ["write_chrome_trace", "write_event_array", "read_chrome_trace",
           "prometheus_text", "SNAPSHOT_EVENT"]

#: name of the instant event carrying the final registry snapshot
SNAPSHOT_EVENT = "repro.registry_snapshot"


def _json_line(obj: Dict[str, Any]) -> str:
    # histograms carry inf min/max before the first sample; trace JSON
    # must stay strict-JSON for Perfetto, so map non-finite to null
    def fix(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        return v

    return json.dumps(obj, default=fix, allow_nan=False, sort_keys=True)


def _sanitize_tree(obj):
    """Replace non-finite floats with None, recursively (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize_tree(v) for v in obj]
    return obj


def write_event_array(path: str, events: List[Dict[str, Any]]) -> str:
    """Write trace events as a JSON array, one event per line (the dual
    JSON/JSONL dialect :func:`read_chrome_trace` parses); returns ``path``."""
    with open(path, "w") as f:
        f.write("[\n")
        for i, ev in enumerate(events):
            comma = "," if i + 1 < len(events) else ""
            f.write(_json_line(ev) + comma + "\n")
        f.write("]\n")
    return path


def write_chrome_trace(registry: Registry, path: str, *,
                       process_name: str = "repro") -> str:
    """Dump the registry's trace ring (+ final snapshot) as a
    Perfetto-loadable trace file; returns ``path``."""
    identity = dict(registry.identity)
    if "rank" in identity:
        process_name = f"{process_name} [rank {identity['rank']}]"
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": registry.pid,
         "args": {"name": process_name,
                  **({"identity": identity} if identity else {})}},
    ]
    events.extend(registry.events())
    events.append({
        "name": SNAPSHOT_EVENT, "ph": "i", "s": "p", "pid": registry.pid,
        "tid": registry.tid(), "ts": 0.0,
        "args": {"snapshot": _sanitize_tree(registry.snapshot())}})
    return write_event_array(path, events)


def read_chrome_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a trace written by :func:`write_chrome_trace` (tolerates the
    plain-JSONL and unterminated-array dialects of the format too)."""
    with open(path) as f:
        text = f.read()
    stripped = text.strip()
    if stripped.startswith("["):
        try:
            return json.loads(stripped)
        except json.JSONDecodeError:
            pass  # unterminated array: fall through to per-line parsing
    events = []
    for line in stripped.splitlines():
        line = line.strip().rstrip(",")
        if line in ("", "[", "]"):
            continue
        events.append(json.loads(line))
    return events


def _prom_name(name: str, suffix: str = "") -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name) + suffix


def _prom_escape(v: Any) -> str:
    """Escape a label value per the text-exposition spec: backslash,
    double-quote, and line-feed are the three characters that break the
    ``name{k="v"} value`` line grammar."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, str],
                 extra: Dict[str, str] = None) -> str:
    items = dict(labels)
    items.update(extra or {})
    if not items:
        return ""
    body = ",".join(f'{_prom_name(k)}="{_prom_escape(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def _prom_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_text(registry: Registry) -> str:
    """The registry in Prometheus text exposition format (version 0.0.4)."""
    snap = registry.snapshot()
    lines: List[str] = []
    typed: set = set()

    def header(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for c in snap["counters"]:
        name = _prom_name(c["name"], "_total")
        header(name, "counter")
        lines.append(f"{name}{_prom_labels(c['labels'])} "
                     f"{_prom_value(c['value'])}")
    for g in snap["gauges"]:
        if isinstance(g["value"], float) and math.isnan(g["value"]):
            continue    # a never-set gauge has no meaningful sample to expose
        name = _prom_name(g["name"])
        header(name, "gauge")
        lines.append(f"{name}{_prom_labels(g['labels'])} "
                     f"{_prom_value(g['value'])}")
    for h in snap["histograms"]:
        name = _prom_name(h["name"])
        header(name, "histogram")
        labels = h["labels"]
        b = h["buckets_per_doubling"]
        cum = h["zero_count"]
        for i_str, n in h["buckets"].items():   # already index-sorted
            cum += n
            le = 2.0 ** ((int(i_str) + 1) / b)
            lines.append(
                f"{name}_bucket{_prom_labels(labels, {'le': repr(le)})} "
                f"{cum}")
        lines.append(f"{name}_bucket{_prom_labels(labels, {'le': '+Inf'})} "
                     f"{h['count']}")
        lines.append(f"{name}_sum{_prom_labels(labels)} "
                     f"{_prom_value(h['sum'])}")
        lines.append(f"{name}_count{_prom_labels(labels)} {h['count']}")
    return "\n".join(lines) + "\n"
