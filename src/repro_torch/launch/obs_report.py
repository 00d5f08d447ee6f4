"""Render a telemetry trace or flight-recorder bundle as terminal tables.

Consumes the Chrome/Perfetto trace file the telemetry layer writes
(``repro_torch.obs.write_chrome_trace``, or the ``--telemetry-out`` flag on
``python -m repro_torch.launch.train_sim``): the
span timeline gives per-region latency percentiles, and the embedded
``repro.registry_snapshot`` instant event gives counters (compile
counts, NaN skips, admissions), gauges (occupancy, resident slots,
slab bytes), histogram aggregates, and the roofline-style cost table
(``cost.*`` gauges recorded once per hot path at its first call by
``repro_torch.obs.cost``; the port compiles nothing, so ``compile_s`` stays
empty) — one file, all views. Merged fleet traces (``python -m
repro_torch.launch.obs_merge``) render with one span row per rank.

Run:  python -m repro_torch.launch.obs_report /tmp/run.trace.jsonl
      python -m repro_torch.launch.obs_report /tmp/run.trace.jsonl --json
      python -m repro_torch.launch.obs_report --postmortem /tmp/postmortem.json

Unusable inputs (missing/empty/truncated files, traces without the
embedded snapshot) exit with status 2 and a one-line error on stderr.

Copy of ``repro/launch/obs_report.py`` (no JAX);
``tests/test_torch_obs.py`` holds it to the original.
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
from typing import Any, Dict, List

from repro_torch import obs
from repro_torch.obs.flight import BUNDLE_KIND

COMPILE_SUFFIX = "_traces"      # counters counting jit trace events
COST_PREFIX = "cost."           # cost gauges (repro_torch/obs/cost.py)


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != v:                       # NaN
            return "-"
        if v and (abs(v) >= 1e5 or abs(v) < 1e-3):
            return f"{v:.3e}"
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    return str(v)


def _table(title: str, headers: List[str],
           rows: List[List[Any]]) -> str:
    if not rows:
        return ""
    cells = [[_fmt(c) for c in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells))
              for i, h in enumerate(headers)]
    def line(cols, pad=" "):
        return "  ".join(c.ljust(w, pad) if i == 0 else c.rjust(w, pad)
                         for i, (c, w) in enumerate(zip(cols, widths)))
    out = [f"== {title} ==", line(headers),
           line(["-" * w for w in widths])]
    out += [line(r) for r in cells]
    return "\n".join(out) + "\n"


def _label_str(labels: Dict[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def span_rows(events: List[Dict[str, Any]]) -> List[List[Any]]:
    """Aggregate complete ("X") events per span name through the shared
    log-bucket histogram — the exact sketch the live registry uses. On a
    merged fleet trace (several named processes) spans are keyed per
    rank track, so each rank gets its own row."""
    procs = {e.get("pid"): e.get("args", {}).get("name")
             for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    multi = len(procs) > 1
    hists: Dict[str, obs.Histogram] = {}
    for e in events:
        if e.get("ph") == "X":
            key = e["name"]
            if multi:
                key = f"{procs.get(e.get('pid'), e.get('pid'))} :: {key}"
            hists.setdefault(key, obs.Histogram(key)) \
                 .record(e.get("dur", 0.0) / 1e3)        # us -> ms
    rows = []
    for name, h in hists.items():
        rows.append([name, h.count, h.percentile(50), h.percentile(99),
                     h.mean, h.sum / 1e3])
    rows.sort(key=lambda r: -r[5])
    return rows


def snapshot_of(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    for e in reversed(events):
        if e.get("name") == obs.SNAPSHOT_EVENT:
            return e["args"]["snapshot"]
    return {}


def cost_rows(snap: Dict[str, Any]) -> List[List[Any]]:
    """Roofline-style rows from the ``cost.*`` gauges: one row per
    (path, extra labels) with FLOPs, bytes accessed, arithmetic
    intensity, and the buffer/compile columns."""
    by_path: Dict[Any, Dict[str, float]] = {}
    for g in snap.get("gauges", []):
        if not g["name"].startswith(COST_PREFIX):
            continue
        labels = dict(g.get("labels") or {})
        path = labels.pop("path", "?")
        key = (path, tuple(sorted(labels.items())))
        by_path.setdefault(key, {})[g["name"][len(COST_PREFIX):]] = g["value"]
    rows = []
    for (path, labels), d in sorted(by_path.items()):
        flops = d.get("flops")
        nbytes = d.get("bytes_accessed")
        intensity = (flops / nbytes) if flops and nbytes else None
        mib = lambda k: (d[k] / 2 ** 20) if d.get(k) is not None else None
        rows.append([path, _label_str(dict(labels)), flops, nbytes,
                     intensity, mib("argument_bytes"), mib("output_bytes"),
                     mib("temp_bytes"), mib("peak_bytes"),
                     d.get("compile_seconds")])
    return rows


def _cost_table(snap: Dict[str, Any]) -> str:
    return _table(
        "compiled cost (per jitted hot path, analyzed once at compile)",
        ["path", "labels", "flops", "bytes", "flops/B", "arg_MiB",
         "out_MiB", "tmp_MiB", "peak_MiB", "compile_s"], cost_rows(snap))


def render(events: List[Dict[str, Any]]) -> str:
    snap = snapshot_of(events)
    parts = [_table("spans (from trace timeline)",
                    ["span", "count", "p50_ms", "p99_ms", "mean_ms",
                     "total_s"], span_rows(events))]

    counters = snap.get("counters", [])
    compiles = [c for c in counters if c["name"].endswith(COMPILE_SUFFIX)]
    parts.append(_table(
        "compilations (jit traces of resident impls)",
        ["counter", "labels", "count"],
        [[c["name"], _label_str(c["labels"]), c["value"]]
         for c in compiles]))
    parts.append(_cost_table(snap))
    parts.append(_table(
        "counters", ["counter", "labels", "value"],
        [[c["name"], _label_str(c["labels"]), c["value"]]
         for c in counters if not c["name"].endswith(COMPILE_SUFFIX)]))
    parts.append(_table(
        "gauges (last sampled value)", ["gauge", "labels", "value"],
        [[g["name"], _label_str(g["labels"]), g["value"]]
         for g in snap.get("gauges", [])
         if not g["name"].startswith(COST_PREFIX)]))
    ms = 1e3
    parts.append(_table(
        "histograms", ["histogram", "labels", "count", "p50_ms",
                       "p90_ms", "p99_ms", "mean_ms"],
        [[h["name"], _label_str(h["labels"]), h["count"],
          *((None if h[q] is None else h[q] * ms)
            for q in ("p50", "p90", "p99")),
          None if not h["count"] or h["sum"] is None
          else h["sum"] / h["count"] * ms]
         for h in snap.get("histograms", [])
         if h["name"].endswith(".seconds")]))

    instants = {}
    for e in events:
        if e.get("ph") == "i" and e["name"] != obs.SNAPSHOT_EVENT:
            instants[e["name"]] = instants.get(e["name"], 0) + 1
    parts.append(_table("instant events", ["event", "count"],
                        sorted(instants.items())))
    if snap.get("dropped_events"):
        parts.append(f"(trace ring dropped {snap['dropped_events']} "
                     "oldest events)\n")
    return "\n".join(p for p in parts if p)


# -- postmortem bundles -------------------------------------------------------

def render_postmortem(bundle: Dict[str, Any]) -> str:
    """Render a flight-recorder bundle (``repro_torch.obs.FlightRecorder``)."""
    wall = bundle.get("wall_time_unix")
    when = (datetime.datetime.fromtimestamp(wall, datetime.timezone.utc)
            .isoformat() if isinstance(wall, (int, float)) else "-")
    head = [f"== flight recorder: {bundle.get('reason', '?')} ==",
            f"written   {when}"]
    if bundle.get("identity"):
        head.append(f"identity  {_label_str(bundle['identity'])}")
    if bundle.get("context"):
        head.append(f"context   {_label_str(bundle['context'])}")
    head.append(f"events    {len(bundle.get('events', []))} retained of "
                f"{bundle.get('trace_events_total', '?')} recorded")
    parts = ["\n".join(head) + "\n"]

    state = bundle.get("state", {})
    slots = (state.get("sim_server") or {}).get("slots")
    if slots:
        parts.append(_table(
            "sim_server slots", ["slot", "phase", "uid", "scene", "sample",
                                 "t", "t_hist", "t_total", "cursor_rows"],
            [[s.get("slot"), s.get("phase"), s.get("uid"),
              s.get("scene_id"), s.get("sample_id"), s.get("t"),
              s.get("t_hist"), s.get("t_total"), s.get("cursor_rows")]
             for s in slots]))
    for name, st in sorted(state.items()):
        if name == "sim_server" or not isinstance(st, dict):
            continue
        parts.append(_table(f"{name} state", ["key", "value"],
                            [[k, json.dumps(v) if isinstance(v, (dict, list))
                              else v] for k, v in sorted(st.items())]))

    snap = bundle.get("snapshot", {})
    parts.append(_cost_table(snap))
    parts.append(_table(
        "counters", ["counter", "labels", "value"],
        [[c["name"], _label_str(c["labels"]), c["value"]]
         for c in snap.get("counters", [])]))
    parts.append(_table("last events (tail of the trace ring)",
                        ["event", "count"],
                        sorted({e["name"]: sum(1 for x in bundle["events"]
                                               if x["name"] == e["name"])
                                for e in bundle.get("events", [])}.items())))
    return "\n".join(p for p in parts if p)


def _die(msg: str) -> int:
    print(f"error: {msg}".splitlines()[0], file=sys.stderr)
    return 2


def _postmortem_main(path: str, as_json: bool) -> int:
    try:
        with open(path) as f:
            bundle = json.load(f)
    except OSError as e:
        return _die(f"cannot read {path!r}: {e}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        return _die(f"cannot parse {path!r} as a postmortem bundle: {e}")
    if not isinstance(bundle, dict) or bundle.get("kind") != BUNDLE_KIND:
        return _die(f"{path!r} is not a flight-recorder bundle "
                    f"(expected kind={BUNDLE_KIND!r})")
    if as_json:
        print(json.dumps(bundle, indent=2))
    else:
        print(render_postmortem(bundle), end="")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a repro telemetry trace (spans + registry "
                    "snapshot + compiled-cost table) or a flight-recorder "
                    "postmortem bundle as terminal tables.")
    ap.add_argument("trace", help="trace file written by "
                                  "repro_torch.obs.write_chrome_trace (or a "
                                  "postmortem bundle with --postmortem)")
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregates as JSON instead of tables")
    ap.add_argument("--postmortem", action="store_true",
                    help="treat the input as a flight-recorder bundle")
    args = ap.parse_args(argv)

    if args.postmortem:
        return _postmortem_main(args.trace, args.json)

    try:
        events = obs.read_chrome_trace(args.trace)
    except OSError as e:
        return _die(f"cannot read {args.trace!r}: {e}")
    except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
        return _die(f"cannot parse {args.trace!r} as a trace: {e}")
    if not events:
        return _die(f"{args.trace!r} contains no trace events")
    snap = snapshot_of(events)
    if not snap:
        return _die(f"{args.trace!r} has no embedded registry snapshot "
                    f"({obs.SNAPSHOT_EVENT} event) — was the trace "
                    "truncated mid-write?")
    if args.json:
        print(json.dumps({
            "spans": {r[0]: {"count": r[1], "p50_ms": r[2], "p99_ms": r[3],
                             "mean_ms": r[4], "total_s": r[5]}
                      for r in span_rows(events)},
            "cost": [{"path": r[0], "labels": r[1], "flops": r[2],
                      "bytes_accessed": r[3], "intensity": r[4]}
                     for r in cost_rows(snap)],
            "snapshot": snap}, indent=2))
    else:
        print(render(events), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
