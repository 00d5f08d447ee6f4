"""Merge per-rank telemetry traces into one Perfetto timeline.

Inputs are the ``rank*.trace.jsonl`` files a fleet run writes under
``--telemetry-dir`` (``benchmarks/fleet_bench.py``,
``python -m repro_torch.launch.train_sim``): pass the directory, or the files
explicitly. The merged file gets one named track per rank, wall-clock
aligned via each registry's ``epoch``, with ``straggler.flagged``
decisions overlaid on the flagged rank's own track, and a combined
registry snapshot whose instruments carry a ``rank`` label — load it at
https://ui.perfetto.dev or render it with
``python -m repro_torch.launch.obs_report``.

Run:  python -m repro_torch.launch.obs_merge /tmp/fleet_tel
      python -m repro_torch.launch.obs_merge rank00000.trace.jsonl \
          rank00001.trace.jsonl -o merged.trace.jsonl

Unusable inputs exit with status 2 and a one-line error on stderr.

Copy of ``repro/launch/obs_merge.py`` (no JAX); ``tests/test_torch_obs.py`` holds
it to the original.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.obs import fleet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-rank repro telemetry traces into one "
                    "Perfetto timeline (one named track per rank).")
    ap.add_argument("inputs", nargs="+",
                    help="rank trace files, or one directory containing "
                         "rank*.trace.jsonl files")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: merged.trace.jsonl next "
                         "to the inputs)")
    args = ap.parse_args(argv)

    try:
        if len(args.inputs) == 1 and os.path.isdir(args.inputs[0]):
            paths = fleet.discover_rank_traces(args.inputs[0])
            out = args.out or os.path.join(args.inputs[0],
                                           "merged.trace.jsonl")
        else:
            paths = list(args.inputs)
            out = args.out or os.path.join(
                os.path.dirname(paths[0]) or ".", "merged.trace.jsonl")
        summary = fleet.merge_traces(paths, out)
    except (fleet.MergeError, OSError) as e:
        print(f"error: {e}".splitlines()[0], file=sys.stderr)
        return 2

    ranks = summary["ranks"]
    print(f"merged {len(ranks)} rank trace(s) "
          f"(ranks {', '.join(map(str, ranks))}; "
          f"{summary['events']} events, "
          f"{summary['straggler_overlays']} straggler overlay(s)) "
          f"-> {summary['out']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
