"""Render the roofline table from the dry-run's JSONs (port of
``repro/launch/report.py``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report
           [--dir experiments/dryrun_torch] [--replicated]

``--replicated`` adds the memory a rank holds under the port's placement
today (``memory_replicated``: whole parameters and optimizer state) beside
the memory by the sharding rules.
"""
from __future__ import annotations

import argparse
import json
import os


def load(d):
    recs = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                recs.append(json.load(f))
    return recs


def fmt_ms(x):
    return f"{x*1e3:.1f}"


def _replicated(r):
    m = r.get("memory_replicated") or {}
    return (f" {m.get('hbm_per_chip_gib', 0.0):.1f} "
            f"| {'Y' if m.get('fits_hbm') else 'N'} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--replicated", action="store_true",
                    help="add the memory as the port places it today")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    rep = args.replicated

    print("| arch | shape | status | compute ms | memory ms | coll ms | "
          "dominant | useful FLOPs | HBM GiB/chip | fits |"
          + (" replicated GiB/chip | fits |" if rep else ""))
    print("|---|---|---|---:|---:|---:|---|---:|---:|---|"
          + ("---:|---|" if rep else ""))
    blank = " | |" if rep else ""
    n_ok = n_skip = n_err = 0
    for r in recs:
        if r.get("mesh") != args.mesh:
            continue
        if r["status"] == "skipped":
            n_skip += 1
            print(f"| {r['arch']} | {r['shape']} | skipped "
                  f"(sub-quadratic n/a) | | | | | | | |" + blank)
            continue
        if r["status"] != "ok":
            n_err += 1
            print(f"| {r['arch']} | {r['shape']} | ERROR: "
                  f"{r.get('error','')[:60]} | | | | | | | |" + blank)
            continue
        n_ok += 1
        t = r.get("terms")
        if not t:
            # count-only cells (agent-sim train step): no roofline terms,
            # but the memory evidence is still a row
            print(f"| {r['arch']} | {r['shape']} | compiled | | | | | "
                  f"| {r.get('hbm_per_chip_gib', 0.0):.1f} "
                  f"| {'Y' if r.get('fits_hbm') else 'N'} |"
                  + (_replicated(r) if rep else ""))
            continue
        u = r.get("useful_flops_frac")
        print(f"| {r['arch']} | {r['shape']} | ok | {fmt_ms(t['compute_s'])} "
              f"| {fmt_ms(t['memory_s'])} | {fmt_ms(t['collective_s'])} "
              f"| {t['dominant']} | {u:.2f} | {r['hbm_per_chip_gib']:.1f} "
              f"| {'Y' if r['fits_hbm'] else 'N'} |"
              + (_replicated(r) if rep else ""))
    print(f"\nok={n_ok} skipped={n_skip} errors={n_err}")

    # multi-pod memory-pass summary
    print("\nMulti-pod (2x16x16) compile proof:")
    ok = [r for r in recs if r.get("mesh") == "multi" and r["status"] == "ok"]
    err = [r for r in recs if r.get("mesh") == "multi"
           and r["status"] == "error"]
    skip = [r for r in recs if r.get("mesh") == "multi"
            and r["status"] == "skipped"]
    print(f"  compiled: {len(ok)}  skipped: {len(skip)}  errors: {len(err)}")
    for r in err:
        print(f"  ERROR {r['arch']} {r['shape']}: {r.get('error','')[:100]}")


if __name__ == "__main__":
    main()
