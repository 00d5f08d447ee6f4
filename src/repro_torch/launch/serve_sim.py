"""Launch a continuous-batching simulation service under Poisson traffic:
``python -m repro_torch.launch.serve_sim`` (port of ``launch/serve_sim.py``).

Stands up a :class:`repro_torch.runtime.SimServer`, streams procedurally
generated scenes at it with exponential inter-arrival gaps (the open-loop
traffic model serving systems are sized against), and reports sustained
scenes/s, tick latency percentiles and slab-cache accounting. Runs on the
card unless ``--device cpu`` is given; without a card it raises.

Run:  python -m repro_torch.launch.serve_sim --slots 8 --scenes 32
      python -m repro_torch.launch.serve_sim --cache-dtype int8 --rate 0.5
      python -m repro_torch.launch.serve_sim --device cpu

``docs/serving.md`` states the slot lifecycle and the isolation argument.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from repro_torch import obs
from repro_torch.kernels import cuda
from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
from repro_torch.runtime.sim_server import (SceneRequest, SimServer,
                                            poisson_drive)
from repro_torch.scenarios.core import ScenarioConfig
from repro_torch.scenarios.registry import generate_mixed


def build(args):
    """(scenario config, model) from the flags, weights seeded by
    ``--seed``. ``se2_fourier`` needs 6 | head_dim, so its head_dim is
    rounded up to a multiple of 6, as the reference's launcher does: 18 at
    the defaults, a cached row 150 wide."""
    scen = ScenarioConfig(num_map=args.num_map, num_agents=args.num_agents,
                          num_steps=args.num_steps)
    head_dim = args.d_model // args.heads
    if args.encoding == "se2_fourier":
        head_dim = -(-head_dim // 6) * 6      # encoding needs 6 | head_dim
    cfg = AgentSimConfig(d_model=args.d_model, num_layers=args.layers,
                         num_heads=args.heads, head_dim=head_dim,
                         d_ff=4 * args.d_model,
                         num_actions=scen.num_actions,
                         encoding=args.encoding)
    model = AgentSimModel(cfg, device=args.device,
                          generator=torch.Generator().manual_seed(args.seed))
    return scen, model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve procedurally generated scenes from a "
                    "continuous-batching SimServer under Poisson traffic.")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--scenes", type=int, default=32)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean Poisson arrivals per service tick")
    ap.add_argument("--t-hist", type=int, default=4)
    ap.add_argument("--num-map", type=int, default=32)
    ap.add_argument("--num-agents", type=int, default=8)
    ap.add_argument("--num-steps", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--encoding", default="se2_fourier")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--cache-dtype", default=None,
                    help="float32 / bfloat16 / int8 (default: float32)")
    ap.add_argument("--decode-impl", default=None,
                    help="auto / flash_decode / plain / ref (default: the "
                         "model's, auto)")
    ap.add_argument("--drain-lag", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="write the Chrome/Perfetto trace (spans + final "
                         "registry snapshot) to PATH after the drive; "
                         "render it with "
                         "python -m repro_torch.launch.obs_report")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="also dump the registry in Prometheus text "
                         "exposition format")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the drive into "
                         "DIR/trace.json (the sim_server.tick / .admit "
                         "record_function ranges label the launches)")
    ap.add_argument("--postmortem-out", default=None, metavar="PATH",
                    help="dump a SimServer flight-recorder bundle (per-"
                         "slot phase/cursor table + registry tail) to "
                         "PATH after the drive; render with python -m "
                         "repro_torch.launch.obs_report --postmortem")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("serve_sim")

    reg = obs.Registry()
    scen, model = build(args)
    srv = SimServer(model, scen, num_slots=args.slots,
                    cache_dtype=args.cache_dtype,
                    decode_impl=args.decode_impl, drain_lag=args.drain_lag,
                    device=args.device, registry=reg)
    scenes = generate_mixed(args.seed, 0, args.scenes, scen)
    reqs = [SceneRequest(uid=i, tensors=s, t_hist=args.t_hist,
                         seed=args.seed, scene_id=i)
            for i, s in enumerate(scenes)]

    log.info("serving %d scenes over %d slots on %s (slab %d rows/slot, "
             "cache_dtype=%s, decode=%s, rate=%.2f/tick)",
             len(reqs), args.slots, srv.device, srv.max_len,
             args.cache_dtype or "float32", args.decode_impl or "model",
             args.rate)
    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if srv.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    cuda.reset_launches()
    t0 = time.perf_counter()
    out = poisson_drive(srv, reqs, rate=args.rate, seed=args.seed,
                        warmup_ticks=1)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("torch profiler trace written to %s", path)
    hist = out["latency"]                 # working ticks after the first
    stats = srv.stats()
    if len(srv.done) != len(reqs):
        raise RuntimeError(f"requests lost: {len(srv.done)} of "
                           f"{len(reqs)} drained")
    log.info("drained %d/%d scenes in %d ticks, %.2fs wall "
             "(%.1f scenes/s sustained)", len(srv.done), len(reqs),
             srv.ticks, wall, len(reqs) / max(hist.sum, 1e-9))
    log.info("tick latency (after the first tick): p50 %.2f ms  "
             "p99 %.2f ms", 1e3 * hist.percentile(50),
             1e3 * hist.percentile(99))
    log.info("slab: %.1f MiB for %d x %d rows; peak occupancy is live "
             "rows / slab rows per tick", stats["slab_mib"],
             args.slots, srv.max_len)
    log.info("kernel launches: %s (each tick and each admission runs the "
             "model's %d layers once; each tick samples once)",
             dict(cuda.LAUNCHES) or "none (CPU)", model.cfg.num_layers)
    if args.telemetry_out:
        obs.write_chrome_trace(reg, args.telemetry_out)
        log.info("telemetry trace: %s (load in Perfetto, or render with "
                 "python -m repro_torch.launch.obs_report %s)",
                 args.telemetry_out, args.telemetry_out)
    if args.prom_out:
        with open(args.prom_out, "w") as f:
            f.write(obs.prometheus_text(reg))
        log.info("prometheus exposition: %s", args.prom_out)
    if args.postmortem_out:
        log.info("flight-recorder bundle: %s",
                 srv.dump_postmortem(args.postmortem_out, reason="manual"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
