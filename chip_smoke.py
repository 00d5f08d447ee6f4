#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. the card: its name and power limit;
2. build: every CUDA source under src/repro_torch/kernels/csrc, one nvcc
   each, all started together (into build/kernels/);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the rollout's shapes, including ragged cursors, stale NaN rows past the
   cursor and every cache dtype;
4. main path: sim-se2-fourier at full width (seeded random weights) rolls
   out 64 freeform scenes through RolloutEngine with float32 and int8
   caches; launch counts, output shape and finiteness are checked, and the
   cached decode is held to the full forward on two scenes;
5. times: each kernel at the tick shape beside its plain version, a
   PyTorch library call where one exists, and its bound on this card
   (CUDA events over back-to-back calls; CUPTI kernel time beside them).

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet rates (the bound_ms denominators)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

DECODE_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
              "bfloat16": dict(atol=8e-3, rtol=8e-3),
              "int8": dict(atol=2e-4, rtol=2e-3)}
SE2_TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
             "int8": dict(atol=8e-2, rtol=8e-2)}

REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode.py:115",
    "se2_project_q": "src/repro/kernels/se2_project.py:76",
    "se2_project_k": "src/repro/kernels/se2_project.py:42",
}
SOURCES = {
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "se2_project_q": "src/repro_torch/kernels/csrc/se2_project.cu",
    "se2_project_k": "src/repro_torch/kernels/csrc/se2_project.cu",
}


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def close_or_raise(what, got, want, atol, rtol):
    """Max |got - want|; raises when any element is out of tolerance."""
    import torch
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of "
                             f"tolerance (max abs err {float(err.max()):.3e})")
    return float(err.max())


def time_ms(fn, batches=20, per_batch=10, warmup=5):
    """Median per-call milliseconds over ``batches`` runs of ``per_batch``
    back-to-back calls, each run between two CUDA events. Where the host
    launches slower than the card runs the call, this is the launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(batches)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(batches)]
    for s, e in zip(starts, ends):
        s.record()
        for _ in range(per_batch):
            fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / per_batch
                             for s, e in zip(starts, ends))


def kernel_ms(fn, reps=20):
    """Mean device milliseconds a call spends in kernels (CUPTI, through
    torch.profiler): the call's own time on the card, without the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps


# ---------------------------------------------------------------------------
# inputs at the rollout's shapes
# ---------------------------------------------------------------------------

def decode_case(gen, dev, cache_dtype, *, layers, b, h, s, c, sq, cursors,
                num_map, num_agents):
    """A stacked cache with scene-layout times, scribbled segment ids and
    NaN rows past each cursor, plus appended query rows."""
    import torch
    from repro_torch.kernels.flash_decode import quantize_kv
    k = torch.randn((layers, b, h, s, c), generator=gen, device=dev)
    v = torch.randn((layers, b, h, s, c), generator=gen, device=dev)
    q = torch.randn((b, h, sq, c), generator=gen, device=dev)
    pos = torch.arange(s, device=dev)
    k_times = torch.where(pos < num_map, 0,
                          1 + (pos - num_map) // num_agents)
    k_times = k_times.to(torch.int32)[None].expand(b, s).contiguous()
    q_times = torch.full((b, sq), int(k_times.max()) + 1, dtype=torch.int32,
                         device=dev)
    k_seg = torch.where(torch.rand((b, s), generator=gen, device=dev) < 0.1,
                        -1, 0).to(torch.int32)
    q_seg = torch.where(torch.rand((b, sq), generator=gen, device=dev) < 0.1,
                        -1, 0).to(torch.int32)
    kvl = torch.as_tensor(cursors, dtype=torch.int32, device=dev)
    stale = pos[None, :] >= kvl[:, None].long()               # (b, s)
    k_seg = torch.where(stale, 0, k_seg).contiguous()         # scribbled
    k_scale = v_scale = None
    if cache_dtype == "int8":
        k, k_scale = quantize_kv(k)
        v, v_scale = quantize_kv(v)
        nan = torch.tensor(float("nan"), device=dev)
        k_scale = torch.where(stale[None, :, None], nan, k_scale).contiguous()
        v_scale = torch.where(stale[None, :, None], nan, v_scale).contiguous()
    else:
        dt = getattr(torch, cache_dtype)
        nan = torch.tensor(float("nan"), device=dev)
        k = torch.where(stale[None, :, None, :, None], nan, k).to(dt)
        v = torch.where(stale[None, :, None, :, None], nan, v).to(dt)
    return dict(q=q, k=k.contiguous(), v=v.contiguous(), kv_length=kvl,
                k_scale=k_scale, v_scale=v_scale, q_times=q_times,
                k_times=k_times, q_segment_ids=q_seg, k_segment_ids=k_seg)


def se2_case(gen, dev, b, h, n, d, pos_scale):
    import torch
    x = torch.randn((b, h, n, d), generator=gen, device=dev)
    xy = (torch.rand((b, n, 2), generator=gen, device=dev) * 2 - 1) * 60.0
    th = (torch.rand((b, n, 1), generator=gen, device=dev) * 2 - 1) * math.pi
    pose = torch.cat([xy * pos_scale, th], -1).contiguous()
    return x, pose


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import configs, scenarios
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.se2_project import (se2_fourier_project,
                                                 se2_project_plain)
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.runtime import RolloutEngine

    # 1. the card ------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(build_logs)}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    arch = configs.get_sim_arch("sim-se2-fourier")
    cfg = arch.agent_sim_config()
    scen = arch.scenario_config()
    model = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
    enc = model.blocks[0].attn.enc
    c = enc.expanded_dim
    t_hist, n_slots = 8, 64
    s_max = -(-(scen.num_map + scen.num_steps * scen.num_agents) // 128) * 128
    tick_rows, prefill_rows = scen.num_agents, \
        scen.num_map + t_hist * scen.num_agents
    log(f"arch {arch.name}: d_model {cfg.d_model}, {cfg.num_layers} layers, "
        f"{cfg.num_heads} heads x {cfg.head_dim}, F {cfg.fourier_terms}, "
        f"c {c}, max_len {s_max}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # 3. kernels against their plain versions ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {"flash_decode": 0.0, "se2_project_q": 0.0,
               "se2_project_k": 0.0}
    cursors = np.concatenate([[0, 1, 127, 128, s_max],
                              np.random.default_rng(0).integers(
                                  0, s_max + 1, n_slots - 5)])
    for cache_dtype in ("float32", "bfloat16", "int8"):
        for sq in (tick_rows, prefill_rows):
            case = decode_case(gen, dev, cache_dtype, layers=cfg.num_layers,
                               b=n_slots, h=cfg.num_heads, s=s_max, c=c,
                               sq=sq, cursors=cursors,
                               num_map=scen.num_map,
                               num_agents=scen.num_agents)
            q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
            want = ops.decode_attention(q, k, v, impl="plain", layer=3,
                                        **case)
            for splits in (None, 1, 5):
                got = ops.decode_attention(q, k, v, impl="flash_decode",
                                           layer=3, num_splits=splits,
                                           **case)
                torch.cuda.synchronize()
                err = close_or_raise(
                    f"flash_decode {cache_dtype} Sq={sq} splits={splits}",
                    got, want, **DECODE_TOL[cache_dtype])
                max_err["flash_decode"] = max(max_err["flash_decode"], err)
                log(f"flash_decode {cache_dtype:8s} Sq={sq:3d} "
                    f"splits={splits}: max abs err {err:.3e}")
    for n in (tick_rows, prefill_rows):
        x, pose = se2_case(gen, dev, n_slots, cfg.num_heads, n,
                           cfg.head_dim, cfg.pos_scale)
        for mode in ("q", "k"):
            got = se2_fourier_project(x, pose, enc, mode)
            torch.cuda.synchronize()
            err = close_or_raise(f"se2_project_{mode} n={n}", got,
                                 se2_project_plain(x, pose, enc, mode),
                                 **SE2_TOL)
            max_err[f"se2_project_{mode}"] = max(
                max_err[f"se2_project_{mode}"], err)
            log(f"se2_project_{mode} rows {tuple(x.shape[:3])}: "
                f"max abs err {err:.3e}")

    # 4. main path --------------------------------------------------------------
    scenes = [scenarios.generate_scene("freeform", 0, i, scen)
              for i in range(n_slots)]
    batch = {k_: torch.as_tensor(np.stack([s.tensors[k_] for s in scenes[:2]]),
                                 device=dev)
             for k_ in ("map_feats", "map_pose", "map_valid", "agent_feats",
                        "agent_pose", "agent_valid")}
    full = model(batch)
    for cache_dtype in ("float32", "int8"):
        cache = model.init_cache(2, s_max, cache_dtype)
        hist = {k_: (v_[:, :t_hist] if k_.startswith("agent") else v_)
                for k_, v_ in batch.items()}
        got, cache = model.prefill(cache, hist)
        err = close_or_raise(f"prefill vs full forward ({cache_dtype})",
                             got, full[:, :t_hist], **MODEL_TOL[cache_dtype])
        for t in range(t_hist, scen.num_steps):
            lt, cache = model.step(cache, batch["agent_feats"][:, t],
                                   batch["agent_pose"][:, t],
                                   batch["agent_valid"][:, t],
                                   torch.full((2,), t, dtype=torch.int32,
                                              device=dev))
            err = max(err, close_or_raise(
                f"step {t} vs full forward ({cache_dtype})", lt, full[:, t],
                **MODEL_TOL[cache_dtype]))
        log(f"cached decode vs full forward, {cache_dtype} cache: "
            f"max abs logit err {err:.3e}")

    RolloutEngine(model, scen, num_slots=n_slots).run(
        scenes, t_hist=t_hist, n_samples=1, seed=0)          # warm-up
    want_counts = {"flash_decode": cfg.num_layers * (1 + scen.num_steps
                                                     - t_hist)}
    want_counts["se2_project_q"] = want_counts["flash_decode"]
    want_counts["se2_project_k"] = 2 * want_counts["flash_decode"]
    launches = dict.fromkeys(want_counts, 0)
    for cache_dtype in ("float32", "int8"):
        engine = RolloutEngine(model, scen, num_slots=n_slots,
                               cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        t0 = time.perf_counter()
        fut = engine.run(scenes, t_hist=t_hist, n_samples=1, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        want_shape = (n_slots, 1, scen.num_steps - t_hist, scen.num_agents, 3)
        if fut.shape != want_shape or not np.isfinite(fut).all():
            raise AssertionError(f"rollout output {fut.shape} (want "
                                 f"{want_shape}), finite "
                                 f"{np.isfinite(fut).all()}")
        if counts != want_counts:
            raise AssertionError(f"{cache_dtype} launches {counts} != "
                                 f"{want_counts}")
        for name in launches:
            launches[name] += counts[name]
        log(f"rollout {cache_dtype}: {n_slots} scenes x {engine.ticks} ticks "
            f"in {secs:.3f} s = {engine.ticks / secs:.1f} ticks/s, "
            f"{n_slots / secs:.1f} scenes/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {counts}")

        if cache_dtype == "float32":
            f32_secs = secs

    # where the rollout's time goes: device time by kernel (torch.profiler)
    # against the unprofiled wall time of the same float32 run
    from torch.profiler import ProfilerActivity, profile
    engine = RolloutEngine(model, scen, num_slots=n_slots)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run(scenes, t_hist=t_hist, n_samples=1, seed=0)
        torch.cuda.synchronize()
    # kernel events only: a PyTorch op's event repeats its kernels' time
    per_kernel = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(ms for ms, _, _ in per_kernel)
    n_kernels = sum(count for _, count, _ in per_kernel)
    if device_ms > 0:
        log(f"profile: {device_ms:.2f} ms of device time in "
            f"{n_kernels} kernels ({n_kernels / (1 + engine.ticks):.0f} per "
            f"prefill or tick) over a {f32_secs * 1e3:.2f} ms unprofiled "
            f"float32 rollout: busy {device_ms / (f32_secs * 1e3):.1%}, "
            f"idle {1 - device_ms / (f32_secs * 1e3):.1%}")
        for ms, count, key in per_kernel[:15]:
            log(f"  {ms:9.3f} ms {count:6d} x {key[:90]}")
    else:
        log("profile: no device time recorded (device busy share not "
            "measured)")

    # 5. times at the tick shape ---------------------------------------------------
    kvl = scen.num_map + scen.num_steps * scen.num_agents - 2 * scen.num_agents
    case = decode_case(gen, dev, "float32", layers=cfg.num_layers,
                       b=n_slots, h=cfg.num_heads, s=s_max, c=c,
                       sq=tick_rows, cursors=[kvl] * n_slots,
                       num_map=scen.num_map, num_agents=scen.num_agents)
    q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
    decode = lambda impl: ops.decode_attention(  # noqa: E731
        q, k, v, impl=impl, layer=3, **case)
    live = case["k_times"][:, None, :kvl] <= case["q_times"][:, :, None]
    seg = ((case["q_segment_ids"][:, :, None]
            == case["k_segment_ids"][:, None, :kvl])
           & (case["k_segment_ids"][:, None, :kvl] >= 0))
    mask = (live & seg)[:, None].contiguous()             # (B, 1, Sq, kvl)
    kl, vl = k[3, :, :, :kvl], v[3, :, :, :kvl]
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        q, kl, vl, attn_mask=mask, scale=1.0 / math.sqrt(cfg.head_dim))
    b_, h_, sq_ = n_slots, cfg.num_heads, tick_rows
    dec_bytes = (b_ * h_ * kvl * 2 * c * 4 + b_ * h_ * sq_ * 2 * c * 4
                 + b_ * kvl * 2 * 4 + b_ * sq_ * 2 * 4 + b_ * 4)
    dec_flops = 2 * b_ * h_ * sq_ * kvl * 2 * c
    x, pose = se2_case(gen, dev, n_slots, cfg.num_heads, tick_rows,
                       cfg.head_dim, cfg.pos_scale)
    rows = n_slots * cfg.num_heads * tick_rows
    nb, nf = enc.num_blocks, enc.num_terms
    se2_bytes = rows * (cfg.head_dim + c) * 4 + n_slots * tick_rows * 3 * 4
    timings = {
        "flash_decode": dict(
            fn=lambda: decode("flash_decode"), plain=lambda: decode("plain"),
            library=library, bytes=dec_bytes, flops=dec_flops),
        "se2_project_q": dict(
            fn=lambda: se2_fourier_project(x, pose, enc, "q"),
            plain=lambda: se2_project_plain(x, pose, enc, "q"), library=None,
            bytes=se2_bytes, flops=rows * (nb * (4 * nf + 24) + 2 * nf)),
        "se2_project_k": dict(
            fn=lambda: se2_fourier_project(x, pose, enc, "k"),
            plain=lambda: se2_project_plain(x, pose, enc, "k"), library=None,
            bytes=se2_bytes, flops=rows * nb * (16 * nf * nf + 24 * nf + 8)),
    }
    records = []
    for name, tm in timings.items():
        ms = time_ms(tm["fn"])
        plain_ms = time_ms(tm["plain"])
        library_ms = time_ms(tm["library"]) if tm["library"] else None
        device = {"ms": kernel_ms(tm["fn"]), "plain_ms": kernel_ms(tm["plain"])}
        if tm["library"]:
            device["library_ms"] = kernel_ms(tm["library"])
        byte_ms = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        flop_ms = tm["flops"] / F32_FLOP_PER_S * 1e3
        rec = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(byte_ms, flop_ms),
               "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
               "library_ms": library_ms}
        records.append(rec)
        log(json.dumps({"kernel": name, "launches": launches[name],
                        "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms,
                        "bound_ms": rec["bound_ms"],
                        "max_err": max_err[name],
                        "device_time_ms": device}))
    log(f"tick shape: {n_slots} slots x {cfg.num_heads} heads x {tick_rows} "
        f"query rows, {kvl} live cache rows, c = {c}")

    log(json.dumps({"kernels": records}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
