#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which fails the run:

1. the card: its name and power limit;
2. build: every CUDA source under src/repro_torch/kernels/csrc, one nvcc
   each, all started together (into build/kernels/); the flash forward's,
   the backward's and the decode's builds must show 0 spill bytes, and
   the HMMA instructions in their SASS are counted (cuobjdump);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the rollout's shapes, including ragged cursors, stale NaN rows past the
   cursor and every cache dtype, the decode also with the prefill's
   block-causal mask and required bitwise repeatable at every split
   count; the flash-attention forward, dq and dk/dv
   at the train step's shape (32 scenes, the scenes' own times and segment
   ids, -1 rows included) and on a feature matrix (index causal, window,
   softcap, GQA, Dv != D, ragged lengths, widths off the tensor cores' k8
   step, bf16), float32 gradients against the plain backward in float64,
   the forward (at the train shape and at odd widths, float32 and bf16)
   and the backward run twice and required bitwise equal;
4. rollout: sim-se2-fourier at full width (seeded random weights) rolls
   out 64 freeform scenes through RolloutEngine with float32 and int8
   caches; launch counts, output shape and finiteness are checked, the
   cached decode is held to the O(S^2) reference forward on two scenes,
   and so are the flash kernels' forward logits;
5. training: the behaviour-cloning train step at full width, 32 freeform
   scenes a batch through ShardedIterator, 2 warm-up and 20 timed steps
   with global-norm clip and AdamW on warmup-cosine; the loss must be
   finite and fall, each flash kernel must launch 6 times a step, the
   gradients of one batch through the kernels are held to those through
   the plain versions, open-loop metrics on 2 holdout batches must be
   finite; steps/s, peak memory and the device profile are printed;
6. times: each kernel at its main-path shape beside its plain version, a
   PyTorch library call where one exists, and its bound on this card
   (CUDA events over back-to-back calls; CUPTI kernel time beside them);
   the decode at the tick and, in its record's "prefill", at the prefill;
   the tensor-core kernels' bound is at the tensor cores' rate for
   float32-accurate products, the CUDA-core bound beside it, and the
   share of the pairs the forward's and backward's tiles compute that the
   mask admits.

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet rates (the bound_ms denominators): HBM, f32 on the
# CUDA cores, and float32-accurate products on the tensor cores (split TF32:
# three TF32 products each, a third of the 495 TFLOP/s TF32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SPLIT_TF32_FLOP_PER_S = 495e12 / 3
# rows a CTA of the forward / backward owns and rows it walks at c = 200
# (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
FWD_TILE_OWN, FWD_TILE_WALK = 64, 32
BWD_TILE_OWN, BWD_TILE_WALK = 64, 32

DECODE_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
              "bfloat16": dict(atol=8e-3, rtol=8e-3),
              "int8": dict(atol=2e-4, rtol=2e-3)}
SE2_TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
             "int8": dict(atol=8e-2, rtol=8e-2)}
# flash kernels vs plain versions: tests/test_kernels.py:25-27 (forward)
# and :162-163 (gradients); bf16 outputs round to bf16 on both sides
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
FLASH_GRAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-3),
                  "bfloat16": dict(atol=1e-2, rtol=4e-2)}
# the train step's parameter gradients, kernels vs plain versions, per
# tensor relative to its largest |g|: float32 sums in another order through
# 6 layers forward and back; an indexing or masking fault shows at O(1)
TRAIN_GRAD_REL_TOL = 1e-3
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_LR = 32, 2, 20, 3e-3
# the rollout: scene slots, and steps of history written by the prefill
N_SLOTS, T_HIST = 64, 8
FAMILIES = ("freeform",)

REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode.py:115",
    "se2_project_q": "src/repro/kernels/se2_project.py:76",
    "se2_project_k": "src/repro/kernels/se2_project.py:42",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:44",
    "flash_attention_dq": "src/repro/kernels/flash_attention_bwd.py:132",
    "flash_attention_dkv": "src/repro/kernels/flash_attention_bwd.py:181",
}
SOURCES = {
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "se2_project_q": "src/repro_torch/kernels/csrc/se2_project.cu",
    "se2_project_k": "src/repro_torch/kernels/csrc/se2_project.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_dq": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_attention_dkv":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}


T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(title):
    log(f"--- {title} (at {time.perf_counter() - T0:.1f} s)")


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


def spill_bytes(build_log: str) -> int:
    """Spill stores and loads, in bytes, summed over a build log's
    functions (nvcc -Xptxas -v)."""
    return sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", build_log))


def sass_counts(library, opcode, kernels):
    """Instructions ``opcode`` in the SASS of the functions of ``library``
    whose names hold each of ``kernels`` (cuobjdump -sass), or None where
    the toolkit has no cuobjdump."""
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    counts = dict.fromkeys(kernels, 0)
    function = ""
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1]
        elif opcode in line:
            for name in kernels:
                if name in function:
                    counts[name] += 1
    return counts


def computed_pairs(pair_mask, own, walk):
    """Pairs a flash kernel's tensor-core tiles compute over a (B, owned
    rows, walked rows) mask: every pair of each own x walk tile (ragged
    edges padded) in which the mask admits at least one pair."""
    import torch
    b, n_own, n_walk = pair_mask.shape
    m = torch.nn.functional.pad(pair_mask.to(torch.uint8),
                                (0, -n_walk % walk, 0, -n_own % own))
    tiles = m.reshape(b, m.shape[1] // own, own, m.shape[2] // walk, walk)
    return int(tiles.amax(dim=4).amax(dim=2).sum()) * own * walk


def kernel_ms(fn, reps=20):
    """Mean device milliseconds a call spends in kernels (CUPTI, through
    torch.profiler): the call's own time on the card, without the host.
    Each kernel counts at its mean time a launch times its launches a call
    (its recorded launches over ``reps``, rounded), so that launches the
    trace misses do not read as time saved; a kernel whose recorded
    launches are not a whole number a call is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
            continue
        per_call = round(e.count / reps) or e.count / reps
        if e.count != per_call * reps:
            log(f"kernel_ms: CUPTI recorded {e.count} launches of "
                f"{e.key[:60]} over {reps} calls")
        total += e.self_device_time_total / e.count * per_call
    return total / 1e3


# ---------------------------------------------------------------------------
# inputs at the rollout's shapes
# ---------------------------------------------------------------------------

def decode_case(gen, dev, cache_dtype, *, layers, b, h, s, c, sq, cursors,
                num_map, num_agents, prefill=False):
    """A stacked cache with scene-layout times, scribbled segment ids and
    NaN rows past each cursor, plus query rows: appended at the newest
    time (a tick), or with ``prefill`` the cache's first ``sq`` tokens,
    their own times and segment ids (block-causal, as the prefill)."""
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
    if prefill:
        q_times = k_times[:, :sq].contiguous()
        q_seg = k_seg[:, :sq].contiguous()
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


def scene_attention_case(gen, dev, model, scen, n, scale):
    """Random q~, k~, v~ and output cotangent at the train step's attention
    shape (n scenes, all heads, c wide) with the scenes' own times and
    segment ids; a few agents and map tokens are marked invalid, so the
    -1 rows are in."""
    import torch
    from repro_torch.training.data import make_sim_batch
    batch = make_sim_batch(0, 0, n, scen, FAMILIES)
    batch["agent_valid"][::3, 5:, -2:] = False
    batch["map_valid"][1::4, -6:] = False
    _, times, seg = model.tokenize({k: torch.as_tensor(v, device=dev)
                                    for k, v in batch.items()})
    cfg = model.cfg
    c = model.blocks[0].attn.enc.expanded_dim
    shape = (n, cfg.num_heads, times.shape[1], c)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(4))
    return q, k, v, do, dict(causal=True, scale=scale, q_times=times,
                             k_times=times, q_segment_ids=seg,
                             k_segment_ids=seg)


# name: (b, hq, hkv, sq, sk, d, dv, options); lengths not multiples of the
# 16 / 32-row tiles
FLASH_FEATURES = {
    "causal_gqa_dv": (2, 4, 2, 45, 45, 32, 40, dict(causal=True)),
    "window_cross": (1, 2, 2, 50, 70, 24, 24, dict(window=12)),
    "causal_window_mqa": (2, 4, 1, 33, 65, 16, 16,
                          dict(causal=True, window=16)),
    "softcap": (1, 2, 2, 40, 40, 32, 32, dict(softcap=20.0)),
    # widths not multiples of the tensor cores' k8 step, lengths not of m16
    "odd_widths": (2, 4, 2, 37, 53, 20, 36, dict(causal=True)),
}


def feature_case(gen, dev, name, dtype):
    import torch
    b, hq, hkv, sq, sk, d, dv, opts = FLASH_FEATURES[name]
    shapes = ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
              (b, hq, sq, dv))
    q, k, v, do = (torch.randn(s_, generator=gen, device=dev).to(dtype)
                   for s_ in shapes)
    return q, k, v, do, opts


def check_flash(what, q, k, v, do, opts, max_err):
    """The three flash kernels against their plain versions on one input;
    returns the kernels' (dq, dk, dv)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    dt = "float32" if q.dtype == torch.float32 else "bfloat16"
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **opts)
    grads = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    # float32 gradients are held to exact ones: the plain backward of the
    # same inputs in float64, rounded to float32
    wide = torch.float64 if q.dtype == torch.float32 else q.dtype
    want = tuple(w.to(q.dtype) for w in fab.flash_bwd_plain(
        q.to(wide), k.to(wide), v.to(wide), out.to(wide), lse, do.to(wide),
        **opts))
    torch.cuda.synchronize()
    errs = {"flash_attention_fwd": close_or_raise(
        f"flash fwd {what}", out, want_out, **FLASH_TOL[dt])}
    live = want_lse > -1e29
    close_or_raise(f"flash lse {what}", lse[live], want_lse[live],
                   atol=1e-5, rtol=1e-5)
    for name, i in (("flash_attention_dq", 0), ("flash_attention_dkv", 1),
                    ("flash_attention_dkv", 2)):
        err = close_or_raise(f"{name} {what} ({'dq dk dv'.split()[i]})",
                             grads[i], want[i], **FLASH_GRAD_TOL[dt])
        errs[name] = max(errs.get(name, 0.0), err)
    for name, err in errs.items():
        max_err[name] = max(max_err[name], err)
    log(f"flash {what}: max abs err " + ", ".join(
        f"{n.split('_')[-1]} {e:.3e}" for n, e in errs.items()))
    return grads


def device_profile(run, wall_s, per, what):
    """Device time by kernel (torch.profiler) over ``run()`` against the
    unprofiled wall time ``wall_s`` of the same work; ``per`` is (unit,
    units in the run, read after it). Returns the busy share, or None when
    the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # kernel events only: a PyTorch op's event repeats its kernels' time
    per_kernel = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(ms for ms, _, _ in per_kernel)
    n_kernels = sum(count for _, count, _ in per_kernel)
    if device_ms <= 0:
        log(f"profile {what}: no device time recorded (device busy share "
            f"not measured)")
        return None
    busy = device_ms / (wall_s * 1e3)
    log(f"profile {what}: {device_ms:.2f} ms of device time in "
        f"{n_kernels} kernels ({n_kernels / per[1]():.0f} per {per[0]}) over "
        f"a {wall_s * 1e3:.2f} ms unprofiled run: busy {busy:.1%}, idle "
        f"{1 - busy:.1%}")
    for ms, count, key in per_kernel[:15]:
        log(f"  {ms:9.3f} ms {count:6d} x {key[:90]}")
    return busy


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
    from repro_torch.data import ShardedIterator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.nn.agent_sim import AgentSimModel, action_nll
    from repro_torch.runtime import RolloutEngine
    from repro_torch.training.data import holdout_batches, make_batch_fn
    from repro_torch.training.steps import (bc_optimizer, loss_summary,
                                            make_sim_train_step,
                                            open_loop_metrics)

    # 1. the card ------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build ---------------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    build_logs = cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(build_logs)}")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # the tensor-core kernels keep their accumulators in registers
    for source, kernels in (("flash_attention", ("fwd_kernel",)),
                            ("flash_attention_bwd",
                             ("dq_kernel", "dkv_kernel")),
                            ("flash_decode", ("decode_kernel",))):
        lib = cuda.library_path(source)
        text = build_logs[source] or lib.with_suffix(".log").read_text()
        if "spill stores" not in text:
            raise AssertionError(f"{source}: no ptxas report in its build "
                                 f"log")
        if spill_bytes(text):
            raise AssertionError(f"{source} spills {spill_bytes(text)} "
                                 f"bytes")
        hmma = sass_counts(lib, "HMMA", kernels)
        log(f"{source}: 0 spill bytes; HMMA instructions in the SASS: "
            + ("not available (no cuobjdump)" if hmma is None else
               ", ".join(f"{k} {n}" for k, n in hmma.items())))

    arch = configs.get_sim_arch("sim-se2-fourier")
    cfg = arch.agent_sim_config()
    scen = arch.scenario_config()
    model = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
    enc = model.blocks[0].attn.enc
    c = enc.expanded_dim
    t_hist, n_slots = T_HIST, N_SLOTS
    s_max = -(-(scen.num_map + scen.num_steps * scen.num_agents) // 128) * 128
    tick_rows, prefill_rows = scen.num_agents, \
        scen.num_map + t_hist * scen.num_agents
    log(f"arch {arch.name}: d_model {cfg.d_model}, {cfg.num_layers} layers, "
        f"{cfg.num_heads} heads x {cfg.head_dim}, F {cfg.fourier_terms}, "
        f"c {c}, max_len {s_max}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # 3. kernels against their plain versions ----------------------------------
    phase("3. kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = dict.fromkeys(REPLACES, 0.0)
    cursors = np.concatenate([[0, 1, 127, 128, s_max],
                              np.random.default_rng(0).integers(
                                  0, s_max + 1, n_slots - 5)])
    for cache_dtype in ("float32", "bfloat16", "int8"):
        for sq, prefill in ((tick_rows, False), (prefill_rows, False),
                            (prefill_rows, True)):
            case = decode_case(gen, dev, cache_dtype, layers=cfg.num_layers,
                               b=n_slots, h=cfg.num_heads, s=s_max, c=c,
                               sq=sq, cursors=cursors,
                               num_map=scen.num_map,
                               num_agents=scen.num_agents, prefill=prefill)
            q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
            want = ops.decode_attention(q, k, v, impl="plain", layer=3,
                                        **case)
            what = f"{cache_dtype:8s} Sq={sq:3d}{' prefill mask' * prefill}"
            for splits in (None, 1, 5):
                got = ops.decode_attention(q, k, v, impl="flash_decode",
                                           layer=3, num_splits=splits,
                                           **case)
                again = ops.decode_attention(q, k, v, impl="flash_decode",
                                             layer=3, num_splits=splits,
                                             **case)
                torch.cuda.synchronize()
                err = close_or_raise(
                    f"flash_decode {what} splits={splits}", got, want,
                    **DECODE_TOL[cache_dtype])
                if not torch.equal(got, again):
                    raise AssertionError(f"flash_decode {what} splits="
                                         f"{splits}: not bitwise repeatable")
                max_err["flash_decode"] = max(max_err["flash_decode"], err)
                log(f"flash_decode {what} splits={splits}: max abs err "
                    f"{err:.3e}, bitwise repeatable")
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
    attn_scale = 1.0 / math.sqrt(cfg.head_dim)
    train_case = scene_attention_case(gen, dev, model, scen, TRAIN_BATCH,
                                      attn_scale)
    first = check_flash("train shape " + "x".join(
        map(str, train_case[0].shape)), *train_case, max_err)
    again = fab.flash_attention_bwd(*train_case[:3], *fa.flash_attention_fwd(
        *train_case[:3], **train_case[4]), train_case[3], **train_case[4])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("flash backward is not bitwise repeatable")
    log("flash backward at the train shape: bitwise repeatable")
    for name in FLASH_FEATURES:
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(f"{name} {str(dtype)[6:]}",
                        *feature_case(gen, dev, name, dtype), max_err)
    repeat_cases = {"train shape": train_case}
    for dtype in (torch.float32, torch.bfloat16):
        repeat_cases[f"odd_widths {str(dtype)[6:]}"] = feature_case(
            gen, dev, "odd_widths", dtype)
    repeat_cases["train shape bfloat16"] = (
        *(t_.to(torch.bfloat16) for t_ in train_case[:4]), train_case[4])
    for what, (q, k, v, _, opts) in repeat_cases.items():
        first = fa.flash_attention_fwd(q, k, v, **opts)
        again = fa.flash_attention_fwd(q, k, v, **opts)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"flash forward {what}: not bitwise "
                                 f"repeatable")
    log(f"flash forward bitwise repeatable: {', '.join(repeat_cases)}")

    # 4. rollout -----------------------------------------------------------------
    phase("4. rollout")
    scenes = [scenarios.generate_scene("freeform", 0, i, scen)
              for i in range(n_slots)]
    batch = {k_: torch.as_tensor(np.stack([s.tensors[k_] for s in scenes[:2]]),
                                 device=dev)
             for k_ in ("map_feats", "map_pose", "map_valid", "agent_feats",
                        "agent_pose", "agent_valid")}
    ref_model = AgentSimModel(dataclasses.replace(cfg, attn_impl="ref"),
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = ref_model(batch)
        err = close_or_raise("flash forward vs reference forward", model(batch),
                             full, **MODEL_TOL["float32"])
    log(f"full forward through the flash kernels vs the O(S^2) reference: "
        f"max abs logit err {err:.3e}")
    del ref_model
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
    launches = dict.fromkeys(REPLACES, 0)
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
        for name, n in counts.items():
            launches[name] += n
        log(f"rollout {cache_dtype}: {n_slots} scenes x {engine.ticks} ticks "
            f"in {secs:.3f} s = {engine.ticks / secs:.1f} ticks/s, "
            f"{n_slots / secs:.1f} scenes/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {counts}")

        if cache_dtype == "float32":
            f32_secs = secs

    # where the rollout's time goes: device time by kernel (torch.profiler)
    # against the unprofiled wall time of the same float32 run
    engine = RolloutEngine(model, scen, num_slots=n_slots)
    device_profile(lambda: engine.run(scenes, t_hist=t_hist, n_samples=1,
                                      seed=0),
                   f32_secs, ("prefill or tick", lambda: 1 + engine.ticks),
                   "float32 rollout")

    # 5. training -----------------------------------------------------------------
    phase("5. training")
    del engine
    torch.cuda.empty_cache()
    tmodel = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
    data = ShardedIterator(make_batch_fn(scen, FAMILIES),
                           batch_size=TRAIN_BATCH, seed=0)
    opt = bc_optimizer(lr=TRAIN_LR, steps=TRAIN_WARMUP + TRAIN_STEPS)
    train_step = make_sim_train_step(tmodel, opt)
    state = opt.init(dict(tmodel.named_parameters()))
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        state, metrics = train_step(state, next(data))
    torch.cuda.synchronize()
    log(f"train warm-up: {TRAIN_WARMUP} steps in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cuda.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    train_secs = time.perf_counter() - t0
    counts = dict(cuda.LAUNCHES)
    losses = [float(x) for x in losses]
    per_step = {"flash_attention_fwd": cfg.num_layers,
                "flash_attention_dq": cfg.num_layers,
                "flash_attention_dkv": cfg.num_layers,
                "se2_project_q": cfg.num_layers,
                "se2_project_k": 2 * cfg.num_layers}
    want_counts = {k_: n * TRAIN_STEPS for k_, n in per_step.items()}
    if counts != want_counts:
        raise AssertionError(f"train launches {counts} != {want_counts}")
    for name, n in counts.items():
        launches[name] += n
    summary = loss_summary(losses)
    if not (np.isfinite(losses).all()
            and summary["loss_last"] < summary["loss_first"]):
        raise AssertionError(f"train loss did not fall: {losses}")
    log(f"train: {TRAIN_STEPS} steps x {TRAIN_BATCH} scenes in "
        f"{train_secs:.3f} s = {TRAIN_STEPS / train_secs:.2f} steps/s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({resident / 2**30:.2f} GiB of it resident before the loop: "
        f"weights, optimizer state, the kernel phase's inputs), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({summary}), grad_norm "
        f"{float(metrics['grad_norm']):.3f}, accuracy "
        f"{float(metrics['accuracy']):.3f}, launches {counts}")
    t0 = time.perf_counter()
    host_batch = next(data)
    log(f"train data: one {TRAIN_BATCH}-scene batch from the iterator in "
        f"{time.perf_counter() - t0:.3f} s of host time")

    # gradients of one batch: the kernels against the plain versions
    pmodel = AgentSimModel(dataclasses.replace(cfg, attn_impl="plain"),
                           generator=torch.Generator().manual_seed(0))
    pmodel.load_state_dict(tmodel.state_dict())
    pmodel.requires_grad_(True)
    gb = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in host_batch.items()}
    grads = []
    for m_ in (tmodel, pmodel):
        loss = action_nll(m_(gb), gb["actions"], gb["agent_valid"])
        names, leaves = zip(*m_.named_parameters())
        grads.append(dict(zip(names, torch.autograd.grad(loss, leaves))))
    worst = 0.0
    for name, g_plain in grads[1].items():
        scale_ = float(g_plain.abs().max())
        err = float((grads[0][name] - g_plain).abs().max())
        if not err <= TRAIN_GRAD_REL_TOL * scale_ + 1e-12:
            raise AssertionError(f"train grad {name}: kernels vs plain max "
                                 f"abs err {err:.3e}, tensor max {scale_:.3e}")
        worst = max(worst, err / max(scale_, 1e-30))
    log(f"train step gradients, kernels vs plain versions: worst max abs "
        f"err / tensor max {worst:.3e} over {len(grads[1])} tensors")
    del pmodel, grads
    ol = open_loop_metrics(tmodel, holdout_batches(scen, TRAIN_BATCH, 2,
                                                   families=FAMILIES))
    if not all(math.isfinite(x) for x in ol.values()):
        raise AssertionError(f"open-loop metrics not finite: {ol}")
    log(f"open-loop metrics on 2 holdout batches: {ol}")

    def one_step():
        nonlocal state
        state, _ = train_step(state, host_batch)
    device_profile(one_step, train_secs / TRAIN_STEPS, ("train step", lambda: 1),
                   "one train step")
    data.close()

    # 6. times at the main-path shapes ------------------------------------------
    phase("6. times")
    kvl = scen.num_map + scen.num_steps * scen.num_agents - 2 * scen.num_agents

    def decode_timing(sq, cursor, prefill):
        """flash_decode at the tick (sq new rows at the newest time against
        ``cursor`` live rows) or the prefill (the first sq tokens against
        themselves, block-causal), float32 cache; SDPA over the live prefix
        with the same mask. FLOPs count the (q, k) pairs the mask admits,
        bounded at the tensor cores' rate for float32-accurate products."""
        case = decode_case(gen, dev, "float32", layers=cfg.num_layers,
                           b=n_slots, h=cfg.num_heads, s=s_max, c=c, sq=sq,
                           cursors=[cursor] * n_slots, num_map=scen.num_map,
                           num_agents=scen.num_agents, prefill=prefill)
        q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
        live = (case["k_times"][:, None, :cursor]
                <= case["q_times"][:, :, None])
        seg = ((case["q_segment_ids"][:, :, None]
                == case["k_segment_ids"][:, None, :cursor])
               & (case["k_segment_ids"][:, None, :cursor] >= 0))
        mask = (live & seg)[:, None].contiguous()         # (B, 1, Sq, cursor)
        kl, vl = k[3, :, :, :cursor], v[3, :, :, :cursor]
        b_, h_ = n_slots, cfg.num_heads
        return dict(
            fn=lambda: ops.decode_attention(q, k, v, impl="flash_decode",
                                            layer=3, **case),
            plain=lambda: ops.decode_attention(q, k, v, impl="plain",
                                               layer=3, **case),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kl, vl, attn_mask=mask,
                scale=1.0 / math.sqrt(cfg.head_dim)),
            bytes=(b_ * h_ * cursor * 2 * c * 4 + b_ * h_ * sq * 2 * c * 4
                   + b_ * cursor * 2 * 4 + b_ * sq * 2 * 4 + b_ * 4),
            flops=2 * int(mask.sum()) * h_ * 2 * c,
            rate=SPLIT_TF32_FLOP_PER_S, kernel="flash_decode",
            shape=f"{'prefill' if prefill else 'tick'}: {b_} slots x {h_} "
                  f"heads x {sq} query rows, {cursor} live cache rows, "
                  f"{int(mask.sum())} of {b_ * sq * cursor} (q, k) pairs "
                  f"admitted a head")
    x, pose = se2_case(gen, dev, n_slots, cfg.num_heads, tick_rows,
                       cfg.head_dim, cfg.pos_scale)
    rows = n_slots * cfg.num_heads * tick_rows
    nb, nf = enc.num_blocks, enc.num_terms
    se2_bytes = rows * (cfg.head_dim + c) * 4 + n_slots * tick_rows * 3 * 4
    timings = {
        "flash_decode": decode_timing(tick_rows, kvl, False),
        "flash_decode_prefill": decode_timing(prefill_rows, prefill_rows,
                                              True),
        "se2_project_q": dict(
            fn=lambda: se2_fourier_project(x, pose, enc, "q"),
            plain=lambda: se2_project_plain(x, pose, enc, "q"), library=None,
            bytes=se2_bytes, flops=rows * (nb * (4 * nf + 24) + 2 * nf)),
        "se2_project_k": dict(
            fn=lambda: se2_fourier_project(x, pose, enc, "k"),
            plain=lambda: se2_project_plain(x, pose, enc, "k"), library=None,
            bytes=se2_bytes, flops=rows * nb * (16 * nf * nf + 24 * nf + 8)),
    }
    # the flash kernels at the train step's attention shape; FLOPs count
    # only the (q, k) pairs this run's mask admits, bounded at the tensor
    # cores' rate for float32-accurate products
    tq, tk, tv, tdo, topts = train_case
    tout, tlse = fa.flash_attention_fwd(tq, tk, tv, **topts)
    tdelta = torch.sum(tdo * tout, dim=-1)
    times_, seg_ = topts["q_times"], topts["q_segment_ids"]
    pair_mask = ((times_[:, None, :] <= times_[:, :, None])
                 & (seg_[:, :, None] == seg_[:, None, :])
                 & (seg_[:, None, :] >= 0))                 # (B, Sq, Sk)
    tb_, th_, ts_, tc_ = tq.shape
    pairs = int(pair_mask.sum()) * th_
    elem, row = tb_ * th_ * ts_ * tc_ * 4, tb_ * th_ * ts_ * 4
    masks_bytes = 4 * tb_ * ts_ * 4
    sdpa_mask = pair_mask[:, None]
    lq, lk, lv = (t_.detach().clone().requires_grad_(True)
                  for t_ in (tq, tk, tv))
    lout = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=sdpa_mask, scale=attn_scale)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lout, (lq, lk, lv), tdo, retain_graph=True)
    plain_bwd = lambda: fab.flash_bwd_plain(  # noqa: E731
        tq, tk, tv, tout, tlse, tdo, **topts)
    timings.update({
        "flash_attention_fwd": dict(
            fn=lambda: fa.flash_attention_fwd(tq, tk, tv, **topts),
            plain=lambda: fa.flash_fwd_plain(tq, tk, tv, **topts),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                tq, tk, tv, attn_mask=sdpa_mask, scale=attn_scale),
            bytes=4 * elem + row + masks_bytes,
            flops=2 * pairs * (tc_ + tc_), rate=SPLIT_TF32_FLOP_PER_S),
        # one plain backward and one SDPA backward compute dq, dk and dv
        # together: both rows carry the same combined plain_ms/library_ms
        "flash_attention_dq": dict(
            fn=lambda: fab.flash_attention_dq(tq, tk, tv, tdo, tlse, tdelta,
                                              **topts),
            plain=plain_bwd, library=sdpa_bwd,
            bytes=5 * elem + 2 * row + masks_bytes,
            flops=2 * pairs * (2 * tc_ + tc_), rate=SPLIT_TF32_FLOP_PER_S),
        "flash_attention_dkv": dict(
            fn=lambda: fab.flash_attention_dkv(tq, tk, tv, tdo, tlse,
                                               tdelta, **topts),
            plain=plain_bwd, library=sdpa_bwd,
            bytes=6 * elem + 2 * row + masks_bytes,
            flops=2 * pairs * (2 * tc_ + 2 * tc_), rate=SPLIT_TF32_FLOP_PER_S),
    })
    records = []
    measured = {}

    def once(timer, fn):
        """timer(fn), measured once for a function two rows share."""
        if (timer, fn) not in measured:
            measured[timer, fn] = timer(fn)
        return measured[timer, fn]

    for name, tm in timings.items():
        kernel = tm.get("kernel", name)
        ms = time_ms(tm["fn"])
        plain_ms = once(time_ms, tm["plain"])
        library_ms = once(time_ms, tm["library"]) if tm["library"] else None
        device = {"ms": kernel_ms(tm["fn"]),
                  "plain_ms": once(kernel_ms, tm["plain"])}
        if tm["library"]:
            device["library_ms"] = once(kernel_ms, tm["library"])
        byte_ms = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        flop_ms = tm["flops"] / tm.get("rate", F32_FLOP_PER_S) * 1e3
        rec = {"name": name, "route": "cuda", "source": SOURCES[kernel],
               "replaces": REPLACES[kernel], "launches": launches[kernel],
               "max_abs_err": max_err[kernel], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(byte_ms, flop_ms),
               "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
               "library_ms": library_ms,
               # the same work at the CUDA cores' f32 rate
               "bound_f32_ms": max(byte_ms,
                                   tm["flops"] / F32_FLOP_PER_S * 1e3)}
        records.append(rec)
        log(json.dumps({"kernel": kernel, "shape": tm.get("shape"),
                        "launches": launches[kernel],
                        "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms,
                        "bound_ms": rec["bound_ms"],
                        "bound_f32_ms": rec["bound_f32_ms"],
                        "max_err": max_err[kernel],
                        "device_time_ms": device}))
    # the decode's prefill row rides in its record: one entry a kernel
    prefill = records.pop([r["name"] for r in records].index(
        "flash_decode_prefill"))
    records[0]["prefill"] = {k_: prefill[k_] for k_ in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bound_f32_ms")}
    log(f"train attention shape: {tb_} scenes x {th_} heads x {ts_} tokens, "
        f"c = {tc_}; {pairs // th_} of {tb_ * ts_ * ts_} (q, k) pairs "
        f"admitted ({pairs / (th_ * tb_ * ts_ * ts_):.1%}); the plain_ms and "
        f"library_ms of flash_attention_dq and _dkv are one backward that "
        f"computes dq, dk and dv together")
    for name, own_mask, own, walk in (
            ("flash_attention_fwd", pair_mask, FWD_TILE_OWN, FWD_TILE_WALK),
            ("flash_attention_dq", pair_mask, BWD_TILE_OWN, BWD_TILE_WALK),
            ("flash_attention_dkv", pair_mask.transpose(1, 2), BWD_TILE_OWN,
             BWD_TILE_WALK)):
        computed = computed_pairs(own_mask, own, walk)
        log(f"{name}: its {own} x {walk} tiles compute {computed} (q, k) "
            f"pairs a head, of which the mask admits {pairs // th_} "
            f"({pairs / th_ / computed:.1%})")

    phase("done")
    log(json.dumps({"kernels": records}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
