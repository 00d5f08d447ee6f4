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
   and the backward run twice and required bitwise equal; the four se2
   modes (forward "q" and "k", transposed "q_t" and "k_t") at the tick,
   prefill and train shapes and at odd nb (head_dim 18, ragged tiles),
   float32 and bf16, each run twice and required bitwise equal, and the
   gradients of both directions through the kernels against those through
   the plain versions;
4. rollout: sim-se2-fourier at full width (seeded random weights) rolls
   out 64 freeform scenes through RolloutEngine with float32 and int8
   caches; launch counts, output shape and finiteness are checked, the
   cached decode is held to the O(S^2) reference forward on two scenes,
   and so are the flash kernels' forward logits; the profile counts device
   launches, host-to-device copies and stream synchronizations a tick, and
   a rollout must call no function of core/encodings.py or core/fourier.py
   that runs a tensor op (every SE(2) transform goes through the kernels);
   a highway and a pedestrian_crossing scene with padded agents are held
   to the reference forward too, on their valid agents;
5. training: the behaviour-cloning train step at full width, 32 freeform
   scenes a batch through ShardedIterator, 2 warm-up and 20 timed steps
   with global-norm clip and AdamW on warmup-cosine; the loss must be
   finite and fall, each flash kernel must launch 6 times a step and each
   se2 mode 12 times, the gradients of one freeform batch and of one
   batch of all seven families through the kernels are held to those
   through the plain versions, open-loop metrics on 2
   holdout batches must be finite; steps/s, peak memory and the device
   profile are printed (with the same counts a step), and a step must call
   no plain SE(2) op;
6. times: each kernel at its main-path shape beside its plain version, a
   PyTorch library call where one exists, and its bound on this card
   (CUDA events over back-to-back calls; CUPTI kernel time beside them);
   the decode at the tick and, in its record's "prefill", at the prefill;
   each se2 mode at the tick and, in its record's "train", at the train
   step's 32 x 8 x 336 rows;
   the tensor-core kernels' bound is at the tensor cores' rate for
   float32-accurate products, the CUDA-core bound beside it, and the
   share of the pairs the forward's and backward's tiles compute that the
   mask admits;
7. evaluation: evaluate_families with phase 5's trained model over all
   seven scenario families (16 scenes each, 4 samples, 64 slots): exact
   launch counts, every family's metrics finite with a kinematic
   infeasibility rate of 0, tables bitwise equal at 48 slots, no plain
   SE(2) op; wall seconds of scene generation, rollouts and scoring, and
   the host seconds of a mixed and a freeform training batch. Its
   launches join the kernels' record.

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
# bf16 outputs round to bf16 on both sides (tests/test_torch_cuda.py)
SE2_BF16_TOL = dict(atol=2e-2, rtol=2e-2)
SE2_MODES = ("se2_project_q", "se2_project_k", "se2_project_q_t",
             "se2_project_k_t")
# functions of core/encodings.py and core/fourier.py that read the encoding's
# configuration and run no tensor op; any other call there is a plain SE(2) op
SE2_CONFIG_FUNCTIONS = {"expanded_dim", "expanded_v_dim", "num_blocks",
                        "block_terms", "transforms_values", "scales",
                        "_log_spaced", "basis_frequencies",
                        "_quadrature_constants",
                        "<genexpr>"}   # expanded_dim's sum over the blocks
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
# the decode against the full forward on scenes with padded agents
MIXED_PAIR = ("highway", "pedestrian_crossing")
# the evaluation: every family, scenes a family, samples a scene, and the
# slot counts of the two runs that must give bitwise-equal tables
EVAL_SCENES, EVAL_SAMPLES, EVAL_SLOTS = 16, 4, (64, 48)
EVAL_SCENE_SEED = 777         # evaluate_families' default scene seed

# the transposed se2 modes have no TPU kernel: they compute what the JAX
# package computes with untransform_out (also transform_q's VJP) and with
# JAX autodiff of _expand_k
REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode.py:115",
    "se2_project_q": "src/repro/kernels/se2_project.py:76",
    "se2_project_k": "src/repro/kernels/se2_project.py:42",
    "se2_project_q_t": "src/repro/core/encodings.py:443",
    "se2_project_k_t": "src/repro/core/encodings.py:413",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:44",
    "flash_attention_dq": "src/repro/kernels/flash_attention_bwd.py:132",
    "flash_attention_dkv": "src/repro/kernels/flash_attention_bwd.py:181",
}
SOURCES = {
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "se2_project_q": "src/repro_torch/kernels/csrc/se2_project.cu",
    "se2_project_k": "src/repro_torch/kernels/csrc/se2_project.cu",
    "se2_project_q_t": "src/repro_torch/kernels/csrc/se2_project.cu",
    "se2_project_k_t": "src/repro_torch/kernels/csrc/se2_project.cu",
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


def se2_case(gen, dev, b, h, n, width, pos_scale):
    """x (b, h, n, width) and encoder-scaled poses (b, n, 3) of a scene
    60 m across."""
    import torch
    x = torch.randn((b, h, n, width), generator=gen, device=dev)
    xy = (torch.rand((b, n, 2), generator=gen, device=dev) * 2 - 1) * 60.0
    th = (torch.rand((b, n, 1), generator=gen, device=dev) * 2 - 1) * math.pi
    pose = torch.cat([xy * pos_scale, th], -1).contiguous()
    return x, pose


def se2_mode(name):
    """(kernel, plain version, mode, transposed) of an se2 record name."""
    from repro_torch.kernels import se2_project as sp
    mode = name.split("_")[2]
    if name.endswith("_t"):
        return sp.se2_fourier_project_t, sp.se2_project_t_plain, mode, True
    return sp.se2_fourier_project, sp.se2_project_plain, mode, False


def se2_flops(name, tokens, rows, nb, nf):
    """FLOPs an se2 mode needs (sin/cos not counted): the pose's
    coefficients once a token ("k": the 2F nodes' arguments and the 4F x 2F
    projection sums, a block; "q": the basis' arguments and v_x, v_y), and
    each row's expansion or contraction."""
    per_token = (nb * (8 * nf + 16 * nf * nf) if "_k" in name
                 else nf + 8 * nb)
    per_row = {"se2_project_k": 12 * nf + 6, "se2_project_q": 4 * nf + 18,
               "se2_project_k_t": 16 * nf + 6,
               "se2_project_q_t": 8 * nf + 18}[name]
    return tokens * per_token + rows * nb * per_row


def plain_se2_calls(fn):
    """Calls, on every thread, into functions of core/encodings.py and
    core/fourier.py that run tensor ops (all but SE2_CONFIG_FUNCTIONS) over
    ``fn()``: the plain SE(2) ops a path still runs, by function name."""
    import collections
    import threading
    import torch
    files = ("repro_torch/core/encodings.py", "repro_torch/core/fourier.py")
    hits = collections.Counter()

    def hook(frame, event, arg):
        code = frame.f_code
        if (event == "call" and code.co_filename.endswith(files)
                and code.co_name not in SE2_CONFIG_FUNCTIONS):
            hits[code.co_name] += 1
    threading.setprofile_all_threads(hook)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        threading.setprofile_all_threads(None)
    return hits


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
    runtime = {e.key: e.count for e in prof.key_averages()
               if e.key.startswith("cuda")}
    htod = sum(count for _, count, key in per_kernel
               if key.startswith("Memcpy HtoD"))
    units = per[1]()
    log(f"profile {what}: per {per[0]}: {n_kernels / units:.1f} device "
        f"launches, {htod / units:.2f} host-to-device copies, "
        f"{runtime.get('cudaStreamSynchronize', 0) / units:.2f} "
        f"cudaStreamSynchronize, "
        f"{runtime.get('cudaDeviceSynchronize', 0) / units:.2f} "
        f"cudaDeviceSynchronize" + ("" if "cudaLaunchKernel" in runtime else
                                    " (no CUDA runtime calls recorded)"))
    if device_ms <= 0:
        log(f"profile {what}: no device time recorded (device busy share "
            f"not measured)")
        return None
    busy = device_ms / (wall_s * 1e3)
    log(f"profile {what}: {device_ms:.2f} ms of device time in "
        f"{n_kernels} kernels ({n_kernels / units:.0f} per {per[0]}) over "
        f"a {wall_s * 1e3:.2f} ms unprofiled run: busy {busy:.1%}, idle "
        f"{1 - busy:.1%}")
    for ms, count, key in per_kernel[:15]:
        log(f"  {ms:9.3f} ms {count:6d} x {key[:90]}")
    return busy


class Replay:
    """The engine surface ``evaluate_scenes`` reads (``run``, ``scen``),
    returning futures already rolled out: the scoring alone."""

    def __init__(self, futures, scen):
        self.futures, self.scen = futures, scen

    def run(self, scenes, **_):
        return self.futures


def same_tables(a, b) -> bool:
    """Evaluation tables equal bitwise, NaN (no vehicle to score) equal to
    NaN."""
    return a.keys() == b.keys() and all(
        a[f].keys() == b[f].keys() and all(
            x == y or (math.isnan(x) and math.isnan(y))
            for x, y in ((a[f][k], b[f][k]) for k in a[f]))
        for f in a)


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
    from repro_torch.core.encodings import SE2Fourier
    from repro_torch.kernels.se2_project import (se2_fourier_project,
                                                 se2_fourier_project_t,
                                                 se2_project_plain,
                                                 se2_project_t_plain)
    from repro_torch.data import ShardedIterator
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.nn.agent_sim import AgentSimModel, action_nll
    from repro_torch.runtime import (EvalConfig, RolloutEngine,
                                     evaluate_families, evaluate_scenes)
    from repro_torch.training.data import (holdout_batches, make_batch_fn,
                                           make_sim_batch)
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
    train_tokens = scen.num_map + scen.num_steps * scen.num_agents
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
    # the four se2 modes at the tick, prefill and train shapes, and at odd
    # nb (head_dim 18: rows off 16-byte boundaries) with ragged tiles
    odd_enc = SE2Fourier(head_dim=18, num_terms=cfg.fourier_terms)
    se2_cases = [(enc, n_slots, tick_rows), (enc, n_slots, prefill_rows),
                 (enc, TRAIN_BATCH, train_tokens), (odd_enc, 5, 37)]
    for enc_, b_, n_ in se2_cases:
        errs = dict.fromkeys(SE2_MODES, 0.0)
        for name in SE2_MODES:
            kernel, plain, mode, transposed = se2_mode(name)
            width = enc_.expanded_dim if transposed else enc_.head_dim
            for dtype in (torch.float32, torch.bfloat16):
                x, pose = se2_case(gen, dev, b_, cfg.num_heads, n_, width,
                                   cfg.pos_scale)
                x = x.to(dtype)
                got = kernel(x, pose, enc_, mode)
                again = kernel(x, pose, enc_, mode)
                want = plain(x, pose, enc_, mode)
                torch.cuda.synchronize()
                f32 = dtype == torch.float32
                err = close_or_raise(
                    f"{name} {b_}x{cfg.num_heads}x{n_} head_dim "
                    f"{enc_.head_dim} {dtype}", got, want,
                    **(SE2_TOL if f32 else SE2_BF16_TOL))
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {b_}x{n_} {dtype}: not "
                                         f"bitwise repeatable")
                if f32:
                    errs[name] = err
                    max_err[name] = max(max_err[name], err)
        log(f"se2 rows {b_}x{cfg.num_heads}x{n_}, head_dim {enc_.head_dim}: "
            f"f32 and bf16 within tolerance, bitwise repeatable; f32 max "
            f"abs err " + ", ".join(f"{k_[12:]} {e:.3e}"
                                    for k_, e in errs.items()))
    # gradients through the kernels (each direction's backward is the
    # other's kernel) against autograd through the plain versions
    x, pose = se2_case(gen, dev, TRAIN_BATCH, cfg.num_heads, train_tokens,
                       cfg.head_dim, cfg.pos_scale)
    g_, _ = se2_case(gen, dev, TRAIN_BATCH, cfg.num_heads, train_tokens, c,
                     cfg.pos_scale)
    for mode in ("q", "k"):
        grads = []
        for fwd, bwd in ((se2_fourier_project, se2_fourier_project_t),
                         (se2_project_plain, se2_project_t_plain)):
            xr = x.clone().requires_grad_(True)
            gr = g_.clone().requires_grad_(True)
            loss = ((fwd(xr, pose, enc, mode) * g_).sum()
                    + (bwd(gr, pose, enc, mode) * x).sum())
            grads.append(torch.autograd.grad(loss, (xr, gr)))
        err = max(close_or_raise(f"se2 {mode} gradient", a, b, **SE2_TOL)
                  for a, b in zip(*grads))
        log(f"se2 {mode}: gradients of both directions through the kernels "
            f"vs the plain versions at the train shape: max abs err "
            f"{err:.3e}")
    del x, g_, grads
    calls = plain_se2_calls(lambda: se2_project_plain(
        *se2_case(gen, dev, 1, 1, 4, cfg.head_dim, cfg.pos_scale), enc, "k"))
    if not calls:
        raise AssertionError("plain_se2_calls saw no call of the plain "
                             "version")
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
    # two freeform scenes, all agents valid, and a highway and a
    # pedestrian_crossing scene with padded (segment-masked, frozen) agents
    padded = [next(s for s in (scenarios.generate_scene(f, 0, i, scen)
                               for i in range(100))
                   if s.num_valid_agents < scen.num_agents)
              for f in MIXED_PAIR]
    ref_model = AgentSimModel(dataclasses.replace(cfg, attn_impl="ref"),
                              generator=torch.Generator().manual_seed(0))
    for what, pair in (("freeform", scenes[:2]),
                       (" + ".join(MIXED_PAIR), padded)):
        batch = {k_: torch.as_tensor(np.stack([s.tensors[k_] for s in pair]),
                                     device=dev)
                 for k_ in ("map_feats", "map_pose", "map_valid",
                            "agent_feats", "agent_pose", "agent_valid")}
        valid = batch["agent_valid"]          # logits compared on valid agents
        with torch.no_grad():
            full = ref_model(batch)
            err = close_or_raise(f"flash forward vs reference forward "
                                 f"({what})", model(batch)[valid],
                                 full[valid], **MODEL_TOL["float32"])
        log(f"{what} (valid agents {[s.num_valid_agents for s in pair]} of "
            f"{scen.num_agents}): full forward through the flash kernels vs "
            f"the O(S^2) reference: max abs logit err {err:.3e}")
        for cache_dtype in ("float32", "int8"):
            cache = model.init_cache(2, s_max, cache_dtype)
            hist = {k_: (v_[:, :t_hist] if k_.startswith("agent") else v_)
                    for k_, v_ in batch.items()}
            got, cache = model.prefill(cache, hist)
            err = close_or_raise(
                f"prefill vs full forward ({what}, {cache_dtype})",
                got[valid[:, :t_hist]], full[:, :t_hist][valid[:, :t_hist]],
                **MODEL_TOL[cache_dtype])
            for t in range(t_hist, scen.num_steps):
                lt, cache = model.step(cache, batch["agent_feats"][:, t],
                                       batch["agent_pose"][:, t],
                                       valid[:, t],
                                       torch.full((2,), t, dtype=torch.int32,
                                                  device=dev))
                err = max(err, close_or_raise(
                    f"step {t} vs full forward ({what}, {cache_dtype})",
                    lt[valid[:, t]], full[:, t][valid[:, t]],
                    **MODEL_TOL[cache_dtype]))
            log(f"{what}: cached decode vs full forward, {cache_dtype} "
                f"cache: max abs logit err {err:.3e}")
    del ref_model

    RolloutEngine(model, scen, num_slots=n_slots).run(
        scenes, t_hist=t_hist, n_samples=1, seed=0)          # warm-up
    want_counts = {"flash_decode": cfg.num_layers * (1 + scen.num_steps
                                                     - t_hist)}
    want_counts["se2_project_q"] = want_counts["flash_decode"]
    want_counts["se2_project_k"] = 2 * want_counts["flash_decode"]
    want_counts["se2_project_q_t"] = want_counts["flash_decode"]
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
    calls = plain_se2_calls(lambda: engine.run(scenes, t_hist=t_hist,
                                               n_samples=1, seed=0))
    if calls:
        raise AssertionError(f"the rollout ran plain SE(2) ops: {calls}")
    log("rollout: no call into core/encodings.py or core/fourier.py that "
        "runs a tensor op")

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
    # a layer: q~ and untransform_out forward ("q", "q_t") and backward
    # ("q_t", "q"), k~ and v~ forward ("k" twice) and backward ("k_t" twice)
    per_step = {"flash_attention_fwd": cfg.num_layers,
                "flash_attention_dq": cfg.num_layers,
                "flash_attention_dkv": cfg.num_layers,
                "se2_project_q": 2 * cfg.num_layers,
                "se2_project_q_t": 2 * cfg.num_layers,
                "se2_project_k": 2 * cfg.num_layers,
                "se2_project_k_t": 2 * cfg.num_layers}
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

    # gradients of one batch: the kernels against the plain versions, on a
    # freeform batch and on one mixed batch of all seven families
    pmodel = AgentSimModel(dataclasses.replace(cfg, attn_impl="plain"),
                           generator=torch.Generator().manual_seed(0))
    pmodel.load_state_dict(tmodel.state_dict())
    pmodel.requires_grad_(True)
    for what, host_b in (("freeform", host_batch),
                         ("seven families", make_sim_batch(
                             0, 0, TRAIN_BATCH, scen, families=None))):
        gb = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in host_b.items()}
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
                raise AssertionError(
                    f"train grad {name} ({what}): kernels vs plain max abs "
                    f"err {err:.3e}, tensor max {scale_:.3e}")
            worst = max(worst, err / max(scale_, 1e-30))
        log(f"train step gradients, kernels vs plain versions, {what} batch "
            f"({int(gb['agent_valid'][:, 0].sum())} of "
            f"{TRAIN_BATCH * scen.num_agents} agents valid): worst max abs "
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
    calls = plain_se2_calls(one_step)
    if calls:
        raise AssertionError(f"the train step ran plain SE(2) ops: {calls}")
    log("train step: no call into core/encodings.py or core/fourier.py that "
        "runs a tensor op")
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
    def se2_timing(name, b_, n_):
        """An se2 mode at b_ scenes x n_ tokens, all heads, float32; each
        input read once and each output written once, bounded by bytes."""
        kernel, plain, mode, transposed = se2_mode(name)
        width = c if transposed else cfg.head_dim
        x, pose = se2_case(gen, dev, b_, cfg.num_heads, n_, width,
                           cfg.pos_scale)
        rows = b_ * cfg.num_heads * n_
        return dict(
            fn=lambda: kernel(x, pose, enc, mode),
            plain=lambda: plain(x, pose, enc, mode), library=None,
            bytes=rows * (cfg.head_dim + c) * 4 + b_ * n_ * 3 * 4,
            flops=se2_flops(name, b_ * n_, rows, enc.num_blocks,
                            enc.num_terms),
            kernel=name, shape=f"{b_} scenes x {cfg.num_heads} heads x {n_} "
                               f"tokens")

    # se2 at the tick (the record) and at the train step (its "train")
    timings = {
        "flash_decode": decode_timing(tick_rows, kvl, False),
        "flash_decode_prefill": dict(
            decode_timing(prefill_rows, prefill_rows, True), nest="prefill"),
        **{name: se2_timing(name, n_slots, tick_rows) for name in SE2_MODES},
        **{f"{name}_train": dict(se2_timing(name, TRAIN_BATCH, train_tokens),
                                 nest="train") for name in SE2_MODES},
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
    # the decode's prefill row and the se2 train rows ride in their kernel's
    # record: one entry a kernel
    for nested in [r for r in records if timings[r["name"]].get("nest")]:
        records.remove(nested)
        owner = next(r for r in records
                     if r["name"] == timings[nested["name"]]["kernel"])
        owner[timings[nested["name"]]["nest"]] = {k_: nested[k_] for k_ in (
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

    # 7. evaluation ---------------------------------------------------------
    phase("7. evaluation")
    eval_cfg = EvalConfig(t_hist=t_hist, n_samples=EVAL_SAMPLES, seed=0)
    fams = scenarios.registry.names()
    t0 = time.perf_counter()
    eval_scenes = [scenarios.generate_scene(f, EVAL_SCENE_SEED, i, scen)
                   for f in fams for i in range(EVAL_SCENES)]
    gen_secs = time.perf_counter() - t0
    chunks = -(-len(eval_scenes) * EVAL_SAMPLES // EVAL_SLOTS[0])
    per_chunk = cfg.num_layers * (1 + scen.num_steps - t_hist)
    want_counts = {"flash_decode": chunks * per_chunk,
                   "se2_project_q": chunks * per_chunk,
                   "se2_project_k": 2 * chunks * per_chunk,
                   "se2_project_q_t": chunks * per_chunk}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cuda.reset_launches()
    t0 = time.perf_counter()
    tables = evaluate_families(tmodel, scen, eval_cfg, families=None,
                               n_scenes_per_family=EVAL_SCENES,
                               scene_seed=EVAL_SCENE_SEED,
                               num_slots=EVAL_SLOTS[0])
    torch.cuda.synchronize()
    eval_secs = time.perf_counter() - t0
    counts = dict(cuda.LAUNCHES)
    if counts != want_counts:
        raise AssertionError(f"evaluation launches {counts} != {want_counts}")
    for name, n in counts.items():
        launches[name] += n
    log(f"evaluate_families: {len(fams)} families x {EVAL_SCENES} scenes x "
        f"{EVAL_SAMPLES} samples, {EVAL_SLOTS[0]} slots ({chunks} chunks of "
        f"1 prefill + {scen.num_steps - t_hist} ticks) in {eval_secs:.3f} s "
        f"= {len(eval_scenes) / eval_secs:.1f} scenes/s end to end, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({resident / 2**30:.2f} GiB resident before), launches {counts}")
    # where its time goes: scene generation (host), the rollouts (the card),
    # the scoring (host) over the same futures, which must give the same
    # tables
    engine = RolloutEngine(tmodel, scen, num_slots=EVAL_SLOTS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = engine.run(eval_scenes, t_hist=t_hist, n_samples=EVAL_SAMPLES,
                         seed=eval_cfg.seed)
    roll_secs = time.perf_counter() - t0
    device_profile(lambda: engine.run(eval_scenes, t_hist=t_hist,
                                      n_samples=EVAL_SAMPLES,
                                      seed=eval_cfg.seed),
                   roll_secs, ("prefill or tick", lambda: chunks * (
                       1 + scen.num_steps - t_hist)), "evaluation rollouts")
    del engine
    t0 = time.perf_counter()
    scored = evaluate_scenes(Replay(futures, scen), eval_scenes, eval_cfg)
    score_secs = time.perf_counter() - t0
    if not same_tables(scored, tables):
        raise AssertionError("the timed rollout and scoring gave other "
                             "tables than evaluate_families")
    log(f"evaluation host time: scene generation {gen_secs:.3f} s for "
        f"{len(eval_scenes)} scenes")
    log(f"evaluation rollouts: {roll_secs:.3f} s for "
        f"{len(eval_scenes) * EVAL_SAMPLES} lanes "
        f"({len(eval_scenes) / roll_secs:.1f} scenes/s)")
    log(f"evaluation scoring (host-side scene_metrics): {score_secs:.3f} s")
    for what, fam_ in (("seven families", None), ("freeform", FAMILIES)):
        t0 = time.perf_counter()
        make_sim_batch(0, 0, TRAIN_BATCH, scen, families=fam_)
        log(f"train data, {what}: one {TRAIN_BATCH}-scene make_sim_batch in "
            f"{time.perf_counter() - t0:.3f} s of host time")
    log("evaluation table (agent-weighted means):")
    for fam, row in tables.items():
        log(f"  {fam:24s} " + ", ".join(f"{k_} {v_:.6g}"
                                        for k_, v_ in row.items()))
    road_vehicles = {f: any(
        s.lane_graph is not None and bool(
            ((s.tensors["agent_type"] == scenarios.AGENT_TYPE["vehicle"])
             & s.tensors["agent_valid"][0]).any())
        for s in eval_scenes if s.family == f) for f in fams}
    if sorted(tables) != sorted(fams + ["overall"]):
        raise AssertionError(f"evaluation rows {sorted(tables)}")
    for fam, row in tables.items():
        want_n = EVAL_SCENES * (len(fams) if fam == "overall" else 1)
        finite = ["min_ade", "miss_rate", "collision_rate",
                  "kinematic_infeasibility_rate"]
        if fam == "overall" or road_vehicles[fam]:
            finite.append("offroad_rate")
        bad = [k_ for k_ in finite if not math.isfinite(row[k_])]
        if (bad or row["kinematic_infeasibility_rate"] != 0.0
                or row["n_scenes"] != want_n):
            raise AssertionError(f"evaluation {fam}: not finite {bad}, "
                                 f"row {row}")
    again = {}
    calls = plain_se2_calls(lambda: again.update(evaluate_families(
        tmodel, scen, eval_cfg, families=None,
        n_scenes_per_family=EVAL_SCENES, scene_seed=EVAL_SCENE_SEED,
        num_slots=EVAL_SLOTS[1])))
    if calls:
        raise AssertionError(f"the evaluation ran plain SE(2) ops: {calls}")
    if not same_tables(again, tables):
        raise AssertionError(f"evaluation at {EVAL_SLOTS[1]} slots gave "
                             f"other tables: {again}")
    log(f"evaluation: tables bitwise equal at {EVAL_SLOTS[0]} and "
        f"{EVAL_SLOTS[1]} slots; no call into core/encodings.py or "
        f"core/fourier.py that runs a tensor op")
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    phase("done")
    log(json.dumps({"kernels": records}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
