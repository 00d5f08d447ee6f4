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
   count, at sim-se2-fourier's c = 200 and at the other arches' c = 24;
   the sampler at the engine's and the server's tick;
   the flash-attention forward, dq and dk/dv
   at the train step's shape (32 scenes, the scenes' own times and segment
   ids, -1 rows included; c = 200 and 24) and on a feature matrix (index causal, window,
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
   step's 32 x 8 x 336 rows; the decode (tick and prefill) and the flash
   kernels again at c = 24, in their records' "c24" and "c24_prefill",
   and at c = 150 ("c150", "c150_prefill") and past 256 columns (column
   windows: "c300", "c300_prefill", the decode also at "c500"); the decode, the flash kernels
   and the se2 modes in bf16 ("bf16", the se2 train shape "bf16_train");
   the sampler at the engine's tick (its record) and the server's
   ("server"), bounded by its integer operations;
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
   launches join the kernels' record;
8. Table-I arches: sim-absolute, sim-rope2d and sim-se2-repr at full width
   (seeded random weights), each through phase 4's checks against the
   reference forward and its float32 and int8 rollouts (exactly the
   decode's launches, no se2 kernel), phase 5's training (the flash
   kernels 6 times a step, gradients through the kernels against the
   plain versions, pose_proj included), open-loop metrics and an
   evaluation of 7 families x 4 scenes x 4 samples (launches exact, rates
   finite, kinematic infeasibility 0); the plain transforms' calls and
   launches of rope2d and se2_repr are reported, not gated; the action
   probabilities of a freeform scene re-posed by z must hold within 5e-4
   (se2_repr, rope2d under a translation) or move by more than 1e-4
   (absolute); phase 5's sim-se2-fourier weights run the same evaluation,
   and one Table-I line an arch is printed; Algorithm 2 through the flash
   forward is held to Algorithm 1 for rope2d, se2_repr and se2_fourier,
   and the peak memory of each is printed at N = M = 1024 and 4096
   (Algorithm 1 only where it needs at most half the card);
9. the trainer stack at full width (sim-se2-fourier, 32 freeform scenes a
   step): (a) ``train_sim.train_single``, the launcher's path, 30 steps
   with a checkpoint every 10 and an evaluation every 15 (7 families x 2
   scenes x 2 samples and 2 holdout batches), telemetry and the flight
   recorder armed: status done, the loss falling, the final checkpoint
   bitwise equal to the model, every closed-loop rate finite, the
   kernels' launches exactly those counted from the code, the trace's
   trainer.step / .checkpoint / .eval spans and its report; steps/s
   against phase 5's bare loop and the seconds of a save's parts; (b)
   20 steps straight against 10, a fresh Trainer's restore and 10 more:
   the data cursor, the losses within rtol 1e-5 and the parameters within
   1e-6, bitwise equality printed; (c) the NaN drill (--inject-nan-at):
   FloatingPointError, a checkpoint tagged halt_reason that a restore
   refuses without force and takes with it, the postmortem bundle
   rendered, and one skipped step leaving the parameters and the AdamW
   state bitwise unchanged; (d) the newest checkpoint truncated: the
   restore falls back one step and counts it; (e) run_comparison over
   the four encodings, 10 steps x 32 mixed scenes each: every row done,
   NLL and minADE finite, the loss falling, the table printed;
10. the continuous-batching SimServer at full width (phase 4's seed-0
   sim-se2-fourier, 64 slots, max_len 384): first the decode at the
   admission's shape (one scene's 48 map rows against themselves on the
   48-row sub-cache) and at the server tick's (every slot at its own
   cursor and step, retired slots past max_len), float32 and int8, and the
   se2 modes at the admission's, against their plain versions and bitwise
   repeatable; (a) a Poisson drive of 128 mixed scenes x 2 samples at 2.0
   arrivals a tick, float32 and int8: every lane ok and finite, launches
   exactly (ticks + admissions) x the model's per call, lanes/s, tick
   p50/p99, slab and peak memory; drain_lag 1 against 0 in one process
   over the first 64 scenes, and under the profiler the launches, copies and host waits (stream,
   device and event synchronisations) in each tick, at most one a tick
   with drain_lag 1; no plain SE(2) op; (b) the gauntlet in 8 slots,
   float32 and int8: an eviction mid-prefill, retirements, every stale row
   scribbled with NaN garbage, then the victim beside 7 neighbours bitwise
   equal to the victim alone in a fresh 8-slot server; (c) serve_scenes
   against RolloutEngine.run over phase 4's 64 scenes: the logits after
   the history within MODEL_TOL, the share of bitwise-equal futures
   printed; (d) a slot poisoned with NaN mid-rollout: one lane failed with
   nonfinite_pose, the others bitwise the no-fault run's, the scrubbed
   slot's next tenant bitwise its solo run; (e) ``python -m
   repro_torch.launch.chaos`` (all five drills pass, every bundle renders)
   and ``python -m repro_torch.launch.serve_sim`` at its defaults
   (head_dim 18, c = 150), its trace rendered by obs_report;
11. (a) sampling: the categorical kernel (jax.random's Threefry stream,
   csrc/categorical.cu) ran in phase 3 against repro_torch.prng at the
   engine's tick and the server's (each slot its own step, free slots):
   the 32-bit words and the uniforms bitwise, the Gumbel noise within
   1e-6, actions equal wherever the top two perturbed scores differ by
   1e-5 or more (the disagreements counted); here a rollout's actions are
   bitwise repeatable run to run, and a server lane (i, k) reproduces the
   engine's lane (i, k) bitwise wherever no agent meets a near-tie, the
   share printed; (b) widths: the decode (float32, bf16, int8 caches; a
   bf16 query too), the flash forward, dq and dk/dv at c = 50, 150, 250
   and two odd widths against their plain versions, then sim-se2-fourier
   at full width with head_dim 18 (c = 150) held to the reference forward
   (f32 and int8 caches), rolled out and trained 3 steps with launches
   exact; serve_sim's defaults build head_dim 18; (c) bfloat16: the same
   model at dtype "bfloat16": the kernels at its shapes in bf16 against
   their plain versions, its cached decode (bf16 and int8 caches) against
   its full forward at 8e-2, a 64-slot rollout (bf16 and int8 caches),
   20 train steps (loss finite and falling, float32 parameters), the
   7 x 4 x 4 evaluation and a 64-lane server drive, launches exact;
   ticks/s, steps/s, lanes/s, peak memory and slab beside the float32
   model's, and the action probabilities' shift under a re-pose. Every
   sampled path of phases 4, 7-11 launches the categorical kernel once a
   tick, and those counts are gated too;
12. (a) rows wider than 256 (balanced column windows): the decode (float32,
   bf16, int8 caches, a bf16 query) and the flash forward, dq and dk/dv at
   c = 300 and 500 against their plain versions (phase 6 times them), and
   sim-se2-fourier at full width with head_dim 36 (c = 300) held to the
   reference forward, rolled out and trained 3 steps, launches exact; the
   fleet on torch.distributed, four ranks sharing the card over gloo:
   (b) a 2 x 2 ("pod", "data") fleet rollout of 64 freeform scenes at full
   width, each rank's 16 lanes bitwise equal to a single-process engine
   with 16 slots, the gathered result against one engine running all 64
   lanes at MODEL_TOL (the bitwise lanes counted), every rank's launches
   exact and reported to rank 0; (c) the compressed-DP train step
   (int8 + error feedback over "pod") on the same 2 x 2 mesh, 32 scenes a
   global batch, and on a 1 x 1 mesh over NCCL: losses finite, parameters
   bitwise equal on every rank, launches exact, the 1 x 1 step's loss
   against the plain step's; (d) ``python -m repro_torch.launch.train_sim``
   over 2 ranks with checkpoints every 3 steps, then its last checkpoint
   removed and the run restarted from the one before: the final checkpoint
   bitwise equal to the first run's. Rates of (b)-(d) are of ranks sharing
   one card, not a scaling curve;
13. the dense LM serving stack: (a) the decode at phi4-mini-3.8b's tick
   (8 slots x 24 / 8 heads x 128, cursors spread over 1-2,048; float32,
   bf16 and int8 caches with float32 and bf16 queries; a 40-token chunk
   causal through its positions), stablelm-3b's 80-wide MHA and
   granite-20b's MQA (a group of 48), and the flash forward at the prefill
   (2 x 1,024 tokens, causal, float32 and bf16, and the same two archs'
   heads) against their plain versions, timed beside SDPA and the bound;
   (b) phi4-mini-3.8b at full width and depth (3.8 B parameters, float32,
   random weights from a CUDA generator seeded 0): the prefill step's last
   logits for 2 prompts of 512 tokens, and every position's, against the
   same prompts fed token by token through the serve step, within 2e-3 /
   2e-2, launches exact (32 flash forward, 32 x 512 decode) and no plain
   attention call; the registered bf16 config on the same weights: top-1
   equal to float32's at 85% of the positions at least, and in the
   prefill step's rows except at near-ties (float32's top two within
   1e-3), the disagreements counted; (c) the LM
   Server at full width (4 layers), 16 requests (prompts 16-256 tokens, 32 new each,
   greedy) through 8 slots with float32 and int8 caches: every request
   done with 32 tokens, the shortest, the longest and two admitted mid-run
   equal to their runs in a 1-slot server or parted from them at a
   near-tie (both runs' top two the same two tokens within 1e-3, read
   again at the parting token), decode launches exactly layers
   x ticks, no plain attention call; tokens/s, tick p50/p99, peak memory
   and the device profile of the float32 drive's first 40 ticks (launches
   a tick, busy share);
   (d) ``python -m repro_torch.launch.serve --arch phi4-mini-3.8b`` exits
   0 with its decode launches logged; (e) stablelm-3b, granite-20b and
   internvl2-26b at full width and 2 layers (internvl with its 256-token
   prefix, decoded as one chunk): token-by-token decode against the full
   forward as in (b), launches exact. (c) runs phi4-mini at full width and
   4 of its 32 layers (its ticks are host-bound); (b) and (d) run all 32;
14. LM training and gemma2-27b's attention: (a) the flash forward, dq and
   dk/dv at phi4-mini's train attention (2 x 24 / 8 heads x 512 x 128,
   causal, float32 and bf16) and at gemma2's local layer (1 x 32 / 16 x
   8,192 x 128, window 4,096, softcap 50, scale 144^-0.5), and the decode
   at gemma2's tick (2 slots x 32 / 16 x 128, cursors 4,700 and 5,200 past
   the window, and 100 and 3,000 within it; float32, bf16 and int8 caches
   x float32 and bf16 queries) against their plain versions, timed beside
   SDPA where there is no softcap; (b) one batch's gradients through the
   kernels against the plain versions, float32: phi4-mini at full width
   and 4 layers (2 x 512 tokens) and gemma2 at full width and one pair (1
   x 5,120 tokens, so the window bites), every tensor within 1e-3 of its
   largest |g|, launches exact, no plain attention call; (c) phi4-mini at
   full width and depth, bf16 compute over float32 master weights,
   ``make_train_step(remat=True)`` with launch/train's AdamW chain for 10
   steps of 2 x 512 synthetic_lm tokens: the loss finite and falling,
   exactly 64 forward, 32 dq and 32 dk/dv launches a step, steps/s,
   tokens/s, peak memory above the weights and one step's profile; then 3
   steps of clip + adafactor(1e-4), its peak memory beside AdamW's; (d) the
   Trainer on stablelm-3b's LM step at full width and 1 layer: 8 steps
   with a save at 4, a second Trainer from that checkpoint to 8 within the
   reference's restart tolerance, a NaN-reported step leaving the
   parameters and AdamW state bitwise, the seconds of a save and a
   restore; (e) ``python -m repro_torch.launch.train --arch phi4-mini-3.8b
   --reduced --steps 20 --ckpt-every 10`` exits 0 with its logged loss
   falling, and resumes from step 20 when run again; (f) gemma2-27b at
   full width and 4 layers (two pairs, float32): prompts of 4,700 and
   5,100 tokens prefilled into two slots, 64 positions each decoded with
   per-slot cursors and held to the full forward over the whole sequence
   (2e-3 / 2e-2 with a float32 cache, 8e-2 with int8), decode launches
   exactly layers x (prefills + ticks), half of them with the window and
   the softcap, no plain attention call; the tick's time.

15. MoE with MLA: (a) the decode at deepseek-v2-lite-16b's absorbed MLA
   tick (8 slots x 16 / 1 heads, D 576, the values the rows' first 512
   columns read in place at the rows' pitch, cursors up to 544; float32,
   and bf16 cache and query) and at its absorbed prefill (2 x 512 rows as
   one chunk, causal through the positions), and the flash forward, dq and
   dk/dv at its full forward (2 x 16 / 16 heads x 512, D 192, Dv 128,
   causal, float32 and bf16) against their plain versions, timed beside
   SDPA and the bound; (b) deepseek-v2-lite-16b at full width and depth
   (15,706,484,224 parameters, float32, a CUDA generator seeded 0) at
   capacity factor E / k: 2 prompts of 512 tokens prefilled as one chunk
   and 32 tokens decoded against the full forward on every position (2e-3
   / 2e-2), launches exact (27 flash forward; 27 decode a chunk or tick),
   no plain attention call; tokens/s, tick p50, peak memory, the ticks'
   profile (launches, busy share); the share of assignments dropped at the
   config's own 1.25; (c) the LM Server at full width and 4 layers (the
   dense layer and 3 MoE), 16 requests x 32 new tokens through 8 slots,
   float32 cache: every request done, 4 equal to their solo runs or
   parted at a near-tie, as 13c's (a tick's group is its 8 slots' tokens,
   whose capacity, 8, drops nothing), decode
   launches exactly layers x ticks, no plain attention call; (d) the
   gradients of deepseek at full width and 2 layers through the kernels
   against the plain versions (float32, 2 x 512 tokens, 1e-3 of each
   tensor's max |g|), then 10 AdamW steps at 4 layers (2,254,983,168
   parameters, bf16 compute, peak lr 3e-4): the loss's 5-step means fall,
   aux finite, 8 forward, 4 dq and 4 dk/dv launches a step; (e)
   kimi-k2-1t-a32b (1,028,298,994,688 parameters on meta) at full width,
   cut to 2 layers and 32 experts (4,463,004,672 parameters): decode
   against the full forward as (b).

The second-to-last lines are the kernels' JSON record and the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
Without a card, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import itertools
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
# encodings whose int8-cache decode drifts past MODEL_TOL["int8"] from the
# full forward in the reference too: se2_repr caches psi(p) k, whose
# translation column carries raw positions (tens of encoder units at
# metric poses), so one row's absmax scale coarsens its other entries.
# On phase 4's freeform pair at full width the reference's int8 decode
# drifts 0.116 and the port's 0.116. Their int8 decode through the kernels
# is held to the plain versions on the same int8 cache instead, and the
# drift is printed.
INT8_DRIFT_REPORTED = ("se2_repr",)
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
# phase 8: the other three Table-I arches, each rolled out, trained and
# scored as phases 4, 5 and 7 do (scenes a family of its evaluation), then
# held to SE(2) invariance under the re-posings z and Algorithm 1 against
# Algorithm 2
TABLE1_ARCHS = ("sim-absolute", "sim-rope2d", "sim-se2-repr")
TABLE1_EVAL_SCENES = 4
# tests/test_se2.py:154 (se2_repr, exact up to float32) and :168 (the
# absolute baseline must move); rope2d is re-posed by translations only
INVARIANCE_Z = {"se2_repr": (3.0, -2.0, 0.7), "rope2d": (3.0, -2.0, 0.0),
                "absolute": (3.0, -2.0, 0.7), "se2_fourier": (3.0, -2.0, 0.7)}
EXACT_INVARIANCE_BOUND, ABSOLUTE_MOVES = 5e-4, 1e-4
# Algorithm 2 against Algorithm 1: tests/test_encodings.py:50; shapes of
# the comparison and of the memory readings, and the poses' extent (m)
ALG_TOL = {"rope2d": 2e-5, "se2_repr": 2e-5, "se2_fourier": 5e-3}
ALG_HEADS, ALG_N, ALG_MEM_N, ALG_EXTENT_M = 8, 256, (1024, 4096), 30.0

# phase 9: the trainer stack at full width. (a) the launcher's path:
# steps, checkpoint and eval cadence, evaluation scenes a family x samples,
# holdout batches; (b) a straight run against a restart halfway; (c) the
# NaN drill: the step whose reported loss turns NaN, and the guard's limit;
# (e) the Table-I comparison's steps a run
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_EVAL_EVERY = 30, 10, 15
TRAINER_EVAL_SCENES, TRAINER_EVAL_SAMPLES, TRAINER_HOLDOUT = 2, 2, 2
RESTART_STEPS = 20
NAN_AT, MAX_NANS = 3, 5
# (10, not 20, keeps the whole run near 1,000 s of its 1,200 s: 75 of the
# 20-step comparison's 79 s were training, PERF.md §6)
COMPARE_STEPS = 10
# the restart against the straight run: the reference's own tolerances
# (tests/test_trainer_server.py:145-149)
RESTART_LOSS_RTOL, RESTART_PARAM_ATOL = 1e-5, 1e-6
# phase 10: the SimServer. (a) the Poisson drive: slots, mixed scenes x
# samples a scene, the lanes' horizon, arrivals a tick (about 3/4 of the
# 64 / 24 lanes a tick a full slab retires), the scenes' seed and the
# working ticks the latency histogram skips; (b) the gauntlet's slots (also
# (d)'s); (d) the lanes of the quarantine run
# (the drain_lag comparison's four drives run the first 64 scenes, not all
# 128: the six drives took half of 10a's 100 s on a slow card host, whose
# whole run passed 1,200 s, PERF.md §6)
SERVE_SLOTS, SERVE_SCENES, SERVE_SAMPLES, SERVE_T_TOTAL = 64, 128, 2, 24
SERVE_LAG_SCENES = 64
SERVE_RATE, SERVE_SEED, SERVE_WARMUP_TICKS = 2.0, 10, 2
# scenes of the profiled drive
SERVE_PROFILE_SCENES = 32
GAUNTLET_SLOTS, QUARANTINE_LANES = 8, 12

# phase 11: (b) the attention kernels at row widths (D, Dv) that are not
# multiples of 4: se2_fourier's c = 50 head_dim / 6 at head_dim 6, 18 and
# 30, and two odd widths; the head_dim of its full-width model (c = 150)
WIDTH_CASES = {"c50": (50, 50), "c150": (150, 150), "c250": (250, 250),
               "d75_dv151": (75, 151), "d13_dv7": (13, 7)}
WIDTH_HEAD_DIM = 18
# phase 12: (a) rows past the 256 columns the attention kernels keep in
# registers (balanced column windows): c = 300 and 500 (se2_fourier at
# head_dim 36 and 60), and the full-width model at head_dim 36; (b)-(d) the
# fleet on torch.distributed, its ranks sharing the one card over gloo:
# ranks and pods of the mesh, lanes of the fleet rollout (one chunk), DP
# train steps, and the launcher's steps and checkpoint cadence at world 2
WIDE_CASES = {"c300": (300, 300), "c500": (500, 500)}
WIDE_HEAD_DIM = 36
FLEET_WORLD, FLEET_PODS, FLEET_LANES, FLEET_DP_STEPS = 4, 2, 64, 3
LAUNCHER_WORLD, LAUNCHER_STEPS, LAUNCHER_CKPT_EVERY = 2, 6, 3
# the fleet rollout against one process running every lane at once: lanes
# may part only where sampling meets a near-tie (GEMMs of another shape
# round the logits apart by ulps); at most this share of them
FLEET_PARTED_SHARE = 0.02
# (a) two samplers whose float32 logs round an ulp apart (a Gumbel score
# moves by up to about 5e-7) may pick apart only where an agent's top two
# perturbed scores lie closer than this; lanes and slots of the checks
NEAR_TIE = 1e-5
SAMPLING_SCENES, SAMPLING_SAMPLES = 32, 2
# (c) the bf16 model: its cached decode against its full forward at the
# reference's bf16 tolerance (tests/test_decode.py:306-307); its train
# step's gradients through the kernels against the plain versions, per
# tensor relative to its largest |g|: each op rounds its output to bf16 on
# both paths, in other places, through 6 layers forward and back
BF16_MODEL_TOL = dict(atol=8e-2, rtol=8e-2)
BF16_GRAD_REL_TOL = 8e-2
BF16_EVAL_SCENES, BF16_SERVE_SCENES = 4, 32
# phase 13: the dense LM serving stack. (a) the decode at phi4-mini-3.8b's
# tick (slots, cursors spread over 1 up to this many rows) and the flash
# forward at its prefill (prompts x tokens); (b) the full-width model's
# prefill step against token-by-token decode at the reference's gate
# (tests/test_archs_smoke.py:118-120), its bf16 config's top-1 against
# float32's except at near-ties (float32's top two within LM_NEAR_TIE);
# (c) the Server: requests, slots, new tokens a request, prompt lengths,
# the cache's rows; (e) the other dense archs at full width, cut in depth
LM_ARCH = "phi4-mini-3.8b"
LM_SLOTS, LM_MAX_CURSOR = 8, 2048
LM_PREFILL_B, LM_PREFILL_S = 2, 1024
LM_GATE_PROMPTS, LM_GATE_LEN = 2, 512
LM_GATE_TOL = dict(atol=2e-3, rtol=2e-2)
# (also the server's solo-run gate: a slot rounds otherwise beside others,
# and at prompts of 16-128 tokens an int8 request parted from its solo run
# where its top two lay 2.2e-4 and 1.4e-4 apart, PERF.md §6)
LM_NEAR_TIE = 1e-3
# bf16 rounding moves the random-weight model's logits by about 0.1 a
# position (max abs on an H100, PERF.md §6), past most of float32's top-two
# gaps (median 0.15): over every position top-1 agreement is a share, not
# an identity
LM_BF16_AGREE = 0.85
LM_SERVE_REQUESTS, LM_SERVE_SLOTS, LM_SERVE_NEW = 16, 8, 32
LM_SERVE_PROMPT, LM_SERVE_MAX_LEN = (16, 256), 320
# the server's depth: a tick is host-bound (about 60 launches a layer,
# 57 ms at 32 layers on an H100, PERF.md §5), and 16 requests with
# four solo runs a cache dtype took 209 s at full depth; an eighth of it
# (4 layers; 8 took 60 s) keeps the whole run near 1,000 s
# (13b and 13d run the full 32 layers)
LM_SERVE_LAYERS = 4
LM_PROFILE_TICKS = 40
LM_SHALLOW_ARCHS = ("stablelm-3b", "granite-20b", "internvl2-26b")
LM_SHALLOW_LAYERS, LM_SHALLOW_TOKENS = 2, 64
# phase 14: LM training and gemma2. (a) the flash kernels at phi4-mini's
# train attention (prompts x tokens) and at gemma2's local layer (window,
# softcap, query_pre_attn_scalar 144); the decode at gemma2's tick (its
# cache's rows, cursors past the window, and a case where the window
# exceeds every cursor); (b) gradients through the kernels against the
# plain versions, per tensor relative to its largest |g| (phase 5's rule):
# (arch, layers, batch, tokens); (c) phi4-mini at full depth: AdamW steps
# (launch/train's chain) and adafactor steps of LM_TRAIN_B x LM_TRAIN_S
# synthetic tokens; (d) the Trainer on stablelm-3b at 1 layer: steps, the
# checkpoint step; (e) launch.train's steps and cadence; (f) gemma2 at 4
# layers: prompt lengths, decode steps
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS, LM_ADAFACTOR_STEPS = 2, 512, 10, 3
# launch/train's chain at this peak rate (its --lr): at its default 3e-3 the
# first steps' losses rise (12.87 -> 15.54 at the fourth) as they do through
# the plain attention in float32, and past the fifth step bf16 parts from
# float32 (the kernels in float32 follow the plain run) by more than the
# 0.35 their 5-step means fall; at 3e-4 these fall by 1.4
# (benchmarks/torch_lm_lr.py on an H100, PERF.md §6)
LM_TRAIN_LR = 3e-4
GEMMA_ARCH = "gemma2-27b"
GEMMA_LOCAL_S = 8192
GEMMA_TICK_CURSORS, GEMMA_SHORT_CURSORS, GEMMA_CACHE_ROWS = \
    (4700, 5200), (100, 3000), 5248
LM_GRAD_CASES = (("phi4-mini-3.8b", 4, 2, 512), (GEMMA_ARCH, 2, 1, 5120))
# (d) runs one layer: its 4.65 GiB checkpoints at 2 layers took 83 s of a
# run on a slow card host, whose whole run passed 1,200 s (PERF.md §6)
TRAINER_ARCH, TRAINER_LAYERS, TRAINER_STEPS_LM, TRAINER_CKPT_AT = \
    "stablelm-3b", 1, 8, 4
LAUNCH_TRAIN_STEPS, LAUNCH_TRAIN_CKPT = 20, 10
GEMMA_LAYERS, GEMMA_PROMPTS, GEMMA_NEW = 4, (4700, 5100), 64
# phase 15: MoE with MLA. (a) the decode at deepseek-v2-lite's absorbed tick
# (slots, cursors up to this many rows) and at its absorbed prefill (the
# gate's prompts as one chunk), the flash kernels at its full forward (the
# gate's prompts x tokens); (b) deepseek at full width and depth: prompts x
# tokens prefilled, then new tokens decoded a tick at a time, against the
# full forward, with the capacity factor E / k (nothing dropped); the ticks
# profiled; (c) the Server over the dense layer and 3 MoE layers: requests,
# slots, new tokens, prompt lengths, cache rows; (d) training cut in depth
# (the gradient check at fewer layers); (e) kimi-k2 at full width, cut in
# depth and experts (one full MoE layer holds 16.9 B expert parameters,
# 67.6 GB in float32); the reference's counts of the two configs' specs
MOE_ARCH, KIMI_ARCH = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
MLA_SLOTS, MLA_TICK_CURSOR = 8, 544
MOE_GATE_PROMPTS, MOE_GATE_LEN, MOE_GATE_NEW = 2, 512, 32
MOE_PROFILE_TICKS = 4
MOE_SERVE_LAYERS, MOE_SERVE_REQUESTS, MOE_SERVE_SLOTS, MOE_SERVE_NEW = \
    4, 16, 8, 32
MOE_SERVE_PROMPT, MOE_SERVE_MAX_LEN = (16, 128), 192
MOE_TRAIN_LAYERS, MOE_GRAD_LAYERS, MOE_TRAIN_STEPS = 4, 2, 10
KIMI_LAYERS, KIMI_EXPERTS, KIMI_PREFILL, KIMI_NEW = 2, 32, 48, 16
MOE_COUNTS = {MOE_ARCH: 15_706_484_224, KIMI_ARCH: 1_028_298_994_688}

# bound_ms denominators of phase 6's new rows: bf16 products on the tensor
# cores (H100 SXM data sheet), and 32-bit integer operations for the
# sampler's hash: 64 a clock an SM on compute capability 9.0 (the CUDA C++
# Programming Guide's arithmetic throughput table), 132 SMs at the H100
# SXM's 1.98 GHz boost clock
BF16_FLOP_PER_S = 989e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# operations of the sampler (csrc/categorical.cu), logf counted as one:
# Threefry-2x32 (the key schedule, 20 rounds of add, rotate, xor and 5 key
# injections), then the word's xor, the uniform's shift, or, subtract, add
# and max, two logs and negations, the logit's add and the argmax compare
THREEFRY_OPS = 2 + 20 * 3 + 5 * 3 + 2
SAMPLE_OPS = THREEFRY_OPS + 13

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
    # no TPU kernel: the reference samples in XLA (jax.random.categorical)
    "categorical": "src/repro/runtime/rollout.py:204",
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
    "categorical": "src/repro_torch/kernels/csrc/categorical.cu",
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


def grads_close_or_raise(what, got, want, rel_tol):
    """Phase 5's rule for parameter gradients, kernels (``got``) against
    plain versions (``want``), dicts of tensors by name: each tensor finite
    on both sides and within ``rel_tol`` of its plain max |g| (plus 1e-12).
    Returns (the largest max abs err / tensor max, its tensor's name)."""
    import torch
    worst, worst_name = 0.0, ""
    for name, g_plain in want.items():
        g = got[name]
        if not (torch.isfinite(g).all() and torch.isfinite(g_plain).all()):
            raise AssertionError(f"{what} grad {name}: non-finite values")
        scale = float(g_plain.abs().max())
        err = float((g.float() - g_plain.float()).abs().max())
        if not err <= rel_tol * scale + 1e-12:
            raise AssertionError(
                f"{what} grad {name}: kernels vs plain max abs err "
                f"{err:.3e}, tensor max {scale:.3e}")
        if err / max(scale, 1e-30) >= worst:
            worst, worst_name = err / max(scale, 1e-30), name
    return worst, worst_name


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


def scene_attention_case(gen, dev, model, scen, n, scale, c):
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
    shape = (n, model.cfg.num_heads, times.shape[1], c)
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


def sampling_case(gen, dev, b, a, k, per_slot):
    """Lane keys (b, 2) as RolloutEngine keys b / 2 scenes x 2 samples,
    steps (b,) int32 and logits (b, a, k): every lane at step 20 (the
    engine's tick), or with ``per_slot`` each at its own step and every
    fourth slot free (key(0) at step 0, as a server carries a free slot)."""
    import torch
    from repro_torch import prng
    from repro_torch.runtime.rollout import rollout_keys
    keys = rollout_keys(0, b // 2, 2, dev)
    logits = torch.randn((b, a, k), generator=gen, device=dev) * 3
    if per_slot:
        steps = torch.randint(0, 24, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        free = torch.arange(b, device=dev) % 4 == 3
        keys = torch.where(free[:, None], prng.key(0, device=dev),
                           keys).contiguous()
        steps = torch.where(free, 0, steps).to(torch.int32)
    else:
        steps = torch.full((b,), 20, dtype=torch.int32, device=dev)
    return keys, steps, logits


def check_sampler(what, keys, steps, logits):
    """The categorical kernel (its debug entry) against repro_torch.prng,
    its plain version, on the card: the 32-bit words and the uniforms
    bitwise, the Gumbel noise within 1e-6 (float32 log), the actions equal
    wherever the top two perturbed scores differ by NEAR_TIE or more, the
    kernel bitwise repeatable. Returns the noise's max abs error."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import categorical as cat
    acts, words, unif, noise = cat.categorical_debug(keys, steps, logits)
    again = cat.categorical_debug(keys, steps, logits)[0]
    b, a, k = logits.shape
    keys_t = prng.fold_in(keys, steps)
    tiny = float(torch.finfo(torch.float32).tiny)
    want_noise = prng.gumbel(keys_t, (a, k))
    want = prng.categorical(keys_t, logits)
    torch.cuda.synchronize()
    if not (torch.equal(words, prng.random_bits(keys_t, (a, k)))
            and torch.equal(unif, prng.uniform(keys_t, (a, k),
                                               minval=tiny))):
        raise AssertionError(f"categorical {what}: words or uniforms differ "
                             f"from prng's")
    err = close_or_raise(f"categorical {what}: noise", noise, want_noise,
                         atol=1e-6, rtol=0.0)
    if not torch.equal(acts, again):
        raise AssertionError(f"categorical {what}: not bitwise repeatable")
    top2 = (want_noise + logits).topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = acts != want
    if bool((gap[differ] >= NEAR_TIE).any()):
        raise AssertionError(f"categorical {what}: {int(differ.sum())} rows "
                             f"differ from prng's, not all at near-ties")
    log(f"categorical {what} ({b} x {a} x {k}): words and uniforms bitwise "
        f"equal to prng's, noise max abs err {err:.3e}; actions equal in "
        f"{b * a - int(differ.sum())} of {b * a} rows, "
        f"{int(differ.sum())} differ, each at a near-tie ("
        f"{int((gap < NEAR_TIE).sum())} rows have a top-two gap under "
        f"{NEAR_TIE:g}); bitwise repeatable")
    return err


def score_gaps(model, scen, scenes, t_hist, n_samples, seed):
    """RolloutEngine's tick loop over every (scene, sample) lane in one
    chunk, recording each tick's gap between every agent's top two
    perturbed scores (Gumbel noise plus logits): numpy (S, K, T_fut, A).
    Lane (si, ki) is keyed as RolloutEngine.run keys it."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.kernels.categorical import categorical
    from repro_torch.runtime import RolloutEngine
    from repro_torch.runtime.rollout import rollout_keys
    total, dev = len(scenes) * n_samples, model.device
    eng = RolloutEngine(model, scen, num_slots=total)
    lanes = np.arange(total) // n_samples
    hist = scene_batch([scenes[i] for i in lanes], dev)
    hist = {k_: (v_[:, :t_hist] if k_.startswith("agent") else v_)
            for k_, v_ in hist.items()}
    keys = rollout_keys(seed, len(scenes), n_samples, dev)
    gaps = []
    with torch.no_grad():
        logits, cache = model.prefill(eng.init_cache(), hist)
        logits = logits[:, -1].float().contiguous()
        pose = hist["agent_pose"][:, -1]
        speed = hist["agent_feats"][:, -1, :, 0] * 10.0
        feats, valid = hist["agent_feats"][:, -1], hist["agent_valid"][:, -1]
        for t in range(t_hist, scen.num_steps):
            steps = torch.full((total,), t, dtype=torch.int32, device=dev)
            scores = prng.gumbel(prng.fold_in(keys, steps),
                                 logits.shape[1:]) + logits
            top2 = scores.topk(2, dim=-1).values
            gaps.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
            acts = categorical(keys, steps, logits)
            cache, logits, pose, speed = eng._advance(
                cache, acts, pose, speed, feats, valid, t)
            logits = logits.float().contiguous()
    return np.stack(gaps, 1).reshape(len(scenes), n_samples, -1,
                                     scen.num_agents)


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


SCENE_KEYS = ("map_feats", "map_pose", "map_valid", "agent_feats",
              "agent_pose", "agent_valid")


def scene_batch(scenes, dev):
    """The model's input tensors of a list of scenes, on ``dev``."""
    import numpy as np
    import torch
    return {k: torch.as_tensor(np.stack([s.tensors[k] for s in scenes]),
                               device=dev) for k in SCENE_KEYS}


def check_against_reference(model, scen, pairs, t_hist, s_max,
                            cache_dtypes=("float32", "int8"), tol=None):
    """On each (name, scenes) pair's valid agents: the full forward through
    the flash kernels against the O(S^2) reference forward (the same
    weights at attn_impl "ref"), and prefill plus every step with each of
    ``cache_dtypes`` against that reference; at MODEL_TOL, or ``tol`` for
    every comparison (the bf16 model's)."""
    import torch
    from repro_torch.nn.agent_sim import AgentSimModel
    dev = model.device
    ref_model = AgentSimModel(dataclasses.replace(model.cfg, attn_impl="ref"),
                              device=dev)
    ref_model.load_state_dict(model.state_dict())
    for what, pair in pairs:
        batch = scene_batch(pair, dev)
        valid = batch["agent_valid"]          # logits compared on valid agents
        n = len(pair)
        with torch.no_grad():
            full = ref_model(batch)
            err = close_or_raise(f"flash forward vs reference forward "
                                 f"({what})", model(batch)[valid],
                                 full[valid],
                                 **(tol or MODEL_TOL["float32"]))
        log(f"{what} (valid agents {[s.num_valid_agents for s in pair]} of "
            f"{scen.num_agents}): full forward through the flash kernels vs "
            f"the O(S^2) reference: max abs logit err {err:.3e}")
        hist = {k_: (v_[:, :t_hist] if k_.startswith("agent") else v_)
                for k_, v_ in batch.items()}
        for cache_dtype in cache_dtypes:
            reported = (cache_dtype == "int8"
                        and model.cfg.encoding in INT8_DRIFT_REPORTED)
            decoded = {}
            for impl in ("auto", "plain") if reported else ("auto",):
                cache = model.init_cache(n, s_max, cache_dtype)
                with torch.no_grad():
                    steps_ = [model.prefill(cache, hist, impl=impl)[0]]
                    for t in range(t_hist, scen.num_steps):
                        steps_.append(model.step(
                            cache, batch["agent_feats"][:, t],
                            batch["agent_pose"][:, t], valid[:, t],
                            torch.full((n,), t, dtype=torch.int32,
                                       device=dev), impl=impl)[0][:, None])
                decoded[impl] = torch.cat(steps_, 1)
            got = decoded["auto"]
            if reported:
                err = close_or_raise(
                    f"cached decode through the kernels vs the plain "
                    f"versions ({what}, {cache_dtype})", got[valid],
                    decoded["plain"][valid],
                    **(tol or MODEL_TOL[cache_dtype]))
                drift = float((got - full)[valid].abs().max())
                log(f"{what}: cached decode through the kernels vs the "
                    f"plain versions, {cache_dtype} cache: max abs logit err "
                    f"{err:.3e}; drift from the full forward {drift:.3e} "
                    f"(not gated: int8 rows of {model.cfg.encoding})")
                continue
            err = close_or_raise(
                f"cached decode vs full forward ({what}, {cache_dtype})",
                got[valid], full[valid], **(tol or MODEL_TOL[cache_dtype]))
            log(f"{what}: cached decode vs full forward, {cache_dtype} "
                f"cache: max abs logit err {err:.3e}")


def rollouts(model, scen, scenes, t_hist, want_counts, launches, what,
             cache_dtypes=("float32", "int8"), stats=None):
    """One warm-up, then one RolloutEngine.run of ``scenes`` (a slot each)
    with each of ``cache_dtypes``: the output shaped and finite, the
    launches exactly ``want_counts`` (added to ``launches``); then the
    first cache dtype's device profile. ``stats`` gets each dtype's
    (ticks/s, peak GiB). Returns an engine of the first cache dtype."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.runtime import RolloutEngine
    n_slots = len(scenes)
    RolloutEngine(model, scen, num_slots=n_slots).run(
        scenes, t_hist=t_hist, n_samples=1, seed=0)          # warm-up
    for cache_dtype in cache_dtypes:
        engine = RolloutEngine(model, scen, num_slots=n_slots,
                               cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        cuda.reset_launches()
        t0 = time.perf_counter()
        fut = engine.run(scenes, t_hist=t_hist, n_samples=1, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        want_shape = (n_slots, 1, scen.num_steps - t_hist, scen.num_agents,
                      3)
        if fut.shape != want_shape or not np.isfinite(fut).all():
            raise AssertionError(f"rollout output {fut.shape} (want "
                                 f"{want_shape}), finite "
                                 f"{np.isfinite(fut).all()}")
        if counts != want_counts:
            raise AssertionError(f"{what}{cache_dtype} launches {counts} != "
                                 f"{want_counts}")
        for name, n in counts.items():
            launches[name] += n
        log(f"{what}rollout {cache_dtype}: {n_slots} scenes x "
            f"{engine.ticks} ticks in {secs:.3f} s = "
            f"{engine.ticks / secs:.1f} ticks/s, {n_slots / secs:.1f} "
            f"scenes/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({resident / 2**30:.2f} GiB resident before), launches "
            f"{counts}")
        if stats is not None:
            stats[cache_dtype] = (engine.ticks / secs,
                                  torch.cuda.max_memory_allocated() / 2**30)
        if cache_dtype == cache_dtypes[0]:
            first_secs = secs
    # where the rollout's time goes: device time by kernel (torch.profiler)
    # against the unprofiled wall time of the same run
    engine = RolloutEngine(model, scen, num_slots=n_slots,
                           cache_dtype=cache_dtypes[0])
    device_profile(lambda: engine.run(scenes, t_hist=t_hist, n_samples=1,
                                      seed=0),
                   first_secs, ("prefill or tick", lambda: 1 + engine.ticks),
                   f"{what}{cache_dtypes[0]} rollout")
    return engine


def train(model, scen, per_step, launches, what, mixed_grads,
          grad_rel_tol=TRAIN_GRAD_REL_TOL):
    """Phase 5's training of ``model``: 32 freeform scenes a batch through
    ShardedIterator, bc_optimizer(3e-3, 22), 2 warm-up and 20 timed steps;
    the loss finite and falling and the launches exactly ``per_step`` a
    step (added to ``launches``); the gradients of one batch (with
    ``mixed_grads`` also of one batch of all seven families) through the
    kernels against those through the plain versions; open-loop metrics on
    2 holdout batches finite; the device profile of one step. Returns
    (one more train step as a function, the open-loop metrics, the batch
    iterator, which the caller closes, and the timed loop's steps/s)."""
    import numpy as np
    import torch
    from repro_torch.data import ShardedIterator
    from repro_torch.kernels import cuda
    from repro_torch.nn.agent_sim import AgentSimModel, action_nll
    from repro_torch.training.data import (holdout_batches, make_batch_fn,
                                           make_sim_batch)
    from repro_torch.training.steps import (bc_optimizer, loss_summary,
                                            make_sim_train_step,
                                            open_loop_metrics)
    dev = model.device
    data = ShardedIterator(make_batch_fn(scen, FAMILIES),
                           batch_size=TRAIN_BATCH, seed=0)
    opt = bc_optimizer(lr=TRAIN_LR, steps=TRAIN_WARMUP + TRAIN_STEPS)
    train_step = make_sim_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        state, metrics = train_step(state, next(data))
    torch.cuda.synchronize()
    log(f"{what}train warm-up: {TRAIN_WARMUP} steps in "
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
    want_counts = {k_: n * TRAIN_STEPS for k_, n in per_step.items()}
    if counts != want_counts:
        raise AssertionError(f"{what}train launches {counts} != "
                             f"{want_counts}")
    for name, n in counts.items():
        launches[name] += n
    summary = loss_summary(losses)
    if not (np.isfinite(losses).all()
            and summary["loss_last"] < summary["loss_first"]):
        raise AssertionError(f"{what}train loss did not fall: {losses}")
    log(f"{what}train: {TRAIN_STEPS} steps x {TRAIN_BATCH} scenes in "
        f"{train_secs:.3f} s = {TRAIN_STEPS / train_secs:.2f} steps/s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({resident / 2**30:.2f} GiB of it resident before the loop: "
        f"weights, optimizer state, earlier phases' tensors), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({summary}), grad_norm "
        f"{float(metrics['grad_norm']):.3f}, accuracy "
        f"{float(metrics['accuracy']):.3f}, launches {counts}")
    t0 = time.perf_counter()
    host_batch = next(data)
    log(f"{what}train data: one {TRAIN_BATCH}-scene batch from the iterator "
        f"in {time.perf_counter() - t0:.3f} s of host time")

    # gradients of one batch: the kernels against the plain versions
    pmodel = AgentSimModel(dataclasses.replace(model.cfg, attn_impl="plain"),
                           device=dev)
    pmodel.load_state_dict(model.state_dict())
    pmodel.requires_grad_(True)
    grad_batches = [("freeform", host_batch)]
    if mixed_grads:
        grad_batches.append(("seven families", make_sim_batch(
            0, 0, TRAIN_BATCH, scen, families=None)))
    for bname, host_b in grad_batches:
        gb = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in host_b.items()}
        grads = []
        for m_ in (model, pmodel):
            loss = action_nll(m_(gb), gb["actions"], gb["agent_valid"])
            names, leaves = zip(*m_.named_parameters())
            grads.append(dict(zip(names, torch.autograd.grad(loss, leaves))))
        worst, _ = grads_close_or_raise(f"{what}train ({bname})", grads[0],
                                        grads[1], grad_rel_tol)
        log(f"{what}train step gradients, kernels vs plain versions, {bname} "
            f"batch ({int(gb['agent_valid'][:, 0].sum())} of "
            f"{TRAIN_BATCH * scen.num_agents} agents valid): worst max abs "
            f"err / tensor max {worst:.3e} over {len(grads[1])} tensors")
    del pmodel, grads
    ol = open_loop_metrics(model, holdout_batches(scen, TRAIN_BATCH, 2,
                                                  families=FAMILIES))
    if not all(math.isfinite(x) for x in ol.values()):
        raise AssertionError(f"{what}open-loop metrics not finite: {ol}")
    log(f"{what}open-loop metrics on 2 holdout batches: {ol}")

    def one_step():
        nonlocal state
        state, _ = train_step(state, host_batch)
    device_profile(one_step, train_secs / TRAIN_STEPS, ("train step", lambda: 1),
                   f"{what}one train step")
    return one_step, ol, data, TRAIN_STEPS / train_secs


def check_tables(tables, eval_scenes, n_scenes, what):
    """An evaluation's table: a row for each family and "overall", each
    with its scene count, every rate finite (off-road where the family has
    a vehicle on a lane graph) and a kinematic infeasibility rate of 0."""
    from repro_torch import scenarios
    fams = scenarios.registry.names()
    road_vehicles = {f: any(
        s.lane_graph is not None and bool(
            ((s.tensors["agent_type"] == scenarios.AGENT_TYPE["vehicle"])
             & s.tensors["agent_valid"][0]).any())
        for s in eval_scenes if s.family == f) for f in fams}
    if sorted(tables) != sorted(fams + ["overall"]):
        raise AssertionError(f"{what}evaluation rows {sorted(tables)}")
    for fam, row in tables.items():
        want_n = n_scenes * (len(fams) if fam == "overall" else 1)
        finite = ["min_ade", "miss_rate", "collision_rate",
                  "kinematic_infeasibility_rate"]
        if fam == "overall" or road_vehicles[fam]:
            finite.append("offroad_rate")
        bad = [k_ for k_ in finite if not math.isfinite(row[k_])]
        if (bad or row["kinematic_infeasibility_rate"] != 0.0
                or row["n_scenes"] != want_n):
            raise AssertionError(f"{what}evaluation {fam}: not finite {bad}, "
                                 f"row {row}")


def action_shift(model, scene, z):
    """The largest change of an action probability of a valid agent at the
    scene's last step under a global re-pose of every pose by z (a full
    forward each way)."""
    import torch
    from repro_torch.core import se2
    batch = scene_batch([scene], model.device)
    moved = dict(batch)
    zt = torch.tensor(z, device=model.device)
    for key in ("map_pose", "agent_pose"):
        moved[key] = se2.compose(zt, batch[key])
    with torch.no_grad():
        base, after = (torch.softmax(model(b)[:, -1], -1)
                       for b in (batch, moved))
    valid = batch["agent_valid"][:, -1]
    return float((after - base)[valid].abs().max())


def launches_in(fn):
    """Device launches (kernels and copies) of one ``fn()`` call, by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def peak_bytes(fn):
    """Device memory ``fn()`` holds at its peak above what was allocated
    before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def table1_phase(tmodel, se2_fourier_ol, scen, scenes, pairs, t_hist, s_max,
                 launches):
    """Phase 8: the other three Table-I arches at full width, each with
    seeded random weights: (a) the rollout, its checks against the
    reference forward and its plain-transform calls; (b) the train loop;
    (c) open-loop metrics and a small evaluation over the seven families
    (``tmodel``, phase 5's sim-se2-fourier, runs the same evaluation); (d)
    SE(2) invariance of the action probabilities; then (e) Algorithm 2
    through the flash forward against Algorithm 1, and the peak memory of
    each. Main-path launches join ``launches``."""
    import torch
    from repro_torch import configs, scenarios
    from repro_torch.core import attention
    from repro_torch.kernels import cuda
    from repro_torch.nn.agent_sim import AgentSimModel, build_sim_encoding
    from repro_torch.runtime import EvalConfig, evaluate_families
    dev = tmodel.device
    fams = scenarios.registry.names()
    eval_cfg = EvalConfig(t_hist=t_hist, n_samples=EVAL_SAMPLES, seed=0)
    eval_scenes = [scenarios.generate_scene(f, EVAL_SCENE_SEED, i, scen)
                   for f in fams for i in range(TABLE1_EVAL_SCENES)]
    num_layers = tmodel.cfg.num_layers
    per_rollout = num_layers * (1 + scen.num_steps - t_hist)
    ticks = scen.num_steps - t_hist
    eval_chunks = -(-len(eval_scenes) * EVAL_SAMPLES // EVAL_SLOTS[0])
    per_eval = eval_chunks * per_rollout

    def small_eval(model, want_counts, what):
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        tables = evaluate_families(model, scen, eval_cfg, families=None,
                                   n_scenes_per_family=TABLE1_EVAL_SCENES,
                                   scene_seed=EVAL_SCENE_SEED,
                                   num_slots=EVAL_SLOTS[0])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        if counts != want_counts:
            raise AssertionError(f"{what}evaluation launches {counts} != "
                                 f"{want_counts}")
        for name, n in counts.items():
            launches[name] += n
        check_tables(tables, eval_scenes, TABLE1_EVAL_SCENES, what)
        log(f"{what}evaluate_families: {len(fams)} families x "
            f"{TABLE1_EVAL_SCENES} scenes x {EVAL_SAMPLES} samples, "
            f"{EVAL_SLOTS[0]} slots, in {secs:.3f} s; rates finite, "
            f"kinematic infeasibility 0; launches {counts}")
        return tables

    rows, shifts = {}, {}
    for arch_name in TABLE1_ARCHS:
        arch = configs.get_sim_arch(arch_name)
        cfg, name = arch.agent_sim_config(), arch.encoding
        phase(f"8. Table-I arch {arch_name}")
        torch.cuda.empty_cache()
        model = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
        enc = model.blocks[0].attn.enc
        log(f"arch {arch_name}: d_model {cfg.d_model}, {cfg.num_layers} "
            f"layers, {cfg.num_heads} heads x {cfg.head_dim}, cache widths "
            f"{model.blocks[0].attn.cache_dims}, "
            f"{sum(p.numel() for p in model.parameters())} parameters")
        what = f"{arch_name} "
        # a. rollout
        check_against_reference(model, scen, pairs, t_hist, s_max)
        engine = rollouts(model, scen, scenes, t_hist,
                          {"flash_decode": per_rollout, "categorical": ticks},
                          launches, what)
        calls = plain_se2_calls(lambda: engine.run(scenes, t_hist=t_hist,
                                                   n_samples=1, seed=0))
        del engine
        if enc is not None:
            # a layer's plain transforms at the tick, as SimAttention calls
            # them: q and k (rope2d), also v and the output (se2_repr)
            x = torch.randn((N_SLOTS, cfg.num_heads, scen.num_agents,
                             cfg.head_dim), device=dev)
            p4 = torch.zeros((N_SLOTS, 1, scen.num_agents, enc.pose_dim),
                             device=dev)

            def transforms():
                enc.transform_q(x, p4)
                enc.transform_k(x, p4)
                if enc.transforms_values:
                    enc.transform_v(x, p4)
                    enc.untransform_out(x, p4)
            per_layer = launches_in(transforms)
            log(f"{what}plain transforms ({type(enc).__name__}): "
                f"{sum(calls.values())} calls into core/encodings.py a "
                f"rollout ({dict(calls)}); {per_layer} device launches a "
                f"layer of a tick, {per_layer * cfg.num_layers} a tick")
        elif calls:
            raise AssertionError(f"{what}rollout ran plain SE(2) ops: "
                                 f"{calls}")
        # b. training
        per_step = dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                                  "flash_attention_dkv"), cfg.num_layers)
        one_step, ol, data, _ = train(model, scen, per_step, launches,
                                      what, mixed_grads=False)
        calls = plain_se2_calls(one_step)
        data.close()
        log(f"{what}train step: {sum(calls.values())} calls into "
            f"core/encodings.py ({dict(calls)})")
        if enc is None and calls:
            raise AssertionError(f"{what}train step ran plain SE(2) ops")
        # c. scoring
        rows[name] = (ol, small_eval(model, {
            "flash_decode": per_eval, "categorical": eval_chunks * ticks},
            what)["overall"])
        # d. invariance of the action probabilities under a re-pose
        shifts[name] = action_shift(model, scenes[0], INVARIANCE_Z[name])
        log(f"{what}action probabilities under z = {INVARIANCE_Z[name]}: "
            f"max shift {shifts[name]:.3e}")
        if name == "absolute":
            if not shifts[name] > ABSOLUTE_MOVES:
                raise AssertionError(f"{what}did not move under a re-pose: "
                                     f"{shifts[name]:.3e}")
        elif not shifts[name] <= EXACT_INVARIANCE_BOUND:
            raise AssertionError(f"{what}moved {shifts[name]:.3e} under a "
                                 f"re-pose (bound {EXACT_INVARIANCE_BOUND})")
        del model, one_step
    phase("8. Table-I lines")
    rows["se2_fourier"] = (se2_fourier_ol, small_eval(tmodel, {
        "flash_decode": per_eval, "se2_project_q": per_eval,
        "se2_project_k": 2 * per_eval, "se2_project_q_t": per_eval,
        "categorical": eval_chunks * ticks}, "sim-se2-fourier ")["overall"])
    shifts["se2_fourier"] = action_shift(tmodel, scenes[0],
                                         INVARIANCE_Z["se2_fourier"])
    log(f"sim-se2-fourier action probabilities under z = "
        f"{INVARIANCE_Z['se2_fourier']}: max shift "
        f"{shifts['se2_fourier']:.3e} (not gated: the F = 12 truncation)")
    log(f"Table I after {TRAIN_WARMUP + TRAIN_STEPS} train steps from random "
        f"weights (printed, not compared: so few steps order nothing); "
        f"open loop on 2 holdout batches, closed loop over {len(fams)} "
        f"families x {TABLE1_EVAL_SCENES} scenes x {EVAL_SAMPLES} samples:")
    for name in ("absolute", "rope2d", "se2_repr", "se2_fourier"):
        ol, row = rows[name]
        log(f"  Table-I {name:12s} nll {ol['nll']:.4f} accuracy "
            f"{ol['accuracy']:.4f} minADE {row['min_ade']:.4f} miss "
            f"{row['miss_rate']:.4f} collision {row['collision_rate']:.4f} "
            f"off-road {row['offroad_rate']:.4f} | invariance shift "
            f"{shifts[name]:.3e}")

    # e. Algorithm 2 (through the flash forward) against Algorithm 1
    phase("8. Algorithm 1 against Algorithm 2")
    encs = {"rope2d": build_sim_encoding(
                configs.get_sim_arch("sim-rope2d").agent_sim_config()),
            "se2_repr": build_sim_encoding(
                configs.get_sim_arch("sim-se2-repr").agent_sim_config()),
            "se2_fourier": tmodel.blocks[0].attn.enc}
    gen = torch.Generator(device=dev).manual_seed(8)
    half_card = torch.cuda.get_device_properties(dev).total_memory / 2
    d = tmodel.cfg.head_dim

    def inputs(n, pose_dim):
        q, k, v = (torch.randn((1, ALG_HEADS, n, d), generator=gen,
                               device=dev) for _ in range(3))
        xy = (torch.rand((1, 1, n, 2), generator=gen, device=dev) * 2 - 1) \
            * ALG_EXTENT_M * tmodel.cfg.pos_scale
        th = (torch.rand((1, 1, n, 1), generator=gen, device=dev) * 2 - 1) \
            * math.pi
        pose = torch.cat([xy, th], -1)[..., :pose_dim]
        return q, k, v, pose

    for name, enc in encs.items():
        q, k, v, pose = inputs(ALG_N, enc.pose_dim)
        grid = pose.expand(1, ALG_HEADS, ALG_N, enc.pose_dim)
        cuda.reset_launches()
        with torch.no_grad():
            lin = attention.relative_attention_linear(
                enc, q, k, v, pose, pose, sdpa_fn=attention.flash_sdpa)
            torch.cuda.synchronize()
            if cuda.LAUNCHES != {"flash_attention_fwd": 1}:
                raise AssertionError(f"Algorithm 2 ({name}) launched "
                                     f"{cuda.LAUNCHES}")
            quad = attention.relative_attention_quadratic(enc, q, k, v, grid,
                                                          grid)
        err = close_or_raise(f"Algorithm 2 vs Algorithm 1 ({name})", lin,
                             quad, atol=ALG_TOL[name], rtol=ALG_TOL[name])
        log(f"Algorithm 2 through the flash forward vs Algorithm 1, {name}, "
            f"B 1, H {ALG_HEADS}, N = M = {ALG_N}, d {d}, c "
            f"{enc.expanded_dim}: max abs err {err:.3e} (tolerance "
            f"{ALG_TOL[name]})")
        prev_n, prev_peak = None, None
        for n in (ALG_N,) + ALG_MEM_N:
            q, k, v, pose = inputs(n, enc.pose_dim)
            grid = pose.expand(1, ALG_HEADS, n, enc.pose_dim)
            with torch.no_grad():
                lin_b = peak_bytes(lambda: attention.relative_attention_linear(
                    enc, q, k, v, pose, pose, sdpa_fn=attention.flash_sdpa))
                # the (N, M) tensors Algorithm 1 holds at once: phi(p_rel) k
                # (and v), the relative poses, the logits and the weights
                pair_floats = d * (2 if enc.transforms_values else 1) \
                    + enc.pose_dim + 2
                need = ALG_HEADS * n * n * pair_floats * 4
                if prev_peak is not None:
                    need = max(need, prev_peak * (n / prev_n) ** 2)
                if need > half_card:
                    quad_text = (f"quadratic not run: needs about "
                                 f"{need / 2**30:.1f} GiB, over half the "
                                 f"card ({half_card / 2**30:.1f} GiB)")
                else:
                    prev_n, prev_peak = n, peak_bytes(
                        lambda: attention.relative_attention_quadratic(
                            enc, q, k, v, grid, grid))
                    quad_text = (f"quadratic {prev_peak / 2**20:.1f} MiB "
                                 f"(estimated {need / 2**20:.1f})")
            if n in ALG_MEM_N:
                log(f"peak memory, {name}, N = M = {n}: linear "
                    f"{lin_b / 2**20:.1f} MiB, {quad_text}")
        del q, k, v, pose, grid, lin, quad


def _launcher_args(work, *extra):
    """``train_sim`` arguments for phase 9's sim-se2-fourier at full
    width, 32 scenes a step, seed 0."""
    from repro_torch.launch import train_sim
    return train_sim.build_parser().parse_args([
        "--arch", "sim-se2-fourier", "--batch", str(TRAIN_BATCH),
        "--lr", str(TRAIN_LR), "--seed", "0", "--ckpt-dir", str(work),
        "--holdout-batches", str(TRAINER_HOLDOUT),
        "--eval-scenes-per-family", str(TRAINER_EVAL_SCENES),
        "--eval-samples", str(TRAINER_EVAL_SAMPLES), *map(str, extra)])


def _model_state(trainer):
    """Copies of the parameters and the AdamW step and moments."""
    adam = trainer.opt_state[1]
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            adam["step"], {m: {k: v.clone() for k, v in adam[m].items()}
                           for m in ("mu", "nu")})


def _same_state(a, b) -> bool:
    import torch
    return a[1] == b[1] and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in ((a[0], b[0]), (a[2]["mu"], b[2]["mu"]),
                     (a[2]["nu"], b[2]["nu"])))


def trainer_phase(arch, per_step, bare_rate, launches):
    """Phase 9: the trainer stack at full width through the port's entry
    points. (a) ``train_sim.train_single`` (the launcher's path) over 32
    freeform scenes a step with checkpoints, periodic evaluation,
    telemetry and the flight recorder armed: status, falling loss, the
    final checkpoint bitwise, finite rates, exact launches, the trace's
    spans and its report; (b) a straight run against a restart halfway;
    (c) the NaN drill and one skipped step held bitwise; (d) a truncated
    newest checkpoint and the fallback past it; (e) ``run_comparison``
    over the four encodings. ``per_step`` is phase 5's launches a step,
    ``bare_rate`` its loop's steps/s; main-path launches join
    ``launches``."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.data import ShardedIterator
    from repro_torch.kernels import cuda
    from repro_torch.launch import obs_report, train_sim
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.scenarios import registry
    from repro_torch.training.comparison import (COMPARISON_ENCODINGS,
                                                 format_table,
                                                 run_comparison)
    from repro_torch.training.data import make_batch_fn
    from repro_torch.training.steps import bc_optimizer, make_sim_train_step
    cfg, scen = arch.agent_sim_config(), arch.scenario_config()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase9_", dir=ROOT / "build"))
    old_reg = obs.set_registry(obs.Registry())
    try:
        # a. the launcher's path ---------------------------------------------
        phase("9a. trainer: the launcher's path")
        reg = obs.get_registry()
        args = _launcher_args(
            work / "a", "--steps", TRAINER_STEPS,
            "--ckpt-every", TRAINER_CKPT_EVERY,
            "--eval-every", TRAINER_EVAL_EVERY,
            "--postmortem-out", work / "a.postmortem.json")
        # what the launches must be, from the code: each step phase 5's;
        # each eval one rollout chunk (prefill + ticks past the history)
        # over 7 x 2 x 2 lanes and the forward of the holdout batches
        t_hist = max(1, scen.num_steps // 2)
        lanes = (len(registry.names()) * TRAINER_EVAL_SCENES
                 * TRAINER_EVAL_SAMPLES)
        chunks = -(-lanes // min(32, lanes))
        decode = chunks * cfg.num_layers * (1 + scen.num_steps - t_hist)
        forward = dict.fromkeys(("se2_project_q", "se2_project_q_t",
                                 "flash_attention_fwd"), cfg.num_layers)
        forward["se2_project_k"] = 2 * cfg.num_layers
        per_eval = {"flash_decode": decode, "se2_project_q": decode,
                    "se2_project_k": 2 * decode, "se2_project_q_t": decode,
                    "categorical": chunks * (scen.num_steps - t_hist)}
        for k_, n in forward.items():
            per_eval[k_] = per_eval.get(k_, 0) + TRAINER_HOLDOUT * n
        evals = TRAINER_STEPS // TRAINER_EVAL_EVERY
        want = {k_: TRAINER_STEPS * n for k_, n in per_step.items()}
        for k_, n in per_eval.items():
            want[k_] = want.get(k_, 0) + evals * n
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        result = train_sim.train_single(args, families=FAMILIES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        if counts != want:
            raise AssertionError(f"trainer launches {counts} != {want}")
        for name, n in counts.items():
            launches[name] += n
        trainer = result.pop("trainer")
        rates = {k_: v for k_, v in result.items()
                 if k_.startswith("closed_")}
        if not (result["status"] == "done"
                and result["steps"] == TRAINER_STEPS
                and result["loss_last"] < result["loss_first"]
                and all(math.isfinite(v) for v in rates.values())
                and math.isfinite(result["final_nll"])):
            raise AssertionError(f"trainer run unhealthy: {result}")
        train_sim.check_final_checkpoint(trainer)
        log(f"train_single: {TRAINER_STEPS} steps x {TRAIN_BATCH} freeform "
            f"scenes in {wall:.2f} s (ckpt every {TRAINER_CKPT_EVERY}, eval "
            f"every {TRAINER_EVAL_EVERY}: {evals} x {lanes} lanes + "
            f"{TRAINER_HOLDOUT} holdout batches); status done, loss "
            f"{result['loss_first']:.4f} -> {result['loss_last']:.4f}, "
            f"final checkpoint bitwise equal to the model, launches exact "
            f"{counts}")
        log(f"train_single final metrics: nll {result['final_nll']:.4f}, "
            f"accuracy {result['final_accuracy']:.4f}, " + ", ".join(
                f"{k_} {v:.4f}" for k_, v in rates.items()))
        spans = {}
        for ev in reg.events():
            if ev.get("ph") == "X":
                spans.setdefault(ev["name"], []).append(ev["dur"] / 1e6)
        # periodic saves and one final save of the last step
        want_spans = {"trainer.step": TRAINER_STEPS, "trainer.eval": evals,
                      "trainer.checkpoint":
                          TRAINER_STEPS // TRAINER_CKPT_EVERY + 1}
        got_spans = {k_: len(spans.get(k_, ())) for k_ in want_spans}
        if got_spans != want_spans:
            raise AssertionError(f"trace spans {got_spans} != {want_spans}")
        trace = obs.write_chrome_trace(reg, str(work / "a.trace.jsonl"))
        if obs_report.main([trace]) != 0:
            raise AssertionError("obs_report could not render the trace")
        step_s = spans["trainer.step"]
        steady = sorted(step_s)[len(step_s) // 2]
        log(f"trainer steps/s: median step span {steady * 1e3:.1f} ms = "
            f"{1 / steady:.2f} steps/s, mean over {len(step_s)} steps "
            f"{len(step_s) / sum(step_s):.2f} steps/s; phase 5's bare loop "
            f"{bare_rate:.2f} steps/s in this process")
        log("trainer.eval spans: " + ", ".join(
            f"{s_:.3f} s" for s_ in spans["trainer.eval"])
            + "; trainer.checkpoint spans (the host copy and CRC on the "
            "training thread): " + ", ".join(
                f"{s_:.3f} s" for s_ in spans["trainer.checkpoint"]))
        # one save split into its parts
        tree = trainer.checkpoint_tree()
        flat = ckpt_manager._flatten(tree)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = ckpt_manager._to_host(flat)
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for v in host.values():
            ckpt_manager._crc(v)
        crc_s = time.perf_counter() - t0
        extra = {"step": trainer.step, "data": trainer.data.state_dict()}
        t0 = time.perf_counter()
        trainer.ckpt.save(trainer.step + 1, tree, extra=extra)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer.ckpt.wait()
        write_s = time.perf_counter() - t0
        nbytes = sum(v.nbytes for v in host.values())
        log(f"one checkpoint save, {nbytes / 1e6:.1f} MB in {len(host)} "
            f"arrays: host copy {copy_s:.3f} s and CRC32 {crc_s:.3f} s on "
            f"the training thread (save() returned in {save_s:.3f} s), npz "
            f"write {write_s:.3f} s on the background thread")
        del trainer, tree, flat, host
        torch.cuda.empty_cache()

        # b. restart -------------------------------------------------------
        phase("9b. trainer: restart")

        def make(ckpt_dir, total, registry=None):
            model = AgentSimModel(cfg,
                                  generator=torch.Generator().manual_seed(0))
            opt = bc_optimizer(TRAIN_LR, RESTART_STEPS)
            data = ShardedIterator(make_batch_fn(scen, FAMILIES),
                                   batch_size=TRAIN_BATCH, seed=0)
            return Trainer(make_sim_train_step(model, opt), model,
                           opt.init(dict(model.named_parameters())), data,
                           str(ckpt_dir), TrainerConfig(
                               total_steps=total, ckpt_every=RESTART_STEPS // 2,
                               log_every=RESTART_STEPS),
                           registry=registry)

        straight = make(work / "b_straight", RESTART_STEPS)
        straight.run()
        straight.data.close()
        want_state = _model_state(straight)
        want_hist = list(straight.history)
        del straight
        first = make(work / "b_restart", RESTART_STEPS // 2)
        first.run()
        first.data.close()
        del first
        second = make(work / "b_restart", RESTART_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not second.restore_if_available():
            raise AssertionError("restart found no checkpoint")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if second.data.cursor != RESTART_STEPS // 2:
            raise AssertionError(f"restored data cursor "
                                 f"{second.data.cursor}")
        second.run()
        second.data.close()
        got_state = _model_state(second)
        np.testing.assert_allclose(second.history,
                                   want_hist[RESTART_STEPS // 2:],
                                   rtol=RESTART_LOSS_RTOL)
        worst = max(float((got_state[0][k_] - v).abs().max())
                    for k_, v in want_state[0].items())
        if not worst <= RESTART_PARAM_ATOL:
            raise AssertionError(f"restart params differ by {worst:.3e}")
        bitwise = (second.history == want_hist[RESTART_STEPS // 2:]
                   and _same_state(got_state, want_state))
        log(f"restart: {RESTART_STEPS // 2} + {RESTART_STEPS // 2} steps "
            f"against {RESTART_STEPS} straight: data cursor "
            f"{RESTART_STEPS // 2} after restore ({restore_s:.3f} s), loss "
            f"history within rtol {RESTART_LOSS_RTOL}, params max abs diff "
            f"{worst:.3e}; bitwise equal (history, params, AdamW moments): "
            f"{bitwise}")
        del second, got_state, want_state

        # c. the NaN drill ---------------------------------------------------
        phase("9c. trainer: the NaN drill")
        bundle = work / "c.postmortem.json"
        args = _launcher_args(work / "c", "--steps", TRAINER_STEPS,
                              "--inject-nan-at", NAN_AT,
                              "--postmortem-out", bundle)
        try:
            train_sim.train_single(args, families=FAMILIES)
        except FloatingPointError as e:
            log(f"NaN drill: FloatingPointError: {e}")
        else:
            raise AssertionError("the NaN drill did not halt")
        sub = next((work / "c").iterdir())
        _, extra = CheckpointManager(str(sub)).restore(fallback=True)
        if extra.get("halt_reason") != "nan" or \
                extra["step"] != NAN_AT + MAX_NANS - 1:
            raise AssertionError(f"halt checkpoint extra {extra}")
        fresh = make(sub, TRAINER_STEPS)
        try:
            fresh.restore_if_available()
        except RuntimeError as e:
            log(f"restore without force refused: {str(e)[:80]}...")
        else:
            raise AssertionError("a halt checkpoint restored without force")
        if not (fresh.restore_if_available(force=True)
                and fresh.step == NAN_AT + MAX_NANS - 1):
            raise AssertionError("forced restore failed")
        fresh.data.close()
        del fresh
        if obs_report.main(["--postmortem", str(bundle)]) != 0:
            raise AssertionError("obs_report could not render the bundle")
        # one skipped step on the card: state bitwise as before it
        tr = make(work / "c_skip", 3)
        inner, seen = tr.step_fn, {}

        class NaNOnce:
            update = inner.update

            @staticmethod
            def grads(batch):
                g, m = inner.grads(batch)
                if not seen:
                    seen["before"] = _model_state(tr)
                    return g, dict(m, loss=float("nan"))
                if "after" not in seen:
                    seen["after"] = _model_state(tr)
                return g, m

        tr.step_fn = NaNOnce
        out = tr.run()
        tr.data.close()
        if not (out["nan_skipped"] == 1
                and _same_state(seen["after"], seen["before"])):
            raise AssertionError("a skipped step changed the parameters or "
                                 "the optimizer state")
        log("NaN drill: halt checkpoint tagged 'nan' at step "
            f"{extra['step']}, restore refused without force and taken "
            "with it, the postmortem bundle rendered; a skipped step left "
            "parameters and AdamW state bitwise unchanged")
        del tr, seen

        # d. corruption ----------------------------------------------------
        phase("9d. trainer: a truncated checkpoint")
        straight_dir = work / "b_straight"
        newest = max(straight_dir.glob("step_*"))
        npz = newest / "arrays.npz"
        with open(npz, "r+b") as f:
            f.truncate(npz.stat().st_size // 2)
        fallback_reg = obs.Registry()
        fresh = make(straight_dir, RESTART_STEPS, registry=fallback_reg)
        if not fresh.restore_if_available():
            raise AssertionError("no checkpoint restored past the truncated "
                                 "one")
        fresh.data.close()
        skipped = fresh.ckpt.last_restore_report["skipped"]
        n_fallback = fallback_reg.counter("trainer.ckpt_fallback").value
        if fresh.step != RESTART_STEPS // 2 or n_fallback != 1:
            raise AssertionError(f"fallback to step {fresh.step}, counter "
                                 f"{n_fallback}")
        log(f"truncated {newest.name}/arrays.npz: restored step "
            f"{fresh.step}, trainer.ckpt_fallback {n_fallback:g}, skipped "
            f"{skipped}")
        del fresh
        torch.cuda.empty_cache()

        # e. the comparison ------------------------------------------------
        phase("9e. trainer: the Table-I comparison")
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        rows = run_comparison(
            arch, COMPARISON_ENCODINGS, steps=COMPARE_STEPS,
            batch=TRAIN_BATCH, lr=TRAIN_LR, seed=0,
            holdout_n=TRAINER_HOLDOUT,
            n_scenes_per_family=TRAINER_EVAL_SCENES,
            eval_samples=TRAINER_EVAL_SAMPLES, ckpt_root=str(work / "e"))
        torch.cuda.synchronize()
        for name, n in cuda.LAUNCHES.items():
            launches[name] += n
        for enc in COMPARISON_ENCODINGS:
            row = rows[enc]
            if not (row["status"] == "done"
                    and math.isfinite(row["open_loop_nll"])
                    and math.isfinite(row["closed_loop_min_ade"])
                    and row["loss_last"] < row["loss_first"]):
                raise AssertionError(f"comparison {enc}: {row}")
        log(f"run_comparison: {len(COMPARISON_ENCODINGS)} encodings x "
            f"{COMPARE_STEPS} steps x {TRAIN_BATCH} scenes of all seven "
            f"families, evaluation 7 x {TRAINER_EVAL_SCENES} x "
            f"{TRAINER_EVAL_SAMPLES}, in {time.perf_counter() - t0:.1f} s; "
            f"every row done, NLL and minADE finite, loss falling; "
            f"launches {dict(cuda.LAUNCHES)}; train seconds " + ", ".join(
                f"{e} {rows[e]['train_s']:.1f}" for e in COMPARISON_ENCODINGS))
        log(format_table(rows))
        log(f"(one seed and {COMPARE_STEPS} steps decide no ordering of the "
            f"encodings)")
    finally:
        obs.set_registry(old_reg)
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the continuous-batching SimServer
# ---------------------------------------------------------------------------

# the CUDA runtime calls on which the host waits for the card
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def scribble_stale_rows(cache, cursors, seed):
    """Every row at or past each slot's cursor of a server's stacked cache
    overwritten in place with garbage: huge floats, a quarter NaN (scales
    included), full-range int8, and times and segment ids of 1 (a
    *valid-looking* id); a torch copy of tests/serving_utils.py's."""
    import torch
    dev = cache["seg"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = cache["seg"].shape[1]
    cur = torch.as_tensor(cursors, device=dev)
    stale = torch.arange(s, device=dev)[None, :] >= cur[:, None]   # (B, S)
    for key, x in cache.items():
        if key == "cursor":
            continue
        mask = {5: stale[None, :, None, :, None], 4: stale[None, :, None, :],
                2: stale}[x.ndim]
        if x.dtype == torch.int8:
            junk = torch.randint(-128, 128, x.shape, generator=gen,
                                 device=dev, dtype=torch.int8)
        elif not x.dtype.is_floating_point:
            junk = torch.ones_like(x)
        else:
            junk = torch.randn(x.shape, generator=gen, device=dev) * 100.0
            junk = torch.where(torch.rand(x.shape, generator=gen,
                                          device=dev) < 0.25,
                               float("nan"), junk).to(x.dtype)
        x.copy_(torch.where(mask, junk, x))


def bitwise_or_raise(what, got, want):
    import numpy as np
    if not np.array_equal(got, want):
        diff = np.abs(np.asarray(got, np.float64) - np.asarray(want,
                                                               np.float64))
        raise AssertionError(f"{what}: {int((diff != 0).sum())} of "
                             f"{diff.size} elements differ (max |diff| "
                             f"{diff.max():.3e})")


def tick_profile(srv, run):
    """``run()`` under torch.profiler with each ``srv.tick()`` wrapped in a
    range: per tick (idle polls included) the host waits (HOST_WAITS calls)
    inside it, the waits outside any tick (the final flush), and the
    device time, kernel launches and host-to-device copies of the whole
    run. Raises when the profiler recorded no CUDA runtime call, which
    would leave the waits uncounted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    tick = srv.tick

    def ranged_tick():
        with record_function("chip_smoke.server_tick"):
            return tick()
    srv.tick = ranged_tick
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        del srv.tick
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "chip_smoke.server_tick")
    waits = [e for e in events if e.name in HOST_WAITS]
    if not any(e.name == "cudaLaunchKernel" for e in events):
        raise AssertionError("the profiler recorded no CUDA runtime call: "
                             "host waits not counted")
    per_tick = [sum(1 for w in waits if t0 <= w.time_range.start <= t1)
                for t0, t1 in spans]
    # device time and counts by kernel name, as device_profile reads them
    # the GPU spans of record_function ranges (the server's own and the
    # tick's above) repeat their kernels' time: kernels only
    device = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(("sim_server.",
                                               "chip_smoke."))),
                    key=lambda e: -e.self_device_time_total)
    return {
        "per_tick": per_tick, "outside": len(waits) - sum(per_tick),
        "top": [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in device[:8]],
        "device_ms": sum(e.self_device_time_total for e in device) / 1e3,
        "launches": sum(e.count for e in device
                        if not e.key.startswith(("Memcpy", "Memset"))),
        "htod": sum(e.count for e in device
                    if e.key.startswith("Memcpy HtoD")),
        "dtoh": sum(e.count for e in device
                    if e.key.startswith("Memcpy DtoH")),
    }


def server_requests(scenes):
    """The Poisson drive's lanes: every scene x SERVE_SAMPLES samples,
    keyed like RolloutEngine's lane (scene, sample) at seed 0."""
    from repro_torch.runtime import SceneRequest
    return [SceneRequest(uid=i * SERVE_SAMPLES + k, tensors=s,
                         t_hist=T_HIST, t_total=SERVE_T_TOTAL, seed=0,
                         scene_id=i, sample_id=k)
            for i, s in enumerate(scenes) for k in range(SERVE_SAMPLES)]


def server_phase(model, scen, s_max, launches, max_err):
    """Phase 10: the continuous-batching SimServer at full width (phase
    4's seed-0 sim-se2-fourier, 64 slots, max_len s_max). The decode and
    se2 kernels at the server's new shapes against their plain versions,
    then (a) the Poisson drive, (b) the gauntlet, (c) serve_scenes
    against the engine, (d) quarantine and (e) the launchers. The Poisson
    drives' launches join ``launches``; kernel errors join ``max_err``."""
    import os
    import subprocess
    import numpy as np
    import torch
    from repro_torch import chaos, obs, scenarios
    from repro_torch.kernels import cuda, ops
    from repro_torch.launch.obs_report import render_postmortem
    from repro_torch.runtime import (RolloutEngine, SceneRequest, SimServer,
                                     poisson_drive, serve_scenes)
    cfg = model.cfg
    dev = model.device
    enc = model.blocks[0].attn.enc
    c, m, a = enc.expanded_dim, scen.num_map, scen.num_agents
    layers = cfg.num_layers
    per_call = {"flash_decode": layers, "se2_project_q": layers,
                "se2_project_k": 2 * layers, "se2_project_q_t": layers}

    # the kernels at the server's shapes -----------------------------------
    phase("10. server: kernels at the admission's and the tick's shapes")
    gen = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(10)
    # admission: one scene's M map rows, all at time 0, against themselves
    # on the M-row sub-cache; the tick: every slot at its own cursor and
    # step, retired slots past max_len (kv_length clamps to S)
    tick_kvl = np.concatenate([[a, m + a, s_max, s_max + a],
                               rng.integers(m + a, s_max + a + 1,
                                            SERVE_SLOTS - 4)])
    for cache_dtype in ("float32", "int8"):
        for what, kw in (
                ("admission", dict(b=1, s=m, sq=m, cursors=[m],
                                   prefill=True)),
                ("server tick", dict(b=SERVE_SLOTS, s=s_max, sq=a,
                                     cursors=tick_kvl))):
            case = decode_case(gen, dev, cache_dtype, layers=layers,
                               h=cfg.num_heads, c=c, num_map=m,
                               num_agents=a, **kw)
            if what == "server tick":
                case["q_times"] = torch.as_tensor(
                    rng.integers(1, scen.num_steps + 1, (SERVE_SLOTS, 1)),
                    dtype=torch.int32, device=dev).expand(-1, a).contiguous()
            q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
            want = ops.decode_attention(q, k, v, impl="plain", layer=layers - 1,
                                        **case)
            got = ops.decode_attention(q, k, v, impl="flash_decode",
                                       layer=layers - 1, **case)
            again = ops.decode_attention(q, k, v, impl="flash_decode",
                                         layer=layers - 1, **case)
            torch.cuda.synchronize()
            err = close_or_raise(f"flash_decode {what} {cache_dtype}", got,
                                 want, **DECODE_TOL[cache_dtype])
            if not torch.equal(got, again):
                raise AssertionError(f"flash_decode {what} {cache_dtype}: "
                                     f"not bitwise repeatable")
            max_err["flash_decode"] = max(max_err["flash_decode"], err)
            log(f"flash_decode {what} ({tuple(q.shape)} against "
                f"{k.shape[3]} rows, {cache_dtype}): max abs err "
                f"{err:.3e}, bitwise repeatable")
    errs = {}
    for name in SE2_MODES:
        kernel, plain, mode, transposed = se2_mode(name)
        x, pose = se2_case(gen, dev, 1, cfg.num_heads, m,
                           c if transposed else cfg.head_dim, cfg.pos_scale)
        got, again = kernel(x, pose, enc, mode), kernel(x, pose, enc, mode)
        want = plain(x, pose, enc, mode)
        torch.cuda.synchronize()
        errs[name] = close_or_raise(f"{name} admission", got, want,
                                    **SE2_TOL)
        if not torch.equal(got, again):
            raise AssertionError(f"{name} admission: not bitwise "
                                 f"repeatable")
        max_err[name] = max(max_err[name], errs[name])
    log(f"se2 at the admission's 1 x {cfg.num_heads} x {m} rows: bitwise "
        f"repeatable; max abs err " + ", ".join(
            f"{k_[12:]} {e:.3e}" for k_, e in errs.items()))

    # a. the Poisson drive -----------------------------------------------------
    phase("10a. server: Poisson drive")
    t0 = time.perf_counter()
    scenes = scenarios.registry.generate_mixed(SERVE_SEED, 0, SERVE_SCENES,
                                               scen)
    gen_s = time.perf_counter() - t0
    lanes = SERVE_SCENES * SERVE_SAMPLES

    def server(cache_dtype="float32", num_slots=SERVE_SLOTS, drain_lag=1,
               registry=obs.NULL):
        return SimServer(model, scen, num_slots=num_slots, max_len=s_max,
                         cache_dtype=cache_dtype, drain_lag=drain_lag,
                         device=dev, registry=registry)

    def drive(srv, reqs):
        return poisson_drive(srv, reqs, rate=SERVE_RATE, seed=0,
                             warmup_ticks=SERVE_WARMUP_TICKS)

    # warm-up: cuBLAS handles, the pinned-memory pool, both dtypes' paths
    for cache_dtype in ("float32", "int8"):
        drive(server(cache_dtype), server_requests(scenes[:8]))
    log(f"scene generation: {SERVE_SCENES} mixed scenes in {gen_s:.3f} s "
        f"of host time")
    walls = {}
    for cache_dtype in ("float32", "int8"):
        reg = obs.Registry()
        srv = server(cache_dtype, registry=reg)
        reqs = server_requests(scenes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        cuda.reset_launches()
        t0 = time.perf_counter()
        out = drive(srv, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        calls = srv.ticks + srv.admitted
        want = {k_: calls * n for k_, n in per_call.items()}
        want["categorical"] = srv.ticks          # each tick samples once
        if counts != want:
            raise AssertionError(f"server {cache_dtype} launches {counts} != "
                                 f"{want} ({srv.ticks} ticks + "
                                 f"{srv.admitted} admissions)")
        for name, n in counts.items():
            launches[name] += n
        done = srv.done
        bad = [u for u in range(lanes) if u not in done
               or done[u].status != "ok"
               or not np.isfinite(done[u].future).all()]
        if bad or len(done) != lanes:
            raise AssertionError(f"server {cache_dtype}: lanes {bad[:8]} "
                                 f"missing, failed or non-finite")
        hist, stats = out["latency"], srv.stats()
        qwait = reg.histogram("sim_server.queue_wait.seconds")
        first = reg.histogram("sim_server.first_action.seconds")
        walls[cache_dtype] = wall
        log(f"server {cache_dtype}: {lanes} lanes ({SERVE_SCENES} scenes x "
            f"{SERVE_SAMPLES}) at {SERVE_RATE} arrivals a tick over "
            f"{SERVE_SLOTS} slots: {srv.ticks} working ticks and "
            f"{srv.admitted} admissions in {wall:.3f} s = "
            f"{lanes / wall:.1f} lanes/s ({SERVE_SCENES / wall:.1f} scenes/s) "
            f"wall; sustained {lanes / hist.sum:.1f} lanes/s over "
            f"{hist.count} ticks after {SERVE_WARMUP_TICKS}; tick p50 "
            f"{hist.percentile(50) * 1e3:.2f} ms, p99 "
            f"{hist.percentile(99) * 1e3:.2f} ms; queue wait p50 "
            f"{qwait.percentile(50) * 1e3:.1f} ms, first action p50 "
            f"{first.percentile(50) * 1e3:.1f} ms; slab "
            f"{stats['slab_mib']:.1f} MiB, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({resident / 2**30:.2f} GiB resident before); launches exact "
            f"{counts}")
    # drain_lag 1 against 0 in one process, over the same lanes (the first
    # SERVE_LAG_SCENES scenes), in turns (1, 0, 0, 1): the host's pace
    # drifts within a run
    done_by_lag = {}
    lag_lanes = SERVE_LAG_SCENES * SERVE_SAMPLES
    for lag in (1, 0, 0, 1):
        srv = server(drain_lag=lag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drive(srv, server_requests(scenes[:SERVE_LAG_SCENES]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = out["latency"]
        done_by_lag[lag] = srv.done
        log(f"server float32 drain_lag={lag}, {lag_lanes} lanes: "
            f"{wall:.3f} s, {lag_lanes / wall:.1f} lanes/s wall, sustained "
            f"{lag_lanes / hist.sum:.1f} lanes/s, tick p50 "
            f"{hist.percentile(50) * 1e3:.2f} ms, p99 "
            f"{hist.percentile(99) * 1e3:.2f} ms")
    for uid, res in done_by_lag[0].items():
        bitwise_or_raise(f"drain_lag 0 vs 1, lane {uid}", res.future,
                         done_by_lag[1][uid].future)
    # where the time goes, and the host waits in each tick, over the first
    # SERVE_PROFILE_SCENES scenes (the profiler's own cost grows with the
    # events it keeps): the unprofiled drive, then the same under the
    # profiler
    few = scenes[:SERVE_PROFILE_SCENES]
    srv = server()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive(srv, server_requests(few))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    srv = server()
    prof = tick_profile(srv, lambda: drive(srv, server_requests(few)))
    n_ticks, waits = srv.ticks, prof["per_tick"]
    log(f"profile server float32 drain_lag=1, {len(few) * SERVE_SAMPLES} "
        f"lanes: {n_ticks} working ticks and {srv.admitted} admissions; per "
        f"working tick {prof['launches'] / n_ticks:.1f} device launches, "
        f"{prof['htod'] / n_ticks:.2f} host-to-device and "
        f"{prof['dtoh'] / n_ticks:.2f} device-to-host copies; host waits in "
        f"a tick: max {max(waits)}, total {sum(waits)} over {len(waits)} "
        f"tick calls (idle polls included), {prof['outside']} outside the "
        f"ticks (the flush, the final synchronize); {prof['device_ms']:.2f} "
        f"ms of kernels against the unprofiled {wall * 1e3:.1f} ms: busy "
        f"{prof['device_ms'] / (wall * 1e3):.1%}")
    for ms, count, key in prof["top"]:
        log(f"  {ms:9.3f} ms {count:6d} x {key[:90]}")
    if max(waits) > 1:
        raise AssertionError(f"drain_lag=1: a tick waited on the host "
                             f"{max(waits)} times")
    srv = server()
    calls = plain_se2_calls(lambda: drive(srv, server_requests(scenes[:8])))
    if calls:
        raise AssertionError(f"the server ran plain SE(2) ops: {calls}")
    log("server: no call into core/encodings.py or core/fourier.py that "
        "runs a tensor op")

    # b. the gauntlet -----------------------------------------------------------
    phase("10b. server: the gauntlet")
    victim = scenarios.generate_scene("signalized_intersection", 40, 0, scen)
    neighbours = scenarios.registry.generate_mixed(8, 200,
                                                   GAUNTLET_SLOTS - 1, scen)
    evictees = scenarios.registry.generate_mixed(7, 100, GAUNTLET_SLOTS,
                                                 scen)
    # the victim lands in slot `seat` behind that many neighbours; alone,
    # it runs in slot 0
    seat = GAUNTLET_SLOTS // 2

    def victim_request():
        return SceneRequest(uid=0, tensors=victim, t_hist=T_HIST, seed=9,
                            scene_id=0)
    for cache_dtype in ("float32", "int8"):
        solo = server(cache_dtype, num_slots=GAUNTLET_SLOTS)
        solo.submit(victim_request())
        solo.run_until_drained()
        srv = server(cache_dtype, num_slots=GAUNTLET_SLOTS)
        for i, scene in enumerate(evictees):
            srv.submit(SceneRequest(uid=100 + i, tensors=scene, t_hist=4,
                                    t_total=T_HIST + 4, seed=1,
                                    scene_id=50 + i))
        srv.tick()                                # every slot mid-prefill
        if not srv.evict(101):
            raise AssertionError("mid-prefill eviction found no lane")
        while any(s.req for s in srv.slots):      # the rest retire
            srv.tick()
        srv.flush()
        scribble_stale_rows(srv.cache, [0] * GAUNTLET_SLOTS, seed=3)
        arrivals = [SceneRequest(uid=1 + i, tensors=scene, t_hist=2 + i % 4,
                                 seed=2, scene_id=77 + i)
                    for i, scene in enumerate(neighbours)]
        arrivals.insert(seat, victim_request())
        for req in arrivals:
            srv.submit(req)
        srv.tick()
        if srv.slots[seat].req.uid != 0:
            raise AssertionError(f"the victim is not in slot {seat}")
        srv.run_until_drained()
        want = [0, *range(1, GAUNTLET_SLOTS),
                *(100 + i for i in range(GAUNTLET_SLOTS) if i != 1)]
        if sorted(srv.done) != sorted(want):
            raise AssertionError(f"gauntlet lanes {sorted(srv.done)}")
        bitwise_or_raise(f"gauntlet victim actions ({cache_dtype})",
                         srv.done[0].actions, solo.done[0].actions)
        bitwise_or_raise(f"gauntlet victim poses ({cache_dtype})",
                         srv.done[0].future, solo.done[0].future)
        log(f"gauntlet {cache_dtype}: {GAUNTLET_SLOTS} slots, an eviction "
            f"mid-prefill, {GAUNTLET_SLOTS - 1} lanes retired, every stale "
            f"row scribbled with NaN garbage, the victim in slot {seat} "
            f"beside {GAUNTLET_SLOTS - 1} neighbours: actions and poses "
            f"bitwise equal to the victim alone in slot 0 of a fresh "
            f"{GAUNTLET_SLOTS}-slot server")

    # c. serve_scenes against the engine -----------------------------------------
    phase("10c. server: serve_scenes against RolloutEngine")
    free = [scenarios.generate_scene("freeform", 0, i, scen)
            for i in range(SERVE_SLOTS)]
    engine = RolloutEngine(model, scen, num_slots=SERVE_SLOTS, device=dev)
    fut_e = engine.run(free, t_hist=T_HIST, n_samples=1, seed=0)
    hist_batch = {k_: (v_[:, :T_HIST] if k_.startswith("agent") else v_)
                  for k_, v_ in scene_batch(free, dev).items()}
    with torch.no_grad():
        eng_logits = model.prefill(model.init_cache(SERVE_SLOTS, s_max),
                                   hist_batch)[0][:, -1]
    srv = server()
    captured = {}
    tick = srv.tick

    def capturing_tick():
        ticked = tick()
        if srv.ticks == T_HIST and "logits" not in captured:
            captured["logits"] = srv.state["logits"].clone()
        return ticked
    srv.tick = capturing_tick
    fut_s = serve_scenes(srv, free, t_hist=T_HIST, n_samples=1, seed=0)
    err = close_or_raise("server vs engine: logits after the history",
                         captured["logits"], eng_logits,
                         **MODEL_TOL["float32"])
    same = [np.array_equal(fut_s[i], fut_e[i]) for i in range(SERVE_SLOTS)]
    logits_same = torch.equal(captured["logits"], eng_logits)
    log(f"serve_scenes vs RolloutEngine.run, {SERVE_SLOTS} freeform scenes "
        f"through {SERVE_SLOTS} slots: logits after the teacher-forced "
        f"history within MODEL_TOL (max abs err {err:.3e}, bitwise equal "
        f"{logits_same}); futures bitwise equal in {sum(same)} of "
        f"{SERVE_SLOTS} lanes ({sum(same) / SERVE_SLOTS:.1%})")
    del engine

    # d. quarantine -----------------------------------------------------------------
    phase("10d. server: quarantine")
    q_scenes = scenarios.registry.generate_mixed(5, 0, QUARANTINE_LANES, scen)

    def serve(poison_tick=None):
        srv_ = server(num_slots=GAUNTLET_SLOTS)
        for i, scene in enumerate(q_scenes):
            srv_.submit(SceneRequest(uid=i, tensors=scene, t_hist=T_HIST,
                                     seed=11, scene_id=i))
        victim_uid, ticks = None, 0
        while srv_.queue or any(s.req for s in srv_.slots):
            if ticks == poison_tick:
                victim_uid = srv_.slots[0].req.uid
                chaos.poison_server_slot(srv_, 0)
            srv_.tick()
            ticks += 1
        srv_.flush()
        return srv_, victim_uid
    ref, _ = serve()
    srv, victim_uid = serve(poison_tick=T_HIST + 3)
    failed = {u: r.reason for u, r in srv.done.items() if r.status != "ok"}
    if failed != {victim_uid: "nonfinite_pose"} or srv.quarantined != 1:
        raise AssertionError(f"quarantine: failed lanes {failed}, "
                             f"quarantined {srv.quarantined}")
    for uid, res in srv.done.items():
        if uid != victim_uid:
            bitwise_or_raise(f"healthy lane {uid} poses", res.future,
                             ref.done[uid].future)
            bitwise_or_raise(f"healthy lane {uid} actions", res.actions,
                             ref.done[uid].actions)
    tenant = scenarios.generate_scene("highway", 123, 0, scen)

    def tenant_request():
        return SceneRequest(uid=99, tensors=tenant, t_hist=T_HIST, seed=21,
                            scene_id=0)
    srv.submit(tenant_request())
    srv.tick()
    if srv.slots[0].req.uid != 99:
        raise AssertionError("the tenant is not in the scrubbed slot 0")
    srv.run_until_drained()
    solo = server(num_slots=GAUNTLET_SLOTS)
    solo.submit(tenant_request())
    solo.run_until_drained()
    bitwise_or_raise("scrubbed slot's next tenant", srv.done[99].future,
                     solo.done[99].future)
    log(f"quarantine: slot 0 poisoned with NaN at tick {T_HIST + 3}; lane "
        f"{victim_uid} failed with nonfinite_pose, the counter at 1; "
        f"{len(srv.done) - 2} healthy lanes bitwise equal to the no-fault "
        f"run; the scrubbed slot's next tenant bitwise equal to its solo run")

    # e. the launchers -------------------------------------------------------------
    phase("10e. server: the launchers")
    work = ROOT / "build" / "phase10"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def launch(*args, timeout):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", *map(str, args)],
                             env=env, cwd=work, capture_output=True,
                             text=True, timeout=timeout)
        if run.returncode != 0:
            raise AssertionError(f"{args[0]} exited {run.returncode}:\n"
                                 f"{run.stderr[-3000:]}")
        return run, time.perf_counter() - t0
    run, secs = launch("repro_torch.launch.chaos", "--out",
                       work / "chaos.json", "--bundles-dir",
                       work / "bundles", timeout=300)
    record = json.loads((work / "chaos.json").read_text())
    if not record["all_passed"] or record["n_scenarios"] != 5 \
            or torch.device(record["device"]).type != dev.type:
        raise AssertionError(f"chaos drills: {record}")
    for name, row in record["scenarios"].items():
        bundle = json.loads((work / "bundles" / row["bundle"]).read_text())
        if bundle["reason"] not in render_postmortem(bundle):
            raise AssertionError(f"chaos {name}: bundle did not render")
    log(f"python -m repro_torch.launch.chaos: all {record['n_scenarios']} "
        f"drills passed on the card in {secs:.1f} s (" + ", ".join(
            f"{k_} {v_['wall_s']:.2f} s"
            for k_, v_ in record["scenarios"].items())
        + "); every bundle rendered")
    run, secs = launch("repro_torch.launch.serve_sim", "--telemetry-out",
                       work / "serve.trace.jsonl", timeout=300)
    log(f"python -m repro_torch.launch.serve_sim (defaults) in {secs:.1f} "
        f"s: " + " | ".join(run.stderr.strip().splitlines()[-6:]))
    report, _ = launch("repro_torch.launch.obs_report",
                       work / "serve.trace.jsonl", timeout=120)
    if "sim_server.tick" not in report.stdout:
        raise AssertionError("obs_report lost the sim_server.tick span")
    log("obs_report rendered the serve_sim trace")


# ---------------------------------------------------------------------------
# phase 11: jax.random-exact sampling, widths off 4, bfloat16
# ---------------------------------------------------------------------------

def sampling_phase(model, scen, scenes, t_hist, s_max):
    """Phase 11a: a rollout's actions bitwise repeatable run to run, and a
    server lane (i, k) against engine lane (i, k) over 32 scenes x 2
    samples: futures bitwise equal in every lane without a near-tie (an
    agent's top two perturbed scores within NEAR_TIE at some tick: there
    the server's logits, within MODEL_TOL of the engine's, may pick
    apart); the share printed. (The kernel against prng at the tick's and
    the server's shapes ran in phase 3.)"""
    import numpy as np
    from repro_torch.runtime import RolloutEngine, SimServer, serve_scenes
    phase("11a. sampling: rollouts repeatable, server lanes against the "
          "engine's")
    engine = RolloutEngine(model, scen, num_slots=len(scenes))
    runs = [(engine.run(scenes, t_hist=t_hist, n_samples=1, seed=5),
             engine.last_actions.copy()) for _ in range(2)]
    bitwise_or_raise("rollout futures, run to run", runs[1][0], runs[0][0])
    bitwise_or_raise("rollout actions, run to run", runs[1][1], runs[0][1])
    log(f"rollout of {len(scenes)} scenes at seed 5: futures and "
        f"{runs[0][1].size} sampled actions bitwise equal run to run")
    sub = scenes[:SAMPLING_SCENES]
    lanes = len(sub) * SAMPLING_SAMPLES
    engine = RolloutEngine(model, scen, num_slots=lanes)
    want = engine.run(sub, t_hist=t_hist, n_samples=SAMPLING_SAMPLES,
                      seed=5)
    srv = SimServer(model, scen, num_slots=lanes, max_len=s_max)
    got = serve_scenes(srv, sub, t_hist=t_hist, n_samples=SAMPLING_SAMPLES,
                       seed=5)
    tied = score_gaps(model, scen, sub, t_hist, SAMPLING_SAMPLES,
                      5).min(axis=(2, 3)) < NEAR_TIE          # (S, K)
    equal = np.array([[np.array_equal(got[i, k_], want[i, k_])
                       for k_ in range(SAMPLING_SAMPLES)]
                      for i in range(len(sub))])
    if (~equal & ~tied).any():
        raise AssertionError(f"server lanes {np.argwhere(~equal & ~tied)} "
                             f"differ from the engine's without a near-tie")
    log(f"server vs engine, {len(sub)} scenes x {SAMPLING_SAMPLES} samples "
        f"through {lanes} slots: futures bitwise equal in "
        f"{int(equal.sum())} of {lanes} lanes ({equal.mean():.1%}); "
        f"{int(tied.sum())} lanes hold a near-tie (top-two gap under "
        f"{NEAR_TIE:g}), {int((~equal).sum())} differ, all among them")


def widths_phase(cfg, scen, scenes, pairs, t_hist, s_max, launches,
                 max_err, cases, head_dim, title):
    """Phases 11b and 12a: the decode (float32, bf16, int8 caches; a bf16
    query too) and the flash forward, dq and dk/dv at ``cases`` against
    their plain versions at phase 3's tolerances; then sim-se2-fourier at
    full width with ``head_dim``: checked against the reference forward,
    rolled out (float32 and int8, launches exact) and trained 3 steps
    (loss finite, launches exact)."""
    import torch
    from repro_torch.kernels import cuda, ops
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.training.data import make_batch_fn
    from repro_torch.data import ShardedIterator
    from repro_torch.training.steps import bc_optimizer, make_sim_train_step
    phase(title)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = {"tick": (scen.num_agents, False),
            "prefill": (scen.num_map + t_hist * scen.num_agents, True)}
    cursors = [0, 1, 127, 128, s_max, 200, 300, 64]
    for name, (d, dv) in cases.items():
        worst = 0.0
        for cache_dtype, shape in itertools.product(
                ("float32", "bfloat16", "int8"), rows):
            sq, prefill = rows[shape]
            common = dict(layers=2, b=len(cursors), h=cfg.num_heads,
                          s=s_max, sq=sq, cursors=cursors,
                          num_map=scen.num_map, num_agents=scen.num_agents,
                          prefill=prefill)
            case = decode_case(gen, dev, cache_dtype, c=d, **common)
            other = decode_case(gen, dev, cache_dtype, c=dv, **common)
            q, k = case.pop("q"), case.pop("k")
            v = other["v"]
            case.pop("v")
            case["v_scale"] = other["v_scale"]
            queries = [q] + ([q.to(torch.bfloat16)]
                             if cache_dtype == "bfloat16" else [])
            for q_ in queries:
                want = ops.decode_attention(q_, k, v, impl="plain", layer=1,
                                            **case)
                for splits in (None, 1, 5):
                    got = ops.decode_attention(q_, k, v, impl="flash_decode",
                                               layer=1, num_splits=splits,
                                               **case)
                    again = ops.decode_attention(q_, k, v,
                                                 impl="flash_decode", layer=1,
                                                 num_splits=splits, **case)
                    torch.cuda.synchronize()
                    tol = DECODE_TOL["bfloat16" if q_.dtype == torch.bfloat16
                                     else cache_dtype]
                    err = close_or_raise(
                        f"flash_decode {name} {cache_dtype} {shape} q "
                        f"{str(q_.dtype)[6:]} splits={splits}", got, want,
                        **tol)
                    if not torch.equal(got, again) or got.dtype != q_.dtype:
                        raise AssertionError(f"flash_decode {name}: not "
                                             f"bitwise repeatable or not in "
                                             f"q's dtype")
                    worst = max(worst, err)
                    if q_.dtype == torch.float32:
                        max_err["flash_decode"] = max(
                            max_err["flash_decode"], err)
        log(f"flash_decode at D = {d}, Dv = {dv}: float32, bf16 and int8 "
            f"caches (bf16 also with a bf16 query), the tick's and the "
            f"prefill's rows, splits auto / 1 / 5: within tolerance, bitwise "
            f"repeatable; max abs err {worst:.3e}")
        for dtype in (torch.float32, torch.bfloat16):
            shapes = ((2, 4, 45, d), (2, 2, 45, d), (2, 2, 45, dv),
                      (2, 4, 45, dv))
            q, k, v, do = (torch.randn(s_, generator=gen, device=dev)
                           .to(dtype) for s_ in shapes)
            check_flash(f"D = {d}, Dv = {dv}, causal GQA, "
                        f"{str(dtype)[6:]}", q, k, v, do,
                        dict(causal=True), max_err)
    # the full-width model at head_dim
    cfg_h = dataclasses.replace(cfg, head_dim=head_dim)
    model = AgentSimModel(cfg_h, generator=torch.Generator().manual_seed(0))
    c = model.blocks[0].attn.cache_dims[0]
    log(f"sim-se2-fourier at head_dim {head_dim}: c = {c}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    check_flash(f"train shape c = {c}", *scene_attention_case(
        gen, dev, model, scen, TRAIN_BATCH, 1.0 / math.sqrt(head_dim),
        c), max_err)
    check_against_reference(model, scen, pairs, t_hist, s_max)
    ticks = scen.num_steps - t_hist
    per_rollout = cfg.num_layers * (1 + ticks)
    rollouts(model, scen, scenes, t_hist, {
        "flash_decode": per_rollout, "se2_project_q": per_rollout,
        "se2_project_k": 2 * per_rollout, "se2_project_q_t": per_rollout,
        "categorical": ticks}, launches, f"head_dim {head_dim} ")
    data = ShardedIterator(make_batch_fn(scen, FAMILIES),
                           batch_size=TRAIN_BATCH, seed=0)
    opt = bc_optimizer(lr=TRAIN_LR, steps=3)
    step = make_sim_train_step(model, opt)
    state = opt.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    cuda.reset_launches()
    losses = []
    for _ in range(3):
        state, metrics = step(state, next(data))
        losses.append(float(metrics["loss"]))
    counts = dict(cuda.LAUNCHES)
    want = {k_: 3 * n for k_, n in {
        "flash_attention_fwd": 1, "flash_attention_dq": 1,
        "flash_attention_dkv": 1, "se2_project_q": 2, "se2_project_q_t": 2,
        "se2_project_k": 2, "se2_project_k_t": 2}.items()}
    want = {k_: n * cfg.num_layers for k_, n in want.items()}
    data.close()
    if counts != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"head_dim {head_dim} train: launches "
                             f"{counts} (want {want}), losses {losses}")
    for k_, n in counts.items():
        launches[k_] += n
    log(f"head_dim {head_dim} train: 3 steps x {TRAIN_BATCH} scenes, "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}, launches {counts}")
    del model


def serve_sim_defaults():
    """Phase 11b's end: serve_sim's defaults give head_dim 18 (phase 10e
    served them)."""
    from repro_torch.launch import serve_sim
    args = serve_sim.build_parser().parse_args([])
    _, smodel = serve_sim.build(args)
    if (smodel.cfg.head_dim, smodel.blocks[0].attn.cache_dims[0]) != (18, 150):
        raise AssertionError(f"serve_sim defaults: head_dim "
                             f"{smodel.cfg.head_dim}")
    log("serve_sim at its defaults builds head_dim 18 (c = 150), as the "
        "reference's launcher; phase 10e served it on the card")


def bf16_phase(model, scen, scenes, pairs, t_hist, s_max, launches,
               max_err, f32_rollout, f32_steps_per_s):
    """Phase 11c: sim-se2-fourier at full width and dtype "bfloat16" (phase
    4's seed-0 weights): the kernels at its shapes in bf16 against their
    plain versions; the cached decode (bf16 and int8 caches) against the
    full forward and the flash forward against the reference forward at
    8e-2; a 64-slot rollout with bf16 and int8 caches, 20 train steps
    (loss finite and falling, gradients through the kernels against the
    plain versions), the 7 x 4 x 4 evaluation and a 64-lane server drive,
    each with its launches exact; ticks/s, steps/s, lanes/s, peak memory and
    slab beside the float32 model's in this process; the action
    probabilities' shift under a re-pose."""
    import numpy as np
    import torch
    from repro_torch import obs, scenarios
    from repro_torch.kernels import cuda, ops
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.runtime import (EvalConfig, SimServer,
                                     evaluate_families, poisson_drive)
    phase("11c. bfloat16: the sim path at dtype bfloat16")
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(13)
    cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
    m16 = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
    m16.load_state_dict(model.state_dict())
    c = m16.blocks[0].attn.cache_dims[0]
    layers = cfg.num_layers
    # the kernels at the bf16 model's tick and train shapes
    case = decode_case(gen, dev, "bfloat16", layers=layers, b=N_SLOTS,
                       h=cfg.num_heads, s=s_max, c=c, sq=scen.num_agents,
                       cursors=[s_max - 2 * scen.num_agents] * N_SLOTS,
                       num_map=scen.num_map, num_agents=scen.num_agents)
    q, k, v = case.pop("q").to(torch.bfloat16), case.pop("k"), case.pop("v")
    got = ops.decode_attention(q, k, v, impl="flash_decode", layer=3, **case)
    want = ops.decode_attention(q, k, v, impl="plain", layer=3, **case)
    torch.cuda.synchronize()
    err = close_or_raise("flash_decode bf16 tick", got, want,
                         **DECODE_TOL["bfloat16"])
    log(f"flash_decode, bf16 cache and query at the tick ({N_SLOTS} x "
        f"{cfg.num_heads} x {scen.num_agents} x {c}): max abs err {err:.3e}")
    train_case = scene_attention_case(gen, dev, m16, scen, TRAIN_BATCH,
                                      1.0 / math.sqrt(cfg.head_dim), c)
    check_flash("train shape bfloat16", *(
        t_.to(torch.bfloat16) for t_ in train_case[:4]), train_case[4],
        max_err)
    check_against_reference(m16, scen, pairs, t_hist, s_max,
                            cache_dtypes=("bfloat16", "int8"),
                            tol=BF16_MODEL_TOL)
    ticks = scen.num_steps - t_hist
    per_rollout = layers * (1 + ticks)
    rollout_counts = {"flash_decode": per_rollout,
                      "se2_project_q": per_rollout,
                      "se2_project_k": 2 * per_rollout,
                      "se2_project_q_t": per_rollout, "categorical": ticks}
    stats = {}
    rollouts(m16, scen, scenes, t_hist, rollout_counts, launches, "bf16 ",
             cache_dtypes=("bfloat16", "int8"), stats=stats)
    log("rollout, ticks/s and peak GiB: " + ", ".join(
        f"bf16 model {k_} cache {v_[0]:.1f} / {v_[1]:.2f}"
        for k_, v_ in stats.items()) + "; float32 model (phase 4) " + ", ".join(
        f"{k_} cache {v_[0]:.1f} / {v_[1]:.2f}" for k_, v_ in
        f32_rollout.items()))
    per_step = {"flash_attention_fwd": layers, "flash_attention_dq": layers,
                "flash_attention_dkv": layers, "se2_project_q": 2 * layers,
                "se2_project_q_t": 2 * layers, "se2_project_k": 2 * layers,
                "se2_project_k_t": 2 * layers}
    _, _, data, rate = train(m16, scen, per_step, launches, "bf16 ",
                             mixed_grads=False,
                             grad_rel_tol=BF16_GRAD_REL_TOL)
    data.close()
    log(f"train steps/s: bf16 {rate:.2f}, float32 (phase 5) "
        f"{f32_steps_per_s:.2f}")
    if not all(p_.dtype == torch.float32 for p_ in m16.parameters()):
        raise AssertionError("bf16 training left a non-float32 parameter")
    eval_cfg = EvalConfig(t_hist=t_hist, n_samples=EVAL_SAMPLES, seed=0)
    chunks = -(-len(scenarios.registry.names()) * BF16_EVAL_SCENES
               * EVAL_SAMPLES // EVAL_SLOTS[0])
    want = {k_: chunks * n for k_, n in rollout_counts.items()}
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    tables = evaluate_families(m16, scen, eval_cfg,
                               n_scenes_per_family=BF16_EVAL_SCENES,
                               num_slots=EVAL_SLOTS[0])
    secs = time.perf_counter() - t0
    counts = dict(cuda.LAUNCHES)
    if counts != want:
        raise AssertionError(f"bf16 evaluation launches {counts} != {want}")
    for k_, n in counts.items():
        launches[k_] += n
    eval_scenes = [scenarios.generate_scene(f, EVAL_SCENE_SEED, i, scen)
                   for f in scenarios.registry.names()
                   for i in range(BF16_EVAL_SCENES)]
    check_tables(tables, eval_scenes, BF16_EVAL_SCENES, "bf16 ")
    log(f"bf16 evaluate_families: 7 families x {BF16_EVAL_SCENES} scenes x "
        f"{EVAL_SAMPLES} samples in {secs:.3f} s; rates finite, kinematic "
        f"infeasibility 0; overall " + ", ".join(
            f"{k_} {v_:.4g}" for k_, v_ in tables["overall"].items()))
    serve_scenes_ = scenarios.registry.generate_mixed(SERVE_SEED, 0,
                                                      BF16_SERVE_SCENES, scen)
    for m_, what in ((m16, "bf16"), (model, "float32")):
        srv = SimServer(m_, scen, num_slots=SERVE_SLOTS, max_len=s_max,
                        device=dev, registry=obs.NULL)
        poisson_drive(srv, server_requests(serve_scenes_[:4]),
                      rate=SERVE_RATE, seed=0)               # warm-up
        srv = SimServer(m_, scen, num_slots=SERVE_SLOTS, max_len=s_max,
                        device=dev, registry=obs.NULL)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        t0 = time.perf_counter()
        poisson_drive(srv, server_requests(serve_scenes_), rate=SERVE_RATE,
                      seed=0, warmup_ticks=SERVE_WARMUP_TICKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
        calls = srv.ticks + srv.admitted
        want = {"flash_decode": layers * calls, "se2_project_q": layers * calls,
                "se2_project_k": 2 * layers * calls,
                "se2_project_q_t": layers * calls, "categorical": srv.ticks}
        lanes = len(serve_scenes_) * SERVE_SAMPLES
        done = srv.done
        if counts != want or len(done) != lanes or any(
                r.status != "ok" or not np.isfinite(r.future).all()
                for r in done.values()):
            raise AssertionError(f"{what} server drive: launches {counts} "
                                 f"(want {want}), {len(done)} of {lanes} "
                                 f"lanes done")
        for k_, n in counts.items():
            launches[k_] += n
        slab = sum(t_.numel() * t_.element_size()
                   for t_ in srv.cache.values()) / 2**20
        log(f"server, {what} model ({srv.cache['k'].dtype} slab): {lanes} "
            f"lanes in {srv.ticks} ticks, {wall:.3f} s = {lanes / wall:.1f} "
            f"lanes/s, slab {slab:.1f} MiB, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"exact")
    shifts = {what: action_shift(m_, scenes[0], INVARIANCE_Z["se2_fourier"])
              for m_, what in ((m16, "bf16"), (model, "float32"))}
    log(f"action probabilities under z = {INVARIANCE_Z['se2_fourier']}: max "
        f"shift bf16 {shifts['bf16']:.3e}, float32 {shifts['float32']:.3e}")
    del m16


def free_port() -> int:
    import socket
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        return s_.getsockname()[1]


def fleet_rank(rank, world, port, out, cfg, scen, t_hist, pods, n_steps):
    """One rank of phase 12b-c (a process of its own, spawned): the fleet
    rollout and the compressed-DP train step over a (pods, world / pods)
    mesh; with world 1 (NCCL) the DP step alone, against the plain step's
    loss. Rank 0 gathers every rank's record into ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import scenarios
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import init_fleet, make_fleet_mesh
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.runtime import RolloutEngine
    from repro_torch.training.data import make_sim_batch
    from repro_torch.training.steps import (bc_optimizer,
                                            make_sim_dp_train_step,
                                            make_sim_train_step, sim_dp_state)
    backend = init_fleet(rank, world, f"tcp://localhost:{port}",
                         device="cuda")
    mesh = make_fleet_mesh(pods=pods)
    model = AgentSimModel(cfg, generator=torch.Generator().manual_seed(0))
    rec = {"rank": rank, "backend": backend,
           "coord": list(mesh.get_coordinate())}
    if world > 1:
        # 12b: one chunk of FLEET_LANES lanes, each rank its block
        scenes = [scenarios.generate_scene("freeform", 0, i, scen)
                  for i in range(FLEET_LANES)]
        run = dict(t_hist=t_hist, n_samples=1, seed=0)
        eng = RolloutEngine(model, scen, num_slots=FLEET_LANES, mesh=mesh)
        eng.run(scenes, **run)                              # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        cuda.reset_launches()
        t0 = time.perf_counter()
        fut = eng.run(scenes, **run)
        torch.cuda.synchronize()
        rec["rollout"] = dict(secs=time.perf_counter() - t0,
                              counts=dict(cuda.LAUNCHES),
                              local_slots=eng.local_slots,
                              ticks=scen.num_steps - t_hist)
        if rank == 0:
            acts = eng.last_actions
            local = RolloutEngine(model, scen, num_slots=eng.local_slots)
            want_local = local.run(scenes, **run)
            full = RolloutEngine(model, scen, num_slots=FLEET_LANES)
            want_full = full.run(scenes, **run)
            np.savez(f"{out}/fleet.npz", fut=fut, acts=acts,
                     local=want_local, local_acts=local.last_actions,
                     full=want_full, full_acts=full.last_actions)
        dist.barrier()
    # 12c: the compressed-DP step, TRAIN_BATCH scenes a global batch
    opt = bc_optimizer(TRAIN_LR, n_steps)
    step = make_sim_dp_train_step(model, opt, mesh, compress=True)
    state = sim_dp_state(opt, dict(model.named_parameters()))
    batches = [make_sim_batch(0, i * TRAIN_BATCH, TRAIN_BATCH, scen,
                              FAMILIES) for i in range(n_steps)]
    if world == 1:
        # the plain step's loss on the first batch, from the same weights
        plain = make_sim_train_step(model, opt)
        rec["plain_loss"] = float(plain.grads(batches[0])[1]["loss"])
    torch.cuda.synchronize()
    cuda.reset_launches()
    losses, secs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        grads, metrics = step.grads(batch)
        losses.append(float(metrics["loss"]))
        state = step.update(state, grads)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    digest = hashlib.sha256()
    for p_ in model.parameters():
        digest.update(p_.detach().cpu().numpy().tobytes())
    rec["dp"] = dict(losses=losses, secs=secs, counts=dict(cuda.LAUNCHES),
                     params=digest.hexdigest(),
                     residual_max=max(float(r.abs().max()) for r in
                                      state["residual"].values()))
    got = [None] * world if rank == 0 else None
    dist.gather_object(rec, got, dst=0)
    if rank == 0:
        Path(f"{out}/ranks.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def fleet_phase(cfg, scen, t_hist, launches):
    """Phase 12b-c: FLEET_WORLD spawned ranks sharing the card over gloo,
    then one rank over NCCL (see the module docstring)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    out = ROOT / "build" / "phase12"
    out.mkdir(parents=True, exist_ok=True)
    per_rollout = cfg.num_layers * (1 + scen.num_steps - t_hist)
    want_rollout = {"flash_decode": per_rollout,
                    "se2_project_q": per_rollout,
                    "se2_project_k": 2 * per_rollout,
                    "se2_project_q_t": per_rollout,
                    "categorical": scen.num_steps - t_hist}
    want_dp = {k_: FLEET_DP_STEPS * n * cfg.num_layers for k_, n in {
        "flash_attention_fwd": 1, "flash_attention_dq": 1,
        "flash_attention_dkv": 1, "se2_project_q": 2, "se2_project_q_t": 2,
        "se2_project_k": 2, "se2_project_k_t": 2}.items()}
    for world, pods, title in (
            (FLEET_WORLD, FLEET_PODS, "12b-c. fleet: 2 x 2 gloo ranks "
             "sharing the card"),
            (1, 1, "12c. the compressed-DP step on a 1 x 1 NCCL mesh")):
        phase(title)
        t0 = time.perf_counter()
        mp.spawn(fleet_rank, args=(world, free_port(), str(out), cfg, scen,
                                   t_hist, pods, FLEET_DP_STEPS),
                 nprocs=world, join=True)
        ranks = json.loads((out / "ranks.json").read_text())
        log(f"{world} rank(s) spawned, ran and joined in "
            f"{time.perf_counter() - t0:.1f} s; backends "
            f"{sorted({r['backend'] for r in ranks})}")
        for r in ranks:
            if "rollout" in r:
                ro = r["rollout"]
                if ro["counts"] != want_rollout:
                    raise AssertionError(f"fleet rank {r['rank']} rollout "
                                         f"launches {ro['counts']} (want "
                                         f"{want_rollout})")
                for k_, n in ro["counts"].items():
                    launches[k_] += n
                log(f"fleet rollout, rank {r['rank']} {r['coord']}: "
                    f"{ro['local_slots']} lanes x {ro['ticks']} ticks in "
                    f"{ro['secs']:.3f} s = {ro['ticks'] / ro['secs']:.1f} "
                    f"ticks/s, launches {ro['counts']}")
            dp = r["dp"]
            if dp["counts"] != want_dp or not all(
                    math.isfinite(x) for x in dp["losses"]):
                raise AssertionError(f"DP rank {r['rank']}: launches "
                                     f"{dp['counts']} (want {want_dp}), "
                                     f"losses {dp['losses']}")
            for k_, n in dp["counts"].items():
                launches[k_] += n
            log(f"DP step, rank {r['rank']} {r['coord']} ({r['backend']}): "
                f"losses {', '.join(f'{x:.5f}' for x in dp['losses'])}, "
                f"s/step {', '.join(f'{x:.3f}' for x in dp['secs'])}, "
                f"residual max {dp['residual_max']:.3e}, launches "
                f"{dp['counts']}")
        if len({r["dp"]["params"] for r in ranks}) != 1 or len(
                {tuple(r["dp"]["losses"]) for r in ranks}) != 1:
            raise AssertionError("DP ranks ended with other parameters or "
                                 "losses")
        log(f"DP step: {world} rank(s) end with bitwise equal parameters "
            f"and losses")
        if world == 1:
            err = abs(ranks[0]["dp"]["losses"][0] - ranks[0]["plain_loss"])
            if err > 1e-6 * abs(ranks[0]["plain_loss"]):
                raise AssertionError(f"1 x 1 DP loss {ranks[0]['dp']} "
                                     f"against the plain step's "
                                     f"{ranks[0]['plain_loss']}")
            log(f"1 x 1 NCCL DP step: first loss within {err:.2e} of the "
                f"plain step's {ranks[0]['plain_loss']:.6f}")
            continue
        res = dict(np.load(out / "fleet.npz"))
        if not (np.array_equal(res["fut"], res["local"])
                and np.array_equal(res["acts"], res["local_acts"])):
            raise AssertionError("the fleet rollout differs from a "
                                 "single-process engine with the local "
                                 "lane count")
        same = (res["acts"] == res["full_acts"]).reshape(FLEET_LANES, -1)
        parted = int((~same.all(axis=1)).sum())
        kept = same.all(axis=1)
        close_or_raise("fleet rollout vs one engine of every lane",
                       torch.from_numpy(res["fut"][kept]),
                       torch.from_numpy(res["full"][kept]),
                       **MODEL_TOL["float32"])
        bitwise = int(sum(np.array_equal(res["fut"][i], res["full"][i])
                          for i in range(FLEET_LANES)))
        if parted > FLEET_PARTED_SHARE * FLEET_LANES:
            raise AssertionError(f"{parted} fleet lanes parted from the "
                                 f"single engine's")
        one = ranks[0]["rollout"]
        log(f"fleet rollout: every rank's lanes bitwise equal to a "
            f"{one['local_slots']}-slot single-process engine; against one "
            f"engine of all {FLEET_LANES} lanes {bitwise} lanes bitwise, "
            f"{parted} parted at a sampled action, the rest within "
            f"MODEL_TOL; {FLEET_LANES / max(r['rollout']['secs'] for r in ranks):.1f} "
            f"scenes/s over {world} ranks sharing one card")
    torch.cuda.empty_cache()


def launcher_phase():
    """Phase 12d: ``python -m repro_torch.launch.train_sim`` over
    LAUNCHER_WORLD ranks (one process each) at full width, a checkpoint
    every LAUNCHER_CKPT_EVERY steps; then the last checkpoint is removed
    and the same command restarts from the one before: its final
    checkpoint must equal the first run's bitwise."""
    import os
    import shutil
    import numpy as np
    phase("12d. train_sim over 2 ranks: checkpoint and restart")
    work = ROOT / "build" / "phase12d"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def launch():
        port = free_port()
        cmd = [sys.executable, "-m", "repro_torch.launch.train_sim",
               "--steps", str(LAUNCHER_STEPS),
               "--ckpt-every", str(LAUNCHER_CKPT_EVERY), "--batch",
               str(TRAIN_BATCH // LAUNCHER_WORLD), "--ckpt-dir",
               str(work / "ckpt"), "--eval-scenes-per-family", "1",
               "--eval-samples", "1", "--holdout-batches", "1"]
        # torchrun's variables, one process a rank
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   WORLD_SIZE=str(LAUNCHER_WORLD), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(LAUNCHER_WORLD)]
        logs = [p_.communicate(timeout=600)[0] for p_ in procs]
        secs = time.perf_counter() - t0
        for r, (p_, text) in enumerate(zip(procs, logs)):
            (work / f"rank{r}.log").write_text(text)
            if p_.returncode != 0:
                raise AssertionError(f"train_sim rank {r} exited "
                                     f"{p_.returncode}:\n{text[-3000:]}")
        done = [line for line in logs[0].splitlines() if "finished:" in line]
        return secs, done[-1] if done else "", logs

    secs, done, logs = launch()
    steps = sorted((work / "ckpt").glob("*/step_*"))
    if [int(p_.name.split("_")[1]) for p_ in steps] != list(range(
            LAUNCHER_CKPT_EVERY, LAUNCHER_STEPS + 1, LAUNCHER_CKPT_EVERY)):
        raise AssertionError(f"checkpoints {[p_.name for p_ in steps]}")
    last = steps[-1]
    with np.load(last / "arrays.npz") as z:
        first = {k: z[k] for k in z.files}
    log(f"train_sim at world {LAUNCHER_WORLD}: {LAUNCHER_STEPS} steps x "
        f"{TRAIN_BATCH} scenes (a share a rank) in {secs:.1f} s wall, "
        f"checkpoints {[p_.name for p_ in steps]}; {done.split('INFO')[-1][:200]}")
    shutil.rmtree(last)
    secs, done, logs = launch()
    if not any("restored from step" in line for line in logs[0].splitlines()):
        raise AssertionError("the restart did not restore a checkpoint")
    with np.load(last / "arrays.npz") as z:
        again = {k: z[k] for k in z.files}
    if sorted(again) != sorted(first):
        raise AssertionError("the restarted run's final checkpoint holds "
                             "other arrays")
    import torch
    for k_ in (k_ for k_ in first if first[k_].size):
        close_or_raise(f"restarted checkpoint {k_}",
                       torch.from_numpy(np.asarray(again[k_])),
                       torch.from_numpy(np.asarray(first[k_])),
                       atol=RESTART_PARAM_ATOL, rtol=RESTART_LOSS_RTOL)
    bitwise = sum(np.array_equal(again[k_], first[k_]) for k_ in first)
    log(f"train_sim restart from step {LAUNCHER_STEPS - LAUNCHER_CKPT_EVERY}: "
        f"{secs:.1f} s wall; final checkpoint within the reference's "
        f"restart tolerance of the straight run's, {bitwise} of "
        f"{len(first)} arrays bitwise; both ranks exited 0")
    shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: the dense LM serving stack
# ---------------------------------------------------------------------------

def lm_decode_case(gen, dev, *, b, hq, hkv, d, s, cursors, cache_dtype,
                   q_dtype, sq=1):
    """An LM cache of two layers read at layer 1 (rows past each cursor
    NaN; int8: NaN scales) and sq query rows a slot at the last sq
    positions before its cursor (causal through q_times / k_times where
    sq > 1)."""
    import torch
    from repro_torch.kernels.flash_decode import quantize_kv
    k = torch.randn((2, b, hkv, s, d), generator=gen, device=dev)
    v = torch.randn((2, b, hkv, s, d), generator=gen, device=dev)
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(q_dtype)
    kvl = torch.as_tensor(cursors, dtype=torch.int32, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= kvl[:, None].long()
    nan = torch.tensor(float("nan"), device=dev)
    opts = dict(k_scale=None, v_scale=None, q_times=None, k_times=None)
    if cache_dtype == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        opts["k_scale"] = torch.where(past[None, :, None], nan,
                                      ks).contiguous()
        opts["v_scale"] = torch.where(past[None, :, None], nan,
                                      vs).contiguous()
    else:
        dt = getattr(torch, cache_dtype)
        k = torch.where(past[None, :, None, :, None], nan, k).to(dt)
        v = torch.where(past[None, :, None, :, None], nan, v).to(dt)
    if sq > 1:
        opts["q_times"] = (kvl[:, None] - sq + torch.arange(sq, device=dev)
                           ).to(torch.int32).contiguous()
        opts["k_times"] = torch.arange(s, dtype=torch.int32, device=dev)[
            None].expand(b, s).contiguous()
    return q, k.contiguous(), v.contiguous(), kvl, opts


class PlainCalls:
    """Counts calls of the attention kernels' plain versions and of the
    plain attention paths while it is entered (module attributes wrapped,
    so calls through the dispatchers are seen)."""

    TARGETS = (("repro_torch.kernels.flash_decode", "decode_plain"),
               ("repro_torch.kernels.flash_attention", "flash_fwd_plain"),
               ("repro_torch.kernels.flash_attention_bwd", "flash_bwd_plain"),
               ("repro_torch.kernels.ref", "mha_chunked"),
               ("repro_torch.kernels.ref", "mha_reference"))

    def __enter__(self):
        import importlib
        self.calls, self._saved = {}, []
        for mod_name, fn_name in self.TARGETS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, fn))

            def counted(*a, _fn=fn, _name=fn_name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(mod, fn_name, counted)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self._saved:
            setattr(mod, fn_name, fn)


def lm_kernels(gen, dev, max_err, records):
    """Phase 13a: the decode and the flash forward at the LM shapes against
    their plain versions (phase 3's tolerances), each timed as phase 6
    times (events and CUPTI) beside its plain version, SDPA and its bound;
    the rows nest in the two kernels' records."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import dequantize_kv
    F = torch.nn.functional
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(13)
    cursors = np.concatenate([[1, LM_MAX_CURSOR], rng.integers(
        1, LM_MAX_CURSOR + 1, LM_SLOTS - 2)])
    # the decode: (b, hq, hkv, d, s, cursors) a case
    tick = (LM_SLOTS, 24, 8, 128, LM_MAX_CURSOR, cursors)
    decode_checks = {f"{cd} cache, {str(qd)[6:]} query": (tick, cd, qd, 1)
                     for cd in ("float32", "bfloat16", "int8")
                     for qd in (f32, bf16)}
    decode_checks["phi4 chunk of 40, float32"] = (
        (2, 24, 8, 128, 512, [40, 300]), "float32", f32, 40)
    decode_checks["stablelm MHA 32 x 80, float32"] = (
        (LM_SLOTS, 32, 32, 80, LM_MAX_CURSOR, cursors), "float32", f32, 1)
    decode_checks["granite MQA 48 / 1, float32"] = (
        (LM_SLOTS, 48, 1, 128, LM_MAX_CURSOR, cursors), "float32", f32, 1)
    timed = {"float32 cache, float32 query": "lm_tick",
             "bfloat16 cache, bfloat16 query": "lm_tick_bf16",
             "int8 cache, bfloat16 query": "lm_tick_int8_bf16q",
             "stablelm MHA 32 x 80, float32": "lm_tick_stablelm",
             "granite MQA 48 / 1, float32": "lm_tick_granite"}
    timings = {}
    for what, ((b, hq, hkv, d, s, cur), cd, qd, sq) in decode_checks.items():
        q, k, v, kvl, opts = lm_decode_case(
            gen, dev, b=b, hq=hq, hkv=hkv, d=d, s=s, cursors=cur,
            cache_dtype=cd, q_dtype=qd, sq=sq)
        run = lambda q=q, k=k, v=v, kvl=kvl, opts=opts: \
            ops.decode_attention(q, k, v, kv_length=kvl, layer=1,
                                 impl="flash_decode", **opts)
        got, again = run(), run()
        want = ops.decode_attention(q, k, v, kv_length=kvl, layer=1,
                                    impl="plain", **opts)
        torch.cuda.synchronize()
        tol = DECODE_TOL["bfloat16" if qd == bf16 else cd]
        err = close_or_raise(f"13a flash_decode {what}", got, want, **tol)
        if not torch.equal(got, again):
            raise AssertionError(f"13a flash_decode {what}: not bitwise "
                                 f"repeatable")
        max_err["flash_decode"] = max(max_err["flash_decode"], err)
        log(f"13a flash_decode {what}: {b} slots x {hq}/{hkv} heads x {d}, "
            f"{sq} query rows, cursors {min(cur)}-{max(cur)}: max abs err "
            f"{err:.3e}, bitwise repeatable")
        if what not in timed:
            continue
        live = int(kvl.sum())
        es = k.element_size()
        # SDPA over layer 1 in the query's dtype (int8 dequantized), the
        # NaN rows past the cursors zeroed (a masked NaN V row is NaN in P V)
        kl, vl = (torch.nan_to_num(
            dequantize_kv(t_[1], sc[1], dtype=qd) if cd == "int8"
            else t_[1].to(qd))
            for t_, sc in ((k, opts["k_scale"]), (v, opts["v_scale"])))
        mask = (torch.arange(s, device=dev)[None, :] < kvl[:, None].long()
                )[:, None, None, :]
        timings[timed[what]] = dict(
            fn=run, plain=lambda q=q, k=k, v=v, kvl=kvl, opts=opts:
            ops.decode_attention(q, k, v, kv_length=kvl, layer=1,
                                 impl="plain", **opts),
            library=lambda q=q, kl=kl, vl=vl, mask=mask:
            F.scaled_dot_product_attention(q, kl, vl, attn_mask=mask,
                                           enable_gqa=True),
            bytes=(live * hkv * 2 * d * es + (live * hkv * 2 * 4
                                              if cd == "int8" else 0)
                   + 2 * b * hq * sq * d * q.element_size() + b * 4),
            flops=2 * live * hq * sq * 2 * d,
            rate=SPLIT_TF32_FLOP_PER_S if cd == "float32"
            else BF16_FLOP_PER_S, kernel="flash_decode",
            shape=f"{what}: {b} slots x {hq}/{hkv} heads x {d}, {live} live "
                  f"rows over {s}")
    # the forward at the prefill: causal, (b, hq, hkv, s, d, dtype)
    fwd_checks = {
        "lm_prefill": (LM_PREFILL_B, 24, 8, LM_PREFILL_S, 128, f32),
        "lm_prefill_bf16": (LM_PREFILL_B, 24, 8, LM_PREFILL_S, 128, bf16),
        "lm_prefill_stablelm": (LM_PREFILL_B, 32, 32, LM_PREFILL_S, 80, f32),
        "lm_prefill_granite": (LM_PREFILL_B, 48, 1, LM_PREFILL_S, 128, f32)}
    for name, (b, hq, hkv, s, d, dt) in fwd_checks.items():
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dt)
        run = lambda q=q, k=k, v=v: fa.flash_attention_fwd(  # noqa: E731
            q, k, v, causal=True)
        (got, lse), (again, _) = run(), run()
        want, want_lse = fa.flash_fwd_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        key = "float32" if dt == f32 else "bfloat16"
        err = close_or_raise(f"13a flash forward {name}", got, want,
                             **FLASH_TOL[key])
        close_or_raise(f"13a flash forward {name} lse", lse, want_lse,
                       atol=1e-4, rtol=1e-5)
        if not torch.equal(got, again):
            raise AssertionError(f"13a flash forward {name}: not bitwise "
                                 f"repeatable")
        if dt == f32:
            max_err["flash_attention_fwd"] = max(
                max_err["flash_attention_fwd"], err)
        log(f"13a flash forward {name}: {b} x {hq}/{hkv} heads x {s} x {d} "
            f"causal, {key}: max abs err {err:.3e}, bitwise repeatable")
        es = q.element_size()
        pairs = b * s * (s + 1) // 2
        timings[name] = dict(
            fn=run, plain=lambda q=q, k=k, v=v: fa.flash_fwd_plain(
                q, k, v, causal=True),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            bytes=(2 * b * hq * s * d + 2 * b * hkv * s * d) * es
            + b * hq * s * 4,
            flops=2 * pairs * hq * 2 * d,
            rate=SPLIT_TF32_FLOP_PER_S if dt == f32 else BF16_FLOP_PER_S,
            kernel="flash_attention_fwd",
            shape=f"{b} x {hq}/{hkv} heads x {s} x {d}, causal, {key}")
    for name, tm in timings.items():
        ms = time_ms(tm["fn"])
        plain_ms = time_ms(tm["plain"], batches=5, per_batch=4)
        library_ms = time_ms(tm["library"])
        device = {"ms": kernel_ms(tm["fn"]),
                  "library_ms": kernel_ms(tm["library"])}
        byte_ms = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        flop_ms = tm["flops"] / tm["rate"] * 1e3
        nested = {"ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(byte_ms, flop_ms),
                  "bound_by": "bytes" if byte_ms >= flop_ms
                  else "operations", "library_ms": library_ms,
                  "bound_f32_ms": max(byte_ms,
                                      tm["flops"] / F32_FLOP_PER_S * 1e3)}
        owner = next(r for r in records if r["name"] == tm["kernel"])
        owner[name] = nested
        log(json.dumps({"kernel": tm["kernel"], "row": name,
                        "shape": tm["shape"], **nested,
                        "device_time_ms": device}))


def lm_tokenwise(model, toks, prefix, max_len):
    """Logits of every token position decoded over a fresh float32 cache:
    the prefix (if any) and the first token as one chunk (the decode kernel
    with q_times / k_times), then one token a serve step."""
    import torch
    from repro_torch.runtime.steps import make_serve_step
    serve = make_serve_step(model)
    p = 0 if prefix is None else prefix.shape[1]
    cache = model.init_cache(toks.shape[0], max_len, torch.float32)
    first, _, cache = model(toks[:, :1], prefix_embeds=prefix, cache=cache,
                            cache_index=0)
    outs = [first[:, p:]]
    for i in range(1, toks.shape[1]):
        lg, cache = serve(cache, toks[:, i:i + 1], p + i)
        outs.append(lg[:, None])
    return torch.cat(outs, 1)


def lm_served(model, requests, cache_dtype, slots, max_len,
              max_ticks=None):
    """Drive a Server over ``requests`` [(uid, prompt, max_new)] (to the
    end, or ``max_ticks`` ticks); returns (server, wall s, per-tick s,
    launches, tick a request was admitted, plain attention calls, peak
    memory above the model's)."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.runtime.server import Request, Server
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    srv = Server(model, num_slots=slots, max_len=max_len,
                 cache_dtype=cache_dtype)
    for uid, prompt, new in requests:
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    admitted, ticks = {}, []
    with PlainCalls() as plain:
        cuda.reset_launches()
        t0 = time.perf_counter()
        while (srv.queue or any(s.request for s in srv.slots)) and (
                max_ticks is None or srv.ticks < max_ticks):
            ts = time.perf_counter()
            srv.step()
            ticks.append(time.perf_counter() - ts)
            for s in srv.slots:
                if s.request is not None:
                    admitted.setdefault(s.request.uid, srv.ticks - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    return srv, wall, ticks, counts, admitted, plain.calls, peak


def served_top2(model, requests, uid, cache_dtype, slots, max_len):
    """Drive a Server over ``requests`` to the end; for each token request
    ``uid`` generates, its float32 logits' top two (ids, values)."""
    import numpy as np
    from repro_torch.runtime.server import Request, Server
    srv = Server(model, num_slots=slots, max_len=max_len,
                 cache_dtype=cache_dtype)
    for u, prompt, new in requests:
        srv.submit(Request(uid=u, prompt=prompt, max_new_tokens=new))
    seen, sample = [], srv._sample

    def watch(logits, req):
        if req.uid == uid:
            ids = np.argpartition(logits, -2)[-2:]
            ids = ids[np.argsort(-logits[ids], kind="stable")]
            seen.append((ids.tolist(), logits[ids].tolist()))
        return sample(logits, req)
    srv._sample = watch
    srv.run_until_drained()
    return seen


def solo_gate(model, requests, done, checked, cache_dtype, slots, max_len,
              tag):
    """Each request of ``checked`` {uid: why} against its solo run (one
    slot): its tokens must equal those it gave beside the others
    (``done``), or part at a near-tie. A slot's logits round otherwise
    beside others (the products' shapes follow the slot count), so a
    greedy pick may flip where the top two lie within LM_NEAR_TIE: there
    both runs are driven again to read their top two at the parting token,
    which must be the same two tokens within LM_NEAR_TIE in each. Returns
    (the solo runs' decode launches, {uid: why} of those equal, of those
    parted at a near-tie)."""
    n, equal, tied = 0, {}, {}
    for uid, why in checked.items():
        solo, _, _, counts, *_ = lm_served(model, [requests[uid]],
                                           cache_dtype, 1, max_len)
        n += counts["flash_decode"]
        got, alone = done[uid].generated, solo.done[uid].generated
        if got == alone:
            equal[uid] = why
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, alone)) if a != b)
        both = served_top2(model, requests, uid, cache_dtype, slots,
                           max_len)[j]
        one = served_top2(model, [requests[uid]], uid, cache_dtype, 1,
                          max_len)[j]
        gaps = (both[1][0] - both[1][1], one[1][0] - one[1][1])
        what = (f"{tag}: request {uid} ({why}) parts from its solo run at "
                f"its token {j}: {got[j]} beside others (top two "
                f"{both[0]}, gap {gaps[0]:.3e}) and {alone[j]} alone (top "
                f"two {one[0]}, gap {gaps[1]:.3e})")
        pair = {got[j], alone[j]}
        if set(both[0]) != pair or set(one[0]) != pair \
                or max(gaps) >= LM_NEAR_TIE:
            raise AssertionError(f"{what}, not at a near-tie (top two "
                                 f"within {LM_NEAR_TIE}); tokens {got} "
                                 f"beside others and {alone} alone")
        log(f"{what}: a near-tie")
        tied[uid] = why
    return n, equal, tied


def solo_summary(equal, tied):
    """The solo-run gate's outcome as a clause of a log line."""
    out = ("requests " + ", ".join(f"{u} ({w})" for u, w in equal.items())
           + " equal to their solo runs") if equal else \
        "no request equal to its solo run"
    if tied:
        out += "; " + ", ".join(f"{u} ({w})" for u, w in tied.items()) \
            + " parted from theirs at a near-tie"
    return out


def lm_phase(launches, max_err, records):
    """Phase 13: the dense LM serving stack (see the module docstring)."""
    import os

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.nn.module import count_params
    from repro_torch.nn.transformer import build_model
    from repro_torch.runtime.steps import make_prefill_step
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()

    phase("13a. the LM stack: the decode and the flash forward at the LM "
          "shapes")
    gen = torch.Generator(device=dev).manual_seed(13)
    lm_kernels(gen, dev, max_err, records)

    phase(f"13b. {LM_ARCH} at full width and depth: prefill against "
          f"token-by-token decode")
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"{LM_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_q_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab} (tied), {count_params(model):,} parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, drawn by a CUDA "
        f"generator seeded 0 in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_GATE_PROMPTS, LM_GATE_LEN))).to(dev)
    prefill = make_prefill_step(model)
    cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = prefill({"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if dict(cuda.LAUNCHES) != {"flash_attention_fwd": cfg.num_layers}:
        raise AssertionError(f"13b prefill launches {dict(cuda.LAUNCHES)}")
    launches["flash_attention_fwd"] += cfg.num_layers
    with torch.no_grad():
        full, _, _ = model(toks)
    cuda.reset_launches()
    t0 = time.perf_counter()
    with PlainCalls() as plain:
        dec = lm_tokenwise(model, toks, None, LM_GATE_LEN)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    want = {"flash_decode": cfg.num_layers * LM_GATE_LEN}
    if dict(cuda.LAUNCHES) != want or plain.calls:
        raise AssertionError(f"13b decode launches {dict(cuda.LAUNCHES)} != "
                             f"{want}; plain calls {plain.calls}")
    launches["flash_decode"] += want["flash_decode"]
    err_last = close_or_raise("13b the prefill step's last logits against "
                              "the serve step's", dec[:, -1], last,
                              **LM_GATE_TOL)
    err_all = close_or_raise("13b every position's logits, decode against "
                             "the full forward", dec, full, **LM_GATE_TOL)
    log(f"13b {LM_GATE_PROMPTS} prompts x {LM_GATE_LEN} tokens: the prefill "
        f"step in {prefill_s:.3f} s ({cfg.num_layers} flash forward "
        f"launches); {LM_GATE_LEN} serve steps in {dec_s:.2f} s "
        f"({dec_s / LM_GATE_LEN * 1e3:.2f} ms a step, "
        f"{cfg.num_layers * LM_GATE_LEN} decode launches, no plain "
        f"attention call); last logits max abs err {err_last:.3e}, every "
        f"position {err_all:.3e} (gate {LM_GATE_TOL})")
    del dec
    # the registered bf16 config on the same weights: top-1 against
    # float32's at every position, and at the prefill step's last positions
    bmodel = build_model(configs.get_config(LM_ARCH), device="meta")
    bmodel.load_state_dict(model.state_dict(), assign=True)
    with torch.no_grad():
        bfull, _, _ = bmodel(toks)
        blast = make_prefill_step(bmodel)({"tokens": toks})
    f, b_ = full.float(), bfull.float()
    top2 = torch.topk(f, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    agree = f.argmax(-1) == b_.argmax(-1)
    near = gap < LM_NEAR_TIE
    diff = (f - b_).abs().amax(-1)
    share = float(agree.float().mean())
    gq = torch.quantile(gap.flatten(), torch.tensor([0.1, 0.5], device=dev))
    log(f"13b bf16 ({LM_ARCH} as registered, the same weights): top-1 "
        f"equal to float32's at {int(agree.sum())} of {agree.numel()} "
        f"positions ({share:.1%}); of the {int((~agree).sum())} that differ, "
        f"{int((~agree & near).sum())} are near-ties (float32's top two "
        f"within {LM_NEAR_TIE}), the largest float32 gap among them "
        f"{float(gap[~agree].max()) if (~agree).any() else 0.0:.4f}; "
        f"float32's top-two gap p10 {float(gq[0]):.4f}, p50 "
        f"{float(gq[1]):.4f}; bf16 logits' max abs diff a position p50 "
        f"{float(diff.median()):.4f}, max {float(diff.max()):.4f}; logits' "
        f"max abs {float(f.abs().max()):.3f}")
    if share < LM_BF16_AGREE:
        raise AssertionError(f"13b bf16: top-1 agreement {share:.1%} under "
                             f"{LM_BF16_AGREE:.0%}")
    lgap = torch.topk(last.float(), 2, dim=-1).values
    lgap = lgap[:, 0] - lgap[:, 1]
    last_agree = last.float().argmax(-1) == blast.float().argmax(-1)
    if bool((~last_agree & (lgap >= LM_NEAR_TIE)).any()):
        raise AssertionError(f"13b bf16: the prefill step's top-1 differs "
                             f"from float32's away from a near-tie (gaps "
                             f"{lgap.tolist()}, equal {last_agree.tolist()})")
    log(f"13b bf16: the prefill step's last logits' top-1 equal to "
        f"float32's in {int(last_agree.sum())} of {last_agree.numel()} rows "
        f"(float32 gaps {', '.join(f'{g_:.4f}' for g_ in lgap.tolist())})")
    del bmodel, bfull, blast, full, f, b_, last, model
    torch.cuda.empty_cache()

    phase(f"13c. the LM Server at full width and {LM_SERVE_LAYERS} layers: "
          f"{LM_SERVE_REQUESTS} requests through {LM_SERVE_SLOTS} slots")
    cfg = dataclasses.replace(cfg, num_layers=LM_SERVE_LAYERS)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    rng = np.random.default_rng(131)
    lens = rng.integers(LM_SERVE_PROMPT[0], LM_SERVE_PROMPT[1] + 1,
                        LM_SERVE_REQUESTS)
    requests = [(uid, rng.integers(1, cfg.vocab_size, n), LM_SERVE_NEW)
                for uid, n in enumerate(lens)]
    for cache_dtype in ("float32", "int8"):
        srv, wall, ticks, counts, admitted, plain_calls, peak = lm_served(
            model, requests, cache_dtype, LM_SERVE_SLOTS, LM_SERVE_MAX_LEN)
        done = srv.done
        if sorted(done) != list(range(LM_SERVE_REQUESTS)) or any(
                len(r.generated) != LM_SERVE_NEW for r in done.values()):
            raise AssertionError(f"13c {cache_dtype}: requests "
                                 f"{sorted(done)} or lengths wrong")
        want = {"flash_decode": cfg.num_layers * srv.ticks}
        if counts != want or plain_calls:
            raise AssertionError(f"13c {cache_dtype}: launches {counts} != "
                                 f"{want}; plain calls {plain_calls}")
        launches["flash_decode"] += want["flash_decode"]
        checked = {int(np.argmin(lens)): "shortest",
                   int(np.argmax(lens)): "longest"}
        mid = sorted((t, u) for u, t in admitted.items()
                     if t > 0 and u not in checked)
        for t, u in (mid[0], mid[-1]):
            checked[u] = f"admitted at tick {t}"
        if len(checked) != 4:
            raise AssertionError(f"13c: {checked} are not 4 requests")
        _, equal, tied = solo_gate(model, requests, done, checked,
                                   cache_dtype, LM_SERVE_SLOTS,
                                   LM_SERVE_MAX_LEN, f"13c {cache_dtype}")
        n_tok = sum(len(r.generated) for r in done.values())
        tick_ms = np.asarray(ticks) * 1e3
        log(f"13c {cache_dtype} cache: {LM_SERVE_REQUESTS} requests (prompts "
            f"{lens.min()}-{lens.max()} tokens, {LM_SERVE_NEW} new each, "
            f"greedy) in {srv.ticks} ticks, {wall:.2f} s: "
            f"{n_tok / wall:.1f} generated tokens/s, "
            f"{(n_tok + int(lens.sum())) / wall:.1f} tokens/s with the "
            f"prompts; tick p50 {np.percentile(tick_ms, 50):.2f} ms, p99 "
            f"{np.percentile(tick_ms, 99):.2f} ms; {cfg.num_layers} decode "
            f"launches a tick, no plain attention call; peak memory "
            f"{peak / 2**30:.2f} GiB above the model's; "
            + solo_summary(equal, tied))
        if cache_dtype == "float32":     # the first ticks, profiled
            part = lambda: lm_served(  # noqa: E731
                model, requests, cache_dtype, LM_SERVE_SLOTS,
                LM_SERVE_MAX_LEN, max_ticks=LM_PROFILE_TICKS)
            device_profile(part, part()[1], ("tick", lambda: LM_PROFILE_TICKS),
                           f"13c LM server, float32 cache, its first "
                           f"{LM_PROFILE_TICKS} ticks")
        del srv
    del model
    torch.cuda.empty_cache()

    phase(f"13d. python -m repro_torch.launch.serve --arch {LM_ARCH}")
    work = ROOT / "build" / "phase13"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         LM_ARCH], cwd=work, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if run.returncode != 0:
        raise AssertionError(f"launch.serve exited {run.returncode}:\n"
                             f"{run.stderr[-3000:]}")
    served = [ln for ln in run.stderr.splitlines() if "served" in ln]
    if not served or "flash_decode" not in served[0]:
        raise AssertionError(f"launch.serve: no decode launch reported:\n"
                             f"{run.stderr[-2000:]}")
    log(f"13d launch.serve exited 0 in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(run.stderr.strip().splitlines()[:2] + served))

    phase("13e. stablelm-3b, granite-20b, internvl2-26b at full width and "
          f"{LM_SHALLOW_LAYERS} layers")
    for arch in LM_SHALLOW_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch),
                                  num_layers=LM_SHALLOW_LAYERS,
                                  dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(1)
        model = build_model(cfg, device=dev, generator=gen)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, LM_SHALLOW_TOKENS))).to(dev)
        prefix = None
        if cfg.vision_prefix:
            prefix = torch.randn((2, cfg.vision_prefix, cfg.d_model),
                                 generator=gen, device=dev)
        p = 0 if prefix is None else cfg.vision_prefix
        cuda.reset_launches()
        with torch.no_grad():
            full, _, _ = model(toks, prefix_embeds=prefix)
            with PlainCalls() as plain:
                dec = lm_tokenwise(model, toks, prefix, p + LM_SHALLOW_TOKENS)
        torch.cuda.synchronize()
        want = {"flash_attention_fwd": cfg.num_layers,
                "flash_decode": cfg.num_layers * LM_SHALLOW_TOKENS}
        if dict(cuda.LAUNCHES) != want or plain.calls:
            raise AssertionError(f"13e {arch}: launches "
                                 f"{dict(cuda.LAUNCHES)} != {want}; plain "
                                 f"calls {plain.calls}")
        for name, n in want.items():
            launches[name] += n
        err = close_or_raise(f"13e {arch} decode against the full forward",
                             dec, full[:, p:], **LM_GATE_TOL)
        log(f"13e {arch}: {count_params(model):,} parameters at "
            f"{cfg.num_layers} layers ({count_params(model) * 4 / 2**30:.2f} "
            f"GiB), {cfg.num_q_heads}/{cfg.num_kv_heads} heads x "
            f"{cfg.resolved_head_dim}"
            + (f", a {p}-token prefix decoded as one chunk" if p else "")
            + f": {LM_SHALLOW_TOKENS} tokens x 2, decode against the full "
            f"forward max abs err {err:.3e}")
        del model, full, dec
        torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: LM training; gemma2's windowed, softcapped attention
# ---------------------------------------------------------------------------

def window_pairs(s, window):
    """(q, k) pairs a causal row of length s admits under a window."""
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def lm_train_kernels(gen, dev, max_err, records):
    """Phase 14a: the flash forward, dq and dk/dv at phi4-mini's train
    attention (float32 and bf16) and gemma2's local layer, and the decode
    at gemma2's tick with its window and softcap, against their plain
    versions (phase 3's tolerances; float32 gradients against the plain
    backward of float64 inputs) and timed as phase 6 times; the rows nest
    in the kernels' records ("lm_train_*", "gemma2_*")."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops
    F = torch.nn.functional
    f32, bf16 = torch.float32, torch.bfloat16
    gcfg = configs.get_config(GEMMA_ARCH)
    gopts = dict(causal=True, window=gcfg.window, softcap=gcfg.attn_softcap,
                 scale=gcfg.query_scale ** -0.5)
    cases = {
        "lm_train": (LM_TRAIN_B, 24, 8, LM_TRAIN_S, 128, dict(causal=True),
                     f32),
        "lm_train_bf16": (LM_TRAIN_B, 24, 8, LM_TRAIN_S, 128,
                          dict(causal=True), bf16),
        "gemma2_local": (1, 32, 16, GEMMA_LOCAL_S, 128, gopts, f32)}
    timings = {}
    for name, (b, hq, hkv, s, d, opts, dt) in cases.items():
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((b, hq, s, d), (b, hkv, s, d),
                                     (b, hkv, s, d), (b, hq, s, d)))
        key = "float32" if dt == f32 else "bfloat16"
        out, lse = fa.flash_attention_fwd(q, k, v, **opts)
        again, _ = fa.flash_attention_fwd(q, k, v, **opts)
        want, want_lse = fa.flash_fwd_plain(q, k, v, **opts)
        err = close_or_raise(f"14a flash forward {name}", out, want,
                             **FLASH_TOL[key])
        close_or_raise(f"14a flash forward {name} lse", lse, want_lse,
                       atol=1e-4, rtol=1e-5)
        got = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
        got2 = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
        wide = torch.float64 if dt == f32 else dt
        wantg = fab.flash_bwd_plain(q.to(wide), k.to(wide), v.to(wide),
                                    out.to(wide), lse, do.to(wide), **opts)
        if not (torch.equal(out, again) and all(
                torch.equal(a, b_) for a, b_ in zip(got, got2))):
            raise AssertionError(f"14a {name}: not bitwise repeatable")
        gerr = {}
        for which, a, w in zip(("dq", "dk", "dv"), got, wantg):
            gerr[which] = close_or_raise(f"14a flash {which} {name}", a,
                                         w.to(dt), **FLASH_GRAD_TOL[key])
        if dt == f32:
            max_err["flash_attention_fwd"] = max(
                max_err["flash_attention_fwd"], err)
            max_err["flash_attention_dq"] = max(
                max_err["flash_attention_dq"], gerr["dq"])
            max_err["flash_attention_dkv"] = max(
                max_err["flash_attention_dkv"], gerr["dk"], gerr["dv"])
        log(f"14a flash {name}: {b} x {hq}/{hkv} heads x {s} x {d}, {key}, "
            f"{opts}: max abs err out {err:.3e}, dq {gerr['dq']:.3e}, dk "
            f"{gerr['dk']:.3e}, dv {gerr['dv']:.3e}; bitwise repeatable")
        delta = torch.sum(do.float() * out.float(), dim=-1)
        es = q.element_size()
        pairs = b * hq * window_pairs(s, opts.get("window"))
        qb, kb, row = b * hq * s * d * es, b * hkv * s * d * es, b * hq * s * 4
        rate = SPLIT_TF32_FLOP_PER_S if dt == f32 else BF16_FLOP_PER_S
        library = lib_bwd = None
        if not opts.get("softcap"):
            lq, lk, lv = (t_.detach().clone().requires_grad_(True)
                          for t_ in (q, k, v))
            lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                                  enable_gqa=True)
            library = lambda q=q, k=k, v=v: \
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
            lib_bwd = lambda lout=lout, lq=lq, lk=lk, lv=lv, do=do: \
                torch.autograd.grad(lout, (lq, lk, lv), do, retain_graph=True)
        plain_bwd = lambda q=q, k=k, v=v, out=out, lse=lse, do=do, opts=opts: \
            fab.flash_bwd_plain(q, k, v, out, lse, do, **opts)
        shape = f"{b} x {hq}/{hkv} heads x {s} x {d}, {key}"
        timings[("flash_attention_fwd", name)] = dict(
            fn=lambda q=q, k=k, v=v, opts=opts: fa.flash_attention_fwd(
                q, k, v, **opts),
            plain=lambda q=q, k=k, v=v, opts=opts: fa.flash_fwd_plain(
                q, k, v, **opts),
            library=library, bytes=2 * qb + 2 * kb + row,
            flops=2 * pairs * 2 * d, rate=rate, shape=shape)
        timings[("flash_attention_dq", name)] = dict(
            fn=lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, opts=opts:
            fab.flash_attention_dq(q, k, v, do, lse, delta, **opts),
            plain=plain_bwd, library=lib_bwd, bytes=3 * qb + 2 * kb + 2 * row,
            flops=2 * pairs * 3 * d, rate=rate, shape=shape)
        timings[("flash_attention_dkv", name)] = dict(
            fn=lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, opts=opts:
            fab.flash_attention_dkv(q, k, v, do, lse, delta, **opts),
            plain=plain_bwd, library=lib_bwd, bytes=2 * qb + 4 * kb + 2 * row,
            flops=2 * pairs * 4 * d, rate=rate, shape=shape)
    # the decode at gemma2's tick: 2 slots x 32/16 heads x 128, one row at
    # each cursor, the window and the softcap; rows past the cursors NaN
    window, softcap = gcfg.window, gcfg.attn_softcap
    scale = gcfg.query_scale ** -0.5
    for cursors, tag in ((GEMMA_TICK_CURSORS, ""),
                         (GEMMA_SHORT_CURSORS, " (window past the cursors)")):
        for cd in ("float32", "bfloat16", "int8"):
            for qd in (f32, bf16):
                q, k, v, kvl, opts = lm_decode_case(
                    gen, dev, b=2, hq=32, hkv=16, d=128, s=GEMMA_CACHE_ROWS,
                    cursors=list(cursors), cache_dtype=cd, q_dtype=qd)
                q = (q.float() * 20).to(qd)      # scores the softcap bends
                opts["q_times"] = (kvl[:, None] - 1).contiguous()
                opts["k_times"] = torch.arange(
                    GEMMA_CACHE_ROWS, dtype=torch.int32, device=dev)[
                        None].expand(2, GEMMA_CACHE_ROWS).contiguous()
                opts.update(window=window, softcap=softcap, scale=scale)
                run = lambda q=q, k=k, v=v, kvl=kvl, opts=opts: \
                    ops.decode_attention(q, k, v, kv_length=kvl, layer=1,
                                         impl="flash_decode", **opts)
                got, again = run(), run()
                want = ops.decode_attention(q, k, v, kv_length=kvl, layer=1,
                                            impl="plain", **opts)
                what = f"{cd} cache, {str(qd)[6:]} query{tag}"
                err = close_or_raise(
                    f"14a flash_decode gemma2 {what}", got, want,
                    **DECODE_TOL["bfloat16" if qd == bf16 else cd])
                if not torch.equal(got, again):
                    raise AssertionError(f"14a flash_decode gemma2 {what}: "
                                         f"not bitwise repeatable")
                max_err["flash_decode"] = max(max_err["flash_decode"], err)
                log(f"14a flash_decode gemma2 tick {what}: cursors "
                    f"{list(cursors)}, window {window}, softcap {softcap}: "
                    f"max abs err {err:.3e}, bitwise repeatable")
                nest = {("float32", f32): "gemma2_tick",
                        ("bfloat16", bf16): "gemma2_tick_bf16",
                        ("int8", bf16): "gemma2_tick_int8_bf16q"}.get(
                            (cd, qd))
                if tag or nest is None:
                    continue
                # the keys the window admits are all the work needs
                live = sum(min(int(c), window) for c in cursors)
                es = k.element_size()
                timings[("flash_decode", nest)] = dict(
                    fn=run, plain=lambda q=q, k=k, v=v, kvl=kvl, opts=opts:
                    ops.decode_attention(q, k, v, kv_length=kvl, layer=1,
                                         impl="plain", **opts),
                    library=None,
                    bytes=live * 16 * 2 * 128 * es
                    + (live * 16 * 2 * 4 if cd == "int8" else 0)
                    + 2 * 2 * 32 * 128 * q.element_size() + 2 * 4,
                    flops=2 * live * 32 * 2 * 128,
                    rate=SPLIT_TF32_FLOP_PER_S if cd == "float32"
                    else BF16_FLOP_PER_S,
                    shape=f"gemma2 tick {what}: 2 slots x 32/16 x 128, "
                          f"{live} rows in the window")
    for (kernel, name), tm in timings.items():
        big = name == "gemma2_local"
        ms = time_ms(tm["fn"], batches=5 if big else 20,
                     per_batch=2 if big else 10)
        plain_ms = time_ms(tm["plain"], batches=2 if big else 5,
                           per_batch=1 if big else 4, warmup=1)
        library_ms = (time_ms(tm["library"], batches=5 if big else 20)
                      if tm["library"] else None)
        # CUPTI for the kernel and the library call (the plain versions by
        # events only: a profiler session costs about a second)
        device = {"ms": kernel_ms(tm["fn"], reps=3 if big else 20)}
        if tm["library"]:
            device["library_ms"] = kernel_ms(tm["library"])
        byte_ms = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        flop_ms = tm["flops"] / tm["rate"] * 1e3
        nested = {"ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(byte_ms, flop_ms),
                  "bound_by": "bytes" if byte_ms >= flop_ms
                  else "operations", "library_ms": library_ms,
                  "bound_f32_ms": max(byte_ms,
                                      tm["flops"] / F32_FLOP_PER_S * 1e3)}
        owner = next(r for r in records if r["name"] == kernel)
        owner[name] = nested
        log(json.dumps({"kernel": kernel, "row": name, "shape": tm["shape"],
                        **nested, "device_time_ms": device}))


def lm_model(arch, dev, seed=0, **overrides):
    """A registered LM config (``overrides`` replaced) at full width on the
    card, weights from a CUDA generator seeded ``seed``."""
    import torch
    from repro_torch import configs
    from repro_torch.nn.transformer import build_model
    cfg = dataclasses.replace(configs.get_config(arch), **overrides)
    return build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))


def lm_batch(cfg, b, s, index, dev):
    """``b`` synthetic_lm sequences of ``s`` tokens (seed 0, from
    ``index``) on the card, with a zero prefix where the config takes one."""
    import torch
    from repro_torch.launch.train import make_batch_fn
    batch = make_batch_fn(cfg, s)(0, index, b)
    return {k_: torch.as_tensor(v_, device=dev) for k_, v_ in batch.items()}


def lm_grad_check(arch, layers, b, s, dev, launches, tag="14b"):
    """Phase 14b: one batch's gradients through the kernels against the
    plain versions, float32, every parameter tensor within
    TRAIN_GRAD_REL_TOL of its largest |g| and finite (phase 5's rule:
    :func:`grads_close_or_raise`); launches exact (the forward
    twice a layer under remat), no plain attention call on the kernel
    side."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.nn.module import count_params
    from repro_torch.optim import sgd
    from repro_torch.runtime.steps import make_train_step
    model = lm_model(arch, dev, num_layers=layers, dtype="float32")
    batch = lm_batch(model.cfg, b, s, 0, dev)
    step = make_train_step(model, sgd(0.0))
    cuda.reset_launches()
    with PlainCalls() as plain:
        kg, km = step.grads(batch)
        torch.cuda.synchronize()
    want = {"flash_attention_fwd": 2 * layers, "flash_attention_dq": layers,
            "flash_attention_dkv": layers}
    if dict(cuda.LAUNCHES) != want or plain.calls:
        raise AssertionError(f"{tag} {arch}: launches {dict(cuda.LAUNCHES)} "
                             f"!= {want}; plain calls {plain.calls}")
    for name, n in want.items():
        launches[name] += n
    model.impl = "plain"
    pg, pm = step.grads(batch)
    if sorted(kg) != sorted(pg):
        raise AssertionError(f"{tag} {arch}: the two sides' tensors differ")
    worst, worst_name = grads_close_or_raise(f"{tag} {arch}", kg, pg,
                                             TRAIN_GRAD_REL_TOL)
    log(f"{tag} {arch} at full width and {layers} layers "
        f"({count_params(model):,} parameters), {b} x {s} tokens, float32: "
        f"loss {float(km['loss']):.5f} (plain {float(pm['loss']):.5f}); "
        f"{len(kg)} gradient tensors, the largest difference "
        f"{worst:.2e} of its tensor's max |g| ({worst_name}); launches "
        f"{want}, no plain attention call")
    del model, kg, pg
    torch.cuda.empty_cache()


def lm_train_full(dev, launches):
    """Phase 14c: phi4-mini-3.8b at full width and depth, bf16 compute,
    float32 master weights: launch/train's AdamW chain, then adafactor."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.nn.module import count_params
    from repro_torch.optim import (adafactor, adamw, chain,
                                   clip_by_global_norm, warmup_cosine)
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.training.steps import loss_summary
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = lm_model(LM_ARCH, dev)
    cfg = model.cfg
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    n_params = count_params(model)
    batches = [lm_batch(cfg, LM_TRAIN_B, LM_TRAIN_S, i * LM_TRAIN_B, dev)
               for i in range(LM_TRAIN_STEPS + 1)]
    per_step = {"flash_attention_fwd": 2 * cfg.num_layers,
                "flash_attention_dq": cfg.num_layers,
                "flash_attention_dkv": cfg.num_layers}

    def run(opt, n, what):
        params = dict(model.named_parameters())
        state = opt.init(params)
        step = make_train_step(model, opt, remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        cuda.reset_launches()
        with PlainCalls() as plain:
            for i in range(n):
                t0 = time.perf_counter()
                grads, metrics = step.grads(batches[i])
                loss = float(metrics["loss"])
                state = step.update(state, grads)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(loss)
        want = {k_: v_ * n for k_, v_ in per_step.items()}
        if dict(cuda.LAUNCHES) != want or plain.calls:
            raise AssertionError(f"14c {what}: launches {dict(cuda.LAUNCHES)}"
                                 f" != {want}; plain calls {plain.calls}")
        for k_, v_ in want.items():
            launches[k_] += v_
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"14c {what}: losses {losses}")
        peak = torch.cuda.max_memory_allocated() - base - weights
        return losses, secs, peak, step, state

    opt = chain(clip_by_global_norm(1.0),
                adamw(warmup_cosine(LM_TRAIN_LR, 20, LM_TRAIN_STEPS)))
    losses, secs, peak, step, state = run(opt, LM_TRAIN_STEPS, "AdamW")
    ends = loss_summary(losses)
    if not ends["loss_last"] < ends["loss_first"]:
        raise AssertionError(f"14c AdamW: the loss did not fall: {losses}")
    med = statistics.median(secs[1:])
    log(f"14c {LM_ARCH} at full width and depth ({cfg.num_layers} layers, "
        f"{n_params:,} parameters, {weights / 2**30:.2f} GiB of float32 "
        f"weights), compute {cfg.dtype}, remat, {LM_TRAIN_STEPS} AdamW steps "
        f"of {LM_TRAIN_B} x {LM_TRAIN_S} synthetic_lm tokens (vocab "
        f"{cfg.vocab_size}), peak lr {LM_TRAIN_LR}: loss "
        f"{ends['loss_first']:.4f} -> {ends['loss_last']:.4f} (5-step means; "
        f"{', '.join(f'{x:.3f}' for x in losses)}); {1 / med:.3f} steps/s, "
        f"{LM_TRAIN_B * LM_TRAIN_S / med:.0f} tokens/s (median step "
        f"{med:.3f} s, the first {secs[0]:.3f} s); peak memory "
        f"{peak / 2**30:.2f} GiB above the weights (AdamW moments "
        f"{2 * weights / 2**30:.2f} GiB of it); launches a step {per_step}, "
        f"no plain attention call")
    # one step profiled
    batch = batches[LM_TRAIN_STEPS]

    def one():
        g, _ = step.grads(batch)
        return step.update(state, g)

    def counted(what, fn):
        """``fn()`` with the launches gated at one step's, as in run()."""
        cuda.reset_launches()
        with PlainCalls() as plain:
            out = fn()
            torch.cuda.synchronize()
        if dict(cuda.LAUNCHES) != per_step or plain.calls:
            raise AssertionError(f"14c {what}: launches {dict(cuda.LAUNCHES)}"
                                 f" != {per_step}; plain calls {plain.calls}")
        for k_, v_ in per_step.items():
            launches[k_] += v_
        return out

    t0 = time.perf_counter()
    state = counted("the unprofiled step", one)
    wall = time.perf_counter() - t0
    busy = counted("the profiled step", lambda: device_profile(
        one, wall, ("step", lambda: 1), f"14c {LM_ARCH} AdamW train step"))
    del state, step
    torch.cuda.empty_cache()
    a_losses, a_secs, a_peak, _, _ = run(
        chain(clip_by_global_norm(1.0), adafactor(1e-4)),
        LM_ADAFACTOR_STEPS, "adafactor")
    log(f"14c adafactor (clip 1.0, lr 1e-4; the dry-run's pairing): "
        f"{LM_ADAFACTOR_STEPS} steps, loss "
        f"{', '.join(f'{x:.4f}' for x in a_losses)}"
        f", median step {statistics.median(a_secs):.3f} s; peak memory "
        f"{a_peak / 2**30:.2f} GiB above the weights against AdamW's "
        f"{peak / 2**30:.2f}; busy share of the AdamW step "
        + ("not measured" if busy is None else f"{busy:.1%}"))
    del model, batches
    torch.cuda.empty_cache()


def lm_trainer_check(dev, launches):
    """Phase 14d: the Trainer on stablelm-3b's LM step at full width and
    TRAINER_LAYERS layers: TRAINER_STEPS_LM steps with a save at TRAINER_CKPT_AT, then a
    step whose loss is reported NaN (skipped: the parameters and AdamW state
    bitwise as they were); a second Trainer from the TRAINER_CKPT_AT
    checkpoint to TRAINER_STEPS_LM (the reference's restart tolerance); the
    seconds of the saves' host part and of a restore."""
    import shutil

    import torch
    from repro_torch import obs
    from repro_torch.data import ShardedIterator
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.nn.module import count_params
    from repro_torch.optim import adamw, chain, clip_by_global_norm
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    work = ROOT / "build" / "phase14d"
    shutil.rmtree(work, ignore_errors=True)

    def trainer(total, ckpt_every, seed, registry=None):
        model = lm_model(TRAINER_ARCH, dev, seed=seed,
                         num_layers=TRAINER_LAYERS, dtype="float32")
        opt = chain(clip_by_global_norm(1.0), adamw(3e-3))
        data = ShardedIterator(make_batch_fn(model.cfg, 128), batch_size=4,
                               seed=0)
        return Trainer(make_train_step(model, opt), model,
                       opt.init(dict(model.named_parameters())), data,
                       str(work), TrainerConfig(total_steps=total,
                                                ckpt_every=ckpt_every,
                                                log_every=100),
                       registry=registry)

    def state(tr):
        return [t_.detach().clone() for t_ in
                list(tr.model.state_dict().values())
                + _tensor_leaves(tr.opt_state)]

    cuda.reset_launches()
    reg = obs.Registry()
    full = trainer(TRAINER_STEPS_LM + 1, TRAINER_CKPT_AT, 0, reg)
    n_params = count_params(full.model)
    inner, seen = full.step_fn, {}

    def nan_last(batch):
        g, m = inner.grads(batch)
        if full.step == TRAINER_STEPS_LM:    # the step after the last
            seen["before"] = state(full)
            m = dict(m, loss=torch.tensor(float("nan"), device=dev))
        return g, m

    full.step_fn = dataclasses.replace(inner, grads=nan_last)
    t0 = time.perf_counter()
    full.run()
    run_s = time.perf_counter() - t0
    full.data.close()
    if full.nan_guard.total_skipped != 1 or not all(
            torch.equal(a, b_) for a, b_ in zip(seen["before"],
                                                state(full))):
        raise AssertionError("14d: the NaN-reported step changed the state")
    del seen
    saves = [ev["dur"] / 1e6 for ev in reg.events()
             if ev.get("ph") == "X" and ev["name"] == "trainer.checkpoint"]
    # keep the step-4 checkpoint only: the restart must start there
    size = 0
    for d_ in work.iterdir():
        if d_.name.startswith("step_") and \
                int(d_.name.split("_")[1].split(".")[0]) > TRAINER_CKPT_AT:
            size = max(size, sum(f.stat().st_size for f in d_.rglob("*")
                                 if f.is_file()))
            shutil.rmtree(d_)
    again = trainer(TRAINER_STEPS_LM, 10 ** 6, 1)
    t0 = time.perf_counter()
    if not again.restore_if_available():
        raise AssertionError("14d: no checkpoint to restore")
    restore_s = time.perf_counter() - t0
    if again.step != TRAINER_CKPT_AT or again.data.cursor != TRAINER_CKPT_AT:
        raise AssertionError(f"14d: restored step {again.step}, cursor "
                             f"{again.data.cursor}")
    again.run()
    again.data.close()
    hist_a = full.history[TRAINER_CKPT_AT:]
    if len(hist_a) != len(again.history) or any(
            abs(x - y) > RESTART_LOSS_RTOL * abs(y)
            for x, y in zip(hist_a, again.history)):
        raise AssertionError(f"14d restart: losses {again.history} != "
                             f"{hist_a}")
    a_sd, b_sd = full.model.state_dict(), again.model.state_dict()
    worst = 0.0
    for name, t_ in a_sd.items():
        close_or_raise(f"14d restart {name}", b_sd[name], t_,
                       atol=RESTART_PARAM_ATOL, rtol=RESTART_LOSS_RTOL)
        worst = max(worst, float((b_sd[name] - t_).abs().max()))
    counts = dict(cuda.LAUNCHES)
    steps_run = 2 * TRAINER_STEPS_LM - TRAINER_CKPT_AT + 1
    want = {"flash_attention_fwd": 2 * TRAINER_LAYERS * steps_run,
            "flash_attention_dq": TRAINER_LAYERS * steps_run,
            "flash_attention_dkv": TRAINER_LAYERS * steps_run}
    if counts != want:
        raise AssertionError(f"14d launches {counts} != {want}")
    for k_, v_ in want.items():
        launches[k_] += v_
    log(f"14d Trainer on {TRAINER_ARCH} at full width and {TRAINER_LAYERS} "
        f"layers ({n_params:,} parameters): {TRAINER_STEPS_LM} steps and a "
        f"NaN-reported one (skipped, the parameters and AdamW state bitwise "
        f"unchanged), saves at {TRAINER_CKPT_AT}, {TRAINER_STEPS_LM} and "
        f"{TRAINER_STEPS_LM + 1}, in {run_s:.1f} s; trainer.checkpoint spans "
        f"(the host copy and CRC on the training thread) "
        + ", ".join(f"{x:.2f} s" for x in saves)
        + f", {size / 2**30:.2f} GiB a checkpoint; a second Trainer restored "
        f"step {TRAINER_CKPT_AT} in {restore_s:.2f} s and ran to "
        f"{TRAINER_STEPS_LM}: losses within rtol {RESTART_LOSS_RTOL}, "
        f"parameters within atol {RESTART_PARAM_ATOL} (max {worst:.2e}); "
        f"launches {counts}")
    shutil.rmtree(work, ignore_errors=True)
    del full, again
    torch.cuda.empty_cache()


def _tensor_leaves(node):
    """The tensors of an optimizer state (tuples, dicts, ints), in order."""
    import torch
    if isinstance(node, torch.Tensor):
        return [node]
    if isinstance(node, dict):
        return [t_ for k_ in sorted(node) for t_ in _tensor_leaves(node[k_])]
    if isinstance(node, (tuple, list)):
        return [t_ for x in node for t_ in _tensor_leaves(x)]
    return []


def lm_launch_train():
    """Phase 14e: python -m repro_torch.launch.train on the card, reduced,
    then run again to resume from its checkpoint."""
    import os
    import shutil
    work = ROOT / "build" / "phase14e"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = []
    for steps in (LAUNCH_TRAIN_STEPS, LAUNCH_TRAIN_STEPS + LAUNCH_TRAIN_CKPT):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             LM_ARCH, "--reduced", "--steps", str(steps), "--ckpt-every",
             str(LAUNCH_TRAIN_CKPT), "--ckpt-dir", str(work / "ckpt")],
            cwd=work, capture_output=True, text=True, timeout=300, env=env)
        if run.returncode != 0:
            raise AssertionError(f"launch.train exited {run.returncode}:\n"
                                 f"{run.stderr[-3000:]}")
        losses = [float(x) for x in re.findall(r"step \d+ loss ([\d.]+)",
                                               run.stderr)]
        logs.append((time.perf_counter() - t0, losses, run.stderr))
    (s1, l1, _), (s2, l2, err2) = logs
    if len(l1) != LAUNCH_TRAIN_STEPS // 10 or not l1[-1] < l1[0]:
        raise AssertionError(f"launch.train: logged losses {l1}")
    if f"restored from step {LAUNCH_TRAIN_STEPS}" not in err2 or len(l2) != 1:
        raise AssertionError(f"launch.train did not resume:\n{err2[-2000:]}")
    log(f"14e launch.train --arch {LM_ARCH} --reduced --steps "
        f"{LAUNCH_TRAIN_STEPS} --ckpt-every {LAUNCH_TRAIN_CKPT}: exit 0 in "
        f"{s1:.1f} s, logged losses {l1}; run again to "
        f"{LAUNCH_TRAIN_STEPS + LAUNCH_TRAIN_CKPT} steps: resumed from step "
        f"{LAUNCH_TRAIN_STEPS}, exit 0 in {s2:.1f} s, loss {l2}")
    shutil.rmtree(work, ignore_errors=True)


def gemma2_serving(dev, launches):
    """Phase 14f: gemma2-27b at full width and GEMMA_LAYERS layers (float32
    weights): two prompts prefilled into their slots, GEMMA_NEW decode steps
    with per-slot cursors, every decoded position held to the full forward
    over the whole sequence; float32 and int8 caches."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.nn.module import count_params
    model = lm_model(GEMMA_ARCH, dev, num_layers=GEMMA_LAYERS,
                     dtype="float32")
    cfg = model.cfg
    rng = np.random.default_rng(14)
    seqs = [torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, n + GEMMA_NEW))).to(dev)
        for n in GEMMA_PROMPTS]
    max_len = max(GEMMA_PROMPTS) + GEMMA_NEW
    # the full forward over each whole sequence: the prefill's last
    # position and every decoded one
    wants = []
    with torch.no_grad():
        for n, seq in zip(GEMMA_PROMPTS, seqs):
            full, _, _ = model(seq)
            wants.append(full[0, n - 1:n + GEMMA_NEW - 1].float().clone())
            del full
    torch.cuda.empty_cache()
    want = torch.stack(wants)                        # (2, GEMMA_NEW, vocab)
    calls = []
    real = fd.flash_decode

    def seen(*a, **kw):
        calls.append((kw.get("window"), kw.get("softcap")))
        return real(*a, **kw)

    for cache_dtype in ("float32", "int8"):
        calls.clear()
        cuda.reset_launches()
        fd.flash_decode = seen
        try:
            with torch.no_grad(), PlainCalls() as plain:
                t0 = time.perf_counter()
                caches, firsts = [], []
                for n, seq in zip(GEMMA_PROMPTS, seqs):
                    cache = model.init_cache(1, max_len, cache_dtype)
                    lg, _, cache = model(seq[:, :n], cache=cache,
                                         cache_index=0)
                    firsts.append(lg[0, -1].float())
                    caches.append(cache)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                cache = {g: {h: {k_: torch.cat([c[g][h][k_] for c in caches],
                                               1).contiguous()
                                 for k_ in caches[0][g][h]}
                             for h in caches[0][g]} for g in caches[0]}
                del caches
                outs, ticks = [torch.stack(firsts)[:, None]], []
                for i in range(GEMMA_NEW - 1):
                    idx = torch.tensor([n + i for n in GEMMA_PROMPTS],
                                       device=dev)
                    tok = torch.stack([seq[0, n + i] for n, seq in
                                       zip(GEMMA_PROMPTS, seqs)])[:, None]
                    t0 = time.perf_counter()
                    lg, _, cache = model(tok, cache=cache, cache_index=idx)
                    outs.append(lg.float())
                    torch.cuda.synchronize()
                    ticks.append(time.perf_counter() - t0)
                got = torch.cat(outs, 1)
        finally:
            fd.flash_decode = real
        ticks_n = GEMMA_NEW - 1
        want_launch = {"flash_decode": GEMMA_LAYERS * (len(GEMMA_PROMPTS)
                                                       + ticks_n)}
        local = sum(1 for w, c in calls if w == cfg.window
                    and c == cfg.attn_softcap)
        glob = sum(1 for w, c in calls if w is None
                   and c == cfg.attn_softcap)
        if dict(cuda.LAUNCHES) != want_launch or plain.calls or \
                local != glob or local + glob != len(calls):
            raise AssertionError(f"14f {cache_dtype}: launches "
                                 f"{dict(cuda.LAUNCHES)} != {want_launch}; "
                                 f"plain calls {plain.calls}; windowed "
                                 f"{local}, global {glob} of {len(calls)}")
        launches["flash_decode"] += want_launch["flash_decode"]
        tol = LM_GATE_TOL if cache_dtype == "float32" else MODEL_TOL["int8"]
        err = close_or_raise(f"14f gemma2 {cache_dtype} cache: decode "
                             f"against the full forward", got, want, **tol)
        tick_ms = np.asarray(ticks) * 1e3
        log(f"14f {GEMMA_ARCH} at full width and {GEMMA_LAYERS} layers "
            f"({count_params(model):,} parameters, float32), {cache_dtype} "
            f"cache: prompts of {GEMMA_PROMPTS} tokens prefilled in "
            f"{prefill_s:.2f} s, {GEMMA_NEW} positions a prompt against the "
            f"full forward: max abs err {err:.3e} (gate {tol}); tick p50 "
            f"{np.percentile(tick_ms, 50):.2f} ms, p99 "
            f"{np.percentile(tick_ms, 99):.2f} ms at cursors "
            f"{GEMMA_PROMPTS[0]}-{GEMMA_PROMPTS[1] + GEMMA_NEW}; decode "
            f"launches {want_launch['flash_decode']}, {local} with the "
            f"window {cfg.window} and softcap {cfg.attn_softcap}, {glob} "
            f"with the softcap alone; no plain attention call")
        del cache, got
    del model, want
    torch.cuda.empty_cache()


def lm_train_phase(launches, max_err, records):
    """Phase 14: LM training and gemma2 (see the module docstring)."""
    import torch
    import gc
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14 starts with {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated by earlier phases")
    phase("14a. LM training and gemma2: the flash kernels at the train "
          "shapes, the decode with a window and a softcap")
    gen = torch.Generator(device=dev).manual_seed(14)
    lm_train_kernels(gen, dev, max_err, records)
    log(f"14a: {time.perf_counter() - t_phase:.1f} s")
    phase("14b. gradients through the kernels against the plain versions")
    for arch, layers, b, s in LM_GRAD_CASES:
        lm_grad_check(arch, layers, b, s, dev, launches)
    phase(f"14c. {LM_ARCH} trains at full width and depth")
    lm_train_full(dev, launches)
    phase(f"14d. the Trainer on an LM step ({TRAINER_ARCH}, "
          f"{TRAINER_LAYERS} layers)")
    lm_trainer_check(dev, launches)
    phase("14e. python -m repro_torch.launch.train")
    lm_launch_train()
    phase(f"14f. {GEMMA_ARCH} at full width and {GEMMA_LAYERS} layers: "
          f"windowed, softcapped decode")
    gemma2_serving(dev, launches)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: MoE with MLA (deepseek-v2-lite-16b, kimi-k2-1t-a32b)
# ---------------------------------------------------------------------------

def mla_kernels(gen, dev, max_err, records):
    """Phase 15a: the decode at MLA's absorbed shapes (16 query heads
    against one latent kv head, D = r + dr = 576, the values the rows'
    first r = 512 columns, read in place at the rows' pitch) and the flash
    forward, dq and dk/dv at MLA's full forward (16 / 16 heads, D 192, Dv
    128, causal) against their plain versions (phase 3's tolerances), timed
    as phase 6 times beside SDPA; the rows nest in the kernels' records
    ("mla_*")."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops
    F = torch.nn.functional
    f32, bf16 = torch.float32, torch.bfloat16
    cfg = configs.get_config(MOE_ARCH)
    m, hq = cfg.mla, cfg.num_q_heads
    r, dr = m.kv_lora_rank, m.qk_rope_dim
    scale = (m.qk_nope_dim + dr) ** -0.5
    rng = np.random.default_rng(15)
    tick = [MLA_TICK_CURSOR, 1] + [int(c) for c in rng.integers(
        MLA_TICK_CURSOR - 64, MLA_TICK_CURSOR + 1, MLA_SLOTS - 2)]
    gate = MOE_GATE_LEN + MOE_GATE_NEW
    # (slots, query rows a slot, cache rows, cursors, cache dtype, q dtype)
    decode_checks = {
        "mla_tick": (MLA_SLOTS, 1, gate, tick, "float32", f32),
        "mla_tick_bf16": (MLA_SLOTS, 1, gate, tick, "bfloat16", bf16),
        "mla_prefill": (MOE_GATE_PROMPTS, MOE_GATE_LEN, gate,
                        [MOE_GATE_LEN] * MOE_GATE_PROMPTS, "float32", f32)}
    timings = {}
    for name, (b, sq, s, cursors, cd, qd) in decode_checks.items():
        rows = torch.randn((2, b, 1, s, r + dr), generator=gen, device=dev)
        kvl = torch.as_tensor(cursors, dtype=torch.int32, device=dev)
        past = torch.arange(s, device=dev)[None, :] >= kvl[:, None].long()
        rows = torch.where(past[None, :, None, :, None], float("nan"),
                           rows).to(getattr(torch, cd)).contiguous()
        q = torch.randn((b, hq, sq, r + dr), generator=gen, device=dev).to(qd)
        opts = dict(scale=scale)
        cols = torch.arange(s, device=dev)
        mask = (cols[None, :] < kvl[:, None].long())[:, None, None, :]
        if sq > 1:
            opts["q_times"] = (kvl[:, None] - sq + torch.arange(
                sq, device=dev)).int().contiguous()
            opts["k_times"] = cols.int()[None].expand(b, s).contiguous()
            mask = mask & (cols[None, None, None, :]
                           <= opts["q_times"][:, None, :, None])
        v = rows[..., :r]                      # the latent: a column view
        run = lambda q=q, rows=rows, v=v, kvl=kvl, opts=opts: \
            ops.decode_attention(q, rows, v, kv_length=kvl, layer=1,
                                 impl="flash_decode", **opts)
        got, again = run(), run()
        copy = ops.decode_attention(q, rows, v.contiguous(), kv_length=kvl,
                                    layer=1, impl="flash_decode", **opts)
        want = ops.decode_attention(q, rows, v, kv_length=kvl, layer=1,
                                    impl="plain", **opts)
        torch.cuda.synchronize()
        what = f"{name}: {cd} cache, {str(qd)[6:]} query"
        err = close_or_raise(f"15a flash_decode {what}", got, want,
                             **DECODE_TOL["bfloat16" if qd == bf16 else cd])
        if not (torch.equal(got, again) and torch.equal(got, copy)):
            raise AssertionError(f"15a flash_decode {what}: not bitwise "
                                 f"repeatable, or the pitch read differs "
                                 f"from a contiguous V")
        max_err["flash_decode"] = max(max_err["flash_decode"], err)
        log(f"15a flash_decode {what}: {b} slots x {hq}/1 heads x "
            f"{r + dr} (V the first {r} columns at pitch {r + dr}), {sq} "
            f"query rows, cursors {min(cursors)}-{max(cursors)}: max abs err "
            f"{err:.3e}, bitwise repeatable and equal to a contiguous V")
        live = int(kvl.sum())
        pairs = hq * (live if sq == 1 else b * sq * (sq + 1) // 2)
        kl = torch.nan_to_num(rows[1].to(qd))
        timings[("flash_decode", name)] = dict(
            fn=run, plain=lambda q=q, rows=rows, v=v, kvl=kvl, opts=opts:
            ops.decode_attention(q, rows, v, kv_length=kvl, layer=1,
                                 impl="plain", **opts),
            library=lambda q=q, kl=kl, mask=mask:
            F.scaled_dot_product_attention(q, kl, kl[..., :r], attn_mask=mask,
                                           scale=scale, enable_gqa=True),
            # the live rows once (V is their first r columns), q, the output
            bytes=live * (r + dr) * rows.element_size()
            + b * hq * sq * (2 * r + dr) * q.element_size() + b * 4,
            flops=2 * pairs * (2 * r + dr),
            rate=SPLIT_TF32_FLOP_PER_S if cd == "float32" else BF16_FLOP_PER_S,
            shape=f"{what}, {b} x {hq}/1 x {r + dr} / {r}, {live} live rows")
    # the full forward: (b, heads, tokens, D, Dv), causal
    b, s, d, dv = MOE_GATE_PROMPTS, MOE_GATE_LEN, m.qk_nope_dim + dr, \
        m.v_head_dim
    for name, dt in (("mla_train", f32), ("mla_train_bf16", bf16)):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((b, hq, s, d), (b, hq, s, d),
                                     (b, hq, s, dv), (b, hq, s, dv)))
        key = "float32" if dt == f32 else "bfloat16"
        opts = dict(causal=True, scale=scale)
        out, lse = fa.flash_attention_fwd(q, k, v, **opts)
        again, _ = fa.flash_attention_fwd(q, k, v, **opts)
        want, want_lse = fa.flash_fwd_plain(q, k, v, **opts)
        err = close_or_raise(f"15a flash forward {name}", out, want,
                             **FLASH_TOL[key])
        close_or_raise(f"15a flash forward {name} lse", lse, want_lse,
                       atol=1e-4, rtol=1e-5)
        got = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
        got2 = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
        wide = torch.float64 if dt == f32 else dt
        wantg = fab.flash_bwd_plain(q.to(wide), k.to(wide), v.to(wide),
                                    out.to(wide), lse, do.to(wide), **opts)
        if not (torch.equal(out, again) and all(
                torch.equal(a, b_) for a, b_ in zip(got, got2))):
            raise AssertionError(f"15a {name}: not bitwise repeatable")
        gerr = {which: close_or_raise(f"15a flash {which} {name}", a,
                                      w.to(dt), **FLASH_GRAD_TOL[key])
                for which, a, w in zip(("dq", "dk", "dv"), got, wantg)}
        if dt == f32:
            max_err["flash_attention_fwd"] = max(
                max_err["flash_attention_fwd"], err)
            max_err["flash_attention_dq"] = max(
                max_err["flash_attention_dq"], gerr["dq"])
            max_err["flash_attention_dkv"] = max(
                max_err["flash_attention_dkv"], gerr["dk"], gerr["dv"])
        log(f"15a flash {name}: {b} x {hq}/{hq} heads x {s}, D {d}, Dv {dv}, "
            f"causal, {key}: max abs err out {err:.3e}, dq {gerr['dq']:.3e}, "
            f"dk {gerr['dk']:.3e}, dv {gerr['dv']:.3e}; bitwise repeatable")
        delta = torch.sum(do.float() * out.float(), dim=-1)
        es = q.element_size()
        pairs = b * hq * s * (s + 1) // 2
        qb, vb, row = b * hq * s * d * es, b * hq * s * dv * es, b * hq * s * 4
        rate = SPLIT_TF32_FLOP_PER_S if dt == f32 else BF16_FLOP_PER_S
        lq, lk, lv = (t_.detach().clone().requires_grad_(True)
                      for t_ in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                              scale=scale)
        library = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)
        lib_bwd = lambda lout=lout, lq=lq, lk=lk, lv=lv, do=do: \
            torch.autograd.grad(lout, (lq, lk, lv), do, retain_graph=True)
        plain_bwd = lambda q=q, k=k, v=v, out=out, lse=lse, do=do: \
            fab.flash_bwd_plain(q, k, v, out, lse, do, **opts)
        shape = f"{b} x {hq}/{hq} heads x {s}, D {d} / Dv {dv}, {key}"
        timings[("flash_attention_fwd", name)] = dict(
            fn=lambda q=q, k=k, v=v: fa.flash_attention_fwd(q, k, v, **opts),
            plain=lambda q=q, k=k, v=v: fa.flash_fwd_plain(q, k, v, **opts),
            library=library, bytes=2 * qb + 2 * vb + row,
            flops=2 * pairs * (d + dv), rate=rate, shape=shape)
        timings[("flash_attention_dq", name)] = dict(
            fn=lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta:
            fab.flash_attention_dq(q, k, v, do, lse, delta, **opts),
            plain=plain_bwd, library=lib_bwd,
            bytes=3 * qb + 2 * vb + 2 * row,
            flops=2 * pairs * (2 * d + dv), rate=rate, shape=shape)
        timings[("flash_attention_dkv", name)] = dict(
            fn=lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta:
            fab.flash_attention_dkv(q, k, v, do, lse, delta, **opts),
            plain=plain_bwd, library=lib_bwd,
            bytes=3 * qb + 3 * vb + 2 * row,
            flops=2 * pairs * (2 * d + 2 * dv), rate=rate, shape=shape)
    for (kernel, name), tm in timings.items():
        ms = time_ms(tm["fn"])
        plain_ms = time_ms(tm["plain"], batches=3, per_batch=2, warmup=1)
        library_ms = time_ms(tm["library"])
        device = {"ms": kernel_ms(tm["fn"]),
                  "library_ms": kernel_ms(tm["library"])}
        byte_ms = tm["bytes"] / HBM_BYTES_PER_S * 1e3
        flop_ms = tm["flops"] / tm["rate"] * 1e3
        nested = {"ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(byte_ms, flop_ms),
                  "bound_by": "bytes" if byte_ms >= flop_ms
                  else "operations", "library_ms": library_ms,
                  "bound_f32_ms": max(byte_ms,
                                      tm["flops"] / F32_FLOP_PER_S * 1e3)}
        owner = next(r_ for r_ in records if r_["name"] == kernel)
        owner[name] = nested
        log(json.dumps({"kernel": kernel, "row": name, "shape": tm["shape"],
                        **nested, "device_time_ms": device}))


def moe_decode_gate(model, toks, n_prefill, launches, what):
    """Every position's logits two ways: the full forward (a flash forward
    a layer), and the cache: the first ``n_prefill`` tokens as one chunk
    (the decode kernel a layer, causal through the positions), then a
    serve step a token. Launches exact, no plain attention call. Returns
    (full, cached, aux, the chunk's seconds, each tick's seconds)."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.runtime.steps import make_serve_step
    n_layers = model.cfg.num_layers
    b, s = toks.shape
    serve = make_serve_step(model)
    with PlainCalls() as plain:
        cuda.reset_launches()
        with torch.no_grad():
            full, aux, _ = model(toks)
        torch.cuda.synchronize()
        if dict(cuda.LAUNCHES) != {"flash_attention_fwd": n_layers}:
            raise AssertionError(f"{what} full forward: launches "
                                 f"{dict(cuda.LAUNCHES)}")
        launches["flash_attention_fwd"] += n_layers
        cache = model.init_cache(b, s, torch.float32)
        cuda.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            first, _, cache = model(toks[:, :n_prefill], cache=cache,
                                    cache_index=0)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
        outs, ticks = [first], []
        for i in range(n_prefill, s):
            t0 = time.perf_counter()
            lg, cache = serve(cache, toks[:, i:i + 1], i)
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t0)
            outs.append(lg[:, None])
        want = {"flash_decode": n_layers * (1 + s - n_prefill)}
        if dict(cuda.LAUNCHES) != want or plain.calls:
            raise AssertionError(f"{what} cached decode: launches "
                                 f"{dict(cuda.LAUNCHES)} != {want}; plain "
                                 f"calls {plain.calls}")
    launches["flash_decode"] += want["flash_decode"]
    return full, torch.cat(outs, 1), aux, chunk_s, ticks


def no_drop(cfg, **overrides):
    """``cfg`` with a capacity factor of E / k: every group's capacity is at
    least its token count, so no assignment is dropped (prefill and decode
    then differ by rounding alone, whatever their group sizes)."""
    moe = dataclasses.replace(cfg.moe, **overrides)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


def dropped_share(moe, x):
    """The share of x's (B, S, d) token-expert assignments that ``moe``'s
    capacity drops: those past the first C routed to their expert."""
    import torch
    t = x.shape[0] * x.shape[1]
    ids, _, _ = moe.route(x.reshape(t, -1))
    per_expert = torch.bincount(ids.flatten(), minlength=moe.num_experts)
    return float((per_expert - moe.capacity(t)).clamp(min=0).sum()) \
        / ids.numel()


def moe_serving_full(dev, launches):
    """Phase 15b: deepseek-v2-lite-16b at full width and depth, float32."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import cuda
    from repro_torch.nn.moe import MoE
    from repro_torch.nn.module import count_params
    from repro_torch.nn.transformer import build_model
    from repro_torch.runtime.steps import make_serve_step
    reg = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(no_drop(reg), dtype="float32")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    n_params = count_params(model)
    if n_params != MOE_COUNTS[MOE_ARCH]:
        raise AssertionError(f"15b {MOE_ARCH}: {n_params:,} parameters")
    log(f"{MOE_ARCH}: {cfg.num_layers} layers (1 dense, d_ff "
        f"{cfg.moe.dense_ff}; then {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.num_shared} shared, expert_ff "
        f"{cfg.moe.expert_ff}), d_model {cfg.d_model}, MLA {cfg.num_q_heads} "
        f"heads (kv_lora {cfg.mla.kv_lora_rank}, rope {cfg.mla.qk_rope_dim}, "
        f"nope {cfg.mla.qk_nope_dim}, v {cfg.mla.v_head_dim}), vocab "
        f"{cfg.padded_vocab}: {n_params:,} parameters, "
        f"{weights / 2**30:.2f} GiB of float32 weights, drawn by a CUDA "
        f"generator seeded 0 in {time.perf_counter() - t0:.2f} s; capacity "
        f"factor {cfg.moe.capacity_factor:.4g} (E / k: nothing dropped)")
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_GATE_PROMPTS, MOE_GATE_LEN + MOE_GATE_NEW))
    ).to(dev)
    torch.cuda.reset_peak_memory_stats()
    full, dec, aux, chunk_s, ticks = moe_decode_gate(
        model, toks, MOE_GATE_LEN, launches, "15b")
    peak = torch.cuda.max_memory_allocated() - base - weights
    err_chunk = close_or_raise("15b the prefill chunk's logits against the "
                               "full forward", dec[:, :MOE_GATE_LEN],
                               full[:, :MOE_GATE_LEN], **LM_GATE_TOL)
    err_dec = close_or_raise("15b the decoded positions' logits against the "
                             "full forward", dec[:, MOE_GATE_LEN:],
                             full[:, MOE_GATE_LEN:], **LM_GATE_TOL)
    if not math.isfinite(float(aux)):
        raise AssertionError(f"15b aux {float(aux)}")
    tick_ms = np.asarray(ticks) * 1e3
    n_tok = MOE_GATE_PROMPTS * MOE_GATE_NEW
    log(f"15b {MOE_GATE_PROMPTS} prompts x {MOE_GATE_LEN} tokens prefilled "
        f"as one chunk in {chunk_s:.3f} s ({cfg.num_layers} decode launches "
        f"at Sq {MOE_GATE_LEN}), then {MOE_GATE_NEW} ticks: "
        f"{n_tok / sum(ticks):.1f} tokens/s, tick p50 "
        f"{np.percentile(tick_ms, 50):.2f} ms, p99 "
        f"{np.percentile(tick_ms, 99):.2f} ms; {cfg.num_layers} decode "
        f"launches a tick, no plain attention call; max abs err against the "
        f"full forward {err_chunk:.3e} (prefill), {err_dec:.3e} (decoded) "
        f"(gate {LM_GATE_TOL}); aux {float(aux):.5f}; peak memory "
        f"{peak / 2**30:.2f} GiB above the weights")
    del full, dec
    # the device profile of a few ticks (rewriting rows of the gate's cache
    # with the same values)
    serve = make_serve_step(model)
    cache = model.init_cache(MOE_GATE_PROMPTS, MOE_GATE_LEN + MOE_GATE_NEW,
                             torch.float32)

    def ticks_run():
        c = cache
        for i in range(MOE_PROFILE_TICKS):
            _, c = serve(c, toks[:, i:i + 1], i)
        torch.cuda.synchronize()

    cuda.reset_launches()
    t0 = time.perf_counter()
    ticks_run()
    wall = time.perf_counter() - t0
    busy = device_profile(ticks_run, wall, ("tick", lambda: MOE_PROFILE_TICKS),
                          f"15b {MOE_ARCH} ticks at 2 slots")
    want = {"flash_decode": 2 * cfg.num_layers * MOE_PROFILE_TICKS}
    if dict(cuda.LAUNCHES) != want:
        raise AssertionError(f"15b profiled ticks: launches "
                             f"{dict(cuda.LAUNCHES)} != {want}")
    launches["flash_decode"] += want["flash_decode"]
    log("15b busy share of a tick: "
        + ("not measured" if busy is None else f"{busy:.1%}"))
    # the config's own capacity factor: the share of assignments dropped
    shares = []
    moes = [mod for mod in model.modules() if isinstance(mod, MoE)]
    for mod in moes:
        mod.capacity_factor = reg.moe.capacity_factor
    hooks = [mod.register_forward_pre_hook(
        lambda mod, inp: shares.append(dropped_share(mod, inp[0])))
        for mod in moes]
    cuda.reset_launches()
    with torch.no_grad():
        model(toks)
    for h in hooks:
        h.remove()
    if dict(cuda.LAUNCHES) != {"flash_attention_fwd": cfg.num_layers}:
        raise AssertionError(f"15b capacity 1.25: launches "
                             f"{dict(cuda.LAUNCHES)}")
    launches["flash_attention_fwd"] += cfg.num_layers
    t = MOE_GATE_PROMPTS * (MOE_GATE_LEN + MOE_GATE_NEW)
    log(f"15b at the config's capacity factor {reg.moe.capacity_factor} "
        f"({moes[0].capacity(t)} rows an expert for {t} tokens x "
        f"{reg.moe.top_k}): {float(np.mean(shares)):.2%} of the assignments "
        f"dropped over the {len(moes)} MoE layers (per layer "
        f"{min(shares):.2%}-{max(shares):.2%})")
    del model, cache, toks
    torch.cuda.empty_cache()


def moe_server(dev, launches):
    """Phase 15c: the LM Server over deepseek-v2-lite's dense layer and
    MOE_SERVE_LAYERS - 1 MoE layers at the config's own capacity factor."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.nn.moe import MoE
    from repro_torch.nn.transformer import build_model
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              num_layers=MOE_SERVE_LAYERS, dtype="float32")
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    # the server feeds every slot one token a tick (prompts too, token by
    # token), so a tick's MoE group is num_slots tokens, and a solo run's
    # one: a capacity of at least that many rows an expert drops nothing
    moe = next(mod for mod in model.modules() if isinstance(mod, MoE))
    for n in (MOE_SERVE_SLOTS, 1):
        if moe.capacity(n) < n:
            raise AssertionError(f"15c: capacity {moe.capacity(n)} under "
                                 f"{n} tokens a tick")
    rng = np.random.default_rng(151)
    lens = rng.integers(MOE_SERVE_PROMPT[0], MOE_SERVE_PROMPT[1] + 1,
                        MOE_SERVE_REQUESTS)
    requests = [(uid, rng.integers(1, cfg.vocab_size, n), MOE_SERVE_NEW)
                for uid, n in enumerate(lens)]
    srv, wall, ticks, counts, admitted, plain_calls, peak = lm_served(
        model, requests, "float32", MOE_SERVE_SLOTS, MOE_SERVE_MAX_LEN)
    done = srv.done
    if sorted(done) != list(range(MOE_SERVE_REQUESTS)) or any(
            len(r_.generated) != MOE_SERVE_NEW for r_ in done.values()):
        raise AssertionError(f"15c: requests {sorted(done)} or lengths "
                             f"wrong")
    want = {"flash_decode": cfg.num_layers * srv.ticks}
    if counts != want or plain_calls:
        raise AssertionError(f"15c: launches {counts} != {want}; plain "
                             f"calls {plain_calls}")
    launches["flash_decode"] += want["flash_decode"]
    checked = {int(np.argmin(lens)): "shortest", int(np.argmax(lens)):
               "longest"}
    mid = sorted((t, u) for u, t in admitted.items()
                 if t > 0 and u not in checked)
    for t, u in (mid[0], mid[-1]):
        checked[u] = f"admitted at tick {t}"
    if len(checked) != 4:
        raise AssertionError(f"15c: {checked} are not 4 requests")
    n_solo, equal, tied = solo_gate(model, requests, done, checked,
                                    "float32", MOE_SERVE_SLOTS,
                                    MOE_SERVE_MAX_LEN, "15c")
    launches["flash_decode"] += n_solo
    n_tok = sum(len(r_.generated) for r_ in done.values())
    tick_ms = np.asarray(ticks) * 1e3
    log(f"15c {MOE_SERVE_REQUESTS} requests (prompts {lens.min()}-"
        f"{lens.max()} tokens, {MOE_SERVE_NEW} new each, greedy) through "
        f"{MOE_SERVE_SLOTS} slots at {cfg.num_layers} layers, capacity "
        f"factor {cfg.moe.capacity_factor} ({moe.capacity(MOE_SERVE_SLOTS)} "
        f"rows an expert for a tick's {MOE_SERVE_SLOTS} tokens: nothing "
        f"dropped), float32 cache: {srv.ticks} ticks, {wall:.2f} s, "
        f"{n_tok / wall:.1f} generated tokens/s, "
        f"{(n_tok + int(lens.sum())) / wall:.1f} with the prompts; tick p50 "
        f"{np.percentile(tick_ms, 50):.2f} ms, p99 "
        f"{np.percentile(tick_ms, 99):.2f} ms; {cfg.num_layers} decode "
        f"launches a tick, no plain attention call; peak memory "
        f"{peak / 2**30:.2f} GiB above the model's; "
        + solo_summary(equal, tied))
    part = lambda: lm_served(  # noqa: E731
        model, requests, "float32", MOE_SERVE_SLOTS, MOE_SERVE_MAX_LEN,
        max_ticks=MOE_PROFILE_TICKS * 8)
    runs = [part()]
    device_profile(lambda: runs.append(part()), runs[0][1],
                   ("tick", lambda: MOE_PROFILE_TICKS * 8),
                   f"15c MoE server, its first {MOE_PROFILE_TICKS * 8} ticks")
    for run in runs:
        if run[3] != {"flash_decode": cfg.num_layers * run[0].ticks} \
                or run[5]:
            raise AssertionError(f"15c profiled drive: launches {run[3]}; "
                                 f"plain calls {run[5]}")
        launches["flash_decode"] += run[3]["flash_decode"]
    del model, srv
    torch.cuda.empty_cache()


def moe_train(dev, launches):
    """Phase 15d: deepseek-v2-lite at full width, cut in depth: the
    gradients through the kernels against the plain versions, then AdamW
    steps in bf16 compute over float32 weights."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.nn.module import count_params
    from repro_torch.optim import adamw, chain, clip_by_global_norm, \
        warmup_cosine
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.training.steps import loss_summary
    lm_grad_check(MOE_ARCH, MOE_GRAD_LAYERS, LM_TRAIN_B, LM_TRAIN_S, dev,
                  launches, tag="15d")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = lm_model(MOE_ARCH, dev, num_layers=MOE_TRAIN_LAYERS)
    cfg = model.cfg
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    n_params = count_params(model)
    batches = [lm_batch(cfg, LM_TRAIN_B, LM_TRAIN_S, i * LM_TRAIN_B, dev)
               for i in range(MOE_TRAIN_STEPS)]
    n = cfg.num_layers
    per_step = {"flash_attention_fwd": 2 * n, "flash_attention_dq": n,
                "flash_attention_dkv": n}
    opt = chain(clip_by_global_norm(1.0),
                adamw(warmup_cosine(LM_TRAIN_LR, 20, MOE_TRAIN_STEPS)))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(model, opt, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, auxes, secs = [], [], []
    cuda.reset_launches()
    with PlainCalls() as plain:
        for batch in batches:
            t0 = time.perf_counter()
            grads, metrics = step.grads(batch)
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux"]))
            state = step.update(state, grads)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    want = {k_: v_ * MOE_TRAIN_STEPS for k_, v_ in per_step.items()}
    if dict(cuda.LAUNCHES) != want or plain.calls:
        raise AssertionError(f"15d: launches {dict(cuda.LAUNCHES)} != "
                             f"{want}; plain calls {plain.calls}")
    for k_, v_ in want.items():
        launches[k_] += v_
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"15d: losses {losses}, aux {auxes}")
    ends = loss_summary(losses)
    if not ends["loss_last"] < ends["loss_first"]:
        raise AssertionError(f"15d: the loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated() - base - weights
    med = statistics.median(secs[1:])
    log(f"15d {MOE_ARCH} at full width and {n} layers ({n_params:,} "
        f"parameters, {weights / 2**30:.2f} GiB of float32 weights), "
        f"compute {cfg.dtype}, remat, {MOE_TRAIN_STEPS} AdamW steps of "
        f"{LM_TRAIN_B} x {LM_TRAIN_S} synthetic_lm tokens, peak lr "
        f"{LM_TRAIN_LR}, capacity factor {cfg.moe.capacity_factor}: loss "
        f"{ends['loss_first']:.4f} -> {ends['loss_last']:.4f} (5-step means; "
        f"{', '.join(f'{x:.3f}' for x in losses)}); aux "
        f"{', '.join(f'{x:.4f}' for x in auxes)}; {1 / med:.3f} steps/s, "
        f"{LM_TRAIN_B * LM_TRAIN_S / med:.0f} tokens/s (median step "
        f"{med:.3f} s, the first {secs[0]:.3f} s); peak memory "
        f"{peak / 2**30:.2f} GiB above the weights (AdamW moments "
        f"{2 * weights / 2**30:.2f} GiB of it); launches a step {per_step}, "
        f"no plain attention call")
    del model, state, step, batches
    torch.cuda.empty_cache()


def kimi_check(dev, launches):
    """Phase 15e: kimi-k2-1t-a32b at full width, cut to KIMI_LAYERS layers
    and KIMI_EXPERTS experts: decode against the full forward as 15b."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.nn.module import count_params
    from repro_torch.nn.transformer import build_model
    reg = configs.get_config(KIMI_ARCH)
    n_full = count_params(build_model(reg, device="meta"))
    if n_full != MOE_COUNTS[KIMI_ARCH]:
        raise AssertionError(f"15e {KIMI_ARCH} on meta: {n_full:,}")
    cfg = dataclasses.replace(no_drop(reg, num_experts=KIMI_EXPERTS),
                              num_layers=KIMI_LAYERS, dtype="float32")
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    n_params = count_params(model)
    rng = np.random.default_rng(152)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, KIMI_PREFILL + KIMI_NEW))).to(dev)
    full, dec, aux, chunk_s, ticks = moe_decode_gate(
        model, toks, KIMI_PREFILL, launches, "15e")
    err = close_or_raise("15e decode against the full forward", dec, full,
                         **LM_GATE_TOL)
    log(f"15e {KIMI_ARCH}: {n_full:,} parameters at its full "
        f"{reg.num_layers} layers and {reg.moe.num_experts} experts (on "
        f"meta); at full width (d_model {cfg.d_model}, {cfg.num_q_heads}/"
        f"{cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, expert_ff "
        f"{cfg.moe.expert_ff}, top-{cfg.moe.top_k} + {cfg.moe.num_shared} "
        f"shared) cut to {KIMI_LAYERS} layers and {KIMI_EXPERTS} experts: "
        f"{n_params:,} parameters ({n_params * 4 / 2**30:.2f} GiB); 2 "
        f"prompts of {KIMI_PREFILL} tokens as a chunk, then {KIMI_NEW} "
        f"ticks (p50 {statistics.median(ticks) * 1e3:.2f} ms): every "
        f"position within {err:.3e} of the full forward (gate "
        f"{LM_GATE_TOL}), capacity factor {cfg.moe.capacity_factor:.4g}, "
        f"aux {float(aux):.5f}")
    del model, full, dec
    torch.cuda.empty_cache()


def moe_phase(launches, max_err, records):
    """Phase 15: MoE with MLA (see the module docstring)."""
    import gc

    import torch
    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15 starts with {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated by earlier phases")
    phase("15a. MoE with MLA: the decode at MLA's absorbed shapes, the "
          "flash kernels at its full forward")
    mla_kernels(torch.Generator(device=dev).manual_seed(15), dev, max_err,
                records)
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"15b. {MOE_ARCH} at full width and depth: prefill and decode "
          f"against the full forward")
    moe_serving_full(dev, launches)
    phase(f"15c. the LM Server over {MOE_ARCH} at {MOE_SERVE_LAYERS} layers")
    moe_server(dev, launches)
    phase(f"15d. {MOE_ARCH} trains at full width and {MOE_TRAIN_LAYERS} "
          f"layers")
    moe_train(dev, launches)
    phase(f"15e. {KIMI_ARCH} at full width, {KIMI_LAYERS} layers and "
          f"{KIMI_EXPERTS} experts")
    kimi_check(dev, launches)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.categorical import categorical, categorical_plain
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.runtime import (EvalConfig, RolloutEngine,
                                     evaluate_families, evaluate_scenes)
    from repro_torch.training.data import make_sim_batch

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
    # the decode at sim-se2-fourier's c = 200 and at the other Table-I
    # arches' c = head_dim = 24
    for cache_dtype, width in itertools.product(
            ("float32", "bfloat16", "int8"), (c, cfg.head_dim)):
        for sq, prefill in ((tick_rows, False), (prefill_rows, False),
                            (prefill_rows, True)):
            case = decode_case(gen, dev, cache_dtype, layers=cfg.num_layers,
                               b=n_slots, h=cfg.num_heads, s=s_max, c=width,
                               sq=sq, cursors=cursors,
                               num_map=scen.num_map,
                               num_agents=scen.num_agents, prefill=prefill)
            q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
            want = ops.decode_attention(q, k, v, impl="plain", layer=3,
                                        **case)
            what = (f"{cache_dtype:8s} c={width:3d} Sq={sq:3d}"
                    f"{' prefill mask' * prefill}")
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
                                      attn_scale, c)
    # and at the other Table-I arches' width, c = head_dim = 24
    train_case_24 = scene_attention_case(gen, dev, model, scen, TRAIN_BATCH,
                                         attn_scale, cfg.head_dim)
    for case_ in (train_case, train_case_24):
        what = "train shape " + "x".join(map(str, case_[0].shape))
        first = check_flash(what, *case_, max_err)
        again = fab.flash_attention_bwd(*case_[:3], *fa.flash_attention_fwd(
            *case_[:3], **case_[4]), case_[3], **case_[4])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"flash backward at the {what}: not "
                                 f"bitwise repeatable")
        log(f"flash backward at the {what}: bitwise repeatable")
    for name in FLASH_FEATURES:
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(f"{name} {str(dtype)[6:]}",
                        *feature_case(gen, dev, name, dtype), max_err)
    repeat_cases = {"train shape": train_case,
                    "train shape c=24": train_case_24}
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
    # the sampler at the engine's tick and the server's
    for what, per_slot in (("engine tick", False), ("server tick", True)):
        err = check_sampler(what, *sampling_case(
            gen, dev, n_slots, scen.num_agents, scen.num_actions, per_slot))
        max_err["categorical"] = max(max_err["categorical"], err)

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
    pairs = (("freeform", scenes[:2]), (" + ".join(MIXED_PAIR), padded))
    check_against_reference(model, scen, pairs, t_hist, s_max)
    want_counts = {"flash_decode": cfg.num_layers * (1 + scen.num_steps
                                                     - t_hist)}
    want_counts["se2_project_q"] = want_counts["flash_decode"]
    want_counts["se2_project_k"] = 2 * want_counts["flash_decode"]
    want_counts["se2_project_q_t"] = want_counts["flash_decode"]
    want_counts["categorical"] = scen.num_steps - t_hist    # one a tick
    launches = dict.fromkeys(REPLACES, 0)
    f32_rollout = {}
    engine = rollouts(model, scen, scenes, t_hist, want_counts, launches, "",
                      stats=f32_rollout)
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
    # a layer: q~ and untransform_out forward ("q", "q_t") and backward
    # ("q_t", "q"), k~ and v~ forward ("k" twice) and backward ("k_t" twice)
    per_step = {"flash_attention_fwd": cfg.num_layers,
                "flash_attention_dq": cfg.num_layers,
                "flash_attention_dkv": cfg.num_layers,
                "se2_project_q": 2 * cfg.num_layers,
                "se2_project_q_t": 2 * cfg.num_layers,
                "se2_project_k": 2 * cfg.num_layers,
                "se2_project_k_t": 2 * cfg.num_layers}
    one_step, ol, data, bare_rate = train(tmodel, scen, per_step,
                                          launches, "", mixed_grads=True)
    calls = plain_se2_calls(one_step)
    if calls:
        raise AssertionError(f"the train step ran plain SE(2) ops: {calls}")
    log("train step: no call into core/encodings.py or core/fourier.py that "
        "runs a tensor op")
    data.close()

    # 6. times at the main-path shapes ------------------------------------------
    phase("6. times")
    kvl = scen.num_map + scen.num_steps * scen.num_agents - 2 * scen.num_agents
    c150 = SE2Fourier(head_dim=WIDTH_HEAD_DIM,
                      num_terms=cfg.fourier_terms).expanded_dim
    c300 = SE2Fourier(head_dim=WIDE_HEAD_DIM,
                      num_terms=cfg.fourier_terms).expanded_dim

    def decode_timing(sq, cursor, prefill, c, b_=n_slots, s_=s_max,
                      dtype="float32"):
        """flash_decode at the tick (sq new rows at the newest time against
        ``cursor`` live rows) or the prefill (the first sq tokens against
        themselves, block-causal), b_ slots of a cache s_ rows of c wide,
        float32 (or bf16 cache and query); SDPA over the live prefix with
        the same mask. FLOPs count the (q, k) pairs the mask admits,
        bounded at the tensor cores' rate for float32-accurate products
        (bf16 products for bf16)."""
        case = decode_case(gen, dev, dtype, layers=cfg.num_layers,
                           b=b_, h=cfg.num_heads, s=s_, c=c, sq=sq,
                           cursors=[cursor] * b_, num_map=scen.num_map,
                           num_agents=scen.num_agents, prefill=prefill)
        q, k, v = case.pop("q"), case.pop("k"), case.pop("v")
        q = q.to(k.dtype)
        es = k.element_size()
        live = (case["k_times"][:, None, :cursor]
                <= case["q_times"][:, :, None])
        seg = ((case["q_segment_ids"][:, :, None]
                == case["k_segment_ids"][:, None, :cursor])
               & (case["k_segment_ids"][:, None, :cursor] >= 0))
        mask = (live & seg)[:, None].contiguous()         # (B, 1, Sq, cursor)
        kl, vl = k[3, :, :, :cursor], v[3, :, :, :cursor]
        h_ = cfg.num_heads
        return dict(
            fn=lambda: ops.decode_attention(q, k, v, impl="flash_decode",
                                            layer=3, **case),
            plain=lambda: ops.decode_attention(q, k, v, impl="plain",
                                               layer=3, **case),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kl, vl, attn_mask=mask,
                scale=1.0 / math.sqrt(cfg.head_dim)),
            bytes=(b_ * h_ * cursor * 2 * c * es + b_ * h_ * sq * 2 * c * es
                   + b_ * cursor * 2 * 4 + b_ * sq * 2 * 4 + b_ * 4),
            flops=2 * int(mask.sum()) * h_ * 2 * c,
            rate=SPLIT_TF32_FLOP_PER_S if es == 4 else BF16_FLOP_PER_S,
            kernel="flash_decode",
            shape=f"{'prefill' if prefill else 'tick'}, {dtype}: {b_} slots x {h_} "
                  f"heads x {sq} query rows x {c}, {cursor} live cache rows, "
                  f"{int(mask.sum())} of {b_ * sq * cursor} (q, k) pairs "
                  f"admitted a head")
    def se2_timing(name, b_, n_, dtype=torch.float32):
        """An se2 mode at b_ scenes x n_ tokens, all heads, float32 (or
        bf16); each input read once and each output written once, bounded
        by bytes."""
        kernel, plain, mode, transposed = se2_mode(name)
        width = c if transposed else cfg.head_dim
        x, pose = se2_case(gen, dev, b_, cfg.num_heads, n_, width,
                           cfg.pos_scale)
        x = x.to(dtype)
        rows = b_ * cfg.num_heads * n_
        return dict(
            fn=lambda: kernel(x, pose, enc, mode),
            plain=lambda: plain(x, pose, enc, mode), library=None,
            bytes=(rows * (cfg.head_dim + c) * x.element_size()
                   + b_ * n_ * 3 * 4),
            flops=se2_flops(name, b_ * n_, rows, enc.num_blocks,
                            enc.num_terms),
            kernel=name, shape=f"{b_} scenes x {cfg.num_heads} heads x {n_} "
                               f"tokens, {str(dtype)[6:]}")

    def sampling_timing(per_slot):
        """The sampler at the tick (64 lanes x 12 agents x 63 actions), one
        step for all lanes or each slot its own; reads the logits, keys and
        steps once and writes the actions, and runs SAMPLE_OPS integer and
        float operations an element and a fold_in a row."""
        keys, steps, logits = sampling_case(gen, dev, n_slots,
                                            scen.num_agents,
                                            scen.num_actions, per_slot)
        b_, a_, k_ = logits.shape
        return dict(
            fn=lambda: categorical(keys, steps, logits),
            plain=lambda: categorical_plain(keys, steps, logits),
            library=None,
            bytes=b_ * a_ * k_ * 4 + b_ * 16 + b_ * 4 + b_ * a_ * 8,
            flops=b_ * a_ * (k_ * SAMPLE_OPS + THREEFRY_OPS),
            rate=INT32_OPS_PER_S, kernel="categorical",
            shape=f"{b_} lanes x {a_} agents x {k_} actions, "
                  f"{'each slot its own step' if per_slot else 'one step'}")

    # se2 at the tick (the record), at the train step (its "train") and at
    # the server's admission ("admit"); the decode at c = 200 (the record,
    # its "prefill", "admit") and at the other Table-I arches' c = 24
    # ("c24", "c24_prefill")
    timings = {
        "flash_decode": decode_timing(tick_rows, kvl, False, c),
        "flash_decode_prefill": dict(
            decode_timing(prefill_rows, prefill_rows, True, c),
            nest="prefill"),
        "flash_decode_c24": dict(
            decode_timing(tick_rows, kvl, False, cfg.head_dim), nest="c24"),
        "flash_decode_prefill_c24": dict(
            decode_timing(prefill_rows, prefill_rows, True, cfg.head_dim),
            nest="c24_prefill"),
        **{name: se2_timing(name, n_slots, tick_rows) for name in SE2_MODES},
        **{f"{name}_train": dict(se2_timing(name, TRAIN_BATCH, train_tokens),
                                 nest="train") for name in SE2_MODES},
        # the server's admission (phase 10): one scene's map rows against
        # themselves on the M-row sub-cache
        "flash_decode_admit": dict(
            decode_timing(scen.num_map, scen.num_map, True, c, b_=1,
                          s_=scen.num_map), nest="admit"),
        **{f"{name}_admit": dict(se2_timing(name, 1, scen.num_map),
                                 nest="admit") for name in SE2_MODES},
        # the sampler at the engine's tick (the record) and the server's
        "categorical": sampling_timing(False),
        "categorical_server": dict(sampling_timing(True), nest="server"),
        # the decode at se2_fourier's c = 150 (head_dim 18), and with bf16
        # cache and query at c = 200 (the bf16 model's tick)
        "flash_decode_c150": dict(
            decode_timing(tick_rows, kvl, False, c150), nest="c150"),
        "flash_decode_prefill_c150": dict(
            decode_timing(prefill_rows, prefill_rows, True, c150),
            nest="c150_prefill"),
        "flash_decode_bf16": dict(
            decode_timing(tick_rows, kvl, False, c, dtype="bfloat16"),
            nest="bf16"),
        # past 256 columns (column windows): se2_fourier at head_dim 36
        # (c = 300), and c = 500 at the tick
        "flash_decode_c300": dict(
            decode_timing(tick_rows, kvl, False, c300), nest="c300"),
        "flash_decode_prefill_c300": dict(
            decode_timing(prefill_rows, prefill_rows, True, c300),
            nest="c300_prefill"),
        "flash_decode_c500": dict(
            decode_timing(tick_rows, kvl, False, 500), nest="c500"),
        **{f"{name}_bf16": dict(se2_timing(name, n_slots, tick_rows,
                                           torch.bfloat16), nest="bf16")
           for name in SE2_MODES},
        **{f"{name}_bf16_train": dict(
            se2_timing(name, TRAIN_BATCH, train_tokens, torch.bfloat16),
            nest="bf16_train") for name in SE2_MODES},
    }
    def flash_timings(case):
        """The flash forward, dq and dk/dv at the train step's attention
        shape; FLOPs count only the (q, k) pairs this run's mask admits,
        bounded at the tensor cores' rate for float32-accurate products.
        Returns the three timings and the (B, Sq, Sk) pair mask."""
        tq, tk, tv, tdo, topts = case
        tout, tlse = fa.flash_attention_fwd(tq, tk, tv, **topts)
        tdelta = torch.sum(tdo.float() * tout.float(), dim=-1)
        es = tq.element_size()
        rate = SPLIT_TF32_FLOP_PER_S if es == 4 else BF16_FLOP_PER_S
        times_, seg_ = topts["q_times"], topts["q_segment_ids"]
        pair_mask = ((times_[:, None, :] <= times_[:, :, None])
                     & (seg_[:, :, None] == seg_[:, None, :])
                     & (seg_[:, None, :] >= 0))             # (B, Sq, Sk)
        tb_, th_, ts_, tc_ = tq.shape
        pairs = int(pair_mask.sum()) * th_
        elem, row = tb_ * th_ * ts_ * tc_ * es, tb_ * th_ * ts_ * 4
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
        shape = (f"{tb_} scenes x {th_} heads x {ts_} tokens x {tc_}, "
                 f"{str(tq.dtype)[6:]}")
        return {
            "flash_attention_fwd": dict(
                fn=lambda: fa.flash_attention_fwd(tq, tk, tv, **topts),
                plain=lambda: fa.flash_fwd_plain(tq, tk, tv, **topts),
                library=lambda: torch.nn.functional
                .scaled_dot_product_attention(tq, tk, tv, attn_mask=sdpa_mask,
                                              scale=attn_scale),
                bytes=4 * elem + row + masks_bytes,
                flops=2 * pairs * (tc_ + tc_), rate=rate, shape=shape),
            # one plain backward and one SDPA backward compute dq, dk and dv
            # together: both rows carry the same combined plain/library ms
            "flash_attention_dq": dict(
                fn=lambda: fab.flash_attention_dq(tq, tk, tv, tdo, tlse,
                                                  tdelta, **topts),
                plain=plain_bwd, library=sdpa_bwd,
                bytes=5 * elem + 2 * row + masks_bytes,
                flops=2 * pairs * (2 * tc_ + tc_), rate=rate, shape=shape),
            "flash_attention_dkv": dict(
                fn=lambda: fab.flash_attention_dkv(tq, tk, tv, tdo, tlse,
                                                   tdelta, **topts),
                plain=plain_bwd, library=sdpa_bwd,
                bytes=6 * elem + 2 * row + masks_bytes,
                flops=2 * pairs * (2 * tc_ + 2 * tc_), rate=rate,
                shape=shape),
        }, pair_mask

    flash_200, pair_mask = flash_timings(train_case)
    timings.update(flash_200)
    # the flash kernels at c = 24 (the other arches), c = 150 (se2_fourier
    # at head_dim 18) and in bf16 at c = 200 (the bf16 model's train step)
    for nest, case_ in (
            ("c24", train_case_24),
            ("c150", scene_attention_case(gen, dev, model, scen, TRAIN_BATCH,
                                          attn_scale, c150)),
            ("c300", scene_attention_case(gen, dev, model, scen, TRAIN_BATCH,
                                          attn_scale, c300)),
            ("bf16", (*(t_.to(torch.bfloat16) for t_ in train_case[:4]),
                      train_case[4]))):
        timings.update({f"{name}_{nest}": dict(tm, kernel=name, nest=nest)
                        for name, tm in flash_timings(case_)[0].items()})
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
        # CUPTI for the kernel and the library call; the plain versions by
        # events only: a profiler session costs about a second, and the
        # plain versions alone took about 40 of them)
        device = {"ms": kernel_ms(tm["fn"])}
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
    tb_, th_, ts_, _ = train_case[0].shape
    admitted = int(pair_mask.sum()) * th_
    log(f"train attention shape: {tb_} scenes x {th_} heads x {ts_} tokens, "
        f"c = {c} and {cfg.head_dim}; {admitted // th_} of {tb_ * ts_ * ts_} "
        f"(q, k) pairs admitted ({admitted / (th_ * tb_ * ts_ * ts_):.1%}); the "
        f"plain_ms and library_ms of flash_attention_dq and _dkv are one "
        f"backward that computes dq, dk and dv together")
    for name, own_mask, own, walk in (
            ("flash_attention_fwd", pair_mask, FWD_TILE_OWN, FWD_TILE_WALK),
            ("flash_attention_dq", pair_mask, BWD_TILE_OWN, BWD_TILE_WALK),
            ("flash_attention_dkv", pair_mask.transpose(1, 2), BWD_TILE_OWN,
             BWD_TILE_WALK)):
        computed = computed_pairs(own_mask, own, walk)
        log(f"{name}: its {own} x {walk} tiles compute {computed} (q, k) "
            f"pairs a head, of which the mask admits {admitted // th_} "
            f"({admitted / th_ / computed:.1%})")

    # the timing cases' tensors (and SDPA's retained graphs) are not needed
    # past phase 6: phase 14's full-depth train step needs the card's memory
    del timings, measured, flash_200
    torch.cuda.empty_cache()

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
                   "se2_project_q_t": chunks * per_chunk,
                   "categorical": chunks * (scen.num_steps - t_hist)}
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
    check_tables(tables, eval_scenes, EVAL_SCENES, "")
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

    # 8. the other three Table-I arches ------------------------------------
    table1_phase(tmodel, ol, scen, scenes, pairs, t_hist, s_max, launches)

    # 9. the trainer stack --------------------------------------------------
    del tmodel
    torch.cuda.empty_cache()
    trainer_phase(arch, per_step, bare_rate, launches)

    # 10. the continuous-batching server -----------------------------------
    server_phase(model, scen, s_max, launches, max_err)

    # 11. jax.random-exact sampling, widths off 4, bfloat16 ---------------
    sampling_phase(model, scen, scenes, t_hist, s_max)
    widths_phase(cfg, scen, scenes, pairs, t_hist, s_max, launches, max_err,
                 WIDTH_CASES, WIDTH_HEAD_DIM, "11b. widths: the attention "
                 "kernels at rows not a multiple of 4 wide")
    serve_sim_defaults()
    bf16_phase(model, scen, scenes, pairs, t_hist, s_max, launches, max_err,
               f32_rollout, bare_rate)

    # 12. rows past 256; the fleet on torch.distributed --------------------
    widths_phase(cfg, scen, scenes, pairs, t_hist, s_max, launches, max_err,
                 WIDE_CASES, WIDE_HEAD_DIM, "12a. rows wider than 256: "
                 "column windows")
    del model
    torch.cuda.empty_cache()
    fleet_phase(cfg, scen, t_hist, launches)
    launcher_phase()

    # 13. the dense LM serving stack ----------------------------------------
    lm_phase(launches, max_err, records)

    # 14. LM training; gemma2's windowed, softcapped attention --------------
    lm_train_phase(launches, max_err, records)

    # 15. MoE with MLA -------------------------------------------------------
    moe_phase(launches, max_err, records)
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
