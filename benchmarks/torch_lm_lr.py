"""phi4-mini-3.8b's first train steps at two peak learning rates, on one
card.

    python3 benchmarks/torch_lm_lr.py [--steps 10] [--lrs 3e-3 3e-4]

At full width and depth, weights from a CUDA generator seeded 0 (as
``chip_smoke.py`` phase 14c builds them), ``launch/train``'s chain
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine(lr, 20, steps)))``
runs ``--steps`` steps of 2 x 512 ``synthetic_lm`` tokens (seed 0, the
batches of phase 14c) once per peak rate in ``--lrs``, through the attention
kernels in the registered bf16 compute with remat. At the first rate it
also runs over the same batches through the plain attention in float32
compute and through the kernels in float32 compute, to tell how the model
trains at that rate from a fault of the kernels or of bf16 (remat and the
tensor-at-a-time optimizer step are bitwise equal to their alternatives:
``tests/test_torch_lm_train.py``). Each run keeps every parameter tensor's
gradient norm a step; the three runs at the first rate are compared: the
first step whose losses part by more than ``LOSS_PART`` and, at the
first step whose gradient norms part by more than ``GRAD_PART`` of the
larger in some tensor, those tensors.

Each batch is also scored without an update, by the initial model and by
the model after the last rate's run (its loss under one set of weights:
how hard the batch is), and described: the share of its labels that the
data's latent bigram table predicts, the share that are the Zipf tail's
clipped token (vocab - 1), and its distinct labels.

Prints the card (``nvidia-smi --query-gpu=name,power.limit``), a line per
run, and one JSON line with every loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARCH, B, S = "phi4-mini-3.8b", 2, 512
# two runs part where their losses differ by more than LOSS_PART, and their
# gradients where a tensor's norms differ by more than GRAD_PART of the larger
LOSS_PART, GRAD_PART = 0.1, 0.05


def parting(a, b):
    """Where runs ``a`` and ``b`` part: the first step whose losses differ
    by more than LOSS_PART, and the first step where some tensor's gradient
    norms differ by more than GRAD_PART of the larger, with the tensors
    that do there (the largest differences first)."""
    loss_step = next((i for i, (x, y) in enumerate(zip(a["losses"],
                                                         b["losses"]))
                      if abs(x - y) > LOSS_PART), None)
    grad_step, tensors = None, []
    for i, (na, nb) in enumerate(zip(a["tensor_norms"], b["tensor_norms"])):
        rel = {n: abs(na[n] - nb[n]) / max(na[n], nb[n], 1e-30) for n in na}
        tensors = sorted((n for n in rel if rel[n] > GRAD_PART),
                         key=lambda n: -rel[n])
        if tensors:
            grad_step = i
            tensors = [(n, rel[n]) for n in tensors[:8]]
            break
    return {"runs": [a["what"], b["what"]], "lr": a["lr"],
            "loss_parts_at_step": loss_step,
            "grads_part_at_step": grad_step, "first_tensors": tensors}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lrs", type=float, nargs="+", default=[3e-3, 3e-4])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_lr: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.data import synthetic_lm
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.nn.transformer import build_model
    from repro_torch.optim import (adamw, chain, clip_by_global_norm,
                                   warmup_cosine)
    from repro_torch.runtime.steps import lm_loss, make_train_step

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    cuda.build_all()
    cfg = configs.get_config(ARCH)
    host = [make_batch_fn(cfg, S)(0, i * B, B) for i in range(args.steps)]
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in host]

    def model_for(dtype, impl):
        c = dataclasses.replace(cfg, dtype=dtype)
        return build_model(c, impl, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))

    @torch.no_grad()
    def scores(model):
        return [float(lm_loss(model(b["tokens"])[0], b["labels"]))
                for b in batches]

    def train(model, lr, what):
        opt = chain(clip_by_global_norm(1.0),
                    adamw(warmup_cosine(lr, 20, args.steps)))
        step = make_train_step(model, opt, remat=True)
        state = opt.init(dict(model.named_parameters()))
        losses, norms, tensor_norms = [], [], []
        t0 = time.perf_counter()
        for b in batches:
            grads, m = step.grads(b)
            tensor_norms.append({n: float(torch.linalg.vector_norm(g))
                                 for n, g in grads.items()})
            state = step.update(state, grads)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        secs = time.perf_counter() - t0
        print(f"{what}, peak lr {lr}: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
              f"{', '.join(f'{x:.3f}' for x in norms)} ({secs:.1f} s)",
              flush=True)
        del state, step
        return {"what": what, "lr": lr, "losses": losses,
                "grad_norms": norms, "tensor_norms": tensor_norms}

    runs, first = [], None
    for i, lr in enumerate(args.lrs):
        model = model_for(cfg.dtype, None)
        if first is None:
            first = scores(model)
        runs.append(train(model, lr, f"kernels, {cfg.dtype} compute"))
        if i == 0:
            for dtype, impl, what in (
                    ("float32", "plain", "plain attention, float32 compute"),
                    ("float32", None, "kernels, float32 compute")):
                del model
                torch.cuda.empty_cache()
                model = model_for(dtype, impl)
                runs.append(train(model, lr, what))
        if i == len(args.lrs) - 1:
            last = scores(model)
        del model
        torch.cuda.empty_cache()

    table = synthetic_lm._bigram_table(0, synthetic_lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=S))
    stats = []
    for b, s0, s1 in zip(host, first, last):
        tok, lab = b["tokens"].astype(np.int64), b["labels"].astype(np.int64)
        stats.append({"bigram_share": float(np.mean(table[tok] == lab)),
                      "tail_share": float(np.mean(lab == cfg.vocab_size - 1)),
                      "distinct": int(np.unique(lab).size),
                      "initial_loss": s0, "trained_loss": s1})
        print(f"batch {len(stats) - 1}: {json.dumps(stats[-1])}", flush=True)
    partings = [parting(runs[a], runs[b])
                for a, b in ((2, 1), (2, 0), (1, 0))]
    for p in partings:
        print(f"parting: {json.dumps(p)}", flush=True)
    for r in runs:
        r.pop("tensor_norms")
    print(json.dumps({"arch": ARCH, "batch": [B, S], "runs": runs,
                      "batches": stats, "partings": partings,
                      "trained_by": f"kernels, lr {args.lrs[-1]}"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
