"""phi4-mini-3.8b's first train steps at two peak learning rates, on one
card.

    python3 benchmarks/torch_lm_lr.py [--steps 10] [--lrs 3e-3 3e-4]

At full width and depth, weights from a CUDA generator seeded 0 (as
``chip_smoke.py`` phase 14c builds them), ``launch/train``'s chain
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine(lr, 20, steps)))``
runs ``--steps`` steps of 2 x 512 ``synthetic_lm`` tokens (seed 0, the
batches of phase 14c) once per peak rate in ``--lrs``, through the attention
kernels in the registered bf16 compute with remat. At the first rate it
also runs through the plain attention in float32 compute over the same
batches, to tell how the model trains at that rate from a fault of the
kernels or of bf16 (remat and the tensor-at-a-time optimizer step are
bitwise equal to their alternatives: ``tests/test_torch_lm_train.py``).

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
        losses, norms = [], []
        t0 = time.perf_counter()
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        secs = time.perf_counter() - t0
        print(f"{what}, peak lr {lr}: losses "
              f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
              f"{', '.join(f'{x:.3f}' for x in norms)} ({secs:.1f} s)",
              flush=True)
        del state, step
        return {"what": what, "lr": lr, "losses": losses,
                "grad_norms": norms}

    runs, first = [], None
    for i, lr in enumerate(args.lrs):
        model = model_for(cfg.dtype, None)
        if first is None:
            first = scores(model)
        runs.append(train(model, lr, f"kernels, {cfg.dtype} compute"))
        if i == 0:
            del model
            torch.cuda.empty_cache()
            model = model_for("float32", "plain")
            runs.append(train(model, lr, "plain attention, float32 "
                                         "compute"))
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
    print(json.dumps({"arch": ARCH, "batch": [B, S], "runs": runs,
                      "batches": stats,
                      "trained_by": f"kernels, lr {args.lrs[-1]}"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
