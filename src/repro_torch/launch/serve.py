"""Serve an LM config with continuous batching (port of
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch phi4-mini-3.8b
    python -m repro_torch.launch.serve --arch stablelm-3b --reduced --device cpu

Random weights from ``--seed`` (on the card they are drawn by a CUDA
generator seeded ``--seed``: a full-width model in a fraction of the CPU
generator's time, other numbers); prompts of 4-11 random tokens from a
numpy generator seeded ``--seed``. Runs on the card unless ``--device cpu``
is given; without a card it raises. An encoder-decoder config (whisper)
exits with the reference's own message: its ``Server`` has no
encoder-decoder path, and neither has the port's.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda
from repro_torch.nn.module import count_params
from repro_torch.nn.transformer import build_model
from repro_torch.runtime.server import Request, Server


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Continuous-batching decode of an LM config.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's CPU-sized variant, float32")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("serve")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    if cfg.enc_dec:
        raise SystemExit("enc-dec serving demo: see examples/ for whisper")
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    log.info("%s: %d parameters on %s, compute %s, built in %.1f s",
             cfg.name, count_params(model), dev, cfg.dtype,
             time.perf_counter() - t0)
    srv = Server(model, num_slots=args.slots, max_len=args.max_len,
                 seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        srv.submit(Request(
            uid=uid, prompt=rng.integers(1, cfg.vocab_size,
                                         rng.integers(4, 12)),
            max_new_tokens=args.max_new, temperature=args.temperature))
    cuda.reset_launches()
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    dt = time.perf_counter() - t0
    if len(done) != args.requests:
        raise RuntimeError(f"requests lost: {len(done)} of {args.requests} "
                           f"drained")
    total = sum(len(r.generated) for r in done.values())
    log.info("served %d requests, %d tokens in %.2f s (%.1f tok/s, %d "
             "ticks); kernel launches %s", len(done), total, dt, total / dt,
             srv.ticks, dict(cuda.LAUNCHES) or "none (CPU)")
    for uid in sorted(done):
        log.info("req %d -> %s", uid, done[uid].generated)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
