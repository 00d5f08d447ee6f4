"""Train an LM config (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch phi4-mini-3.8b
    python -m repro_torch.launch.train --arch stablelm-3b --reduced --device cpu

Wires the config, the model, the LM train step and the fault-tolerant
``Trainer``, as the reference does: ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine(lr, 20, steps)))``, synthetic Zipfian LM batches
(``data/synthetic_lm.py``, seed 0) through ``ShardedIterator``, a
checkpoint every ``--ckpt-every`` steps (restored when one is there), and
SIGTERM as a preemption: checkpoint and exit.

The parameters live replicated on one device, drawn from ``--seed`` (on
the card by a CUDA generator seeded ``--seed``, as ``launch/serve.py``
draws them). One process: the reference's mesh places its parameters
over the fleet; the port's FSDP placement is ROADMAP A10.9, so a run under
several ranks raises, and ``--production-mesh`` (256 ranks; 512 with
``--multi-pod``) raises on any smaller world. Runs on the card unless
``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import tempfile
import threading

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import synthetic_lm
from repro_torch.data.pipeline import ShardedIterator
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn.module import count_params
from repro_torch.nn.transformer import build_model
from repro_torch.optim import adamw, chain, clip_by_global_norm, warmup_cosine
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig

log = logging.getLogger("repro_torch.launch.train")

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train an LM config.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's CPU-sized variant, float32")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) production mesh: needs 256 ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: (2, 16, 16), 512 ranks")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the initial weights' seed")
    return ap


def make_batch_fn(cfg, seq: int):
    """``make_batch(seed, index, batch)`` of the reference's launcher:
    synthetic tokens and labels, zero frames (an encoder-decoder's) or a
    zero vision prefix where the config takes one."""
    data_cfg = synthetic_lm.LMDataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq)

    def make(seed, idx, bs):
        b = synthetic_lm.generate_batch(seed, idx, bs, data_cfg)
        if cfg.enc_dec:
            b["frames"] = np.zeros((bs, cfg.encoder_frames, cfg.d_model),
                                   np.float32)
        if cfg.vision_prefix:
            b["prefix"] = np.zeros((bs, cfg.vision_prefix, cfg.d_model),
                                   np.float32)
        return b

    return make


def run(args) -> dict:
    """The launcher's run; returns the trainer's summary with its loss
    history under ``"history"`` and the ``Trainer`` itself (its model
    and optimizer state) under ``"trainer"``."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError("launch.train runs one process: the LM's "
                           "parameter placement over ranks is ROADMAP A10.9")
    if args.production_mesh:
        make_production_mesh(multi_pod=args.multi_pod)  # raises under 256
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    log.info("%s: %d parameters on %s, compute %s", cfg.name,
             count_params(model), dev, cfg.dtype)
    opt = chain(clip_by_global_norm(1.0),
                adamw(warmup_cosine(args.lr, 20, args.steps)))
    step = make_train_step(model, opt, remat=True)
    opt_state = opt.init(dict(model.named_parameters()))
    data = ShardedIterator(make_batch_fn(cfg, args.seq),
                           batch_size=args.batch, seed=0)

    # graceful preemption: SIGTERM triggers checkpoint-and-exit (a signal
    # handler can only be installed from the main thread)
    stop = {"flag": False}
    on_main = threading.current_thread() is threading.main_thread()
    old_handler = (signal.signal(signal.SIGTERM,
                                 lambda *_: stop.update(flag=True))
                   if on_main else None)
    trainer = Trainer(
        step, model, opt_state, data, args.ckpt_dir,
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      log_every=10),
        metrics_cb=lambda s, m: log.info(
            "step %d loss %.4f (%.2fs/step)", s, m["loss"],
            m["sec_per_step"]),
        should_stop=lambda: stop["flag"])
    try:
        trainer.restore_if_available()
        out = trainer.run()
    finally:
        data.close()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    log.info("finished: %s", out)
    return {**out, "history": list(trainer.history), "trainer": trainer}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
