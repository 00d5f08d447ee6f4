"""LM step functions (port of ``repro/runtime/steps.py:27-117``): the
token cross entropy, the prefill step and the serve (decode) step.

The reference's step functions build a model from a config and take its
parameter tree at every call; the port's take the model, whose weights it
holds. ``make_train_step`` for an LM is not ported yet (ROADMAP A10.1).
"""
from __future__ import annotations

from typing import Callable

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask=None) -> torch.Tensor:
    """Mean token cross entropy in float32 (masked mean where ``mask``)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - picked
    if mask is None:
        return torch.mean(nll)
    w = mask.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def make_prefill_step(model) -> Callable:
    """``prefill(batch) -> logits (B, vocab)`` of the last position of the
    full forward over ``batch["tokens"]`` (after ``batch["prefix"]`` for a
    vision-prefix config)."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill(batch):
        if cfg.vision_prefix:
            logits, _, _ = model(batch["tokens"],
                                 prefix_embeds=batch["prefix"])
        else:
            logits, _, _ = model(batch["tokens"])
        return logits[:, -1]

    return prefill


def make_serve_step(model) -> Callable:
    """``serve_step(cache, tokens, index) -> (logits (B, vocab), cache)``:
    one decode step of ``tokens`` (B, S) written into the preallocated
    ``cache`` at ``index`` (an int, or a (B,) tensor of per-slot cursors
    with S = 1); the cache is updated in place."""

    @torch.no_grad()
    def serve_step(cache, tokens, index):
        logits, _, cache = model(tokens, cache=cache, cache_index=index)
        return logits[:, -1], cache

    return serve_step
