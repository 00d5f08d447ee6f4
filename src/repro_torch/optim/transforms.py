"""Gradient-transform optimizers (port of ``repro/optim/transforms.py``).

The reference's ``(init, update)`` protocol over a dict of named tensors,
written as the reference writes it rather than with ``torch.optim``, so
that the arithmetic matches by construction: AdamW's ``b2 = 0.95`` and
``eps`` outside the square root of the bias-corrected second moment, the
schedule evaluated at ``step + 1``, and the clip scale
``min(1, max_norm / max(norm, 1e-9))``.

``update(grads, state, params) -> (updates, new_state)``: updates carry the
``-lr`` sign and are added to the parameters by :func:`apply_updates`.
Every step-dependent scalar stays a tensor, so an update never waits on
the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]
OptState = Any
Schedule = Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]


def _to_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def global_norm(tensors: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tensors.values()))


def chain(*opts: Optimizer) -> Optimizer:
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params):
        new_states = []
        for o, s in zip(opts, state):
            grads, ns = o.update(grads, s, params)
            new_states.append(ns)
        return grads, tuple(new_states)

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        gnorm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        return {n: (g.float() * scale).to(g.dtype)
                for n, g in grads.items()}, ()

    return Optimizer(init, update)


def sgd(lr) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        return {n: -lr_t * g.float() for n, g in grads.items()}, \
            {"step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        return {"step": 0,
                "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        t = torch.tensor(step, dtype=torch.float32)
        b1c = 1.0 - torch.pow(b1, t)
        b2c = 1.0 - torch.pow(b2, t)
        updates, mu_new, nu_new = {}, {}, {}
        for n, g in grads.items():
            g = g.float()
            mu = b1 * state["mu"][n] + (1 - b1) * g
            nu = b2 * state["nu"][n] + (1 - b2) * g * g
            updates[n] = -lr_t * (mu / b1c / (torch.sqrt(nu / b2c) + eps)
                                  + weight_decay * params[n].float())
            mu_new[n], nu_new[n] = mu, nu
        return updates, {"step": step, "mu": mu_new, "nu": nu_new}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """Add ``updates`` to ``params`` in place (the reference returns new
    arrays; the port updates the model's own parameters) and return
    ``params``."""
    for n, p in params.items():
        p.copy_((p.float() + updates[n]).to(p.dtype))
    return params
