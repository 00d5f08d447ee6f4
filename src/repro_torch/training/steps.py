"""Behaviour-cloning train and eval steps (port of
``repro/training/steps.py:40-95, 151-187``).

One BC update: the teacher-forced logits of the full forward (block-causal
over simulation times, the same mask the rollout cache relies on), the
validity-masked ``action_nll``, its gradients by autograd (through the flash
attention kernels on the card), then global-norm clipping and AdamW on a
warmup-cosine schedule.

The port's steps work on the model's own parameters: the train step writes
each update into them in place, where the reference returns new arrays.
So the step comes in two halves (:class:`SimTrainStep`): the gradients and
metrics, which change nothing, and the update, which the trainer skips
when the loss is not finite (the reference discards the new arrays).
Batches may be numpy dicts (as the data pipeline yields them) or tensors;
the steps move them to the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import params as pparams
from repro_torch.nn.agent_sim import AgentSimModel, action_nll
from repro_torch.optim import (Optimizer, adamw, apply_updates, chain,
                               clip_by_global_norm, global_norm,
                               warmup_cosine)

__all__ = ["bc_optimizer", "loss_summary", "SimTrainStep",
           "make_sim_train_step",
           "make_sim_eval_step", "open_loop_metrics"]


def bc_optimizer(lr: float, steps: int) -> Optimizer:
    """The BC optimizer recipe: global-norm clip + AdamW on a
    warmup-cosine schedule."""
    warmup = max(1, min(20, steps // 10))
    return chain(clip_by_global_norm(1.0),
                 adamw(warmup_cosine(lr, warmup, steps)))


def loss_summary(history: Sequence[float]) -> Dict[str, float]:
    """Endpoint means of a loss trajectory (k-step windows)."""
    k = max(1, min(5, len(history) // 2))
    return {
        "loss_first": float(np.mean(history[:k])) if len(history) else
        float("nan"),
        "loss_last": float(np.mean(history[-k:])) if len(history) else
        float("nan"),
    }


def _masked_accuracy(logits, actions, valid):
    """Fraction of valid agent steps whose argmax action matches the
    expert's."""
    pred = torch.argmax(logits.float(), dim=-1)
    w = valid.float()
    hit = (pred == actions).float()
    return torch.sum(hit * w) / torch.clamp(torch.sum(w), min=1.0)


def _on_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _logits(model: AgentSimModel, batch: Dict[str, torch.Tensor]):
    """The model's logits with its parameters cast to the compute dtype,
    as the reference's steps cast theirs (``cast_params``); in float32
    the module runs as it is."""
    dt = model.cfg.compute_dtype
    if dt == torch.float32:
        return model(batch)
    return torch.func.functional_call(
        model, pparams.cast(dict(model.named_parameters()), dt), (batch,))


@dataclasses.dataclass(frozen=True)
class SimTrainStep:
    """One BC update in two halves, so that a caller can read the loss
    between them and drop the update (the trainer's non-finite gate).

    ``grads(batch) -> (grads, metrics)`` computes the gradients and the
    metrics and changes nothing; ``update(opt_state, grads) -> opt_state``
    clips, steps AdamW and writes the parameters in place. Calling the
    object runs both: ``step(opt_state, batch) -> (opt_state, metrics)``.
    """
    grads: Callable[[Dict[str, Any]], Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]]
    update: Callable[[Any, Dict[str, torch.Tensor]], Any]

    def __call__(self, opt_state, batch):
        grads, metrics = self.grads(batch)
        return self.update(opt_state, grads), metrics


def make_sim_train_step(model: AgentSimModel,
                        optimizer: Optimizer) -> SimTrainStep:
    """One BC update: teacher-forced masked NLL -> grads -> optimizer.

    Switches on gradients for the model's parameters and returns a
    :class:`SimTrainStep`, ``step(opt_state, batch) -> (opt_state,
    metrics)``. The step updates the parameters in place; start from
    ``optimizer.init(dict(model.named_parameters()))``. ``metrics`` holds
    0-d tensors on the model's device: ``loss``, ``grad_norm`` (of the raw
    gradients, before clipping) and ``accuracy``. At ``dtype="bfloat16"``
    the forward runs on the parameters cast to bf16; the parameters, the
    optimizer's moments and the gradients stay float32.
    """
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_half(batch):
        batch = _on_device(batch, model.device)
        logits = _logits(model, batch)
        loss = action_nll(logits, batch["actions"], batch["agent_valid"])
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        with torch.no_grad():
            metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads),
                       "accuracy": _masked_accuracy(
                           logits, batch["actions"], batch["agent_valid"])}
        return grads, metrics

    @torch.no_grad()
    def update_half(opt_state, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        return opt_state

    return SimTrainStep(grads_half, update_half)


def make_sim_eval_step(model: AgentSimModel) -> Callable:
    """Open-loop evaluation of one batch with the model's current weights:
    ``eval_step(batch) -> {"nll", "accuracy"}`` (0-d tensors)."""

    @torch.no_grad()
    def eval_step(batch):
        batch = _on_device(batch, model.device)
        logits = _logits(model, batch)
        return {"nll": action_nll(logits, batch["actions"],
                                  batch["agent_valid"]),
                "accuracy": _masked_accuracy(logits, batch["actions"],
                                             batch["agent_valid"])}

    return eval_step


def open_loop_metrics(model: AgentSimModel,
                      batches: Sequence[Dict[str, Any]],
                      eval_fn: Optional[Callable] = None) -> Dict[str, float]:
    """Mean open-loop NLL / accuracy over a list of batches."""
    if not batches:
        return {"nll": float("nan"), "accuracy": float("nan")}
    if eval_fn is None:
        eval_fn = make_sim_eval_step(model)
    rows = [{k: float(v) for k, v in eval_fn(b).items()} for b in batches]
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
