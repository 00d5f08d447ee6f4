"""Behaviour-cloning train and eval steps (port of
``repro/training/steps.py``).

One BC update: the teacher-forced logits of the full forward (block-causal
over simulation times, the same mask the rollout cache relies on), the
validity-masked ``action_nll``, its gradients by autograd (through the flash
attention kernels on the card), then global-norm clipping and AdamW on a
warmup-cosine schedule.

The port's steps work on the model's own parameters: the train step writes
each update into them in place, where the reference returns new arrays.
So the step comes in two halves (:class:`~repro_torch.runtime.trainer.
TrainStep`): the gradients and metrics, which change nothing, and the
update (:func:`repro_torch.optim.step_in_place`), which the trainer skips
when the loss is not finite (the reference discards the new arrays).
Batches may be numpy dicts (as the data pipeline yields them) or tensors;
the steps move them to the model's device.

Across ranks (:mod:`repro_torch.launch.mesh`), with parameters replicated:
``make_sim_train_step(..., group=)`` is the global-batch step, each rank
on its share of the batch, the NLL's sum and valid count all-reduced
before the division (the counterpart of the reference's GSPMD step); and
:func:`make_sim_dp_train_step` is the compressed-DP step of
``repro.distributed.dp_compress``, a per-shard loss meaned over "data"
and reduced in int8 with error feedback over "pod".
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import params as pparams
from repro_torch.distributed import dp_compress
from repro_torch.distributed.sharding import batch_sharding
from repro_torch.nn.agent_sim import AgentSimModel, action_nll, nll_terms
from repro_torch.optim import (Optimizer, adamw, chain, clip_by_global_norm,
                               global_norm, step_in_place, warmup_cosine)
from repro_torch.runtime.trainer import TrainStep
from repro_torch.training.data import TRAIN_KEYS

__all__ = ["bc_optimizer", "loss_summary", "make_sim_train_step", "make_sim_dp_train_step", "sim_dp_state",
           "make_sim_eval_step", "open_loop_metrics", "sim_input_specs",
           "sim_batch_shardings"]


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


def make_sim_train_step(model: AgentSimModel, optimizer: Optimizer, *,
                        group=None) -> TrainStep:
    """One BC update: teacher-forced masked NLL -> grads -> optimizer.

    Switches on gradients for the model's parameters and returns a
    :class:`~repro_torch.runtime.trainer.TrainStep`, ``step(opt_state,
    batch) -> (opt_state, metrics)``. The step updates the parameters in
    place; start from
    ``optimizer.init(dict(model.named_parameters()))``. ``metrics`` holds
    0-d tensors on the model's device: ``loss``, ``grad_norm`` (of the raw
    gradients, before clipping) and ``accuracy``. At ``dtype="bfloat16"``
    the forward runs on the parameters cast to bf16; the parameters, the
    optimizer's moments and the gradients stay float32.

    ``group``: a process group whose ranks each bring their share of one
    global batch. The valid count and the argmax hits are all-reduced
    before the backward, each rank's NLL sum is divided by the global
    count and its gradients all-reduced, so every rank computes the
    single-process step on the global batch (up to the order of the sums)
    and applies the same update.
    """
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_global(batch):
        batch = _on_device(batch, model.device)
        logits = _logits(model, batch)
        actions, valid = batch["actions"], batch["agent_valid"]
        total, count = nll_terms(logits, actions, valid)
        hits = torch.sum((torch.argmax(logits.detach().float(), dim=-1)
                          == actions).float() * valid.float())
        sums = dp_compress.all_reduce(torch.stack([count, hits]),
                                      dist.ReduceOp.SUM, group)
        count_all = torch.clamp(sums[0], min=1.0)
        local = total / count_all
        out = dp_compress.sum_over(dict(zip(params, torch.autograd.grad(
            local, list(params.values())))), group)
        with torch.no_grad():
            loss = dp_compress.all_reduce(local.detach(), dist.ReduceOp.SUM,
                                          group)
            metrics = {"loss": loss, "grad_norm": global_norm(out),
                       "accuracy": sums[1] / count_all}
        return out, metrics

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

    def update_half(opt_state, grads):
        return step_in_place(optimizer, grads, opt_state, params)

    return TrainStep(grads_half if group is None else grads_global,
                     update_half)


def sim_dp_state(optimizer: Optimizer, params) -> Dict[str, Any]:
    """State of :func:`make_sim_dp_train_step`: the optimizer state plus
    the error-feedback residual the compressed cross-pod reduction carries
    between steps (zeros at init: nothing untransmitted yet)."""
    return {"opt": optimizer.init(params),
            "residual": {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}}


def make_sim_dp_train_step(model: AgentSimModel, optimizer: Optimizer, mesh,
                           *, compress: bool = True) -> TrainStep:
    """The fleet-scale BC update over a ("pod", "data") mesh
    (:func:`repro_torch.launch.mesh.make_fleet_mesh`): the masked NLL of
    this rank's rows of the global batch, its gradients meaned in full
    precision over "data", and, where the mesh has a "pod" axis, reduced
    over it in int8 with error feedback (``compress``; in full precision
    without), as ``repro.distributed.dp_compress.make_compressed_dp_step``.

    A :class:`~repro_torch.runtime.trainer.TrainStep` over ``state =
    sim_dp_state(optimizer, params)``, so the
    :class:`~repro_torch.runtime.trainer.Trainer` runs it and checkpoints the residual beside the optimizer. Its gradient
    half reduces the gradients over "data" and the loss over the whole
    mesh, so every rank's non-finite guard reads the same loss and all
    ranks skip together; its update half runs the cross-pod reduction
    (which needs the state's residual) and the update. Raises when the
    global batch does not divide the mesh's DP shards."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_half(batch):
        local = _on_device(dp_compress.local_rows(batch, mesh), model.device)
        logits = _logits(model, local)
        loss = action_nll(logits, local["actions"], local["agent_valid"])
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        grads, loss = dp_compress.mean_over_data(grads, loss, mesh)
        return grads, {"loss": loss}

    @torch.no_grad()
    def update_half(state, grads):
        grads, residual = dp_compress.reduce_over_pods(
            grads, state["residual"], mesh, compress=compress)
        opt = step_in_place(optimizer, grads, state["opt"], params)
        return {"opt": opt, "residual": residual}

    return TrainStep(grads_half, update_half)


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


def sim_input_specs(scen, batch_size: int) -> Dict[str, torch.Tensor]:
    """Stand-ins of one training batch on the meta device (shapes and
    dtypes, no storage), the reference's ``ShapeDtypeStruct`` specs."""
    b, m = batch_size, scen.num_map
    t, a = scen.num_steps, scen.num_agents
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    shapes = {
        "map_feats": ((b, m, scen.map_feat_dim), f32),
        "map_pose": ((b, m, 3), f32),
        "map_valid": ((b, m), bl),
        "agent_feats": ((b, t, a, scen.agent_feat_dim), f32),
        "agent_pose": ((b, t, a, 3), f32),
        "agent_valid": ((b, t, a), bl),
        "actions": ((b, t, a), i32),
    }
    assert set(shapes) == set(TRAIN_KEYS)
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in shapes.items()}


def sim_batch_shardings(specs: Dict[str, Any], mesh, rules=None):
    """Where each leaf of a batch-leading sim batch lives over the mesh's
    DP axes (:func:`repro_torch.distributed.sharding.batch_sharding`)."""
    return {k: batch_sharding(mesh, v.shape, rules)
            for k, v in specs.items()}
