"""Data-parallel training step with a compressed cross-pod gradient
reduction (port of ``repro/distributed/dp_compress.py``).

At multi-pod scale the gradient all-reduce decomposes hierarchically:

    1. a full-precision mean over the intra-pod "data" axis;
    2. an int8-quantized sum over the cross-pod "pod" axis with per-tensor
       scales, plus an error-feedback residual carried between steps so
       quantization error never accumulates as bias.

The reference writes this as one ``shard_map``; here every rank of a
:mod:`repro_torch.launch.mesh` mesh runs the step on its rows of the
global batch, and the two reductions are separate collectives on the
mesh's "data" and "pod" groups. Parameters are replicated: every rank
applies the same reduced update to its own copy, so they stay equal.

Over gloo (CPU ranks, or ranks sharing a card) card tensors are staged
through host memory for each collective; over NCCL they reduce in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import batch_sharding
from repro_torch.launch.mesh import mesh_shape
from repro_torch.optim.transforms import step_in_place
from repro_torch.params import reference_leaf


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of ``t`` over ``group``: in place on the card over
    NCCL, through a host copy over gloo."""
    if t.is_cuda and dist.get_backend(group) != "nccl":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def sum_over(tensors: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each float32 tensor of ``tensors`` summed over ``group``, in one
    all-reduce of them all."""
    names = list(tensors)
    flat = all_reduce(torch.cat([tensors[k].reshape(-1) for k in names]),
                      dist.ReduceOp.SUM, group)
    out, at = {}, 0
    for k in names:
        n = tensors[k].numel()
        out[k] = flat[at:at + n].view(tensors[k].shape)
        at += n
    return out


def _int8_psum(g: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize -> integer sum over ``group`` -> dequantize (per-tensor
    scale). The scale comes from the max over the group (one all-reduce
    MAX), so every member quantizes on the same grid and the integer sum
    is exact up to the quantization step. Returns (the dequantized sum,
    this member's dequantized transmission, for error feedback)."""
    g32 = g.to(torch.float32)
    amax = all_reduce(torch.max(torch.abs(g32)), dist.ReduceOp.MAX, group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int32)
    total = all_reduce(q, dist.ReduceOp.SUM, group)
    return total.to(torch.float32) * scale, q.to(torch.float32) * scale


def local_rows(batch: Dict[str, object], mesh):
    """This rank's rows of a global batch-leading ``batch`` over the
    mesh's data-parallel axes, "pod" then "data" (the reference's
    ``P(dp_axes)``). Raises when the batch does not divide them."""
    sizes = mesh_shape(mesh)
    shards = sizes.get("pod", 1) * sizes.get("data", 1)
    b = next(iter(batch.values())).shape[0]
    if b % shards:
        raise ValueError(f"batch {b} does not divide the mesh's {shards} "
                         f"DP shards")
    rows = batch_sharding(mesh, (b,)).rows(b)
    return {k: v[rows] for k, v in batch.items()}


def mean_over_data(grads: Dict[str, torch.Tensor], loss: torch.Tensor, mesh,
                   pod_axis: str = "pod", data_axis: str = "data"):
    """Step 1, and the loss: the full-precision mean of the gradients over
    the "data" group (one all-reduce of all of them), and of the loss over
    "data" and, where the mesh has it, "pod". Every rank gets the same
    values, so every rank's non-finite guard decides alike."""
    group = mesh.get_group(data_axis)
    n = mesh_shape(mesh)[data_axis]
    out = {k: g / n for k, g in sum_over(grads, group).items()}
    loss = all_reduce(loss.detach().reshape(()), dist.ReduceOp.SUM, group) / n
    if pod_axis in mesh_shape(mesh):
        loss = all_reduce(loss, dist.ReduceOp.SUM,
                          mesh.get_group(pod_axis)) / mesh_shape(mesh)[pod_axis]
    return out, loss


def reduce_over_pods(grads: Dict[str, torch.Tensor],
                     residual: Dict[str, torch.Tensor], mesh,
                     pod_axis: str = "pod", compress: bool = True):
    """Step 2: the cross-pod mean, int8 with error feedback when
    ``compress`` (the residual carries what this member failed to
    transmit, its own quantization error), else in full precision.
    Returns (grads, new residual); a mesh without a "pod" axis returns
    both unchanged.

    The scale is per tensor of the reference's tree: the port keeps one
    tensor a layer (``blocks.{i}.attn.q.kernel``) where the reference
    stacks the layers in one leaf, so the layers of a leaf are quantized
    together, on one grid, as the reference quantizes its leaf."""
    sizes = mesh_shape(mesh)
    if pod_axis not in sizes:
        return grads, residual
    group, npods = mesh.get_group(pod_axis), sizes[pod_axis]
    if not compress:
        return ({k: all_reduce(g, dist.ReduceOp.SUM, group) / npods
                 for k, g in grads.items()}, residual)
    leaves: Dict[str, list] = {}
    for k in grads:
        leaves.setdefault(reference_leaf(k), []).append(k)
    out, new_r = {}, {}
    for names in leaves.values():
        target = torch.cat([(grads[k].to(torch.float32) + residual[k])
                            .reshape(-1) for k in names])
        summed, sent = _int8_psum(target, group)
        summed, rest = summed / npods, target - sent
        at = 0
        for k in names:
            n = grads[k].numel()
            out[k] = summed[at:at + n].view(grads[k].shape)
            new_r[k] = rest[at:at + n].view(grads[k].shape)
            at += n
    return out, new_r


def make_compressed_dp_step(loss_fn: Callable, optimizer, mesh,
                            pod_axis: str = "pod", data_axis: str = "data",
                            compress: bool = True):
    """Returns ``step(params, opt_state, residual, batch) -> (params,
    opt_state, residual, loss)``.

    ``loss_fn(params, batch) -> 0-d tensor`` is written for one shard;
    ``batch`` is the global batch, of which each rank takes its rows over
    the mesh's DP axes. ``params`` is a dict of leaf tensors with
    gradients on, updated in place; ``residual`` (float32 tensors named as
    ``params``) carries the error-feedback state. As in the reference, a
    mesh with a "pod" axis reduces over it with int8 + error feedback
    (``compress``) even when that axis has size 1."""
    def step(params, opt_state, residual, batch):
        local = local_rows(batch, mesh)
        loss = loss_fn(params, local)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        grads, loss = mean_over_data(grads, loss, mesh, pod_axis, data_axis)
        grads, residual = reduce_over_pods(grads, residual, mesh, pod_axis,
                                           compress)
        opt_state = step_in_place(optimizer, grads, opt_state, params)
        return params, opt_state, residual, loss

    return step
