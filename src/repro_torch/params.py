"""Weights across the two packages.

The reference keeps an agent-sim model's weights as a nested dict with the
layers stacked on a leading axis under ``"blocks"``; the port keeps one
module per layer. Both store a Dense kernel as ``in_shape + out_shape``,
so crossing over is a renaming plus the (un)stacking of ``blocks``:

  tree["blocks"]["attn"]["q"]["kernel"][i]  <->  "blocks.{i}.attn.q.kernel"

The same mapping carries any dict of tensors named like the model's
parameters, such as AdamW's ``mu`` and ``nu`` (checkpoints store them in
the reference's layout). The conversion is exact both ways.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

_STACKED = "blocks"


def _flatten(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _tensor(x, device) -> torch.Tensor:
    """An owning tensor on ``device`` from a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    return torch.tensor(np.asarray(x), device=device)


def from_reference(tree, device=None) -> Dict[str, torch.Tensor]:
    """Flat name -> tensor dict from a tree in the reference's layout (numpy
    arrays or tensors): a state dict for the port's model, or a named
    tensor dict such as AdamW's ``mu``. Tensors land on ``device`` (default
    the CPU)."""
    device = torch.device("cpu") if device is None else device
    out = {}
    for name, arr in _flatten(tree):
        if name.startswith(_STACKED + "."):
            rest = name[len(_STACKED) + 1:]
            for i in range(arr.shape[0]):
                out[f"{_STACKED}.{i}.{rest}"] = _tensor(arr[i], device)
        else:
            out[name] = _tensor(arr, device)
    return out


def reference_tensors(named: Mapping[str, torch.Tensor]):
    """The reference's tree of tensors from a flat name -> tensor dict, on
    the tensors' device: the ``blocks`` layers stacked by ``torch.stack``
    (new tensors), every other leaf the caller's own tensor."""
    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    tree: Dict = {}

    def put(path, t):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t

    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == _STACKED:
            stacked.setdefault(".".join(parts[2:]), {})[int(parts[1])] = t
        else:
            put(parts, t.detach())
    for rest, layers in stacked.items():
        put([_STACKED] + rest.split("."),
            torch.stack([layers[i].detach() for i in range(len(layers))]))
    return tree


def to_reference(src: Union[nn.Module, Mapping[str, torch.Tensor]]):
    """The reference's numpy tree from the port's model or from a flat name
    -> tensor dict (inverse of :func:`from_reference`). Every array is a
    copy: none aliases the caller's tensors."""
    named = src.state_dict() if isinstance(src, nn.Module) else src

    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        return node.to("cpu", copy=True).numpy()

    return to_numpy(reference_tensors(named))


def cast(named: Mapping[str, torch.Tensor],
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating-point tensors of a flat name -> tensor dict cast to
    ``dtype`` (the reference's ``nn/module.py::cast_params``: the compute
    dtype's entry into the model). The casts are differentiable, so the
    gradients of float32 parameters come back float32; a tensor already
    of ``dtype`` is returned as it is."""
    return {k: t.to(dtype) if t.is_floating_point() else t
            for k, t in named.items()}
