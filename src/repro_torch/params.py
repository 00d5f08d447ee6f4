"""Weights across the two packages.

The reference keeps an agent-sim model's weights as a nested dict with the
layers stacked on a leading axis under ``"blocks"``; the port keeps one
module per layer. Both store a Dense kernel as ``in_shape + out_shape``,
so crossing over is a renaming plus the (un)stacking of ``blocks``:

  tree["blocks"]["attn"]["q"]["kernel"][i]  <->  "blocks.{i}.attn.q.kernel"

The tree holds numpy arrays (``np.asarray`` over the reference's
``init_params``); the conversion is exact both ways.
"""
from __future__ import annotations

from typing import Dict

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
            yield name, np.asarray(val)


def from_reference(tree) -> Dict[str, torch.Tensor]:
    """State dict for the port's model from the reference's numpy tree."""
    out = {}
    for name, arr in _flatten(tree):
        if name.startswith(_STACKED + "."):
            rest = name[len(_STACKED) + 1:]
            for i in range(arr.shape[0]):
                out[f"{_STACKED}.{i}.{rest}"] = torch.tensor(arr[i])
        else:
            out[name] = torch.tensor(arr)
    return out


def to_reference(model: nn.Module):
    """The reference's numpy tree from the port's model (inverse of
    :func:`from_reference`)."""
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    tree: Dict = {}

    def put(path, arr):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr

    for name, t in model.state_dict().items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == _STACKED:
            stacked.setdefault(".".join(parts[2:]), {})[int(parts[1])] = arr
        else:
            put(parts, arr)
    for rest, layers in stacked.items():
        put([_STACKED] + rest.split("."),
            np.stack([layers[i] for i in range(len(layers))]))
    return tree
