"""Weights across the two packages.

The reference keeps an agent-sim model's weights as a nested dict with the
layers stacked on a leading axis under ``"blocks"``, an LM's each layer
group under ``"group{g}"`` (stacked where the group has more than one
layer), and an encoder-decoder's ``"encoder"``, ``"decoder"`` and
``"cross"`` stacks (stacked at any depth, as ``"blocks"``); the port keeps
one module per layer. Both store a Dense kernel as
``in_shape + out_shape``, so crossing over is a renaming plus the
(un)stacking:

  tree["blocks"]["attn"]["q"]["kernel"][i]  <->  "blocks.{i}.attn.q.kernel"
  tree["cross"]["attn"]["q"]["kernel"][i]   <->  "cross.{i}.attn.q.kernel"
                                                 (and "encoder", "decoder")
  tree["group{g}"]["attn"]["q"]["kernel"][i] <-> "groups.{g}.{i}.attn.q.kernel"
  tree["group{g}"]["attn"]["q"]["kernel"]    <-> "groups.{g}.0.attn.q.kernel"
                                                 (a group of one layer)
  tree["group{g}"]["a"]["attn"]["q"]["kernel"][i]
                                            <-> "groups.{g}.{i}.a.attn.q.kernel"
                                                 (gemma2's (local, global)
                                                 pairs, "a" and "b")

Every other leaf (``embedding``, ``pos_embedding``, ``final_norm``,
``lm_head``, ``enc_norm``, ``dec_norm``, ...) crosses as it is.

The same mapping carries any dict of tensors named like the model's
parameters, such as AdamW's ``mu`` and ``nu`` (checkpoints store them in
the reference's layout). The conversion is exact both ways.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

# top-level subtrees the reference stacks over layers at any depth
_STACKED = ("blocks", "encoder", "decoder", "cross")
_GROUP = re.compile(r"^group(\d+)$")


def _group_is_stacked(sub) -> bool:
    """Whether a reference ``group{g}`` subtree is stacked over layers: every
    block has a norm whose ``scale`` is (d_model,) unstacked and
    (layers, d_model) stacked."""
    if "a" in sub and "b" in sub:              # a group of layer pairs
        return _group_is_stacked(sub["a"])
    for key in sorted(sub):
        if key.startswith("norm"):
            return np.ndim(sub[key]["scale"]) == 2
    raise ValueError(f"a layer group without a norm: {sorted(sub)}")


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
    stacked = {key: _group_is_stacked(sub) for key, sub in tree.items()
               if _GROUP.match(key) and isinstance(sub, dict)}
    out = {}
    for name, arr in _flatten(tree):
        head, _, rest = name.partition(".")
        group = _GROUP.match(head)
        if head in _STACKED:
            for i in range(arr.shape[0]):
                out[f"{head}.{i}.{rest}"] = _tensor(arr[i], device)
        elif group and stacked.get(head):
            for i in range(arr.shape[0]):
                out[f"groups.{group[1]}.{i}.{rest}"] = _tensor(arr[i], device)
        elif group:
            out[f"groups.{group[1]}.0.{rest}"] = _tensor(arr, device)
        else:
            out[name] = _tensor(arr, device)
    return out


def reference_leaf(name: str) -> str:
    """The reference's leaf of a port parameter name: ``blocks.{i}.rest``
    belongs to the stacked ``blocks.rest`` (so do the encoder-decoder's
    stacks), ``groups.{g}.{i}.rest`` to ``group{g}.rest``; any other name
    is its own."""
    parts = name.split(".")
    if parts[0] in _STACKED and len(parts) > 2 and parts[1].isdigit():
        return ".".join([parts[0]] + parts[2:])
    if parts[0] == "groups" and len(parts) > 3 and parts[1].isdigit() \
            and parts[2].isdigit():
        return ".".join([f"group{parts[1]}"] + parts[3:])
    return name


def layer_index(name: str) -> int:
    """The layer (or pair) a port parameter belongs to within its group,
    0 for a name outside any."""
    parts = name.split(".")
    if parts[0] in _STACKED and len(parts) > 2 and parts[1].isdigit():
        return int(parts[1])
    if parts[0] == "groups" and len(parts) > 3 and parts[2].isdigit():
        return int(parts[2])
    return 0


def reference_groups(names) -> Dict[str, list]:
    """Port parameter names grouped by their reference leaf
    (:func:`reference_leaf`), each group in layer order: the tensors the
    reference keeps as one (stacked) array."""
    groups: Dict[str, list] = {}
    for n in names:
        groups.setdefault(reference_leaf(n), []).append(n)
    return {leaf: sorted(ns, key=layer_index) for leaf, ns in groups.items()}


def is_stacked(leaf: str, names) -> bool:
    """Whether the reference stacks the port tensors ``names`` of its leaf
    ``leaf``: a layer group of more than one layer, or the agent-sim
    ``blocks`` and the encoder-decoder's stacks (stacked at any depth), as
    :func:`reference_tensors` does."""
    return len(names) > 1 or leaf.split(".")[0] in _STACKED


def reference_tensors(named: Mapping[str, torch.Tensor]):
    """The reference's tree of tensors from a flat name -> tensor dict, on
    the tensors' device: the layers of ``blocks`` (and of the
    encoder-decoder's stacks), and of each LM group of more than one,
    stacked by ``torch.stack`` (new tensors); every other leaf the caller's
    own tensor."""
    stacked: Dict[str, Dict[int, torch.Tensor]] = {}
    tree: Dict = {}
    groups: Dict[str, Dict[str, Dict[int, torch.Tensor]]] = {}

    def put(path, t):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t

    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in _STACKED:
            stacked.setdefault(".".join([parts[0]] + parts[2:]),
                               {})[int(parts[1])] = t
        elif parts[0] == "groups":
            groups.setdefault(f"group{parts[1]}", {}).setdefault(
                ".".join(parts[3:]), {})[int(parts[2])] = t
        else:
            put(parts, t.detach())
    for leaf, layers in stacked.items():
        put(leaf.split("."),
            torch.stack([layers[i].detach() for i in range(len(layers))]))
    for group, leaves in groups.items():
        for rest, layers in leaves.items():
            if len(layers) == 1:
                put([group] + rest.split("."), layers[0].detach())
            else:
                put([group] + rest.split("."), torch.stack(
                    [layers[i].detach() for i in range(len(layers))]))
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
