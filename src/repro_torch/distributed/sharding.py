"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``,
the resolver).

Tensors carry *logical* axis names (``"embed"``, ``"heads"``,
``"act_batch"``, ...); a rule set maps each to mesh axes, and
:func:`spec_for` resolves one tensor's axes to a per-dimension tuple of
mesh axes, dropping any axis that does not divide its dimension, as the
reference's ``PartitionSpec`` does. The port replicates its parameters, so
what it shards is batch-leading data: :func:`batch_sharding` says which
rows of such an array this rank holds.

A mesh is a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) or a mapping
of axis sizes; the resolver reads only the sizes.

:func:`sharding_for_specs` and :func:`derive_opt_shardings` resolve every
parameter's and optimizer leaf's logical axes (``nn.module.ParamSpec``)
to a :class:`Shard`: its spec, and its shape and bytes on one rank of the
mesh. They place nothing: the dry-run (``launch/dryrun.py``) reads them to
say what a config would hold on a rank under the reference's rules.
Placing tensors by them (DTensor) and the activation constraints
(the reference's ``logical_constraint``) come with FSDP / tensor
parallelism, ROADMAP A10.9.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.launch.mesh import mesh_shape

# Logical axis -> tuple of mesh axes, in priority order (the reference's).
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # parameters
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "embed": ("pod", "data"),        # FSDP storage sharding
    "embed_no_fsdp": (),
    "head_dim": (),
    "kv_lora": (),
    "layers": (),
    "state": (),
    "conv": (),
    "basis": (),
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": ("model",),
    "act_embed": (),
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "act_kv": ("model",),
    "act_kvlen": ("model",),
    "act_tokens": ("pod", "data"),
    "act_cap": (),
}


class _Ctx(threading.local):
    mesh = None
    rules: Optional[Dict[str, Tuple[str, ...]]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Make ``mesh`` and ``rules`` (default :data:`DEFAULT_RULES`) the
    active ones of this thread (:func:`active_mesh`)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def dp_shard_count() -> int:
    """Data-parallel shards (pod x data) of the active mesh; 1 without
    one."""
    if _CTX.mesh is None:
        return 1
    sizes = mesh_shape(_CTX.mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _resolve_axis(dim: int, logical: Optional[str], shape: Dict[str, int],
                  rules: Dict[str, Tuple[str, ...]], used: set):
    """Mesh axes for one tensor dim, honoring divisibility and axis reuse."""
    if logical is None:
        return None
    axes = [a for a in rules.get(logical, ()) if a in shape]
    chosen = []
    size = 1
    for a in axes:
        if a in used:
            continue
        if dim % (size * shape[a]) == 0:
            chosen.append(a)
            size *= shape[a]
    for a in chosen:
        used.add(a)
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None
             ) -> tuple:
    """The mesh axes of each dimension of a tensor of ``shape`` with
    ``logical_axes``: None, an axis name, or a tuple of names; trailing
    Nones stripped, as ``PartitionSpec`` does."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = [_resolve_axis(d, ax, sizes, rules, used)
             for d, ax in zip(shape, logical_axes)]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Where the rows of a batch-leading array live: ``spec`` as
    :func:`spec_for` gives it, split into ``shards`` equal row blocks, of
    which this rank holds block ``index`` (0 when the array is replicated
    or the mesh is a mapping of sizes)."""
    spec: tuple
    shards: int
    index: int

    def rows(self, n: int) -> slice:
        """This rank's rows of an array of ``n`` rows."""
        per = n // self.shards
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh, shape: Sequence[int], rules=None) -> BatchSharding:
    """Sharding of a batch-leading array (tokens, labels, ...) over the
    mesh's data-parallel axes; replicated when the batch does not divide
    them (e.g. the batch=1 long-context shape)."""
    logical = ["act_batch"] + [None] * (len(shape) - 1)
    spec = spec_for(shape, logical, mesh, rules)
    axes = spec[0] if spec else None
    axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
    sizes = mesh_shape(mesh)
    coord = (mesh.get_coordinate() if hasattr(mesh, "get_coordinate")
             else None)
    shards, index = 1, 0
    for a in axes:
        shards *= sizes[a]
        if coord is not None:
            index = index * sizes[a] + coord[list(sizes).index(a)]
    return BatchSharding(spec, shards, index)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One tensor on one rank of a mesh: its ``spec`` (:func:`spec_for`),
    the ``shape`` of the block a rank holds and that block's ``nbytes``."""
    spec: tuple
    shape: Tuple[int, ...]
    nbytes: int


def shard_of(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh, rules=None, itemsize: int = 4) -> Shard:
    """The :class:`Shard` of a tensor of ``shape`` whose dims carry
    ``logical_axes`` (none: replicated), of ``itemsize``-byte elements."""
    shape = tuple(int(d) for d in shape)
    axes = tuple(logical_axes) or (None,) * len(shape)
    spec = spec_for(shape, axes, mesh, rules)
    sizes = mesh_shape(mesh)
    local = list(shape)
    for i, part in enumerate(spec):
        for a in (() if part is None else (part,) if isinstance(part, str)
                  else part):
            local[i] //= sizes[a]
    return Shard(spec, tuple(local), math.prod(local) * itemsize)


def _specs(specs) -> Mapping[str, Any]:
    """``{name: ParamSpec}`` of a module or of such a mapping."""
    if hasattr(specs, "named_parameters"):
        from repro_torch.nn.module import param_specs
        return param_specs(specs)
    return specs


def sharding_for_specs(specs, mesh, rules=None) -> Dict[str, Shard]:
    """``{parameter name: Shard}`` of a model's float32 parameters (a
    module, or its ``{name: ParamSpec}``) by their logical axes."""
    return {n: shard_of(s.shape, s.axes, mesh, rules)
            for n, s in _specs(specs).items()}


def _leaf_shard(t, shape, axes, mesh, rules) -> Shard:
    itemsize = t.element_size() if hasattr(t, "element_size") else 4
    return shard_of(shape, axes, mesh, rules, itemsize)


def derive_opt_shardings(specs, opt_state, mesh, rules=None):
    """The optimizer state's tree with a :class:`Shard` at every leaf,
    derived from the parameters' logical axes as the reference derives
    its shardings: AdamW's ``mu`` / ``nu`` (and an unfactored adafactor
    ``v``) as their parameter; adafactor's factored ``vr`` over the
    parameter's axes but its last, ``vc`` over all but its second last;
    ``step`` (and anything else) replicated."""
    specs = _specs(specs)

    def replicated(leaf):
        if hasattr(leaf, "shape"):
            return _leaf_shard(leaf, leaf.shape, (), mesh, rules)
        return Shard((), (), 0)

    def param_like(tree):
        return {n: _leaf_shard(t, specs[n].shape, specs[n].axes, mesh, rules)
                for n, t in tree.items()}

    def factored(tree):
        out = {}
        for n, slots in tree.items():
            sp = specs[n]
            if "vr" in slots:
                out[n] = {
                    "vr": _leaf_shard(slots["vr"], sp.shape[:-1],
                                      sp.axes[:-1], mesh, rules),
                    "vc": _leaf_shard(slots["vc"],
                                      sp.shape[:-2] + sp.shape[-1:],
                                      sp.axes[:-2] + sp.axes[-1:], mesh,
                                      rules)}
            else:
                out[n] = {"v": _leaf_shard(slots["v"], sp.shape, sp.axes,
                                           mesh, rules)}
        return out

    def walk(node):
        if isinstance(node, tuple):
            return tuple(walk(x) for x in node)
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "step":
                    out[k] = replicated(v)
                elif k in ("mu", "nu"):
                    out[k] = param_like(v)
                elif k == "v":
                    out[k] = factored(v)
                else:
                    out[k] = walk(v)
            return out
        return replicated(node)

    return walk(opt_state)


def shard_bytes(tree) -> int:
    """Bytes a rank holds of a tree of :class:`Shard` leaves."""
    if isinstance(tree, Shard):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(shard_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(shard_bytes(v) for v in tree)
    return 0
