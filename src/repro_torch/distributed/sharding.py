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
of axis sizes; the resolver reads only the sizes. The reference's
``sharding_for_specs``, ``derive_opt_shardings``, ``logical_constraint``
and ``dp_shard_count`` place parameters and activations of the LM stack
(FSDP / tensor parallelism) and come with it (ROADMAP A10).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

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
