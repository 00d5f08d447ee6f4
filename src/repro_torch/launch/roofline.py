"""Roofline terms of one step (port of ``repro/launch/roofline.py``).

Three terms, each in seconds a step on the target card (``launch.mesh.HW``):

    compute    = FLOPs a rank / peak FLOP/s
    memory     = bytes a rank accesses / HBM bandwidth
    collective = bytes a rank moves over its links / link bandwidth

The FLOPs and bytes are a rank's own, counted by ``obs/cost.py`` on the
``meta`` device (``launch/dryrun.py``). The reference reads its collective
bytes from the partitioned HLO text; the port has none, so
:func:`placement_collectives` counts the collectives of the port's own
placement: parameters replicated, the batch split over the data-parallel
axes ("pod", "data"). A train step then makes one all-reduce of the
float32 gradients over those axes; prefill and decode make none. The
reference's ring factor for an all-reduce over N ranks (a reduce-scatter
and an all-gather) is 2 * (N-1)/N * bytes.

The reference's ``bf16_corrected`` halves the float32 share of its
collective bytes, undoing an upcast that XLA's CPU pass makes around bf16
compute. The port moves every payload at its own dtype (the gradients are
float32 because the master weights are), so there is nothing to undo:
its ``bf16_corrected`` is ``per_chip_bytes``, and ``f32_bytes`` still says
how much of it is float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

#: the data-parallel mesh axes the port's placement splits the batch over
DP_AXES = ("pod", "data")


@dataclasses.dataclass
class CollectiveStats:
    per_chip_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0
    f32_bytes: float = 0.0     # moved bytes whose payload dtype is f32

    def add_all_reduce(self, n: int, nbytes: float) -> None:
        """One all-reduce over ``n`` ranks of an ``nbytes`` float32
        payload."""
        moved = 2.0 * (n - 1) / n * nbytes
        self.per_chip_bytes += moved
        self.by_kind["all-reduce"] = self.by_kind.get("all-reduce",
                                                      0.0) + moved
        self.count += 1
        self.f32_bytes += moved

    @property
    def bf16_corrected(self) -> float:
        """The bytes the card moves: the payloads travel at their own
        dtype, so no upcast is undone (the reference halves its f32
        share)."""
        return self.per_chip_bytes

    def to_dict(self):
        return {"per_chip_bytes": self.per_chip_bytes,
                "by_kind": self.by_kind, "count": self.count,
                "f32_bytes": self.f32_bytes,
                "bf16_corrected": self.bf16_corrected}


def placement_collectives(mode: str, grad_bytes: float,
                          sizes: Dict[str, int]) -> CollectiveStats:
    """The collectives a rank makes in one step of ``mode`` under the
    port's placement on a mesh of axis ``sizes``: for "train", one float32
    all-reduce of the ``grad_bytes`` of gradients over the data-parallel
    axes (none on a single data-parallel rank); none for "prefill" and
    "decode"."""
    stats = CollectiveStats()
    n = math.prod(sizes.get(a, 1) for a in DP_AXES)
    if mode == "train" and n > 1:
        stats.add_all_reduce(n, grad_bytes)
    return stats


def roofline_terms(flops: float, bytes_accessed: float,
                   coll: CollectiveStats, hw: Dict) -> Dict[str, float]:
    """Terms in seconds a step, from one rank's FLOPs, bytes and
    collective bytes (the reference's arithmetic)."""
    compute = flops / hw["peak_flops_bf16"]
    memory = bytes_accessed / hw["hbm_bw"]
    collective_raw = coll.per_chip_bytes / hw["ici_bw"]
    collective = coll.bf16_corrected / hw["ici_bw"]
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    total = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "collective_s_raw_f32": collective_raw,
        "dominant": dominant,
        "bound_s": total,
        "roofline_fraction_of_compute": compute / total if total > 0 else 0.0,
    }


def model_flops_for(cfg, shape, n_params: int = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for train;
    2*N*D forward-only for prefill; 2*N_active per token for decode. N is
    the parameter count of ``cfg``'s model built on ``meta`` (or
    ``n_params``)."""
    if n_params is None:
        from repro_torch.nn.module import count_params
        from repro_torch.nn.transformer import build_model
        n_params = count_params(build_model(cfg, device="meta"))
    n_active = n_params
    if cfg.moe is not None:
        # the routed experts a token does not reach
        m = cfg.moe
        moe_layers = cfg.num_layers - m.first_k_dense
        expert_params = moe_layers * m.num_experts * 3 * cfg.d_model * m.expert_ff
        active_expert = moe_layers * m.top_k * 3 * cfg.d_model * m.expert_ff
        n_active = n_params - expert_params + active_expert
    tokens = shape.global_batch * (shape.seq_len if shape.mode in
                                   ("train", "prefill") else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n_active * tokens


def summarize(record: Dict) -> str:
    t = record["terms"]
    return (f"{record['arch']:24s} {record['shape']:12s} {record['mesh']:6s} "
            f"compute={t['compute_s']*1e3:9.3f}ms memory={t['memory_s']*1e3:9.3f}ms "
            f"coll={t['collective_s']*1e3:9.3f}ms dom={t['dominant']:10s} "
            f"useful={record.get('useful_flops_frac', float('nan')):.3f}")
