"""Mixture-of-Experts with capacity dispatch (port of
``repro/nn/moe.py``: ``_dispatch_local``, ``_combine_local`` and ``MoE``).

Each token's router picks its ``top_k`` experts (float32 logits, the
picks' softmax as their weights); the assignments are stable-sorted by
expert, ranked within their expert, and scattered into an (E, C, d)
buffer of ``C = capacity(T)`` rows an expert. An assignment ranked past C
is dropped (GShard's "dropping" strategy): it goes to a sentinel row
that is sliced off. The experts' gated FFNs run as batched products over
the buffer; the combine gathers each assignment's output back, weights it
and sums each token's ``k`` contributions. A shared-experts branch
(deepseek, kimi) runs densely beside them, and the Switch Transformer
load-balance loss comes out beside the output.

The reference groups tokens into one dispatch group a data-parallel shard
and runs the group-local sort and scatter in a ``shard_map``; a port rank
is its own process, so it is one group (the reference's ``groups == 1``
branch). The combine sums each token's contributions in a fixed order
(its assignments in sorted order), not with a scatter-add: a CUDA
``index_add_`` adds by atomics, in an order that varies run to run, and
the LM server's checks need the layer bitwise repeatable.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.nn.layers import ACTIVATIONS
from repro_torch.nn.mlp import GatedMLP
from repro_torch.nn.module import ParamSpec, new_parameter


def _dispatch_local(xt: torch.Tensor, eid: torch.Tensor, w: torch.Tensor,
                    cap: int, num_experts: int):
    """xt (T, d); eid, w (T, k). Returns the buffer (E, cap, d) and the
    sorted assignments ``(eid_s, tok_s, w_s, pos)``, each (T * k,), for
    :func:`_combine_local` (``pos == cap``: dropped)."""
    tg, d = xt.shape
    k = eid.shape[-1]
    flat_eid = eid.reshape(tg * k)
    flat_tok = torch.arange(tg * k, device=xt.device) // k
    order = torch.argsort(flat_eid, stable=True)
    eid_s = flat_eid[order]
    tok_s = flat_tok[order]
    w_s = w.reshape(tg * k)[order]
    first = torch.searchsorted(eid_s, eid_s, right=False)
    pos = torch.arange(tg * k, device=xt.device) - first
    pos = torch.where(pos < cap, pos, torch.full_like(pos, cap))
    buf = xt.new_zeros((num_experts, cap + 1, d))
    buf[eid_s, pos] = xt[tok_s]           # the dropped land on row cap
    return buf[:, :cap], eid_s, tok_s, w_s, pos


def _combine_local(eo: torch.Tensor, eid_s, tok_s, w_s, pos, cap: int,
                   tg: int) -> torch.Tensor:
    """eo (E, cap, d) -> y (T, d) float32: each token's k weighted expert
    outputs (0 for a dropped assignment), summed in the order its
    assignments have after the sort."""
    d = eo.shape[-1]
    k = tok_s.shape[0] // tg
    gathered = eo[eid_s, torch.clamp(pos, max=cap - 1)]           # (T*k, d)
    valid = (pos < cap)[:, None]
    contrib = torch.where(valid, gathered.to(torch.float32)
                          * w_s[:, None].to(torch.float32),
                          torch.zeros((), device=eo.device))
    by_token = torch.argsort(tok_s, stable=True)
    return contrib[by_token].reshape(tg, k, d).sum(dim=1)


class MoE(nn.Module):
    """Routed experts (``num_experts`` gated FFNs of width ``expert_ff``,
    ``top_k`` a token) with ``num_shared`` shared experts run as one dense
    gated MLP of width ``num_shared * expert_ff``. ``forward`` returns
    (y, aux loss)."""

    def __init__(self, d_model: int, num_experts: int, top_k: int,
                 expert_ff: int, num_shared: int = 0,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01,
                 activation: str = "silu", device=None):
        super().__init__()
        d, e, f = d_model, num_experts, expert_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.act = ACTIVATIONS[activation]
        self.router = new_parameter(ParamSpec(
            (d, e), init="normal", scale=0.006,
            axes=("embed_no_fsdp", None)), device)
        # the reference's fan_in of an (E, d, f) leaf: every axis but the
        # last (module.py's rule for rank >= 2)
        in_ax, out_ax = ("experts", "embed", "mlp"), ("experts", "mlp", "embed")
        self.gate = new_parameter(ParamSpec((e, d, f), fan_in=e * d,
                                            axes=in_ax), device)
        self.up = new_parameter(ParamSpec((e, d, f), fan_in=e * d,
                                          axes=in_ax), device)
        self.down = new_parameter(ParamSpec((e, f, d), fan_in=e * f,
                                            axes=out_ax), device)
        self.shared = (GatedMLP(d, num_shared * f, device, activation)
                       if num_shared else None)

    def capacity(self, tokens: int) -> int:
        """Rows an expert takes: ``tokens * k * capacity_factor / E``,
        rounded up to a multiple of 8, at least 8."""
        cap = int(tokens * self.top_k * self.capacity_factor
                  / self.num_experts)
        return max(8, cap + (-cap) % 8)

    def route(self, xt: torch.Tensor):
        """(top ids (T, k), their weights (T, k), aux loss) of tokens xt
        (T, d): float32 logits, ``lax.top_k``'s order (largest first)."""
        e, k = self.num_experts, self.top_k
        logits = xt.to(torch.float32) @ self.router.to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        top_logits, top_ids = torch.topk(logits, k, dim=-1, sorted=True)
        weights = torch.softmax(top_logits, dim=-1)
        # assignments an expert: integer adds, exact in any order (and no
        # host sync, which bincount's output size would take)
        ids = top_ids.reshape(-1)
        density = torch.zeros(e, dtype=torch.int64, device=ids.device
                              ).scatter_add_(0, ids, torch.ones_like(ids)
                                             ).to(torch.float32) / ids.numel()
        aux = self.aux_weight * e * torch.sum(density * probs.mean(dim=0))
        return top_ids, weights, aux

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss float32)."""
        b, s, d = x.shape
        t = b * s
        cap = self.capacity(t)
        xt = x.reshape(t, d)
        top_ids, weights, aux = self.route(xt)
        buf, eid_s, tok_s, w_s, pos = _dispatch_local(
            xt, top_ids, weights, cap, self.num_experts)
        dt = buf.dtype
        h = self.act(torch.bmm(buf, self.gate.to(dt))) * torch.bmm(
            buf, self.up.to(dt))
        eo = torch.bmm(h, self.down.to(dt))                       # (E, C, d)
        y = _combine_local(eo, eid_s, tok_s, w_s, pos, cap, t)
        if self.shared is not None:
            y = y + self.shared(xt).to(torch.float32)
        return y.to(x.dtype).reshape(b, s, d), aux
