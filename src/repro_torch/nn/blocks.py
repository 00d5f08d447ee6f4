"""The transformer block (port of ``repro/nn/blocks.py::Block``):
pre-norms, optional post-norms (gemma2's), an attention mixer
(``Attention`` or ``MLAttention``) and a channel mixer (an MLP, or a
``MoE`` whose load-balance loss the block returns beside its output).

The reference's block also carries SSM and parallel-SSM mixers; the port
has not taken those families yet, and ``build_model`` raises for them
(``repro_torch.nn.transformer.unsupported``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.nn.attention import CacheStep
from repro_torch.nn.layers import LayerNorm, RMSNorm
from repro_torch.nn.moe import MoE


def make_norm(kind: str, dim: int, device=None) -> nn.Module:
    """"layer" -> LayerNorm; "rms_offset" -> RMSNorm storing (w - 1);
    anything else RMSNorm."""
    if kind == "layer":
        return LayerNorm(dim, device=device)
    if kind == "rms_offset":
        return RMSNorm(dim, device=device, weight_offset=1.0)
    return RMSNorm(dim, device=device)


class Block(nn.Module):
    def __init__(self, d_model: int, attention: Optional[nn.Module] = None,
                 mlp: Optional[nn.Module] = None, norm: str = "rms",
                 post_norms: bool = False, device=None):
        super().__init__()
        self.attn, self.mlp = attention, mlp
        if attention is not None:
            self.norm_mix = make_norm(norm, d_model, device)
            if post_norms:
                self.post_norm_mix = make_norm(norm, d_model, device)
        if mlp is not None:
            self.norm_mlp = make_norm(norm, d_model, device)
            if post_norms:
                self.post_norm_mlp = make_norm(norm, d_model, device)
        self.post_norms = post_norms

    def forward(self, x: torch.Tensor, pose: Optional[torch.Tensor] = None,
                *, cache=None, layer: int = 0,
                step: Optional[CacheStep] = None,
                impl: Optional[str] = None):
        """(x, aux): aux is the MoE's load-balance loss, None without a
        MoE (a tuple, so that it passes through ``torch.utils.checkpoint``
        with x)."""
        aux = None
        if self.attn is not None:
            mixed = self.attn(self.norm_mix(x), pose, cache=cache,
                              layer=layer, step=step, impl=impl)
            if self.post_norms:
                mixed = self.post_norm_mix(mixed)
            x = x + mixed
        if self.mlp is not None:
            out = self.mlp(self.norm_mlp(x))
            if isinstance(self.mlp, MoE):
                out, aux = out
            if self.post_norms:
                out = self.post_norm_mlp(out)
            x = x + out
        return x, aux
