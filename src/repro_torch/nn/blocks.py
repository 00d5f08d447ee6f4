"""The dense transformer block (port of ``repro/nn/blocks.py::Block``):
pre-norms, optional post-norms (gemma2's), an attention mixer and an MLP.

The reference's block also carries MoE, SSM and parallel-SSM mixers; the
port has not taken those families yet, and ``build_model`` raises for them
(``repro_torch.nn.transformer.unsupported``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.nn.attention import Attention, CacheStep
from repro_torch.nn.layers import LayerNorm, RMSNorm


def make_norm(kind: str, dim: int, device=None) -> nn.Module:
    """"layer" -> LayerNorm; "rms_offset" -> RMSNorm storing (w - 1);
    anything else RMSNorm."""
    if kind == "layer":
        return LayerNorm(dim, device=device)
    if kind == "rms_offset":
        return RMSNorm(dim, device=device, weight_offset=1.0)
    return RMSNorm(dim, device=device)


class Block(nn.Module):
    def __init__(self, d_model: int, attention: Optional[Attention] = None,
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
                impl: Optional[str] = None) -> torch.Tensor:
        if self.attn is not None:
            mixed = self.attn(self.norm_mix(x), pose, cache=cache,
                              layer=layer, step=step, impl=impl)
            if self.post_norms:
                mixed = self.post_norm_mix(mixed)
            x = x + mixed
        if self.mlp is not None:
            out = self.mlp(self.norm_mlp(x))
            if self.post_norms:
                out = self.post_norm_mlp(out)
            x = x + out
        return x
