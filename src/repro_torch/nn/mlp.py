"""Feed-forward blocks (port of ``repro/nn/mlp.py``): the gated MLP
(SwiGLU / GeGLU) and the plain two-matrix MLP."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.layers import ACTIVATIONS, Dense


class GatedMLP(nn.Module):
    """down(act(gate(x)) * up(x)); SwiGLU at the default ``silu``."""

    def __init__(self, d_model: int, d_ff: int, device=None,
                 activation: str = "silu"):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.gate = Dense((d_model,), (d_ff,), device)
        self.up = Dense((d_model,), (d_ff,), device)
        self.down = Dense((d_ff,), (d_model,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.act(self.gate(x)) * self.up(x))


class MLP(nn.Module):
    """down(act(up(x))), with biases by default (granite, whisper)."""

    def __init__(self, d_model: int, d_ff: int, device=None,
                 activation: str = "gelu", use_bias: bool = True):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.up = Dense((d_model,), (d_ff,), device, use_bias=use_bias)
        self.down = Dense((d_ff,), (d_model,), device, use_bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.act(self.up(x)))
