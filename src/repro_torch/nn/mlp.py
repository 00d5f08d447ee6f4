"""Gated feed-forward block (port of ``repro/nn/mlp.py::GatedMLP``)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn.layers import Dense


class GatedMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.gate = Dense((d_model,), (d_ff,), device)
        self.up = Dense((d_model,), (d_ff,), device)
        self.down = Dense((d_ff,), (d_model,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))
