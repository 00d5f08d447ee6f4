"""Basic layers (port of ``repro/nn/layers.py``): Dense and RMSNorm."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.nn.module import ParamSpec, new_parameter


class Dense(nn.Module):
    """y = x @ W; W has shape ``in_shape + out_shape`` (DenseGeneral), the
    reference's own layout, so weights cross over without a transpose."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 device=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = new_parameter(
            ParamSpec(self.in_shape + self.out_shape, init="fan_in",
                      fan_in=int(np.prod(self.in_shape))), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.kernel.to(x.dtype),
                               dims=len(self.in_shape))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = new_parameter(ParamSpec((dim,), init="ones"), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(x.dtype)
