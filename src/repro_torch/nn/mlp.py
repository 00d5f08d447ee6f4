"""Feed-forward blocks (port of ``repro/nn/mlp.py``): the gated MLP
(SwiGLU / GeGLU), the plain two-matrix MLP and RWKV-6's channel mix."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn.layers import ACTIVATIONS, Dense
from repro_torch.nn.module import ParamSpec, new_parameter


class GatedMLP(nn.Module):
    """down(act(gate(x)) * up(x)); SwiGLU at the default ``silu``."""

    def __init__(self, d_model: int, d_ff: int, device=None,
                 activation: str = "silu"):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.gate = Dense((d_model,), (d_ff,), device, in_axes=("embed",),
                          out_axes=("mlp",))
        self.up = Dense((d_model,), (d_ff,), device, in_axes=("embed",),
                        out_axes=("mlp",))
        self.down = Dense((d_ff,), (d_model,), device, in_axes=("mlp",),
                          out_axes=("embed",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.act(self.gate(x)) * self.up(x))


class MLP(nn.Module):
    """down(act(up(x))), with biases by default (granite, whisper)."""

    def __init__(self, d_model: int, d_ff: int, device=None,
                 activation: str = "gelu", use_bias: bool = True):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.up = Dense((d_model,), (d_ff,), device, use_bias=use_bias,
                        in_axes=("embed",), out_axes=("mlp",))
        self.down = Dense((d_ff,), (d_model,), device, use_bias=use_bias,
                          in_axes=("mlp",), out_axes=("embed",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.act(self.up(x)))


class RWKVChannelMix(nn.Module):
    """RWKV-6 channel mixing: a token-shift lerp, a squared-relu key and a
    sigmoid receptance gate."""

    def __init__(self, d_model: int, d_ff: int, device=None):
        super().__init__()
        d, f = d_model, d_ff
        mix = ParamSpec((d,), init="uniform", scale=0.5,
                        axes=("embed_no_fsdp",))
        self.mix_k = new_parameter(mix, device)
        self.mix_r = new_parameter(mix, device)
        self.key = Dense((d,), (f,), device, in_axes=("embed",),
                         out_axes=("mlp",))
        self.value = Dense((f,), (d,), device, in_axes=("mlp",),
                           out_axes=("embed",))
        self.receptance = Dense((d,), (d,), device, in_axes=("embed",),
                                out_axes=("embed_no_fsdp",))

    def forward(self, x: torch.Tensor,
                shifted: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``shifted``: the previous token's activations (a decode passes
        the cached one first); None shifts ``x`` itself, zeros first."""
        if shifted is None:
            shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
        xk = x + (shifted - x) * self.mix_k.to(x.dtype)
        xr = x + (shifted - x) * self.mix_r.to(x.dtype)
        k = torch.square(F.relu(self.key(xk)))
        return torch.sigmoid(self.receptance(xr)) * self.value(k)
