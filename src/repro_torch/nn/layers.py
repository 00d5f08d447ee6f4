"""Basic layers (port of ``repro/nn/layers.py``): Dense, the norms, the
token embedding, sinusoidal positions and the activations."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn.module import ParamSpec, new_parameter


class Dense(nn.Module):
    """y = x @ W (+ b); W has shape ``in_shape + out_shape`` (DenseGeneral),
    the reference's own layout, so weights cross over without a transpose.
    The kernel (and bias) are cast to the input's dtype at every call, as
    the reference's are. ``in_axes`` / ``out_axes`` are the logical axes
    of the input and output dims (the kernel's are both, the bias's the
    output's)."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 device=None, use_bias: bool = False, *,
                 in_axes: Tuple[Optional[str], ...] = (),
                 out_axes: Tuple[Optional[str], ...] = ()):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = new_parameter(
            ParamSpec(self.in_shape + self.out_shape, init="fan_in",
                      fan_in=int(np.prod(self.in_shape)),
                      axes=tuple(in_axes) + tuple(out_axes)), device)
        self.bias = (new_parameter(ParamSpec(self.out_shape, init="zeros",
                                             axes=out_axes), device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.tensordot(x, self.kernel.to(x.dtype),
                            dims=len(self.in_shape))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class RMSNorm(nn.Module):
    """Normalises in float32; ``weight_offset`` 1.0 stores the scale as
    (w - 1), gemma's convention (initialised at zeros)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 weight_offset: float = 0.0):
        super().__init__()
        self.eps = eps
        self.weight_offset = weight_offset
        self.scale = new_parameter(ParamSpec(
            (dim,), init="zeros" if weight_offset else "ones",
            axes=("embed_no_fsdp",)), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        w = self.scale.to(torch.float32)
        if self.weight_offset:
            w = w + self.weight_offset
        return (y * w).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = new_parameter(ParamSpec((dim,), init="ones",
                                             axes=("embed_no_fsdp",)), device)
        self.bias = new_parameter(ParamSpec((dim,), init="zeros",
                                            axes=("embed_no_fsdp",)), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        y = y * self.scale.to(torch.float32) + self.bias.to(torch.float32)
        return y.to(x.dtype)


class Embedding(nn.Module):
    """Token embedding table (vocab, dim), normal(``scale``) at init.

    The lookup gathers rows and casts them to the compute dtype (the
    reference casts the table, then gathers: the same values);
    :meth:`attend` gives tied-weight logits ``x @ E^T``. ``axes`` are the
    table's logical axes (a learned position table's rows are ``None``)."""

    def __init__(self, vocab_size: int, dim: int, device=None,
                 scale_by_sqrt_dim: bool = False, scale: float = 0.02,
                 axes: Tuple[Optional[str], ...] = ("vocab", "embed")):
        super().__init__()
        self.dim = dim
        self.scale_by_sqrt_dim = scale_by_sqrt_dim
        self.embedding = new_parameter(
            ParamSpec((vocab_size, dim), init="normal", scale=scale,
                      axes=axes), device)

    def forward(self, tokens: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        out = F.embedding(tokens.long(), self.embedding).to(dtype)
        if self.scale_by_sqrt_dim:
            out = out * torch.tensor(np.sqrt(self.dim), dtype=dtype,
                                     device=out.device)
        return out

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-weights logits: x @ E^T."""
        return x @ self.embedding.to(x.dtype).T


def sinusoidal_positions(length: int, dim: int,
                         max_timescale: float = 10000.0) -> torch.Tensor:
    """Standard transformer sin/cos table (length, dim), float32."""
    positions = np.arange(length)[:, None]
    dims = np.arange(dim // 2)[None, :]
    angles = positions / (max_timescale ** (2 * dims / dim))
    table = np.concatenate([np.sin(angles), np.cos(angles)], axis=-1)
    return torch.as_tensor(table, dtype=torch.float32)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


#: ``jax.nn.gelu`` defaults to ``approximate=True``, so the reference's
#: "gelu" is the tanh form, the same as "gelu_tanh" (``F.gelu``'s default
#: is the exact erf form)
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "gelu_tanh": _gelu_tanh,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}
