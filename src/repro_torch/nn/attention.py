"""Head split/merge helpers (port of ``repro/nn/attention.py:39-49``)."""
from __future__ import annotations

import torch


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int
                 ) -> torch.Tensor:
    """(B, S, H, D) or (B, S, H*D) -> (B, H, S, D)."""
    if x.ndim == 4:
        return x.transpose(1, 2)
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H, D); the output projection contracts both
    head axes."""
    return x.transpose(1, 2)
