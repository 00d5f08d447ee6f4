"""Plain attention oracle (port of ``repro/kernels/ref.py:19-150``).

``mha_reference`` is the O(S^2) ground truth the decode paths are held to,
and the full forward of the agent-sim model. Two conventions carry over
from the reference: a query row with no live key gives 0, and a value row
that no query can reach is zeroed before ``p @ v`` (0 * NaN is NaN, and
rows beyond a cache cursor may hold any bit pattern).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def build_mask(sq: int, sk: int, *, causal: bool = False,
               q_segment_ids=None, k_segment_ids=None,
               q_times=None, k_times=None, device=None) -> torch.Tensor:
    """Boolean (..., sq, sk) mask; True = may attend.

    ``q_times/k_times`` (..., S) replace token indices in the causal
    comparison: block-causal attention over simulation steps.
    """
    if q_times is not None:
        rows = q_times[..., :, None]
        cols = k_times[..., None, :]
        mask = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                          dtype=torch.bool, device=rows.device)
    else:
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(sk, device=device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (cols <= rows)
    if q_segment_ids is not None and k_segment_ids is not None:
        seg = q_segment_ids[..., :, None] == k_segment_ids[..., None, :]
        mask = mask & seg & (k_segment_ids[..., None, :] >= 0)
    return mask


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // hkv, dim=1)


def mha_reference(q, k, v, *, causal: bool = False,
                  scale: Optional[float] = None,
                  q_segment_ids=None, k_segment_ids=None,
                  q_times=None, k_times=None,
                  kv_length=None) -> torch.Tensor:
    """O(S^2)-memory multi-head attention.

    q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv); Hkv divides
    Hq. ``kv_length`` (B,) masks key positions at or beyond each row's
    cursor. Returns (B, Hq, Sq, Dv) in v's dtype.
    """
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    mask = build_mask(sq, sk, causal=causal, q_times=q_times,
                      k_times=k_times, device=q.device)
    mask = mask[:, None] if q_times is not None else mask[None, None]
    if q_segment_ids is not None:
        seg = build_mask(sq, sk, q_segment_ids=q_segment_ids,
                         k_segment_ids=k_segment_ids, device=q.device)
        mask = mask & seg[:, None]
    if kv_length is not None:
        kvl = torch.as_tensor(kv_length, device=q.device).reshape(-1)
        live = torch.arange(sk, device=q.device)[None, :] < kvl[:, None]
        mask = mask & live[:, None, None, :]
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    v = torch.where(mask.any(dim=2)[..., None], v, torch.zeros((), dtype=v.dtype,
                                                              device=v.device))
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(v.dtype)
