"""Plain attention oracles (port of ``repro/kernels/ref.py:19-193``).

``mha_reference`` is the O(S^2) ground truth the kernels are held to;
``lse_reference`` gives the forward's log-sum-exp rows and
``mha_grads_reference`` the gradients, by autograd through
``mha_reference``. Two conventions carry over
from the reference: a query row with no live key gives 0, and a value row
that no query can reach is zeroed before ``p @ v`` (0 * NaN is NaN, and
rows beyond a cache cursor may hold any bit pattern).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def build_mask(sq: int, sk: int, *, causal: bool = False,
               window: Optional[int] = None,
               q_segment_ids=None, k_segment_ids=None,
               q_times=None, k_times=None, device=None) -> torch.Tensor:
    """Boolean (..., sq, sk) mask; True = may attend.

    ``q_times/k_times`` (..., S) replace token indices in the causal and
    window comparisons: block-causal attention over simulation steps.
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
    if window is not None:
        mask = mask & (cols > rows - window)
    if q_segment_ids is not None and k_segment_ids is not None:
        seg = q_segment_ids[..., :, None] == k_segment_ids[..., None, :]
        mask = mask & seg & (k_segment_ids[..., None, :] >= 0)
    return mask


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // hkv, dim=1)


def _scores_and_mask(q, k, *, causal, window, softcap, scale,
                     q_segment_ids, k_segment_ids, q_times, k_times):
    """float32 scores (B, Hq, Sq, Sk), scaled then soft-capped, and the
    boolean mask broadcastable against them."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    k = _repeat_kv(k, hq)
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if softcap is not None and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = build_mask(sq, sk, causal=causal, window=window, q_times=q_times,
                      k_times=k_times, device=q.device)
    mask = mask[:, None] if q_times is not None else mask[None, None]
    if q_segment_ids is not None:
        seg = build_mask(sq, sk, q_segment_ids=q_segment_ids,
                         k_segment_ids=k_segment_ids, device=q.device)
        mask = mask & seg[:, None]
    return s, mask


def mha_reference(q, k, v, *, causal: bool = False,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  q_segment_ids=None, k_segment_ids=None,
                  q_times=None, k_times=None,
                  kv_length=None) -> torch.Tensor:
    """O(S^2)-memory multi-head attention.

    q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv); Hkv divides
    Hq. Scores are scaled, then soft-capped (``tanh(s / c) * c``).
    ``kv_length`` (B,) masks key positions at or beyond each row's cursor.
    Returns (B, Hq, Sq, Dv) in v's dtype.
    """
    sk = k.shape[2]
    s, mask = _scores_and_mask(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_segment_ids=q_segment_ids,
                               k_segment_ids=k_segment_ids, q_times=q_times,
                               k_times=k_times)
    v = _repeat_kv(v, q.shape[1])
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


def lse_reference(q, k, *, causal: bool = False,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  q_segment_ids=None, k_segment_ids=None,
                  q_times=None, k_times=None) -> torch.Tensor:
    """O(S^2) row log-sum-exp (B, Hq, Sq) float32, the forward's ``lse``
    output. A row with no live key is about -1e30 in both this and the
    kernels; compare only rows with at least one live key."""
    s, mask = _scores_and_mask(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_segment_ids=q_segment_ids,
                               k_segment_ids=k_segment_ids, q_times=q_times,
                               k_times=k_times)
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    return torch.logsumexp(s, dim=-1)


def mha_grads_reference(q, k, v, g, **kwargs):
    """(dq, dk, dv) of ``sum(mha_reference(q, k, v, **kwargs) * g)`` by
    autograd: the gradient oracle of the backward kernels. ``g`` is the
    output cotangent."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = mha_reference(*leaves, **kwargs)
        loss = torch.sum(out.float() * g.float())
        return torch.autograd.grad(loss, leaves)
