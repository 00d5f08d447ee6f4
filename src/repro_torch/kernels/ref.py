"""Plain attention oracles (port of ``repro/kernels/ref.py``).

``mha_reference`` is the O(S^2) ground truth the kernels are held to;
``lse_reference`` gives the forward's log-sum-exp rows and
``mha_grads_reference`` the gradients, by autograd through
``mha_reference``; ``mha_chunked`` is the reference's linear-memory plain
path (an online softmax over key chunks), the LM decode's attention in the
reference. Two conventions carry over
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
               q_times=None, k_times=None, q_offset=0,
               device=None) -> torch.Tensor:
    """Boolean (..., sq, sk) mask; True = may attend.

    ``q_times/k_times`` (..., S) replace token indices in the causal and
    window comparisons: block-causal attention over simulation steps.
    ``q_offset`` (an int, or a (B,) tensor of per-row cursors) shifts the
    query positions: queries that are a suffix of the keys (decode over a
    cache). A (B,) offset gives a (B, sq, sk) mask.
    """
    if q_times is not None:
        rows = q_times[..., :, None]
        cols = k_times[..., None, :]
        mask = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                          dtype=torch.bool, device=rows.device)
    else:
        rows = _query_rows(sq, q_offset, device)
        cols = torch.arange(sk, device=device)[None, :]
        mask = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                          dtype=torch.bool, device=device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    if q_segment_ids is not None and k_segment_ids is not None:
        seg = q_segment_ids[..., :, None] == k_segment_ids[..., None, :]
        mask = mask & seg & (k_segment_ids[..., None, :] >= 0)
    return mask


def _query_rows(sq: int, q_offset, device) -> torch.Tensor:
    """Query positions: (sq, 1) for a scalar offset, (B, sq, 1) for a
    (B,) tensor of offsets."""
    rows = torch.arange(sq, device=device)[:, None]
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        return rows[None] + q_offset.to(device, torch.int64)[:, None, None]
    return rows + q_offset


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    hkv = k.shape[1]
    if hkv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // hkv, dim=1)


def _scores_and_mask(q, k, *, causal, window, softcap, scale,
                     q_segment_ids, k_segment_ids, q_times, k_times,
                     q_offset=0):
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
                      k_times=k_times, q_offset=q_offset, device=q.device)
    mask = mask[:, None] if mask.ndim == 3 else mask[None, None]
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
                  q_times=None, k_times=None, q_offset=0,
                  kv_length=None) -> torch.Tensor:
    """O(S^2)-memory multi-head attention.

    q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv); Hkv divides
    Hq. Scores are scaled, then soft-capped (``tanh(s / c) * c``).
    ``q_offset`` shifts the query positions (see :func:`build_mask`);
    ``kv_length`` (B,) masks key positions at or beyond each row's cursor.
    Returns (B, Hq, Sq, Dv) in v's dtype.
    """
    sk = k.shape[2]
    s, mask = _scores_and_mask(q, k, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_segment_ids=q_segment_ids,
                               k_segment_ids=k_segment_ids, q_times=q_times,
                               k_times=k_times, q_offset=q_offset)
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


def auto_chunk(sk: int, max_chunks: int = 64, base: int = 512) -> int:
    """The reference's chunk size: ``base``, doubled until at most
    ``max_chunks`` chunks cover ``sk`` keys."""
    c = base
    while sk > c * max_chunks:
        c *= 2
    return c


def mha_chunked(q, k, v, *, causal: bool = False,
                window: Optional[int] = None,
                softcap: Optional[float] = None,
                scale: Optional[float] = None,
                q_segment_ids=None, k_segment_ids=None,
                q_times=None, k_times=None, q_offset=0,
                kv_length=None,
                chunk_size: Optional[int] = None) -> torch.Tensor:
    """Linear-memory attention in plain PyTorch: an online softmax over key
    chunks (the reference's ``mha_chunked``, its loop as a Python loop).

    Shapes and masks as :func:`mha_reference`; ``q_offset`` an int or a
    (B,) tensor. Keys are padded to a whole number of chunks with segment
    id -1. As in the reference, a query row with no live key gets the mean
    of the reachable values (``p`` is not masked), not 0; unreachable value
    rows are zeroed before ``p @ v``.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    dev = q.device
    if chunk_size is None:
        chunk_size = auto_chunk(sk)
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    if sk % chunk_size != 0:
        pad = chunk_size - sk % chunk_size
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if k_segment_ids is None:
            k_segment_ids = torch.zeros((b, sk), dtype=torch.int32, device=dev)
            if q_segment_ids is None:
                q_segment_ids = torch.zeros((b, sq), dtype=torch.int32,
                                            device=dev)
        k_segment_ids = torch.nn.functional.pad(k_segment_ids, (0, pad),
                                                value=-1)
        if k_times is not None:
            k_times = torch.nn.functional.pad(k_times, (0, pad))
    n_chunks = k.shape[2] // chunk_size
    group = hq // hkv
    qf = q.float()
    kvl = None
    if kv_length is not None:
        kvl = torch.as_tensor(kv_length, device=dev).reshape(-1)
    neg = torch.full((), _NEG_INF, device=dev)
    m = torch.full((b, hq, sq), _NEG_INF, device=dev)
    l = torch.zeros((b, hq, sq), device=dev)
    acc = torch.zeros((b, hq, sq, dv), device=dev)
    for i in range(n_chunks):
        sl = slice(i * chunk_size, (i + 1) * chunk_size)
        kc = k[:, :, sl].repeat_interleave(group, dim=1).float()
        vc = v[:, :, sl].repeat_interleave(group, dim=1).float()
        s = torch.einsum("bhnd,bhmd->bhnm", qf, kc) * scale
        if softcap is not None and softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        cols = torch.arange(sl.start, sl.stop, device=dev)[None, :]
        if q_times is not None:
            rows = q_times[:, :, None]
            cols = k_times[:, None, sl]
        else:
            rows = _query_rows(sq, q_offset, dev)
        mask = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                          dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (cols <= rows)
        if window is not None:
            mask = mask & (cols > rows - window)
        mask = mask[:, None] if mask.ndim == 3 else mask[None, None]
        if q_segment_ids is not None:
            ks = k_segment_ids[:, sl]
            seg = ((q_segment_ids[:, :, None] == ks[:, None, :])
                   & (ks[:, None, :] >= 0))
            mask = mask & seg[:, None]
        if kvl is not None:
            live = torch.arange(sl.start, sl.stop, device=dev)[None, :] \
                < kvl[:, None]
            mask = mask & live[:, None, None, :]
        s = torch.where(mask, s, neg)
        vc = torch.where(mask.any(dim=2)[..., None], vc,
                         torch.zeros((), device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhnm,bhmd->bhnd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(v.dtype)
