"""Relative scaled dot-product attention (port of
``repro/core/attention.py``: the paper's Algorithms 1 and 2).

``relative_attention_quadratic`` materialises phi(p_{n->m}) for every pair,
O(N * M) memory, and is the correctness oracle.
``relative_attention_linear`` is Algorithm 2: O(N + M) pre- and
post-transforms around a standard attention, which the caller may inject
(:func:`flash_sdpa` runs the flash kernels).

Conventions: q ``(..., N, d)``, k / v ``(..., M, d)``, poses
``(..., N, pose_dim)`` / ``(..., M, pose_dim)``; mask ``(..., N, M)``
boolean (True = attend) or None. Leading dims broadcast.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.core import se2
from repro_torch.core.encodings import GroupEncoding
from repro_torch.kernels import ops

SdpaFn = Callable[..., torch.Tensor]

_NEG_INF = -1e30


def sdpa_reference(q, k, v, mask=None, scale: Optional[float] = None):
    """Plain softmax attention, accumulated in float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...nd,...md->...nm", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, -1)
    return torch.einsum("...nm,...md->...nd", probs, v.float()).to(v.dtype)


def flash_sdpa(q, k, v, mask=None, scale: Optional[float] = None):
    """:func:`sdpa_reference` through ``ops.attention(impl="flash")``: the
    flash forward and backward kernels for CUDA tensors, their plain
    versions for CPU tensors. Takes no mask; the leading dims of q, k and
    v are broadcast together and flattened into the batch."""
    if mask is not None:
        raise ValueError("flash_sdpa takes no mask")
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2], v.shape[:-2])

    def flat(x):
        x = x.expand(*lead, *x.shape[-2:])
        return x.reshape(-1, 1, *x.shape[-2:]).contiguous()

    out = ops.attention(flat(q), flat(k), flat(v), impl="flash", scale=scale)
    return out.reshape(*lead, *out.shape[-2:])


def relative_attention_quadratic(enc: GroupEncoding, q, k, v, pose_q, pose_k,
                                 mask=None, scale: Optional[float] = None):
    """Algorithm 1, the O(N * M)-memory oracle:
    ``b_nm = q_n^T phi(p_{n->m}) k_m``,
    ``o_n = sum_m softmax(b)_nm phi(p_{n->m}) v_m``."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    if enc.pose_dim == 3:
        p_rel = se2.relative(pose_q[..., :, None, :], pose_k[..., None, :, :])
    else:
        p_rel = pose_k[..., None, :, :] - pose_q[..., :, None, :]
    phik = enc.apply_phi(p_rel, torch.broadcast_to(
        k[..., None, :, :], p_rel.shape[:-1] + k.shape[-1:]))
    logits = torch.einsum("...nd,...nmd->...nm", q, phik).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, -1)
    if enc.transforms_values:
        phiv = enc.apply_phi(p_rel, torch.broadcast_to(
            v[..., None, :, :], p_rel.shape[:-1] + v.shape[-1:]))
        out = torch.einsum("...nm,...nmd->...nd", probs, phiv.float())
    else:
        out = torch.einsum("...nm,...md->...nd", probs, v.float())
    return out.to(v.dtype)


def relative_attention_linear(enc: GroupEncoding, q, k, v, pose_q, pose_k,
                              mask=None, scale: Optional[float] = None,
                              sdpa_fn: SdpaFn = sdpa_reference,
                              fold_scale: bool = False, **sdpa_kwargs):
    """Algorithm 2: linear-memory relative attention around a standard
    attention ``sdpa_fn(q, k, v, mask=..., scale=...)``.

    With ``fold_scale`` the paper's Algorithm 2 verbatim: ``(c/d)^{1/4}``
    folded into q~ and k~, and the attention's default ``1/sqrt(c)``;
    otherwise ``1/sqrt(d)`` is passed explicitly (the same result, one
    multiply less).
    """
    d = q.shape[-1]
    qt = enc.transform_q(q, pose_q)
    kt = enc.transform_k(k, pose_k)
    vt = enc.transform_v(v, pose_k)
    if fold_scale:
        gamma = (float(qt.shape[-1]) / float(d)) ** 0.25
        qt, kt = qt * gamma, kt * gamma
        eff_scale = None
    else:
        eff_scale = (1.0 / float(d) ** 0.5) if scale is None else scale
    ot = sdpa_fn(qt, kt, vt, mask=mask, scale=eff_scale, **sdpa_kwargs)
    if enc.transforms_values:
        ot = enc.untransform_out(ot, pose_q)
    return ot


def invariance_gap(enc: GroupEncoding, q, k, v, pose_q, pose_k, z,
                   mask=None, linear: bool = True, **kwargs):
    """Max |difference| of the attention outputs under a global transform
    z of every pose: about 0 for the exact encodings (rope1d, rope2d,
    se2_repr), the Fourier truncation error for se2_fourier. ``kwargs``
    go to :func:`relative_attention_linear` (e.g. ``sdpa_fn``)."""
    fn = (functools.partial(relative_attention_linear, **kwargs) if linear
          else relative_attention_quadratic)
    out = fn(enc, q, k, v, pose_q, pose_k, mask=mask)
    if enc.pose_dim == 3:
        zq = se2.compose(torch.broadcast_to(z, pose_q.shape), pose_q)
        zk = se2.compose(torch.broadcast_to(z, pose_k.shape), pose_k)
    else:
        zq, zk = pose_q + z, pose_k + z
    out_z = fn(enc, q, k, v, zq, zk, mask=mask)
    return torch.max(torch.abs(out - out_z))
