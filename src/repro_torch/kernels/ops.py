"""Attention dispatch (port of ``repro/kernels/ops.py:278-497``).

The flash path's ``jax.custom_vjp`` becomes :class:`FlashAttention`, a
``torch.autograd.Function``: its forward saves q, k, v, the output and the
forward's log-sum-exp rows (all O(S), no (Sq, Sk) tensor), and its backward
recomputes block probabilities from them. The reference pads to the TPU's
128-lane tiles around its kernels (``_pad_all``); the CUDA kernels mask
their own ragged edges, so nothing here pads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.obs import cost


def decode_attention(q, k, v, *, kv_length, impl: str = "auto",
                     scale: Optional[float] = None,
                     q_segment_ids=None, k_segment_ids=None,
                     q_times=None, k_times=None,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     k_scale=None, v_scale=None,
                     num_splits: Optional[int] = None,
                     layer: Optional[int] = None):
    """Attention of a few new query rows against a preallocated (possibly
    int8) cache bounded per row by ``kv_length``.

    ``impl``:
      * ``"auto"`` / ``"flash_decode"``: the CUDA split-K ragged kernel for
        a CUDA tensor, its plain version for a CPU tensor;
      * ``"plain"``: the plain version on any device;
      * ``"ref"``: the O(S^2) oracle over the dequantized layer slice.

    ``layer`` marks k/v (and scales) as the stacked (L, B, Hkv, S, .) cache.
    ``window`` (over the times, which it needs) and ``softcap`` as the
    flash kernels'.
    """
    common = dict(k_scale=k_scale, v_scale=v_scale,
                  q_segment_ids=q_segment_ids, k_segment_ids=k_segment_ids,
                  q_times=q_times, k_times=k_times, window=window,
                  softcap=softcap, scale=scale, layer=layer)
    if impl in ("auto", "flash_decode", "plain"):
        with cost.kernel_cost(lambda: cost.decode_cost(
                q, k, v, layer, k_scale, v_scale, kv_length, q_times,
                k_times, q_segment_ids, k_segment_ids)):
            if impl == "plain":
                return fd.decode_plain(q, k, v, kv_length, **common)
            return fd.flash_decode(q, k, v, kv_length,
                                   num_splits=num_splits, **common)
    if impl == "ref":
        if layer is not None:
            k, v = k[layer], v[layer]
            k_scale = None if k_scale is None else k_scale[layer]
            v_scale = None if v_scale is None else v_scale[layer]
        if k_scale is not None:
            k = fd.dequantize_kv(k, k_scale, dtype=q.dtype)
        if v_scale is not None:
            v = fd.dequantize_kv(v, v_scale, dtype=q.dtype)
        return attention(q, k, v, impl="ref", causal=q_times is not None,
                         window=window, softcap=softcap,
                         scale=scale, q_segment_ids=q_segment_ids,
                         k_segment_ids=k_segment_ids, q_times=q_times,
                         k_times=k_times, kv_length=kv_length)
    raise ValueError(f"unknown decode_attention impl {impl!r}")


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``_flash`` with its
    forward and backward rules).

    ``plain=False`` runs :func:`flash_attention.flash_attention_fwd` and
    :func:`flash_attention_bwd.flash_attention_bwd`, which launch the CUDA
    kernels for CUDA tensors and run their plain versions for CPU tensors;
    ``plain=True`` runs the plain versions on any device. Integer masks
    and options get no gradient. Each direction reports its shape-only
    cost to a first call being counted (``obs.cost``).
    """

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, k_segment_ids, q_times,
                k_times, causal, window, softcap, scale, plain):
        opts = dict(causal=causal, window=window, softcap=softcap,
                    scale=scale)
        fwd = fa.flash_fwd_plain if plain else fa.flash_attention_fwd
        with cost.kernel_cost(lambda: cost.flash_fwd_cost(
                q, k, v, causal, q_times, k_times, q_segment_ids,
                k_segment_ids)):
            out, lse = fwd(q, k, v, q_segment_ids=q_segment_ids,
                           k_segment_ids=k_segment_ids, q_times=q_times,
                           k_times=k_times, **opts)
        ctx.save_for_backward(q, k, v, out, lse, q_segment_ids,
                              k_segment_ids, q_times, k_times)
        ctx.opts, ctx.plain = opts, plain
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, q_seg, k_seg, q_times, k_times = ctx.saved_tensors
        bwd = fab.flash_bwd_plain if ctx.plain else fab.flash_attention_bwd
        with cost.kernel_cost(lambda: cost.flash_bwd_cost(
                q, k, v, ctx.opts["causal"], q_times, k_times, q_seg,
                k_seg)):
            dq, dk, dv = bwd(q, k, v, out, lse, g.contiguous(),
                             q_segment_ids=q_seg, k_segment_ids=k_seg,
                             q_times=q_times, k_times=k_times, **ctx.opts)
        return (dq, dk, dv) + (None,) * 9


def attention(q, k, v, *, impl: str = "auto", causal: bool = False,
              window: Optional[int] = None, softcap: Optional[float] = None,
              scale: Optional[float] = None,
              q_segment_ids=None, k_segment_ids=None,
              q_times=None, k_times=None, q_offset=0, kv_length=None):
    """Full multi-head attention, differentiable in q, k and v.

    ``impl``:
      * ``"auto"`` / ``"flash"``: the CUDA forward and backward kernels for
        CUDA tensors, their plain versions for CPU tensors;
      * ``"plain"``: the plain versions (blocked online softmax forward,
        blocked backward) on any device;
      * ``"chunked"``: the reference's linear-memory plain path
        (:func:`ref.mha_chunked`), chosen by name only: nothing else
        routes to it;
      * ``"ref"``: the O(S^2) oracle, differentiated by autograd.

    ``q_offset`` (an int or a (B,) tensor: queries that are a suffix of
    the keys) and ``kv_length`` (decode cursors) are taken by ``"chunked"``
    and ``"ref"`` only: the decode shape goes through
    :func:`decode_attention`.
    """
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_segment_ids=q_segment_ids, k_segment_ids=k_segment_ids,
              q_times=q_times, k_times=k_times)
    if impl == "ref":
        return ref.mha_reference(q, k, v, q_offset=q_offset,
                                 kv_length=kv_length, **kw)
    if impl == "chunked":
        return ref.mha_chunked(q, k, v, q_offset=q_offset,
                               kv_length=kv_length, **kw)
    if impl not in ("auto", "flash", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if kv_length is not None:
        raise ValueError("kv_length takes impl='ref' or 'chunked'; use "
                         "decode_attention")
    if isinstance(q_offset, torch.Tensor) or q_offset:
        raise NotImplementedError("q_offset takes impl='ref' or 'chunked'")
    return FlashAttention.apply(q, k, v, q_segment_ids, k_segment_ids,
                                q_times, k_times, causal, window, softcap,
                                scale, impl == "plain")
