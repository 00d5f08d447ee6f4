"""Attention dispatch (port of ``repro/kernels/ops.py:363-497``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref


def decode_attention(q, k, v, *, kv_length, impl: str = "auto",
                     scale: Optional[float] = None,
                     q_segment_ids=None, k_segment_ids=None,
                     q_times=None, k_times=None,
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
    """
    common = dict(k_scale=k_scale, v_scale=v_scale,
                  q_segment_ids=q_segment_ids, k_segment_ids=k_segment_ids,
                  q_times=q_times, k_times=k_times, scale=scale, layer=layer)
    if impl in ("auto", "flash_decode"):
        return fd.flash_decode(q, k, v, kv_length, num_splits=num_splits,
                               **common)
    if impl == "plain":
        return fd.decode_plain(q, k, v, kv_length, **common)
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
                         scale=scale, q_segment_ids=q_segment_ids,
                         k_segment_ids=k_segment_ids, q_times=q_times,
                         k_times=k_times, kv_length=kv_length)
    raise ValueError(f"unknown decode_attention impl {impl!r}")


def attention(q, k, v, *, impl: str = "ref", causal: bool = False,
              scale: Optional[float] = None,
              q_segment_ids=None, k_segment_ids=None,
              q_times=None, k_times=None, kv_length=None):
    """Full multi-head attention. Only the oracle is ported so far; the
    flash forward kernel comes with the training slice (see ROADMAP.md)."""
    if impl != "ref":
        raise ValueError(f"attention impl {impl!r} is not ported; use 'ref'")
    return ref.mha_reference(q, k, v, causal=causal, scale=scale,
                             q_segment_ids=q_segment_ids,
                             k_segment_ids=k_segment_ids, q_times=q_times,
                             k_times=k_times, kv_length=kv_length)
