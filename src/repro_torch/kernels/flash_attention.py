"""Flash-attention forward (port of ``repro/kernels/flash_attention.py``).

* :func:`flash_attention_fwd` launches the CUDA kernel in
  ``csrc/flash_attention.cu`` for CUDA tensors (and raises on anything it
  does not take) and runs :func:`flash_fwd_plain` for CPU tensors.
* :func:`flash_fwd_plain` is a blocked online softmax in plain PyTorch: the
  same recurrence over key blocks, never an (Sq, Sk) tensor larger than one
  block.

Both return ``(out, lse)``: out (B, Hq, Sq, Dv) in v's dtype and the
float32 row log-sum-exp (B, Hq, Sq) the backward recomputes probabilities
from. Masks: causal and sliding window over indices, or over ``q_times`` /
``k_times`` where given; segment ids (``q_seg == k_seg`` and
``k_seg >= 0``); GQA (q head h reads kv head ``h // group``). Scores are
scaled, then soft-capped (``tanh(s / c) * c``). A row with no live key gives
0, and ``lse = m + log(max(l, 1e-30))``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_K = 128          # keys per block of the plain version


def block_mask(sq: int, k0: int, k1: int, *, causal, window, q_segment_ids,
               k_segment_ids, q_times, k_times, device) -> torch.Tensor:
    """Mask of every query row against keys [k0, k1): (B or 1, 1, Sq,
    k1 - k0) bool, broadcastable over heads."""
    if q_times is not None:
        rows = q_times[:, :, None]
        cols = k_times[:, None, k0:k1]
    else:
        rows = torch.arange(sq, device=device)[None, :, None]
        cols = torch.arange(k0, k1, device=device)[None, None, :]
    mask = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                      dtype=torch.bool, device=device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    if q_segment_ids is not None:
        ks = k_segment_ids[:, None, k0:k1]
        mask = mask & (q_segment_ids[:, :, None] == ks) & (ks >= 0)
    return mask[:, None]


def _softcapped(s, softcap):
    if softcap is not None and softcap > 0:
        return torch.tanh(s / softcap) * softcap
    return s


def flash_fwd_plain(q, k, v, *, causal: bool = False,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_segment_ids=None, k_segment_ids=None,
                    q_times=None, k_times=None):
    """The plain version: online softmax over blocks of 128 keys."""
    b, hq, sq, d = q.shape
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qf = q.float()
    m = torch.full((b, hq, sq), _NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, dv), device=q.device)
    for k0 in range(0, sk, _BLOCK_K):
        k1 = min(k0 + _BLOCK_K, sk)
        kc = k[:, :, k0:k1].float().repeat_interleave(group, dim=1)
        vc = v[:, :, k0:k1].float().repeat_interleave(group, dim=1)
        s = _softcapped(torch.einsum("bhnd,bhmd->bhnm", qf, kc) * scale,
                        softcap)
        mask = block_mask(sq, k0, k1, causal=causal, window=window,
                          q_segment_ids=q_segment_ids,
                          k_segment_ids=k_segment_ids, q_times=q_times,
                          k_times=k_times, device=q.device)
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhnm,bhmd->bhnd", p, vc)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(v.dtype), m + torch.log(l)


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_segment_ids=None, k_segment_ids=None,
                        q_times=None, k_times=None):
    """Flash-attention forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. q (B, Hq, Sq, D); k (B, Hkv, Sk, D);
    v (B, Hkv, Sk, Dv); times / segment ids (B, S) int32 or None, in (q, k)
    pairs. Returns (out, lse)."""
    kw = mask_options(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_segment_ids=q_segment_ids,
                      k_segment_ids=k_segment_ids, q_times=q_times,
                      k_times=k_times)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, **kw)
    check_inputs(q, k, v, **kw)
    b, hq, sq, d = q.shape
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((b, hq, sq, dv), dtype=v.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), device=q.device)
    _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_mask_ptrs(kw),
              out.data_ptr(), lse.data_ptr(), b, hq, hkv, sq, sk, d, dv,
              *_mask_args(kw, d), _DTYPES[q.dtype],
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda.count_launch("flash_attention_fwd")
    return out, lse


def mask_options(*, causal: bool = False, window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None, q_segment_ids=None,
                 k_segment_ids=None, q_times=None, k_times=None) -> dict:
    """The keyword options every flash entry point takes, with defaults."""
    return dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_segment_ids=q_segment_ids, k_segment_ids=k_segment_ids,
                q_times=q_times, k_times=k_times)


def _check_int(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 {shape} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def check_inputs(q, k, v, *, causal, window, softcap, scale, q_segment_ids,
                 k_segment_ids, q_times, k_times, extra=()):
    """Raise on anything the CUDA kernels do not take. ``extra`` holds more
    (name, tensor, shape) operands of q's dtype (the backward's do)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {dev}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, S, width)")
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    if tuple(k.shape) != (b, hkv, sk, d) or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit together")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    for name, t, shape in (("q", q, q.shape), ("k", k, k.shape),
                           ("v", v, v.shape), *extra):
        if t.dtype != q.dtype or t.device != dev or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be a contiguous {q.dtype} "
                             f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if d < 1 or dv < 1:
        raise ValueError(f"row widths D={d}, Dv={dv} must be positive")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if (q_times is None) != (k_times is None) or \
            (q_segment_ids is None) != (k_segment_ids is None):
        raise ValueError("times and segment ids come in (q, k) pairs")
    if q_times is not None:
        _check_int("q_times", q_times, (b, sq), dev)
        _check_int("k_times", k_times, (b, sk), dev)
    if q_segment_ids is not None:
        _check_int("q_segment_ids", q_segment_ids, (b, sq), dev)
        _check_int("k_segment_ids", k_segment_ids, (b, sk), dev)


def _mask_ptrs(kw):
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return (ptr(kw["q_times"]), ptr(kw["k_times"]), ptr(kw["q_segment_ids"]),
            ptr(kw["k_segment_ids"]))


def _mask_args(kw, d):
    """(causal, window, softcap, scale) as the kernels take them: window
    -1 and softcap 0 for none."""
    scale = kw["scale"] if kw["scale"] is not None else 1.0 / float(d) ** 0.5
    window = -1 if kw["window"] is None else int(kw["window"])
    softcap = float(kw["softcap"]) if kw["softcap"] else 0.0
    return int(bool(kw["causal"])), window, softcap, float(scale)


@functools.lru_cache(maxsize=None)
def _kernel():
    return cuda.launcher(
        "flash_attention", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
