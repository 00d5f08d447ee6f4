"""Split-K ragged decode over a layer-stacked K/V cache (port of
``repro/kernels/flash_decode.py``).

A rollout tick attends a handful of new query rows against a preallocated
cache whose live prefix is bounded per row by ``kv_length``. The cache may
hold float32, bfloat16, or int8 rows with per-(head, token) float32
scales; all arithmetic is float32.

* :func:`flash_decode` launches the CUDA kernel in ``csrc/flash_decode.cu``
  for CUDA tensors (and raises on anything it does not take) and runs
  :func:`decode_plain` for CPU tensors.
* :func:`decode_plain` is the port of ``decode_ragged_xla``: an online
  softmax over the live key blocks only, reading the stacked cache in place
  through views (only one block is ever converted to float32).

Masking: the cursor (no row at or past ``kv_length[b]`` is read), then,
where given, block-causal over explicit times (``k_time <= q_time``), a
sliding window over the same times (``k_time > q_time - window``, as the
flash kernels' and the reference's chunked path; a window needs times),
segment ids (``q_seg == k_seg`` and ``k_seg >= 0``), and GQA (``h //
group``). ``softcap`` maps the scaled scores through ``softcap *
tanh(s / softcap)`` before the softmax, as ``ref.py`` and the flash
kernels do. A value row that no query can reach is zeroed before ``p @ v``
(0 * NaN is NaN, and rows past a cursor may hold any bit pattern); a query
row with no live key gives 0.

The JAX package's Pallas decode has neither a window nor a softcap: the
reference decodes gemma2 through its chunked path. The port's kernel takes
both (the kernel's instances without them are the ones it had before).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda

_NEG_INF = -1e30

#: cache storage dtypes accepted (as strings) by ``init_cache`` /
#: ``RolloutEngine(cache_dtype=...)``
CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def canonical_cache_dtype(dtype, default=None):
    """Resolve a cache-dtype option (string / torch dtype / None)."""
    if dtype is None:
        return default
    if isinstance(dtype, str):
        return CACHE_DTYPES[dtype]
    return dtype


def quantize_kv(x: torch.Tensor, eps: float = 1e-8):
    """Symmetric int8 quantization over the feature axis: (int8 values
    (..., d), float32 scales (...,)), one scale per (batch, head, token)
    row. Bit-exact with the reference (same f32 ops, round half to even)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=eps) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------

def _check_window(window, softcap, q_times):
    if window is not None and (window < 1 or q_times is None):
        raise ValueError(f"a decode window ({window}) must be positive and "
                         f"needs q_times / k_times (the positions)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")


def decode_plain(q, k, v, kv_length, *, k_scale=None, v_scale=None,
                 q_segment_ids=None, k_segment_ids=None,
                 q_times=None, k_times=None,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None, block_k: int = 128,
                 layer: Optional[int] = None) -> torch.Tensor:
    """Cursor-bounded online-softmax decode in plain PyTorch.

    q (B, Hq, Sq, D); k (B, Hkv, S, D) and v (B, Hkv, S, Dv), or with
    ``layer=i`` the stacked (L, B, Hkv, S, .) buffers read at layer i (v
    may be a column view of wider rows: MLA's values are the first Dv
    columns of its cached rows, ``v = k[..., :Dv]``);
    ``kv_length`` (B,). The loop runs ``ceil(max(kv_length) / block_k)``
    blocks; the last one clamps its start to ``S - block_k`` and masks the
    rows an earlier block already folded. Computes in float32, or in
    float64 for float64 queries (an exact yardstick for the kernel).
    """
    _check_window(window, softcap, q_times)
    b, hq, sq, d = q.shape
    if layer is not None:
        k, v = k[layer], v[layer]
        k_scale = None if k_scale is None else k_scale[layer]
        v_scale = None if v_scale is None else v_scale[layer]
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    block_k = min(block_k, sk)
    kvl = torch.as_tensor(kv_length, device=q.device).reshape(-1)
    kvl = kvl.expand(b).to(torch.int64)
    n_live = (min(int(kvl.max()), sk) + block_k - 1) // block_k
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(work)
    m = torch.full((b, hq, sq), _NEG_INF, dtype=work, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=work, device=q.device)
    acc = torch.zeros((b, hq, sq, dv), dtype=work, device=q.device)
    for i in range(n_live):
        start_u = i * block_k
        start = min(start_u, sk - block_k)
        sl = slice(start, start + block_k)
        kc = k[:, :, sl].to(work)
        vc = v[:, :, sl].to(work)
        if k_scale is not None:
            kc = kc * k_scale[:, :, sl][..., None]
        if v_scale is not None:
            vc = vc * v_scale[:, :, sl][..., None]
        if group > 1:
            kc = torch.repeat_interleave(kc, group, dim=1)
            vc = torch.repeat_interleave(vc, group, dim=1)
        s = torch.einsum("bhnd,bhmd->bhnm", qf, kc) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        cols = torch.arange(start, start + block_k, device=q.device)
        mask = ((cols[None, :] < kvl[:, None]) & (cols >= start_u)[None, :])
        mask = mask[:, None, None, :]
        if q_times is not None:
            kt, qt = k_times[:, None, None, sl], q_times[:, None, :, None]
            mask = mask & (kt <= qt)
            if window is not None:
                mask = mask & (kt > qt - window)
        if q_segment_ids is not None:
            ks = k_segment_ids[:, None, None, sl]
            mask = mask & (q_segment_ids[:, None, :, None] == ks) & (ks >= 0)
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
        vc = torch.where(mask.any(dim=2).any(dim=1)[:, None, :, None], vc,
                         torch.zeros((), device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhnm,bhmd->bhnd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# The kernel wrapper.
# ---------------------------------------------------------------------------

_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode(q, k, v, kv_length, *, k_scale=None, v_scale=None,
                 q_segment_ids=None, k_segment_ids=None,
                 q_times=None, k_times=None,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None,
                 num_splits: Optional[int] = None,
                 layer: Optional[int] = None) -> torch.Tensor:
    """Split-K ragged decode: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Shapes as :func:`decode_plain`; q float32 or
    bfloat16, and the (B, Hq, Sq, Dv) output in q's dtype, as the
    reference's. Any row width (past 256 columns the kernel runs column
    windows of at most 256, each recomputing the scores). ``num_splits`` (CUDA
    only) splits each row's key range over that many CTAs, whose partials
    a second kernel joins; the kernel holds it to its count of key tiles,
    and None picks enough to give every SM a CTA. ``window`` (which needs
    the times) and ``softcap`` take rows of at most 200 columns on the
    card (every registered config's head is 64 or 128 wide). ``v`` is
    contiguous or the leading Dv columns of a contiguous tensor of wider
    rows (its row pitch goes to the kernel, so MLA's latent is read in
    place, not stored twice)."""
    if q.device.type == "cpu":
        return decode_plain(q, k, v, kv_length, k_scale=k_scale,
                            v_scale=v_scale, q_segment_ids=q_segment_ids,
                            k_segment_ids=k_segment_ids, q_times=q_times,
                            k_times=k_times, window=window, softcap=softcap,
                            scale=scale, layer=layer)
    _check_window(window, softcap, q_times)
    return _launch(q, k, v, kv_length, k_scale, v_scale, q_segment_ids,
                   k_segment_ids, q_times, k_times, window, softcap, scale,
                   num_splits, layer)


def _check_int(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 {shape} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch(q, k, v, kv_length, k_scale, v_scale, q_seg, k_seg, q_times,
            k_times, window, softcap, scale, num_splits, layer):
    dev = q.device
    if q.dtype not in _Q_CODES or q.ndim != 4 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous float32 or bfloat16 "
                         f"(B, Hq, Sq, D) tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, hq, sq, d = q.shape
    if layer is None:
        k, v = k[None], v[None]
        k_scale = None if k_scale is None else k_scale[None]
        v_scale = None if v_scale is None else v_scale[None]
        layer = 0
    if k.ndim != 5 or v.ndim != 5:
        raise ValueError(f"cache must be (L, B, Hkv, S, .), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    nl, _, hkv, sk, dv = v.shape
    if tuple(k.shape) != (nl, b, hkv, sk, d) or not 0 <= layer < nl:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} / layer "
                         f"{layer} do not match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if k.dtype not in _CACHE_CODES or v.dtype != k.dtype:
        raise TypeError(f"cache dtype must be one of float32/bfloat16/int8 "
                        f"for both k and v, got {k.dtype} / {v.dtype}")
    if k.device != dev or not k.is_contiguous():
        raise ValueError(f"k must be contiguous on {dev}")
    v_pitch = _row_pitch(v)
    if v.device != dev or v_pitch is None:
        raise ValueError(f"v must be contiguous on {dev}, or the leading "
                         f"columns of a contiguous tensor of wider rows; got "
                         f"strides {v.stride()} for {tuple(v.shape)}")
    if d < 1 or dv < 1:
        raise ValueError(f"row widths D={d}, Dv={dv} must be positive")
    if (window is not None or softcap is not None) and max(d, dv) > 200:
        raise ValueError(f"a window or a softcap takes rows of at most 200 "
                         f"columns on the card, got D={d}, Dv={dv}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("int8 caches need k_scale and v_scale; other "
                         "caches take none")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (nl, b, hkv, sk) \
                    or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous float32 "
                                 f"{(nl, b, hkv, sk)} on {dev}")
    _check_int("kv_length", kv_length, (b,), dev)
    if (q_times is None) != (k_times is None) or \
            (q_seg is None) != (k_seg is None):
        raise ValueError("times and segment ids come in (q, k) pairs")
    if q_times is not None:
        _check_int("q_times", q_times, (b, sq), dev)
        _check_int("k_times", k_times, (b, sk), dev)
    if q_seg is not None:
        _check_int("q_segment_ids", q_seg, (b, sq), dev)
        _check_int("k_segment_ids", k_seg, (b, sk), dev)
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    if num_splits is None:
        num_splits = _num_splits()(b, hq, hkv, sq, sk, d, dv, 0,
                                   _sm_count(dev))
    num_splits = max(1, int(num_splits))
    o_part = torch.empty((b, hq, num_splits, sq, dv), device=dev)
    m_part = torch.empty((b, hq, num_splits, sq), device=dev)
    l_part = torch.empty((b, hq, num_splits, sq), device=dev)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale),
              ptr(v_scale), kv_length.data_ptr(), ptr(q_times), ptr(k_times),
              ptr(q_seg), ptr(k_seg), o_part.data_ptr(), m_part.data_ptr(),
              l_part.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk, d, dv,
              layer, num_splits, _CACHE_CODES[k.dtype], _Q_CODES[q.dtype],
              float(scale), -1 if window is None else int(window),
              0.0 if softcap is None else float(softcap),
              torch.cuda.current_stream(dev).cuda_stream, v_pitch)
    cuda.count_launch("flash_decode")
    return out


def _row_pitch(v: torch.Tensor) -> Optional[int]:
    """The row pitch of an (L, B, Hkv, S, Dv) cache: Dv for a contiguous
    one, p for the leading Dv columns of a contiguous (..., p) tensor;
    None for any other layout."""
    if v.is_contiguous():
        return v.shape[-1]
    nl, b, h, s, dv = v.shape
    p = v.stride(3)
    want = (b * h * s * p, h * s * p, s * p, p, 1)
    if p < dv or any(st != w for st, w, n in zip(v.stride(), want, v.shape)
                     if n > 1):
        return None
    return p


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _num_splits():
    """The kernel's own split count for a launch's shapes."""
    fn = cuda.load("flash_decode").flash_decode_num_splits
    fn.argtypes = [ctypes.c_int] * 9
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return cuda.launcher(
        "flash_decode", [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
           ctypes.c_int])
