"""Flash-attention backward (port of ``repro/kernels/flash_attention_bwd.py``).

* :func:`flash_attention_bwd` launches the dq and the dk/dv kernels of
  ``csrc/flash_attention_bwd.cu`` for CUDA tensors (and raises on anything
  they do not take) and runs :func:`flash_bwd_plain` for CPU tensors. The
  kernels run their five products on the tensor cores in split TF32: each
  float32 operand is split into two TF32 parts and a product is taken as
  three TF32 products, which keeps float32 accuracy.
* :func:`flash_bwd_plain` is the port of the reference's blocked recurrence
  ``ops._bwd_chunked``: the same arithmetic chunk by chunk over keys, in
  float32 (float64 for float64 inputs, which the kernels' checks pass to
  get an exact yardstick).

Both recompute block probabilities from the forward's log-sum-exp rows,
``P = exp(S - lse)``, so no (Sq, Sk) tensor outlives a block. The row term
``delta = sum(dO * O)`` is plain PyTorch, as the reference computes it in
XLA outside its kernels. Masks and conventions are the forward's
(:mod:`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention import (_DTYPES, _mask_args,
                                                 _mask_ptrs, _softcapped,
                                                 block_mask, check_inputs,
                                                 mask_options)

_CHUNK = 512            # keys per chunk of the plain version


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_segment_ids=None, k_segment_ids=None,
                    q_times=None, k_times=None):
    """The plain version: (dq, dk, dv) in the dtypes of (q, k, v), from the
    forward's output ``o``, its ``lse`` rows and the output cotangent
    ``do``, over chunks of 512 keys (the reference's chunk), computed in
    float32 or the inputs' wider dtype. GQA sums dk/dv over the q heads of
    each kv head's group."""
    b, hq, sq, d = q.shape
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, gf = q.to(ct), do.to(ct)
    delta = torch.sum(gf * o.to(ct), dim=-1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, sk, _CHUNK):
        k1 = min(k0 + _CHUNK, sk)
        kc = k[:, :, k0:k1].to(ct).repeat_interleave(group, dim=1)
        vc = v[:, :, k0:k1].to(ct).repeat_interleave(group, dim=1)
        s_pre = torch.einsum("bhnd,bhmd->bhnm", qf, kc) * scale
        s = _softcapped(s_pre, softcap)
        mask = block_mask(sq, k0, k1, causal=causal, window=window,
                          q_segment_ids=q_segment_ids,
                          k_segment_ids=k_segment_ids, q_times=q_times,
                          k_times=k_times, device=q.device)
        p = torch.where(mask, torch.exp(s - lse[..., None]),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("bhnd,bhmd->bhnm", gf, vc)
        ds = p * (dp - delta[..., None])
        if softcap is not None and softcap > 0:
            t = torch.tanh(s_pre / softcap)
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq = dq + torch.einsum("bhnm,bhmd->bhnd", ds, kc)
        dkc = torch.einsum("bhnm,bhnd->bhmd", ds, qf)
        dvc = torch.einsum("bhnm,bhnd->bhmd", p, gf)
        if group > 1:
            dkc = dkc.reshape(b, hkv, group, k1 - k0, d).sum(dim=2)
            dvc = dvc.reshape(b, hkv, group, k1 - k0, dv).sum(dim=2)
        dks.append(dkc)
        dvs.append(dvc)
    if not dks:
        dks = [torch.zeros_like(k, dtype=torch.float32)]
        dvs = [torch.zeros_like(v, dtype=torch.float32)]
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_segment_ids=None, k_segment_ids=None,
                        q_times=None, k_times=None):
    """Flash-attention backward: the dq and dk/dv kernels for CUDA tensors,
    the plain version for CPU tensors, outputs alone for meta tensors. q,
    k, v as the forward; o and do (B, Hq, Sq, Dv); lse (B, Hq, Sq)
    float32. Returns (dq, dk, dv)."""
    kw = mask_options(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_segment_ids=q_segment_ids,
                      k_segment_ids=k_segment_ids, q_times=q_times,
                      k_times=k_times)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    return (flash_attention_dq(q, k, v, do, lse, delta, **kw),
            *flash_attention_dkv(q, k, v, do, lse, delta, **kw))


def flash_attention_dq(q, k, v, do, lse, delta, **kw):
    """The dq kernel (CUDA tensors only): dq like q. ``delta`` (B, Hq, Sq)
    float32 is ``sum(do * o, -1)``; masks and options as the forward."""
    dq = torch.empty_like(q)
    _launch("dq", q, k, v, do, lse, delta, (dq,), kw)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, **kw):
    """The dk/dv kernel (CUDA tensors only): (dk like k, dv like v)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", q, k, v, do, lse, delta, (dk, dv), kw)
    return dk, dv


def _launch(which, q, k, v, do, lse, delta, outs, kw):
    kw = mask_options(**kw)
    b, hq, sq, d = q.shape
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    check_inputs(q, k, v, **kw, extra=(("do", do, (b, hq, sq, dv)),))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq) \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(b, hq, sq)} tensor on {q.device}")
    _kernel(which)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), *_mask_ptrs(kw),
                   *(t.data_ptr() for t in outs), b, hq, hkv, sq, sk, d, dv,
                   *_mask_args(kw, d), _DTYPES[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    cuda.count_launch(f"flash_attention_{which}")


@functools.lru_cache(maxsize=None)
def _kernel(which: str):
    outs = 1 if which == "dq" else 2
    return cuda.launcher(
        "flash_attention_bwd", [ctypes.c_void_p] * (10 + outs)
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p],
        entry=f"flash_attention_{which}")
