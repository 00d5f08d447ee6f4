"""Fused SE(2) Fourier query/key projection (port of
``repro/kernels/se2_project.py``).

:func:`se2_fourier_project` launches the CUDA kernel in
``csrc/se2_project.cu`` for a CUDA tensor and runs the plain version,
:func:`se2_project_plain` (the encoding's own ``transform_q`` /
``transform_k``), for a CPU tensor. Mode ``"k"`` also serves values, as
``transform_v`` is ``transform_k``.

The projection is differentiable in x: its backward is the vector-Jacobian
product of the plain version, recomputed with autograd. The reference
differentiates ``enc.transform_*`` by autodiff and has no backward kernel,
so none is written here. The pose is data and gets no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import fourier
from repro_torch.core.encodings import SE2Fourier
from repro_torch.kernels import cuda

_ROWS_PER_CTA = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"k": 0, "q": 1}


def se2_project_plain(x: torch.Tensor, pose: torch.Tensor, enc: SE2Fourier,
                      mode: str) -> torch.Tensor:
    """The plain version: ``enc.transform_q`` / ``enc.transform_k``."""
    p = pose[:, None] if x.ndim == 4 else pose
    if mode == "q":
        return enc.transform_q(x, p)
    if mode == "k":
        return enc.transform_k(x, p)
    raise ValueError(f"mode must be 'q' or 'k', got {mode!r}")


@functools.lru_cache(maxsize=None)
def _constants(enc: SE2Fourier, device: torch.device) -> torch.Tensor:
    """cos z_j, sin z_j, the (2F, F) projection, frequencies, odd flags and
    block scales, float32, in the layout the kernel reads."""
    f = enc.num_terms
    nodes, proj = fourier._quadrature_constants(f)
    odd = (np.arange(f) % 2 == 1).astype(np.float64)
    flat = np.concatenate([np.cos(nodes), np.sin(nodes), proj.reshape(-1),
                           fourier.basis_frequencies(f), odd, enc.scales()])
    return torch.as_tensor(flat, dtype=torch.float32, device=device)


def se2_fourier_project(x: torch.Tensor, pose: torch.Tensor,
                        enc: SE2Fourier, mode: str) -> torch.Tensor:
    """Algorithm 2's per-token transform of queries (``mode="q"``) or
    keys/values (``mode="k"``).

    x (B, H, n, head_dim) with pose (B, n, 3), the pose shared by the H
    heads; or x (T, head_dim) with pose (T, 3). Returns
    ``x.shape[:-1] + (enc.expanded_dim,)`` in x's dtype.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be 'q' or 'k', got {mode!r}")
    return _Project.apply(x, pose, enc, mode)


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pose, enc, mode):
        ctx.save_for_backward(x, pose)
        ctx.enc, ctx.mode = enc, mode
        if x.device.type == "cpu":
            return se2_project_plain(x, pose, enc, mode)
        return _launch(x, pose, enc, mode)

    @staticmethod
    def backward(ctx, g):
        x, pose = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            y = se2_project_plain(x, pose, ctx.enc, ctx.mode)
            (gx,) = torch.autograd.grad(y, x, g)
        return gx, None, None, None


def _launch(x, pose, enc, mode):
    if enc.adaptive_terms:
        raise ValueError("the se2_project kernel takes non-adaptive F only")
    if x.device.type != "cuda" or pose.device != x.device:
        raise ValueError(f"x and pose must share one CUDA device, got "
                         f"{x.device} and {pose.device}")
    if x.dtype not in _DTYPES or pose.dtype != torch.float32:
        raise TypeError(f"x must be float32/bfloat16 and pose float32, got "
                        f"{x.dtype} and {pose.dtype}")
    if not (x.is_contiguous() and pose.is_contiguous()):
        raise ValueError("x and pose must be contiguous")
    d = x.shape[-1]
    if d != enc.head_dim:
        raise ValueError(f"x feature dim {d} != head_dim {enc.head_dim}")
    if x.ndim == 4:
        b, h, n, _ = x.shape
        if pose.shape != (b, n, 3):
            raise ValueError(f"pose {tuple(pose.shape)} != {(b, n, 3)}")
    elif x.ndim == 2:
        b, h, n = 1, 1, x.shape[0]
        if pose.shape != (n, 3):
            raise ValueError(f"pose {tuple(pose.shape)} != {(n, 3)}")
    else:
        raise ValueError(f"x must be (B, H, n, d) or (T, d), got "
                         f"{tuple(x.shape)}")
    out = torch.empty(x.shape[:-1] + (enc.expanded_dim,), dtype=x.dtype,
                      device=x.device)
    consts = _constants(enc, x.device)
    _kernel()(x.data_ptr(), pose.data_ptr(), consts.data_ptr(),
              out.data_ptr(), b * h * n, h, n, d, enc.num_blocks,
              enc.num_terms, _MODES[mode], _DTYPES[x.dtype], _ROWS_PER_CTA,
              torch.cuda.current_stream(x.device).cuda_stream)
    cuda.count_launch(f"se2_project_{mode}")
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    return cuda.launcher(
        "se2_project", [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
