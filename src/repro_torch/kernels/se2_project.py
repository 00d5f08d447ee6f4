"""Fused SE(2) Fourier query/key projection and its transpose (port of
``repro/kernels/se2_project.py``).

:func:`se2_fourier_project` is Algorithm 2's per-token pre-transform:
``phi_q^T x`` (mode ``"q"``) or ``phi_k x`` (mode ``"k"``, which also serves
values, as ``transform_v`` is ``transform_k``). :func:`se2_fourier_project_t`
is its transpose: ``phi_q g``, which is ``untransform_out``, or ``phi_k^T g``.
For a CUDA tensor both launch the kernels in ``csrc/se2_project.cu``; for a
CPU tensor they run the plain versions, :func:`se2_project_plain` and
:func:`se2_project_t_plain`; for a meta tensor they allocate the output
and compute nothing.

The projection is linear in x, so each direction's backward is the other
direction at the same pose: the two autograd Functions are each other's
vector-Jacobian product, and save only the pose. The pose is data and gets
no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import fourier
from repro_torch.core.encodings import SE2Fourier, _as_compute, _rotate_pairs
from repro_torch.kernels import cuda
from repro_torch.obs import cost

_TOKENS_PER_CTA = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"k": 0, "q": 1}


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be 'q' or 'k', got {mode!r}")


def se2_project_plain(x: torch.Tensor, pose: torch.Tensor, enc: SE2Fourier,
                      mode: str) -> torch.Tensor:
    """The plain forward: ``enc.transform_q`` / ``enc.transform_k``."""
    _check_mode(mode)
    p = pose[:, None] if x.ndim == 4 else pose
    return enc.transform_q(x, p) if mode == "q" else enc.transform_k(x, p)


def se2_project_t_plain(g: torch.Tensor, pose: torch.Tensor,
                        enc: SE2Fourier, mode: str) -> torch.Tensor:
    """The plain transpose: ``enc.untransform_out`` (``phi_q g``) for "q";
    for "k", ``phi_k^T g`` contracted block by block: per axis
    ``(gamma . top + lambda . bot, gamma . bot - lambda . top)`` over the
    block's terms, and ``rho(theta)^T`` on the theta pair."""
    _check_mode(mode)
    p = pose[:, None] if g.ndim == 4 else pose
    if mode == "q":
        return enc.untransform_out(g, p)
    gf = _as_compute(g)
    x, y, theta = enc._scaled_xy(p)
    gx, lx, gy, ly = fourier.xy_coefficients(x, y, enc.num_terms)
    ct, st = torch.cos(theta), torch.sin(theta)
    outs, off = [], 0
    for bi, nf in enumerate(enc.block_terms()):
        seg = gf[..., off:off + 4 * nf + 2]
        off += 4 * nf + 2
        for axis, gam, lam in ((0, gx, lx), (1, gy, ly)):
            gam, lam = gam[..., bi, :nf], lam[..., bi, :nf]
            top = seg[..., 2 * axis * nf:(2 * axis + 1) * nf]
            bot = seg[..., (2 * axis + 1) * nf:(2 * axis + 2) * nf]
            outs += [(gam * top + lam * bot).sum(-1),
                     (gam * bot - lam * top).sum(-1)]
        outs += _rotate_pairs(seg[..., 4 * nf], seg[..., 4 * nf + 1], ct, -st)
    return torch.stack(outs, -1).to(g.dtype)


@functools.lru_cache(maxsize=None)
def _constants(enc: SE2Fourier, device: torch.device) -> torch.Tensor:
    """cos z_j, sin z_j, the (2F, F) projection, frequencies, odd flags,
    block scales and the folded projections proj[j] +- proj[j + F] (node
    z_j + pi samples u at -u), float32, in the layout the kernel reads."""
    f = enc.num_terms
    nodes, proj = fourier._quadrature_constants(f)
    odd = (np.arange(f) % 2 == 1).astype(np.float64)
    flat = np.concatenate([np.cos(nodes), np.sin(nodes), proj.reshape(-1),
                           fourier.basis_frequencies(f), odd, enc.scales(),
                           (proj[:f] + proj[f:]).reshape(-1),
                           (proj[:f] - proj[f:]).reshape(-1)])
    return torch.as_tensor(flat, dtype=torch.float32, device=device)


def se2_fourier_project(x: torch.Tensor, pose: torch.Tensor,
                        enc: SE2Fourier, mode: str) -> torch.Tensor:
    """Algorithm 2's per-token transform of queries (``mode="q"``) or
    keys/values (``mode="k"``).

    x (B, H, n, head_dim) with pose (B, n, 3), the pose shared by the H
    heads; or x (T, head_dim) with pose (T, 3). Returns
    ``x.shape[:-1] + (enc.expanded_dim,)`` in x's dtype.
    """
    _check_mode(mode)
    return _Project.apply(x, pose, enc, mode)


def se2_fourier_project_t(g: torch.Tensor, pose: torch.Tensor,
                          enc: SE2Fourier, mode: str) -> torch.Tensor:
    """The transpose of :func:`se2_fourier_project` at the same pose:
    ``phi_q g`` (``enc.untransform_out``) for ``mode="q"``, ``phi_k^T g``
    for ``mode="k"``. g (B, H, n, expanded_dim) or (T, expanded_dim);
    returns ``g.shape[:-1] + (enc.head_dim,)`` in g's dtype."""
    _check_mode(mode)
    return _ProjectT.apply(g, pose, enc, mode)


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pose, enc, mode):
        ctx.save_for_backward(pose)
        ctx.enc, ctx.mode = enc, mode
        with cost.kernel_cost(lambda: cost.se2_cost(x, enc, mode, False)):
            if x.device.type == "cpu":
                return se2_project_plain(x, pose, enc, mode)
            if x.device.type == "meta":
                return x.new_empty(x.shape[:-1] + (enc.expanded_dim,))
            return _launch(x, pose, enc, mode, transposed=False)

    @staticmethod
    def backward(ctx, g):
        (pose,) = ctx.saved_tensors
        return (_ProjectT.apply(g.contiguous(), pose, ctx.enc, ctx.mode),
                None, None, None)


class _ProjectT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, pose, enc, mode):
        ctx.save_for_backward(pose)
        ctx.enc, ctx.mode = enc, mode
        with cost.kernel_cost(lambda: cost.se2_cost(g, enc, mode, True)):
            if g.device.type == "cpu":
                return se2_project_t_plain(g, pose, enc, mode)
            if g.device.type == "meta":
                return g.new_empty(g.shape[:-1] + (enc.head_dim,))
            return _launch(g, pose, enc, mode, transposed=True)

    @staticmethod
    def backward(ctx, x):
        (pose,) = ctx.saved_tensors
        return (_Project.apply(x.contiguous(), pose, ctx.enc, ctx.mode),
                None, None, None)


def _launch(x, pose, enc, mode, transposed):
    if enc.adaptive_terms:
        raise ValueError("the se2_project kernel takes non-adaptive F only")
    if x.device.type != "cuda" or pose.device != x.device:
        raise ValueError(f"input and pose must share one CUDA device, got "
                         f"{x.device} and {pose.device}")
    if x.dtype not in _DTYPES or pose.dtype != torch.float32:
        raise TypeError(f"input must be float32/bfloat16 and pose float32, "
                        f"got {x.dtype} and {pose.dtype}")
    if not (x.is_contiguous() and pose.is_contiguous()):
        raise ValueError("input and pose must be contiguous")
    d_in, d_out = enc.head_dim, enc.expanded_dim
    if transposed:
        d_in, d_out = d_out, d_in
    if x.shape[-1] != d_in:
        raise ValueError(f"input feature dim {x.shape[-1]} != {d_in}")
    if x.ndim == 4:
        b, h, n, _ = x.shape
        if pose.shape != (b, n, 3):
            raise ValueError(f"pose {tuple(pose.shape)} != {(b, n, 3)}")
    elif x.ndim == 2:
        b, h, n = 1, 1, x.shape[0]
        if pose.shape != (n, 3):
            raise ValueError(f"pose {tuple(pose.shape)} != {(n, 3)}")
    else:
        raise ValueError(f"input must be (B, H, n, d) or (T, d), got "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % 16:       # the kernel reads aligned 4-element quads
        x = x.clone()
    out = torch.empty(x.shape[:-1] + (d_out,), dtype=x.dtype, device=x.device)
    entry = "se2_project_t" if transposed else "se2_project"
    _kernel(entry)(x.data_ptr(), pose.data_ptr(),
                   _constants(enc, x.device).data_ptr(), out.data_ptr(),
                   b * h * n, h, n, enc.head_dim, enc.num_blocks,
                   enc.num_terms, _MODES[mode], _DTYPES[x.dtype],
                   _TOKENS_PER_CTA,
                   torch.cuda.current_stream(x.device).cuda_stream)
    cuda.count_launch(f"se2_project_{mode}{'_t' if transposed else ''}")
    return out


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    return cuda.launcher(
        "se2_project", [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p], entry)
