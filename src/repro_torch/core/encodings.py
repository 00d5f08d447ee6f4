"""Group-relative position encodings (port of ``repro/core/encodings.py``).

An encoding supplies the paper's factorisation
``phi(p_n^{-1} p_m) = phi_q(p_n) phi_k(p_m)``: Algorithm 2 pre-transforms
queries with ``phi_q^T`` and keys/values with ``phi_k``, runs a standard
attention, and post-transforms the output with ``phi_q``. ``apply_phi`` is
the exact ``phi(p_rel) @ vec`` of Algorithm 1.

This slice ports the paper's ``se2_fourier`` encoding; the other Table-I
encodings come in a later slice (``make_encoding`` says so).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import fourier


def _as_compute(x: torch.Tensor) -> torch.Tensor:
    """The encodings compute in float32; float64 stays float64 (the exact
    yardstick of the projection's adjoint and gradient tests)."""
    return x if x.dtype == torch.float64 else x.to(torch.float32)


def _rotate_pairs(x0, x1, cos, sin):
    """Apply rho(angle) with components given by (cos, sin) to pairs."""
    return x0 * cos - x1 * sin, x0 * sin + x1 * cos


def _log_spaced(n: int, lo: float, hi: float) -> np.ndarray:
    if n == 1:
        return np.array([hi])
    return np.exp(np.linspace(np.log(lo), np.log(hi), n))


class GroupEncoding:
    """Interface shared by all encodings."""

    name: str = "base"
    pose_dim: int = 0
    head_dim: int = 0

    @property
    def expanded_dim(self) -> int:
        """c: feature dim after phi_q^T / phi_k."""
        return self.head_dim

    @property
    def expanded_v_dim(self) -> int:
        """Feature dim of a cached value row."""
        return self.expanded_dim if self.transforms_values else self.head_dim

    def transform_q(self, q, pose):
        return q

    def transform_k(self, k, pose):
        return k

    def transform_v(self, v, pose):
        return v

    def untransform_out(self, o, pose):
        return o

    def apply_phi(self, p_rel, vec):
        return vec

    @property
    def transforms_values(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class SE2Fourier(GroupEncoding):
    """The paper's SE(2) Fourier encoding (Sec. III).

    ``head_dim`` is divisible by 6; each 6-wide block ``(x0, x1, y0, y1,
    t0, t1)`` is acted on by ``diag[rho(a_b x_rel), rho(a_b y_rel),
    rho(theta_rel)]`` with the block's spatial scale ``a_b``. The factorised
    form expands each block to ``4F + 2`` features. With
    ``adaptive_terms=True`` block b keeps ``F_b ~ F a_b / a_max`` terms
    (floored at ``min_terms``).
    """

    head_dim: int = 48
    num_terms: int = 18
    min_scale: float = 0.25
    max_scale: float = 1.0
    adaptive_terms: bool = False
    min_terms: int = 4
    term_margin: int = 3
    pose_dim: int = 3
    name: str = "se2_fourier"

    def __post_init__(self):
        if self.head_dim % 6 != 0:
            raise ValueError(f"se2_fourier head_dim must be divisible by 6, "
                             f"got {self.head_dim}")
        if self.num_terms < 1:
            raise ValueError("num_terms must be >= 1")

    @property
    def num_blocks(self) -> int:
        return self.head_dim // 6

    def scales(self) -> np.ndarray:
        """Per-block spatial scales ``a_b`` (float64)."""
        return _log_spaced(self.num_blocks, self.min_scale, self.max_scale)

    def block_terms(self) -> Tuple[int, ...]:
        """Fourier basis size per block (all equal unless adaptive)."""
        if not self.adaptive_terms:
            return (self.num_terms,) * self.num_blocks
        return tuple(
            min(self.num_terms,
                max(self.min_terms,
                    int(np.ceil(self.num_terms * s / self.max_scale))
                    + self.term_margin))
            for s in self.scales())

    @property
    def expanded_dim(self) -> int:
        return sum(4 * f + 2 for f in self.block_terms())

    @property
    def transforms_values(self) -> bool:
        return True

    def _split_blocks(self, x):
        return _as_compute(x).reshape(*x.shape[:-1], self.num_blocks, 6)

    def _scaled_xy(self, pose):
        """Per-block scaled (x, y), each (..., nb), and theta (...,)."""
        p = _as_compute(pose)
        scales = torch.as_tensor(self.scales(), dtype=p.dtype,
                                 device=pose.device)
        return p[..., 0:1] * scales, p[..., 1:2] * scales, p[..., 2]

    # -- query side ----------------------------------------------------------
    def _query_pieces(self, pose):
        x, y, theta = self._scaled_xy(pose)
        c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
        v_x = -x * c - y * s
        v_y = x * s - y * c
        b = fourier.eval_basis(theta, self.num_terms)
        return v_x, v_y, b, theta

    def transform_q(self, q, pose):
        qb = self._split_blocks(q)
        v_x, v_y, b_full, theta = self._query_pieces(pose)
        ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
        segs = []
        for bi, nf in enumerate(self.block_terms()):
            b = b_full[..., None, :nf]
            parts = []
            for q0, q1, v in ((qb[..., bi:bi + 1, 0], qb[..., bi:bi + 1, 1],
                               v_x[..., bi:bi + 1]),
                              (qb[..., bi:bi + 1, 2], qb[..., bi:bi + 1, 3],
                               v_y[..., bi:bi + 1])):
                r0, r1 = _rotate_pairs(q0, q1, torch.cos(v), -torch.sin(v))
                parts.append(torch.cat([r0[..., None] * b, r1[..., None] * b],
                                       -1))
            t0, t1 = _rotate_pairs(qb[..., bi:bi + 1, 4],
                                   qb[..., bi:bi + 1, 5], ct, st)
            parts.append(torch.stack([t0, t1], -1))
            segs.append(torch.cat(parts, -1)[..., 0, :])
        return torch.cat(segs, -1).to(q.dtype)

    # -- key side -------------------------------------------------------------
    def _expand_k(self, k, pose):
        kb = self._split_blocks(k)
        x, y, theta = self._scaled_xy(pose)
        gx, lx, gy, ly = fourier.xy_coefficients(x, y, self.num_terms)
        ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
        segs = []
        for bi, nf in enumerate(self.block_terms()):
            parts = []
            for k0, k1, gamma, lam in (
                    (kb[..., bi:bi + 1, 0], kb[..., bi:bi + 1, 1],
                     gx[..., bi:bi + 1, :nf], lx[..., bi:bi + 1, :nf]),
                    (kb[..., bi:bi + 1, 2], kb[..., bi:bi + 1, 3],
                     gy[..., bi:bi + 1, :nf], ly[..., bi:bi + 1, :nf])):
                top = gamma * k0[..., None] - lam * k1[..., None]
                bot = lam * k0[..., None] + gamma * k1[..., None]
                parts.append(torch.cat([top, bot], -1))
            t0, t1 = _rotate_pairs(kb[..., bi:bi + 1, 4],
                                   kb[..., bi:bi + 1, 5], ct, st)
            parts.append(torch.stack([t0, t1], -1))
            segs.append(torch.cat(parts, -1)[..., 0, :])
        return torch.cat(segs, -1).to(k.dtype)

    def transform_k(self, k, pose):
        return self._expand_k(k, pose)

    def transform_v(self, v, pose):
        return self._expand_k(v, pose)

    def untransform_out(self, o, pose):
        """o = phi_q(p_n) o~, contracting (..., c) back to (..., head_dim).

        With one basis size for every block, all blocks are contracted at
        once (some 25 tensor ops, where the per-block loop below takes some
        200: on the card each op is a launch, and this runs in every layer
        of every rollout tick)."""
        if self.adaptive_terms:
            return self._untransform_blocks(o, pose)
        nf = self.num_terms
        of = _as_compute(o).reshape(*o.shape[:-1], self.num_blocks,
                                    4 * nf + 2)
        v_x, v_y, b, theta = self._query_pieces(pose)
        # [top_x, bot_x, top_y, bot_y] per block: the basis contractions
        tb = (of[..., :4 * nf].unflatten(-1, (4, nf))
              * b[..., None, None, :]).sum(-1)
        x0, x1 = _rotate_pairs(tb[..., 0], tb[..., 1], torch.cos(v_x),
                               torch.sin(v_x))
        y0, y1 = _rotate_pairs(tb[..., 2], tb[..., 3], torch.cos(v_y),
                               torch.sin(v_y))
        t0, t1 = _rotate_pairs(of[..., 4 * nf], of[..., 4 * nf + 1],
                               torch.cos(theta)[..., None],
                               -torch.sin(theta)[..., None])
        res = torch.stack([x0, x1, y0, y1, t0, t1], -1)
        return res.flatten(-2).to(o.dtype)

    def _untransform_blocks(self, o, pose):
        """``untransform_out`` block by block, as the reference writes it
        (blocks may differ in basis size)."""
        of = _as_compute(o)
        v_x, v_y, b_full, theta = self._query_pieces(pose)
        ct, st = torch.cos(theta), torch.sin(theta)
        outs = []
        off = 0
        for bi, nf in enumerate(self.block_terms()):
            b = b_full[..., :nf]
            seg = of[..., off:off + 4 * nf + 2]
            off += 4 * nf + 2
            for idx, v in ((0, v_x[..., bi]), (1, v_y[..., bi])):
                sub = seg[..., idx * 2 * nf:(idx + 1) * 2 * nf]
                top = torch.sum(b * sub[..., :nf], -1)
                bot = torch.sum(b * sub[..., nf:], -1)
                o0, o1 = _rotate_pairs(top, bot, torch.cos(v), torch.sin(v))
                outs.extend([o0, o1])
            t0, t1 = _rotate_pairs(seg[..., 4 * nf], seg[..., 4 * nf + 1],
                                   ct, -st)
            outs.extend([t0, t1])
        return torch.stack(outs, -1).to(o.dtype)

    # -- Algorithm 1 oracle ------------------------------------------------
    def apply_phi(self, p_rel, vec):
        """Exact diag[rho(a_b x_rel), rho(a_b y_rel), rho(theta_rel)] vec."""
        vb = self._split_blocks(vec)
        xr, yr, tr = self._scaled_xy(p_rel)
        tr = tr[..., None].expand_as(xr)
        outs = []
        for ang, i0 in ((xr, 0), (yr, 2), (tr, 4)):
            outs.extend(_rotate_pairs(vb[..., i0], vb[..., i0 + 1],
                                      torch.cos(ang), torch.sin(ang)))
        res = torch.stack(outs, -1)
        return res.reshape(*res.shape[:-2], -1).to(vec.dtype)


#: Table-I encoding names; only ``se2_fourier`` is ported so far
ENCODINGS = ("absolute", "rope1d", "rope2d", "se2_repr", "se2_fourier")


def make_encoding(name: str, head_dim: int, **kwargs) -> GroupEncoding:
    if name not in ENCODINGS:
        raise ValueError(f"unknown encoding {name!r}; options: "
                         f"{sorted(ENCODINGS)}")
    if name != "se2_fourier":
        raise NotImplementedError(
            f"encoding {name!r} is not ported to repro_torch yet; "
            f"see ROADMAP.md")
    return SE2Fourier(head_dim=head_dim, **kwargs)
