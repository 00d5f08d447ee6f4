"""Group-relative position encodings (port of ``repro/core/encodings.py``).

An encoding supplies the paper's factorisation
``phi(p_n^{-1} p_m) = phi_q(p_n) phi_k(p_m)``: Algorithm 2 pre-transforms
queries with ``phi_q^T`` and keys/values with ``phi_k``, runs a standard
attention, and post-transforms the output with ``phi_q``. ``apply_phi`` is
the exact ``phi(p_rel) @ vec`` of Algorithm 1.

The encodings of the paper's Table I and one more:

* :class:`AbsoluteEncoding`: no transform; the model adds a pose embedding
  to the token features instead (the non-invariant baseline).
* :class:`Rope1D`: G = R, rotary embeddings in the "split half" layout.
* :class:`Rope2D`: G = R^2, a Rope1D on each half of the width (x, then
  y): translation invariant, not rotation invariant.
* :class:`SE2Repr`: G = SE(2) through the 3x3 homogeneous matrix of each
  3-wide block (exact; the scores hold raw positions).
* :class:`SE2Fourier`: G = SE(2), the paper's linear-memory encoding.

Transforms act on the trailing feature dimension and broadcast over the
leading ones; poses have trailing dimension ``pose_dim``. Float64 inputs
compute in float64, everything else in float32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import fourier, se2


def _as_compute(x: torch.Tensor) -> torch.Tensor:
    """The encodings compute in float32; float64 stays float64 (the exact
    yardstick of the projection's adjoint and gradient tests)."""
    return x if x.dtype == torch.float64 else x.to(torch.float32)


@functools.lru_cache(maxsize=None)
def _ladder(values: Tuple[float, ...], dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """A float64 ladder (frequencies, scales) as a ``dtype`` tensor on
    ``device``, copied there once: a copy from host memory in every call
    would make the host wait for the card in every layer."""
    return torch.tensor(values, dtype=dtype, device=device)


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
class AbsoluteEncoding(GroupEncoding):
    """No relative encoding; the model adds a pose embedding upstream."""

    head_dim: int = 0
    pose_dim: int = 3
    name: str = "absolute"


def rope_frequencies(num_freqs: int, base: float = 10000.0,
                     max_freq: float = 1.0) -> np.ndarray:
    """RoFormer's ladder ``max_freq * base^(-2i / d)``, i in [0, d/2), in
    float64."""
    if num_freqs == 1:
        return np.array([max_freq])
    i = np.arange(num_freqs)
    return max_freq * (base ** (-2.0 * i / (2.0 * num_freqs)))


@dataclasses.dataclass(frozen=True)
class Rope1D(GroupEncoding):
    """Rotary embeddings for G = R (a token index or any scalar
    coordinate), in the "split half" layout: feature ``i`` pairs with
    feature ``i + head_dim // 2``. The score picks up
    ``rho(p_m - p_n)``."""

    head_dim: int = 64
    base: float = 10000.0
    max_freq: float = 1.0
    pose_dim: int = 1
    name: str = "rope1d"

    def __post_init__(self):
        if self.head_dim % 2 != 0:
            raise ValueError(f"rope1d head_dim must be even, got "
                             f"{self.head_dim}")

    def _rotate(self, x, pose):
        xc = _as_compute(x)
        # the float64 ladder cast to the compute dtype, then multiplied
        freqs = _ladder(tuple(rope_frequencies(
            self.head_dim // 2, self.base, self.max_freq)), xc.dtype,
            x.device)
        ang = pose[..., 0:1].to(xc.dtype) * freqs
        h = self.head_dim // 2
        r0, r1 = _rotate_pairs(xc[..., :h], xc[..., h:], torch.cos(ang),
                               torch.sin(ang))
        return torch.cat([r0, r1], -1).to(x.dtype)

    def transform_q(self, q, pose):
        return self._rotate(q, pose)

    def transform_k(self, k, pose):
        return self._rotate(k, pose)

    def apply_phi(self, p_rel, vec):
        return self._rotate(vec, p_rel)


@dataclasses.dataclass(frozen=True)
class Rope2D(GroupEncoding):
    """Axis-aligned rotary embeddings for G = R^2 (paper Sec. II-D): the
    first half of the width encodes x, the second y, each a
    :class:`Rope1D` of half the width."""

    head_dim: int = 64
    base: float = 100.0
    max_freq: float = 1.0
    pose_dim: int = 2
    name: str = "rope2d"

    def __post_init__(self):
        if self.head_dim % 4 != 0:
            raise ValueError(f"rope2d head_dim must be divisible by 4, got "
                             f"{self.head_dim}")

    def _rotate(self, x, pose):
        sub = Rope1D(head_dim=self.head_dim // 2, base=self.base,
                     max_freq=self.max_freq)
        h = self.head_dim // 2
        return torch.cat([sub.transform_q(x[..., :h], pose[..., 0:1]),
                          sub.transform_q(x[..., h:], pose[..., 1:2])], -1)

    def transform_q(self, q, pose):
        return self._rotate(q, pose)

    def transform_k(self, k, pose):
        return self._rotate(k, pose)

    def apply_phi(self, p_rel, vec):
        return self._rotate(vec, p_rel)


@dataclasses.dataclass(frozen=True)
class SE2Repr(GroupEncoding):
    """SE(2) through the homogeneous 3x3 representation (paper Sec. II-E):
    ``phi(p) = psi(p)``, ``phi_q(p_n) = psi(p_n^{-1})``,
    ``phi_k(p_m) = psi(p_m)``, on each 3-wide block with the block's
    position scale. Exact, with c = d.

    ``psi`` of a block pose (X, Y, t) maps (x0, x1, x2) to
    ``(c x0 - s x1 + X x2, s x0 + c x1 + Y x2, x2)``; the transforms are
    written in that closed form, not as 3x3 matrix products.
    """

    head_dim: int = 48
    min_scale: float = 0.25
    max_scale: float = 1.0
    pose_dim: int = 3
    name: str = "se2_repr"

    def __post_init__(self):
        if self.head_dim % 3 != 0:
            raise ValueError(f"se2_repr head_dim must be divisible by 3, got "
                             f"{self.head_dim}")

    @property
    def num_blocks(self) -> int:
        return self.head_dim // 3

    def scales(self) -> np.ndarray:
        """Per-block position scales (float64)."""
        return _log_spaced(self.num_blocks, self.min_scale, self.max_scale)

    def _apply_psi(self, x, pose, inverse: bool, transpose: bool):
        """psi of each block's scaled pose (of its inverse with
        ``inverse``, transposed with ``transpose``) applied blockwise to
        the trailing dim."""
        xb = _as_compute(x).reshape(*x.shape[:-1], self.num_blocks, 3)
        p = _as_compute(pose)
        scales = _ladder(tuple(self.scales()), p.dtype, pose.device)
        tx, ty = p[..., 0:1] * scales, p[..., 1:2] * scales   # (..., nb)
        if inverse:
            tx, ty, t = se2.inverse(torch.stack(
                torch.broadcast_tensors(tx, ty, p[..., 2:3]), -1)).unbind(-1)
        else:
            t = p[..., 2:3]
        c, s = torch.cos(t), torch.sin(t)
        x0, x1, x2 = xb.unbind(-1)
        if transpose:       # psi^T: [[c, s, 0], [-s, c, 0], [X, Y, 1]]
            out = (c * x0 + s * x1, -s * x0 + c * x1,
                   tx * x0 + ty * x1 + x2)
        else:
            out = (c * x0 - s * x1 + tx * x2, s * x0 + c * x1 + ty * x2, x2)
        return torch.stack(out, -1).flatten(-2).to(x.dtype)

    def transform_q(self, q, pose):
        # q~ = phi_q(p)^T q = psi(p^{-1})^T q
        return self._apply_psi(q, pose, inverse=True, transpose=True)

    def transform_k(self, k, pose):
        return self._apply_psi(k, pose, inverse=False, transpose=False)

    def transform_v(self, v, pose):
        return self._apply_psi(v, pose, inverse=False, transpose=False)

    def untransform_out(self, o, pose):
        return self._apply_psi(o, pose, inverse=True, transpose=False)

    def apply_phi(self, p_rel, vec):
        return self._apply_psi(vec, p_rel, inverse=False, transpose=False)

    @property
    def transforms_values(self) -> bool:
        return True


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


ENCODINGS: Dict[str, type] = {
    "absolute": AbsoluteEncoding,
    "rope1d": Rope1D,
    "rope2d": Rope2D,
    "se2_repr": SE2Repr,
    "se2_fourier": SE2Fourier,
}


def make_encoding(name: str, head_dim: int, **kwargs) -> GroupEncoding:
    if name not in ENCODINGS:
        raise ValueError(f"unknown encoding {name!r}; options: "
                         f"{sorted(ENCODINGS)}")
    if name == "absolute":
        return AbsoluteEncoding(head_dim=head_dim)
    return ENCODINGS[name](head_dim=head_dim, **kwargs)
