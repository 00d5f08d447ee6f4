"""SE(2) group operations (port of ``repro/core/se2.py``).

Poses are tensors whose trailing dimension is 3: ``(x, y, theta)``. Every
function broadcasts over leading dimensions. A pose ``p`` is the
homogeneous matrix

    psi(p) = [[cos t, -sin t, x],
              [sin t,  cos t, y],
              [0,      0,     1]]

so that ``psi(compose(p1, p2)) = psi(p1) psi(p2)``.
"""
from __future__ import annotations

import math

import torch


def wrap_angle(theta):
    """Wrap an angle (radians) into ``[-pi, pi)``. ``%`` on tensors is
    ``torch.remainder``, which takes the divisor's sign, as ``jnp``'s
    ``%`` does."""
    return (theta + math.pi) % (2.0 * math.pi) - math.pi


def identity(shape=(), dtype=torch.float32, device=None):
    """Identity pose(s) of the given leading shape."""
    return torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device)


def compose(p1, p2):
    """Group product ``p1 * p2`` (apply p2 in the frame of p1)."""
    x1, y1, t1 = p1[..., 0], p1[..., 1], p1[..., 2]
    x2, y2, t2 = p2[..., 0], p2[..., 1], p2[..., 2]
    c, s = torch.cos(t1), torch.sin(t1)
    x = x1 + c * x2 - s * y2
    y = y1 + s * x2 + c * y2
    return torch.stack([x, y, wrap_angle(t1 + t2)], -1)


def inverse(p):
    """Group inverse: ``compose(inverse(p), p) == identity``."""
    x, y, t = p[..., 0], p[..., 1], p[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    xi = -(c * x + s * y)
    yi = -(-s * x + c * y)
    return torch.stack([xi, yi, wrap_angle(-t)], -1)


def relative(p_n, p_m):
    """Relative pose ``p_{n->m} = p_n^{-1} p_m``.

    Broadcasts: pass ``p_n[..., :, None, :]`` and ``p_m[..., None, :, :]``
    for the full pairwise grid.
    """
    xn, yn, tn = p_n[..., 0], p_n[..., 1], p_n[..., 2]
    xm, ym, tm = p_m[..., 0], p_m[..., 1], p_m[..., 2]
    c, s = torch.cos(tn), torch.sin(tn)
    dx, dy = xm - xn, ym - yn
    x_rel = c * dx + s * dy
    y_rel = -s * dx + c * dy
    return torch.stack([x_rel, y_rel, wrap_angle(tm - tn)], -1)


def matrix(p):
    """Homogeneous 3x3 matrix representation ``psi(p)``."""
    x, y, t = p[..., 0], p[..., 1], p[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    row0 = torch.stack([c, -s, x], -1)
    row1 = torch.stack([s, c, y], -1)
    row2 = torch.stack([zeros, zeros, ones], -1)
    return torch.stack([row0, row1, row2], -2)


def from_matrix(m):
    """Inverse of :func:`matrix`."""
    t = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    return torch.stack([m[..., 0, 2], m[..., 1, 2], t], -1)


def rot2(theta):
    """2D rotation matrix ``rho(theta)`` with trailing shape (2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def transform_points(p, pts):
    """Apply pose ``p`` to 2D points ``pts`` (trailing dim 2)."""
    x, y, t = p[..., 0:1], p[..., 1:2], p[..., 2]
    c, s = torch.cos(t)[..., None], torch.sin(t)[..., None]
    px, py = pts[..., 0:1], pts[..., 1:2]
    return torch.cat([c * px - s * py + x, s * px + c * py + y], -1)
