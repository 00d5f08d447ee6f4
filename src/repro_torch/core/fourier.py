"""Fourier-series machinery for the SE(2) Fourier encoding (port of
``repro/core/fourier.py``).

``cos(u(theta))`` / ``sin(u(theta))`` with ``u^x = x cos z + y sin z`` and
``u^y = -x sin z + y cos z`` are approximated by a truncated series in the
basis g_0 = 1, g_i = sin(((i + 1) / 2) z) (odd i), cos((i / 2) z) (even i),
with coefficients from the rectangle rule at 2F nodes on [-pi, pi). The
constants are computed once in float64 numpy and cast to float32 at use.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def basis_frequencies(num_terms: int) -> np.ndarray:
    """Integer frequency of each basis element g_i (0, 1, 1, 2, 2, ...)."""
    i = np.arange(num_terms)
    return np.where(i % 2 == 0, i // 2, (i + 1) // 2)


def eval_basis(z: torch.Tensor, num_terms: int) -> torch.Tensor:
    """``[g_0(z), ..., g_{F-1}(z)]``; output shape ``z.shape + (F,)``."""
    freqs = torch.as_tensor(basis_frequencies(num_terms), dtype=z.dtype,
                            device=z.device)
    is_odd = torch.as_tensor(np.arange(num_terms) % 2 == 1, device=z.device)
    zf = z[..., None] * freqs
    return torch.where(is_odd, torch.sin(zf), torch.cos(zf))


@functools.lru_cache(maxsize=None)
def _quadrature_constants(num_terms: int):
    """Quadrature nodes (2F,) and the (2F, F) projection matrix, float64.

    ``proj[j, i] = a_i * g_i(z_j) / (2F)`` so that for samples
    ``f_j = f(z_j)`` the coefficients are ``f @ proj``.
    """
    f = int(num_terms)
    nodes = -np.pi + 2.0 * np.pi * np.arange(2 * f) / (2 * f)
    freqs = basis_frequencies(f)
    i = np.arange(f)
    g = np.where(
        i[None, :] % 2 == 1,
        np.sin(nodes[:, None] * freqs[None, :]),
        np.cos(nodes[:, None] * freqs[None, :]),
    )
    a = np.where(i == 0, 1.0, 2.0)
    proj = g * a[None, :] / (2 * f)
    return nodes, proj


def quadrature_nodes(num_terms: int, dtype=torch.float32, device=None):
    nodes, _ = _quadrature_constants(num_terms)
    return torch.as_tensor(nodes, dtype=dtype, device=device)


def quadrature_projection(num_terms: int, dtype=torch.float32, device=None):
    _, proj = _quadrature_constants(num_terms)
    return torch.as_tensor(proj, dtype=dtype, device=device)


def xy_coefficients(x: torch.Tensor, y: torch.Tensor, num_terms: int):
    """``(gamma_x, lambda_x, gamma_y, lambda_y)``, each ``x.shape + (F,)``:
    the series coefficients of cos/sin(u^x) and cos/sin(u^y) for the key
    position (x, y)."""
    nodes = quadrature_nodes(num_terms, x.dtype, x.device)
    cz, sz = torch.cos(nodes), torch.sin(nodes)
    u_x = x[..., None] * cz + y[..., None] * sz
    u_y = -x[..., None] * sz + y[..., None] * cz
    proj = quadrature_projection(num_terms, x.dtype, x.device)
    return (torch.cos(u_x) @ proj, torch.sin(u_x) @ proj,
            torch.cos(u_y) @ proj, torch.sin(u_y) @ proj)
