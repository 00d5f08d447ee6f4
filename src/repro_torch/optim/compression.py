"""Gradient compression for the cross-pod all-reduce (port of
``repro/optim/compression.py``).

Where the links between pods are an order of magnitude slower than those
inside one, the cross-pod gradient reduction is the bandwidth bottleneck.
Two compressors:

  * int8 linear quantization with a per-tensor scale (4x fewer bytes than
    float32), and
  * top-k sparsification with **error feedback**: the residual is carried
    to the next step so compression error does not bias convergence
    (Karimireddy et al., 2019).

The data-parallel step applies them around the cross-pod reduction
(:mod:`repro_torch.distributed.dp_compress`); inside a pod gradients reduce
in full precision. Trees are dicts (or tuples) of tensors, as the port's
parameters are.
"""
from __future__ import annotations

import dataclasses

import torch


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def compress_gradients(grads, bits: int = 8):
    """Per-tensor symmetric linear quantization to int8: each leaf becomes
    ``{"q": int8 tensor, "scale": 0-d float32}``."""
    if bits != 8:
        raise ValueError("int8 only")

    def one(g):
        g32 = g.to(torch.float32)
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}

    return _map(one, grads)


def decompress_gradients(comp):
    """The float32 tensors a :func:`compress_gradients` tree stands for."""
    if _quantized(comp):
        return comp["q"].to(torch.float32) * comp["scale"]
    if isinstance(comp, dict):
        return {k: decompress_gradients(v) for k, v in comp.items()}
    if isinstance(comp, (tuple, list)):
        return type(comp)(decompress_gradients(v) for v in comp)
    return comp


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCompressor:
    """Top-k sparsification with an error-feedback residual accumulator."""

    k_frac: float = 0.05

    def init(self, params):
        return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

    def compress(self, grads, residual):
        """Returns (sent, new_residual). ``sent`` is dense (zero off the
        top k of each tensor): on the wire a sparse encoding would ship
        (index, value) pairs; the dense stand-in keeps the algorithm exact
        for testing."""
        def one(g, r):
            acc = g.to(torch.float32) + r
            flat = torch.abs(acc).reshape(-1)
            k = max(1, int(flat.shape[0] * self.k_frac))
            thresh = torch.topk(flat, k).values[-1]
            mask = (torch.abs(acc) >= thresh).to(torch.float32)
            sent = acc * mask
            return _Pair(sent, acc - sent)

        pairs = _map(one, grads, residual)
        return (_map(lambda p: p.sent, pairs), _map(lambda p: p.rest, pairs))


@dataclasses.dataclass(frozen=True)
class _Pair:                  # a leaf of the tree compress() builds
    sent: torch.Tensor
    rest: torch.Tensor
