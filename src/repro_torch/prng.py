"""The parts of ``jax.random`` the sim paths use, in plain PyTorch, bit for
bit (the Threefry-2x32 generator of jax 0.9.0, whose
``jax_threefry_partitionable`` flag is on).

A key is its key data: two uint32 values, held in the last axis of an
int64 tensor (``(..., 2)``), the values ``jax.random.key_data`` gives.
Every operation works on int64 values masked to 32 bits, which every
device supports (PyTorch's own ``uint32`` is partial); the Threefry
arithmetic takes plain Python ints as well, so a host computes one lane's
key without a tensor.

* :func:`key` is ``jax.random.key(seed)``: ``[0, seed mod 2^32]`` (jax
  keeps 32-bit seeds while x64 is off).
* :func:`fold_in` is ``jax.random.fold_in``: the key hashed with the
  counters ``(0, data)``.
* :func:`random_bits` gives the 32-bit words of a shape: the element at
  flat index i hashes the counters ``(i >> 32, i & 0xFFFFFFFF)`` and the
  two output words are XORed (the partitionable scheme).
* :func:`uniform`, :func:`gumbel` (the default "low" mode,
  ``-log(-log(u))`` over ``u`` in [tiny, 1)) and :func:`categorical`
  (Gumbel-max over the last axis, ties to the lowest index, as
  ``jnp.argmax``) follow ``jax._src.random`` operation for operation in
  float32.

The CUDA kernel ``kernels/categorical.py`` computes :func:`categorical`
of a tick (and the ``fold_in`` of each lane's step) in one launch; this
module is its plain version.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)

IntLike = Union[int, torch.Tensor]


def _rotl(x: IntLike, r: int) -> IntLike:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1: IntLike, k2: IntLike, x1: IntLike, x2: IntLike):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2): a pair of uint32 words. Arguments are ints or
    int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _data_u32(data: IntLike) -> IntLike:
    """``jnp.asarray(data, uint32)``: a Python int must lie in
    [0, 2^32), an integer tensor wraps mod 2^32."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & _M32
    data = int(data)
    if not 0 <= data <= _M32:
        raise OverflowError(f"Python integer {data} out of bounds for uint32")
    return data


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data, (2,) int64."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def key_data(keys: torch.Tensor) -> np.ndarray:
    """The keys' values as ``jax.random.key_data`` gives them: a uint32
    numpy array of the same shape."""
    return keys.detach().cpu().numpy().astype(np.uint32)


def fold_in_pair(k1: IntLike, k2: IntLike, data: IntLike):
    """``fold_in`` on a key given as its two words (ints or tensors)."""
    return threefry2x32(k1, k2, 0, _data_u32(data))


def fold_in(keys: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in`` of keys (..., 2) with ``data``: an int, or
    an integer tensor of the keys' batch shape (``vmap(fold_in)``)."""
    y1, y2 = fold_in_pair(keys[..., 0], keys[..., 1], data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def lane_key(seed: int, scene: int, sample: int):
    """``fold_in(fold_in(key(seed), scene), sample)`` as two ints: the key
    of rollout lane (scene, sample), computed on the host."""
    k = fold_in_pair(0, int(seed) & _M32, scene)
    return fold_in_pair(*k, sample)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit words (..., *shape) int64 of each key (..., 2), as
    ``jax.random.bits(key, shape, uint32)``: element i of the flattened
    shape hashes the counters (i >> 32, i & 0xFFFFFFFF)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(*lead, 1)
    k2 = keys[..., 1].reshape(*lead, 1)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (y1 ^ y2).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` of each
    key (..., 2): (..., *shape) float32. A word's top 23 bits are the
    mantissa of a float in [1, 2); minus 1, it lies in [0, 1)."""
    bits = random_bits(keys, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(f * float(hi - lo) + float(lo), min=float(lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low") of each
    key (..., 2): ``-log(-log(u))``, u uniform over [tiny, 1)."""
    u = uniform(keys, shape, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.categorical)(keys, logits)``: keys (B..., 2),
    logits (B..., *event, K) float32; int64 samples (B..., *event) by
    Gumbel-max over the last axis, the noise of each key of shape
    (*event, K)."""
    event = logits.shape[keys.dim() - 1:]
    scores = gumbel(keys, event) + logits.to(torch.float32)
    return torch.argmax(scores, dim=-1)
