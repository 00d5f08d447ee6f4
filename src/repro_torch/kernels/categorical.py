"""``jax.random``-exact categorical sampling of a tick (no TPU kernel: the
reference samples in XLA, ``repro/runtime/rollout.py:202-206``).

Lane b draws ``categorical(fold_in(keys[b], steps[b]), logits[b])``: the
Threefry-2x32 Gumbel-max of :mod:`repro_torch.prng`, each lane at its own
step (a server's slots are each at their own step; an engine's lanes share
one).

* :func:`categorical` launches the CUDA kernel in ``csrc/categorical.cu``
  for CUDA tensors (and raises on anything it does not take) and runs
  :func:`categorical_plain` for CPU tensors.
* :func:`categorical_debug` (CUDA only) also returns each element's 32-bit
  word, uniform and Gumbel noise, for the checks against the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import prng
from repro_torch.kernels import cuda
from repro_torch.obs import cost


def categorical_plain(keys: torch.Tensor, steps: torch.Tensor,
                      logits: torch.Tensor) -> torch.Tensor:
    """The plain version: keys (B, 2) int64, steps (B,) integer, logits
    (B, A, K); int64 action ids (B, A)."""
    return prng.categorical(prng.fold_in(keys, steps), logits)


def categorical(keys: torch.Tensor, steps: torch.Tensor,
                logits: torch.Tensor) -> torch.Tensor:
    """Action ids (B, A) int64 sampled from logits (B, A, K) float32 with
    the lanes' keys (B, 2) int64 folded with their steps (B,) int32: the
    kernel for CUDA tensors, the plain version for CPU tensors, the output
    alone for meta tensors."""
    with cost.kernel_cost(lambda: cost.sampler_cost(logits)):
        if logits.device.type == "cpu":
            return categorical_plain(keys, steps, logits)
        out = torch.empty(logits.shape[:2], dtype=torch.int64,
                          device=logits.device)
        if logits.device.type == "meta":
            return out
        _launch(keys, steps, logits, out, None)
        cuda.count_launch("categorical")
        return out


def categorical_debug(keys: torch.Tensor, steps: torch.Tensor,
                      logits: torch.Tensor):
    """(actions, words, uniforms, noise) from the kernel's debug entry:
    actions (B, A) int64; each element's 32-bit word (B, A, K) int64, its
    uniform and its Gumbel noise (B, A, K) float32. CUDA tensors only; not
    counted as a launch of the sampling path."""
    if logits.device.type != "cuda":
        raise ValueError("categorical_debug runs the kernel: CUDA tensors "
                         "only")
    b, a, k = logits.shape
    dev = logits.device
    out = torch.empty((b, a), dtype=torch.int64, device=dev)
    words = torch.empty((b, a, k), dtype=torch.int64, device=dev)
    unif = torch.empty((b, a, k), dtype=torch.float32, device=dev)
    noise = torch.empty((b, a, k), dtype=torch.float32, device=dev)
    _launch(keys, steps, logits, out, (words, unif, noise))
    return out, words, unif, noise


def _launch(keys, steps, logits, out, debug):
    dev = logits.device
    if logits.dtype != torch.float32 or logits.ndim != 3 \
            or not logits.is_contiguous():
        raise ValueError(f"logits must be a contiguous float32 (B, A, K) "
                         f"tensor, got {logits.dtype} {tuple(logits.shape)}")
    b, a, k = logits.shape
    if keys.dtype != torch.int64 or tuple(keys.shape) != (b, 2) \
            or keys.device != dev or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous int64 ({b}, 2) tensor "
                         f"on {dev}, got {keys.dtype} {tuple(keys.shape)} "
                         f"on {keys.device}")
    if steps.dtype != torch.int32 or tuple(steps.shape) != (b,) \
            or steps.device != dev or not steps.is_contiguous():
        raise ValueError(f"steps must be a contiguous int32 ({b},) tensor on "
                         f"{dev}, got {steps.dtype} {tuple(steps.shape)} on "
                         f"{steps.device}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if debug is None:
        _kernel("categorical")(keys.data_ptr(), steps.data_ptr(),
                               logits.data_ptr(), out.data_ptr(), b, a, k,
                               stream)
    else:
        _kernel("categorical_debug")(
            keys.data_ptr(), steps.data_ptr(), logits.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in debug), b, a, k, stream)


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    n_ptr = 4 if entry == "categorical" else 7
    return cuda.launcher("categorical", [ctypes.c_void_p] * n_ptr
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         entry=entry)
