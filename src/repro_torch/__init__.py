"""PyTorch/CUDA port of the SE(2)-invariant agent-simulation stack.

The JAX package ``repro`` is the reference; this package mirrors its
module paths (``repro_torch.core.encodings`` ports ``repro.core.encodings``
and so on) and imports nothing from it. Plain tensor code is PyTorch; the
TPU kernels on the ported path are CUDA C++ kernels for Hopper
(``repro_torch/kernels/csrc``), each with a plain PyTorch version beside
its wrapper.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise (:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
