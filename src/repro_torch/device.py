"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raise when no card is present.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU (the parity tests) asks for ``device="cpu"``. On the card the
    reference precision is float32, so TF32 is switched off for matrix
    products and cuDNN alike (PyTorch's cuDNN default is TF32). ``meta``
    builds shapes without storage (parameter counts).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or 'meta' "
                         f"for shapes), got {dev}")
    return dev
