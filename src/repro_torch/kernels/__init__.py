"""Kernels of the port: CUDA C++ sources in ``csrc/``, their wrappers,
their plain PyTorch versions, and the attention dispatch."""
from repro_torch.kernels import (categorical, cuda, flash_attention,
                                 flash_attention_bwd, flash_decode, ops, ref,
                                 se2_project)

__all__ = ["categorical", "cuda", "flash_attention", "flash_attention_bwd",
           "flash_decode", "ops", "ref", "se2_project"]
