"""Optimizers (port of ``repro/optim``): composable gradient transforms
over dicts of named tensors, and learning-rate schedules. ``adafactor``
comes with the LM stack (see ROADMAP.md)."""
from repro_torch.optim.schedules import (constant, cosine_decay, linear_warmup,
                                         warmup_cosine)
from repro_torch.optim.transforms import (OptState, Optimizer, adamw,
                                          apply_updates, chain,
                                          clip_by_global_norm, global_norm,
                                          sgd)

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates", "chain",
           "clip_by_global_norm", "global_norm", "sgd", "constant",
           "cosine_decay", "linear_warmup", "warmup_cosine"]
