"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

Each schedule maps the step counter (an int or a tensor) to a 0-d float32
tensor on the CPU, computed in float32 as the reference computes it; a 0-d
CPU tensor combines with tensors on any device.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        return peak * torch.clamp(_f32(step) / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_decay(peak: float, decay_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn
