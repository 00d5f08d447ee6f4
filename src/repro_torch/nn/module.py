"""Parameter specs and seeded initialisation (port of ``repro/nn/module.py``).

A layer declares each weight with a :class:`ParamSpec` (shape and init
kind); :func:`init_params` fills every parameter of a module from one
``torch.Generator``. The init kinds are the reference's that the ported
layers use (fan_in, normal with its ``scale``, uniform in [-scale, scale],
ones, zeros); the random numbers differ, since the port does not
reproduce ``jax.random`` (weights cross over through
``repro_torch.params.from_reference`` where a test needs equality). A
module built on the ``meta`` device has shapes and no storage:
:func:`count_params` counts a 20 B-parameter config that way without
allocating it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "fan_in"          # fan_in | normal | uniform | ones | zeros
    fan_in: int = 0               # fan_in init: input size (0 -> shape[0])
    scale: float = 0.02           # normal: standard deviation; uniform: bound
    axes: Tuple[Optional[str], ...] = ()    # logical axis names

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape}")


def new_parameter(spec: ParamSpec, device) -> nn.Parameter:
    """An uninitialised parameter that remembers its spec."""
    p = nn.Parameter(torch.empty(spec.shape, dtype=torch.float32,
                                 device=device), requires_grad=False)
    p.spec = spec
    return p


def _init_leaf(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=dev)
    if spec.init == "normal":
        return torch.randn(spec.shape, generator=gen, device=dev) * spec.scale
    if spec.init == "fan_in":
        fan_in = spec.fan_in or (spec.shape[0] if spec.shape else 1)
        return torch.randn(spec.shape, generator=gen, device=dev) / float(
            np.sqrt(max(fan_in, 1)))
    if spec.init == "uniform":
        # the reference's ``jax.random.uniform(minval=-scale, maxval=scale)``
        return (torch.rand(spec.shape, generator=gen, device=dev) * 2.0
                - 1.0) * spec.scale
    raise ValueError(f"unknown init {spec.init!r}")


@torch.no_grad()
def init_params(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every spec'd parameter of ``module`` in sorted-name order.

    Numbers are drawn on the generator's device and copied to each
    parameter's device, so a CPU generator gives the same weights on every
    device (a CUDA generator draws a full-width LM in a fraction of the
    time, other numbers for the same seed). A module on the ``meta``
    device is left as it is.
    """
    for _, p in sorted(module.named_parameters()):
        if p.device.type != "meta":
            p.copy_(_init_leaf(p.spec, gen))
    return module


def param_specs(module: nn.Module) -> Dict[str, ParamSpec]:
    """``{parameter name: ParamSpec}`` of every parameter of ``module``
    (the reference's spec tree, flat by the port's names)."""
    return {n: p.spec for n, p in module.named_parameters()}


def count_params(module: nn.Module) -> int:
    """Parameters of ``module``: the reference's ``count_params(specs)``.
    Works on a module built on the ``meta`` device."""
    return sum(p.numel() for p in module.parameters())
