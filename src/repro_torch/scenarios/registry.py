"""Scenario family registry (copy of ``repro/scenarios/registry.py``).

A family is a named generator ``(seed, index, cfg) -> Scene``; families
register at import, so importing ``repro_torch.scenarios`` populates it.
A family draws all its randomness from ``family_rng(name, seed, index)``
(freeform keeps the reference's legacy ``(seed, index)`` stream), so any
scene is reproducible from its cursor alone.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.scenarios.core import Scene, ScenarioConfig, stack_scenes

FamilyFn = Callable[[int, int, ScenarioConfig], Scene]

_FAMILIES: Dict[str, FamilyFn] = {}


def register(name: str) -> Callable[[FamilyFn], FamilyFn]:
    def deco(fn: FamilyFn) -> FamilyFn:
        if name in _FAMILIES:
            raise ValueError(f"scenario family {name!r} already registered")
        _FAMILIES[name] = fn
        return fn
    return deco


def names() -> List[str]:
    return sorted(_FAMILIES)


def get(name: str) -> FamilyFn:
    try:
        return _FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown scenario family {name!r}; "
                       f"registered: {names()}") from None


def generate_scene(name: str, seed: int, index: int,
                   cfg: ScenarioConfig) -> Scene:
    return get(name)(seed, index, cfg)


def family_rng(name: str, seed: int, index: int) -> np.random.Generator:
    """The one rng a family may draw from, salted by the family name."""
    salt = zlib.crc32(name.encode())
    return np.random.default_rng(np.random.SeedSequence([salt, seed, index]))


def generate_mixed(seed: int, start_index: int, count: int,
                   cfg: ScenarioConfig,
                   families: Optional[Sequence[str]] = None) -> List[Scene]:
    """``count`` scenes cycling deterministically over ``families``
    (default: every registered family)."""
    fams = list(families) if families is not None else names()
    return [generate_scene(fams[(start_index + i) % len(fams)], seed,
                           start_index + i, cfg)
            for i in range(count)]


def generate_mixed_batch(seed: int, start_index: int, batch_size: int,
                         cfg: ScenarioConfig,
                         families: Optional[Sequence[str]] = None):
    """Mixed-family batch with the ``ShardedIterator`` signature
    ``(seed, start_index, batch_size) -> dict of stacked arrays``."""
    return stack_scenes(generate_mixed(seed, start_index, batch_size, cfg,
                                       families))
