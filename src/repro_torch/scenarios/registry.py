"""Scenario family registry (copy of ``repro/scenarios/registry.py``).

A family is a named generator ``(seed, index, cfg) -> Scene``; families
register at import, so importing ``repro_torch.scenarios`` populates it.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.scenarios.core import Scene, ScenarioConfig

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
