"""Procedural driving scenes (numpy copy of the parts of
``repro.scenarios`` this slice runs)."""
from repro_torch.scenarios import core, families, lane_graph, registry
from repro_torch.scenarios.core import (Scene, ScenarioConfig, decode_action,
                                        encode_action)
from repro_torch.scenarios.registry import generate_scene

__all__ = ["core", "families", "lane_graph", "registry", "Scene",
           "ScenarioConfig", "decode_action", "encode_action",
           "generate_scene"]
