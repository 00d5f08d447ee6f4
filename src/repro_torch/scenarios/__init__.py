"""Scenario suite (numpy copy of ``repro.scenarios``): the lane-graph
world, rule-based reference policies, and the registry of procedural
families, each emitting the same ``AgentSimModel`` tensor dict (variable
agent counts via validity masks, deterministic from ``(family, seed,
index)``). The closed-loop evaluation over these scenes lives in
``repro_torch.runtime.evaluation``.
"""
from repro_torch.scenarios import core, lane_graph, policies, registry
from repro_torch.scenarios import families  # noqa: F401  (registers families)
from repro_torch.scenarios.core import (AGENT_TYPE, DT, MAX_SPEED, Scene,
                                        ScenarioConfig, assemble_scene,
                                        classify_behavior, decode_action,
                                        encode_action, rollout_metrics,
                                        stack_scenes, step_kinematics,
                                        transform_poses, transform_scene)
from repro_torch.scenarios.lane_graph import LaneGraph
from repro_torch.scenarios.registry import (generate_mixed,
                                            generate_mixed_batch,
                                            generate_scene)

__all__ = [
    "core", "lane_graph", "policies", "registry", "families",
    "AGENT_TYPE", "DT", "MAX_SPEED", "Scene", "ScenarioConfig",
    "assemble_scene", "classify_behavior", "decode_action", "encode_action",
    "rollout_metrics", "stack_scenes", "step_kinematics", "transform_poses",
    "transform_scene", "LaneGraph", "generate_mixed", "generate_mixed_batch",
    "generate_scene",
]
