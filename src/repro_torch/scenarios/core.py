"""Scenario substrate (numpy copy of ``repro/scenarios/core.py``): the
config that fixes scene tensor shapes, the action-grid codec, and the Scene
container."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.kinematics import step_kinematics
from repro_torch.scenarios.lane_graph import LaneGraph

__all__ = ["step_kinematics", "ScenarioConfig", "Scene", "encode_action",
           "decode_action", "stack_scenes"]


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    num_map: int = 32             # lane-segment tokens per scene (cap)
    num_agents: int = 8           # agent slots per scene (cap; masked)
    num_steps: int = 16           # history + future steps tokenized
    accel_bins: int = 7           # action grid
    yaw_bins: int = 9
    max_accel: float = 3.0        # m/s^2
    max_yaw_rate: float = 0.5     # rad/s
    map_radius: float = 60.0
    agent_feat_dim: int = 8
    map_feat_dim: int = 8

    @property
    def num_actions(self) -> int:
        return self.accel_bins * self.yaw_bins

    def accel_values(self):
        return np.linspace(-self.max_accel, self.max_accel, self.accel_bins)

    def yaw_values(self):
        return np.linspace(-self.max_yaw_rate, self.max_yaw_rate,
                           self.yaw_bins)


def encode_action(cfg: ScenarioConfig, accel, yaw_rate):
    """Nearest grid cell -> action id."""
    ai = np.argmin(np.abs(cfg.accel_values()[None, :]
                          - np.asarray(accel)[..., None]), axis=-1)
    yi = np.argmin(np.abs(cfg.yaw_values()[None, :]
                          - np.asarray(yaw_rate)[..., None]), axis=-1)
    return ai * cfg.yaw_bins + yi


def decode_action(cfg: ScenarioConfig, action_id):
    ai, yi = np.divmod(np.asarray(action_id), cfg.yaw_bins)
    return cfg.accel_values()[ai], cfg.yaw_values()[yi]


@dataclasses.dataclass
class Scene:
    """One generated scene: the model-facing tensor dict plus host-side
    world metadata.

    ``tensors``: map_feats (M, Fm), map_pose (M, 3), map_valid (M,) bool,
    agent_feats (T, A, Fa), agent_pose (T, A, 3), agent_valid (T, A),
    actions (T, A) int32, behavior (A,) int32, agent_type (A,) int32.
    """
    family: str
    tensors: Dict[str, np.ndarray]
    lane_graph: Optional[LaneGraph] = None


def stack_scenes(scenes: List[Scene]) -> Dict[str, np.ndarray]:
    """Stack same-config scenes (any mix of families) into one batch dict."""
    keys = scenes[0].tensors.keys()
    return {k: np.stack([s.tensors[k] for s in scenes]) for k in keys}
