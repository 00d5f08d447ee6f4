"""Back-compat shim over the scenario suite (port of
``repro/data/scenarios.py``).

The historical surface (``ScenarioConfig``, ``generate_scene``,
``generate_batch``, the action codec, ``step_kinematics``,
``rollout_metrics``) over ``repro_torch.scenarios``: ``generate_scene`` is
the ``freeform`` family's scene, the arrays the reference's shim returns
(the family keeps its original random stream). New code imports from
``repro_torch.scenarios`` directly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.kinematics import DT, MAX_SPEED
from repro_torch.core.kinematics import step_kinematics as _step_kinematics
from repro_torch.scenarios.core import (ScenarioConfig, decode_action,
                                        encode_action, rollout_metrics)
from repro_torch.scenarios.families import freeform as _freeform

__all__ = ["DT", "MAX_SPEED", "ScenarioConfig", "encode_action",
           "decode_action", "step_kinematics", "generate_scene",
           "generate_batch", "rollout_metrics"]


def step_kinematics(pose, speed, accel, yaw_rate, dt: float = DT):
    """Unicycle integration; pose (..., 3), returns (new_pose, new_speed):
    the host-side numpy entry point of ``repro_torch.core.kinematics``."""
    return _step_kinematics(np.asarray(pose), speed, accel, yaw_rate, dt)


def generate_scene(seed: int, index: int, cfg: ScenarioConfig
                   ) -> Dict[str, np.ndarray]:
    """One free-form scene: map tokens, agent rollouts, next-action
    labels, and an ``agent_type`` vector (all vehicles)."""
    tensors, _ = _freeform.generate_tensors(seed, index, cfg)
    return tensors


def generate_batch(seed: int, start_index: int, batch_size: int,
                   cfg: ScenarioConfig) -> Dict[str, np.ndarray]:
    scenes = [generate_scene(seed, start_index + i, cfg)
              for i in range(batch_size)]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
