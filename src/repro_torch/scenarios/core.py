"""Shared scenario substrate (numpy copy of ``repro/scenarios/core.py``):
config, action codec, the Scene container, behavior classification, rigid
re-posing, and mask-aware rollout metrics.

``ScenarioConfig`` (and the action grid codec) is the single source of
truth for scene tensor shapes: every scenario family pads its output to
the config's ``num_map`` / ``num_agents`` caps with validity masks, so
mixed-family batches stack into one static-shape tensor dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.kinematics import (DT, MAX_SPEED, step_kinematics,
                                   wrap_angle)
from repro_torch.scenarios.lane_graph import LaneGraph

__all__ = [
    "DT", "MAX_SPEED", "step_kinematics", "ScenarioConfig", "Scene",
    "encode_action", "decode_action", "assemble_scene", "classify_behavior",
    "transform_poses", "transform_scene", "stack_scenes",
    "rollout_metrics", "AGENT_TYPE",
]

AGENT_TYPE = {"vehicle": 0, "pedestrian": 1}

# behavior categories (paper Table I columns)
BEHAVIOR = {"stationary": 0, "straight": 1, "turning": 2}


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    num_map: int = 32             # lane-segment tokens per scene (cap)
    num_agents: int = 8           # agent slots per scene (cap; masked)
    num_steps: int = 16           # history+future steps tokenized
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
    world metadata the evaluation harness needs (never fed to the model).

    ``tensors`` has the :class:`repro_torch.nn.agent_sim.AgentSimModel` layout:
      map_feats (M, Fm), map_pose (M, 3), map_valid (M,) bool
      agent_feats (T, A, Fa), agent_pose (T, A, 3), agent_valid (T, A)
      actions (T, A) int32, behavior (A,) int32, agent_type (A,) int32
    Agent slots are packed valid-first; ``agent_valid`` is constant over
    time per slot (agents don't appear/disappear mid-scene) and False for
    padding slots beyond the family's drawn agent count.
    """
    family: str
    tensors: Dict[str, np.ndarray]
    lane_graph: Optional[LaneGraph] = None

    @property
    def num_valid_agents(self) -> int:
        return int(self.tensors["agent_valid"][0].sum())


def assemble_scene(family: str, cfg: ScenarioConfig, lane_graph: LaneGraph,
                   agent_pose: np.ndarray, agent_feats: np.ndarray,
                   actions: np.ndarray, agent_type: np.ndarray) -> Scene:
    """Pack simulated trajectories + a lane graph into a model-ready Scene.

    agent_pose (T, n, 3) / agent_feats (T, n, Fa) / actions (T, n) for the
    n *real* agents (n <= cfg.num_agents); slots [n, num_agents) are
    padding with ``agent_valid`` False. Map tokens come from the lane
    graph, padded/masked to ``cfg.num_map`` the same way.
    """
    t, n = agent_pose.shape[:2]
    a = cfg.num_agents
    assert n <= a, f"family {family!r} produced {n} agents > cap {a}"
    map_pose, map_feats, map_valid = lane_graph.map_tokens(
        cfg.num_map, cfg.map_feat_dim)
    pad = lambda arr, fill=0: np.concatenate(
        [arr, np.full((t, a - n) + arr.shape[2:], fill, arr.dtype)], axis=1)
    pose = pad(agent_pose.astype(np.float32))
    feats = pad(agent_feats.astype(np.float32))
    acts = pad(actions.astype(np.int32))
    valid = np.zeros((t, a), bool)
    valid[:, :n] = True
    types = np.concatenate(
        [np.asarray(agent_type, np.int32),
         np.zeros(a - n, np.int32)])
    tensors = {
        "map_feats": map_feats,
        "map_pose": map_pose,
        "map_valid": map_valid,
        "agent_feats": feats,
        "agent_pose": pose,
        "agent_valid": valid,
        "actions": acts,
        "behavior": classify_behavior(pose, valid),
        "agent_type": types,
    }
    return Scene(family=family, tensors=tensors, lane_graph=lane_graph)


def classify_behavior(agent_pose: np.ndarray, agent_valid: np.ndarray,
                      stationary_disp: float = 2.0,
                      turning_yaw: float = 0.3) -> np.ndarray:
    """Label each agent stationary / straight / turning from its
    ground-truth trajectory (paper Table I's per-category split).

    agent_pose (T, A, 3); agent_valid (T, A). Invalid agents get -1.
    """
    disp = np.linalg.norm(agent_pose[-1, :, :2] - agent_pose[0, :, :2],
                          axis=-1)
    dth = np.abs(wrap_angle(agent_pose[-1, :, 2] - agent_pose[0, :, 2],
                            xp=np))
    out = np.where(disp < stationary_disp, BEHAVIOR["stationary"],
                   np.where(dth > turning_yaw, BEHAVIOR["turning"],
                            BEHAVIOR["straight"]))
    return np.where(agent_valid[0], out, -1).astype(np.int32)


def transform_poses(z, pose):
    """Left-compose a global SE(2) transform with (..., 3) poses (numpy)."""
    z = np.asarray(z, np.float32)
    pose = np.asarray(pose, np.float32)
    c, s = np.cos(z[2]), np.sin(z[2])
    x = z[0] + c * pose[..., 0] - s * pose[..., 1]
    y = z[1] + s * pose[..., 0] + c * pose[..., 1]
    return np.stack([x, y, pose[..., 2] + z[2]], -1).astype(np.float32)


def transform_scene(scene: Scene, z) -> Scene:
    """The whole scene rigidly re-posed by z = (x, y, theta): map tokens,
    agent trajectories, and the lane graph. Features, actions, masks, and
    all relative geometry are untouched — an SE(2)-invariant model + the
    metric stack must not notice (property-tested in tests/test_scenarios)."""
    t = dict(scene.tensors)
    t["map_pose"] = transform_poses(z, t["map_pose"])
    t["agent_pose"] = transform_poses(z, t["agent_pose"])
    lg = scene.lane_graph.transformed(z) if scene.lane_graph else None
    return Scene(family=scene.family, tensors=t, lane_graph=lg)


def stack_scenes(scenes: List[Scene]) -> Dict[str, np.ndarray]:
    """Stack same-config scenes (any mix of families) into one batch dict."""
    keys = scenes[0].tensors.keys()
    return {k: np.stack([s.tensors[k] for s in scenes]) for k in keys}


def rollout_metrics(cfg: ScenarioConfig, gt_pose, sampled_poses, behavior,
                    agent_valid=None):
    """minADE over samples, split by ground-truth behavior category.

    gt_pose (T, A, 3); sampled_poses (K, T, A, 3); behavior (A,);
    agent_valid (T, A) or (A,) bool — invalid agents/steps are excluded
    from the displacement average instead of silently dragging the mean
    (padding slots used to be averaged in as if they were real agents).
    Returns dict of minADE per category (paper Table I columns).
    """
    gt_pose = np.asarray(gt_pose)
    sampled_poses = np.asarray(sampled_poses)
    t, a = gt_pose.shape[:2]
    if agent_valid is None:
        valid = np.ones((t, a), bool)
    else:
        valid = np.asarray(agent_valid, bool)
        if valid.ndim == 1:
            valid = np.broadcast_to(valid[None, :], (t, a))
    d = np.linalg.norm(sampled_poses[..., :2] - gt_pose[None, ..., :2],
                       axis=-1)                     # (K, T, A)
    w = valid.astype(np.float64)                    # (T, A)
    steps = w.sum(axis=0)                           # (A,)
    ade = (d * w[None]).sum(axis=1) / np.maximum(steps[None], 1.0)  # (K, A)
    min_ade = ade.min(axis=0)                       # (A,)
    alive = steps > 0
    out = {}
    for name, b in (("stationary", 0), ("straight", 1), ("turning", 2)):
        sel = (np.asarray(behavior) == b) & alive
        out[name] = float(min_ade[sel].mean()) if sel.any() else float("nan")
    return out
