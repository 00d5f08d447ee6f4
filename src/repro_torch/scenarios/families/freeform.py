"""The free-form scenario family (numpy copy of
``repro/scenarios/families/freeform.py``).

A few disconnected arcs/straights, a fixed agent count, and three
hand-assigned behavior modes (stationary / straight / turny). The RNG
stream is seeded by ``(seed, index)`` directly, exactly as the reference
draws it, so both packages generate bit-identical scenes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.kinematics import DT
from repro_torch.scenarios import registry
from repro_torch.scenarios.core import (Scene, ScenarioConfig,
                                        decode_action, encode_action,
                                        step_kinematics)
from repro_torch.scenarios.lane_graph import LaneGraph, polyline_lane


def _make_lanes(rng, cfg: ScenarioConfig):
    """A few arcs/straights through the scene; returns per-segment pose+feat."""
    poses = np.zeros((cfg.num_map, 3), np.float32)
    feats = np.zeros((cfg.num_map, cfg.map_feat_dim), np.float32)
    n_lanes = rng.integers(2, 5)
    seg_per_lane = cfg.num_map // n_lanes
    idx = 0
    lanes = []
    for li in range(n_lanes):
        start = rng.uniform(-cfg.map_radius * 0.5, cfg.map_radius * 0.5, 2)
        heading = rng.uniform(-np.pi, np.pi)
        curvature = rng.uniform(-0.02, 0.02)
        seg_len = rng.uniform(5.0, 10.0)
        pts = []
        x, y, th = start[0], start[1], heading
        for si in range(seg_per_lane):
            if idx >= cfg.num_map:
                break
            poses[idx] = (x, y, th)
            feats[idx, 0] = seg_len / 10.0
            feats[idx, 1] = curvature * 50.0
            feats[idx, 2] = 1.0  # type: lane
            feats[idx, 3] = li / n_lanes
            pts.append((x, y, th, seg_len))
            x += seg_len * np.cos(th)
            y += seg_len * np.sin(th)
            th += curvature * seg_len
            idx += 1
        lanes.append(pts)
    return poses, feats, lanes


def _lane_graph_from_chains(lanes) -> LaneGraph:
    """Deterministic LaneGraph over the drawn segment chains (no rng)."""
    g = LaneGraph()
    for pts in lanes:
        if not pts:
            continue
        xy = [(p[0], p[1]) for p in pts]
        last = pts[-1]
        xy.append((last[0] + last[3] * np.cos(last[2]),
                   last[1] + last[3] * np.sin(last[2])))
        g.add(polyline_lane(np.asarray(xy, np.float64)))
    return g


def generate_tensors(seed: int, index: int, cfg: ScenarioConfig):
    """The legacy scene dict (exact pre-refactor arrays) + the lane chains."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    map_pose, map_feats, lanes = _make_lanes(rng, cfg)

    a, t = cfg.num_agents, cfg.num_steps
    pose = np.zeros((a, 3), np.float32)
    speed = rng.uniform(0.0, 12.0, a).astype(np.float32)
    behavior = rng.integers(0, 3, a)  # 0 stationary-ish, 1 straight, 2 turny
    for ai in range(a):
        lane = lanes[rng.integers(0, len(lanes))]
        seg = lane[rng.integers(0, len(lane))]
        pose[ai] = (seg[0] + rng.normal(0, 1.0), seg[1] + rng.normal(0, 1.0),
                    seg[2] + rng.normal(0, 0.1))
        if behavior[ai] == 0:
            speed[ai] = rng.uniform(0, 0.5)

    agent_pose = np.zeros((t, a, 3), np.float32)
    agent_feats = np.zeros((t, a, cfg.agent_feat_dim), np.float32)
    actions = np.zeros((t, a), np.int64)
    cur_pose, cur_speed = pose, speed
    for ti in range(t):
        agent_pose[ti] = cur_pose
        agent_feats[ti, :, 0] = cur_speed / 10.0
        agent_feats[ti, :, 1] = (behavior == 1)
        agent_feats[ti, :, 2] = (behavior == 2)
        agent_feats[ti, :, 3] = 1.0
        # policy: noisy accel; turny agents sweep yaw rate sinusoidally
        accel = np.where(behavior == 0,
                         -cur_speed / DT * 0.5,
                         rng.normal(0.3, 0.8, a))
        yaw = np.where(behavior == 2,
                       cfg.max_yaw_rate * 0.7
                       * np.sin(0.4 * ti + np.arange(a)),
                       rng.normal(0, 0.03, a))
        accel = np.clip(accel, -cfg.max_accel, cfg.max_accel)
        yaw = np.clip(yaw, -cfg.max_yaw_rate, cfg.max_yaw_rate)
        act_id = encode_action(cfg, accel, yaw)
        actions[ti] = act_id
        # integrate with the *quantized* action so labels are exact
        qa, qy = decode_action(cfg, act_id)
        cur_pose, cur_speed = step_kinematics(cur_pose, cur_speed, qa, qy)

    tensors = {
        "map_feats": map_feats,
        "map_pose": map_pose,
        "map_valid": np.ones(cfg.num_map, bool),
        "agent_feats": agent_feats,
        "agent_pose": agent_pose,
        "agent_valid": np.ones((t, a), bool),
        "actions": actions.astype(np.int32),
        "behavior": behavior.astype(np.int32),
        "agent_type": np.zeros(a, np.int32),       # all vehicles
    }
    return tensors, lanes


@registry.register("freeform")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    tensors, lanes = generate_tensors(seed, index, cfg)
    return Scene(family="freeform", tensors=tensors,
                 lane_graph=_lane_graph_from_chains(lanes))
