"""Highway cruise: parallel straight lanes, free-flow + car-following.
(Numpy copy of ``repro/scenarios/families/highway.py``.)

    ============================================>  lane 2
    =====car=========car========================>  lane 1
    ==========car===============car=============>  lane 0

The whole corridor is randomly re-posed per scene (rotation + offset), so
absolute-position models can't overfit a canonical frame.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import Scene, ScenarioConfig, assemble_scene
from repro_torch.scenarios.lane_graph import LaneGraph, straight_lane
from repro_torch.scenarios.policies import (agent_on_route, simulate,
                                            spaced_starts)

LANE_WIDTH = 3.5


@registry.register("highway")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    rng = registry.family_rng("highway", seed, index)
    heading = rng.uniform(-np.pi, np.pi)
    origin = rng.uniform(-0.3 * cfg.map_radius, 0.3 * cfg.map_radius, 2)
    length = 180.0
    n_lanes = int(rng.integers(2, 4))
    normal = np.array([-np.sin(heading), np.cos(heading)])
    start0 = origin - 0.5 * length * np.array([np.cos(heading),
                                               np.sin(heading)])

    g = LaneGraph()
    lane_ids = []
    for li in range(n_lanes):
        lane_ids.append(g.add(straight_lane(
            start0 + li * LANE_WIDTH * normal, heading, length,
            speed_limit=14.0)))
    for li in range(n_lanes - 1):
        g.set_neighbors(lane_ids[li], left=lane_ids[li + 1])
        g.set_neighbors(lane_ids[li + 1], right=lane_ids[li])

    n_agents = int(rng.integers(min(3, cfg.num_agents),
                                cfg.num_agents + 1))
    per_lane = [n_agents // n_lanes + (1 if li < n_agents % n_lanes else 0)
                for li in range(n_lanes)]
    agents = []
    for li, count in enumerate(per_lane):
        xy, hd = g.route_points([lane_ids[li]])
        starts = spaced_starts(rng, count, 10.0, 0.6 * length, min_gap=18.0)
        for s0 in starts:
            agents.append(agent_on_route(
                float(s0), xy, hd, v0=float(rng.uniform(8.0, 14.0)), rng=rng))
    pose, feats, actions = simulate(cfg, rng, agents, cfg.num_steps)
    types = np.zeros(len(agents), np.int32)
    return assemble_scene("highway", cfg, g, pose, feats, actions, types)
