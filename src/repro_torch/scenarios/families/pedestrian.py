"""Pedestrian crossing: heterogeneous agent types on a two-way road.
(Numpy copy of ``repro/scenarios/families/pedestrian.py``.)

           |  ped  |
    =======|...|...|=======>  eastbound lane
    <======|...v...|========  westbound lane
           | cross |
           |  walk |

Pedestrians (agent_type 1, walking speed, top priority) cross on a
crosswalk lane; vehicles on both lanes yield to them at the conflict
points. The only family with non-vehicle dynamics — it exercises the
heterogeneous-agent path of the model features and the per-type
exemptions in the evaluation metrics (pedestrians are never "off-road").
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import (AGENT_TYPE, Scene, ScenarioConfig,
                                        assemble_scene)
from repro_torch.scenarios.lane_graph import LaneGraph, straight_lane
from repro_torch.scenarios.policies import (IDMParams, agent_on_route,
                                            simulate, spaced_starts)

LANE_OFF = 1.75
ROAD_LEN = 140.0
WALK_HALF = 8.0        # crosswalk half-length


@registry.register("pedestrian_crossing")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    rng = registry.family_rng("pedestrian_crossing", seed, index)
    g = LaneGraph()
    e = g.add(straight_lane((-ROAD_LEN / 2, -LANE_OFF), 0.0, ROAD_LEN,
                            speed_limit=11.0))
    w = g.add(straight_lane((ROAD_LEN / 2, LANE_OFF), np.pi, ROAD_LEN,
                            speed_limit=11.0))
    north = g.add(straight_lane((0.0, -WALK_HALF), np.pi / 2, 2 * WALK_HALF,
                                kind="crosswalk", speed_limit=1.5))
    south = g.add(straight_lane((0.0, WALK_HALF), -np.pi / 2, 2 * WALK_HALF,
                                kind="crosswalk", speed_limit=1.5))

    cap = cfg.num_agents
    n_ped = int(rng.integers(1, max(2, min(4, cap))))
    n_veh = int(rng.integers(1, max(2, min(5, cap - n_ped + 1))))
    agents, types = [], []
    ped_idm = IDMParams(accel_max=1.0, brake=1.5, headway=0.8, min_gap=0.6)
    for _ in range(n_ped):
        lane = north if rng.uniform() < 0.5 else south
        xy, hd = g.route_points([lane])
        agents.append(agent_on_route(
            float(rng.uniform(0.0, WALK_HALF)), xy, hd,
            v0=float(rng.uniform(1.0, 1.8)), rng=rng,
            agent_type=AGENT_TYPE["pedestrian"], priority=3,
            lateral_noise=0.4, heading_noise=0.08, speed_frac=(0.6, 1.0),
            idm=ped_idm))
        types.append(AGENT_TYPE["pedestrian"])
    for li, count in ((e, (n_veh + 1) // 2), (w, n_veh // 2)):
        xy, hd = g.route_points([li])
        for s0 in spaced_starts(rng, count, 15.0, ROAD_LEN / 2 - 6.0,
                                min_gap=16.0):
            agents.append(agent_on_route(
                float(s0), xy, hd, v0=float(rng.uniform(7.0, 11.0)),
                rng=rng, priority=1))
            types.append(AGENT_TYPE["vehicle"])
    agents, types = agents[:cap], types[:cap]
    pose, feats, actions = simulate(cfg, rng, agents, cfg.num_steps)
    return assemble_scene("pedestrian_crossing", cfg, g, pose, feats,
                          actions, np.asarray(types, np.int32))
