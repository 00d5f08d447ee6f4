"""Unprotected left turn: a turner crosses oncoming traffic, no signal.
(Numpy copy of ``repro/scenarios/families/left_turn.py``.)

                         | ^ |
                         | N |
                         |   |
         ----------------+   +----------------
           W <---------- o <-- oncoming <-- W
         ------------\\---+---------------------
           E --> car --`(left turn across W)

The eastbound left turner (priority 1) must find a gap in the oncoming
westbound stream (priority 2) — the canonical interaction the paper's
turning-minADE column stresses.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import Scene, ScenarioConfig, assemble_scene
from repro_torch.scenarios.lane_graph import LaneGraph, arc_lane, straight_lane
from repro_torch.scenarios.policies import (agent_on_route, simulate,
                                            spaced_starts)

LANE_OFF = 1.75
TURN_X = 0.0           # where the turn leaves the eastbound lane
APPROACH = 80.0


@registry.register("unprotected_left")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    rng = registry.family_rng("unprotected_left", seed, index)
    g = LaneGraph()
    # two-way EW road through the origin
    e1 = g.add(straight_lane((-APPROACH, -LANE_OFF), 0.0, APPROACH,
                             speed_limit=12.0))
    e2 = g.add(straight_lane((0.0, -LANE_OFF), 0.0, APPROACH,
                             speed_limit=12.0))
    w = g.add(straight_lane((APPROACH, LANE_OFF), np.pi, 2 * APPROACH,
                            speed_limit=12.0))
    g.connect(e1, e2)
    # left-turn arc: quarter turn from the end of e1 into a northbound exit
    radius = 8.0
    turn = g.add(arc_lane((0.0, -LANE_OFF), 0.0, radius, np.pi / 2,
                          speed_limit=5.0))
    north = g.add(straight_lane((radius, -LANE_OFF + radius), np.pi / 2,
                                60.0, speed_limit=12.0))
    g.connect(e1, turn)
    g.connect(turn, north)

    cap = cfg.num_agents
    # the protagonist: always one left turner, close to the junction
    turn_xy, turn_hd = g.route_points([e1, turn, north])
    agents = [agent_on_route(
        float(APPROACH - rng.uniform(18.0, 32.0)), turn_xy, turn_hd,
        v0=float(rng.uniform(5.0, 8.0)), rng=rng, priority=1)]
    # oncoming westbound stream
    n_onc = int(rng.integers(1, max(2, min(4, cap))))
    onc_xy, onc_hd = g.route_points([w])
    for s0 in spaced_starts(rng, n_onc, 40.0, 2 * APPROACH - 50.0,
                            min_gap=16.0):
        agents.append(agent_on_route(
            float(s0), onc_xy, onc_hd, v0=float(rng.uniform(8.0, 12.0)),
            rng=rng, priority=2))
    # optional eastbound through follower behind the turner
    if cap - len(agents) > 0 and rng.uniform() < 0.7:
        thr_xy, thr_hd = g.route_points([e1, e2])
        agents.append(agent_on_route(
            float(rng.uniform(15.0, 35.0)), thr_xy, thr_hd,
            v0=float(rng.uniform(8.0, 12.0)), rng=rng, priority=2))
    agents = agents[:cap]
    pose, feats, actions = simulate(cfg, rng, agents, cfg.num_steps)
    types = np.zeros(len(agents), np.int32)
    return assemble_scene("unprotected_left", cfg, g, pose, feats, actions,
                          types)
