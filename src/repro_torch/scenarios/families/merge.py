"""On-ramp merge: ramp traffic yields into a mainline gap.
(Numpy copy of ``repro/scenarios/families/merge.py``.)

    ===========================o==================>  mainline
                              /
                         ____/   on-ramp (arc)
                        /
                       car

The ramp route shares the downstream mainline lane, so the conflict
detector sees a merge point; ramp agents (priority 1) gap-accept against
mainline agents (priority 2) via the standard yield rule.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import Scene, ScenarioConfig, assemble_scene
from repro_torch.scenarios.lane_graph import LaneGraph, arc_lane, straight_lane
from repro_torch.scenarios.policies import (agent_on_route, simulate,
                                            spaced_starts)

RAMP_ANGLE = 0.45      # rad between ramp approach and mainline
RAMP_RADIUS = 60.0


@registry.register("onramp_merge")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    rng = registry.family_rng("onramp_merge", seed, index)
    g = LaneGraph()
    # mainline split at the merge point (origin): upstream -> downstream
    up = g.add(straight_lane((-90.0, 0.0), 0.0, 90.0, speed_limit=14.0))
    down = g.add(straight_lane((0.0, 0.0), 0.0, 90.0, speed_limit=14.0))
    g.connect(up, down)
    # ramp: straight approach at RAMP_ANGLE, then an arc that straightens
    # out exactly at the merge point (built at the origin, then shifted)
    arc = arc_lane((0.0, 0.0), RAMP_ANGLE, RAMP_RADIUS, -RAMP_ANGLE)
    shift = -arc.points[-1]
    arc.points = arc.points + shift
    approach_len = 44.0   # multiple of STEP so the joint to the arc is exact
    d = np.array([np.cos(RAMP_ANGLE), np.sin(RAMP_ANGLE)], np.float32)
    approach = straight_lane(arc.points[0] - approach_len * d, RAMP_ANGLE,
                             approach_len, speed_limit=9.0)
    ramp_a = g.add(approach)
    ramp_b = g.add(arc)
    g.connect(ramp_a, ramp_b)
    g.connect(ramp_b, down)

    cap = cfg.num_agents
    n_main = int(rng.integers(1, max(2, min(4, cap))))
    n_ramp = int(rng.integers(1, max(2, min(3, cap - n_main + 1))))
    main_xy, main_hd = g.route_points([up, down])
    ramp_xy, ramp_hd = g.route_points([ramp_a, ramp_b, down])
    agents = []
    for s0 in spaced_starts(rng, n_main, 10.0, 80.0, min_gap=20.0):
        agents.append(agent_on_route(
            float(s0), main_xy, main_hd, v0=float(rng.uniform(10.0, 14.0)),
            rng=rng, priority=2))
    for s0 in spaced_starts(rng, n_ramp, 5.0, approach_len - 5.0,
                            min_gap=15.0):
        agents.append(agent_on_route(
            float(s0), ramp_xy, ramp_hd, v0=float(rng.uniform(6.0, 10.0)),
            rng=rng, priority=1))
    agents = agents[:cap]
    pose, feats, actions = simulate(cfg, rng, agents, cfg.num_steps)
    types = np.zeros(len(agents), np.int32)
    return assemble_scene("onramp_merge", cfg, g, pose, feats, actions, types)
