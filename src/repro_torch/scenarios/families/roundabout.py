"""Roundabout: circulating ring with four entries/exits; entering yields.
(Numpy copy of ``repro/scenarios/families/roundabout.py``.)

                 exit   entry
                    \\   /
                  .--->---.
                 /         \\
        entry --<    ring   >-- exit
                 \\         /
                  `---<---'

The ring is four counterclockwise quadrant arcs; at each quadrant
boundary a route either continues or exits (random fork at trace time).
Entering agents (priority 1) yield to circulating agents (priority 2) at
the ring conflict point.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import Scene, ScenarioConfig, assemble_scene
from repro_torch.scenarios.lane_graph import LaneGraph, arc_lane, straight_lane
from repro_torch.scenarios.policies import agent_on_route, simulate

RING_R = 14.0
ENTRY_LEN = 40.0


@registry.register("roundabout")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    rng = registry.family_rng("roundabout", seed, index)
    g = LaneGraph()
    quad, entry, exits = [], [], []
    for k in range(4):
        th = k * np.pi / 2                       # boundary angle
        p = RING_R * np.array([np.cos(th), np.sin(th)])
        quad.append(g.add(arc_lane(p, th + np.pi / 2, RING_R, np.pi / 2,
                                   speed_limit=7.0)))
    for k in range(4):
        g.connect(quad[k], quad[(k + 1) % 4])
    for k in range(4):
        th = k * np.pi / 2
        p = RING_R * np.array([np.cos(th), np.sin(th)])
        tangent = th + np.pi / 2
        # entry: straight aimed at the ring boundary point, angled 30deg
        # off the ring tangent (a deliberate kink — vehicles slow and turn
        # onto the ring; pure pursuit absorbs it)
        a_dir = tangent - np.pi / 6
        start = p - ENTRY_LEN * np.array([np.cos(a_dir), np.sin(a_dir)])
        entry.append(g.add(straight_lane(start, a_dir, ENTRY_LEN,
                                         speed_limit=9.0)))
        g.connect(entry[k], quad[k])
        # exit: straight leaving the boundary point outward
        x_dir = tangent + np.pi / 6
        exits.append(g.add(straight_lane(p, x_dir, ENTRY_LEN,
                                         speed_limit=9.0)))
        g.connect(quad[(k - 1) % 4], exits[k])

    cap = cfg.num_agents
    n_ring = int(rng.integers(1, max(2, min(3, cap))))
    n_ent = int(rng.integers(1, max(2, min(4, cap - n_ring + 1))))
    agents = []
    ring_starts = rng.permutation(4)[:n_ring]
    for k in ring_starts:
        route = g.trace_route(quad[int(k)], 120.0, rng)
        xy, hd = g.route_points(route)
        agents.append(agent_on_route(
            float(rng.uniform(0.0, 0.5 * RING_R)), xy, hd,
            v0=float(rng.uniform(5.0, 7.0)), rng=rng, priority=2,
            lateral_noise=0.15))
    ent_starts = rng.permutation(4)[:n_ent]
    for k in ent_starts:
        route = g.trace_route(entry[int(k)], 120.0, rng)
        xy, hd = g.route_points(route)
        agents.append(agent_on_route(
            float(rng.uniform(2.0, ENTRY_LEN * 0.6)), xy, hd,
            v0=float(rng.uniform(6.0, 9.0)), rng=rng, priority=1,
            lateral_noise=0.15))
    agents = agents[:cap]
    pose, feats, actions = simulate(cfg, rng, agents, cfg.num_steps)
    types = np.zeros(len(agents), np.int32)
    return assemble_scene("roundabout", cfg, g, pose, feats, actions, types)
