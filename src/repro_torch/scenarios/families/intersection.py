"""Signalized four-way intersection: phased through traffic + left turns.
(Numpy copy of ``repro/scenarios/families/intersection.py``.)

                    |  ^  |
                    |  N  |
                    | [|] |
            --------+-----+--------
              E <--   box    <-- E
            --------+-----+--------
                    | [|] |
                    |  S  |
                    |  ^  |

Each approach runs to a stop line, crosses the box (straight, or a left-
turn arc chosen at the route fork), and exits. A two-phase signal
(NS green / EW green, random period offset) gates the stop lines through
the simulate() stop hook; left turners additionally carry lower priority
than oncoming through traffic, so they yield inside the box.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenarios import registry
from repro_torch.scenarios.core import Scene, ScenarioConfig, assemble_scene
from repro_torch.scenarios.lane_graph import LaneGraph, arc_lane, straight_lane
from repro_torch.scenarios.policies import agent_on_route, simulate

HALF_BOX = 10.0        # intersection half-extent (stop-line distance)
LANE_OFF = 1.75        # right-hand lane offset from the road centerline
APPROACH = 70.0        # approach/exit length

# the four compass directions: heading, unit dir
_DIRS = {
    "E": 0.0, "N": np.pi / 2, "W": np.pi, "S": -np.pi / 2,
}
_LEFT_OF = {"E": "N", "N": "W", "W": "S", "S": "E"}


def _unit(th):
    return np.array([np.cos(th), np.sin(th)], np.float32)


def _build_graph():
    """Per direction: approach -> {through box, left box} -> exits."""
    g = LaneGraph()
    ids = {}
    for name, th in _DIRS.items():
        d, n = _unit(th), _unit(th + np.pi / 2)
        off = -LANE_OFF * n                    # keep-right lane offset
        appr_start = off - (HALF_BOX + APPROACH) * d
        ids[name, "approach"] = g.add(straight_lane(
            appr_start, th, APPROACH, speed_limit=12.0))
        ids[name, "through"] = g.add(straight_lane(
            off - HALF_BOX * d, th, 2 * HALF_BOX, speed_limit=10.0))
        ids[name, "exit"] = g.add(straight_lane(
            off + HALF_BOX * d, th, APPROACH, speed_limit=12.0))
    for name, th in _DIRS.items():
        left = _LEFT_OF[name]
        d, n = _unit(th), _unit(th + np.pi / 2)
        start = -LANE_OFF * n - HALF_BOX * d
        # quarter arc from the stop line into the left direction's exit
        ids[name, "left"] = g.add(arc_lane(
            start, th, _left_turn_radius(name), np.pi / 2, speed_limit=6.0))
        g.connect(ids[name, "approach"], ids[name, "through"])
        g.connect(ids[name, "approach"], ids[name, "left"])
        g.connect(ids[name, "through"], ids[name, "exit"])
        g.connect(ids[name, "left"], ids[left, "exit"])
    return g, ids


def _left_turn_radius(name):
    """Radius that lands the quarter arc on the left exit's lane line."""
    th = _DIRS[name]
    d, n = _unit(th), _unit(th + np.pi / 2)
    start = -LANE_OFF * n - HALF_BOX * d
    left = _LEFT_OF[name]
    dl, nl = _unit(_DIRS[left]), _unit(_DIRS[left] + np.pi / 2)
    target = -LANE_OFF * nl + HALF_BOX * dl
    # arc turning +90deg from `start` heading th ends at
    # start + r*(d + n_perp_delta); solve |along-d displacement| = r
    return float(np.dot(target - start, d))


@registry.register("signalized_intersection")
def generate(seed: int, index: int, cfg: ScenarioConfig) -> Scene:
    rng = registry.family_rng("signalized_intersection", seed, index)
    g, ids = _build_graph()
    dirs = list(_DIRS)
    cap = cfg.num_agents
    n_agents = int(rng.integers(min(3, cap), cap + 1))

    agents, stop_lines, groups = [], [], []
    order = [dirs[int(rng.integers(4))] for _ in range(n_agents)]
    per_dir = {}
    for i, name in enumerate(order):
        route = [ids[name, "approach"]]
        turn_left = rng.uniform() < 0.3
        if turn_left:
            route += [ids[name, "left"], ids[_LEFT_OF[name], "exit"]]
        else:
            route += [ids[name, "through"], ids[name, "exit"]]
        xy, hd = g.route_points(route)
        k = per_dir.get(name, 0)
        per_dir[name] = k + 1
        s0 = float(APPROACH - 15.0 - 22.0 * k - rng.uniform(0.0, 6.0))
        if s0 < 2.0:
            continue                           # approach is full
        agents.append(agent_on_route(
            s0, xy, hd, v0=float(rng.uniform(7.0, 11.0)), rng=rng,
            priority=1 if turn_left else 2))
        stop_lines.append(APPROACH)            # approach lane ends there
        groups.append(0 if name in ("N", "S") else 1)

    period = max(4, cfg.num_steps // 2)
    offset = int(rng.integers(0, 2 * period))

    def stop_hook(i, t):
        green_group = ((t + offset) // period) % 2      # 0 = NS, 1 = EW
        if groups[i] == green_group:
            return None
        if agents[i].s > stop_lines[i] - 1.0:
            return None                        # already past the line
        return stop_lines[i]

    pose, feats, actions = simulate(cfg, rng, agents, cfg.num_steps,
                                    stop_hook=stop_hook)
    types = np.zeros(len(agents), np.int32)
    return assemble_scene("signalized_intersection", cfg, g, pose, feats,
                          actions, types)
