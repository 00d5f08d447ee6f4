"""Rule-based reference policies that drive agents along lane-graph routes
(numpy copy of ``repro/scenarios/policies.py``; its rng draw order is what
keeps the scenes bit-identical to the reference's).

Every family shares one simulation loop (:func:`simulate`): each agent
follows a dense route polyline with a pure-pursuit steering law, keeps
gaps with an IDM-style longitudinal law, and yields at route conflict
points (crossings/merges) to higher-priority traffic; families inject
extra stop constraints (traffic signals, stop lines) through a hook.

Actions are snapped to the scenario's discrete (accel x yaw-rate) grid
and the state integrates with the *quantized* action through the shared
unicycle (`repro_torch.core.kinematics`), so the recorded action labels are
exact — the same convention the freeform generator always used.

Everything is numpy on host; all randomness flows through the single
``np.random.Generator`` a family derives from ``(family, seed, index)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.kinematics import DT, step_kinematics
from repro_torch.scenarios.core import (ScenarioConfig, decode_action,
                                  encode_action)
from repro_torch.scenarios.lane_graph import STEP

CAR_LENGTH = 4.5        # m, bumper-to-bumper allowance in gap keeping
LATERAL_TOL = 2.0       # m, how far off my route a lead can sit
CONFLICT_RADIUS = 2.5   # m, route points closer than this conflict
STOP_MARGIN = 3.0       # m, stop this far before a conflict / stop line
YIELD_HORIZON = 8.0     # s, care about conflicts this far out


@dataclasses.dataclass
class IDMParams:
    accel_max: float = 2.0      # comfortable acceleration a
    brake: float = 3.0          # comfortable deceleration b
    headway: float = 1.5        # desired time gap T
    min_gap: float = 2.0        # jam distance s0


def idm_accel(v, v0, gap, dv, p: IDMParams) -> float:
    """IDM longitudinal acceleration (Treiber, Hennecke and Helbing, 2000).

    v own speed, v0 desired speed, gap bumper gap to lead (inf if free
    road), dv = v - v_lead (closing speed).
    """
    v0 = max(v0, 0.1)
    free = 1.0 - (v / v0) ** 4
    if not np.isfinite(gap):
        return p.accel_max * free
    s_star = p.min_gap + max(
        0.0, v * p.headway + v * dv / (2.0 * np.sqrt(p.accel_max * p.brake)))
    return p.accel_max * (free - (s_star / max(gap, 0.1)) ** 2)


def pursuit_yaw_rate(pose, target_xy, speed, dt: float = DT,
                     gain: float = 0.6) -> float:
    """Proportional pure pursuit: steer the heading toward the lookahead
    point on the route. Speed-independent (unicycle turns in place fine)."""
    bearing = np.arctan2(target_xy[1] - pose[1], target_xy[0] - pose[0])
    err = np.arctan2(np.sin(bearing - pose[2]), np.cos(bearing - pose[2]))
    return gain * err / dt


@dataclasses.dataclass
class RouteAgent:
    """One simulated agent bound to a dense route polyline."""
    route_xy: np.ndarray          # (N, 2) centerline of the full route
    route_heading: np.ndarray     # (N,)
    s: float                      # arclength progress along the route
    pose: np.ndarray              # (3,) current (x, y, theta)
    speed: float
    v0: float                     # desired cruise speed
    agent_type: int = 0           # AGENT_TYPE: 0 vehicle, 1 pedestrian
    priority: int = 1             # yields to strictly higher priority
    idm: IDMParams = dataclasses.field(default_factory=IDMParams)

    @property
    def route_len(self) -> float:
        return STEP * (len(self.route_xy) - 1)

    def point_at(self, s: float) -> np.ndarray:
        i = min(int(round(s / STEP)), len(self.route_xy) - 1)
        return self.route_xy[max(i, 0)]


def agent_on_route(start_s: float, route_xy, route_heading, v0: float,
                   rng: np.random.Generator, *, agent_type: int = 0,
                   priority: int = 1, lateral_noise: float = 0.3,
                   heading_noise: float = 0.03,
                   speed_frac: Tuple[float, float] = (0.5, 1.0),
                   idm: Optional[IDMParams] = None) -> RouteAgent:
    """Spawn an agent at arclength ``start_s`` of a route with small pose
    noise and a random fraction of its desired speed."""
    i = min(int(round(start_s / STEP)), len(route_xy) - 1)
    th = float(route_heading[i])
    normal = np.array([-np.sin(th), np.cos(th)])
    xy = route_xy[i] + normal * rng.normal(0.0, lateral_noise)
    pose = np.array([xy[0], xy[1], th + rng.normal(0.0, heading_noise)],
                    np.float32)
    speed = float(v0 * rng.uniform(*speed_frac))
    return RouteAgent(route_xy=np.asarray(route_xy, np.float32),
                      route_heading=np.asarray(route_heading, np.float32),
                      s=STEP * i, pose=pose, speed=speed, v0=v0,
                      agent_type=agent_type, priority=priority,
                      idm=idm or IDMParams())


def spaced_starts(rng: np.random.Generator, n: int, lo: float, hi: float,
                  min_gap: float = 10.0) -> np.ndarray:
    """Sorted start arclengths in [lo, hi] with pairwise gaps >= min_gap
    (slot-and-jitter, so it never rejects): slot i is [lo + i*w, lo+(i+1)*w)
    and the jitter stays min_gap short of the slot end. When the range
    cannot fit n starts at min_gap spacing, FEWER than n are returned —
    the gap guarantee wins over the count (families absorb the shortfall
    through their validity masks)."""
    n = min(n, max(1, int((hi - lo) / min_gap)))
    if n <= 0:
        return np.zeros(0, np.float32)
    w = (hi - lo) / n
    jitter = rng.uniform(0.0, max(w - min_gap, 1e-3), size=n)
    return (lo + w * np.arange(n) + jitter).astype(np.float32)


def route_conflicts(agents: List[RouteAgent],
                    radius: float = CONFLICT_RADIUS
                    ) -> List[Tuple[int, int, float, float]]:
    """Pairwise route crossing/merge points.

    Returns (i, j, s_i, s_j): the first arclength along i's route where it
    comes within ``radius`` of j's route, and the matching arclength on
    j's. Pairs whose routes run parallel from the start (followers on the
    same lane) are excluded — gap keeping handles those.
    """
    out = []
    for i in range(len(agents)):
        for j in range(len(agents)):
            if i == j:
                continue
            a, b = agents[i].route_xy, agents[j].route_xy
            d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
            close = d < radius
            if not close.any():
                continue
            ii = int(np.argmax(close.any(axis=1)))
            jj = int(np.argmin(d[ii]))
            # same-direction overlap from the very start = same lane
            if ii == 0 and jj == 0:
                continue
            out.append((i, j, STEP * ii, STEP * jj))
    return out


def _lead_gap(agents: List[RouteAgent], i: int) -> Tuple[float, float]:
    """Bumper gap and closing speed to the nearest agent ahead on (or
    laterally within LATERAL_TOL of) agent i's route."""
    me = agents[i]
    gap, dv = np.inf, 0.0
    for j, other in enumerate(agents):
        if j == i:
            continue
        d = np.linalg.norm(me.route_xy - other.pose[:2], axis=-1)
        k = int(np.argmin(d))
        if d[k] > LATERAL_TOL:
            continue
        s_other = STEP * k
        if s_other <= me.s + 0.1:
            continue
        g = s_other - me.s - CAR_LENGTH
        if g < gap:
            gap, dv = g, me.speed - other.speed
    return gap, dv


def _yield_stop(agents: List[RouteAgent], i: int,
                conflicts: List[Tuple[int, int, float, float]]
                ) -> Optional[float]:
    """Arclength to stop before, if agent i must yield at a conflict."""
    me = agents[i]
    stop = None
    for (a, b, s_a, s_b) in conflicts:
        if a != i:
            continue
        other = agents[b]
        if other.priority <= me.priority:
            continue                      # only yield upward in priority
        if me.s > s_a - STOP_MARGIN * 0.5:
            continue                      # already committed to the zone
        if other.s > s_b + CAR_LENGTH:
            continue                      # they already cleared it
        tta = (s_b - other.s) / max(other.speed, 0.5)
        if tta > YIELD_HORIZON and (s_b - other.s) > 30.0:
            continue                      # far away, slow: do not wait
        s_stop = s_a - STOP_MARGIN
        stop = s_stop if stop is None else min(stop, s_stop)
    return stop


StopHook = Callable[[int, int], Optional[float]]


def simulate(cfg: ScenarioConfig, rng: np.random.Generator,
             agents: List[RouteAgent], num_steps: int,
             stop_hook: Optional[StopHook] = None,
             accel_noise: float = 0.25, yaw_noise: float = 0.015):
    """Roll the shared rule-based policy forward ``num_steps`` steps.

    ``stop_hook(agent_idx, t)`` may return an arclength the agent must
    stop before at step t (signals, stop lines), or None.

    Returns (agent_pose (T, A, 3), agent_feats (T, A, Fa),
    actions (T, A) int32) for the A real agents — the caller pads to the
    config's agent cap. Feature convention (the only contract the rollout
    engine relies on is channel 0):
      [0] speed / 10 (dynamic; everything else static per agent)
      [1] vehicle flag   [2] pedestrian flag
      [3] desired speed / 10   [4] priority / 2
    """
    a, t_n = len(agents), num_steps
    conflicts = route_conflicts(agents)
    agent_pose = np.zeros((t_n, a, 3), np.float32)
    agent_feats = np.zeros((t_n, a, cfg.agent_feat_dim), np.float32)
    actions = np.zeros((t_n, a), np.int64)
    for i, ag in enumerate(agents):
        agent_feats[:, i, 1] = 1.0 if ag.agent_type == 0 else 0.0
        agent_feats[:, i, 2] = 1.0 if ag.agent_type == 1 else 0.0
        agent_feats[:, i, 3] = ag.v0 / 10.0
        agent_feats[:, i, 4] = ag.priority / 2.0

    for t in range(t_n):
        # snapshot, then decide all, then move all (simultaneous update)
        accel_cmd = np.zeros(a, np.float32)
        yaw_cmd = np.zeros(a, np.float32)
        for i, ag in enumerate(agents):
            agent_pose[t, i] = ag.pose
            agent_feats[t, i, 0] = ag.speed / 10.0
            gap, dv = _lead_gap(agents, i)
            stops = [s for s in (
                _yield_stop(agents, i, conflicts),
                stop_hook(i, t) if stop_hook is not None else None)
                if s is not None]
            for s_stop in stops:
                g = s_stop - ag.s
                if g < gap:
                    gap, dv = max(g, 0.0), ag.speed
            v0 = ag.v0
            if ag.s >= ag.route_len - STEP:       # route exhausted: stop
                v0, gap, dv = 0.1, min(gap, 1.0), ag.speed
            accel = idm_accel(ag.speed, v0, gap, dv, ag.idm)
            look = max(4.0, 1.2 * ag.speed)
            target = ag.point_at(ag.s + look)
            yaw = pursuit_yaw_rate(ag.pose, target, ag.speed)
            accel_cmd[i] = accel + rng.normal(0.0, accel_noise)
            yaw_cmd[i] = yaw + rng.normal(0.0, yaw_noise)
        accel_cmd = np.clip(accel_cmd, -cfg.max_accel, cfg.max_accel)
        yaw_cmd = np.clip(yaw_cmd, -cfg.max_yaw_rate, cfg.max_yaw_rate)
        act_id = encode_action(cfg, accel_cmd, yaw_cmd)
        actions[t] = act_id
        qa, qy = decode_action(cfg, act_id)
        for i, ag in enumerate(agents):
            new_pose, new_speed = step_kinematics(ag.pose, ag.speed,
                                                  float(qa[i]), float(qy[i]))
            ag.pose = np.asarray(new_pose, np.float32)
            # dead-reckoned route progress; pure pursuit absorbs drift
            ag.s = min(ag.s + 0.5 * (ag.speed + new_speed) * DT,
                       ag.route_len)
            ag.speed = float(new_speed)
    return agent_pose, agent_feats, actions.astype(np.int32)
