"""Lane-graph world model for procedural driving scenarios (numpy copy
of ``repro/scenarios/lane_graph.py``, held bit-identical to it).

A :class:`LaneGraph` is a set of directed lane centerlines (dense 2-D
polylines with per-point headings) plus topology: ``successors`` (which
lanes a lane flows into), and optional ``left``/``right`` neighbors for
lane changes. Everything is numpy and deterministic — graphs are built by
the scenario families from an ``np.random.Generator`` seeded by
``(family, seed, index)``, so a scene is reproducible from its cursor
alone (the same contract as the rest of the data pipeline).

Geometry conventions:

* centerline points are spaced ``STEP`` meters apart, so index distance
  is arclength distance — route following and gap computation are O(1)
  index arithmetic;
* lane headings are the tangent direction of travel (lanes are directed);
* queries (`nearest`, `distance`, `on_road`) are vectorized over
  arbitrary batches of points and are the basis of the off-road metric in
  ``repro_torch.runtime.evaluation``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.kinematics import wrap_angle

STEP = 2.0  # meters between consecutive centerline points

LANE_KIND = {"lane": 0, "crosswalk": 1}


@dataclasses.dataclass
class Lane:
    """One directed lane centerline: points (P, 2), headings (P,)."""
    points: np.ndarray
    headings: np.ndarray
    kind: str = "lane"
    speed_limit: float = 13.0

    def __post_init__(self):
        self.points = np.asarray(self.points, np.float32)
        self.headings = np.asarray(self.headings, np.float32)
        if self.points.ndim != 2 or self.points.shape[1] != 2 \
                or self.headings.shape != (self.points.shape[0],):
            raise ValueError(f"lane points {self.points.shape} / headings "
                             f"{self.headings.shape}")

    @property
    def length(self) -> float:
        return STEP * (len(self.points) - 1)

    def arclengths(self) -> np.ndarray:
        return STEP * np.arange(len(self.points), dtype=np.float32)


def straight_lane(start, heading, length, *, kind="lane",
                  speed_limit=13.0) -> Lane:
    """Straight centerline from ``start`` along ``heading`` for ``length``m."""
    n = max(2, int(round(length / STEP)) + 1)
    s = STEP * np.arange(n, dtype=np.float32)
    direction = np.array([np.cos(heading), np.sin(heading)], np.float32)
    pts = np.asarray(start, np.float32)[None, :] + s[:, None] * direction
    return Lane(pts, np.full(n, heading, np.float32), kind=kind,
                speed_limit=speed_limit)


def arc_lane(start, heading, radius, angle, *, kind="lane",
             speed_limit=13.0) -> Lane:
    """Arc centerline: turn through ``angle`` rad (signed; + is left) with
    turning radius ``radius``. Arclength = radius * |angle|."""
    length = abs(angle) * radius
    n = max(2, int(round(length / STEP)) + 1)
    s = np.linspace(0.0, length, n, dtype=np.float32)
    sgn = np.sign(angle) if angle != 0.0 else 1.0
    curv = sgn / radius
    th = heading + curv * s
    # closed-form arc integral of the unicycle at constant curvature
    x = start[0] + (np.sin(th) - np.sin(heading)) / curv
    y = start[1] - (np.cos(th) - np.cos(heading)) / curv
    return Lane(np.stack([x, y], -1).astype(np.float32),
                th.astype(np.float32), kind=kind, speed_limit=speed_limit)


def polyline_lane(points, *, kind="lane", speed_limit=13.0) -> Lane:
    """Resample an arbitrary polyline to STEP spacing (for e.g. the
    freeform family's legacy segment chains)."""
    pts = np.asarray(points, np.float64)
    seg = np.diff(pts, axis=0)
    seg_len = np.linalg.norm(seg, axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(cum[-1])
    n = max(2, int(round(total / STEP)) + 1)
    s = np.linspace(0.0, total, n)
    x = np.interp(s, cum, pts[:, 0])
    y = np.interp(s, cum, pts[:, 1])
    out = np.stack([x, y], -1)
    d = np.gradient(out, axis=0)
    headings = np.arctan2(d[:, 1], d[:, 0])
    return Lane(out.astype(np.float32), headings.astype(np.float32),
                kind=kind, speed_limit=speed_limit)


class LaneGraph:
    """Directed lane centerlines + successor/left/right topology."""

    def __init__(self):
        self.lanes: List[Lane] = []
        self.successors: List[List[int]] = []
        self.left: List[Optional[int]] = []
        self.right: List[Optional[int]] = []

    # -- construction --------------------------------------------------------
    def add(self, lane: Lane) -> int:
        self.lanes.append(lane)
        self.successors.append([])
        self.left.append(None)
        self.right.append(None)
        return len(self.lanes) - 1

    def connect(self, a: int, b: int):
        """Declare lane ``b`` a successor of lane ``a``."""
        if b not in self.successors[a]:
            self.successors[a].append(b)

    def set_neighbors(self, a: int, *, left: Optional[int] = None,
                      right: Optional[int] = None):
        if left is not None:
            self.left[a] = left
        if right is not None:
            self.right[a] = right

    # -- routes --------------------------------------------------------------
    def trace_route(self, start: int, min_length: float,
                    rng: np.random.Generator) -> List[int]:
        """Follow successors from ``start`` (uniform random at forks) until
        the route is at least ``min_length`` meters or a dead end."""
        route, total, cur = [start], self.lanes[start].length, start
        while total < min_length and self.successors[cur]:
            nxt = self.successors[cur][
                int(rng.integers(len(self.successors[cur])))]
            if nxt in route:       # refuse to loop forever (roundabouts)
                break
            route.append(nxt)
            total += self.lanes[nxt].length
            cur = nxt
        return route

    def route_points(self, route: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate a route's centerlines into one dense polyline.

        Returns (xy (N, 2), headings (N,)); joint points (the shared
        endpoint of consecutive lanes) are deduplicated so arclength stays
        ``STEP * index``.
        """
        xs, hs = [], []
        for i, li in enumerate(route):
            lane = self.lanes[li]
            pts, hd = lane.points, lane.headings
            if i > 0:
                pts, hd = pts[1:], hd[1:]
            xs.append(pts)
            hs.append(hd)
        return np.concatenate(xs, 0), np.concatenate(hs, 0)

    # -- queries -------------------------------------------------------------
    def all_points(self, kinds: Optional[Sequence[str]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(P, 2) stacked centerline points and (P,) owning lane index,
        optionally restricted to lane ``kinds`` (e.g. ``("lane",)`` to
        exclude crosswalks)."""
        sel = [(i, l) for i, l in enumerate(self.lanes)
               if kinds is None or l.kind in kinds]
        if not sel:
            sel = list(enumerate(self.lanes))     # degenerate graph: use all
        pts = np.concatenate([l.points for _, l in sel], 0)
        owner = np.concatenate([
            np.full(len(l.points), i, np.int32) for i, l in sel])
        return pts, owner

    def nearest(self, xy, kinds: Optional[Sequence[str]] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Nearest lane and distance for each query point.

        xy (..., 2) -> (lane_idx (...,) int32, dist (...,) float32).
        """
        pts, owner = self.all_points(kinds)
        q = np.asarray(xy, np.float32)
        flat = q.reshape(-1, 2)
        d = np.linalg.norm(flat[:, None, :] - pts[None, :, :], axis=-1)
        arg = d.argmin(axis=1)
        return (owner[arg].reshape(q.shape[:-1]),
                d[np.arange(len(flat)), arg].reshape(q.shape[:-1])
                .astype(np.float32))

    def distance(self, xy, kinds: Optional[Sequence[str]] = None
                 ) -> np.ndarray:
        """Distance (...,) from each point to the nearest centerline of
        the given ``kinds`` (default: any)."""
        return self.nearest(xy, kinds)[1]

    def on_road(self, xy, threshold: float = 3.5,
                kinds: Optional[Sequence[str]] = None) -> np.ndarray:
        """True where a point lies within ``threshold`` m of a centerline
        (half a lane width plus slack — the off-road metric's predicate)."""
        return self.distance(xy, kinds) <= threshold

    # -- model-facing map tokens --------------------------------------------
    def map_tokens(self, num_map: int, feat_dim: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tokenize the graph into at most ``num_map`` map tokens.

        The token budget is split across lanes proportionally to their
        point counts with **at least one token per lane** (largest-
        remainder rounding) — no lane an agent drives on is ever silently
        absent from the map — and each lane is sampled uniformly along its
        arclength (deterministic — no rng). Features: [0] sample spacing
        / 10, [1] local curvature * 50, [2] lane flag, [3] lane fraction,
        [4] crosswalk flag, [5] speed_limit / 10. Returns
        (pose (num_map, 3), feats (num_map, feat_dim), valid (num_map,)
        bool) — padded with zeros / False beyond the actual token count,
        i.e. *variable map size via masks*.
        """
        n_lanes = len(self.lanes)
        per_lane = []
        sizes = np.array([len(l.points) for l in self.lanes], np.float64)
        if num_map >= n_lanes > 0:
            alloc = np.ones(n_lanes, int)
            frac = sizes / sizes.sum() * (num_map - n_lanes)
            alloc += np.floor(frac).astype(int)
            order = np.argsort(-(frac - np.floor(frac)))
            alloc[order[:num_map - int(alloc.sum())]] += 1
        else:                       # budget below lane count: first lanes
            alloc = (np.arange(n_lanes) < num_map).astype(int)
        for li, lane in enumerate(self.lanes):
            n_tok = min(int(alloc[li]), len(lane.points))
            if n_tok == 0:
                continue
            idx = np.unique(np.linspace(0, len(lane.points) - 1,
                                        n_tok).astype(int))
            spacing = lane.length / max(n_tok - 1, 1)
            for pi in idx:
                curv = 0.0
                if 0 < pi < len(lane.points) - 1:
                    dth = wrap_angle(lane.headings[pi + 1]
                                     - lane.headings[pi - 1])
                    curv = float(dth) / (2.0 * STEP)
                per_lane.append((lane.points[pi, 0], lane.points[pi, 1],
                                 lane.headings[pi], spacing, curv,
                                 lane.kind, li / n_lanes, lane.speed_limit))
        m = min(len(per_lane), num_map)
        pose = np.zeros((num_map, 3), np.float32)
        feats = np.zeros((num_map, feat_dim), np.float32)
        valid = np.zeros(num_map, bool)
        for i in range(m):
            x, y, th, slen, curv, kind, frac, vlim = per_lane[i]
            pose[i] = (x, y, th)
            feats[i, 0] = slen / 10.0
            feats[i, 1] = curv * 50.0
            feats[i, 2] = 1.0 if kind == "lane" else 0.0
            feats[i, 3] = frac
            if feat_dim > 4:
                feats[i, 4] = 1.0 if kind == "crosswalk" else 0.0
            if feat_dim > 5:
                feats[i, 5] = vlim / 10.0
            valid[i] = True
        return pose, feats, valid

    # -- rigid transforms ----------------------------------------------------
    def transformed(self, z) -> "LaneGraph":
        """The graph re-posed by a global SE(2) transform z = (x, y, th)."""
        z = np.asarray(z, np.float32)
        c, s = np.cos(z[2]), np.sin(z[2])
        rot = np.array([[c, -s], [s, c]], np.float32)
        out = LaneGraph()
        for lane in self.lanes:
            out.add(Lane(lane.points @ rot.T + z[:2],
                         wrap_angle(lane.headings + z[2],
                                    xp=np).astype(np.float32),
                         kind=lane.kind, speed_limit=lane.speed_limit))
        out.successors = [list(s_) for s_ in self.successors]
        out.left = list(self.left)
        out.right = list(self.right)
        return out
