"""Lane centerlines (numpy copy of the parts of
``repro/scenarios/lane_graph.py`` that the freeform family builds)."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

STEP = 2.0  # meters between consecutive centerline points


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


def polyline_lane(points, *, kind="lane", speed_limit=13.0) -> Lane:
    """Resample a polyline to STEP spacing."""
    pts = np.asarray(points, np.float64)
    seg_len = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(cum[-1])
    n = max(2, int(round(total / STEP)) + 1)
    s = np.linspace(0.0, total, n)
    out = np.stack([np.interp(s, cum, pts[:, 0]),
                    np.interp(s, cum, pts[:, 1])], -1)
    d = np.gradient(out, axis=0)
    headings = np.arctan2(d[:, 1], d[:, 0])
    return Lane(out.astype(np.float32), headings.astype(np.float32),
                kind=kind, speed_limit=speed_limit)


class LaneGraph:
    """Directed lane centerlines (topology comes with the families that
    use it)."""

    def __init__(self):
        self.lanes: List[Lane] = []

    def add(self, lane: Lane) -> int:
        self.lanes.append(lane)
        return len(self.lanes) - 1
