"""Closed-loop evaluation harness over the cached RolloutEngine (port of
``repro/runtime/evaluation.py``; the scoring is a numpy copy of it).

Batches *mixed-family* scenes (every family pads to the same static
shapes, so one engine serves all of them) through
:class:`repro_torch.runtime.RolloutEngine`, then scores each sampled
future on the host against the scene's ground truth and lane graph:

* **minADE** — best-of-K average displacement error over valid agents
  (masked; padding slots never enter the mean);
* **miss rate** — fraction of valid agents whose best-of-K *final*
  displacement exceeds ``miss_threshold_m``;
* **collision rate** — fraction of valid agents that come within
  ``collision_radius_m`` of another valid agent at any future step,
  averaged over samples;
* **off-road rate** — fraction of valid *vehicle* agent-steps farther
  than ``offroad_threshold_m`` from the nearest lane centerline
  (pedestrians are exempt — their crosswalk is their lane);
* **kinematic-infeasibility rate** — fraction of valid agent-steps whose
  implied speed / yaw rate between consecutive rollout poses exceeds the
  unicycle limits. The engine integrates with clamped actions, so this
  is a self-check that should sit at 0; any other rollout source (a
  learned policy emitting raw poses, a buggy integrator) gets caught.

All metrics are reported per family and aggregated; every metric is a
plain float so the benchmark layer can print CSV rows directly.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.kinematics import DT, MAX_SPEED, wrap_angle
from repro_torch.runtime.rollout import RolloutEngine
from repro_torch.scenarios import registry
from repro_torch.scenarios.core import AGENT_TYPE, Scene, ScenarioConfig

__all__ = ["EvalConfig", "scene_metrics", "evaluate_scenes",
           "evaluate_families"]


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    t_hist: int = 8                   # history steps fed to prefill
    n_samples: int = 4                # rollouts per scene
    seed: int = 0
    miss_threshold_m: float = 2.0
    collision_radius_m: float = 1.5
    offroad_threshold_m: float = 3.5
    kin_tolerance: float = 1.05       # fraction of the hard limits


METRICS = ("min_ade", "miss_rate", "collision_rate", "offroad_rate",
           "kinematic_infeasibility_rate")


def scene_metrics(scen_cfg: ScenarioConfig, eval_cfg: EvalConfig,
                  scene: Scene, futures: np.ndarray) -> Dict[str, float]:
    """Score one scene's sampled futures (K, T_fut, A, 3) against its
    ground truth and lane graph. Returns the METRICS dict plus
    ``n_agents`` (the valid-agent count the means ran over)."""
    t_hist = eval_cfg.t_hist
    tensors = scene.tensors
    gt = np.asarray(tensors["agent_pose"][t_hist:], np.float32)  # (Tf, A, 3)
    valid = np.asarray(tensors["agent_valid"][t_hist:], bool)    # (Tf, A)
    fut = np.asarray(futures, np.float32)                        # (K,Tf,A,3)
    k, t_fut, a, _ = fut.shape
    assert gt.shape[0] == t_fut, (gt.shape, fut.shape)
    alive = valid.any(axis=0)                                    # (A,)
    n_alive = int(alive.sum())
    if n_alive == 0 or t_fut == 0:
        return {m: float("nan") for m in METRICS} | {"n_agents": 0.0}

    w = valid.astype(np.float64)                                 # (Tf, A)
    steps = np.maximum(w.sum(axis=0), 1.0)                       # (A,)

    # minADE / miss rate (masked best-of-K)
    d = np.linalg.norm(fut[..., :2] - gt[None, ..., :2], axis=-1)  # (K,Tf,A)
    ade = (d * w[None]).sum(axis=1) / steps[None]                # (K, A)
    min_ade = float(ade.min(axis=0)[alive].mean())
    t_last = np.asarray(w.cumsum(axis=0).argmax(axis=0), int)    # (A,)
    fde = d[:, t_last, np.arange(a)]                             # (K, A)
    miss = float((fde.min(axis=0)[alive]
                  > eval_cfg.miss_threshold_m).mean())

    # collision rate: any valid pair within radius at any valid step
    pair_d = np.linalg.norm(fut[..., None, :2] - fut[..., None, :, :2],
                            axis=-1)                             # (K,Tf,A,A)
    pair_ok = valid[None, :, :, None] & valid[None, :, None, :]
    pair_ok &= ~np.eye(a, dtype=bool)[None, None]
    hit = (pair_d < eval_cfg.collision_radius_m) & pair_ok
    collided = hit.any(axis=(1, 3))                              # (K, A)
    collision = float(collided[:, alive].mean())

    # off-road rate: valid *vehicle* agent-steps off the lane graph
    veh = (np.asarray(tensors.get("agent_type",
                                  np.zeros(a, np.int32)))
           == AGENT_TYPE["vehicle"])
    veh_w = w * veh[None, :]                                     # (Tf, A)
    if scene.lane_graph is not None and veh_w.sum() > 0:
        # driving lanes only: standing on a crosswalk is still off-road
        # for a vehicle
        dist = scene.lane_graph.distance(fut[..., :2],
                                         kinds=("lane",))       # (K,Tf,A)
        off = (dist > eval_cfg.offroad_threshold_m) * veh_w[None]
        offroad = float(off.sum() / (k * veh_w.sum()))
    else:
        offroad = float("nan")

    # kinematic feasibility between consecutive rollout poses
    if t_fut > 1:
        dxy = np.linalg.norm(np.diff(fut[..., :2], axis=1), axis=-1)
        dth = np.abs(wrap_angle(np.diff(fut[..., 2], axis=1), xp=np))
        ok_steps = (valid[:-1] & valid[1:]).astype(np.float64)   # (Tf-1, A)
        bad = ((dxy > MAX_SPEED * DT * eval_cfg.kin_tolerance)
               | (dth > scen_cfg.max_yaw_rate * DT
                  * eval_cfg.kin_tolerance + 1e-4)) * ok_steps[None]
        denom = k * max(ok_steps.sum(), 1.0)
        kin = float(bad.sum() / denom)
    else:
        kin = 0.0

    return {"min_ade": min_ade, "miss_rate": miss,
            "collision_rate": collision, "offroad_rate": offroad,
            "kinematic_infeasibility_rate": kin,
            "n_agents": float(n_alive)}


def evaluate_scenes(engine, scenes: Sequence[Scene],
                    eval_cfg: EvalConfig) -> Dict[str, Dict[str, float]]:
    """Closed-loop rollouts + metrics for a mixed-family scene list.

    ONE ``engine.run`` covers every scene regardless of family — all
    families share the config's static shapes (validity masks carry the
    per-scene variation), so slots mix freely. Returns ``{family:
    {metric: mean, n_scenes, n_agents}}`` plus an ``"overall"`` row; every
    aggregate row weights each scene by its valid-agent count (see
    :func:`_aggregate`).
    """
    futures = engine.run([s.tensors for s in scenes],
                         t_hist=eval_cfg.t_hist,
                         n_samples=eval_cfg.n_samples,
                         seed=eval_cfg.seed)       # (S, K, Tf, A, 3)
    per_family: Dict[str, List[Dict[str, float]]] = defaultdict(list)
    for si, scene in enumerate(scenes):
        per_family[scene.family].append(
            scene_metrics(engine.scen, eval_cfg, scene, futures[si]))
    out: Dict[str, Dict[str, float]] = {}
    all_rows: List[Dict[str, float]] = []
    for family, rows in sorted(per_family.items()):
        out[family] = _aggregate(rows)
        all_rows.extend(rows)
    out["overall"] = _aggregate(all_rows)
    return out


def _aggregate(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Agent-weighted mean of per-scene metric rows.

    Every metric in ``scene_metrics`` is a mean over a scene's VALID
    agents (or their agent-steps — each valid agent contributes the same
    fixed rollout horizon), so the family/overall aggregate weights each
    row by its ``n_agents``: the result equals the mean over all valid
    agents pooled across scenes. An unweighted mean of rows would let a
    1-agent scene move the table as much as a 30-agent scene, which at
    10k-scene fleet budgets materially skews the reported rows toward
    whichever families generate sparse scenes.
    """
    agg = {}
    for m in METRICS:
        pairs = [(r[m], r["n_agents"]) for r in rows
                 if np.isfinite(r[m]) and r["n_agents"] > 0]
        if pairs:
            v = np.asarray([p[0] for p in pairs], np.float64)
            w = np.asarray([p[1] for p in pairs], np.float64)
            agg[m] = float((v * w).sum() / w.sum())
        else:
            agg[m] = float("nan")
    agg["n_scenes"] = float(len(rows))
    agg["n_agents"] = float(np.sum([r["n_agents"] for r in rows]))
    return agg


def evaluate_families(model, scen_cfg: ScenarioConfig,
                      eval_cfg: EvalConfig, *,
                      families: Optional[Sequence[str]] = None,
                      n_scenes_per_family: int = 4, scene_seed: int = 777,
                      num_slots: Optional[int] = None, device=None,
                      mesh=None) -> Dict[str, Dict[str, float]]:
    """Generate ``n_scenes_per_family`` scenes for every family and run
    the closed-loop evaluation in one mixed batch.

    ``device`` goes to the :class:`RolloutEngine`: ``None`` is the card
    (it raises without one), ``"cpu"`` runs the plain versions, and it
    must be the device the model lives on. ``mesh``: a scene-axis mesh
    (``launch.mesh.make_fleet_mesh``); the engine then splits its lanes
    over the mesh's ranks, and every rank scores the gathered rollouts,
    so the tables equal the single-process engine's.
    """
    fams = list(families) if families is not None else registry.names()
    scenes = [registry.generate_scene(f, scene_seed, i, scen_cfg)
              for f in fams for i in range(n_scenes_per_family)]
    slots = num_slots or min(32, len(scenes) * eval_cfg.n_samples)
    engine = RolloutEngine(model, scen_cfg, num_slots=slots, device=device,
                           mesh=mesh)
    return evaluate_scenes(engine, scenes, eval_cfg)
