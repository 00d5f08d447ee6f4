"""The paper's headline experiment: invariant vs. absolute, trained.

Trains one agent-sim model per attention mechanism — the Table-I rows
``rope2d`` / ``se2_repr`` / ``se2_fourier`` plus the non-invariant
``absolute`` baseline — under IDENTICAL budgets (same expert stream, same
optimizer schedule, same step/batch counts, same init seed), then scores
every run both ways:

* **open-loop**: held-out next-action NLL + argmax accuracy (teacher
  forcing, the paper's Table-I metric);
* **closed-loop**: sampled rollouts through the cached
  :class:`repro_torch.runtime.RolloutEngine` scored by the evaluation harness —
  minADE / miss / collision / off-road per scenario family.

Each run goes through the full fault-tolerant :class:`Trainer` (NaN guard,
checkpointing, restartable data cursor), so the comparison exercises the
production path end to end, not a side-channel loop.

Port of ``repro/training/comparison.py``: ``device`` (default the card)
goes to every model and to the evaluation; ``mesh`` / ``dp_compress``
train through the compressed-DP step over a ("pod", "data") mesh, every
rank of it calling :func:`run_comparison` alike, and ``eval_mesh`` splits
the closed-loop scoring's lanes over a fleet mesh. Each run's first step
lands as ``cost.*{path="train.step", encoding=...}`` gauges
(``obs.CostAccounted``).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import SimArch
from repro_torch.data.pipeline import ShardedIterator
from repro_torch.launch.mesh import rank0_tempdir
from repro_torch.nn.agent_sim import AgentSimModel
from repro_torch.runtime.evaluation import EvalConfig, evaluate_families
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.training.data import holdout_batches, make_batch_fn
from repro_torch.training.steps import (bc_optimizer, loss_summary,
                                        make_sim_dp_train_step,
                                        make_sim_train_step,
                                        open_loop_metrics, sim_dp_state)

log = logging.getLogger("repro_torch.training.comparison")

__all__ = ["COMPARISON_ENCODINGS", "CLOSED_LOOP_METRICS", "train_one",
           "run_comparison", "format_table"]

# Table-I rows: three relative mechanisms vs. the absolute baseline.
COMPARISON_ENCODINGS = ("absolute", "rope2d", "se2_repr", "se2_fourier")

CLOSED_LOOP_METRICS = ("min_ade", "miss_rate", "collision_rate",
                       "offroad_rate")


def train_one(arch: SimArch, *, steps: int, batch: int, lr: float = 3e-3,
              seed: int = 0, ckpt_dir: Optional[str] = None,
              eval_every: int = 0, eval_cb=None, device=None, mesh=None,
              dp_compress: bool = True
              ) -> Tuple[AgentSimModel, Dict[str, float]]:
    """Train one encoding through the fault-tolerant Trainer.

    Returns (the trained model, summary dict). The summary carries the
    loss trajectory endpoints so callers can assert training actually
    moved. A fresh ``ckpt_dir`` per call keeps encodings from restoring
    each other's checkpoints; pass an existing one to resume. The weights
    are drawn from ``seed`` (the port's generator, not ``jax.random``).

    ``mesh``: a ("pod", "data") mesh; the run then goes through
    :func:`make_sim_dp_train_step` (each rank on its rows of every global
    batch, ``dp_compress`` selecting the int8 + error-feedback cross-pod
    reduction), on every rank of the mesh.
    """
    model = AgentSimModel(arch.agent_sim_config(), device=device,
                          generator=torch.Generator().manual_seed(seed))
    opt = bc_optimizer(lr, steps)
    params = dict(model.named_parameters())
    if mesh is None:
        step_fn = make_sim_train_step(model, opt)
        opt_state = opt.init(params)
    else:
        step_fn = make_sim_dp_train_step(model, opt, mesh,
                                         compress=dp_compress)
        opt_state = sim_dp_state(opt, params)
    # the first step's FLOPs and bytes land as cost.* gauges labeled per
    # encoding
    step_fn = obs.CostAccounted(step_fn, "train.step",
                                labels={"encoding": arch.encoding})
    data = ShardedIterator(make_batch_fn(arch.scenario_config()),
                           batch_size=batch, seed=seed)
    if ckpt_dir is None:
        ckpt_dir = rank0_tempdir(f"simcmp_{arch.encoding}_")
    t0 = time.time()
    trainer = Trainer(
        step_fn, model, opt_state, data, ckpt_dir,
        TrainerConfig(total_steps=steps, ckpt_every=max(steps, 1),
                      log_every=max(1, steps // 5),
                      eval_every=eval_every),
        metrics_cb=lambda s, m: log.info(
            "[%s] step %d loss %.4f acc %.3f", arch.encoding, s,
            m["loss"], m.get("accuracy", float("nan"))),
        eval_cb=eval_cb)
    try:
        trainer.restore_if_available()
        out = trainer.run()
    finally:
        data.close()
    summary = {
        "status": out["status"],
        "steps": float(trainer.step),
        "train_s": time.time() - t0,
        **loss_summary(trainer.history),
    }
    return model, summary


def run_comparison(arch: SimArch,
                   encodings: Sequence[str] = COMPARISON_ENCODINGS, *,
                   steps: int = 300, batch: int = 8, lr: float = 3e-3,
                   seed: int = 0, holdout_n: int = 4,
                   n_scenes_per_family: int = 2, eval_samples: int = 4,
                   ckpt_root: Optional[str] = None, report=None,
                   mesh=None, dp_compress: bool = True, eval_mesh=None,
                   eval_num_slots: Optional[int] = None, device=None
                   ) -> Dict[str, Dict[str, float]]:
    """Train every encoding under one budget; score open- and closed-loop.

    ``arch`` fixes everything except the encoding (size, scenario shapes,
    budget), so differences between rows are attributable to the attention
    mechanism alone. Returns ``{encoding: row}`` plus a ``"summary"`` entry
    with the paper's qualitative claim (best relative NLL <= absolute NLL)
    evaluated on this run. ``eval_num_slots`` sets the evaluation's
    rollout lanes.

    ``mesh``/``dp_compress`` route training through the compressed-DP
    step (see :func:`train_one`); ``eval_mesh`` runs the closed-loop
    scoring through the scene-sharded fleet engine. Every rank of the
    meshes calls this alike and gets the same rows.
    """
    report = report or (lambda name, value, extra="": None)
    scen = arch.scenario_config()
    eval_cfg = EvalConfig(t_hist=max(1, scen.num_steps // 2),
                          n_samples=eval_samples, seed=seed + 1)
    holdout = holdout_batches(scen, batch, holdout_n, seed=seed)
    rows: Dict[str, Dict[str, float]] = {}
    for enc in encodings:
        arch_e = dataclasses.replace(
            arch, name=f"{arch.name}-cmp-{enc}", encoding=enc)
        ckpt = (os.path.join(ckpt_root, enc) if ckpt_root else None)
        model, summary = train_one(arch_e, steps=steps, batch=batch, lr=lr,
                                   seed=seed, ckpt_dir=ckpt, device=device,
                                   mesh=mesh, dp_compress=dp_compress)
        open_m = open_loop_metrics(model, holdout)
        closed = evaluate_families(
            model, scen, eval_cfg,
            n_scenes_per_family=n_scenes_per_family,
            scene_seed=seed + 777, num_slots=eval_num_slots, device=device,
            mesh=eval_mesh)
        row = dict(summary)
        row["open_loop_nll"] = open_m["nll"]
        row["open_loop_accuracy"] = open_m["accuracy"]
        for m in CLOSED_LOOP_METRICS:
            row[f"closed_loop_{m}"] = closed["overall"][m]
        # full per-family closed-loop tables ride along (agent-weighted)
        row["families"] = {f: dict(v) for f, v in closed.items()}
        rows[enc] = row
        report(f"comparison/{enc}/open_loop_nll", f"{row['open_loop_nll']:.4f}",
               f"train_s={row['train_s']:.1f}")
        for m in CLOSED_LOOP_METRICS:
            report(f"comparison/{enc}/{m}", f"{row[f'closed_loop_{m}']:.4f}")
        del model       # the next encoding's model takes its card memory
    relative = [e for e in encodings if e != "absolute"]
    if relative and "absolute" in rows:
        best_rel = min(rows[e]["open_loop_nll"] for e in relative)
        abs_nll = rows["absolute"]["open_loop_nll"]
        # strict comparison; the signed margin is reported alongside so
        # noisy short-budget runs are judged by the consumer, not by a
        # slack silently baked into the boolean
        beats = bool(best_rel <= abs_nll)
        rows["summary"] = {"relative_beats_absolute": float(beats),
                           "nll_margin": abs_nll - best_rel,
                           "best_relative_nll": best_rel,
                           "absolute_nll": abs_nll}
        report("comparison/relative_beats_absolute", float(beats),
               f"margin={abs_nll - best_rel:.4f}")
    return rows


def format_table(rows: Dict[str, Dict[str, float]]) -> str:
    """Markdown table of the comparison results (the paper's Table I shape:
    one row per encoding, open-loop NLL plus closed-loop metrics)."""
    cols = ["open_loop_nll", "open_loop_accuracy"] + \
        [f"closed_loop_{m}" for m in CLOSED_LOOP_METRICS]
    head = ("| encoding | NLL | acc | minADE | miss | collision | offroad |",
            "|---|---:|---:|---:|---:|---:|---:|")
    lines = list(head)
    for enc, row in rows.items():
        if enc == "summary":
            continue
        vals = " | ".join(f"{row[c]:.4f}" if np.isfinite(row[c]) else "nan"
                          for c in cols)
        lines.append(f"| {enc} | {vals} |")
    if "summary" in rows:
        s = rows["summary"]
        lines.append("")
        lines.append(f"relative_beats_absolute: "
                     f"{bool(s['relative_beats_absolute'])} "
                     f"(best relative NLL {s['best_relative_nll']:.4f} vs "
                     f"absolute {s['absolute_nll']:.4f})")
    return "\n".join(lines)
