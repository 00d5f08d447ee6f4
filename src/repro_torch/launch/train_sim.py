"""Agent-sim BC training launcher: ``python -m repro_torch.launch.train_sim``
(port of ``repro/launch/train_sim.py``).

Wires the expert-demonstration pipeline (``repro_torch.training.data``) ->
the BC train step (``repro_torch.training.steps``) -> the fault-tolerant
:class:`Trainer`, with periodic closed-loop evaluation through
``repro_torch.runtime.evaluation`` riding the trainer's eval hook. Runs on
the card unless ``--device cpu`` is given; without a card it raises.

Modes:

  # single-encoding training with periodic closed-loop eval
  python -m repro_torch.launch.train_sim --arch sim-se2-fourier \
      --steps 200 --eval-every 100

  # the paper's invariant-vs-absolute comparison table (identical budgets)
  python -m repro_torch.launch.train_sim --compare --steps 200

``--smoke`` shrinks everything to CI size and asserts the run is healthy:
loss decreased from init and the final checkpoint round-trips bit-exactly
(``--smoke --device cpu`` runs on the CPU).

Across ranks: start one process a rank with torchrun's variables set
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``torchrun
--nproc-per-node N -m repro_torch.launch.train_sim`` sets them), or call
:func:`train_single` in a process whose group is up. Each rank draws its
share of every global
batch (``--batch`` rows a rank) and the step is the single-process step
on the global batch (``make_sim_train_step(..., group=)``); rank 0 writes
the checkpoints. ``--production-mesh`` asks for the production mesh,
which needs 256 ranks and raises on a smaller world.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import tempfile
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import SIM_ARCHS, get_sim_arch
from repro_torch.data.pipeline import ShardedIterator
from repro_torch.launch.mesh import (init_fleet, make_production_mesh,
                                     rank0_tempdir)
from repro_torch.nn.agent_sim import AgentSimModel
from repro_torch.params import to_reference
from repro_torch.runtime.evaluation import EvalConfig, evaluate_scenes
from repro_torch.runtime.rollout import RolloutEngine
from repro_torch.runtime.trainer import Trainer, TrainerConfig, TrainStep
from repro_torch.scenarios import registry
from repro_torch.training.comparison import (COMPARISON_ENCODINGS,
                                             format_table, run_comparison)
from repro_torch.training.data import holdout_batches, make_batch_fn
from repro_torch.training.steps import (bc_optimizer, loss_summary,
                                        make_sim_eval_step,
                                        make_sim_train_step,
                                        open_loop_metrics)

log = logging.getLogger("repro_torch.launch.train_sim")

DEFAULT_CKPT_ROOT = os.path.join(tempfile.gettempdir(),
                                 "repro_torch_sim_ckpt")


def resolve_ckpt_dir(root, arch, smoke: bool) -> str:
    """Per-(arch, shape) checkpoint dir under the chosen root.

    The subdir is salted with the model/scenario shape so restoring a
    checkpoint from a different encoding or a reduced-vs-full run of the
    same arch can never load a mismatched parameter tree. ``--smoke`` with
    no explicit root uses a fresh temp dir: smoke is a health assertion
    and must not silently resume a finished earlier run.
    """
    if root is None:
        root = (rank0_tempdir("repro_torch_sim_smoke_") if smoke
                else DEFAULT_CKPT_ROOT)
    sig = (f"{arch.name}_d{arch.d_model}x{arch.num_layers}"
           f"_m{arch.num_map}a{arch.num_agents}t{arch.num_steps}")
    return os.path.join(root, sig)


def make_eval_cb(model, scen, *, holdout, n_scenes_per_family: int,
                 n_samples: int, seed: int):
    """Periodic evaluation closure for the Trainer's eval hook.

    Scenes, the rollout engine and the open-loop eval step are built once;
    the engine shares ``model``, so every call sees its current weights.
    Returns ``(eval_cb, state)``: ``state["last"]`` holds the newest
    open- and closed-loop metrics, ``state["last_step"]`` their step.
    """
    eval_cfg = EvalConfig(t_hist=max(1, scen.num_steps // 2),
                          n_samples=n_samples, seed=seed + 1)
    scenes = [registry.generate_scene(f, seed + 777, i, scen)
              for f in registry.names()
              for i in range(n_scenes_per_family)]
    engine = RolloutEngine(model, scen,
                           num_slots=min(32, len(scenes) * n_samples),
                           device=model.device)
    eval_fn = make_sim_eval_step(model)
    state = {"last": None, "last_step": None, "engine": engine}

    def eval_cb(step, model_):
        if model_ is not model:
            raise ValueError("eval_cb was built for another model")
        state["last_step"] = step
        closed = evaluate_scenes(engine, scenes, eval_cfg)
        open_m = open_loop_metrics(model, holdout, eval_fn=eval_fn)
        state["last"] = {"open_loop": open_m,
                         "closed_loop": closed["overall"]}
        log.info(
            "eval @ step %d: nll %.4f acc %.3f | minADE %.3f miss %.3f "
            "collision %.3f offroad %.3f", step, open_m["nll"],
            open_m["accuracy"], closed["overall"]["min_ade"],
            closed["overall"]["miss_rate"],
            closed["overall"]["collision_rate"],
            closed["overall"]["offroad_rate"])

    return eval_cb, state


def _with_nan_injection(step_fn: TrainStep, at_step: int) -> TrainStep:
    """Failure drill (``--inject-nan-at``): poison the *reported* loss from
    host call ``at_step`` onward so the NaN guard trips and the
    flight-recorder dump path runs for real. The gradients are untouched;
    the trainer skips the update because of the loss it reads."""
    calls = {"n": 0}

    def grads(batch):
        g, metrics = step_fn.grads(batch)
        if calls["n"] >= at_step:
            metrics = dict(metrics)
            metrics["loss"] = float("nan")
        calls["n"] += 1
        return g, metrics

    return TrainStep(grads, step_fn.update)


def _host_coords():
    """(rank, world) of this process: ``torch.distributed``'s when a
    process group is up, else 0 of 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _smoke_arch(arch):
    return arch.reduced(num_map=12, num_agents=4, num_steps=8)


def train_single(args, families=None) -> dict:
    """One arch through the Trainer; returns the result summary, with the
    Trainer itself under ``"trainer"`` (and with ``--smoke`` asserts the
    run's health). ``families``: the training stream's scenario families
    (default all seven; with one, the data thread does not set the pace,
    which ``chip_smoke.py`` needs to time the trainer)."""
    arch = get_sim_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    if args.smoke:
        arch = _smoke_arch(arch)
    scen = arch.scenario_config()
    model = AgentSimModel(arch.agent_sim_config(), device=args.device,
                          generator=torch.Generator().manual_seed(args.seed))
    rank, world = _host_coords()
    if args.production_mesh:
        make_production_mesh()        # raises on a world under 256 ranks
    ckpt_dir = resolve_ckpt_dir(args.ckpt_dir, arch, args.smoke)
    opt = bc_optimizer(args.lr, args.steps)
    data = ShardedIterator(make_batch_fn(scen, families),
                           batch_size=args.batch, seed=args.seed,
                           host_rank=rank, world=world)
    holdout = holdout_batches(scen, args.batch, args.holdout_batches,
                              seed=args.seed)
    # across ranks, the step on the global batch: each rank its share
    step = make_sim_train_step(
        model, opt, group=torch.distributed.group.WORLD if world > 1
        else None)
    # the first step's FLOPs and bytes land as cost.* gauges (obs/cost.py)
    step = obs.CostAccounted(step, "train.step", labels={"arch": arch.name})
    opt_state = opt.init(dict(model.named_parameters()))
    if args.inject_nan_at is not None:
        step = _with_nan_injection(step, args.inject_nan_at)

    eval_cb, eval_state = make_eval_cb(
        model, scen, holdout=holdout,
        n_scenes_per_family=args.eval_scenes_per_family,
        n_samples=args.eval_samples, seed=args.seed)

    # graceful preemption: SIGTERM triggers checkpoint-and-exit (a signal
    # handler can only be installed from the main thread)
    stop = {"flag": False}
    on_main = threading.current_thread() is threading.main_thread()
    old_handler = (signal.signal(signal.SIGTERM,
                                 lambda *_: stop.update(flag=True))
                   if on_main else None)
    flight = (obs.FlightRecorder(out_path=args.postmortem_out)
              if args.postmortem_out else None)
    trainer = Trainer(
        step, model, opt_state, data, ckpt_dir,
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=args.ckpt_every,
                      log_every=max(1, args.steps // 20),
                      eval_every=args.eval_every),
        metrics_cb=lambda s, m: log.info(
            "step %d loss %.4f acc %.3f (%.2fs/step)", s, m["loss"],
            m.get("accuracy", float("nan")), m["sec_per_step"]),
        should_stop=lambda: stop["flag"],
        eval_cb=eval_cb,
        flight=flight)
    try:
        trainer.restore_if_available(force=args.force)
        out = trainer.run()
        # final eval, unless the cadence already evaluated THIS step in
        # this process (a restored already-complete run, or a NaN-skipped
        # final step, never fired the in-loop hook)
        if eval_state["last_step"] != trainer.step:
            eval_cb(trainer.step, model)
    finally:
        data.close()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)

    result = {
        "arch": arch.name, "encoding": arch.encoding, "status": out["status"],
        "steps": trainer.step,
        # NaN-guard outcome in the final summary: a run that silently
        # discarded updates must say so next to its loss numbers
        "nan_skipped": out.get("nan_skipped", 0),
        **loss_summary(trainer.history),
        **{f"final_{k2}": v for k2, v in
           (eval_state["last"] or {}).get("open_loop", {}).items()},
    }
    closed = (eval_state["last"] or {}).get("closed_loop", {})
    result.update({f"closed_{m}": closed.get(m, float("nan"))
                   for m in ("min_ade", "miss_rate", "collision_rate",
                             "offroad_rate")})
    result["trainer"] = trainer
    log.info("finished: %s", {k: v for k, v in result.items()
                              if k != "trainer"})

    if args.smoke:
        if out["status"] != "done":
            raise AssertionError(out)
        if not np.isfinite(result["loss_last"]):
            raise AssertionError(f"loss not finite: {result}")
        if not result["loss_last"] < result["loss_first"]:
            raise AssertionError(f"loss did not decrease: {result}")
        check_final_checkpoint(trainer)
        log.info("smoke OK: loss %.4f -> %.4f, checkpoint round-trip exact",
                 result["loss_first"], result["loss_last"])
    return result


def check_final_checkpoint(trainer: Trainer):
    """The newest checkpoint holds the trainer's step and, bit for bit,
    its model's parameters."""
    tree, extra = trainer.ckpt.restore(trainer.ckpt.latest_step())
    if int(extra["step"]) != trainer.step:
        raise AssertionError(f"checkpoint step {extra['step']} != "
                             f"{trainer.step}")
    want = to_reference(trainer.model)

    def walk(a, b, path):
        if isinstance(b, dict):
            if sorted(a) != sorted(b):
                raise AssertionError(f"checkpoint keys differ at {path}")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif not (a.dtype == b.dtype and np.array_equal(a, b)):
            raise AssertionError(f"checkpoint differs at {path}")

    walk(tree["params"], want, "params")


def train_compare(args) -> dict:
    arch = get_sim_arch(args.arch)
    if args.reduced or args.smoke:
        arch = arch.reduced()
    if args.smoke:
        arch = _smoke_arch(arch)
    encodings = (tuple(args.encodings.split(","))
                 if args.encodings else COMPARISON_ENCODINGS)
    if args.smoke and not args.encodings:
        # the acceptance pair: one relative encoding vs the baseline
        encodings = ("se2_fourier", "absolute")
    report = lambda name, val, extra="": print(f"{name},{val},{extra}",
                                               flush=True)
    rows = run_comparison(
        arch, encodings, steps=args.steps, batch=args.batch, lr=args.lr,
        seed=args.seed, holdout_n=args.holdout_batches,
        n_scenes_per_family=args.eval_scenes_per_family,
        eval_samples=args.eval_samples, report=report, device=args.device)
    print(format_table(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        log.info("wrote %s", args.out)
    if args.smoke:
        for enc in encodings:
            row = rows[enc]
            ok = (row["status"] == "done"
                  and np.isfinite(row["open_loop_nll"])
                  and np.isfinite(row["closed_loop_min_ade"])
                  and row["loss_last"] < row["loss_first"])
            if not ok:
                raise AssertionError(f"{enc}: {row}")
        log.info("compare smoke OK: %s", list(encodings))
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Behavior-cloning training for the SE(2) agent-sim "
                    "model on scenario-family expert demonstrations.")
    ap.add_argument("--arch", default="sim-se2-fourier",
                    help=f"one of {sorted(SIM_ARCHS)}")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-encoding config")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) production mesh: needs 256 ranks")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (a per-arch+shape subdir is "
                         f"appended; default {DEFAULT_CKPT_ROOT}, or a "
                         "fresh temp dir under --smoke)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="closed-loop eval cadence in steps (0 = final only)")
    ap.add_argument("--eval-scenes-per-family", type=int, default=2)
    ap.add_argument("--eval-samples", type=int, default=2)
    ap.add_argument("--holdout-batches", type=int, default=4)
    ap.add_argument("--compare", action="store_true",
                    help="train every encoding under one budget and print "
                         "the invariant-vs-absolute table")
    ap.add_argument("--encodings", default=None,
                    help="comma-separated subset for --compare")
    ap.add_argument("--out", default=None,
                    help="write --compare results to this JSON path")
    ap.add_argument("--force", action="store_true",
                    help="resume even from a checkpoint tagged with a "
                         "halt_reason (e.g. a NaN-halt save); without it "
                         "the trainer refuses to blindly replay the same "
                         "divergence")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run with health assertions")
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="write the run's Chrome/Perfetto telemetry trace "
                         "(trainer step/eval/checkpoint spans + registry "
                         "snapshot) to PATH; render with "
                         "python -m repro_torch.launch.obs_report")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="also dump the registry in Prometheus text "
                         "exposition format")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="write this process's trace as DIR/rankNNNNN."
                         "trace.jsonl, stamped with its fleet identity; "
                         "merge a fleet's worth with "
                         "python -m repro_torch.launch.obs_merge DIR")
    ap.add_argument("--postmortem-out", default=None, metavar="PATH",
                    help="arm the flight recorder: on NaN-halt or SIGTERM "
                         "preemption, dump a postmortem bundle to PATH "
                         "(render with obs_report --postmortem)")
    ap.add_argument("--inject-nan-at", type=int, default=None, metavar="N",
                    help="failure drill: report NaN losses from step N "
                         "onward so the NaN guard halts and the flight "
                         "recorder fires (exits nonzero by design)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the whole run "
                         "into DIR/trace.json")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # a multi-process run: torchrun's variables give this rank its place
    world = int(os.environ.get("WORLD_SIZE", "1"))
    joined = world > 1 and not torch.distributed.is_initialized()
    if joined:
        init_fleet(int(os.environ["RANK"]), world,
                   f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                   f"{os.environ['MASTER_PORT']}", device=args.device)
    if args.smoke and args.steps == 200:
        args.steps = 40
    # one fresh registry as the process default: the Trainer and the eval
    # hook's rollout engine land in the same timeline
    reg = obs.Registry()
    old_reg = obs.set_registry(reg)
    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and args.device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    try:
        if args.compare:
            return train_compare(args)
        return train_single(args)
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            log.info("torch profiler trace written to %s", path)
        if args.telemetry_out:
            obs.write_chrome_trace(reg, args.telemetry_out)
            log.info("telemetry trace: %s", args.telemetry_out)
        if args.telemetry_dir:
            obs.fleet.stamp_process_identity(reg)
            log.info("per-rank telemetry trace: %s",
                     obs.fleet.write_rank_trace(reg, args.telemetry_dir,
                                                process_name="train_sim"))
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(obs.prometheus_text(reg))
            log.info("prometheus exposition: %s", args.prom_out)
        obs.set_registry(old_reg)
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
