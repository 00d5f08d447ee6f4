"""Chaos drill suite: ``python -m repro_torch.launch.chaos`` (port of
``repro/launch/chaos.py``).

Runs the scripted fault scenarios end to end through the port's
:class:`~repro_torch.runtime.trainer.Trainer` and
:class:`~repro_torch.runtime.sim_server.SimServer`, on the card unless
``--device cpu`` is given, and asserts the recovery invariants the
robustness layer promises (``docs/robustness.md``):

* **corrupt_ckpt_resume** — train, truncate the latest checkpoint's
  ``arrays.npz``, relaunch: the trainer must fall back to the previous
  *verified* step and the resumed run must be bitwise equal (parameters
  and loss history) to the fault-free trajectory.
* **nan_slot_quarantine** — poison one resident slot's poses/logits with
  NaN mid-rollout ({f32, int8} caches): the lane is quarantined
  (``status == "failed"``, a reason, the counter), every healthy lane
  stays bitwise equal to a no-fault run, and a fresh scene admitted into
  the scrubbed slot is bitwise equal to the same request served alone in
  a fresh server of the same slot count. (The reference holds that tenant
  to a solo ``RolloutEngine``; on the card the engine's one-shot prefill
  runs its matrix products at other shapes, so the port holds the server
  to its own isolation contract, as ``chip_smoke.py`` phase 10 does.)
* **dead_worker** — a deterministic ``make_batch`` failure must raise
  ``DataWorkerError`` within bounded retries; a transient failure inside
  the retry budget must recover with the batch stream unchanged.
* **async_save_io** — transient save-IO failures are retried with backoff
  and the checkpoint still verifies; a persistent failure is re-raised at
  ``wait()``; stale ``.tmp`` debris is swept at manager startup.
* **delay_tick** — injected tick latency perturbs timing only: the served
  results stay bitwise equal.

Every drill dumps a flight-recorder bundle and renders it through
``obs_report``'s postmortem view. Faults come from a seeded
:class:`~repro_torch.chaos.FaultPlan`; the summary is written only where
``--out`` points.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import chaos, obs
from repro_torch.checkpoint import CheckpointManager, CheckpointWriteError
from repro_torch.data.pipeline import DataWorkerError, ShardedIterator
from repro_torch.device import resolve_device
from repro_torch.launch.obs_report import render_postmortem
from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.runtime.sim_server import SceneRequest, SimServer
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.scenarios.core import ScenarioConfig
from repro_torch.scenarios.registry import generate_mixed, generate_scene
from repro_torch.training.data import make_batch_fn
from repro_torch.training.steps import make_sim_train_step

log = logging.getLogger("repro_torch.launch.chaos")

SCEN = ScenarioConfig(num_map=8, num_agents=3, num_steps=6)
T_HIST = 3


def _model(device, seed: int = 0) -> AgentSimModel:
    cfg = AgentSimConfig(d_model=32, num_layers=2, num_heads=2, head_dim=12,
                         d_ff=64, num_actions=SCEN.num_actions,
                         encoding="se2_fourier")
    return AgentSimModel(cfg, device=device,
                         generator=torch.Generator().manual_seed(seed))


def _sim_trainer(ckpt_dir: str, total_steps: int, device, *, seed: int = 0,
                 flight=None) -> Trainer:
    """A tiny but real BC training stack (the test suite's shape)."""
    model = _model(device, seed)
    opt = chain(clip_by_global_norm(1.0), adamw(3e-3))
    data = ShardedIterator(make_batch_fn(SCEN), batch_size=2, seed=seed)
    return Trainer(make_sim_train_step(model, opt), model,
                   opt.init(dict(model.named_parameters())), data, ckpt_dir,
                   TrainerConfig(total_steps=total_steps, ckpt_every=4,
                                 log_every=100),
                   flight=flight)


def _assert_bit_identical(got, want, label: str):
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).ravel())
        raise AssertionError(
            f"{label}: {bad.size}/{got.size} elements differ "
            f"(first at flat index {bad[0]})")


def _dump_and_render(fr: obs.FlightRecorder, path: str, *, reason: str,
                     **context) -> str:
    """Every drill must leave a postmortem the tooling can read: dump the
    bundle and round-trip it through the obs_report renderer."""
    out = fr.dump(reason=reason, path=path, **context)
    _render(out, reason)
    return out


def _render(path: str, reason: str) -> None:
    with open(path) as f:
        text = render_postmortem(json.load(f))
    if reason not in text:
        raise AssertionError(f"postmortem render lost the reason: {path}")


# ---------------------------------------------------------------------------
# scenario 1: corrupt-latest checkpoint -> fallback restore, bitwise resume
# ---------------------------------------------------------------------------

def drill_corrupt_ckpt_resume(workdir: str, plan_seed: int,
                              bundle_path: str, device) -> Dict[str, Any]:
    steps_mid, steps_total = 8, 12
    plan = chaos.FaultPlan(seed=plan_seed)

    # fault-free reference trajectory
    tr_ref = _sim_trainer(os.path.join(workdir, "ref"), steps_total, device)
    tr_ref.run()
    tr_ref.data.close()

    # interrupted run: checkpoints at 4 and 8, then the latest is torn
    ckpt_dir = os.path.join(workdir, "victim")
    tr_a = _sim_trainer(ckpt_dir, steps_mid, device)
    tr_a.run()
    tr_a.data.close()
    steps_before = CheckpointManager(ckpt_dir).available_steps()
    corruption = chaos.corrupt_checkpoint(
        ckpt_dir, "truncate_checkpoint_npz", plan=plan)

    # relaunch: must walk back to the newest VERIFIED step, not crash
    fr = obs.FlightRecorder()
    tr_b = _sim_trainer(ckpt_dir, steps_total, device, flight=fr)
    if not tr_b.restore_if_available():
        raise AssertionError("no checkpoint restored")
    report = tr_b.ckpt.last_restore_report
    if report["step"] != 4 or [s["step"] for s in report["skipped"]] != [8]:
        raise AssertionError(f"fallback restore report {report}")
    tr_b.run()
    tr_b.data.close()

    _assert_bit_identical(
        np.asarray(tr_b.history), np.asarray(tr_ref.history[4:]),
        "loss history after fallback resume")
    want = tr_ref.model.state_dict()
    for name, got in tr_b.model.state_dict().items():
        _assert_bit_identical(got.cpu(), want[name].cpu(),
                              f"{name} after fallback resume")

    _dump_and_render(fr, bundle_path, reason="chaos_corrupt_ckpt_resume",
                     corruption=corruption, fallback_step=report["step"])
    return {"passed": True, "steps_present_before": steps_before,
            "fallback_step": report["step"],
            "skipped": report["skipped"],
            "resume_bit_exact": True}


# ---------------------------------------------------------------------------
# scenario 2: NaN-poisoned slot -> quarantine; healthy slots bitwise
# ---------------------------------------------------------------------------

def _submit_lanes(srv: SimServer, scenes, seed: int):
    for i, scene in enumerate(scenes):
        srv.submit(SceneRequest(uid=i, tensors=scene, t_hist=T_HIST,
                                seed=seed, scene_id=i))


def _drive(srv: SimServer, plan: chaos.FaultPlan) -> int:
    """Tick until drained, firing scheduled poison/delay faults against
    the drill's tick clock."""
    tick = 0
    while srv.queue or any(s.req for s in srv.slots):
        f = plan.fires("delay_tick", tick)
        if f is not None:
            time.sleep(f.param)
        f = plan.fires("poison_slot_nan", tick)
        if f is not None:
            chaos.poison_server_slot(srv, f.target, plan=None, tick=tick)
        srv.tick()
        tick += 1
        if tick > 10_000:
            raise RuntimeError("drill server did not drain")
    srv.flush()
    return tick


def drill_nan_slot_quarantine(workdir: str, plan_seed: int,
                              bundle_path: str, device) -> Dict[str, Any]:
    model = _model(device)
    scenes = generate_mixed(5, 0, 3, SCEN)
    out: Dict[str, Any] = {"passed": True}
    for cache_dtype in ("float32", "int8"):
        def server():
            return SimServer(model, SCEN, num_slots=2,
                             cache_dtype=cache_dtype, device=device)

        # fault-free reference: same submissions, no poison
        ref = server()
        _submit_lanes(ref, scenes, seed=11)
        _drive(ref, chaos.FaultPlan(seed=plan_seed))
        if not all(r.status == "ok" for r in ref.done.values()):
            raise AssertionError("the fault-free run failed a lane")

        # poisoned run: NaN into slot 0 (the victim's) mid-rollout
        srv = server()
        plan = chaos.FaultPlan(
            [chaos.Fault("poison_slot_nan", at=4, target=0)],
            seed=plan_seed)
        _submit_lanes(srv, scenes, seed=11)
        _drive(srv, plan)
        if plan.fired_counts().get("poison_slot_nan") != 1:
            raise AssertionError(f"poison fired {plan.fired}")

        victim = srv.done[0]
        if victim.status != "failed" or not victim.reason:
            raise AssertionError(f"victim not quarantined: {victim}")
        if srv.quarantined != 1:
            raise AssertionError(f"quarantined {srv.stats()}")
        healthy = [u for u in srv.done if srv.done[u].status == "ok"]
        if len(healthy) != len(scenes) - 1:
            raise AssertionError(f"healthy lanes {sorted(srv.done)}")
        for uid in healthy:
            _assert_bit_identical(srv.done[uid].future, ref.done[uid].future,
                                  f"healthy lane {uid} poses ({cache_dtype})")
            _assert_bit_identical(srv.done[uid].actions,
                                  ref.done[uid].actions,
                                  f"healthy lane {uid} acts ({cache_dtype})")

        # recovery: a fresh scene through the scrubbed slot, bitwise equal
        # to the same request alone in a fresh server
        fresh = generate_scene("highway", 123, 0, SCEN)

        def request():
            return SceneRequest(uid=99, tensors=fresh, t_hist=T_HIST,
                                seed=21, scene_id=0, sample_id=0)
        solo = server()
        solo.submit(request())
        solo.run_until_drained()
        srv.submit(request())
        srv.run_until_drained()
        if srv.done[99].status != "ok":
            raise AssertionError(f"recycled tenant {srv.done[99]}")
        _assert_bit_identical(srv.done[99].future, solo.done[99].future,
                              f"post-quarantine admission ({cache_dtype})")
        _assert_bit_identical(srv.done[99].actions, solo.done[99].actions,
                              f"post-quarantine actions ({cache_dtype})")
        out[cache_dtype] = {"quarantined": srv.quarantined,
                            "victim_reason": victim.reason,
                            "healthy_bit_identical": True,
                            "recycle_bit_identical": True}
        if cache_dtype == "int8":
            srv.dump_postmortem(bundle_path, reason="chaos_nan_quarantine")
            _render(bundle_path, "chaos_nan_quarantine")
    return out


# ---------------------------------------------------------------------------
# scenario 3: dead data worker -> bounded raise; transient -> exact recovery
# ---------------------------------------------------------------------------

def drill_dead_worker(workdir: str, plan_seed: int,
                      bundle_path: str, device) -> Dict[str, Any]:
    make_batch = make_batch_fn(SCEN)

    # deterministic failure: must raise within bounded retries, not hang
    plan = chaos.FaultPlan(
        [chaos.Fault("kill_data_worker", at=0, count=10 ** 6)],
        seed=plan_seed)
    it = ShardedIterator(chaos.flaky_make_batch(make_batch, plan),
                         batch_size=2, worker_retries=2,
                         retry_backoff=0.01)
    t0 = time.perf_counter()
    raised = False
    try:
        next(it)
    except DataWorkerError:
        raised = True
    raise_s = time.perf_counter() - t0
    it.close()
    if not raised:
        raise AssertionError("deterministic make_batch failure did not "
                             "propagate")
    if raise_s >= 30.0:
        raise AssertionError(f"raise took {raise_s:.1f}s — effectively a "
                             f"hang")
    attempts = plan.fired_counts()["kill_data_worker"]
    if attempts != 3:
        raise AssertionError(f"expected 1 try + 2 retries, saw {attempts}")

    # transient failure inside the retry budget: the stream is unchanged
    it_c = ShardedIterator(make_batch, batch_size=2)
    clean = next(it_c)
    it_c.close()
    plan_t = chaos.FaultPlan(
        [chaos.Fault("kill_data_worker", at=0, count=2)], seed=plan_seed)
    it_t = ShardedIterator(chaos.flaky_make_batch(make_batch, plan_t),
                           batch_size=2, worker_retries=2,
                           retry_backoff=0.01)
    recovered = next(it_t)
    it_t.close()
    for k in clean:
        _assert_bit_identical(recovered[k], clean[k],
                              f"transient-recovery batch[{k}]")

    fr = obs.FlightRecorder()
    fr.add_provider("fault_plan", plan.summary)
    _dump_and_render(fr, bundle_path, reason="chaos_dead_worker",
                     raise_s=raise_s, attempts=attempts)
    return {"passed": True, "raise_s": raise_s, "attempts": attempts,
            "transient_recovered": True}


# ---------------------------------------------------------------------------
# scenario 4: async-save IO failures -> retry/backoff; persistent -> surfaced
# ---------------------------------------------------------------------------

def drill_async_save_io(workdir: str, plan_seed: int,
                        bundle_path: str, device) -> Dict[str, Any]:
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(3, np.float32)}

    # transient: two failed write attempts ride the retry budget
    plan = chaos.FaultPlan(
        [chaos.Fault("fail_async_save_io", at=0, count=2)], seed=plan_seed)
    d1 = os.path.join(workdir, "transient")
    mgr = CheckpointManager(d1, save_retries=2, retry_backoff=0.01,
                            io_hook=chaos.checkpoint_io_hook(plan))
    mgr.save(3, tree)
    mgr.wait()                          # must NOT raise: retries absorbed it
    if mgr.verify(3) is not None:
        raise AssertionError(mgr.verify(3))
    got, _ = mgr.restore(3)
    for k in tree:
        _assert_bit_identical(got[k], tree[k], f"transient-save restore {k}")
    transient_attempts = plan.fired_counts()["fail_async_save_io"]

    # persistent: the save thread's failure must surface at wait()
    plan_p = chaos.FaultPlan(
        [chaos.Fault("fail_async_save_io", at=0, count=10 ** 6)],
        seed=plan_seed)
    d2 = os.path.join(workdir, "persistent")
    mgr_p = CheckpointManager(d2, save_retries=1, retry_backoff=0.01,
                              io_hook=chaos.checkpoint_io_hook(plan_p))
    mgr_p.save(1, tree)
    raised = False
    try:
        mgr_p.wait()
    except CheckpointWriteError:
        raised = True
    if not raised:
        raise AssertionError("persistent save failure was swallowed")
    if mgr_p.latest_step() is not None:
        raise AssertionError("a failed save left a checkpoint")

    # stale-tmp sweep: a crashed writer's debris disappears at startup
    chaos.corrupt_checkpoint(d1, "stale_checkpoint_tmp", plan=plan)
    if not any(n.endswith(".tmp") for n in os.listdir(d1)):
        raise AssertionError("no stale .tmp planted")
    CheckpointManager(d1)
    if any(n.endswith(".tmp") for n in os.listdir(d1)):
        raise AssertionError("stale .tmp not swept")
    if CheckpointManager(d1).verify(3) is not None:
        raise AssertionError("the sweep damaged step 3")

    fr = obs.FlightRecorder()
    fr.add_provider("fault_plan", plan.summary)
    _dump_and_render(fr, bundle_path, reason="chaos_async_save_io",
                     transient_attempts=transient_attempts)
    return {"passed": True, "transient_attempts": transient_attempts,
            "persistent_raised": True, "stale_tmp_cleaned": True}


# ---------------------------------------------------------------------------
# scenario 5: injected tick latency -> timing-only, results bitwise equal
# ---------------------------------------------------------------------------

def drill_delay_tick(workdir: str, plan_seed: int,
                     bundle_path: str, device) -> Dict[str, Any]:
    model = _model(device)
    scenes = generate_mixed(9, 0, 3, SCEN)

    ref = SimServer(model, SCEN, num_slots=2, device=device)
    _submit_lanes(ref, scenes, seed=5)
    _drive(ref, chaos.FaultPlan(seed=plan_seed))

    srv = SimServer(model, SCEN, num_slots=2, device=device)
    plan = chaos.FaultPlan(
        [chaos.Fault("delay_tick", at=2, count=3, param=0.02)],
        seed=plan_seed)
    _submit_lanes(srv, scenes, seed=5)
    _drive(srv, plan)
    fired = plan.fired_counts().get("delay_tick", 0)
    if fired != 3:
        raise AssertionError(f"delays fired {plan.fired}")
    if sorted(srv.done) != sorted(ref.done):
        raise AssertionError(f"lanes {sorted(srv.done)} != "
                             f"{sorted(ref.done)}")
    for uid in ref.done:
        _assert_bit_identical(srv.done[uid].future, ref.done[uid].future,
                              f"delayed lane {uid} poses")
    srv.dump_postmortem(bundle_path, reason="chaos_delay_tick")
    _render(bundle_path, "chaos_delay_tick")
    return {"passed": True, "delays_fired": fired, "bit_identical": True}


# ---------------------------------------------------------------------------

DRILLS = {
    "corrupt_ckpt_resume": drill_corrupt_ckpt_resume,
    "nan_slot_quarantine": drill_nan_slot_quarantine,
    "dead_worker": drill_dead_worker,
    "async_save_io": drill_async_save_io,
    "delay_tick": drill_delay_tick,
}


def run_drills(*, seed: int = 0, workdir: str, bundles_dir: str,
               only=None, device=None) -> Dict[str, Any]:
    device = resolve_device(device)
    os.makedirs(bundles_dir, exist_ok=True)
    t0 = time.perf_counter()
    scenarios: Dict[str, Any] = {}
    for name in [n for n in DRILLS if only is None or n in only]:
        log.info("drill: %s", name)
        wd = os.path.join(workdir, name)
        os.makedirs(wd, exist_ok=True)
        bundle = os.path.join(bundles_dir, f"chaos_{name}.json")
        t1 = time.perf_counter()
        rec = DRILLS[name](wd, seed, bundle, device)
        rec["wall_s"] = round(time.perf_counter() - t1, 3)
        rec["bundle"] = os.path.basename(bundle)
        scenarios[name] = rec
        log.info("drill %s: PASS (%.1fs)", name, rec["wall_s"])
    return {
        "kind": "chaos_drill",
        "seed": seed,
        "device": str(device),
        "scenarios": scenarios,
        "all_passed": all(r.get("passed") for r in scenarios.values()),
        "n_scenarios": len(scenarios),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Deterministic chaos drills: fault-inject the "
                    "checkpoint/serving/data layers and assert the "
                    "self-healing contracts hold bit-exactly.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the JSON summary here")
    ap.add_argument("--bundles-dir", default=None, metavar="DIR",
                    help="where each drill's flight-recorder bundle lands "
                         "(default: a temp dir)")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {sorted(DRILLS)}")
    ap.add_argument("--smoke", action="store_true",
                    help="alias for the default full suite (the drills are "
                         "already CI-sized); kept for CI-invocation symmetry")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    only = set(args.only.split(",")) if args.only else None
    if only is not None and (bad := only - set(DRILLS)):
        ap.error(f"unknown drills {sorted(bad)}; known: {sorted(DRILLS)}")
    workdir = tempfile.mkdtemp(prefix="repro_torch_chaos_")
    bundles = args.bundles_dir or os.path.join(workdir, "bundles")
    record = run_drills(seed=args.seed, workdir=workdir, bundles_dir=bundles,
                        only=only, device=args.device)
    print(json.dumps(record, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        log.info("wrote %s", args.out)
    return 0 if record["all_passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
