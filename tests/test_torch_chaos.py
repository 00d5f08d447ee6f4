"""Parity: the port's chaos layer (``repro_torch.chaos`` and
``repro_torch.launch.chaos``) against the JAX package's, on the CPU.

* fault plans: the same faults and seed give the same firings, the same
  ``fired`` records and the same corruption randomness;
* each injector against the port's ``CheckpointManager`` files: the same
  damage (byte for byte) as the reference's injector on a copy, and the
  port's verify/fallback giving the reference manager's failure reasons;
* the IO-hook and data-worker wrappers through the port's manager and
  iterator, with the reference's firing logs;
* ``python -m repro_torch.launch.chaos --device cpu``: every drill passes,
  every bundle renders, and the record passes the reference's schema for
  ``BENCH_chaos.json``.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import chaos as jchaos  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.data.pipeline import ShardedIterator as JIterator  # noqa: E402
from repro_torch import chaos  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    CheckpointWriteError)
from repro_torch.data.pipeline import (DataWorkerError,  # noqa: E402
                                       ShardedIterator)
from repro_torch.launch.obs_report import render_postmortem  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

PLANS = [
    [("delay_tick", 3, 2, 0, 0.02), ("poison_slot_nan", 1, 1, 1, 0.0)],
    [("fail_async_save_io", 0, 2, 0, 0.0),
     ("kill_data_worker", 2, 10 ** 6, 0, 0.0)],
]


def _plan(pkg, spec, seed):
    return pkg.FaultPlan([pkg.Fault(k, at, count=n, target=t, param=p)
                          for k, at, n, t, p in spec], seed=seed)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", PLANS, ids=["serve", "io"])
def test_fault_plan_matches_reference(spec, seed):
    got, want = _plan(chaos, spec, seed), _plan(jchaos, spec, seed)
    for clock in range(8):
        for kind in chaos.FAULT_KINDS:
            for target in (None, 0, 1):
                a = got.fires(kind, clock, target, where=clock)
                b = want.fires(kind, clock, target, where=clock)
                assert (a is None) == (b is None), (kind, clock, target)
    assert got.fired == want.fired and got.fired
    assert got.summary() == want.summary()
    np.testing.assert_array_equal(got.rng(3).integers(0, 1 << 30, 16),
                                  want.rng(3).integers(0, 1 << 30, 16))
    assert chaos.FAULT_KINDS == jchaos.FAULT_KINDS
    with pytest.raises(ValueError):
        chaos.Fault("not_a_kind", at=0)
    with pytest.raises(ValueError):
        chaos.Fault("delay_tick", at=0, count=0)


def _tree(step):
    rng = np.random.default_rng(step)
    return {"w": torch.from_numpy(rng.standard_normal((4, 5))
                                  .astype(np.float32)),
            "b": torch.full((3,), float(step))}


def _relative(record, root):
    """A corruption record with its paths relative to ``root``."""
    return {k: os.path.relpath(v, root) if k in ("file", "dir") else v
            for k, v in record.items()}


MODES = ["truncate_checkpoint_npz", "bitflip_checkpoint_array",
         "drop_checkpoint_manifest", "stale_checkpoint_tmp"]


@pytest.mark.parametrize("mode", MODES)
def test_corruption_matches_reference(tmp_path, mode):
    """The port's injector damages the port manager's checkpoint exactly
    as the reference's injector damages a copy of it, and the port's
    manager reports the reference manager's reasons and fallback."""
    mine, ref = tmp_path / "port", tmp_path / "ref"
    mgr = CheckpointManager(str(mine), async_save=False)
    mgr.save(1, _tree(1), extra={"step": 1})
    mgr.save(2, _tree(2), extra={"step": 2})
    shutil.copytree(mine, ref)
    plan, jplan = chaos.FaultPlan(seed=4), jchaos.FaultPlan(seed=4)
    got = chaos.corrupt_checkpoint(str(mine), mode, plan=plan)
    want = jchaos.corrupt_checkpoint(str(ref), mode, plan=jplan)

    assert _relative(got, mine) == _relative(want, ref)
    assert [_relative(r, mine) for r in plan.fired] == \
        [_relative(r, ref) for r in jplan.fired]
    for path in sorted(p.relative_to(mine) for p in mine.rglob("*")
                       if p.is_file()):
        assert (mine / path).read_bytes() == (ref / path).read_bytes(), path
    assert sorted(p.relative_to(mine) for p in mine.rglob("*")) == \
        sorted(p.relative_to(ref) for p in ref.rglob("*"))

    if mode == "stale_checkpoint_tmp":
        assert os.path.isdir(got["dir"])
        CheckpointManager(str(mine))                # startup sweeps it
        assert not any(p.name.endswith(".tmp") for p in mine.iterdir())
        return
    port_mgr, ref_mgr = CheckpointManager(str(mine)), JManager(str(ref))
    reason = port_mgr.verify(2)
    assert reason is not None
    assert reason.replace(str(mine), "<dir>") == \
        ref_mgr.verify(2).replace(str(ref), "<dir>")
    assert port_mgr.verify(1) is None
    tree, extra = port_mgr.restore(fallback=True)
    ref_mgr.restore(fallback=True)
    assert int(extra["step"]) == 1
    np.testing.assert_array_equal(tree["w"], _tree(1)["w"].numpy())
    assert json.dumps(port_mgr.last_restore_report).replace(
        str(mine), "<dir>") == json.dumps(ref_mgr.last_restore_report) \
        .replace(str(ref), "<dir>")
    with pytest.raises(IOError):
        port_mgr.restore(2)


def test_io_hook_transient_retries_and_persistent_surfaces(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    fired = []
    for pkg, manager in ((chaos, CheckpointManager), (jchaos, JManager)):
        plan = pkg.FaultPlan([pkg.Fault("fail_async_save_io", at=0,
                                        count=2)])
        mgr = manager(str(tmp_path / pkg.__name__ / "t"), save_retries=2,
                      retry_backoff=0.01,
                      io_hook=pkg.checkpoint_io_hook(plan))
        mgr.save(3, tree if pkg is chaos else {"w": tree["w"].numpy()})
        mgr.wait()                      # the retries absorbed the outage
        assert mgr.verify(3) is None
        fired.append(plan.fired)
    assert fired[0] == fired[1] and len(fired[0]) == 2
    got, _ = CheckpointManager(str(tmp_path / chaos.__name__ / "t")) \
        .restore(3)
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())

    plan = chaos.FaultPlan([chaos.Fault("fail_async_save_io", at=0,
                                        count=10 ** 6)])
    mgr = CheckpointManager(str(tmp_path / "dead"), save_retries=1,
                            retry_backoff=0.01,
                            io_hook=chaos.checkpoint_io_hook(plan))
    mgr.save(1, tree)
    with pytest.raises(CheckpointWriteError):
        mgr.wait()
    assert mgr.latest_step() is None and plan.fired_counts() == {
        "fail_async_save_io": 2}


def _batch_fn(seed, start, size):
    return {"x": np.arange(start, start + size, dtype=np.float32) + seed}


def test_flaky_make_batch_bounded_and_transient(tmp_path):
    fired = []
    for pkg, iterator in ((chaos, ShardedIterator), (jchaos, JIterator)):
        plan = pkg.FaultPlan([pkg.Fault("kill_data_worker", at=0,
                                        count=10 ** 6)])
        it = iterator(pkg.flaky_make_batch(_batch_fn, plan), batch_size=2,
                      worker_retries=2, retry_backoff=0.01)
        with pytest.raises(Exception) as err:
            next(it)
        assert type(err.value).__name__ == "DataWorkerError"
        assert it.cursor == 0
        it.close()
        fired.append(plan.fired)
    assert fired[0] == fired[1] and len(fired[0]) == 3
    plan = chaos.FaultPlan([chaos.Fault("kill_data_worker", at=1, count=2)])
    it = ShardedIterator(chaos.flaky_make_batch(_batch_fn, plan),
                         batch_size=2, worker_retries=2, retry_backoff=0.01)
    got = [next(it) for _ in range(3)]
    it.close()
    assert plan.fired_counts() == {"kill_data_worker": 2}
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g["x"], _batch_fn(0, 2 * i, 2)["x"])
    assert issubclass(DataWorkerError, RuntimeError)


def _bench_schema():
    spec = importlib.util.spec_from_file_location(
        "bench_schema", ROOT / "benchmarks" / "bench_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_launcher_on_cpu(tmp_path):
    """Every drill passes on the CPU and leaves a bundle that renders; the
    summary lands only where --out points and passes the reference's
    BENCH_chaos.json schema."""
    out, bundles = tmp_path / "chaos.json", tmp_path / "bundles"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.chaos", "--device", "cpu",
         "--out", str(out), "--bundles-dir", str(bundles)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    record = json.loads(out.read_text())
    assert record["all_passed"] and record["n_scenarios"] == 5
    assert record["device"] == "cpu"
    q = record["scenarios"]["nan_slot_quarantine"]
    for dtype in ("float32", "int8"):
        assert q[dtype]["victim_reason"] == "nonfinite_pose"
    for name, row in record["scenarios"].items():
        bundle = json.loads((bundles / row["bundle"]).read_text())
        assert bundle["reason"].startswith("chaos_"), name
        assert bundle["reason"] in render_postmortem(bundle)
    bs = _bench_schema()
    check = bs._Check("chaos.json")
    bs.check_chaos(record, check)
    assert check.problems == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bundles",
                                                          "chaos.json"]
