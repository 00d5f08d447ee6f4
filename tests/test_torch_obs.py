"""Parity: the port's telemetry copies (``repro_torch.obs``,
``runtime/monitor.py``, ``launch/obs_report.py`` and ``obs_merge.py``)
against the JAX package's originals, in one process.

The same sequence of instrument calls on a registry of each package must
give equal snapshots, Prometheus text and trace files (wall-clock fields
masked); the same step times and losses give the same straggler, step-timer
and NaN-guard decisions; both renderers print the same report of one trace
or bundle. And the port's rollout engine records its spans without
changing a bit of its rollouts.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.launch import obs_merge as jmerge  # noqa: E402
from repro.launch import obs_report as jreport  # noqa: E402
from repro.runtime import monitor as jmonitor  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import obs_merge as tmerge  # noqa: E402
from repro_torch.launch import obs_report as treport  # noqa: E402
from repro_torch.nn.agent_sim import AgentSimModel  # noqa: E402
from repro_torch.runtime import RolloutEngine  # noqa: E402
from repro_torch.runtime import monitor as tmonitor  # noqa: E402
from repro_torch.scenarios import registry as tregistry  # noqa: E402

PACKAGES = {"jax": (jobs, jmonitor, jreport, jmerge),
            "torch": (tobs, tmonitor, treport, tmerge)}
# fields read from a clock: the monotonic span clock and the wall epoch
CLOCK_KEYS = ("ts", "epoch", "wall_time_unix")


def _mask(tree):
    if isinstance(tree, dict):
        return {k: ("<clock>" if k in CLOCK_KEYS else _mask(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mask(v) for v in tree]
    return tree


def _drive(obs, monitor, rank=2):
    """One fixed sequence of instrument calls; spans are given their
    intervals so their durations are the same in both packages."""
    rng = np.random.default_rng(0)
    reg = obs.Registry(trace_capacity=16)
    reg.set_identity(rank=rank, pod=1, data=0)
    reg.counter("server.admitted").inc()
    reg.counter("server.admitted").inc(3)
    reg.counter("compile.count", fn="step").inc()
    reg.gauge("server.occupancy").set(0.73)
    reg.gauge("rollout.cache_bytes", dtype="int8").set(1_578_240)
    hist = reg.histogram("tick.seconds", phase="decode")
    for v in np.concatenate([rng.lognormal(-5, 1, 300), [0.0, -1.0,
                                                        float("nan")]]):
        hist.record(float(v))
    for i in range(20):                 # overflows the 16-event ring
        t0 = 10.0 + i
        reg.observe_span("trainer.step", t0, t0 + 1e-3 * (i + 1),
                         slot=i % 2)
    reg.event("trainer.halt", step=3, consecutive=5)
    policy = monitor.StragglerPolicy(straggler_factor=1.5, min_samples=3,
                                     registry=reg)
    flagged = policy.evaluate({0: 1.0, 1: 1.1, 2: 3.0, 3: 1.05},
                              {0: 5, 1: 5, 2: 5, 3: 1})
    return reg, flagged


def test_registry_snapshot_prometheus_and_events_match():
    out = {}
    for name, (obs, monitor, _, _) in PACKAGES.items():
        reg, flagged = _drive(obs, monitor)
        out[name] = (_mask(reg.snapshot()), obs.prometheus_text(reg),
                     _mask(reg.events()), flagged, reg.dropped_events,
                     reg.histogram("tick.seconds", phase="decode")
                     .percentile(99))
    assert out["torch"] == out["jax"]
    assert out["jax"][3] == [2] and out["jax"][4] == 8


def test_chrome_trace_files_match_and_read_across(tmp_path):
    files = {}
    for name, (obs, monitor, _, _) in PACKAGES.items():
        reg, _ = _drive(obs, monitor)
        files[name] = obs.write_chrome_trace(reg, str(tmp_path / name))
    for reader in (jobs, tobs):
        got = [_mask(reader.read_chrome_trace(files[n])) for n in files]
        assert got[0] == got[1]
    events = tobs.read_chrome_trace(files["torch"])
    assert events[-1]["name"] == tobs.SNAPSHOT_EVENT == jobs.SNAPSHOT_EVENT


def test_disabled_registry_records_nothing():
    for obs, *_ in PACKAGES.values():
        with obs.NULL.span("x"):
            obs.NULL.counter("c").inc()
        obs.NULL.event("e")
        assert obs.NULL.events() == [] and not list(obs.NULL.instruments())


@pytest.mark.parametrize("times", [
    [0.1, 0.3, 0.2, 0.4], [0.5] * 7, [0.2, float("inf"), 0.1], []])
def test_step_timer_decisions_match(times):
    got = []
    for _, monitor, _, _ in PACKAGES.values():
        timer = monitor.StepTimer(window=3)
        timer.times.extend(times)
        got.append((timer.median, timer.count, timer.stop()))
    np.testing.assert_equal(got[1], got[0])


def test_straggler_policy_decisions_match():
    rng = np.random.default_rng(1)
    for trial in range(30):
        n = int(rng.integers(1, 12))
        medians = {r: float(rng.lognormal(0, 0.5)) for r in range(n)}
        if trial % 5 == 0:
            medians[0] = float("nan")
        counts = ({r: int(rng.integers(0, 20)) for r in range(n)}
                  if trial % 2 else None)
        got = [monitor.StragglerPolicy(
                   straggler_factor=float(1.2 + 0.1 * (trial % 4)),
                   min_samples=int(trial % 6), registry=obs.NULL)
               .evaluate(medians, counts)
               for obs, monitor, _, _ in PACKAGES.values()]
        assert got[0] == got[1], (trial, medians, counts)


def test_nan_guard_decisions_match():
    losses = [1.0, float("nan"), float("inf"), 2.0, float("nan"),
              float("nan"), float("-inf"), 0.5, float("nan")] * 2
    got = []
    for _, monitor, _, _ in PACKAGES.values():
        guard = monitor.NaNGuard(max_consecutive=3)
        got.append(([guard.check(x) for x in losses], guard.consecutive,
                    guard.total_skipped))
    assert got[0] == got[1]
    assert "halt" in got[0][0]


def test_reports_of_one_trace_match(tmp_path, capsys):
    reg, _ = _drive(tobs, tmonitor)
    path = tobs.write_chrome_trace(reg, str(tmp_path / "run.trace.jsonl"))
    text = []
    for report in (jreport, treport):
        for argv in ([path], [path, "--json"]):
            assert report.main(argv) == 0
            text.append(capsys.readouterr().out)
    assert text[2:] == text[:2]
    assert "trainer.step" in text[0] and "== histograms" in text[0]


def test_flight_bundles_match_and_render(tmp_path, capsys):
    bundles = []
    for name, (obs, monitor, _, _) in PACKAGES.items():
        reg, _ = _drive(obs, monitor)
        rec = obs.FlightRecorder(reg, out_path=str(tmp_path / f"{name}.json"),
                                 last_k=8)
        rec.add_provider("trainer", lambda: {"step": 9, "loss_tail": [1.5]})
        rec.add_provider("broken", lambda: 1 / 0)
        bundles.append(rec.dump(reason="nan_halt", step=9))
    loaded = [_mask(json.loads(Path(p).read_text())) for p in bundles]
    assert loaded[0] == loaded[1]
    assert loaded[1]["state"]["broken"]["error"].startswith(
        "ZeroDivisionError")
    text = []
    for report in (jreport, treport):
        assert report.main(["--postmortem", bundles[1]]) == 0
        text.append(capsys.readouterr().out)
    strip = lambda s: [ln for ln in s.splitlines()  # noqa: E731
                       if not ln.startswith("written")]
    assert strip(text[1]) == strip(text[0])
    assert "nan_halt" in text[1]


def test_fleet_merge_matches(tmp_path):
    merged = []
    for name, (obs, monitor, _, merge) in PACKAGES.items():
        d = tmp_path / name
        for rank in (1, 0):
            reg, _ = _drive(obs, monitor, rank=rank)
            obs.fleet.write_rank_trace(reg, str(d), process_name="train_sim")
        out = str(d / "merged.trace.jsonl")
        assert merge.main([str(d), "-o", out]) == 0
        merged.append(_mask(obs.read_chrome_trace(out)))
    assert merged[0] == merged[1]


def test_stamp_process_identity_without_a_process_group():
    reg = tobs.fleet.stamp_process_identity(tobs.Registry(), pod=0)
    assert reg.identity == {"rank": 0, "world": 1, "pod": 0}


def test_rollout_telemetry_records_and_changes_nothing():
    """The engine's spans, tick counter and cache gauge, and bitwise-equal
    rollouts with telemetry on and off (the reference's
    ``test_rollout_engine_obs_on_off_bit_identical``)."""
    arch = tconfigs.get_sim_arch("sim-se2-fourier").reduced(
        num_map=8, num_agents=3, num_steps=6)
    scen = arch.scenario_config()
    model = AgentSimModel(arch.agent_sim_config(), device="cpu")
    scenes = [tregistry.generate_scene(f, 5, i, scen)
              for f in ("freeform", "highway") for i in range(2)]
    runs = []
    for reg in (tobs.Registry(), tobs.NULL):
        engine = RolloutEngine(model, scen, num_slots=3, device="cpu",
                               registry=reg)
        fut = engine.run(scenes, t_hist=3, n_samples=2, seed=4)
        runs.append((fut, engine.last_actions, reg))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    reg = runs[0][2]
    chunks = 3                                  # 8 lanes over 3 slots
    assert reg.counter("rollout.ticks").value == chunks * 3
    names = [e["name"] for e in reg.events()]
    assert names.count("rollout.chunk") == chunks
    assert names.count("rollout.prefill") == chunks
    assert names.count("rollout.step") == chunks * 3
    cache = model.init_cache(3, engine.max_len)
    assert reg.gauge("rollout.cache_bytes").value == sum(
        t.numel() * t.element_size() for t in cache.values())
