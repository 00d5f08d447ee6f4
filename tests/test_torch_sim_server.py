"""Parity and isolation: the port's continuous-batching ``SimServer``
against the JAX package's, on the CPU, at the reference's test size
(``tests/test_sim_server.py``: ``ScenarioConfig(8, 3, 6)``, the 2-layer
d_model 32 se2_fourier model, weights crossed with
``params.from_reference``).

Both servers sample the ``jax.random`` stream (the port through
``repro_torch.prng``), so the two are compared through admission, the
teacher-forced prefill ticks and then closed loop, lane against lane:
actions equal except where a near-tie (top-two perturbed scores within
1e-5, the two frameworks' float32 ``log``) flips one. The port is also
held to the reference's isolation contracts port against port: a lane's
actions and poses do not depend on its slot, its co-residents, its arrival
order or NaN garbage in stale rows.

Which server-vs-engine contract holds: on the CPU the streamed prefill
(a B = 1 map admission, then A rows a tick) gives futures bitwise equal
to ``RolloutEngine``'s one-shot prefill, so (e) and (f) assert bitwise
equality. On the card the engine's prefill runs its matrix products at
other shapes; ``chip_smoke.py`` phase 10 holds the first closed-loop
logits to a tolerance there and the server to itself bitwise.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import scenarios as jscen  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.runtime.sim_server import SceneRequest as JRequest  # noqa: E402
from repro.runtime.sim_server import SimServer as JServer  # noqa: E402
from repro_torch import chaos, obs  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.launch.obs_report import render_postmortem  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime import (RolloutEngine, SceneRequest,  # noqa: E402
                                 SimServer, poisson_drive, serve_scenes)
from repro_torch.runtime.evaluation import (METRICS, EvalConfig,  # noqa: E402
                                            scene_metrics)
from repro_torch.scenarios.core import ScenarioConfig  # noqa: E402
from repro_torch.scenarios.registry import (generate_mixed,  # noqa: E402
                                            generate_scene)
from test_torch_serving_utils import (assert_bit_identical,  # noqa: E402
                                      diverged_lanes, score_gaps,
                                      scribble_stale_rows)

ROOT = Path(__file__).resolve().parents[1]
SCEN_KW = dict(num_map=8, num_agents=3, num_steps=6)
SCEN = ScenarioConfig(**SCEN_KW)
SCEN_J = jscen.ScenarioConfig(**SCEN_KW)
T_HIST = 3
MODEL_KW = dict(d_model=32, num_layers=2, num_heads=2, head_dim=12, d_ff=64,
                encoding="se2_fourier")
# tests/test_decode.py:310 (float32) and :434 (int8 caches)
TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
       "int8": dict(atol=8e-2, rtol=8e-2)}
MATRIX = [("float32", "plain"), ("float32", "ref"), ("int8", "plain"),
          ("int8", "ref")]


@pytest.fixture(scope="module")
def models():
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(
        **MODEL_KW, num_actions=SCEN_J.num_actions, attn_impl="ref"))
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(0))
    tmodel = tsim.AgentSimModel(tsim.AgentSimConfig(
        **MODEL_KW, num_actions=SCEN.num_actions), device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _server(tmodel, num_slots=2, cache_dtype="float32", impl=None,
            registry=obs.NULL):
    return SimServer(tmodel, SCEN, num_slots=num_slots,
                     cache_dtype=cache_dtype, decode_impl=impl, device="cpu",
                     registry=registry)


# -- (a) the admission primitives --------------------------------------------

def _random_cache(jmodel, dtype, rng):
    """A 2-slot, 26-row cache of random values in the reference's layout
    (numpy): the stale rows admission must leave alone."""
    out = {}
    for k, v in jmodel.init_cache(2, 26, dtype).items():
        v = np.asarray(v)
        if v.dtype == np.int8:
            out[k] = rng.integers(-128, 128, v.shape).astype(np.int8)
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = rng.integers(0, 5, v.shape).astype(v.dtype)
        else:
            out[k] = rng.standard_normal(v.shape).astype(v.dtype)
    return out


def _assert_rows_close(got, want, dtype, what):
    """float32 rows at the decode tolerance; int8 rows dequantized."""
    if "k_scale" in want:
        for key in ("k", "v"):
            g = got[key].astype(np.float32) * got[f"{key}_scale"][..., None]
            w = want[key].astype(np.float32) * want[f"{key}_scale"][..., None]
            np.testing.assert_allclose(g, w, **TOL[dtype],
                                       err_msg=f"{what} {key}")
    else:
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key], want[key], **TOL[dtype],
                                       err_msg=f"{what} {key}")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_admit_map_and_install_slot_rows_match_reference(models, dtype):
    """``admit_map`` on a 1-slot sub-cache, installed over slot 1 of a
    cache full of stale values: rows [0, M), their times (0), segment ids
    (0 where map_valid, else -1) and the cursor (M) match the JAX
    functions; every other row is left exactly as it was."""
    jmodel, jparams, tmodel = models
    rng = np.random.default_rng(5)
    scene = dict(generate_scene("roundabout", 3, 0, SCEN).tensors)
    scene["map_valid"] = scene["map_valid"].copy()
    scene["map_valid"][-3:] = False              # both segment ids occur
    mf, mp, mv = (scene[k][None] for k in ("map_feats", "map_pose",
                                            "map_valid"))
    m = SCEN.num_map
    stale = _random_cache(jmodel, dtype, rng)

    _, jsub = jmodel.admit_map(jparams, jmodel.init_cache(1, m, dtype), mf,
                               mp, mv, impl="xla")
    want = {k: np.asarray(v) for k, v in jsim.install_slot_rows(
        {k: jax.numpy.asarray(v) for k, v in stale.items()}, jsub, 1,
        m).items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in stale.items()}
    _, sub = tmodel.admit_map(tmodel.init_cache(1, m, dtype),
                              *map(torch.from_numpy, (mf, mp, mv)))
    got = {k: v.numpy() for k, v in
           tsim.install_slot_rows(cache, sub, 1, m).items()}

    live = {k: v[:, 1, :, :m] for k, v in got.items()
            if k in ("k", "v", "k_scale", "v_scale")}
    _assert_rows_close(live, {k: want[k][:, 1, :, :m] for k in live}, dtype,
                       "admitted rows")
    np.testing.assert_array_equal(got["times"][1, :m], np.zeros(m))
    np.testing.assert_array_equal(got["seg"][1, :m],
                                  np.where(scene["map_valid"], 0, -1))
    for key in ("times", "seg", "cursor"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["cursor"].tolist() == [stale["cursor"][0], m]
    for key in ("k", "v", "k_scale", "v_scale", "times", "seg"):
        if key not in got:
            continue
        untouched = np.ones(got[key].shape, bool)
        if got[key].ndim == 2:
            untouched[1, :m] = False
        else:
            untouched[:, 1, :, :m] = False
        np.testing.assert_array_equal(got[key][untouched],
                                      stale[key][untouched], err_msg=key)


# -- (b) the two servers through admission and the prefill ticks -------------

def _state(srv, key):
    return np.asarray(srv.state[key])


def _compare_slot(jsrv, tsrv, si, dtype, what):
    """Slot ``si`` after a teacher tick: logits and live cache rows at the
    decode tolerances, the teacher-forced state and the row metadata
    exactly."""
    np.testing.assert_allclose(_state(tsrv, "logits")[si],
                               _state(jsrv, "logits")[si], **TOL["float32"],
                               err_msg=f"{what} logits")
    for key in ("pose", "speed", "proto", "valid"):
        np.testing.assert_array_equal(_state(tsrv, key)[si],
                                      _state(jsrv, key)[si],
                                      err_msg=f"{what} {key}")
    cur = int(np.asarray(jsrv.cache["cursor"])[si])
    assert int(tsrv.cache["cursor"][si]) == cur, what
    live = {}
    for name, srv in (("got", tsrv), ("want", jsrv)):
        live[name] = {k: np.asarray(v)[:, si, :, :cur]
                      for k, v in srv.cache.items()
                      if k in ("k", "v", "k_scale", "v_scale")}
    _assert_rows_close(live["got"], live["want"], dtype, what)
    for key in ("times", "seg"):
        np.testing.assert_array_equal(np.asarray(tsrv.cache[key])[si, :cur],
                                      np.asarray(jsrv.cache[key])[si, :cur],
                                      err_msg=f"{what} {key}")


def _without_compilations(stats):
    return {k: v for k, v in stats.items() if not k.endswith("compilations")}


@pytest.fixture(scope="module", params=["float32", "int8"])
def prefill_run(request, models):
    """Both servers, 2 slots, the same requests: uids 0 and 1 admitted,
    two prefill ticks, uid 1 evicted mid-prefill and uid 2 admitted into
    its slot; six ticks in all, then drained. Slots are compared after
    every tick in which they were teacher-forced; the servers' host
    bookkeeping after every tick. Returns what the tests read."""
    dtype = request.param
    jmodel, jparams, tmodel = models
    jreg, treg = jobs.Registry(), obs.Registry()
    jsrv = JServer(jmodel, jparams, SCEN_J, num_slots=2, cache_dtype=dtype,
                   decode_impl="xla", registry=jreg)
    tsrv = _server(tmodel, cache_dtype=dtype, registry=treg)
    scenes = generate_mixed(3, 0, 3, SCEN)
    t_hist = 4

    def submit(uid, scene):
        for cls, srv in ((JRequest, jsrv), (SceneRequest, tsrv)):
            srv.submit(cls(uid=uid, tensors=scene.tensors, t_hist=t_hist,
                           seed=7, scene_id=uid))

    submit(0, scenes[0])
    submit(1, scenes[1])
    compared = []
    for tick in range(6):
        if tick == 2:
            assert jsrv.evict(1) and tsrv.evict(1)
            submit(2, scenes[2])
        steps = [s.t for s in tsrv.slots]        # the steps this tick runs
        for srv in (jsrv, tsrv):
            assert srv.tick()
        for si, slot in enumerate(tsrv.slots):
            if tick == 0 or (slot.req is not None and steps[si] < t_hist):
                _compare_slot(jsrv, tsrv, si, dtype, f"tick {tick} slot {si}")
                compared.append((tick, si))
        assert _without_compilations(tsrv.stats()) == \
            _without_compilations(jsrv.stats()), tick
        assert tsrv.postmortem_state()["slots"] == \
            jsrv.postmortem_state()["slots"], tick
    for srv in (jsrv, tsrv):
        srv.run_until_drained()
    return dict(jsrv=jsrv, tsrv=tsrv, jreg=jreg, treg=treg,
                compared=compared)


def test_prefill_ticks_match_reference_server(prefill_run):
    """Every slot-tick before sampling was compared, through the
    mid-prefill eviction and the re-admission into the freed slot; the
    drained servers' bookkeeping agrees too."""
    run = prefill_run
    # ticks 0-3 for slot 0 (uid 0's four history steps), slot 1 for uid 1's
    # two and uid 2's four
    assert sorted(run["compared"]) == [(0, 0), (0, 1), (1, 0), (1, 1),
                                       (2, 0), (2, 1), (3, 0), (3, 1),
                                       (4, 1), (5, 1)]
    jsrv, tsrv = run["jsrv"], run["tsrv"]
    assert _without_compilations(tsrv.stats()) == \
        _without_compilations(jsrv.stats())
    assert tsrv.stats()["tick_compilations"] == 0.0
    jpm, tpm = jsrv.postmortem_state(), tsrv.postmortem_state()
    for key in ("slots", "queued_uids", "done_uids", "pending_drains"):
        assert tpm[key] == jpm[key], key
    assert sorted(tsrv.done) == [0, 2]
    assert all(r.status == "ok" for r in tsrv.done.values())


def test_closed_loop_lanes_match_reference_server(prefill_run, models):
    """Past the history the two servers sample: lanes 0 and 2 (lane 2
    admitted into the slot freed mid-prefill) roll out closed loop, each
    keyed fold_in(fold_in(key(7), uid), 0). Their actions equal the
    reference server's, except from a tick where the top two perturbed
    scores lie within NEAR_TIE; their futures agree up to that tick."""
    jsrv, tsrv = prefill_run["jsrv"], prefill_run["tsrv"]
    dtype = "int8" if "k_scale" in tsrv.cache else "float32"
    scenes = generate_mixed(3, 0, 3, SCEN)
    gaps = score_gaps(models[2], SCEN, scenes, 4, 1, 7, cache_dtype=dtype)
    uids = (0, 2)
    for uid in uids:
        assert tsrv.done[uid].status == "ok"
    got = np.stack([tsrv.done[u].actions for u in uids])[:, None]
    want = np.stack([np.asarray(jsrv.done[u].actions) for u in uids])[:, None]
    diverged = diverged_lanes(got, want, gaps[list(uids)])
    for i, uid in enumerate(uids):
        upto = diverged.get((i, 0), got.shape[2])
        np.testing.assert_allclose(
            tsrv.done[uid].future[:upto],
            np.asarray(jsrv.done[uid].future)[:upto], **TOL[dtype],
            err_msg=f"lane {uid}")
    assert len(diverged) <= 1, diverged


def _names(snapshot, events):
    names = {(kind, inst["name"]) for kind in ("counters", "gauges",
                                               "histograms")
             for inst in snapshot[kind]}
    names |= {("events", e["name"]) for e in events}
    # the cost gauges differ on purpose: the port counts a first call, with
    # no compile times and a kernel_flops gauge of its own (the names are
    # held in tests/test_torch_cost.py)
    return {n for n in names if not n[1].startswith("cost.")}


def test_telemetry_names_match_reference(prefill_run):
    run = prefill_run
    want = _names(run["jreg"].snapshot(), run["jreg"].events())
    got = _names(run["treg"].snapshot(), run["treg"].events())
    assert got == want
    assert ("histograms", "sim_server.first_action.seconds") in got
    assert ("events", "sim_server.evict") in got
    snap = {c["name"]: c["value"] for c in run["treg"].snapshot()["counters"]}
    assert snap["sim_server.tick_traces"] == 0
    assert snap["sim_server.admitted"] == 3 and snap["sim_server.evicted"] == 1


# -- (c) the gauntlet, port against port -------------------------------------

def _solo(tmodel, scene, cache_dtype, impl, seed=9, t_hist=T_HIST):
    """The lane alone in a fresh 2-slot server: what every schedule must
    reproduce bit for bit."""
    srv = _server(tmodel, cache_dtype=cache_dtype, impl=impl)
    srv.submit(SceneRequest(uid=0, tensors=scene, t_hist=t_hist, seed=seed,
                            scene_id=0))
    return srv.run_until_drained()[0]


@pytest.mark.parametrize("cache_dtype,impl", MATRIX,
                         ids=[f"{d}-{i}" for d, i in MATRIX])
def test_recycled_slot_bitwise_equal_to_solo(models, cache_dtype, impl):
    """The reference's churn gauntlet: fill both slots with evictees of a
    shorter horizon, evict one mid-prefill, let the other retire, scribble
    every stale row with NaN-laced garbage, then admit a noisy neighbour
    and the victim (into slot 1, where the solo run used slot 0). The
    victim's actions, poses and metrics are bitwise those of the victim
    alone in a fresh server, and (on the CPU) of a fresh engine."""
    tmodel = models[2]
    victim = generate_scene("signalized_intersection", 40, 0, SCEN)
    solo = _solo(tmodel, victim, cache_dtype, impl)

    srv = _server(tmodel, cache_dtype=cache_dtype, impl=impl)
    evictees = generate_mixed(7, 100, 2, SCEN)
    srv.submit(SceneRequest(uid=100, tensors=evictees[0], t_hist=2,
                            t_total=4, seed=1, scene_id=50))
    srv.submit(SceneRequest(uid=101, tensors=evictees[1], t_hist=2,
                            t_total=4, seed=1, scene_id=51))
    srv.tick()                                    # both slots mid-prefill
    assert srv.evict(101)                         # mid-prefill eviction
    for _ in range(4):                            # uid=100 retires (t_total)
        srv.tick()
    assert all(s.req is None for s in srv.slots)
    assert srv.admitted == 2 and srv.evicted == 1
    srv.flush()
    scribble_stale_rows(srv.cache, np.zeros(2, np.int32), srv.max_len,
                        seed=3)
    assert torch.isnan(srv.cache["v" if cache_dtype == "float32"
                                 else "v_scale"]).any()

    srv.submit(SceneRequest(uid=1, tensors=evictees[0], t_hist=2, seed=2,
                            scene_id=77))
    srv.submit(SceneRequest(uid=0, tensors=victim, t_hist=T_HIST, seed=9,
                            scene_id=0))
    srv.tick()
    assert srv.slots[1].req.uid == 0
    done = srv.run_until_drained()
    assert sorted(done) == [0, 1, 100]
    label = f"({cache_dtype}/{impl})"
    assert_bit_identical(done[0].actions, solo.actions, f"actions {label}")
    assert_bit_identical(done[0].future, solo.future, f"poses {label}")
    eng = RolloutEngine(tmodel, SCEN, num_slots=1, cache_dtype=cache_dtype,
                        decode_impl=impl, device="cpu")
    fut = eng.run([victim], t_hist=T_HIST, n_samples=1, seed=9)
    assert_bit_identical(done[0].future, fut[0, 0], f"engine poses {label}")
    assert_bit_identical(done[0].actions, eng.last_actions[0, 0],
                         f"engine actions {label}")
    ecfg = EvalConfig(t_hist=T_HIST, n_samples=1)
    m_solo = scene_metrics(SCEN, ecfg, victim, solo.future[None])
    m_srv = scene_metrics(SCEN, ecfg, victim, done[0].future[None])
    for k in METRICS:
        assert (m_srv[k] == m_solo[k]
                or (np.isnan(m_srv[k]) and np.isnan(m_solo[k]))), k


def test_mid_prefill_eviction_frees_slot_for_identical_successor(models):
    tmodel = models[2]
    victim = generate_scene("onramp_merge", 41, 0, SCEN)
    solo = _solo(tmodel, victim, "float32", "plain")
    srv = _server(tmodel, num_slots=1)
    srv.submit(SceneRequest(uid=5, tensors=generate_scene("highway", 1, 0,
                                                          SCEN),
                            t_hist=4, seed=3, scene_id=5))
    srv.tick()
    srv.tick()                                    # 2 of 4 prefill ticks in
    assert srv.evict(5)
    srv.submit(SceneRequest(uid=0, tensors=victim, t_hist=T_HIST, seed=9,
                            scene_id=0))
    done = srv.run_until_drained()
    assert sorted(done) == [0]
    assert_bit_identical(done[0].actions, solo.actions, "actions after evict")
    assert_bit_identical(done[0].future, solo.future, "poses after evict")


# -- (d) the retired slot's clamped write ------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_retired_slot_write_clamps_like_reference(models, dtype):
    """A slot retired with its cursor at max_len (M + 6 A = 26, not rounded
    since <= 128) is still decoded every tick: its A rows land at
    [max_len - A, max_len), as the reference's dynamic_update_slice puts
    them, and nothing raises. The live slot beside it is unaffected."""
    jmodel, jparams, tmodel = models
    s = 26
    assert SCEN.num_map + SCEN.num_steps * SCEN.num_agents == s
    rng = np.random.default_rng(8)
    stale = _random_cache(jmodel, dtype, rng)
    stale["cursor"] = np.asarray([s, 11], np.int32)
    a = SCEN.num_agents
    feats = rng.standard_normal((2, a, 8)).astype(np.float32)
    pose = (rng.standard_normal((2, a, 3)) * 5).astype(np.float32)
    valid = np.ones((2, a), bool)
    t = np.asarray([5, 1], np.int32)
    jlog, jc = jmodel.step(jparams, {k: jax.numpy.asarray(v)
                                     for k, v in stale.items()},
                           feats, pose, valid, t, impl="xla")
    cache = {k: torch.from_numpy(v.copy()) for k, v in stale.items()}
    tlog, tc = tmodel.step(cache, *map(torch.from_numpy,
                                       (feats, pose, valid, t)))
    np.testing.assert_allclose(tlog.numpy()[1], np.asarray(jlog)[1],
                               **TOL["float32"])
    want = {k: np.asarray(v) for k, v in jc.items()}
    got = {k: v.numpy() for k, v in tc.items()}
    for si, rows in ((0, slice(s - a, s)), (1, slice(11, 11 + a))):
        _assert_rows_close(
            {k: got[k][:, si, :, rows] for k in got if k[0] in "kv"},
            {k: want[k][:, si, :, rows] for k in got if k[0] in "kv"},
            dtype, f"slot {si}")
        for key in ("times", "seg"):
            np.testing.assert_array_equal(got[key][si, rows],
                                          want[key][si, rows])
    np.testing.assert_array_equal(got["times"][0, s - a:], t[0] + 1)
    np.testing.assert_array_equal(got["cursor"], want["cursor"])
    assert got["cursor"].tolist() == [s + a, 11 + a]


# -- (e) serve_scenes against the engine --------------------------------------

def test_serve_scenes_matches_engine_batch(models):
    """Futures shaped and keyed like ``RolloutEngine.run``, bitwise on the
    CPU (see the module docstring for the card), even with slots << lanes
    and lanes of a scene retiring at max_len beside live ones."""
    tmodel = models[2]
    scenes = generate_mixed(11, 0, 3, SCEN)
    eng = RolloutEngine(tmodel, SCEN, num_slots=3, device="cpu")
    ref = eng.run(scenes, t_hist=T_HIST, n_samples=2, seed=13)
    srv = _server(tmodel)
    got = serve_scenes(srv, scenes, t_hist=T_HIST, n_samples=2, seed=13)
    assert got.shape == ref.shape == (3, 2, SCEN.num_steps - T_HIST,
                                      SCEN.num_agents, 3)
    assert_bit_identical(got, ref, "serve_scenes futures")
    for uid, res in srv.done.items():
        assert_bit_identical(res.actions,
                             eng.last_actions[uid // 2, uid % 2],
                             f"lane {uid} actions")
    assert not srv.queue and not any(s.req for s in srv.slots)


# -- (f) schedule invariance ---------------------------------------------------

N_PROP_SCENES = 3


def _check_schedule_invariant(models, order_seed, rate, num_slots):
    """Any admission schedule of one scene set (permuted arrival order,
    Poisson gaps, any slot count) gives the same per-scene futures and
    metrics as the engine, bitwise."""
    tmodel = models[2]
    scenes = generate_mixed(21, 0, N_PROP_SCENES, SCEN)
    eng = RolloutEngine(tmodel, SCEN, num_slots=2, device="cpu")
    ref = eng.run(scenes, t_hist=T_HIST, n_samples=1, seed=17)
    order = np.random.default_rng(order_seed).permutation(len(scenes))
    srv = _server(tmodel, num_slots=num_slots)
    reqs = [SceneRequest(uid=int(sid), tensors=scenes[sid], t_hist=T_HIST,
                         seed=17, scene_id=int(sid)) for sid in order]
    out = poisson_drive(srv, reqs, rate=rate, seed=order_seed)
    assert sorted(srv.done) == list(range(len(scenes)))
    assert out["ticks"] == srv.ticks and len(out["arrival_ticks"]) == 3
    ecfg = EvalConfig(t_hist=T_HIST, n_samples=1)
    for sid, scene in enumerate(scenes):
        what = (f"scene {sid} (order_seed={order_seed}, rate={rate}, "
                f"slots={num_slots})")
        assert_bit_identical(srv.done[sid].future, ref[sid, 0], what)
        m_ref = scene_metrics(SCEN, ecfg, scene, ref[sid, 0][None])
        m_got = scene_metrics(SCEN, ecfg, scene, srv.done[sid].future[None])
        for k in METRICS:
            assert (m_got[k] == m_ref[k]
                    or (np.isnan(m_got[k]) and np.isnan(m_ref[k]))), (what, k)


try:
    from hypothesis import given, settings, strategies as st

    # bounds representable in float32 (0.25 and 3.0), which a width=32
    # strategy requires
    @settings(max_examples=4, deadline=None, derandomize=True)
    @given(order_seed=st.integers(0, 2 ** 16),
           rate=st.floats(0.25, 3.0, allow_nan=False, width=32),
           num_slots=st.integers(1, 3))
    def test_metrics_invariant_to_arrival_schedule(models, order_seed, rate,
                                                   num_slots):
        _check_schedule_invariant(models, order_seed, rate, num_slots)

except ImportError:            # hypothesis is an optional dev dependency
    @pytest.mark.parametrize("order_seed,rate,num_slots",
                             [(0, 1.0, 2), (7, 0.25, 1), (123, 2.5, 3)])
    def test_metrics_invariant_to_arrival_schedule(models, order_seed, rate,
                                                   num_slots):
        _check_schedule_invariant(models, order_seed, rate, num_slots)


# -- (g) quarantine -------------------------------------------------------------

def _serve(tmodel, poison_tick=None, registry=obs.NULL, cache_dtype="float32"):
    srv = _server(tmodel, cache_dtype=cache_dtype, registry=registry)
    for i, scene in enumerate(generate_mixed(5, 0, 3, SCEN)):
        srv.submit(SceneRequest(uid=i, tensors=scene, t_hist=T_HIST,
                                seed=11, scene_id=i))
    tick = 0
    while srv.queue or any(s.req for s in srv.slots):
        if tick == poison_tick:
            chaos.poison_server_slot(srv, 0)
        srv.tick()
        tick += 1
        assert tick < 1000
    srv.flush()
    return srv


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_quarantine_keeps_healthy_lanes_and_next_tenant_bitwise(
        models, cache_dtype):
    tmodel = models[2]
    ref = _serve(tmodel, cache_dtype=cache_dtype)
    assert all(r.status == "ok" for r in ref.done.values())
    reg = obs.Registry()
    srv = _serve(tmodel, poison_tick=4, registry=reg,
                 cache_dtype=cache_dtype)
    victim = srv.done[0]
    assert (victim.status, victim.reason) == ("failed", "nonfinite_pose")
    assert srv.quarantined == 1 and srv.stats()["quarantined"] == 1.0
    assert reg.counter("sim_server.quarantined").value == 1
    assert [e["name"] for e in reg.events()].count(
        "sim_server.quarantine") == 1
    healthy = sorted(u for u, r in srv.done.items() if r.status == "ok")
    assert healthy == [1, 2]
    for uid in healthy:
        assert_bit_identical(srv.done[uid].future, ref.done[uid].future,
                             f"lane {uid} poses under quarantine")
        assert_bit_identical(srv.done[uid].actions, ref.done[uid].actions,
                             f"lane {uid} actions under quarantine")
    # the scrubbed slot's next tenant reproduces the fault-free result for
    # the same request
    srv.submit(SceneRequest(uid=7, tensors=generate_mixed(5, 0, 3, SCEN)[2],
                            t_hist=T_HIST, seed=11, scene_id=2))
    srv.run_until_drained()
    assert srv.done[7].status == "ok"
    assert_bit_identical(srv.done[7].future, ref.done[2].future,
                         "recycled-slot tenant poses")


def test_serve_scenes_raises_on_quarantine(models):
    srv = _server(models[2])
    orig_tick, calls = srv.tick, {"n": 0}

    def poisoning_tick():
        if calls["n"] == 4:
            chaos.poison_server_slot(srv, 0)
        calls["n"] += 1
        return orig_tick()

    srv.tick = poisoning_tick
    with pytest.raises(RuntimeError, match="quarantined"):
        serve_scenes(srv, generate_mixed(5, 0, 2, SCEN), t_hist=T_HIST,
                     n_samples=1, seed=11)


# -- host bookkeeping -----------------------------------------------------------

def test_submit_validates_and_drain_lag_zero_is_bitwise(models):
    tmodel = models[2]
    srv = _server(tmodel)
    scene = generate_scene("highway", 2, 0, SCEN)
    with pytest.raises(ValueError, match="slab width"):
        srv.submit(SceneRequest(uid=0, tensors=scene, t_hist=2, t_total=7))
    with pytest.raises(ValueError, match="t_hist"):
        srv.submit(SceneRequest(uid=0, tensors=scene, t_hist=0))
    srv.submit(SceneRequest(uid=0, tensors=scene, t_hist=2))
    with pytest.raises(ValueError, match="duplicate"):
        srv.submit(SceneRequest(uid=0, tensors=scene, t_hist=2))
    assert srv.evict(0) and not srv.evict(0)      # queued, then gone
    sync = SimServer(tmodel, SCEN, num_slots=2, drain_lag=0, device="cpu",
                     registry=obs.NULL)
    lagged = _server(tmodel)
    for s in (sync, lagged):
        s.submit(SceneRequest(uid=3, tensors=scene, t_hist=2, seed=4))
        s.tick()
        s.tick()
        s.tick()
    assert sync.postmortem_state()["pending_drains"] == 0
    assert lagged.postmortem_state()["pending_drains"] == 1
    for s in (sync, lagged):
        s.run_until_drained()
    assert_bit_identical(sync.done[3].future, lagged.done[3].future,
                         "drain_lag 0 vs 1")


# -- (i) the launcher ------------------------------------------------------------

def test_serve_sim_launcher_on_cpu(tmp_path):
    """``python -m repro_torch.launch.serve_sim --device cpu`` at its
    defaults exits 0; its postmortem bundle renders and its trace renders
    through obs_report."""
    pm, trace = tmp_path / "pm.json", tmp_path / "serve.trace.jsonl"
    # one intra-op thread: with the other cores busy (parallel test
    # workers), eight OpenMP threads made this run 9x slower (6.8 s against
    # 53.9 s with seven busy cores of eight)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_sim", "--device",
         "cpu", "--postmortem-out", str(pm), "--telemetry-out", str(trace)],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "drained 32/32 scenes" in out.stderr
    text = render_postmortem(json.loads(pm.read_text()))
    assert "sim_server slots" in text and "manual" in text
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.obs_report", str(trace)],
        env=env, capture_output=True, text=True, timeout=60)
    assert report.returncode == 0, report.stderr
    assert "sim_server.tick" in report.stdout
