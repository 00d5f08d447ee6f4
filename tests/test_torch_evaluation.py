"""Parity: the port's closed-loop evaluation (``runtime/evaluation.py``)
against the JAX reference, on the CPU.

``scene_metrics`` is numpy on both sides, so on the same futures the two
agree to 1e-12. Per-family tables are compared teacher-forced (the
reference engine's sampled actions replayed through the port's kinematics
and decode) and free-running: both packages sample the ``jax.random``
stream, so ``evaluate_families``' tables equal the reference's in every
family none of whose lanes diverged at a near-tie (top-two perturbed
scores within 1e-5, where the two frameworks' float32 ``log`` may pick
apart). The port's ``evaluate_families`` also runs end to end on the CPU
over all seven families at two slot counts, and SE(2)
property tests hold the port's action probabilities under a global re-pose
of every family's scenes to the reference's: se2_fourier within its
truncation bound, se2_repr and rope2d (translations only) within 5e-4
(tests/test_se2.py's bound for the exact encodings), and the absolute
baseline moving by more than 1e-4 (its bound there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs  # noqa: E402
from repro import scenarios as jscen  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.runtime import evaluation as jeval  # noqa: E402
from repro.runtime.rollout import RolloutEngine as JaxEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch import scenarios as tscen  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime import evaluation as teval  # noqa: E402
from repro_torch.runtime import rollout as trollout  # noqa: E402
from test_torch_serving_utils import diverged_lanes, score_gaps  # noqa: E402

SCEN_KW = dict(num_map=8, num_agents=3, num_steps=7)
T_HIST = 3
N_SAMPLES = 2
SCENES_PER_FAMILY = 2
CFG = dict(d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
           fourier_terms=8)
FAMILIES = tscen.registry.names()
RATES = ("miss_rate", "collision_rate", "offroad_rate",
         "kinematic_infeasibility_rate")
# the largest change of any valid agent's action probability under a
# global re-pose within the ranges below, port and reference alike: the
# truncation of the F = 8 Fourier basis, not a fault. Measured on the CPU
# at this arch: at most 2.7e-2 over 47 transforms (|x|, |y| <= 30 m, any
# angle), with the port's and the reference's shifts within 3.0e-7 of
# each other
INVARIANCE_BOUND = 5e-2
EXACT_BOUND, ABSOLUTE_MOVES = 5e-4, 1e-4


@pytest.fixture(scope="module")
def setup():
    scen_t = tscen.ScenarioConfig(**SCEN_KW)
    scen_j = jscen.ScenarioConfig(**SCEN_KW)
    jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(
        **CFG, num_actions=scen_j.num_actions, decode_impl="xla"))
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(2))
    tmodel = tsim.AgentSimModel(
        tsim.AgentSimConfig(**CFG, num_actions=scen_t.num_actions),
        device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    jeng = JaxEngine(jmodel, jparams, scen_j, registry=obs.NULL,
                     num_slots=len(FAMILIES) * SCENES_PER_FAMILY * N_SAMPLES)
    scenes_t = [tscen.generate_scene(f, 5, i, scen_t)
                for f in FAMILIES for i in range(SCENES_PER_FAMILY)]
    scenes_j = [jscen.generate_scene(f, 5, i, scen_j)
                for f in FAMILIES for i in range(SCENES_PER_FAMILY)]
    return dict(scen_t=scen_t, scen_j=scen_j, jmodel=jmodel, jparams=jparams,
                tmodel=tmodel, jeng=jeng, scenes_t=scenes_t,
                scenes_j=scenes_j)


def test_scene_metrics_match_reference_on_the_same_futures(setup):
    """Futures near the ground truth, far from it (misses, collisions,
    off-road and infeasible steps), and with an agent dropping out."""
    rng = np.random.default_rng(0)
    ecfg_t = teval.EvalConfig(t_hist=T_HIST)
    ecfg_j = jeval.EvalConfig(t_hist=T_HIST)
    for st, sj in zip(setup["scenes_t"], setup["scenes_j"]):
        gt = sj.tensors["agent_pose"][T_HIST:]
        for scale in (0.3, 4.0, 40.0):
            fut = (gt[None] + rng.normal(scale=scale, size=(3,) + gt.shape)
                   ).astype(np.float32)
            pairs = [(st, sj)]
            dropped_t, dropped_j = (tscen.Scene(s.family, dict(s.tensors),
                                                s.lane_graph)
                                    for s in (st, sj))
            for s in (dropped_t, dropped_j):
                valid = s.tensors["agent_valid"].copy()
                valid[T_HIST + 2:, 0] = False
                s.tensors["agent_valid"] = valid
            pairs.append((dropped_t, dropped_j))
            for a, b in pairs:
                got = teval.scene_metrics(setup["scen_t"], ecfg_t, a, fut)
                want = jeval.scene_metrics(setup["scen_j"], ecfg_j, b, fut)
                assert got.keys() == want.keys()
                for key in want:
                    np.testing.assert_allclose(got[key], want[key], rtol=0,
                                               atol=1e-12,
                                               err_msg=f"{sj.family} {key}")
    assert teval.METRICS == jeval.METRICS
    assert teval.EvalConfig() == teval.EvalConfig(**vars(jeval.EvalConfig()))


class _Futures:
    """The engine surface ``evaluate_scenes`` reads: ``run`` and ``scen``."""

    def __init__(self, futures, scen):
        self.futures, self.scen = futures, scen

    def run(self, scenes, *, t_hist, n_samples, seed):
        assert len(scenes) == self.futures.shape[0]
        assert (t_hist, n_samples) == (T_HIST, N_SAMPLES)
        return self.futures


def test_teacher_forced_tables_match_reference(setup):
    """The reference engine's rollouts and tables over a mixed seven-family
    scene list; the port's kinematics and decode replay its sampled
    actions, and the port's tables over those futures agree: min_ade to
    1e-4 and every rate exactly (no future here lies within float32 error
    of a metric's threshold)."""
    scen_t, tmodel, scenes = setup["scen_t"], setup["tmodel"], \
        setup["scenes_t"]
    ecfg = jeval.EvalConfig(t_hist=T_HIST, n_samples=N_SAMPLES, seed=3)
    want = jeval.evaluate_scenes(setup["jeng"], setup["scenes_j"], ecfg)
    acts = setup["jeng"].last_actions                  # (S, K, T_fut, A)

    lanes = np.repeat(np.arange(len(scenes)), N_SAMPLES)
    teng = trollout.RolloutEngine(tmodel, scen_t, device="cpu",
                                  num_slots=len(lanes))
    hist = {key: torch.from_numpy(np.stack(
        [scenes[i].tensors[key][:T_HIST] if key.startswith("agent")
         else scenes[i].tensors[key] for i in lanes]))
        for key in ("map_feats", "map_pose", "map_valid", "agent_feats",
                    "agent_pose", "agent_valid")}
    with torch.no_grad():
        cache = teng.init_cache()
        _, cache = tmodel.prefill(cache, hist)
        pose = hist["agent_pose"][:, -1]
        speed = hist["agent_feats"][:, -1, :, 0] * 10.0
        feats, valid = hist["agent_feats"][:, -1], hist["agent_valid"][:, -1]
        flat_acts = torch.from_numpy(
            acts.reshape(len(lanes), -1, scen_t.num_agents)).long()
        poses = []
        for ti, t in enumerate(range(T_HIST, scen_t.num_steps)):
            cache, _, pose, speed = teng._advance(
                cache, flat_acts[:, ti], pose, speed, feats, valid, t)
            poses.append(pose.numpy())
    futures = np.stack(poses, 1).reshape(len(scenes), N_SAMPLES,
                                         -1, scen_t.num_agents, 3)
    got = teval.evaluate_scenes(_Futures(futures, scen_t), scenes,
                                teval.EvalConfig(**vars(ecfg)))
    assert sorted(got) == sorted(want) == sorted(FAMILIES + ["overall"])
    for fam, row in want.items():
        assert got[fam].keys() == row.keys()
        np.testing.assert_allclose(got[fam]["min_ade"], row["min_ade"],
                                   atol=1e-4, rtol=0, err_msg=fam)
        for key in RATES + ("n_scenes", "n_agents"):
            np.testing.assert_equal(got[fam][key], row[key],
                                    err_msg=f"{fam} {key}")


def test_free_running_tables_match_reference(setup):
    """``evaluate_families`` in both packages over the seven families:
    the per-family tables agree (min_ade to 1e-4, every rate and count
    exactly) wherever no lane of the family diverged, and a lane diverges
    only at a near-tie, which the engines' actions show."""
    scen_t, scen_j = setup["scen_t"], setup["scen_j"]
    tmodel = setup["tmodel"]
    ecfg = jeval.EvalConfig(t_hist=T_HIST, n_samples=N_SAMPLES, seed=4)
    want = jeval.evaluate_families(setup["jmodel"], setup["jparams"], scen_j,
                                   ecfg, n_scenes_per_family=1)
    got = teval.evaluate_families(tmodel, scen_t,
                                  teval.EvalConfig(**vars(ecfg)),
                                  n_scenes_per_family=1, device="cpu")
    # the same scenes and lanes through both engines, to find divergence
    scenes = [tscen.generate_scene(f, 777, 0, scen_t) for f in FAMILIES]
    slots = len(scenes) * N_SAMPLES
    teng = trollout.RolloutEngine(tmodel, scen_t, device="cpu",
                                  num_slots=slots)
    teng.run(scenes, t_hist=T_HIST, n_samples=N_SAMPLES, seed=4)
    jeng = JaxEngine(setup["jmodel"], setup["jparams"], scen_j,
                     registry=obs.NULL, num_slots=slots)
    jeng.run([s.tensors for s in scenes], t_hist=T_HIST,
             n_samples=N_SAMPLES, seed=4)
    gaps = score_gaps(tmodel, scen_t, scenes, T_HIST, N_SAMPLES, 4)
    diverged = diverged_lanes(teng.last_actions, jeng.last_actions, gaps)
    off = {scenes[si].family for si, _ in diverged}
    assert len(off) <= 1, diverged
    assert sorted(got) == sorted(want) == sorted(FAMILIES + ["overall"])
    for fam, row in want.items():
        if fam in off or (fam == "overall" and off):
            continue
        np.testing.assert_allclose(got[fam]["min_ade"], row["min_ade"],
                                   atol=1e-4, rtol=0, err_msg=fam)
        for key in RATES + ("n_scenes", "n_agents"):
            np.testing.assert_equal(got[fam][key], row[key],
                                    err_msg=f"{fam} {key}")


def test_evaluate_families_end_to_end_on_the_cpu(setup):
    scen_t, tmodel = setup["scen_t"], setup["tmodel"]
    ecfg = teval.EvalConfig(t_hist=T_HIST, n_samples=N_SAMPLES, seed=1)
    tables = [teval.evaluate_families(tmodel, scen_t, ecfg,
                                      n_scenes_per_family=SCENES_PER_FAMILY,
                                      num_slots=slots, device="cpu")
              for slots in (4, 7)]
    assert tables[0] == tables[1]
    table = tables[0]
    assert sorted(table) == sorted(FAMILIES + ["overall"])
    for fam, row in table.items():
        want_scenes = SCENES_PER_FAMILY * (len(FAMILIES) if fam == "overall"
                                           else 1)
        assert row["n_scenes"] == want_scenes, fam
        assert row["kinematic_infeasibility_rate"] == 0.0, fam
        for key in ("min_ade", "miss_rate", "collision_rate"):
            assert np.isfinite(row[key]), (fam, key)
    # a subset of families, and the reference's default slot count
    two = teval.evaluate_families(tmodel, scen_t, ecfg,
                                  families=("highway", "roundabout"),
                                  n_scenes_per_family=1, device="cpu")
    assert sorted(two) == ["highway", "overall", "roundabout"]


def test_evaluate_families_refuses_the_cpu_unless_asked(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.evaluate_families(setup["tmodel"], setup["scen_t"],
                                teval.EvalConfig(t_hist=T_HIST),
                                n_scenes_per_family=1)


@pytest.fixture(scope="module")
def table1(setup):
    """(port model, reference model, reference weights) of the three other
    Table-I encodings at the setup's arch, weights shared."""
    out = {}
    for i, enc in enumerate(("absolute", "rope2d", "se2_repr")):
        jmodel = jsim.AgentSimModel(jsim.AgentSimConfig(
            **CFG, num_actions=setup["scen_j"].num_actions, encoding=enc))
        jparams = jmodule.init_params(jmodel.specs(), jax.random.key(10 + i))
        tmodel = tsim.AgentSimModel(tsim.AgentSimConfig(
            **CFG, num_actions=setup["scen_t"].num_actions, encoding=enc),
            device="cpu")
        tmodel.load_state_dict(tparams.from_reference(
            jax.tree.map(np.asarray, jparams)))
        out[enc] = dict(tmodel=tmodel, jmodel=jmodel, jparams=jparams)
    return out


def _action_probs(setup, z, models=None):
    """Action probabilities of every valid agent token, port and reference,
    after re-posing each family's scenes by the global transform z (with
    ``models`` the port and reference models of another encoding)."""
    models = models or setup
    scenes_t = [tscen.transform_scene(s, z) for s in setup["scenes_t"]]
    scenes_j = [jscen.transform_scene(s, z) for s in setup["scenes_j"]]
    keys = ("map_feats", "map_pose", "map_valid", "agent_feats",
            "agent_pose", "agent_valid")
    bt = tscen.stack_scenes(scenes_t)
    bj = jscen.stack_scenes(scenes_j)
    with torch.no_grad():
        pt = torch.softmax(models["tmodel"](
            {k: torch.from_numpy(bt[k]) for k in keys}), -1).numpy()
    logits, _ = models["jmodel"](models["jparams"],
                                {k: jnp.asarray(bj[k]) for k in keys})
    pj = np.asarray(jax.nn.softmax(logits, -1))
    valid = bj["agent_valid"]
    return pt[valid], pj[valid]


def _shifts(setup, z, models=None):
    """The largest change of an action probability under z, port and
    reference, which agree change for change within 1e-5."""
    base_t, base_j = _action_probs(setup, (0.0, 0.0, 0.0), models)
    moved_t, moved_j = _action_probs(setup, z, models)
    np.testing.assert_allclose(moved_t - base_t, moved_j - base_j,
                               atol=1e-5, rtol=0)
    return np.abs(moved_t - base_t).max(), np.abs(moved_j - base_j).max()


def _check_invariance(setup, zx, zy, zth):
    assert max(_shifts(setup, (zx, zy, zth))) < INVARIANCE_BOUND


def _check_table1(setup, table1, zx, zy, zth):
    """se2_repr under z, rope2d under z's translation: within the exact
    encodings' bound; absolute: moved, where z moves the scene enough."""
    assert max(_shifts(setup, (zx, zy, zth), table1["se2_repr"])) \
        < EXACT_BOUND
    assert max(_shifts(setup, (zx, zy, 0.0), table1["rope2d"])) \
        < EXACT_BOUND
    if abs(zx) + abs(zy) > 1.0 or abs(zth) > 0.5:
        assert min(_shifts(setup, (zx, zy, zth), table1["absolute"])) \
            > ABSOLUTE_MOVES


try:
    from hypothesis import given, settings, strategies as st

    # bounds a float32 can represent (width=32 refuses any other)
    _transl = st.floats(min_value=-30.0, max_value=30.0, allow_nan=False,
                        width=32)
    _angle = st.floats(min_value=-float(np.float32(np.pi)),
                       max_value=float(np.float32(np.pi)), allow_nan=False,
                       width=32)

    @settings(max_examples=4, deadline=None, derandomize=True)
    @given(zx=_transl, zy=_transl, zth=_angle)
    def test_action_probs_se2_invariant_all_families(setup, zx, zy, zth):
        _check_invariance(setup, zx, zy, zth)

    @settings(max_examples=3, deadline=None, derandomize=True)
    @given(zx=_transl, zy=_transl, zth=_angle)
    def test_table1_action_probs_under_a_global_repose(setup, table1, zx, zy,
                                                       zth):
        _check_table1(setup, table1, zx, zy, zth)
except ImportError:            # hypothesis is an optional dev dependency
    @pytest.mark.parametrize("zx,zy,zth", [(30.0, 20.0, -2.5),
                                           (-12.0, 4.0, 1.3)])
    def test_action_probs_se2_invariant_all_families(setup, zx, zy, zth):
        _check_invariance(setup, zx, zy, zth)

    @pytest.mark.parametrize("zx,zy,zth", [(30.0, 20.0, -2.5),
                                           (-12.0, 4.0, 1.3)])
    def test_table1_action_probs_under_a_global_repose(setup, table1, zx, zy,
                                                       zth):
        _check_table1(setup, table1, zx, zy, zth)
