"""Parity: the port's scenarios, kinematics and rollout engine against the
JAX reference, on the CPU.

The port samples the reference's ``jax.random`` stream (``repro_torch.prng``:
Threefry keys ``fold_in(fold_in(key(seed), scene), sample)``, folded with
the step each tick, Gumbel-max). So the engine is compared free-running:
the port's ``RolloutEngine.run`` futures equal the reference's in every lane
whose sampled actions agree, and a lane may diverge only at a step where
the top two perturbed scores lie within 1e-5 (the two frameworks' float32
``log`` may differ by an ulp there), which the test checks. The engine is
also compared teacher-forced (the reference's actions fed to the port's
prefill, kinematics and step), and the sampler against softmax
frequencies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import obs  # noqa: E402
from repro import scenarios as jscen  # noqa: E402
from repro.core import kinematics as jkin  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.runtime.rollout import RolloutEngine as JaxEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import scenarios as tscen  # noqa: E402
from repro_torch.core import kinematics as tkin  # noqa: E402
from repro_torch.kernels import categorical as tcat  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.runtime import rollout as trollout  # noqa: E402
from test_torch_serving_utils import diverged_lanes, score_gaps  # noqa: E402

SCEN_KW = dict(num_map=8, num_agents=3, num_steps=7)
T_HIST = 3
CFG = dict(d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
           fourier_terms=8)


@pytest.mark.parametrize("seed,index", [(0, 0), (0, 5), (3, 1), (11, 42)])
def test_freeform_scenes_bit_identical(seed, index):
    cfg_j = jscen.ScenarioConfig(**SCEN_KW)
    cfg_t = tscen.ScenarioConfig(**SCEN_KW)
    want = jscen.generate_scene("freeform", seed, index, cfg_j)
    got = tscen.generate_scene("freeform", seed, index, cfg_t)
    assert got.family == want.family == "freeform"
    assert sorted(got.tensors) == sorted(want.tensors)
    for key, arr in want.tensors.items():
        assert got.tensors[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got.tensors[key], arr, err_msg=key)
    assert len(got.lane_graph.lanes) == len(want.lane_graph.lanes)
    for lt, lj in zip(got.lane_graph.lanes, want.lane_graph.lanes):
        np.testing.assert_array_equal(lt.points, lj.points)
        np.testing.assert_array_equal(lt.headings, lj.headings)


def test_kinematics_matches_reference():
    rng = np.random.default_rng(99)
    pose = rng.normal(scale=20.0, size=(32, 3)).astype(np.float32)
    speed = np.abs(rng.normal(scale=12.0, size=(32,))).astype(np.float32)
    accel = rng.normal(scale=3.0, size=(32,)).astype(np.float32)
    yaw = rng.normal(scale=0.5, size=(32,)).astype(np.float32)
    p_np, s_np = jkin.step_kinematics(pose, speed, accel, yaw)
    p_tn, s_tn = tkin.step_kinematics(pose, speed, accel, yaw)
    np.testing.assert_array_equal(p_tn, p_np)       # same numpy code
    np.testing.assert_array_equal(s_tn, s_np)
    p_t, s_t = tkin.step_kinematics(*map(torch.from_numpy,
                                         (pose, speed, accel, yaw)))
    np.testing.assert_allclose(p_t.numpy(), p_np, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), s_np, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    scen_t = tscen.ScenarioConfig(**SCEN_KW)
    scen_j = jscen.ScenarioConfig(**SCEN_KW)
    jcfg = jsim.AgentSimConfig(**CFG, num_actions=scen_j.num_actions,
                               decode_impl="xla")
    jmodel = jsim.AgentSimModel(jcfg)
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(1))
    tmodel = tsim.AgentSimModel(
        tsim.AgentSimConfig(**CFG, num_actions=scen_t.num_actions),
        device="cpu")
    tmodel.load_state_dict(tparams.from_reference(
        jax.tree.map(np.asarray, jparams)))
    scenes = [tscen.generate_scene("freeform", 0, i, scen_t)
              for i in range(3)]
    return scen_j, scen_t, jmodel, jparams, tmodel, scenes


def test_teacher_forced_rollout_matches_reference(setup):
    """The port's prefill + kinematics + step, fed the reference engine's
    sampled actions, reproduces the reference engine's futures."""
    scen_j, scen_t, jmodel, jparams, tmodel, scenes = setup
    n_samples = 2
    jeng = JaxEngine(jmodel, jparams, scen_j, num_slots=4, registry=obs.NULL)
    want = jeng.run([s.tensors for s in scenes], t_hist=T_HIST,
                    n_samples=n_samples, seed=7)
    acts = jeng.last_actions                     # (S, K, T_fut, A)

    teng = trollout.RolloutEngine(tmodel, scen_t, device="cpu",
                                  num_slots=len(scenes) * n_samples)
    lanes = np.repeat(np.arange(len(scenes)), n_samples)
    hist = {key: torch.from_numpy(np.stack(
        [scenes[i].tensors[key][:T_HIST] if key.startswith("agent")
         else scenes[i].tensors[key] for i in lanes]))
        for key in ("map_feats", "map_pose", "map_valid", "agent_feats",
                    "agent_pose", "agent_valid")}
    cache = teng.init_cache()
    _, cache = tmodel.prefill(cache, hist)
    pose = hist["agent_pose"][:, -1]
    speed = hist["agent_feats"][:, -1, :, 0] * 10.0
    feats, valid = hist["agent_feats"][:, -1], hist["agent_valid"][:, -1]
    flat_acts = torch.from_numpy(acts.reshape(len(lanes), -1,
                                              scen_t.num_agents)).long()
    for ti, t in enumerate(range(T_HIST, scen_t.num_steps)):
        cache, _, pose, speed = teng._advance(cache, flat_acts[:, ti], pose,
                                              speed, feats, valid, t)
        np.testing.assert_allclose(
            pose.numpy().reshape(len(scenes), n_samples, -1, 3),
            want[:, :, ti], atol=1e-4, err_msg=f"tick {t}")


@pytest.mark.parametrize("seed", [7, 2024])
def test_free_running_rollout_matches_reference(setup, seed):
    """``RolloutEngine.run`` closed loop against the reference's: every
    lane's actions and futures equal, except a lane that diverges at a
    near-tie (top-two gap under 1e-5, checked at its first differing
    tick), whose futures are compared up to that tick."""
    scen_j, scen_t, jmodel, jparams, tmodel, scenes = setup
    n_samples = 2
    jeng = JaxEngine(jmodel, jparams, scen_j, num_slots=4, registry=obs.NULL)
    want = jeng.run([s.tensors for s in scenes], t_hist=T_HIST,
                    n_samples=n_samples, seed=seed)
    teng = trollout.RolloutEngine(tmodel, scen_t, device="cpu", num_slots=4)
    got = teng.run(scenes, t_hist=T_HIST, n_samples=n_samples, seed=seed)
    assert got.shape == want.shape
    gaps = score_gaps(tmodel, scen_t, scenes, T_HIST, n_samples, seed)
    diverged = diverged_lanes(teng.last_actions, jeng.last_actions, gaps)
    for si in range(len(scenes)):
        for ki in range(n_samples):
            upto = diverged.get((si, ki), got.shape[2])
            np.testing.assert_allclose(got[si, ki, :upto], want[si, ki, :upto],
                                       atol=1e-4, err_msg=f"lane {si}, {ki}")
    assert len(diverged) <= 1, f"lanes {diverged} diverged at near-ties"


def test_futures_independent_of_slot_count(setup):
    _, scen_t, _, _, tmodel, scenes = setup
    outs, acts = [], []
    for slots in (2, 3):
        eng = trollout.RolloutEngine(tmodel, scen_t, num_slots=slots,
                                     device="cpu")
        outs.append(eng.run(scenes, t_hist=T_HIST, n_samples=2, seed=3))
        acts.append(eng.last_actions)
    assert outs[0].shape == (3, 2, scen_t.num_steps - T_HIST,
                             scen_t.num_agents, 3)
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(acts[0], acts[1])


def test_sampler_frequencies_match_softmax():
    """Threefry Gumbel-max draws each action with its softmax probability:
    60000 independent (lane, step) draws of one 6-way distribution stay
    within 5 standard errors of it."""
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    n_lanes, n_steps = 20000, 3
    keys = trollout.rollout_keys(5, n_lanes, 1)
    draws = torch.cat([tcat.categorical_plain(
        keys, torch.full((n_lanes,), t, dtype=torch.int32),
        logits.expand(n_lanes, 1, -1))[:, 0] for t in range(n_steps)])
    freq = torch.bincount(draws, minlength=6).double() / draws.numel()
    p = torch.softmax(logits.double(), -1)
    se = torch.sqrt(p * (1 - p) / draws.numel())
    assert torch.all((freq - p).abs() < 5 * se + 1e-12), (freq, p)
    # distinct streams: other seeds give other draws
    other = tcat.categorical_plain(
        trollout.rollout_keys(6, n_lanes, 1),
        torch.zeros((n_lanes,), dtype=torch.int32),
        logits.expand(n_lanes, 1, -1))
    assert (other[:, 0] != draws[:n_lanes]).float().mean() > 0.3


def test_max_len_rounds_to_block(setup):
    _, scen_t, _, _, tmodel, _ = setup
    eng = trollout.RolloutEngine(tmodel, scen_t, num_slots=1, device="cpu",
                                 max_len=200)
    assert eng.max_len == 256
    assert trollout.RolloutEngine(tmodel, scen_t, num_slots=1, device="cpu",
                                  max_len=40).max_len == 40


@pytest.mark.parametrize("t", [0, 5, 2 ** 31 - 1])
def test_sampler_step_tensor_matches_int_step(t):
    """The sampler folds each lane's own step (a (B,) tensor, as a server's
    slots are each at their own step) into its key: a tensor of one step,
    int32 or int64, draws bitwise what ``fold_in`` of the int step draws,
    and lanes at other steps draw from their own streams."""
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn((64, 3, 63), generator=gen)
    keys = trollout.rollout_keys(9, 32, 2)
    want = prng.categorical(prng.fold_in(keys, t), logits)
    for dtype in (torch.int32, torch.int64):
        got = tcat.categorical_plain(keys, torch.full((64,), t, dtype=dtype),
                                     logits)
        assert torch.equal(got, want), dtype
    steps = torch.arange(64, dtype=torch.int32) % 4
    mixed = tcat.categorical_plain(keys, steps, logits)
    for s in range(4):
        lanes = steps == s
        assert torch.equal(mixed[lanes], prng.categorical(
            prng.fold_in(keys, s), logits)[lanes])
