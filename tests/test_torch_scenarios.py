"""Parity: the port's scenario suite (lane graph, scenario core, rule-based
policies, the seven families, the registry and the mixed training batches)
against the JAX package's, on the CPU.

Both sides are numpy, and the port's modules are copies, so every scene,
query and policy output must be bit-identical.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import scenarios as jscen  # noqa: E402
from repro.core import kinematics as jkin  # noqa: E402
from repro.scenarios import lane_graph as jlg  # noqa: E402
from repro.scenarios import policies as jpol  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro_torch import scenarios as tscen  # noqa: E402
from repro_torch.core import kinematics as tkin  # noqa: E402
from repro_torch.scenarios import lane_graph as tlg  # noqa: E402
from repro_torch.scenarios import policies as tpol  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402

FAMILIES = ['freeform', 'highway', 'onramp_merge', 'pedestrian_crossing',
            'roundabout', 'signalized_intersection', 'unprotected_left']
# the reduced config of tests/test_torch_rollout.py and the full width
CONFIGS = {"reduced": dict(num_map=8, num_agents=3, num_steps=7),
           "full": dict(num_map=48, num_agents=12, num_steps=24)}
PAIRS = [(0, 0), (3, 5), (11, 42)]


def assert_arrays_identical(got, want, what):
    assert type(got) is type(want), what
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_graphs_identical(got, want):
    assert len(got.lanes) == len(want.lanes)
    for i, (lt, lj) in enumerate(zip(got.lanes, want.lanes)):
        assert_arrays_identical(lt.points, lj.points, f"lane {i} points")
        assert_arrays_identical(lt.headings, lj.headings,
                                f"lane {i} headings")
        assert (lt.kind, lt.speed_limit) == (lj.kind, lj.speed_limit), i
    assert got.successors == want.successors
    assert got.left == want.left
    assert got.right == want.right


def assert_scenes_identical(got, want):
    assert got.family == want.family
    assert sorted(got.tensors) == sorted(want.tensors)
    for key, arr in want.tensors.items():
        assert_arrays_identical(got.tensors[key], arr, key)
    assert got.num_valid_agents == want.num_valid_agents
    assert_graphs_identical(got.lane_graph, want.lane_graph)


def both_scenes(family, seed, index, config="full"):
    return (tscen.generate_scene(family, seed, index,
                                 tscen.ScenarioConfig(**CONFIGS[config])),
            jscen.generate_scene(family, seed, index,
                                 jscen.ScenarioConfig(**CONFIGS[config])))


def test_registry_names_match_reference():
    assert tscen.registry.names() == jscen.registry.names() == FAMILIES
    assert tscen.__all__ == jscen.__all__


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed,index", PAIRS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_scenes_bit_identical(family, seed, index, config):
    got, want = both_scenes(family, seed, index, config)
    assert got.family == family
    assert_scenes_identical(got, want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mixed_batches_bit_identical(config):
    """Nine scenes from index 5 cycle through all seven families."""
    cfg_t = tscen.ScenarioConfig(**CONFIGS[config])
    cfg_j = jscen.ScenarioConfig(**CONFIGS[config])
    got = tscen.generate_mixed_batch(4, 5, 9, cfg_t)
    want = jscen.generate_mixed_batch(4, 5, 9, cfg_j)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_arrays_identical(got[key], want[key], key)
    got = tdata.make_sim_batch(4, 5, 9, cfg_t)
    want = jdata.make_sim_batch(4, 5, 9, cfg_j)
    assert sorted(got) == sorted(want) == sorted(tdata.TRAIN_KEYS)
    for key in want:
        assert_arrays_identical(got[key], want[key], key)
    # the default draws every family, so not freeform alone
    only_freeform = tdata.make_sim_batch(4, 5, 9, cfg_t, ("freeform",))
    assert not np.array_equal(only_freeform["agent_valid"],
                              got["agent_valid"])


@pytest.mark.parametrize("family", FAMILIES)
def test_lane_graph_queries_match_reference(family):
    got, want = both_scenes(family, 2, 7)
    gt, gj = got.lane_graph, want.lane_graph
    rng = np.random.default_rng(5)
    pts = gj.all_points()[0]
    lo, hi = pts.min(0) - 10.0, pts.max(0) + 10.0
    xy = rng.uniform(lo, hi, size=(4, 50, 2)).astype(np.float32)
    for kinds in (None, ("lane",), ("crosswalk",)):
        for a, b in zip(gt.all_points(kinds), gj.all_points(kinds)):
            assert_arrays_identical(a, b, f"all_points {kinds}")
        for a, b in zip(gt.nearest(xy, kinds), gj.nearest(xy, kinds)):
            assert_arrays_identical(a, b, f"nearest {kinds}")
        assert_arrays_identical(gt.distance(xy, kinds),
                                gj.distance(xy, kinds), f"distance {kinds}")
        for thr in (1.0, 3.5):
            assert_arrays_identical(gt.on_road(xy, thr, kinds),
                                    gj.on_road(xy, thr, kinds),
                                    f"on_road {thr} {kinds}")
    for num_map, feat_dim in ((48, 8), (5, 4), (len(gj.lanes), 6)):
        for a, b in zip(gt.map_tokens(num_map, feat_dim),
                        gj.map_tokens(num_map, feat_dim)):
            assert_arrays_identical(a, b, f"map_tokens {num_map}")
    for start in range(len(gj.lanes)):
        for min_length in (0.0, 60.0, 500.0):
            route_t = gt.trace_route(start, min_length,
                                     np.random.default_rng(start))
            route_j = gj.trace_route(start, min_length,
                                     np.random.default_rng(start))
            assert route_t == route_j
            for a, b in zip(gt.route_points(route_t),
                            gj.route_points(route_j)):
                assert_arrays_identical(a, b, f"route_points {route_t}")
    for lt, lj in zip(gt.lanes, gj.lanes):
        assert lt.length == lj.length
        assert_arrays_identical(lt.arclengths(), lj.arclengths(), "s")
    z = (12.5, -30.0, 2.2)
    assert_graphs_identical(gt.transformed(z), gj.transformed(z))


def test_lane_constructors_match_reference():
    for args in (((1.0, -2.0), 0.3, 37.0), ((0.0, 0.0), -2.0, 3.0)):
        a, b = tlg.straight_lane(*args), jlg.straight_lane(*args)
        assert_arrays_identical(a.points, b.points, f"straight {args}")
        assert_arrays_identical(a.headings, b.headings, f"straight {args}")
    for args in (((0.0, 1.0), 0.5, 14.0, np.pi / 2),
                 ((3.0, 0.0), -1.0, 60.0, -0.45), ((0.0, 0.0), 0.0, 8.0, 0.0)):
        a, b = tlg.arc_lane(*args), jlg.arc_lane(*args)
        assert_arrays_identical(a.points, b.points, f"arc {args}")
        assert_arrays_identical(a.headings, b.headings, f"arc {args}")
    poly = np.random.default_rng(1).normal(scale=20.0, size=(6, 2))
    a, b = tlg.polyline_lane(poly), jlg.polyline_lane(poly)
    assert_arrays_identical(a.points, b.points, "polyline")
    assert_arrays_identical(a.headings, b.headings, "polyline")
    assert tlg.LANE_KIND == jlg.LANE_KIND and tlg.STEP == jlg.STEP
    with pytest.raises(ValueError):
        tlg.Lane(np.zeros((3, 3)), np.zeros(3))


def test_policies_bit_identical():
    for seed in range(4):
        for args in ((3, 10.0, 100.0, 18.0), (7, 5.0, 39.0, 15.0),
                     (2, 0.0, 5.0, 10.0)):
            assert_arrays_identical(
                tpol.spaced_starts(np.random.default_rng(seed), *args),
                jpol.spaced_starts(np.random.default_rng(seed), *args),
                f"spaced_starts {args}")
    p_t, p_j = tpol.IDMParams(), jpol.IDMParams()
    assert p_t == tpol.IDMParams(**vars(p_j))
    for v, v0, gap, dv in ((0.0, 10.0, np.inf, 0.0), (8.0, 12.0, 20.0, 2.0),
                           (12.0, 0.05, 0.01, -3.0), (3.0, 9.0, 5.0, 3.0)):
        assert tpol.idm_accel(v, v0, gap, dv, p_t) == \
            jpol.idm_accel(v, v0, gap, dv, p_j)
    rng = np.random.default_rng(3)
    for _ in range(20):
        pose = rng.normal(scale=10.0, size=3).astype(np.float32)
        target = rng.normal(scale=10.0, size=2).astype(np.float32)
        assert tpol.pursuit_yaw_rate(pose, target, 5.0) == \
            jpol.pursuit_yaw_rate(pose, target, 5.0)
    assert tkin.wrap_angle(np.float32(7.0), xp=np) == \
        jkin.wrap_angle(np.float32(7.0), xp=np)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_simulate_bit_identical(config):
    """Agents spawned on crossing and merging routes by agent_on_route, the
    conflicts between them, and simulate() with a stop hook, all from the
    same rng in both packages."""
    def run(pkg, lg, cfg):
        g = lg.LaneGraph()
        east = g.add(lg.straight_lane((-60.0, 0.0), 0.0, 120.0))
        north = g.add(lg.straight_lane((0.0, -50.0), np.pi / 2, 100.0,
                                       speed_limit=9.0))
        ramp = g.add(lg.arc_lane((-40.0, -20.0), 0.6, 40.0, -0.6))
        g.connect(ramp, east)
        rng = np.random.default_rng(9)
        agents = []
        for route, prio in (([east], 2), ([north], 1), ([ramp, east], 1)):
            xy, hd = g.route_points(route)
            for s0 in pkg.spaced_starts(rng, 2, 5.0, 45.0, min_gap=15.0):
                agents.append(pkg.agent_on_route(
                    float(s0), xy, hd, v0=float(rng.uniform(6.0, 12.0)),
                    rng=rng, priority=prio))
        agents = agents[:cfg.num_agents]
        conflicts = pkg.route_conflicts(agents)
        out = pkg.simulate(cfg, rng, agents, cfg.num_steps,
                           stop_hook=lambda i, t: 30.0 if t % 5 < 2 else None)
        return conflicts, out, [a.s for a in agents]

    want = run(jpol, jlg, jscen.ScenarioConfig(**CONFIGS[config]))
    got = run(tpol, tlg, tscen.ScenarioConfig(**CONFIGS[config]))
    assert got[0] == want[0]
    for a, b, what in zip(got[1], want[1], ("pose", "feats", "actions")):
        assert_arrays_identical(a, b, what)
    assert got[2] == want[2]


@pytest.mark.parametrize("family", ["highway", "pedestrian_crossing",
                                    "roundabout"])
def test_core_functions_match_reference(family):
    got, want = both_scenes(family, 1, 4)
    cfg_t = tscen.ScenarioConfig(**CONFIGS["full"])
    cfg_j = jscen.ScenarioConfig(**CONFIGS["full"])
    assert tscen.AGENT_TYPE == jscen.AGENT_TYPE
    assert tscen.core.BEHAVIOR == jscen.core.BEHAVIOR
    assert (tscen.DT, tscen.MAX_SPEED) == (jscen.DT, jscen.MAX_SPEED)
    # assemble_scene on the reference's own trajectories and graph
    n = want.num_valid_agents
    t = want.tensors
    args = (t["agent_pose"][:, :n], t["agent_feats"][:, :n],
            t["actions"][:, :n], t["agent_type"][:n])
    assert_scenes_identical(
        tscen.assemble_scene(family, cfg_t, got.lane_graph, *args),
        jscen.assemble_scene(family, cfg_j, want.lane_graph, *args))
    for stat, turn in ((2.0, 0.3), (0.5, 0.05)):
        assert_arrays_identical(
            tscen.classify_behavior(t["agent_pose"], t["agent_valid"],
                                    stat, turn),
            jscen.classify_behavior(t["agent_pose"], t["agent_valid"],
                                    stat, turn), "classify_behavior")
    for z in ((3.0, -4.0, 0.7), (-100.0, 25.0, -3.0)):
        assert_arrays_identical(tscen.transform_poses(z, t["agent_pose"]),
                                jscen.transform_poses(z, t["agent_pose"]),
                                "transform_poses")
        assert_scenes_identical(tscen.transform_scene(got, z),
                                jscen.transform_scene(want, z))
    rng = np.random.default_rng(2)
    sampled = (t["agent_pose"][None]
               + rng.normal(scale=1.5, size=(3,) + t["agent_pose"].shape)
               ).astype(np.float32)
    for valid in (None, t["agent_valid"], t["agent_valid"][0]):
        a = tscen.rollout_metrics(cfg_t, t["agent_pose"], sampled,
                                  t["behavior"], valid)
        b = jscen.rollout_metrics(cfg_j, t["agent_pose"], sampled,
                                  t["behavior"], valid)
        assert a.keys() == b.keys()
        for key in b:
            np.testing.assert_equal(a[key], b[key], err_msg=key)
