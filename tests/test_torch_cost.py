"""The port's cost accounting (``repro_torch/obs/cost.py``) on the CPU.

The counterparts of the reference's ``tests/test_obs_fleet.py:139-190``
(the wrapper on a toy product, a ``NULL`` registry, the engine and the
server recording their four paths, read back by ``obs_report.cost_rows``),
then the port's own: a hand count of one attention call and its backward,
no device value read, obs-on and obs-off rollouts bitwise equal, the
dispatch count of each hot path within 1% of the module formulas'
(``analytic_flops``) with the kernels' share equal, and ``train.step``
recorded by the comparison's and ``train_sim``'s trainers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, obs  # noqa: E402
from repro_torch import scenarios as tscen  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import obs_report  # noqa: E402
from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.obs import cost  # noqa: E402
from repro_torch.runtime import RolloutEngine  # noqa: E402
from repro_torch.runtime.sim_server import SceneRequest, SimServer  # noqa: E402
from repro_torch.training.data import make_sim_batch  # noqa: E402
from repro_torch.training.steps import (bc_optimizer,  # noqa: E402
                                        make_sim_train_step)

SCEN = tscen.ScenarioConfig(num_map=8, num_agents=3, num_steps=7)
T_HIST = 3
CFG = dict(d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
           fourier_terms=8)
PATHS = ("rollout.prefill", "rollout.step", "sim_server.tick",
         "sim_server.admit")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def model():
    return AgentSimModel(AgentSimConfig(**CFG, num_actions=SCEN.num_actions),
                         device="cpu",
                         generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def scenes():
    return [tscen.generate_scene("freeform", 0, i, SCEN) for i in range(3)]


def _gauges(reg, name):
    return {g["labels"]["path"]: g["value"]
            for g in reg.snapshot()["gauges"] if g["name"] == name}


def test_cost_accounted_wrapper_basics():
    reg = obs.Registry()
    f = obs.CostAccounted(lambda a, b: a @ b + 1.0, "toy.mm", registry=reg,
                          labels={"tier": "test"})
    a = torch.ones(4, 4)
    out1, out2 = f(a, a), f(a, a)
    assert torch.equal(out1, out2) and torch.equal(out1, a @ a + 1.0)
    assert f.num_compilations == 1 and f._cache_size() == 1
    assert f.cost["flops"] == 2 * 4 * 4 * 4        # the product's, exactly
    assert f.cost["bytes_accessed"] > 0 and f.cost["kernel_flops"] == 0
    assert f.cost["peak_bytes"] == (f.cost["argument_bytes"]
                                    + f.cost["output_bytes"]) == 2 * 64
    # no compile step: the reference's compile times have no counterpart
    assert "compile_seconds" not in f.cost and "lower_seconds" not in f.cost
    snap = reg.snapshot()
    got = {(g["name"], g["labels"].get("path"), g["labels"].get("tier"))
           for g in snap["gauges"]}
    assert ("cost.flops", "toy.mm", "test") in got
    assert ("cost.peak_bytes", "toy.mm", "test") in got
    [c] = [c for c in snap["counters"] if c["name"] == "cost.compilations"]
    assert c["value"] == 1
    assert any(e["name"] == "cost.compiled" for e in reg.events())


def test_cost_accounted_null_registry_still_computes():
    f = obs.CostAccounted(lambda x: x * 2, "toy.mul", registry=obs.NULL)
    out = f(torch.arange(4, dtype=torch.float32))
    assert torch.equal(out, torch.arange(4, dtype=torch.float32) * 2)
    assert f.cost is not None and f.num_compilations == 1
    assert not list(obs.NULL.instruments())


def test_engine_and_server_record_cost_gauges(model, scenes, tmp_path):
    reg = obs.Registry()
    eng = RolloutEngine(model, SCEN, num_slots=4, device="cpu",
                        registry=reg)
    eng.run(scenes[:2], t_hist=T_HIST, n_samples=1, seed=0)
    srv = SimServer(model, SCEN, num_slots=2, device="cpu", registry=reg)
    srv.submit(SceneRequest(uid=0, tensors=scenes[0], t_hist=T_HIST))
    srv.run_until_drained()
    paths = set(_gauges(reg, "cost.flops"))
    assert set(PATHS) <= paths
    for name in ("cost.bytes_accessed", "cost.peak_bytes"):
        assert set(PATHS) <= set(_gauges(reg, name))
    # each path counted once, however many ticks ran
    counts = {c["labels"]["path"]: c["value"]
              for c in reg.snapshot()["counters"]
              if c["name"] == "cost.compilations"}
    assert all(counts[p] == 1 for p in PATHS)
    assert eng._step._cache_size() == srv._tick._cache_size() == 1

    # obs_report renders the cost table from the written trace
    trace = tmp_path / "run.trace.jsonl"
    obs.write_chrome_trace(reg, str(trace))
    assert obs_report.main([str(trace)]) == 0
    snap = obs_report.snapshot_of(obs.read_chrome_trace(str(trace)))
    rows = obs_report.cost_rows(snap)
    assert {r[0] for r in rows} >= paths
    for r in rows:
        assert r[2] is not None and r[2] > 0        # flops column
        assert r[-1] is None                        # compile_s: none


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_attention_counts_by_hand(grad):
    """One causal GQA attention call (B 2, Hq 4 / Hkv 2, S 16, D 8, Dv 6)
    on the CPU: the kernels' shape-only formula, nothing of the plain
    version's ops. Pairs 2 * 4 * 16 * 16 / 2 = 1,024; forward 2 (D + Dv) a
    pair, backward 2 (4D + 3Dv)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, 8, generator=gen, requires_grad=grad)
    k = torch.randn(2, 2, 16, 8, generator=gen, requires_grad=grad)
    v = torch.randn(2, 2, 16, 6, generator=gen, requires_grad=grad)

    def call():
        out = ops.attention(q, k, v, causal=True)
        if grad:
            torch.autograd.grad(out.sum(), (q, k, v))
        return out

    f = obs.CostAccounted(call, "toy.attention", registry=obs.NULL)
    f()
    pairs = 2 * 4 * 16 * 16 / 2
    want = 2 * pairs * (8 + 6) + (2 * pairs * (4 * 8 + 3 * 6) if grad else 0)
    assert f.cost["kernel_flops"] == want
    # the backward's seed and sum are elementwise: no other FLOP counted
    assert f.cost["flops"] == want
    fwd_bytes = 4 * (q.numel() + k.numel() + v.numel() + 2 * 4 * 16 * 7)
    assert f.cost["bytes_accessed"] >= fwd_bytes


def test_counter_reads_no_device_value(monkeypatch):
    """The counting mode and the kernels' formulas read shapes only: with
    every way to read a tensor's value patched to raise, a counted attention
    forward and backward, a product and a decode-shaped call still count."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 16, 8, generator=gen, requires_grad=True)
    k = torch.randn(2, 2, 16, 8, generator=gen, requires_grad=True)
    w = torch.randn(8, 8, generator=gen)

    def call():
        out = ops.attention(q @ w, k, k, causal=True)
        torch.autograd.grad(out.sum(), (q, k))
        return out

    f = obs.CostAccounted(call, "toy.no_read", registry=obs.NULL)

    def refuse(*_a, **_k):
        raise AssertionError("a device value was read")

    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    f()
    assert f.cost["flops"] > f.cost["kernel_flops"] > 0
    flops, nbytes = cost.decode_cost(
        q, torch.zeros(3, 2, 2, 32, 8), torch.zeros(3, 2, 2, 32, 8), 1,
        None, None, torch.zeros(2, dtype=torch.int32))
    assert flops == 2 * (2 * 4 * 16 * 32) * 16 and nbytes > 0


def test_obs_on_and_off_rollouts_bitwise_equal(model, scenes):
    """Counting only observes: an engine with telemetry, one with
    ``obs.NULL`` and the first engine's second (uncounted) run give the
    same futures and actions bit for bit."""
    runs = []
    for reg in (obs.Registry(), obs.NULL):
        eng = RolloutEngine(model, SCEN, num_slots=4, device="cpu",
                            registry=reg)
        for _ in range(2):
            fut = eng.run(scenes, t_hist=T_HIST, n_samples=2, seed=5)
            runs.append((fut, eng.last_actions))
        assert eng._prefill.cost is not None
    for fut, acts in runs[1:]:
        np.testing.assert_array_equal(fut, runs[0][0])
        np.testing.assert_array_equal(acts, runs[0][1])


def _first_args(wrapper):
    """Wrap a ``CostAccounted`` so the arguments of its first call are kept."""
    seen = {}
    inner = wrapper._fn

    def spy(*args):
        seen.setdefault("args", args)
        return inner(*args)

    wrapper._fn = spy
    return seen


def _within(counted, analytic, what):
    flops, kernel = analytic
    assert counted["kernel_flops"] == kernel, what
    assert kernel > 0, what
    assert abs(counted["flops"] - flops) <= 0.01 * flops, (what, counted,
                                                           flops)


def test_hot_paths_match_the_formulas(model, scenes):
    """Every recorded path's FLOPs within 1% of ``analytic_flops`` at the
    same call's shapes, the kernels' share equal: the engine's prefill and
    tick, the server's tick and admission."""
    eng = RolloutEngine(model, SCEN, num_slots=4, device="cpu",
                        registry=obs.NULL)
    srv = SimServer(model, SCEN, num_slots=2, device="cpu",
                    registry=obs.NULL)
    wrapped = {"rollout.prefill": (eng._prefill, eng._prefill_body),
               "rollout.step": (eng._step, eng._step_body),
               "sim_server.tick": (srv._tick, srv._tick_body),
               "sim_server.admit": (srv._admit, srv._admit_impl)}
    seen = {p: _first_args(w) for p, (w, _) in wrapped.items()}
    eng.run(scenes[:2], t_hist=T_HIST, n_samples=1, seed=0)
    srv.submit(SceneRequest(uid=0, tensors=scenes[0], t_hist=T_HIST))
    srv.run_until_drained()
    for path, (w, body) in wrapped.items():
        args = seen[path]["args"]
        with torch.no_grad():
            analytic = cost.analytic_flops(model, lambda: body(*args))
        _within(w.cost, analytic, path)


def test_train_step_and_forwards_match_the_formulas(model):
    """The sim train step (gradients and update as one count), the sim
    forward and whisper-base's reduced forward against the formulas."""
    step = make_sim_train_step(model, bc_optimizer(1e-3, 4))
    counted = obs.CostAccounted(step, "train.step", registry=obs.NULL)
    state = bc_optimizer(1e-3, 4).init(dict(model.named_parameters()))
    batch = make_sim_batch(0, 0, 2, SCEN)
    grads, _ = counted.grads(batch)
    assert counted.cost is None                   # open until the update
    counted.update(state, grads)
    assert counted.num_compilations == 1
    _within(counted.cost, cost.analytic_flops(model,
                                              lambda: step.grads(batch)),
            "train.step")
    model.requires_grad_(False)

    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    fwd = obs.CostAccounted(model, "sim.forward", registry=obs.NULL)
    with torch.no_grad():
        fwd(tb)
        _within(fwd.cost, cost.analytic_flops(model, lambda: model(tb)),
                "sim forward")

    wm = build_model(configs.get_config("whisper-base").reduced(
        dtype="float32"), device="cpu")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.normal(size=(2, 32, 128)).astype(
        np.float32))
    toks = torch.from_numpy(rng.integers(0, 256, (2, 8)))
    wf = obs.CostAccounted(wm, "whisper.forward", registry=obs.NULL)
    with torch.no_grad():
        wf(frames, toks)
        _within(wf.cost, cost.analytic_flops(wm, lambda: wm(frames, toks)),
                "whisper forward")
    # by hand: the attentions' pairs, encoder 2 x (2 x 4 x 32 x 32), the
    # decoder's causal halves and its cross pairs, each 2 (D + Dv) = 128
    pairs = 2 * (2 * 4 * 32 * 32) + 2 * (2 * 4 * 8 * 8 / 2 + 2 * 4 * 8 * 32)
    assert wf.cost["kernel_flops"] == 2 * pairs * 64


def test_trainers_record_train_step(tmp_path):
    """``train_one`` (the comparison's) records ``cost.*{path="train.step",
    encoding=...}``, as the reference's does."""
    from repro_torch.training.comparison import train_one
    reg = obs.Registry()
    old = obs.set_registry(reg)
    try:
        arch = configs.get_sim_arch("sim-se2-fourier").reduced(
            num_map=8, num_agents=3, num_steps=7)
        train_one(arch, steps=2, batch=2, device="cpu",
                  ckpt_dir=str(tmp_path))
    finally:
        obs.set_registry(old)
    got = {(g["labels"]["path"], g["labels"].get("encoding"))
           for g in reg.snapshot()["gauges"] if g["name"] == "cost.flops"}
    assert ("train.step", "se2_fourier") in got
