"""The port's LM training against the JAX package on the CPU.

``synthetic_lm`` batches bitwise; ``adafactor`` (factored and unfactored
leaves, a stacked layer group) against the reference's, its state carried
both ways; the LM train step against ``repro.runtime.steps.
make_train_step(cfg, opt, remat=False)`` at five reduced archs (weights
crossed by ``params.from_reference``): loss, gradient norm, every gradient
and the parameters after two updates; remat bitwise; the reference's four
LM trainer tests on the port; an LM checkpoint crossing between the
packages both ways; and ``launch.train`` in process.
"""
import argparse
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data import synthetic_lm as jsynth  # noqa: E402
from repro.data.pipeline import ShardedIterator as JIterator  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import TransformerLM as JLM  # noqa: E402
from repro.optim.transforms import Optimizer as JOptimizer  # noqa: E402
from repro.optim.transforms import apply_updates as japply  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs, optim, params  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import ShardedIterator, synthetic_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                         opt_state_from_reference,
                                         opt_state_to_reference)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are a few hundred kilobytes: one intra-op thread runs
    them faster than a pool contending with the test workers and the data
    thread (the thread count is restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ARCHS = ("phi4-mini-3.8b", "stablelm-3b", "granite-20b", "internvl2-26b",
         "gemma2-27b")
B, S = 2, 24


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# data and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,index,vocab,seq", [
    (0, 0, 256, 128), (3, 17, 128, 32), (11, 1000, 200064, 64)])
def test_synthetic_lm_batches_bitwise(seed, index, vocab, seq):
    tcfg = synthetic_lm.LMDataConfig(vocab_size=vocab, seq_len=seq)
    jcfg = jsynth.LMDataConfig(vocab_size=vocab, seq_len=seq)
    got = synthetic_lm.generate_batch(seed, index, 3, tcfg)
    want = jsynth.generate_batch(seed, index, 3, jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


PLAIN_TREE = {"w": (6, 5), "b": (7,), "t": (3, 4, 5), "one": (1, 9)}
# a two-layer group, stacked in the reference: its vectors (2, 8) stay
# unfactored at min_dim_size_to_factor=3, its matrices (2, 8, 3) factor
GROUP_TREE = {"groups.0.0.norm.scale": (8,), "groups.0.1.norm.scale": (8,),
              "groups.0.0.mlp.kernel": (8, 3), "groups.0.1.mlp.kernel": (8, 3),
              "final.scale": (8,)}


def _tree(rng, shapes):
    return {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("shapes,min_dim", [(PLAIN_TREE, 2),
                                            (GROUP_TREE, 3)],
                         ids=["plain", "group"])
def test_adafactor_matches_reference(shapes, min_dim):
    """Five steps against the reference on factored and unfactored leaves
    (min_dim_size_to_factor=2 as tests/test_substrate.py:40; a stacked
    group at 3); updates and state within 1e-6 relative, the state's
    shapes exact, carried both ways."""
    rng = np.random.default_rng(0)
    named = _tree(rng, shapes)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in named.items()}
    jparams = jax.tree.map(jnp.asarray, params.to_reference(tparams))
    topt = optim.adafactor(0.05, min_dim_size_to_factor=min_dim,
                           weight_decay=0.01)
    jopt = joptim.adafactor(0.05, min_dim_size_to_factor=min_dim,
                            weight_decay=0.01)
    tstate, jstate = topt.init(tparams), jopt.init(jparams)
    jupdate = jax.jit(jopt.update)           # as the reference's step runs it
    kinds = {n: set(v) for n, v in tstate["v"].items()}
    assert {frozenset(k) for k in kinds.values()} == {
        frozenset({"v"}), frozenset({"vr", "vc"})}
    for step in range(5):
        grads = {n: rng.normal(size=a.shape).astype(np.float32)
                 for n, a in named.items()}
        tg = {n: torch.from_numpy(g) for n, g in grads.items()}
        jg = jax.tree.map(jnp.asarray, params.to_reference(tg))
        tup, tstate = topt.update(tg, tstate, tparams)
        jup, jstate = jupdate(jg, jstate, jparams)
        want = params.from_reference(jax.tree.map(np.asarray, jup))
        for n in tparams:
            np.testing.assert_allclose(tup[n].numpy(), want[n].numpy(),
                                       rtol=1e-6,
                                       atol=1e-9, err_msg=f"{n} step {step}")
        tparams = optim.apply_updates(tparams, tup)
        jparams = japply(jparams, jup)
        got = jax.tree.map(np.asarray,
                           opt_state_to_reference(tstate))
        assert int(got["step"]) == int(jstate["step"])
        jax.tree.map(lambda a, b: (
            np.testing.assert_equal(a.shape, np.shape(b)),
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-12)), got["v"], jstate["v"])
        back = opt_state_from_reference(
            jax.tree.map(np.asarray, jstate), tstate, "cpu")
        for n, slots in tstate["v"].items():
            for k, t in slots.items():
                assert back["v"][n][k].shape == t.shape
                np.testing.assert_allclose(back["v"][n][k].numpy(),
                                           t.numpy(), rtol=1e-6, atol=1e-12)


def test_adafactor_refuses_a_factored_stack_of_vectors():
    named = {f"groups.0.{i}.norm.scale": torch.zeros(8) for i in range(2)}
    with pytest.raises(NotImplementedError, match="stack of 2 vectors"):
        optim.adafactor(0.1, min_dim_size_to_factor=2).init(named)


@pytest.mark.parametrize("make_opt", [
    lambda: optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(0.1)),
    lambda: optim.chain(optim.clip_by_global_norm(0.5),
                        optim.adafactor(0.3, min_dim_size_to_factor=3)),
    lambda: optim.sgd(0.1)],
    ids=["clip_adamw", "clip_adafactor", "sgd"])
def test_step_in_place_equals_update(make_opt):
    """The tensor-at-a-time step leaves the parameters and the state
    bitwise where the whole-tree update does."""
    rng = np.random.default_rng(1)
    named = _tree(rng, {**PLAIN_TREE, **GROUP_TREE})
    opt = make_opt()
    p_a = {n: torch.from_numpy(a.copy()) for n, a in named.items()}
    p_b = {n: torch.from_numpy(a.copy()) for n, a in named.items()}
    s_a, s_b = opt.init(p_a), opt.init(p_b)
    for _ in range(3):
        grads = {n: torch.from_numpy(rng.normal(size=a.shape).astype(
            np.float32)) for n, a in named.items()}
        up, s_a = opt.update(grads, s_a, p_a)
        optim.apply_updates(p_a, up)
        s_b = optim.step_in_place(opt, dict(grads), s_b, p_b)
    for n in p_a:
        assert torch.equal(p_a[n], p_b[n]), n
    flat = lambda s: jax.tree.leaves(opt_state_to_reference(s))  # noqa
    for a, b in zip(flat(s_a), flat(s_b)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _pair(arch, dtype="float32", seed=0):
    jcfg = jconfigs.get_config(arch).reduced(dtype=dtype)
    jp = jmodule.init_params(JLM(jcfg).specs(), jax.random.key(seed))
    tm = build_model(configs.get_config(arch).reduced(dtype=dtype),
                     device="cpu")
    tm.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                       strict=True)
    return jcfg, jp, tm


def _batch(cfg, seed):
    b = synthetic_lm.generate_batch(seed, 0, B, synthetic_lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=S))
    if cfg.vision_prefix:
        b["prefix"] = np.random.default_rng(seed).normal(
            size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return b


def _capturing(opt):
    """The reference optimizer ``opt`` with the gradients it was last given
    kept in its state: one compile of the reference's step yields them."""
    def init(p):
        return {"grads": jax.tree.map(jnp.zeros_like, p), "opt": opt.init(p)}

    def update(g, state, p):
        updates, new = opt.update(g, state["opt"], p)
        return updates, {"grads": g, "opt": new}

    return JOptimizer(init, update)


LR = 3e-3


def _opts():
    return (joptim.chain(joptim.clip_by_global_norm(1.0),
                         joptim.adamw(LR)),
            optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(LR)))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    cfg, jp, tm = _pair(arch, seed=3)
    batch = _batch(cfg, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt, topt = _opts()
    jopt = _capturing(jopt)
    step = tsteps.make_train_step(tm, topt)
    # two steps: loss, grad_norm and the parameters after each update; the
    # first step's every gradient, within 1e-4 of its tensor's largest |g|
    jstep = jax.jit(jsteps.make_train_step(cfg, jopt, remat=False))
    jstate = jopt.init(jp)
    tstate = topt.init(dict(tm.named_parameters()))
    for i in range(2):
        jp, jstate, jm = jstep(jp, jstate, jb)
        grads, metrics = step.grads(batch)
        if not i:
            want = {n: t.numpy() for n, t in params.from_reference(
                jax.tree.map(np.asarray, jstate["grads"])).items()}
            assert sorted(grads) == sorted(want)
            for n, g in grads.items():
                # 1e-7 absolute beside it: the key bias's gradient vanishes
                # in exact arithmetic (softmax is shift-invariant), so it is
                # rounding alone
                scale = float(np.abs(want[n]).max())
                err = float(np.abs(g.numpy() - want[n]).max())
                assert err <= 1e-4 * scale + 1e-7, (n, err, scale)
        tstate = step.update(tstate, grads)
        assert not grads                     # the update consumed them
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{arch} {k} {i}")
        assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
        want_p = params.from_reference(jax.tree.map(np.asarray, jp))
        for n, p in tm.state_dict().items():
            # AdamW turns the key bias's rounding-level gradient into steps
            # of about lr either way: there only the steps' size is checked
            atol = 2 * LR * (i + 1) if n.endswith("attn.k.bias") else 1e-4
            np.testing.assert_allclose(p.numpy(), want_p[n].numpy(), rtol=0,
                                       atol=atol, err_msg=f"{arch} {n} {i}")


def test_train_step_bf16_matches_reference():
    cfg, jp, tm = _pair("phi4-mini-3.8b", dtype="bfloat16", seed=4)
    batch = _batch(cfg, 4)
    jopt, topt = _opts()
    _, _, jm = jax.jit(jsteps.make_train_step(cfg, jopt, remat=False))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    step = tsteps.make_train_step(tm, topt)
    grads, metrics = step.grads(batch)
    assert all(g.dtype == torch.float32 for g in grads.values())
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=2e-2)


def test_remat_is_bitwise():
    _, _, tm = _pair("gemma2-27b", seed=5)
    batch = _batch(tm.cfg, 5)
    out = []
    for remat in (True, False):
        grads, metrics = tsteps.make_train_step(
            tm, optim.sgd(0.1), remat=remat).grads(batch)
        out.append((grads, float(metrics["loss"])))
    assert out[0][1] == out[1][1]
    for n in out[0][0]:
        assert torch.equal(out[0][0][n], out[1][0][n]), n


# ---------------------------------------------------------------------------
# the Trainer on the LM step (tests/test_trainer_server.py:42-130)
# ---------------------------------------------------------------------------

CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_q_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
              head_dim=16, dtype="float32")
CFG = ModelConfig(**CFG_KW)
DATA_CFG = synthetic_lm.LMDataConfig(vocab_size=128, seq_len=32)


def make_everything(tmp_path, total_steps=20, seed=0):
    model = build_model(CFG, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-3))
    step = tsteps.make_train_step(model, opt, remat=False)
    data = ShardedIterator(
        lambda s, i, b: synthetic_lm.generate_batch(s, i, b, DATA_CFG),
        batch_size=8, seed=0)
    return Trainer(step, model, opt.init(dict(model.named_parameters())),
                   data, str(tmp_path),
                   TrainerConfig(total_steps=total_steps, ckpt_every=5,
                                 log_every=100))


def test_training_reduces_loss(tmp_path):
    tr = make_everything(tmp_path / "a", total_steps=30)
    out = tr.run()
    assert out["status"] == "done"
    first, last = np.mean(tr.history[:5]), np.mean(tr.history[-5:])
    assert last < first - 0.1, (first, last)
    tr.data.close()


def test_checkpoint_restart_bit_exact(tmp_path):
    tr_full = make_everything(tmp_path / "full", total_steps=20)
    tr_full.run()
    full_hist = list(tr_full.history)
    tr_a = make_everything(tmp_path / "resume", total_steps=10)
    tr_a.run()
    tr_b = make_everything(tmp_path / "resume", total_steps=20, seed=9)
    assert tr_b.restore_if_available()
    assert tr_b.step == 10 and tr_b.data.cursor == 10
    tr_b.run()
    np.testing.assert_allclose(full_hist[10:], tr_b.history, rtol=1e-5)
    want, got = tr_full.model.state_dict(), tr_b.model.state_dict()
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=1e-6, err_msg=n)
    tr_full.data.close(); tr_a.data.close(); tr_b.data.close()


def test_preemption_checkpoint_and_resume(tmp_path):
    calls = {"n": 0}

    def stop_after_7():
        calls["n"] += 1
        return calls["n"] > 7

    tr = make_everything(tmp_path / "p", total_steps=50)
    tr.should_stop = stop_after_7
    out = tr.run()
    assert out["status"] == "preempted"
    tr2 = make_everything(tmp_path / "p", total_steps=9)
    assert tr2.restore_if_available()
    assert tr2.step == out["step"]
    out2 = tr2.run()
    assert out2["status"] == "done"
    tr.data.close(); tr2.data.close()


def test_nan_guard_skips_bad_batches(tmp_path):
    """Steps 3 and 4 report a NaN loss: both skipped, and a skipped step
    leaves the parameters and AdamW's moments bitwise as they were."""
    tr = make_everything(tmp_path / "n", total_steps=10)
    inner = tr.step_fn
    bad_steps = {3, 4}
    counter = {"i": 0}
    seen = {}

    def state():
        return [np.array(t, copy=True) for t in jax.tree.leaves(
            (tr.model.state_dict(), opt_state_to_reference(tr.opt_state)))]

    def grads(batch):
        g, m = inner.grads(batch)
        if counter["i"] in bad_steps:
            m = dict(m, loss=torch.tensor(float("nan")))
            seen[counter["i"]] = state()
        if counter["i"] - 1 in seen:
            before, now = seen[counter["i"] - 1], state()
            assert all(np.array_equal(a, b) for a, b in zip(before, now))
        counter["i"] += 1
        return g, m

    tr.step_fn = dataclasses.replace(inner, grads=grads)
    out = tr.run()
    assert out["status"] == "done"
    assert tr.nan_guard.total_skipped == 2
    assert len(tr.history) == 10 - 2
    tr.data.close()


@functools.lru_cache(maxsize=None)
def _reference_step():
    """The reference's jitted LM step at CFG (compiled once a process)."""
    opt = joptim.chain(joptim.clip_by_global_norm(1.0), joptim.adamw(3e-3))
    return opt, jax.jit(jsteps.make_train_step(JModelConfig(**CFG_KW), opt,
                                               remat=False))


def _reference_trainer(path, total_steps):
    """The reference's Trainer at CFG, from the port's seed-0 weights."""
    jp = jax.tree.map(jnp.asarray, params.to_reference(build_model(
        CFG, device="cpu", generator=torch.Generator().manual_seed(0))))
    opt, step = _reference_step()
    data = JIterator(
        lambda s, i, b: jsynth.generate_batch(
            s, i, b, jsynth.LMDataConfig(vocab_size=128, seq_len=32)),
        batch_size=8, seed=0)
    return JTrainer(step, jp, opt.init(jp), data, str(path),
                    JTrainerConfig(total_steps=total_steps, ckpt_every=5,
                                   log_every=100))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lm_checkpoint_crosses_packages(tmp_path, writer):
    """Five steps in one package, the sixth in both from its checkpoint:
    the losses within 1e-5."""
    if writer == "port":
        first = make_everything(tmp_path, total_steps=5)
        first.run()
    else:
        first = _reference_trainer(tmp_path, 5)
        first.run()
    first.data.close()
    port = make_everything(tmp_path, total_steps=6, seed=7)
    ref = _reference_trainer(tmp_path, 6)
    assert port.restore_if_available() and ref.restore_if_available()
    assert port.step == ref.step == 5
    port.run()
    ref.run()
    np.testing.assert_allclose(port.history, ref.history, rtol=1e-5)
    port.data.close(); ref.data.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _args(tmp_path, *extra):
    return launch_train.build_parser().parse_args(
        ["--arch", "phi4-mini-3.8b", "--reduced", "--batch", "2", "--seq",
         "16", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path), *extra])


def test_launch_train_runs_and_resumes(tmp_path):
    out = launch_train.run(_args(tmp_path, "--device", "cpu", "--steps",
                                 "6", "--lr", "1e-2"))
    assert out["status"] == "done" and out["step"] == 6
    hist = out["history"]
    assert len(hist) == 6 and np.all(np.isfinite(hist))
    assert hist[-1] < hist[0]
    again = launch_train.run(_args(tmp_path, "--device", "cpu", "--steps",
                                   "8", "--lr", "1e-2"))
    assert again["step"] == 8 and len(again["history"]) == 2


def test_launch_train_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.run(_args(tmp_path, "--steps", "2"))
    assert isinstance(launch_train.build_parser(), argparse.ArgumentParser)
