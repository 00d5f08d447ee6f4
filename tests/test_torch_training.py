"""Parity: the port's behaviour-cloning training path against the JAX
package, on the CPU, at the reduced ``sim-se2-fourier`` arch (2 layers,
d_model 64, 4 heads x 24, F = 12, c = 200; 16 map + 10 x 6 agent tokens).

* the optimizer (``chain(clip_by_global_norm, adamw(warmup_cosine))``) and
  every schedule, step by step on a random tree;
* expert batches bit-identical, and the data pipeline's resume order;
* the model's masked-NLL loss and its gradients against
  ``jax.value_and_grad`` with the reference at ``attn_impl="ref"`` and at
  ``"flash"`` (Pallas in interpret mode);
* one ``make_sim_train_step`` and the eval step from the same weights and
  batch.

Weights cross over through ``repro_torch.params.from_reference``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.nn import agent_sim as jsim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.data import ShardedIterator  # noqa: E402
from repro_torch.nn import agent_sim as tsim  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

FAMILIES = ("freeform",)
ARCH = "sim-se2-fourier"
LR, STEPS = 3e-3, 10
# the loss and its gradients: float32 sums in another order through a
# 2-layer net (tests/test_decode.py's model-level tolerances)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jarch = jconfigs.get_sim_arch(ARCH).reduced()
    tarch = tconfigs.get_sim_arch(ARCH).reduced()
    scen = tarch.scenario_config()
    jmodel = jsim.AgentSimModel(jarch.agent_sim_config())
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(0))
    return jarch, tarch, scen, jmodel, jparams


def _port_model(tarch, jparams):
    model = tsim.AgentSimModel(tarch.agent_sim_config(), device="cpu")
    model.load_state_dict(tparams.from_reference(_np_tree(jparams)))
    return model


def _batch(scen, invalid, seed=0, index=0, size=3):
    b = tdata.make_sim_batch(seed, index, size, scen, families=FAMILIES)
    if invalid:
        b["agent_valid"][0, 4:, -1] = False   # an agent drops out
        b["map_valid"][1, -3:] = False        # padded map tokens
    return b


# -- optimizer ----------------------------------------------------------------

SCHEDULES = {
    "constant": ((0.1,), (0, 1, 5)),
    "linear_warmup": ((0.1, 4), (0, 1, 3, 4, 9)),
    "cosine_decay": ((0.1, 10, 0.2), (0, 1, 5, 10, 12)),
    "warmup_cosine": ((0.1, 3, 12, 0.1), (0, 1, 2, 3, 4, 8, 12, 20)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    args, steps = SCHEDULES[name]
    jfn, tfn = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for s in steps:
        np.testing.assert_allclose(float(tfn(s)),
                                   float(jfn(jnp.asarray(s, jnp.int32))),
                                   rtol=1e-6, err_msg=f"step {s}")


def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("opt", ["bc", "sgd_wd"])
def test_optimizer_steps_match_reference(opt):
    """Three steps from one random tree; gradients scaled so that clipping
    acts on some steps and not on others."""
    rng = np.random.default_rng(0)
    if opt == "bc":
        jopt = jsteps.bc_optimizer(1e-2, 30)
        topt = tsteps.bc_optimizer(1e-2, 30)
    else:
        jopt = joptim.chain(joptim.clip_by_global_norm(0.5),
                            joptim.adamw(2e-2, weight_decay=0.1))
        topt = toptim.chain(toptim.clip_by_global_norm(0.5),
                            toptim.adamw(2e-2, weight_decay=0.1))
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(jp).items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step, gscale in enumerate((3.0, 0.05, 1.0)):
        g = jax.tree.map(lambda x: jnp.asarray(x * gscale), _tree(rng))
        jupd, js = jopt.update(g, js, jp)
        jp = joptim.transforms.apply_updates(jp, jupd)
        tupd, ts = topt.update({k: torch.from_numpy(v.copy()) for k, v in
                                _flat(g).items()}, ts, tp)
        toptim.apply_updates(tp, tupd)
        for k, want in _flat(jp).items():
            np.testing.assert_allclose(tp[k].numpy(), want, atol=1e-7,
                                       rtol=1e-5, err_msg=f"{k} @ {step}")
    plain = toptim.sgd(0.5)
    upd, state = plain.update({"x": torch.ones(2)}, plain.init({}), {})
    assert state["step"] == 1 and torch.equal(upd["x"], torch.full((2,),
                                                                   -0.5))


def test_loss_summary_matches_reference():
    for hist in ([], [3.0], [5.0, 4.0, 3.0, 2.5, 2.0, 1.0, 0.5]):
        want = jsteps.loss_summary(hist)
        got = tsteps.loss_summary(hist)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_equal(got[k], want[k])


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("seed,index", [(0, 0), (3, 17),
                                        (jdata.HOLDOUT_SEED_OFFSET, 4)])
def test_sim_batches_bit_identical_to_reference(setup, seed, index):
    scen = setup[2]
    jscen = setup[0].scenario_config()
    want = jdata.make_sim_batch(seed, index, 3, jscen, families=FAMILIES)
    got = tdata.make_sim_batch(seed, index, 3, scen, families=FAMILIES)
    assert set(got) == set(tdata.TRAIN_KEYS) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    hold = tdata.holdout_batches(scen, 2, 2, families=FAMILIES)
    jhold = jdata.holdout_batches(jscen, 2, 2, families=FAMILIES)
    for a, b in zip(hold, jhold):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_iterator_resumes_in_the_same_order(setup):
    scen = setup[2]
    fn = tdata.make_batch_fn(scen, FAMILIES)
    it = ShardedIterator(fn, batch_size=2, seed=5)
    for _ in range(3):
        next(it)
    state = it.state_dict()
    expect = [next(it) for _ in range(2)]
    it.close()
    it2 = ShardedIterator(fn, batch_size=2, seed=5)
    it2.load_state_dict(state)
    jit = jpipeline.ShardedIterator(
        jdata.make_batch_fn(setup[0].scenario_config(), FAMILIES),
        batch_size=2, seed=5)
    jit.load_state_dict(state)
    for want in expect:
        got, ref = next(it2), next(jit)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(ref[k], want[k], err_msg=k)
    it2.close()
    jit.close()


# -- model loss and gradients ---------------------------------------------------

def _jax_loss_and_grads(jmodel, jparams, batch):
    def loss_fn(p):
        logits, aux = jmodel(p, batch)
        return jsim.action_nll(logits, batch["actions"],
                               batch["agent_valid"]) + aux
    return jax.jit(jax.value_and_grad(loss_fn))(jparams)


@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("ref_impl", ["ref", "flash"])
def test_loss_and_grads_match_reference(setup, ref_impl, invalid):
    """The port's default path on the CPU (attn_impl "auto": the plain
    flash forward and backward) against the reference's oracle and its
    Pallas kernels in interpret mode."""
    jarch, tarch, scen, _, jparams = setup
    jmodel = jsim.AgentSimModel(dataclasses.replace(
        jarch.agent_sim_config(), attn_impl=ref_impl))
    batch = _batch(scen, invalid)
    want_loss, want_grads = _jax_loss_and_grads(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(tarch, jparams).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tsim.action_nll(model(tb), tb["actions"], tb["agent_valid"])
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = tparams.from_reference(_np_tree(want_grads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)


# -- train and eval steps ------------------------------------------------------

def test_train_step_matches_reference(setup):
    """One BC update from the same weights and batch. The first AdamW step
    moves a weight by about lr * sign(g) whatever |g| is, so the updated
    weights agree to 1e-3 * lr where the reference's |g| > 1e-6, and only
    to 2 * lr where a gradient that small may take either sign."""
    jarch, tarch, scen, jmodel, jparams = setup
    batch = _batch(scen, True)
    jopt = jsteps.bc_optimizer(LR, STEPS)
    jstep = jax.jit(jsteps.make_sim_train_step(jmodel, jopt))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, _, jmetrics = jstep(jparams, jopt.init(jparams), jb)
    _, jgrads = _jax_loss_and_grads(jmodel, jparams, jb)

    model = _port_model(tarch, jparams)
    topt = tsteps.bc_optimizer(LR, STEPS)
    step = tsteps.make_sim_train_step(model, topt)
    state = topt.init(dict(model.named_parameters()))
    state, metrics = step(state, batch)
    assert state[1]["step"] == 1
    for k in ("loss", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    want = tparams.from_reference(_np_tree(jnew))
    big = {n: np.abs(g.numpy()) > 1e-6 for n, g in
           tparams.from_reference(_np_tree(jgrads)).items()}
    for name, p in model.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert err[big[name]].max(initial=0.0) <= 1e-3 * LR, name
        assert err.max(initial=0.0) <= 2 * LR, name


def test_eval_step_and_open_loop_metrics_match_reference(setup):
    jarch, tarch, scen, jmodel, jparams = setup
    batches = tdata.holdout_batches(scen, 3, 2, families=FAMILIES)
    model = _port_model(tarch, jparams)
    got = tsteps.make_sim_eval_step(model)(batches[0])
    want = jsteps.make_sim_eval_step(jmodel)(
        jparams, {k: jnp.asarray(v) for k, v in batches[0].items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    got = tsteps.open_loop_metrics(model, batches)
    want = jsteps.open_loop_metrics(jmodel, jparams, batches)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert tsteps.open_loop_metrics(model, [])["nll"] != \
        tsteps.open_loop_metrics(model, [])["nll"]       # nan


@pytest.mark.parametrize("arch", ["sim-absolute", "sim-rope2d",
                                  "sim-se2-repr"])
def test_train_step_of_each_table1_arch_matches_reference(arch):
    """The other three Table-I arches at the reduced size: the loss and
    every gradient of the port's default path (the plain flash forward and
    backward, the encoding's plain transforms; ``pose_proj`` for
    absolute) against ``jax.value_and_grad`` of the reference at
    ``attn_impl="ref"``, and one ``make_sim_train_step`` reporting the
    same loss and gradient norm."""
    jarch = jconfigs.get_sim_arch(arch).reduced()
    tarch = tconfigs.get_sim_arch(arch).reduced()
    scen = tarch.scenario_config()
    jmodel = jsim.AgentSimModel(jarch.agent_sim_config())
    jparams = jmodule.init_params(jmodel.specs(), jax.random.key(1))
    batch = _batch(scen, True)
    want_loss, want_grads = _jax_loss_and_grads(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(tarch, jparams).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tsim.action_nll(model(tb), tb["actions"], tb["agent_valid"])
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = tparams.from_reference(_np_tree(want_grads))
    assert set(want) == set(grads)
    assert ("pose_proj.kernel" in grads) == (arch == "sim-absolute")
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
    topt = tsteps.bc_optimizer(LR, STEPS)
    step = tsteps.make_sim_train_step(model, topt)
    _, metrics = step(topt.init(dict(model.named_parameters())), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               **LOSS_TOL)
    want_norm = np.sqrt(sum(float(np.sum(np.square(g.numpy())))
                            for g in want.values()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm,
                               rtol=1e-5)
