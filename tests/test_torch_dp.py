"""The compressed data-parallel step against the reference, on the CPU.

* ``repro_torch.optim.compression`` against ``repro.optim.compression``,
  bitwise (both round half to even in float32).
* ``_int8_psum`` over the "pod" group of a 2 x 2 gloo world against the
  reference's under nested ``jax.vmap(axis_name=)``, bitwise: the scale
  is a max and the sum an integer one, exact in any order.
* ``make_compressed_dp_step`` on a least-squares loss with SGD, one rank
  against the reference's (1, 1) mesh: losses, weights and the residual.
* The sim DP step (``make_sim_dp_train_step``, int8 + error feedback over
  "pod") from shared weights (``params.from_reference``) over the same
  global batches: a one-rank (1, 1) mesh against the reference's
  in-process (1, 1) mesh, and four gloo ranks against the reference's
  (2, 2) mesh on four forced CPU devices in a subprocess. Parameters stay
  bitwise equal on every rank.
* The NaN guard: a global batch whose rows on one rank are NaN makes
  every rank's Trainer skip the step and leaves every rank's parameters,
  optimizer state and residual bitwise unchanged.

Parity tolerance. The int8 reduction rounds each gradient element to a
grid of amax / 127: where the two frameworks' float32 gradients straddle a
rounding boundary the element is sent one step apart, and AdamW, which
normalises each element, turns that into a parameter update apart by up
to the learning rate. So the losses are held at rtol 1e-5, and the
parameters at the reference trainer's atol 1e-6 / rtol 1e-5 in all but a
few of their 20 thousand elements (at most 0.5%), each of those within
the learning rate a step.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed.dp_compress import _int8_psum as j_int8_psum  # noqa
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
import torch_fleet_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LR, STEPS = 3e-3, 2

# The reference side of the step, run in this process at (1, 1) and in a
# subprocess on four forced CPU devices at (2, 2): writes the initial
# weights, the global batches and, per mesh, the losses and the final
# parameters.
REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.nn import agent_sim as jsim
from repro.nn import module as jmodule
from repro.scenarios.core import ScenarioConfig
from repro.training.data import make_sim_batch
from repro.training.steps import (bc_optimizer, make_sim_dp_train_step,
                                  sim_dp_state)

def reference_run(out, shape, scen_kw, cfg, lr, steps, batch=8):
    scen = ScenarioConfig(**scen_kw)
    model = jsim.AgentSimModel(jsim.AgentSimConfig(
        **cfg, num_actions=scen.num_actions))
    params = jmodule.init_params(model.specs(), jax.random.key(0))
    weights = jax.tree.map(np.asarray, params)
    batches = [make_sim_batch(0, i * batch, batch, scen) for i in range(steps)]
    mesh = jax.make_mesh(shape, ("pod", "data"))
    opt = bc_optimizer(lr, 10)
    step = jax.jit(make_sim_dp_train_step(model, opt, mesh, compress=True))
    state = sim_dp_state(opt, params)
    losses = []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    flat = {}
    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            flat["p/" + path] = np.asarray(t)
    walk(jax.tree.map(np.asarray, params), "")
    np.savez(out, weights=np.asarray(weights, dtype=object),
             batches=np.asarray(batches, dtype=object),
             losses=np.asarray(losses), **flat)

if __name__ == "__main__":
    import json
    reference_run(sys.argv[1], (2, 2), **json.loads(sys.argv[2]))
"""


def _reference_module():
    ns = {"__name__": "reference_dp"}
    exec(compile(REFERENCE, "reference_dp", "exec"), ns)
    return ns


def _spec():
    return dict(scen_kw=workers.SCEN_KW, cfg=workers.CFG, lr=LR, steps=STEPS)


# ---- compression -----------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": (rng.normal(size=(33,)) * 1e-3).astype(np.float32),
            "c": np.zeros((4,), np.float32)}


def test_compress_decompress_bitwise():
    g = _grads(0)
    want = jcomp.compress_gradients({k: jnp.asarray(v) for k, v in g.items()})
    got = tcomp.compress_gradients({k: torch.from_numpy(v)
                                    for k, v in g.items()})
    for k in g:
        np.testing.assert_array_equal(got[k]["q"].numpy(),
                                      np.asarray(want[k]["q"]))
        assert got[k]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[k]["scale"].numpy(),
                                      np.asarray(want[k]["scale"]))
    back_j = jcomp.decompress_gradients(want)
    back_t = tcomp.decompress_gradients(got)
    for k in g:
        np.testing.assert_array_equal(back_t[k].numpy(),
                                      np.asarray(back_j[k]))
    with pytest.raises(ValueError, match="int8"):
        tcomp.compress_gradients(g, bits=4)


def test_error_feedback_compressor_bitwise():
    jc, tc = jcomp.ErrorFeedbackCompressor(0.1), tcomp.ErrorFeedbackCompressor(
        0.1)
    g0 = _grads(1)
    rj = jc.init({k: jnp.asarray(v) for k, v in g0.items()})
    rt = tc.init({k: torch.from_numpy(v) for k, v in g0.items()})
    for seed in range(3):
        g = _grads(seed + 10)
        sj, rj = jc.compress({k: jnp.asarray(v) for k, v in g.items()}, rj)
        st, rt = tc.compress({k: torch.from_numpy(v) for k, v in g.items()},
                             rt)
        for k in g:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
            np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]))


def test_int8_psum_matches_reference_bitwise(tmp_path):
    rng = np.random.default_rng(3)
    g = rng.normal(size=(2, 2, 6, 5)).astype(np.float32)
    g[1, 0] *= 40.0                     # one member sets the shared scale
    np.savez(tmp_path / "g.npz", g=g)
    workers.spawn(workers.int8_psum_worker, 4, str(tmp_path),
                  str(tmp_path / "g.npz"))
    summed, sent = jax.vmap(jax.vmap(lambda x: j_int8_psum(x, "pod"),
                                     axis_name="data"),
                            axis_name="pod")(jnp.asarray(g))
    for rank in range(4):
        pod, data = divmod(rank, 2)
        got = np.load(tmp_path / f"psum{rank}.npz")
        np.testing.assert_array_equal(got["summed"],
                                      np.asarray(summed[pod, data]))
        np.testing.assert_array_equal(got["sent"], np.asarray(sent[pod, data]))


# ---- the sim DP step -------------------------------------------------------

def _assert_params_close(got, want, label):
    keys = sorted(k for k in want if k.startswith("p/"))
    assert sorted(k for k in got if k.startswith("p/")) == keys
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([want[k].ravel() for k in keys])
    off = ~np.isclose(a, b, atol=1e-6, rtol=1e-5)
    assert off.mean() <= 5e-3, (label, int(off.sum()), a.size)
    assert np.abs(a - b).max() <= STEPS * LR * 1.01, (label,
                                                      np.abs(a - b).max())


def _port_run(tmp_path, world, pods, data_path, nan_rank=-1):
    out = tmp_path / f"port{world}"
    out.mkdir()
    workers.spawn(workers.dp_worker, world, str(out), pods, str(data_path),
                  1, nan_rank)
    return [dict(np.load(out / f"dp{r}.npz")) for r in range(world)]


def test_dp_step_matches_reference_one_by_one(tmp_path):
    """The port on a one-rank (1, 1) mesh against the reference's (1, 1)
    mesh in this process: the pod axis has size 1, and both still reduce
    over it in int8 with error feedback."""
    path = tmp_path / "ref11.npz"
    _reference_module()["reference_run"](str(path), (1, 1), **_spec())
    want = dict(np.load(path, allow_pickle=True))
    got = _port_run(tmp_path, 1, 1, path)[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(got, want, "(1, 1)")


def test_dp_step_matches_reference_two_by_two(tmp_path):
    """Four gloo ranks against the reference's (2, 2) mesh on four forced
    CPU devices (a subprocess with its own time limit); every rank ends
    with the same parameters, bitwise. Rank 3's rows of a first batch are
    NaN: every rank skips it and keeps its state bitwise."""
    path = tmp_path / "ref22.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = tmp_path / "reference_dp.py"
    script.write_text(REFERENCE)
    import json
    subprocess.run([sys.executable, str(script), str(path),
                    json.dumps(_spec())], env=env, check=True, timeout=240)
    want = dict(np.load(path, allow_pickle=True))
    runs = _port_run(tmp_path, 4, 2, path, nan_rank=3)
    for rank, got in enumerate(runs):
        assert int(got["nan_skipped"]) == 1, rank
        assert bool(got["nan_unchanged"]), rank
        np.testing.assert_array_equal(got["losses"], runs[0]["losses"])
        for k in got:
            if k.startswith("p/"):
                np.testing.assert_array_equal(got[k], runs[0][k], err_msg=k)
    np.testing.assert_allclose(runs[0]["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(runs[0], want, "(2, 2)")


def test_generic_dp_step_matches_reference(tmp_path):
    """``make_compressed_dp_step`` itself, on a least-squares loss with
    SGD, one rank on a (1, 1) mesh against the reference's in this
    process: the quantized update, the residual and the losses."""
    from repro.distributed.dp_compress import make_compressed_dp_step
    from repro.optim import sgd
    rng = np.random.default_rng(7)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    x = rng.normal(size=(3, 8, 5)).astype(np.float32)
    y = rng.normal(size=(3, 8, 3)).astype(np.float32)
    np.savez(tmp_path / "ls.npz", w=w, x=x, y=y)
    workers.spawn(workers.generic_dp_worker, 1, str(tmp_path),
                  str(tmp_path / "ls.npz"))
    got = np.load(tmp_path / "generic0.npz")
    opt = sgd(0.1)
    step = jax.jit(make_compressed_dp_step(
        lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), opt,
        jax.make_mesh((1, 1), ("pod", "data"))))
    params = {"w": jnp.asarray(w)}
    state, residual, losses = opt.init(params), {"w": jnp.zeros_like(
        params["w"])}, []
    for i in range(x.shape[0]):
        params, state, residual, loss = step(
            params, state, residual, {"x": jnp.asarray(x[i]),
                                      "y": jnp.asarray(y[i])})
        losses.append(float(loss))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["w"], np.asarray(params["w"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["r"], np.asarray(residual["w"]),
                               rtol=1e-5, atol=1e-6)


def test_batch_must_divide_the_shards(tmp_path):
    """The step raises when the global batch does not divide the mesh's
    DP shards (checked by the port's rows helper without a process
    group, on a stand-in mesh)."""
    from repro_torch.distributed.dp_compress import local_rows
    with pytest.raises(ValueError, match="does not divide"):
        local_rows({"x": np.zeros((6, 2))}, {"pod": 2, "data": 2})
