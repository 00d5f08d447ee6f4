"""The port's MoE layer (``repro_torch/nn/moe.py``) against the JAX
package's on the CPU.

The group-local dispatch and combine on the same routing (index outputs
equal, the buffer bitwise equal), with no assignment dropped (capacity
factor 8) and with drops (1); the layer's output, aux loss and gradients
with and without shared experts; a dropped assignment's token getting
only its shared experts' output; the optimizers over a reduced
deepseek-v2-lite's tree (the stacked (L, E, d, f) expert leaves, the
shared experts, MLA's ``kv_norm``, the one-layer dense ``group0``): AdamW
and adafactor (factored expert leaves) against the reference's, the state
carried both ways. Weights cross through ``params.from_reference``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.optim.transforms import apply_updates as japply  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import TransformerLM as JLM  # noqa: E402
from repro_torch import configs, optim, params  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.runtime import trainer as ttrainer  # noqa: E402

# tests/test_torch_lm.py's forward tolerance
FWD_TOL = dict(atol=1e-4, rtol=1e-3)
E, K, D, F = 8, 2, 32, 24
T = 40


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _routing(seed):
    """Tokens (T, D) and a top-k routing of them: distinct experts a token,
    skewed towards the low ids so that some experts overflow."""
    rng = np.random.default_rng(seed)
    xt = rng.normal(size=(T, D)).astype(np.float32)
    p = np.exp(-0.4 * np.arange(E))
    eid = np.stack([rng.choice(E, K, replace=False, p=p / p.sum())
                    for _ in range(T)]).astype(np.int32)
    w = rng.random((T, K)).astype(np.float32)
    return xt, eid, w


def _layer(cf):
    return jmoe.MoE(d_model=D, num_experts=E, top_k=K, expert_ff=F,
                    capacity_factor=cf)


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["no_drops", "drops"])
def test_dispatch_and_combine_match_reference(cf):
    xt, eid, w = _routing(0)
    cap = _layer(cf).capacity(T)
    assert cap == tmoe.MoE(D, E, K, F, capacity_factor=cf,
                           device="meta").capacity(T)
    want = jmoe._dispatch_local(jnp.asarray(xt), jnp.asarray(eid),
                                jnp.asarray(w), cap, E)
    got = tmoe._dispatch_local(*map(torch.from_numpy, (xt, eid, w)), cap, E)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, wnt in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    dropped = int((got[4] >= cap).sum())
    assert (dropped > 0) == (cf == 1.0), dropped
    eo = np.random.default_rng(1).normal(size=(E, cap, D)).astype(np.float32)
    y = tmoe._combine_local(torch.from_numpy(eo), *got[1:], cap, T)
    y_ref = jmoe._combine_local(jnp.asarray(eo), *want[1:], cap, T)
    assert y.dtype == torch.float32 and y.shape == (T, D)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-6,
                               rtol=1e-6)


def _pair(num_shared, cf, activation="silu", seed=0):
    ref = jmoe.MoE(d_model=D, num_experts=E, top_k=K, expert_ff=F,
                   num_shared=num_shared, capacity_factor=cf,
                   activation=activation)
    jp = jmodule.init_params(ref.specs(), jax.random.key(seed))
    port = tmoe.MoE(D, E, K, F, num_shared=num_shared, capacity_factor=cf,
                    activation=activation, device="cpu")
    port.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                         strict=True)
    return ref, jp, port


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["no_drops", "drops"])
@pytest.mark.parametrize("num_shared,activation",
                         [(0, "silu"), (2, "silu"), (1, "gelu")])
def test_moe_matches_reference(num_shared, activation, cf):
    """y and aux within the forward tolerance; the gradients of
    sum(y * c) + aux in x and every parameter within 1e-4 of each
    tensor's largest |g|."""
    ref, jp, port = _pair(num_shared, cf, activation)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, T // 2, D)).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def f(p, xx):
        y, aux = ref(p, xx)
        return jnp.sum(y * c) + aux, (y, aux)

    (_, (want_y, want_aux)), (jg_p, jg_x) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    port.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = port(tx)
    np.testing.assert_allclose(_np(y), _np(want_y), **FWD_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               **FWD_TOL)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(c)) + aux,
                                [tx] + [p for _, p in port.named_parameters()])
    want = {"x": np.asarray(jg_x), **{n: t.numpy() for n, t in
                                       params.from_reference(jax.tree.map(
                                           np.asarray, jg_p)).items()}}
    assert sorted(want) == sorted(["x"] + names)
    for n, g in zip(["x"] + names, grads):
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(g.numpy() - want[n]).max())
        assert err <= 1e-4 * scale + 1e-7, (n, err, scale)


def test_dropped_assignment_gets_only_the_shared_experts():
    """At capacity 8 rows an expert, the ninth token routed to one expert
    is dropped there: its output is its other expert's share plus the
    shared experts' (so the layer's output never reads a sentinel row)."""
    _, _, port = _pair(1, 1.0)
    n = 32
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, n, D)).astype(np.float32))
    x[..., 0] = 100.0
    with torch.no_grad():
        port.router[0, 0] = 1.0              # every token prefers expert 0
        port.router[0, 1:] = 0.0
        y, _ = port(x)
        ids, w, _ = port.route(x[0])
        cap = port.capacity(n)
        per_expert = torch.bincount(ids.flatten(), minlength=E)
        share = float((per_expert - cap).clamp(min=0).sum()) / ids.numel()
        assert cap == 8 and bool((ids[:, 0] == 0).all())
        # token `cap` is the first that expert 0 cannot take, and its other
        # expert takes it
        e1 = int(ids[cap, 1])
        assert int((ids[:cap + 1] == e1).sum()) <= cap
        assert share >= (n - cap) / (n * K)
        tok = x[0, cap]
        h = port.act(tok @ port.gate[e1]) * (tok @ port.up[e1])
        want = w[cap, 1] * (h @ port.down[e1]) + port.shared(tok)
    np.testing.assert_allclose(y[0, cap].numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _deepseek_tree():
    """The reduced deepseek-v2-lite's reference parameters (seed 7), drawn
    once for the module."""
    cfg = jconfigs.get_config("deepseek-v2-lite-16b").reduced(
        dtype="float32")
    specs = JLM(cfg).specs()
    return jax.jit(lambda key: jmodule.init_params(specs, key))(
        jax.random.key(7))


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizers_over_the_moe_tree_match_reference(which):
    """Two steps of AdamW or adafactor (min_dim_size_to_factor=32, so the
    (L, E, d, f) expert leaves factor over their last two axes) on the
    reduced deepseek-v2-lite's parameters against the reference's on its
    tree: the updates within 1e-5, the state's shapes exact and its values
    within 1e-5 (1e-7 absolute: a moment that cancels to near 0 keeps the
    rounding of its terms) and carried both ways."""
    jp = _deepseek_tree()
    model = build_model(configs.get_config("deepseek-v2-lite-16b").reduced(
        dtype="float32"), device="cpu")
    model.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                          strict=True)
    tparams = dict(model.named_parameters())
    assert tuple(tparams["groups.1.0.mlp.gate"].shape) == (8, 128, 64)
    assert "groups.0.0.mlp.gate.kernel" in tparams    # the dense group0
    assert "groups.1.1.mlp.shared.up.kernel" in tparams
    assert "groups.1.0.attn.kv_norm.scale" in tparams
    if which == "adamw":
        topt, jopt = optim.adamw(1e-3), joptim.adamw(1e-3)
    else:
        topt = optim.adafactor(1e-2, min_dim_size_to_factor=32)
        jopt = joptim.adafactor(1e-2, min_dim_size_to_factor=32)
    tstate, jstate = topt.init(tparams), jopt.init(jp)
    if which == "adafactor":
        slots = tstate["v"]["groups.1.1.mlp.gate"]
        assert {k: tuple(t.shape) for k, t in slots.items()} == {
            "vr": (8, 128), "vc": (8, 64)}
        assert np.shape(jstate["v"]["group1"]["mlp"]["gate"]["vr"]) == \
            (2, 8, 128)
    rng = np.random.default_rng(8)
    jupdate = jax.jit(jopt.update)
    for step in range(2):
        tg = {n: torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) for n, p in tparams.items()}
        jg = jax.tree.map(jnp.asarray, params.to_reference(tg))
        tup, tstate = topt.update(tg, tstate, tparams)
        jup, jstate = jupdate(jg, jstate, jp)
        want = params.from_reference(jax.tree.map(np.asarray, jup))
        assert sorted(want) == sorted(tup)
        for n in tup:
            np.testing.assert_allclose(tup[n].numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-9,
                                       err_msg=f"{n} step {step}")
        with torch.no_grad():
            optim.apply_updates(tparams, tup)
        jp = japply(jp, jup)
        to_ref = ttrainer.opt_state_to_reference
        got = jax.tree.map(np.asarray, to_ref(tstate))
        jax.tree.map(lambda a, b: (
            np.testing.assert_equal(a.shape, np.shape(b)),
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7)), got, jstate)
        back = ttrainer.opt_state_from_reference(
            jax.tree.map(np.asarray, jstate), tstate, "cpu")
        flat = lambda s: jax.tree.leaves(to_ref(s))  # noqa: E731
        for a, b in zip(flat(back), flat(tstate)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)
