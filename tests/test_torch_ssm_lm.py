"""The SSM families' LMs (hymba-1.5b, rwkv6-7b) in the port against the
JAX package on the CPU, at the reduced configs (float32).

Parameter counts of the full configs on ``meta``; the ``params`` round
trip (hymba's three single-layer global groups unstacked, as the
reference keeps them); the full forward (``impl`` "auto" and "chunked",
hymba's window biting); a chunk and then token-by-token decode against
the full forward with float32 and int8 caches (the recurrent state never
int8); one AdamW train step against the reference's, remat bitwise
equal to no remat; the ``Server`` against the reference's on a fresh
server of exactly ``num_slots`` requests, token for token; and, port
only, a request re-admitted into a used slot equal to its solo run (the
port zeroes the slot's recurrent state at admission, which the reference
does not); ``launch.serve`` and ``launch.train`` at ``--reduced --device
cpu``. Weights cross through ``params.from_reference``; the reference
runs its default (non-Pallas) paths.
"""
import argparse
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import TransformerLM as JLM  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs, optim, params  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn.module import count_params  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402

ARCHS = ("hymba-1.5b", "rwkv6-7b")
# the reference's own counts of the full configs' specs
COUNTS = {"hymba-1.5b": 1_662_670_400, "rwkv6-7b": 7_534_944_256}
FWD_TOL = dict(atol=1e-4, rtol=1e-3)
# tests/test_archs_smoke.py:118-120
DECODE_TOL = dict(atol=2e-3, rtol=2e-2)
# tokens a sequence, and the first decode chunk (the reduced scan chunk)
B, S, CHUNK = 2, 32, 16
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Models of a few hundred kilobytes: one intra-op thread beside the
    other test workers (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reduced float32 config, the reference model and its weights
    (seed 0), made once a module: JAX draws them leaf by leaf."""
    cfg = jconfigs.get_config(arch).reduced(dtype="float32")
    jm = JLM(cfg)
    return cfg, jm, jmodule.init_params(jm.specs(), jax.random.key(0))


def pair(arch, impl=None):
    """(cfg, reference model, reference params, port model) at the reduced
    float32 config, the port holding the reference's weights."""
    cfg, jm, jp = _reference(arch)
    tm = build_model(configs.get_config(arch).reduced(dtype="float32"), impl,
                     device="cpu")
    tm.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                       strict=True)
    return cfg, jm, jp, tm


def tokens(cfg, seed, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    """The reference's train-step loss and gradients (its ``loss_fn``,
    float32, no remat) over a batch of ``S`` tokens, with the logits of
    its forward: (batch, loss, logits, gradients), one compile an arch
    for the forward and the train-step tests."""
    cfg, jm, jp = _reference(arch)
    toks = tokens(cfg, 3, S + 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(p):
        logits, aux, _ = jm(p, jnp.asarray(batch["tokens"]), remat=False)
        return jsteps.lm_loss(logits, jnp.asarray(batch["labels"])) + aux, \
            logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    return batch, float(loss), np.asarray(logits), jax.tree.map(np.asarray,
                                                                grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_on_meta(arch):
    model = build_model(configs.get_config(arch), device="meta")
    want = jmodule.count_params(JLM(jconfigs.get_config(arch)).specs())
    assert count_params(model) == want == COUNTS[arch]
    if arch == "hymba-1.5b":            # 1 global, 14 local, 1, 15, 1
        assert [len(g) for g in model.groups] == [1, 14, 1, 15, 1]
        assert [g[0].attn.window for g in model.groups] == \
            [None, 1024, None, 1024, None]
    else:
        assert model.groups[0][0].attn is None


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    tree = jax.tree.map(np.asarray, _reference(arch)[2])
    flat = params.from_reference(tree)
    model = build_model(configs.get_config(arch).reduced(dtype="float32"),
                        device="cpu")
    model.load_state_dict(flat, strict=True)
    jax.tree.map(np.testing.assert_array_equal, params.to_reference(model),
                 tree)
    if arch == "hymba-1.5b":
        for name in ("groups.0.0.ssm.a_log", "groups.2.0.ssm.conv",
                     "groups.4.0.attn_out_norm.scale",
                     "groups.1.0.ssm_out_norm.scale",
                     "groups.3.0.ssm.dt_proj.bias"):
            assert name in flat, name
    else:
        for name in ("groups.0.1.ssm.mix_w", "groups.0.0.ssm.w_lora_b.kernel",
                     "groups.0.1.ssm.bonus", "groups.0.0.ssm.ln_bias",
                     "groups.0.1.mlp.mix_k",
                     "groups.0.0.mlp.receptance.kernel"):
            assert name in flat, name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    batch, _, want, _ = _reference_step(arch)
    _, _, _, tm = pair(arch)
    for impl in ("auto", "chunked"):
        tm.impl = impl
        with torch.no_grad():
            got, aux, cache = tm(torch.from_numpy(batch["tokens"]))
        assert cache is None and float(aux) == 0.0
        np.testing.assert_allclose(_np(got), want, **FWD_TOL,
                                   err_msg=f"{arch} impl={impl}")


def _reference_decode(jm, jp, toks, cache_dtype):
    """The reference's run of :func:`_decode`: its cache and its
    ("chunked") decode, one compile for the chunk and one for the steps."""
    cache = jm.init_cache(B, S + 3, getattr(jnp, cache_dtype))
    run = jax.jit(lambda jp, t, c, i: jm(jp, t, cache=c, cache_index=i,
                                         remat=False))
    first, _, cache = run(jp, jnp.asarray(toks[:, :CHUNK]), cache,
                          jnp.int32(0))
    outs = [first]
    for i in range(CHUNK, S):
        lg, _, cache = run(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                           jnp.full((B,), i, jnp.int32))
        outs.append(lg)
    return jnp.concatenate(outs, 1)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, cache_dtype):
    """A chunk of 16 tokens (the reduced scan chunk) written at 0, then one
    token a step at per-slot cursors: with a float32 cache against the
    full forward, with an int8 cache against the reference's int8 decode
    (the float32 decode meets the reference's in the server test). The
    recurrent state is float32 with either cache: h and s always, the
    others the compute dtype where the cache is int8. (hymba's int8
    decode drifts about 0.1 from its full forward in the reference too,
    past tests/test_decode.py:434's 8e-2.)"""
    cfg, jm, jp, tm = pair(arch)
    toks = tokens(cfg, 2)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, _, _ = tm(tt)
        cache = tm.init_cache(B, S + 3, cache_dtype)
        for gc in cache.values():
            state = dict(gc["ssm"], **({"cmix_shift": gc["cmix_shift"]}
                                       if "cmix_shift" in gc else {}))
            for key, t in state.items():
                assert t.dtype == torch.float32, (key, t.dtype)
        first, _, cache = tm(tt[:, :CHUNK], cache=cache, cache_index=0)
        outs = [first]
        for i in range(CHUNK, S):
            lg, _, cache = tm(tt[:, i:i + 1], cache=cache,
                              cache_index=torch.full((B,), i))
            outs.append(lg)
    got = torch.cat(outs, 1)
    if cache_dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(full), **DECODE_TOL)
    else:
        np.testing.assert_allclose(
            _np(got), _np(_reference_decode(jm, jp, toks, cache_dtype)),
            **DECODE_TOL, err_msg="against the reference's decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """The port's train step (clip + AdamW) against the reference's loss
    and gradients: loss, grad_norm and every gradient (within 1e-4 of its
    tensor's largest |g|); the remat gradients bitwise equal to those
    without remat; the update consumes them and leaves finite weights."""
    batch, want_loss, _, want_g = _reference_step(arch)
    _, _, _, tm = pair(arch)
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(LR))
    plain = tsteps.make_train_step(tm, opt, remat=False).grads(batch)[0]
    step = tsteps.make_train_step(tm, opt)
    grads, metrics = step.grads(batch)
    assert sorted(grads) == sorted(plain)
    for n, g in grads.items():
        assert torch.equal(g, plain[n]), n
    want = params.from_reference(want_g)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        scale = float(want[n].abs().max())
        err = float((g - want[n]).abs().max())
        assert err <= 1e-4 * scale + 1e-7, (n, err, scale)
    want_norm = float(np.sqrt(sum(
        np.sum(np.square(w.numpy(), dtype=np.float64))
        for w in want.values())))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm,
                               rtol=1e-5)
    before = {n: p.clone() for n, p in tm.state_dict().items()}
    step.update(opt.init(dict(tm.named_parameters())), grads)
    assert not grads                         # the update consumed them
    for n, p in tm.state_dict().items():
        assert torch.isfinite(p).all() and not torch.equal(p, before[n]), n


def _requests(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(1, cfg.vocab_size, rng.integers(2, 9)),
             int(rng.integers(3, 9))) for uid in range(n)]


def _serve(model, requests, slots, max_len=48):
    srv = Server(model, num_slots=slots, max_len=max_len)
    for uid, prompt, new in requests:
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    return {uid: r.generated for uid, r in srv.run_until_drained().items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_reference_server(arch):
    """Three requests through three slots of a fresh server (no slot is
    used twice, where the two servers part): the greedy tokens equal the
    reference Server's, request by request."""
    cfg, jm, jp, tm = pair(arch)
    requests = _requests(cfg, 11, 3)
    ref = jserver.Server(jm, jp, num_slots=3, max_len=48,
                         cache_dtype="float32")
    for uid, prompt, new in requests:
        ref.submit(jserver.Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
    want = {uid: r.generated for uid, r in ref.run_until_drained().items()}
    assert _serve(tm, requests, 3) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_readmitted_request_equals_solo_run(arch, monkeypatch):
    """Five requests through two slots: each, the three re-admitted into a
    used slot among them, equals its run alone in a fresh one-slot
    server. Without the reset at admission the re-admitted ones start from
    the slot's last state and part (the reference's behaviour)."""
    cfg, _, _, tm = pair(arch)
    requests = _requests(cfg, 12, 5)
    got = _serve(tm, requests, 2)
    for req in requests:
        assert got[req[0]] == _serve(tm, [req], 1)[req[0]], req[0]
    monkeypatch.setattr(type(tm), "reset_slots",
                        staticmethod(lambda cache, slots: None))
    assert _serve(tm, requests, 2) != got


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_cpu(arch, tmp_path):
    assert launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--max-new", "4"]) == 0
    out = launch_train.run(argparse.Namespace(
        **{**vars(launch_train.build_parser().parse_args(
            ["--arch", arch, "--reduced", "--device", "cpu"])),
           "steps": 3, "batch": 2, "seq": 32, "ckpt_every": 3,
           "ckpt_dir": str(tmp_path)}))
    assert out["status"] == "done" and len(out["history"]) == 3
    assert all(np.isfinite(out["history"]))
