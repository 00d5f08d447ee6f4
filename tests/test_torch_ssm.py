"""The port's SSM mixers (``repro_torch/nn/ssm.py``, the RWKV channel mix
of ``nn/mlp.py`` and the SSM forms of ``nn/blocks.py::Block``) against
the JAX package's on the CPU.

The scans (``diag_ssm_scan``, ``selective_ssm_fused``), ``MambaMixer`` and
``RWKV6TimeMix`` each chunked from a nonzero carried state, one step at a
time, and with gradients (inputs, state and weights); ``RWKVChannelMix``
with and without ``shifted``; ``Block`` in rwkv6's exclusive form
(attention None, RWKV channel mix) and hymba's parallel form (attention
and Mamba, RMS-normed and averaged), without and with a cache. Weights
cross through ``params.from_reference``. The port scans a chunk by
doubling where the reference runs ``associative_scan``: the two sum in
other orders, so they agree within rounding (``TOL``), not bitwise.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.encodings import Rope1D as JRope1D  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import blocks as jblocks  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch import params  # noqa: E402
from repro_torch.core.encodings import Rope1D  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import blocks as tblocks  # noqa: E402
from repro_torch.nn import mlp as tmlp  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

# float32 sums in another order (tests/test_torch_lm.py's forward tolerance)
TOL = dict(atol=1e-4, rtol=1e-3)
# gradients, relative to each tensor's largest |g|
GRAD_REL = 1e-4
B, D, T = 2, 32, 32


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pair(jmod, tmod, seed):
    """The reference module's params and the port module holding them."""
    jp = jmodule.init_params(jmod.specs(), jax.random.key(seed))
    tmod.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                         strict=True)
    return jp, tmod


def _grads_close(got, want, what):
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(_np(g) - w).max())
        assert err <= GRAD_REL * scale + 1e-7, (what, name, err, scale)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

def test_diag_ssm_scan_matches_reference():
    """Four chunks of 8 from a nonzero h0, and the one-chunk case."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, (B, T, 6, 3)).astype(np.float32)
    b = rng.normal(size=(B, T, 6, 3)).astype(np.float32)
    h0 = rng.normal(size=(B, 6, 3)).astype(np.float32)
    for chunk in (8, T):
        want_all, want_last = jax.jit(functools.partial(
            jssm.diag_ssm_scan, chunk=chunk))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
        got_all, got_last = tssm.diag_ssm_scan(_t(a), _t(b), _t(h0),
                                               chunk=chunk)
        np.testing.assert_allclose(_np(got_all), _np(want_all), **TOL)
        np.testing.assert_allclose(_np(got_last), _np(want_last), **TOL)
    with pytest.raises(ValueError, match="divide"):
        tssm.diag_ssm_scan(_t(a), _t(b), _t(h0), chunk=5)


def _selective_inputs(seed, t=T, d=12, n=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 0.5, (B, t, d)).astype(np.float32),
            rng.normal(size=(B, t, n)).astype(np.float32),
            rng.normal(size=(B, t, n)).astype(np.float32),
            rng.normal(size=(B, t, d)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (d, n)).astype(np.float32),
            rng.normal(size=(B, d, n)).astype(np.float32))


def test_selective_ssm_fused_matches_reference():
    """y and h_last from a nonzero h0 over four chunks, and the gradients
    of every input through the per-chunk checkpoints."""
    ins = _selective_inputs(1)
    cot = np.random.default_rng(2).normal(size=(B, T, 12)).astype(np.float32)

    def jloss(*xs):
        y, h = jssm.selective_ssm_fused(*xs, chunk=8)
        return jnp.sum(y * cot) + jnp.sum(h * h), (y, h)

    (_, (want_y, want_h)), want_g = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, ins))
    tins = [_t(x).requires_grad_(True) for x in ins]
    got_y, got_h = tssm.selective_ssm_fused(*tins, chunk=8)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)
    loss = torch.sum(got_y * _t(cot)) + torch.sum(got_h * got_h)
    got_g = torch.autograd.grad(loss, tins)
    _grads_close(dict(enumerate(got_g)), dict(enumerate(want_g)), "fused")


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _mamba(seed):
    jmod = jssm.MambaMixer(d_model=D, d_inner=48, state_size=4, chunk=8)
    jp, tmod = _pair(jmod, tssm.MambaMixer(D, d_inner=48, state_size=4,
                                           chunk=8, device="cpu"), seed)
    # a_log at zeros gives every channel one decay: spread them
    rng = np.random.default_rng(seed)
    a_log = rng.normal(scale=0.5, size=(48, 4)).astype(np.float32)
    jp = dict(jp, a_log=jnp.asarray(a_log))
    with torch.no_grad():
        tmod.a_log.copy_(_t(a_log))
    return jmod, jp, tmod


def _rwkv(seed):
    jmod = jssm.RWKV6TimeMix(d_model=D, head_dim=8, decay_lora=16, chunk=8)
    return (jmod, *_pair(jmod, tssm.RWKV6TimeMix(
        D, head_dim=8, decay_lora=16, chunk=8, device="cpu"), seed))


MIXERS = {"mamba": _mamba, "rwkv6": _rwkv}


def _state(name, rng):
    """A nonzero carried state of each mixer (B slots)."""
    if name == "mamba":
        return {"h": rng.normal(size=(B, 48, 4)).astype(np.float32),
                "conv": rng.normal(size=(B, 3, 48)).astype(np.float32)}
    return {"s": rng.normal(size=(B, 4, 8, 8)).astype(np.float32),
            "shift": rng.normal(size=(B, D)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["chunked", "one_step"])
@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_matches_reference(name, mode):
    """From zeros (no state) and from a nonzero state: four chunks of 8
    (``chunked``), or four single-token steps carrying the state
    (``one_step``, the decode path); outputs and the new state."""
    jmod, jp, tmod = MIXERS[name](3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T if mode == "chunked" else 4, D)).astype(
        np.float32)
    if mode == "chunked":
        want, _ = jax.jit(jmod)(jp, jnp.asarray(x))
        got, _ = tmod(_t(x))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    state = _state(name, rng)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: _t(v) for k, v in state.items()}
    steps = [x] if mode == "chunked" else [x[:, i:i + 1] for i in range(4)]
    jcall = jax.jit(lambda jp, x, st: jmod(jp, x, state=st))
    with torch.no_grad():
        for xs in steps:
            want, jstate = jcall(jp, jnp.asarray(xs), jstate)
            got, tstate = tmod(_t(xs), tstate)
            np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for k in state:
        np.testing.assert_allclose(_np(tstate[k]), _np(jstate[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_gradients_match_reference(name):
    """Gradients of the input, the carried state and every weight through
    the chunked path from a nonzero state."""
    jmod, jp, tmod = MIXERS[name](5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    state = _state(name, rng)
    cot = rng.normal(size=(B, T, D)).astype(np.float32)
    skey = "h" if name == "mamba" else "s"

    def jloss(jp, x, st):
        y, new = jmod(jp, x, state=st)
        return jnp.sum(y * cot) + jnp.sum(new[skey] ** 2)

    want_p, want_x, want_s = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    tmod.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    tstate = {k: _t(v).requires_grad_(True) for k, v in state.items()}
    y, new = tmod(tx, tstate)
    loss = torch.sum(y * _t(cot)) + torch.sum(new[skey] ** 2)
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(
        loss, [tx, *tstate.values(), *tmod.parameters()])
    want = {"x": want_x, **{f"state.{k}": want_s[k] for k in state},
            **{n: t for n, t in params.from_reference(
                jax.tree.map(np.asarray, want_p)).items()}}
    _grads_close(dict(zip(["x", *(f"state.{k}" for k in state), *names],
                          grads)), want, name)


def test_rwkv_channel_mix_matches_reference():
    jmod = jmlp.RWKVChannelMix(D, 64)
    jp, tmod = _pair(jmod, tmlp.RWKVChannelMix(D, 64, device="cpu"), 7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, 5, D)).astype(np.float32)
    shifted = rng.normal(size=(B, 5, D)).astype(np.float32)
    for sh in (None, shifted):
        want = jmod(jp, jnp.asarray(x),
                    shifted=None if sh is None else jnp.asarray(sh))
        got = tmod(_t(x), shifted=None if sh is None else _t(sh))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block(form):
    """rwkv6's exclusive block (attention None, layer norms, the RWKV
    channel mix) or hymba's parallel one (windowed GQA with rope beside a
    Mamba mixer, RMS norms, a gated MLP)."""
    if form == "exclusive":
        jb = jblocks.Block(
            d_model=D, ssm=jssm.RWKV6TimeMix(d_model=D, head_dim=8, chunk=8),
            mlp=jmlp.RWKVChannelMix(D, 64), norm="layer")
        tb = tblocks.Block(
            D, None, tmlp.RWKVChannelMix(D, 64, device="cpu"), norm="layer",
            ssm=tssm.RWKV6TimeMix(D, head_dim=8, chunk=8, device="cpu"),
            device="cpu")
    else:
        jb = jblocks.Block(
            d_model=D,
            attention=jattn.Attention(
                d_model=D, num_q_heads=4, num_kv_heads=2, head_dim=8,
                encoding=JRope1D(head_dim=8), window=6, causal=True),
            ssm=jssm.MambaMixer(d_model=D, state_size=4, chunk=8),
            mlp=jmlp.GatedMLP(D, 64), parallel_ssm=True)
        tb = tblocks.Block(
            D, tattn.Attention(D, 4, 2, 8, encoding=Rope1D(head_dim=8),
                               window=6, device="cpu"),
            tmlp.GatedMLP(D, 64, device="cpu"),
            ssm=tssm.MambaMixer(D, state_size=4, chunk=8, device="cpu"),
            parallel_ssm=True, device="cpu")
    jp, tb = _pair(jb, tb, 9)
    return jb, jp, tb


@pytest.mark.parametrize("form", ["exclusive", "parallel"])
def test_block_matches_reference(form):
    """The full forward, then a cached run: a chunk of 16 tokens and 4
    single-token steps (the state and the shift carried in the port's
    stacked cache, written in place at layer 1 of 2), every output against
    the reference block's over its own cache."""
    jb, jp, tb = _block(form)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, 20, D)).astype(np.float32)
    pose = np.broadcast_to(np.arange(20, dtype=np.float32)[None, :, None],
                           (B, 20, 1))
    want, _, _ = jax.jit(lambda jp, x, pose: jb(jp, x, pose=pose))(
        jp, jnp.asarray(x[:, :16]), jnp.asarray(pose[:, :16]))
    got, aux = tb(_t(x[:, :16]), _t(pose[:, :16]).contiguous())
    assert aux is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jstep = jax.jit(lambda jp, x, pose, cache, index: jb(
        jp, x, pose=pose, cache=cache, cache_index=index, impl="chunked"))
    jcache = jb.init_cache(B, 24, jnp.float32)
    tcache = tb.init_cache(B, 24, torch.float32, layers=2)
    assert sorted(tcache) == sorted(
        (["k", "v"] if form == "parallel" else []) + ["ssm"]
        + (["cmix_shift"] if form == "exclusive" else []))
    assert tcache["ssm"][("h" if form == "parallel" else "s")].dtype == \
        torch.float32
    with torch.no_grad():
        for lo, hi in ((0, 16), (16, 17), (17, 18), (18, 19), (19, 20)):
            step = tattn.cache_step(lo, hi - lo, B, 24, "cpu")
            want, _, jcache = jstep(jp, jnp.asarray(x[:, lo:hi]),
                                    jnp.asarray(pose[:, lo:hi]), jcache,
                                    jnp.int32(lo))
            got, _ = tb(_t(x[:, lo:hi]), _t(pose[:, lo:hi]).contiguous(),
                        cache=tcache, layer=1, step=step)
            np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                       err_msg=f"{form} rows {lo}-{hi}")
    for k, v in jcache["ssm"].items():
        np.testing.assert_allclose(_np(tcache["ssm"][k][1]), _np(v), **TOL)
        assert not tcache["ssm"][k][0].any()      # layer 0 untouched
    if form == "exclusive":
        np.testing.assert_allclose(_np(tcache["cmix_shift"][1]),
                                   _np(jcache["cmix_shift"]), **TOL)
