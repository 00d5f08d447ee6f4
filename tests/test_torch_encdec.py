"""The port's encoder-decoder (whisper-base) against the JAX package on the
CPU.

At the reference's ``whisper-base.reduced(dtype="float32")`` (2 encoder
and 2 decoder layers, d_model 128, 4 heads x 32, 32 frames), weights
crossed by ``params.from_reference``: the parameter count of the full
config, the weights both ways, ``encode``, the full forward (the
reference at ``impl="ref"`` and at ``"flash"``, its Pallas kernels in
interpret mode), ``serve_step`` token by token against the reference's,
the decoded logits against the full forward (the reference's smoke test
skips that check for enc-dec, ``tests/test_archs_smoke.py:106``), one
train step's loss and gradients, and the launchers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import EncDecLM as JEncDec  # noqa: E402
from repro.optim.transforms import Optimizer as JOptimizer  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs, optim, params  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.nn import EncDecLM  # noqa: E402
from repro_torch.nn.module import count_params  # noqa: E402
from repro_torch.nn.transformer import build_model, unsupported  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ARCH = "whisper-base"
# the reference's count of whisper-base's specs
WHISPER_COUNT = 87_656_448
FWD_TOL = dict(atol=1e-4, rtol=1e-3)
# tests/test_archs_smoke.py:118-120
DECODE_TOL = dict(atol=2e-3, rtol=2e-2)
B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """A reduced model is a few hundred kilobytes: one intra-op thread runs
    it faster than a pool contending with the test workers (restored
    after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def pair():
    """(cfg, reference model, reference params, port model): the reduced
    float32 config, the port holding the reference's weights."""
    cfg = jconfigs.get_config(ARCH).reduced(dtype="float32")
    jm = JEncDec(cfg)
    jp = jmodule.init_params(jm.specs(), jax.random.key(0))
    tm = build_model(configs.get_config(ARCH).reduced(dtype="float32"),
                     device="cpu")
    tm.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                       strict=True)
    return cfg, jm, jp, tm


def _inputs(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)
                        ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    return frames, toks


def test_whisper_builds_with_the_reference_count():
    """Full width on meta: an EncDecLM with the reference's 87,656,448
    parameters (inside its smoke test's 6e7-1.2e8,
    ``tests/test_archs_smoke.py:135``); every registered config builds."""
    cfg = configs.get_config(ARCH)
    model = build_model(cfg, device="meta")
    assert isinstance(model, EncDecLM)
    want = jmodule.count_params(JEncDec(jconfigs.get_config(ARCH)).specs())
    assert count_params(model) == want == WHISPER_COUNT
    assert 6e7 <= want <= 1.2e8
    assert all(unsupported(configs.get_config(a)) is None
               for a in configs.ARCH_NAMES)


def test_params_round_trip(pair):
    """``from_reference`` then ``to_reference`` is the identity on the
    EncDecLM tree: the encoder, decoder and cross stacks, the two
    embeddings and the two final norms, bit for bit."""
    _, _, jp, tm = pair
    want = jax.tree.map(np.asarray, jp)
    got = params.to_reference(tm)
    assert sorted(got) == sorted(want) == sorted(
        ["cross", "dec_norm", "decoder", "embedding", "enc_norm", "encoder",
         "pos_embedding"])
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    for path, arr in flat_w.items():
        assert flat_g[path].shape == arr.shape, path
        np.testing.assert_array_equal(flat_g[path], arr, err_msg=str(path))
    # and back: the port's names and values, exactly
    again = params.from_reference(got)
    for name, t in tm.state_dict().items():
        assert torch.equal(again[name], t), name
    # the stacks are stacked even at one layer, as stack_specs stacks them
    one = params.reference_tensors({"cross.0.norm.scale": torch.ones(3)})
    assert one["cross"]["norm"]["scale"].shape == (1, 3)
    assert params.is_stacked("encoder.attn.q.kernel", ["encoder.0.x"])


def test_encode_matches_reference(pair):
    cfg, jm, jp, tm = pair
    frames, _ = _inputs(cfg, 1)
    want = jm.encode(jp, jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)


@pytest.mark.parametrize("jimpl,timpl", [("ref", "auto"), ("flash", "auto"),
                                         ("ref", "chunked")])
def test_forward_matches_reference(pair, jimpl, timpl):
    """The full forward: the reference at ``impl="ref"`` (the O(S^2)
    oracle) and ``"flash"`` (its Pallas kernels, interpret mode), the port
    through the flash kernels' plain versions ("auto" on the CPU) and the
    reference's chunked path."""
    cfg, _, jp, tm = pair
    frames, toks = _inputs(cfg, 2)
    want, jaux, _ = JEncDec(cfg, impl=jimpl)(jp, jnp.asarray(frames),
                                             jnp.asarray(toks))
    tm.impl = timpl
    for mod in tm.modules():
        if hasattr(mod, "impl"):
            mod.impl = timpl
    try:
        with torch.no_grad():
            got, aux, cache = tm(torch.from_numpy(frames),
                                 torch.from_numpy(toks))
    finally:
        for mod in tm.modules():
            if hasattr(mod, "impl"):
                mod.impl = "auto"
    assert cache is None and got.shape == (B, S, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_serve_step_matches_reference(pair, cache_dtype):
    """A 3-token prompt as one chunk at index 0, then token by token, through
    ``make_serve_step`` on both sides (the reference's ``"chunked"``
    attention over its whole cache; the port's decode kernel's plain
    version, cross-attention included), then the decoded logits against
    the port's own full forward over the same tokens."""
    cfg, jm, jp, tm = pair
    frames, toks = _inputs(cfg, 3)
    jenc = jm.encode(jp, jnp.asarray(frames))
    jserve = jax.jit(jsteps.make_serve_step(cfg))
    tserve = tsteps.make_serve_step(tm)
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(_np(tenc), _np(jenc), **FWD_TOL)
    jcache = jm.init_cache(B, 16, jnp.float32 if cache_dtype == "float32"
                           else jnp.int8)
    tcache = tm.init_cache(B, 16, cache_dtype)
    # the reference's block cache nests the rows under "attn"
    assert sorted(tcache) == sorted(jcache["attn"])
    for key, rows in jcache["attn"].items():
        assert tuple(tcache[key].shape) == rows.shape, key
    got_rows = []
    n_prompt = 3
    for start, stop in [(0, n_prompt)] + [(i, i + 1)
                                          for i in range(n_prompt, S)]:
        jlg, jcache = jserve(jp, jcache, jnp.asarray(toks[:, start:stop]),
                             jnp.int32(start), enc_out=jenc)
        tlg, tcache = tserve(tcache, torch.from_numpy(toks[:, start:stop]),
                             start, enc_out=tenc)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **DECODE_TOL,
                                   err_msg=f"{cache_dtype} at {start}")
        got_rows.append(tlg)
    # the port's decode against its full forward: the last logits of each
    # chunk (float32 cache; int8 within the reference's int8 tolerance)
    with torch.no_grad():
        full, _, _ = tm(torch.from_numpy(frames), torch.from_numpy(toks))
    want = full[:, [n_prompt - 1] + list(range(n_prompt, S))]
    tol = DECODE_TOL if cache_dtype == "float32" else dict(atol=8e-2,
                                                           rtol=8e-2)
    np.testing.assert_allclose(_np(torch.stack(got_rows, 1)), _np(want),
                               **tol)


def test_decode_matches_full_forward(pair):
    """Every position decoded token by token (per-slot cursors on the last
    steps) equals the full forward's (2e-3 / 2e-2, the reference's
    decode-vs-prefill tolerance)."""
    cfg, _, _, tm = pair
    frames, toks = _inputs(cfg, 4)
    with torch.no_grad():
        full, _, _ = tm(torch.from_numpy(frames), torch.from_numpy(toks))
        enc = tm.encode(torch.from_numpy(frames))
        cache = tm.init_cache(B, S, "float32")
        outs = []
        for i in range(S):
            index = i if i < S - 2 else torch.full((B,), i, dtype=torch.int32)
            lg, cache = tm.decode(torch.from_numpy(toks[:, i:i + 1]), enc,
                                  cache=cache, cache_index=index)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               **DECODE_TOL)


def test_train_step_matches_reference(pair):
    """One AdamW step: the loss, the gradient norm and every gradient
    (within 1e-4 of its tensor's largest |g|) against the reference's
    ``make_train_step`` on the same batch with random frames."""
    cfg, _, jp, _ = pair
    tm = build_model(configs.get_config(ARCH).reduced(dtype="float32"),
                     device="cpu")
    tm.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)))
    frames, toks = _inputs(cfg, 5)
    labels = np.roll(toks, -1, axis=1)
    batch = {"tokens": toks, "labels": labels, "frames": frames}
    lr = 3e-3
    inner = joptim.chain(joptim.clip_by_global_norm(1.0), joptim.adamw(lr))
    topt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(lr))

    def update(g, state, p):       # keeps the gradients it was given
        updates, new = inner.update(g, state["opt"], p)
        return updates, {"grads": g, "opt": new}

    jopt = JOptimizer(lambda p: {"grads": jax.tree.map(jnp.zeros_like, p),
                                 "opt": inner.init(p)}, update)
    _, jstate, jm = jax.jit(jsteps.make_train_step(cfg, jopt))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    step = tsteps.make_train_step(tm, topt)
    state = topt.init(dict(tm.named_parameters()))
    grads, metrics = step.grads(batch)
    want = {n: t.numpy() for n, t in params.from_reference(
        jax.tree.map(np.asarray, jstate["grads"])).items()}
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(g.numpy() - want[n]).max())
        # 1e-7 absolute: the key bias's gradient vanishes in exact
        # arithmetic (softmax is shift-invariant), so it is rounding alone
        assert err <= 1e-4 * scale + 1e-7, (n, err, scale)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(metrics["aux"]) == 0.0
    before = {n: p.clone() for n, p in tm.state_dict().items()}
    step.update(state, grads)
    assert any(not torch.equal(before[n], p)
               for n, p in tm.state_dict().items())


def test_prefill_step_is_the_full_forwards_last_logits(pair):
    cfg, _, _, tm = pair
    frames, toks = _inputs(cfg, 6)
    got = tsteps.make_prefill_step(tm)({"frames": torch.from_numpy(frames),
                                        "tokens": torch.from_numpy(toks)})
    with torch.no_grad():
        full, _, _ = tm(torch.from_numpy(frames), torch.from_numpy(toks))
    assert torch.equal(got, full[:, -1])


def test_launch_serve_refuses_whisper():
    """The reference's own ``SystemExit`` (``launch/serve.py:37-38``): its
    ``Server`` has no enc-dec path."""
    with pytest.raises(SystemExit, match="enc-dec"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_launch_train_whisper_runs_and_resumes(tmp_path):
    """``launch.train --arch whisper-base --reduced`` on the CPU: zero frames
    in every batch, the loss finite and falling, a checkpoint in the
    reference's layout that a second run resumes from."""
    def args(steps):
        return launch_train.build_parser().parse_args(
            ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
             "--ckpt-every", "3", "--ckpt-dir", str(tmp_path), "--device",
             "cpu", "--lr", "1e-2", "--steps", str(steps)])

    batch = launch_train.make_batch_fn(
        configs.get_config(ARCH).reduced(dtype="float32"), 16)(0, 0, 2)
    assert batch["frames"].shape == (2, 32, 128)
    assert not batch["frames"].any()
    out = launch_train.run(args(6))
    assert out["status"] == "done" and out["step"] == 6
    hist = out["history"]
    assert np.all(np.isfinite(hist)) and hist[-1] < hist[0]
    again = launch_train.run(args(8))
    assert again["step"] == 8 and len(again["history"]) == 2
