"""The port's multi-head latent attention (``MLAttention`` in
``repro_torch/nn/attention.py``) against the JAX package's on the CPU.

The full forward (queries with and without ``q_lora_rank``) at the port's
``impl="ref"`` and ``"plain"`` (the flash kernels' plain versions) against
the reference's ``"ref"`` and ``"flash"`` (Pallas in interpret mode); the
absorbed decode over a prefill chunk and four ticks, with int and per-slot
cursors, at ``"auto"`` (the decode kernel's plain version reading the
values as the latent rows' first columns) and ``"chunked"``, against the
reference's decode and the port's own full forward; the int8 cache's
refusal; and ``decode_plain`` given V as a column view of the cached rows,
bitwise equal to the call on a copy. Weights cross through
``params.from_reference``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.nn import attention as jattn  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro_torch import params  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402

# tests/test_torch_lm.py's tolerances
FWD_TOL = dict(atol=1e-4, rtol=1e-3)
DECODE_TOL = dict(atol=2e-3, rtol=2e-2)
D_MODEL, HEADS = 64, 4
DIMS = dict(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=16, v_head_dim=24)
B, S, PREFILL, TICKS = 2, 12, 8, 4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _pair(q_lora_rank=None, seed=0):
    ref = jattn.MLAttention(d_model=D_MODEL, num_heads=HEADS,
                            q_lora_rank=q_lora_rank, **DIMS)
    jp = jmodule.init_params(ref.specs(), jax.random.key(seed))
    port = tattn.MLAttention(D_MODEL, HEADS, q_lora_rank=q_lora_rank,
                             device="cpu", **DIMS)
    port.load_state_dict(params.from_reference(jax.tree.map(np.asarray, jp)),
                         strict=True)
    return ref, jp, port


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, s, D_MODEL)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.float32)[None, :, None],
                          (B, s, 1)).copy()
    return x, pos


@pytest.mark.parametrize("impls", [("ref", "ref"), ("plain", "flash")],
                         ids=["ref", "plain_vs_flash"])
@pytest.mark.parametrize("q_lora_rank", [None, 24])
def test_mla_forward_matches_reference(q_lora_rank, impls):
    port_impl, ref_impl = impls
    ref, jp, port = _pair(q_lora_rank)
    x, pos = _inputs(1)
    want, cache = ref(jp, jnp.asarray(x), jnp.asarray(pos), impl=ref_impl)
    assert cache is None
    got = port(torch.from_numpy(x), torch.from_numpy(pos), impl=port_impl)
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)


def _port_decode(port, x, pos, impl, vector, max_len):
    """A prefill chunk of PREFILL tokens, then a token a tick: the logits of
    every position, and the cache."""
    cache = port.init_cache(B, max_len, torch.float32)
    assert tuple(cache["ckv"].shape) == (1, B, 1, max_len, 48)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    step = tattn.cache_step(0, PREFILL, B, max_len, "cpu")
    outs = [port(xt[:, :PREFILL], pt[:, :PREFILL], cache=cache, layer=0,
                 step=step, impl=impl)]
    for i in range(PREFILL, PREFILL + TICKS):
        idx = torch.full((B,), i) if vector else i
        step = tattn.cache_step(idx, 1, B, max_len, "cpu")
        outs.append(port(xt[:, i:i + 1], pt[:, i:i + 1], cache=cache,
                         layer=0, step=step, impl=impl))
    return torch.cat(outs, 1)


def _reference_decode(ref, jp, x, pos, max_len):
    cache = ref.init_cache(B, max_len, jnp.float32)
    out, cache = ref(jp, jnp.asarray(x[:, :PREFILL]),
                     jnp.asarray(pos[:, :PREFILL]), cache=cache,
                     cache_index=0)
    outs = [out]
    for i in range(PREFILL, PREFILL + TICKS):
        out, cache = ref(jp, jnp.asarray(x[:, i:i + 1]),
                         jnp.asarray(pos[:, i:i + 1]), cache=cache,
                         cache_index=jnp.int32(i))
        outs.append(out)
    return jnp.concatenate(outs, 1)


@pytest.mark.parametrize("q_lora_rank", [None, 24])
def test_mla_absorbed_decode_matches_reference(q_lora_rank):
    """Prefill + 4 ticks through the latent cache (absorbed queries, the
    values read from the cached rows) against the reference's absorbed
    decode and against the full forward, with int and per-slot cursors."""
    ref, jp, port = _pair(q_lora_rank, seed=2)
    n = PREFILL + TICKS
    x, pos = _inputs(3, n)
    max_len = n + 3
    want = _reference_decode(ref, jp, x, pos, max_len)
    full = port(torch.from_numpy(x), torch.from_numpy(pos), impl="ref")
    for impl, vector in (("auto", False), ("auto", True), ("plain", True),
                         ("chunked", False), ("chunked", True)):
        got = _port_decode(port, x, pos, impl, vector, max_len)
        what = f"impl={impl} vector={vector}"
        np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL,
                                   err_msg=what + " vs the reference")
        np.testing.assert_allclose(_np(got), _np(full), **DECODE_TOL,
                                   err_msg=what + " vs the full forward")


def test_mla_int8_cache_raises():
    _, _, port = _pair()
    with pytest.raises(NotImplementedError, match="int8"):
        port.init_cache(B, 16, "int8")
    assert port.init_cache(B, 16, "bfloat16")["ckv"].dtype == torch.bfloat16


@pytest.mark.parametrize("sq", [1, 5])
def test_decode_plain_reads_values_from_the_latent_rows(sq):
    """V as the first r columns of the (r + dr)-wide cached rows, read at
    layer 1 of a stacked cache, equals the call on a contiguous copy
    bitwise; past-cursor rows hold NaN and reach neither."""
    rng = np.random.default_rng(4)
    r, dr, s = 32, 16, 40
    rows = torch.from_numpy(rng.normal(size=(2, 3, 1, s, r + dr)).astype(
        np.float32))
    kvl = torch.tensor([5, 23, 40], dtype=torch.int32)
    past = torch.arange(s)[None, :] >= kvl[:, None].long()
    rows = torch.where(past[None, :, None, :, None], float("nan"), rows)
    q = torch.from_numpy(rng.normal(size=(3, 4, sq, r + dr)).astype(
        np.float32))
    opts = dict(scale=0.2)
    if sq > 1:
        opts["q_times"] = (kvl[:, None] - sq + torch.arange(sq)).int()
        opts["k_times"] = torch.arange(s, dtype=torch.int32)[None].expand(
            3, s).contiguous()
    view = rows[..., :r]
    got = fd.decode_plain(q, rows, view, kvl, layer=1, **opts)
    copy = fd.decode_plain(q, rows, view.contiguous(), kvl, layer=1, **opts)
    assert got.shape == (3, 4, sq, r) and bool(torch.isfinite(got).all())
    assert torch.equal(got, copy)
    # the CPU wrapper takes the view too (the card's reads it at its pitch)
    assert torch.equal(fd.flash_decode(q, rows, view, kvl, layer=1, **opts),
                       got)
