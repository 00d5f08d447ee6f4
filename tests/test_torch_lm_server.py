"""The port's LM ``Server`` on the CPU: the reference's serving-loop cases
(``tests/test_trainer_server.py``) at its config, run on the port with
the reference's weights (``params.from_reference``), and the port's greedy
tokens held to the reference ``Server``'s for the same requests.

Each slot's decode runs ``impl="auto"`` (the decode kernel's plain version
on the CPU); the reference's decodes ``"chunked"`` over the whole cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.nn.transformer import TransformerLM as JLM  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch import params  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.nn.transformer import build_model  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402
from test_torch_serving_utils import scribble_stale_rows  # noqa: E402

KW = dict(name="t", family="dense", num_layers=2, d_model=64,
          num_q_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          head_dim=16, dtype="float32")
CFG = ModelConfig(**KW)
JCFG = JModelConfig(**KW)


def reference_params(seed):
    return jmodule.init_params(JLM(JCFG).specs(), jax.random.key(seed))


def port_model(seed, impl=None):
    model = build_model(CFG, impl, device="cpu")
    model.load_state_dict(params.from_reference(
        jax.tree.map(np.asarray, reference_params(seed))), strict=True)
    return model


def solo(model, prompt, max_new, **kw):
    srv = Server(model, num_slots=1, max_len=64, **kw)
    srv.submit(Request(uid=0, prompt=prompt, max_new_tokens=max_new))
    return srv.run_until_drained()[0].generated


def test_server_continuous_batching():
    srv = Server(port_model(1), num_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    for uid in range(7):   # more requests than slots
        srv.submit(Request(uid=uid,
                           prompt=rng.integers(1, 100, rng.integers(2, 6)),
                           max_new_tokens=5))
    done = srv.run_until_drained()
    assert sorted(done) == list(range(7))
    for r in done.values():
        assert len(r.generated) == 5
        assert all(0 <= t < CFG.padded_vocab for t in r.generated)


def test_server_int8_slot_reuse_matches_solo():
    """5 requests over 2 int8 slots: every request's greedy tokens equal
    its solo decode in a fresh int8 server (quantize-on-write across slot
    recycling)."""
    model = port_model(4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 100, rng.integers(2, 7)) for _ in range(5)]
    refs = {uid: solo(model, p, 6, cache_dtype="int8")
            for uid, p in enumerate(prompts)}
    srv = Server(model, num_slots=2, max_len=64, cache_dtype="int8")
    for uid, p in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    done = srv.run_until_drained()
    assert sorted(done) == list(range(5))
    for uid in done:
        assert done[uid].generated == refs[uid], uid


def test_server_int8_eos_retirement():
    """The greedy continuation's third token declared the eos: the server
    stops there, and the early-freed slot serves the next request."""
    model = port_model(6)
    prompt = np.asarray([9, 33, 71], np.int32)
    ref = solo(model, prompt, 8, cache_dtype="int8")
    eos = ref[2]
    assert eos not in ref[:2], "degenerate continuation; pick another seed"
    srv = Server(model, num_slots=1, max_len=64, eos_id=eos,
                 cache_dtype="int8")
    srv.submit(Request(uid=0, prompt=prompt, max_new_tokens=8))
    srv.submit(Request(uid=1, prompt=prompt, max_new_tokens=2))
    done = srv.run_until_drained()
    assert done[0].generated == ref[:3]        # retired AT the eos token
    assert done[1].generated == ref[:2]        # recycled slot, same prefix


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_server_cursor_restart_masks_stale_rows(cache_dtype):
    """After a long request retires, every row of the slot is scribbled
    with NaN-laced garbage; the next request's tokens equal a fresh
    server's."""
    model = port_model(7)
    rng = np.random.default_rng(8)
    victim = rng.integers(1, 100, 5)
    ref = solo(model, victim, 6, cache_dtype=cache_dtype)
    srv = Server(model, num_slots=1, max_len=64, cache_dtype=cache_dtype)
    srv.submit(Request(uid=9, prompt=rng.integers(1, 100, 20),
                       max_new_tokens=30))     # long predecessor
    srv.run_until_drained()
    assert srv.slots[0].request is None
    scribble_stale_rows(srv.cache["group0"], np.zeros(1, np.int32),
                        srv.max_len, seed=2)
    assert torch.isnan(srv.cache["group0"]["v_scale" if cache_dtype == "int8"
                                           else "v"]).any()
    srv.submit(Request(uid=0, prompt=victim, max_new_tokens=6))
    assert srv.run_until_drained()[0].generated == ref


def test_server_matches_sequential_decode():
    """Continuous batching gives the same greedy tokens as a lone
    sequential decode of the same prompt (per-slot cursors)."""
    model = port_model(2)
    prompt = np.asarray([5, 17, 42], np.int32)
    ref = solo(model, prompt, 6)
    srv = Server(model, num_slots=4, max_len=64)
    rng = np.random.default_rng(3)
    srv.submit(Request(uid=10, prompt=rng.integers(1, 100, 7),
                       max_new_tokens=9))
    srv.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
    srv.submit(Request(uid=11, prompt=rng.integers(1, 100, 2),
                       max_new_tokens=3))
    srv.submit(Request(uid=12, prompt=rng.integers(1, 100, 4),
                       max_new_tokens=12))
    assert srv.run_until_drained()[0].generated == ref


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_server_matches_reference_server(cache_dtype):
    """The same 6 requests over 3 slots: the port's greedy tokens (impl
    "auto", and the reference's "chunked" path by name) equal the
    reference Server's, request by request."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 100, rng.integers(2, 9)) for _ in range(6)]
    news = [int(n) for n in rng.integers(3, 10, 6)]
    ref = jserver.Server(JLM(JCFG), reference_params(3), num_slots=3,
                         max_len=48, cache_dtype=cache_dtype)
    for uid, (p, n) in enumerate(zip(prompts, news)):
        ref.submit(jserver.Request(uid=uid, prompt=p, max_new_tokens=n))
    want = {uid: r.generated for uid, r in ref.run_until_drained().items()}
    for impl in ("auto", "chunked"):
        srv = Server(port_model(3, impl), num_slots=3, max_len=48,
                     cache_dtype=cache_dtype)
        for uid, (p, n) in enumerate(zip(prompts, news)):
            srv.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
        got = {uid: r.generated for uid, r in srv.run_until_drained().items()}
        assert got == want, impl
        assert srv.ticks == ref.ticks
