"""Parity: ``repro_torch.prng`` against ``jax.random`` (jax 0.9.0, Threefry,
``jax_threefry_partitionable`` on), on the CPU.

Key data, ``fold_in``, the 32-bit words and the uniforms are held bitwise
(integer arithmetic, and the uniform's float is built from the bits). The
Gumbel noise ``-log(-log(u))`` is held within 1e-6 absolute: the two
frameworks' float32 ``log`` may round differently by an ulp. So
``categorical`` may pick another action where the top two perturbed scores
lie that close; every disagreement must be such a near-tie (gap under
1e-5), and they are counted. Seeds come from hypothesis over the int32
range and past it (jax keeps a seed mod 2^32 while x64 is off).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.runtime.rollout import rollout_keys as j_rollout_keys  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.runtime.rollout import rollout_keys  # noqa: E402

SEEDS = st.integers(min_value=-(2 ** 31), max_value=2 ** 31 - 1) | \
    st.sampled_from([0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 2 ** 32 - 1,
                     2 ** 32 + 7, 2 ** 40 + 3])
DATA = st.integers(min_value=0, max_value=2 ** 32 - 1)
FAST = settings(max_examples=25, deadline=None)
NEAR_TIE = 1e-5


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


@FAST
@given(seed=SEEDS, data=DATA)
def test_key_and_fold_in_match_jax(seed, data):
    k = jax.random.key(seed)
    tk = prng.key(seed)
    np.testing.assert_array_equal(prng.key_data(tk), _kd(k))
    np.testing.assert_array_equal(
        prng.key_data(prng.fold_in(tk, data)), _kd(jax.random.fold_in(k,
                                                                      data)))
    # the host form of one lane's key
    lane = prng.lane_key(seed, data, 3)
    want = _kd(jax.random.fold_in(jax.random.fold_in(k, data), 3))
    assert tuple(int(x) for x in want) == lane


def test_fold_in_takes_what_jax_takes():
    """A Python int outside uint32 raises, as jax's conversion does; an
    integer tensor wraps mod 2^32, as a traced int32 step does."""
    tk = prng.key(5)
    for bad in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            prng.fold_in(tk, bad)
    keys = prng.key(5).expand(3, 2)
    steps = torch.tensor([-5, 0, 2 ** 31 - 1], dtype=torch.int32)
    want = jax.vmap(jax.random.fold_in)(
        jnp.stack([jax.random.key(5)] * 3), jnp.asarray(steps.numpy()))
    np.testing.assert_array_equal(prng.key_data(prng.fold_in(keys, steps)),
                                  _kd(want))


@FAST
@given(k1=DATA, k2=DATA, seed=st.integers(0, 2 ** 31 - 1))
def test_threefry2x32_matches_jax(k1, k2, seed):
    counts = np.random.default_rng(seed).integers(0, 2 ** 32, 16,
                                                  dtype=np.uint32)
    want = np.asarray(jprng.threefry_2x32(
        (jnp.uint32(k1), jnp.uint32(k2)), jnp.asarray(counts)))
    x1 = torch.from_numpy(counts[:8].astype(np.int64))
    x2 = torch.from_numpy(counts[8:].astype(np.int64))
    y1, y2 = prng.threefry2x32(k1, k2, x1, x2)
    got = torch.cat([y1, y2]).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@FAST
@given(seed=SEEDS, shape=st.sampled_from([(12, 63), (3, 5, 7), (1,),
                                          (2, 1, 33)]))
def test_bits_and_uniforms_match_jax(seed, shape):
    k = jax.random.key(seed)
    tk = prng.key(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(tk, shape, minval=tiny).numpy(),
        np.asarray(jax.random.uniform(k, shape, minval=tiny)))


@FAST
@given(seed=SEEDS)
def test_batched_bits_match_vmap(seed):
    """A (B, 2) batch of keys gives vmap's (B, A, K) words and uniforms."""
    base = jax.random.key(seed)
    keys = jnp.stack([jax.random.fold_in(base, i) for i in range(4)])
    tkeys = torch.from_numpy(_kd(keys).astype(np.int64))
    want = jax.vmap(lambda key: jax.random.bits(key, (3, 9), jnp.uint32))(
        keys)
    np.testing.assert_array_equal(
        prng.random_bits(tkeys, (3, 9)).numpy().astype(np.uint32),
        np.asarray(want))
    want_u = jax.vmap(lambda key: jax.random.uniform(key, (3, 9)))(keys)
    np.testing.assert_array_equal(prng.uniform(tkeys, (3, 9)).numpy(),
                                  np.asarray(want_u))


@FAST
@given(seed=SEEDS)
def test_gumbel_within_an_ulp_of_log(seed):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.gumbel(k, (12, 63)))
    got = prng.gumbel(prng.key(seed), (12, 63)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 7, -3])
def test_categorical_matches_vmap_categorical(seed):
    """A tick's shape, 64 lanes x 12 agents x 63 actions, each lane at its
    own step: actions equal except at near-ties, which are counted."""
    rng = np.random.default_rng(seed & 0xFFFF)
    logits = (rng.normal(size=(64, 12, 63)) * 3).astype(np.float32)
    steps = rng.integers(-5, 40, 64).astype(np.int32)
    base = jax.random.key(seed)
    keys = jnp.stack([jax.random.fold_in(base, i) for i in range(64)])
    keys_t = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(steps))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys_t,
                                                       jnp.asarray(logits)))
    tkeys = prng.fold_in(torch.from_numpy(_kd(keys).astype(np.int64)),
                         torch.from_numpy(steps))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    noise = np.asarray(jax.vmap(lambda key: jax.random.gumbel(key, (12, 63)))(
        keys_t))
    top2 = np.sort(noise + logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    differ = got != want
    assert (gap[differ] < NEAR_TIE).all(), gap[differ]
    assert differ.sum() <= 2, f"{differ.sum()} near-tie disagreements"
    assert got.dtype == np.int64


def test_categorical_ties_go_to_the_lowest_index():
    keys = prng.key(1).expand(2, 2)
    logits = torch.zeros((2, 1, 6))
    logits[..., 2] = logits[..., 4] = 1e9       # noise is lost in rounding
    assert prng.categorical(keys, logits).tolist() == [[2], [2]]


@pytest.mark.parametrize("seed,n_scenes,n_samples",
                         [(0, 3, 2), (7, 5, 1), (-2, 1, 4), (2 ** 31 - 1, 2, 3)])
def test_rollout_keys_match_reference(seed, n_scenes, n_samples):
    np.testing.assert_array_equal(
        prng.key_data(rollout_keys(seed, n_scenes, n_samples)),
        _kd(j_rollout_keys(seed, n_scenes, n_samples)))
