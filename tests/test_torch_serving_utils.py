"""Slot-isolation helpers for the port's server tests (a torch copy of
``tests/serving_utils.py``, which imports JAX), and their own checks.

A slot is recycled by resetting its cursor; the predecessor's rows stay,
and every decode masks key positions >= kv_length, so stale rows are
unreachable. ``scribble_stale_rows`` overwrites every row at or past each
slot's cursor with adversarial garbage (NaN-laced huge floats, full-range
int8, "valid" segment ids), and the tests then demand bitwise-equal
outputs. Imports no JAX: ``tests/test_torch_cuda.py`` uses it on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


def scribble_stale_rows(cache, cursors, max_len: int, seed: int = 0):
    """Overwrite rows >= cursor of every per-row cache tensor, in place.

    ``cache``: the port's stacked cache dict; tensors with exactly one axis
    of size ``max_len`` are per-row (others, like ``cursor``, are left
    alone); the slot axis is the first other axis of size
    ``len(cursors)``. Garbage by dtype: int8 full-range values, other ints
    1 (a plausible time and a *valid-looking* segment id), floats huge
    noise with a quarter NaN (0 * NaN is NaN, so a zero weight on a masked
    row is not enough: the decode must zero unreachable values). Test
    sizes must keep ``max_len`` and the slot count distinct from every
    other axis length.
    """
    rng = np.random.default_rng(seed)
    n = len(cursors)
    cur = np.asarray(cursors)
    for x in cache.values():
        shape = tuple(x.shape)
        if shape.count(max_len) != 1:
            assert max_len not in shape, f"ambiguous row axis in {shape}"
            continue
        row_ax = shape.index(max_len)
        batch_ax = [i for i, s in enumerate(shape) if s == n and i != row_ax]
        assert batch_ax, f"no slot axis of size {n} in {shape}"
        rows = np.arange(max_len).reshape(
            [-1 if i == row_ax else 1 for i in range(len(shape))])
        cur_b = cur.reshape(
            [-1 if i == batch_ax[0] else 1 for i in range(len(shape))])
        stale = torch.from_numpy(np.broadcast_to(rows >= cur_b, shape).copy())
        if x.dtype == torch.int8:
            junk = rng.integers(-128, 128, shape).astype(np.int8)
        elif not x.dtype.is_floating_point:
            junk = np.ones(shape, np.int64)
        else:
            junk = (rng.standard_normal(shape) * 100.0).astype(np.float32)
            junk[rng.random(shape) < 0.25] = np.nan
        junk = torch.from_numpy(junk).to(x.dtype)
        x.copy_(torch.where(stale.to(x.device), junk.to(x.device), x))
    return cache


def assert_bit_identical(got, want, label: str):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want)
    if not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).ravel())
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        raise AssertionError(
            f"{label}: {bad.size}/{got.size} elements differ (first at flat "
            f"index {bad[0]}; max |diff| {diff.max()})")


# -- the helpers' own checks -------------------------------------------------

def _cache(dtype):
    l, b, h, s, c = 2, 3, 2, 11, 4
    cache = {"k": torch.zeros((l, b, h, s, c), dtype=dtype),
             "times": torch.zeros((b, s), dtype=torch.int32),
             "seg": torch.full((b, s), -1, dtype=torch.int32),
             "cursor": torch.tensor([0, 4, 11], dtype=torch.int32)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros((l, b, h, s))
    return cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_scribble_touches_exactly_the_stale_rows(dtype):
    cache = _cache(dtype)
    cursors = [0, 4, 11]
    scribble_stale_rows(cache, cursors, 11, seed=1)
    for b, cur in enumerate(cursors):
        assert not cache["k"][:, b, :, :cur].any()      # live rows kept
        assert (cache["seg"][b, :cur] == -1).all()
        assert (cache["seg"][b, cur:] == 1).all()       # valid-looking ids
        assert (cache["times"][b, cur:] == 1).all()
    assert torch.equal(cache["cursor"], torch.tensor([0, 4, 11],
                                                     dtype=torch.int32))
    stale = cache["k"][:, 0]
    if dtype == torch.int8:
        assert int(stale.min()) < -100 and int(stale.max()) > 100
        assert torch.isnan(cache["k_scale"][:, 0]).any()
    else:
        assert torch.isnan(stale).any()
        assert float(stale[torch.isfinite(stale)].abs().max()) > 50.0


def test_assert_bit_identical_reports_the_difference():
    a = torch.arange(6, dtype=torch.float32)
    assert_bit_identical(a, a.clone().numpy(), "same")
    b = a.clone()
    b[4] += 1e-6
    with pytest.raises(AssertionError, match="1/6 elements differ"):
        assert_bit_identical(b, a, "one ulp")
