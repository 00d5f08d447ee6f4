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

#: the largest top-two gap of perturbed scores at which the port's and the
#: reference's samples may differ: their float32 ``log`` may round apart by
#: an ulp, which moves a Gumbel score by up to about 5e-7
NEAR_TIE = 1e-5


def score_gaps(model, scen, scenes, t_hist: int, n_samples: int, seed: int,
               cache_dtype=None):
    """The port engine's tick loop over every (scene, sample) lane in one
    chunk on the model's device, recording at each tick the gap between
    the top two perturbed scores (Gumbel noise plus logits) of every agent:
    numpy (S, K, T_fut, A). Lane (si, ki) is keyed as ``RolloutEngine.run``
    keys it."""
    from repro_torch import prng
    from repro_torch.kernels.categorical import categorical
    from repro_torch.runtime.rollout import RolloutEngine, rollout_keys
    scenes = [s.tensors if hasattr(s, "tensors") else s for s in scenes]
    total = len(scenes) * n_samples
    dev = model.device
    eng = RolloutEngine(model, scen, device=dev, num_slots=total,
                        cache_dtype=cache_dtype)
    lanes = np.arange(total) // n_samples
    hist = {key: torch.from_numpy(np.stack(
        [scenes[i][key][:t_hist] if key.startswith("agent")
         else scenes[i][key] for i in lanes])).to(dev)
        for key in ("map_feats", "map_pose", "map_valid", "agent_feats",
                    "agent_pose", "agent_valid")}
    keys = rollout_keys(seed, len(scenes), n_samples, dev)
    gaps = []
    with torch.no_grad():
        logits, cache = model.prefill(eng.init_cache(), hist)
        logits = logits[:, -1].float()
        pose = hist["agent_pose"][:, -1]
        speed = hist["agent_feats"][:, -1, :, 0] * 10.0
        feats, valid = hist["agent_feats"][:, -1], hist["agent_valid"][:, -1]
        for t in range(t_hist, scen.num_steps):
            steps = torch.full((total,), t, dtype=torch.int32, device=dev)
            scores = prng.gumbel(prng.fold_in(keys, steps),
                                 logits.shape[1:]) + logits
            top2 = scores.topk(2, dim=-1).values
            gaps.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
            acts = categorical(keys, steps, logits.contiguous())
            cache, logits, pose, speed = eng._advance(
                cache, acts, pose, speed, feats, valid, t)
            logits = logits.float()
    return np.stack(gaps, 1).reshape(len(scenes), n_samples, -1,
                                     scen.num_agents)


def diverged_lanes(got_acts, want_acts, gaps):
    """Compare two packages' sampled actions (S, K, T_fut, A) lane by lane:
    a lane may differ only from a tick where every differing agent's
    top-two gap (``gaps``, from :func:`score_gaps`) is under NEAR_TIE.
    Returns {(si, ki): first differing tick} for the lanes that differ."""
    agree = np.asarray(got_acts) == np.asarray(want_acts)
    out = {}
    for si in range(agree.shape[0]):
        for ki in range(agree.shape[1]):
            bad = np.nonzero(~agree[si, ki].all(axis=-1))[0]
            if len(bad):
                ti = int(bad[0])
                assert (gaps[si, ki, ti][~agree[si, ki, ti]] < NEAR_TIE).all(), \
                    (si, ki, ti, gaps[si, ki, ti][~agree[si, ki, ti]])
                out[(si, ki)] = ti
    return out


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
