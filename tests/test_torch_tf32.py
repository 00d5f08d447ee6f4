"""The split-TF32 arithmetic of the tensor-core flash backward, on the CPU.

``csrc/flash_attention_bwd.cu`` runs its five products (S = Q K^T,
dP = dO V^T, dQ = dS K, dV = P^T dO, dK = dS^T Q) on the tensor cores,
which read TF32 operands (10 mantissa bits) and accumulate in float32. It
splits each float32 operand x into big = tf32(x), rounded to nearest,
and small = x - big, whose low 13 bits the tensor cores drop as they read
it, and takes a product as small*big + big*small + big*big; S
and dP, whose errors the cancelling sums of dS K, dS^T Q and P^T dO
magnify, are summed over their k8 steps with compensation (two-sum).
These tests emulate that arithmetic with matmuls of TF32-rounded operands
(S and dP summed in float64 and rounded once, the others in float32) and
hold it, at the sim arch's width, to the exact gradients, the plain
backward ``flash_bwd_plain`` of the same inputs in float64, at the
kernels' float32 gradient tolerance, as the checks on the card hold the
kernels. They show why the kernel splits (one TF32 product alone misses
the tolerance by far) and why it skips the small products of bf16 inputs
(they are zero).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402

# the float32 gradient tolerance of the flash kernels (tests/test_kernels.py
# :162-163, chip_smoke.py FLASH_GRAD_TOL["float32"])
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)


def tf32(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, on the int32 view (the low 13 bits cleared)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """A float32 register as the tensor cores read a .tf32 operand: the
    low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """(big, small) as the kernel splits x, small as the tensor cores read
    it."""
    big = tf32(x)
    return big, tf32_read(x - big)


def mm_split(a, b):
    """a @ b as the kernel takes dQ, dK and dV: three TF32 products."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_split_compensated(a, b):
    """a @ b as the kernel takes S and dP: three TF32 products, summed
    without loss and rounded to float32 once."""
    (ab, as_), (bb, bs) = (tuple(x.double() for x in split(y)) for y in (a, b))
    return (as_ @ bb + ab @ bs + ab @ bb).float()


def mm_tf32(a, b):
    """a @ b as one TF32 product."""
    return tf32(a) @ tf32(b)


def backward(q, k, v, do, lse, delta, mask, scale, mm, mm_scores=None):
    """The kernels' recurrence over all pairs at once, with products mm
    (S and dP with mm_scores, where given)."""
    mm_scores = mm_scores or mm
    s = mm_scores(q, k.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = mm_scores(do, v.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def sim_case(seed=0):
    """2 scenes x 8 heads x 336 tokens at c = 200: 48 map tokens at time 0,
    then 24 agents x 12 steps (block-causal times), 10% of the tokens in
    segment -1, randn inputs, scale 1/sqrt(24)."""
    rng = np.random.default_rng(seed)
    b, h, n, c = 2, 8, 336, 200
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, n, c))
                                    .astype(np.float32)) for _ in range(4))
    times = np.concatenate([np.zeros(48), 1 + np.arange(288) // 24])
    times = torch.from_numpy(np.tile(times, (b, 1)).astype(np.int32))
    seg = torch.from_numpy(np.where(rng.random((b, n)) < 0.1, -1, 0)
                           .astype(np.int32))
    opts = dict(causal=True, scale=1.0 / np.sqrt(24.0), q_times=times,
                k_times=times, q_segment_ids=seg, k_segment_ids=seg)
    return q, k, v, do, opts


@pytest.fixture(scope="module")
def sim():
    q, k, v, do, opts = sim_case()
    out, lse = fa.flash_fwd_plain(q, k, v, **opts)
    want = tuple(w.float() for w in fab.flash_bwd_plain(
        q.double(), k.double(), v.double(), out.double(), lse, do.double(),
        **opts))
    delta = torch.sum(do * out, dim=-1)
    t, sg = opts["q_times"], opts["q_segment_ids"]
    mask = ((t[:, None, :] <= t[:, :, None])
            & (sg[:, :, None] == sg[:, None, :])
            & (sg[:, None, :] >= 0))[:, None]
    args = (q, k, v, do, lse, delta, mask, opts["scale"])
    return dict(plain=want,
                split=backward(*args, mm_split, mm_split_compensated),
                single=backward(*args, mm_tf32))


def out_of_tolerance(got, want):
    return int((~torch.isclose(got, want, **GRAD_TOL)).sum())


def tolerance_used(got, want):
    """The largest |got - want| over what the tolerance allows there."""
    allowed = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * want.abs()
    return float(((got - want).abs() / allowed).max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12, -(one + 2.0 ** -11),
                      one + 3 * 2.0 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, one, -(one + 2.0 ** -10),
                         one + 2 * 2.0 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert int((tf32(x).view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_split_keeps_float32_precision():
    """big + small is x to within about 2^-22 of |x|, where big alone is
    off by up to 2^-11."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    big, small = split(x)
    assert float(((big + small - x).abs() / x.abs()).max()) < 2.0 ** -21
    assert float(((big - x).abs() / x.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_split_tf32_backward_meets_float32_tolerance(sim, which):
    got, want = sim["split"][which], sim["plain"][which]
    assert out_of_tolerance(got, want) == 0
    torch.testing.assert_close(got, want, **GRAD_TOL)
    assert tolerance_used(got, want) < 0.5


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_single_tf32_product_misses_float32_tolerance(sim, which):
    """Why the kernel splits: one TF32 product a pair puts a large share of
    the gradient elements outside the float32 tolerance."""
    got, want = sim["single"][which], sim["plain"][which]
    assert out_of_tolerance(got, want) > want.numel() // 10


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_plain_backward_computes_in_float32_or_wider(dtype):
    """flash_bwd_plain computes in float32, or in float64 for float64
    inputs (the exact yardstick above), and returns the inputs' dtype."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16)))
                   .to(getattr(torch, dtype)) for _ in range(4))
    opts = dict(causal=True)
    out, lse = fa.flash_fwd_plain(q.float(), k.float(), v.float(), **opts)
    o = out.to(q.dtype)
    got = fab.flash_bwd_plain(q, k, v, o, lse, do, **opts)
    f32 = fab.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float(), **opts)
    for g, w in zip(got, f32):
        assert g.dtype == q.dtype
        if dtype == "float64":
            torch.testing.assert_close(g.float(), w, **GRAD_TOL)
            assert not torch.equal(g.float(), w)
        else:
            assert torch.equal(g, w.to(q.dtype))


def test_bf16_inputs_have_no_small_part():
    """bf16 values are exact in TF32, so the kernel skips their small
    products; P and dS, computed in float32, still split."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((64, 200)).astype(np.float32))
    big, small = split(x.to(torch.bfloat16).float())
    assert torch.equal(big, x.to(torch.bfloat16).float())
    assert not bool(small.any())
    p = torch.exp(x @ x.T / 200.0 - 5.0)
    assert bool(split(p)[1].any())
