"""The split-TF32 arithmetic of the tensor-core flash kernels, on the CPU.

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

``csrc/flash_attention.cu`` runs the forward's two products, S = Q K^T
(compensated, as the backward's S) and O = P V, the same way; its tests
hold out and the live lse rows, emulated so, to a float64 evaluation at
the forward's float32 tolerance and the lse tolerance the checks on the
card use, and show that one TF32 product on P V misses the first and one
on S the second.

``csrc/flash_decode.cu`` takes the decode's S = Q K^T (compensated) and
O = P V the same way, with a bf16 or int8 cache operand read exactly (no
small part) and int8's per-row scales applied to S by column and to P by
row. Its tests emulate it at the rollout's tick and prefill shapes and
hold it to ``decode_plain`` of float64 inputs at ``chip_smoke.py``'s
DECODE_TOL, and show that one TF32 product on S misses the float32 one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

# the float32 gradient tolerance of the flash kernels (tests/test_kernels.py
# :162-163, chip_smoke.py FLASH_GRAD_TOL["float32"])
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
# the forward's float32 tolerance (tests/test_kernels.py:23-25,
# chip_smoke.py FLASH_TOL["float32"]) and that of its live lse rows
# (chip_smoke.check_flash)
FWD_TOL = {"out": dict(atol=2e-5, rtol=2e-4), "lse": dict(atol=1e-5, rtol=1e-5)}
# the decode kernel's tolerances against its plain version (chip_smoke.py
# DECODE_TOL, tests/test_decode.py:175-177)
DECODE_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
              "int8": dict(atol=2e-4, rtol=2e-3)}


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


def forward(q, k, v, mask, scale, mm_scores, mm):
    """(out, lse) of the forward's softmax over all keys at once, with S
    from mm_scores and P V from mm (masked pairs give P = 0)."""
    s = mm_scores(q, k.transpose(-1, -2)) * scale
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=s.dtype))
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    return mm(p, v) / l[..., None], m + torch.log(l)


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


@pytest.fixture(scope="module")
def sim_fwd():
    """The forward at sim_case: exact (float64, rounded to float32 once) and
    as the kernel computes it, with one TF32 product on P V or on S in
    place of a split one; out and the live lse rows of each."""
    q, k, v, _, opts = sim_case()
    t, sg = opts["q_times"], opts["q_segment_ids"]
    mask = ((t[:, None, :] <= t[:, :, None])
            & (sg[:, :, None] == sg[:, None, :])
            & (sg[:, None, :] >= 0))[:, None]
    live = mask.any(dim=-1).expand(-1, q.shape[1], -1)
    args = (mask, opts["scale"])

    def run(q_, k_, v_, mm_scores, mm):
        out, lse = forward(q_, k_, v_, *args, mm_scores, mm)
        return {"out": out.float(), "lse": lse.float()[live]}
    matmul = torch.matmul
    return dict(
        exact=run(q.double(), k.double(), v.double(), matmul, matmul),
        split=run(q, k, v, mm_split_compensated, mm_split),
        single_pv=run(q, k, v, mm_split_compensated, mm_tf32),
        single_s=run(q, k, v, mm_tf32, mm_split))


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


@pytest.mark.parametrize("which", ["out", "lse"])
def test_split_tf32_forward_meets_float32_tolerance(sim_fwd, which):
    got, want = sim_fwd["split"][which], sim_fwd["exact"][which]
    tol = FWD_TOL[which]
    assert int((~torch.isclose(got, want, **tol)).sum()) == 0
    torch.testing.assert_close(got, want, **tol)
    allowed = tol["atol"] + tol["rtol"] * want.abs()
    assert float(((got - want).abs() / allowed).max()) < 0.5


@pytest.mark.parametrize("variant,which", [("single_pv", "out"),
                                           ("single_s", "lse")],
                         ids=["pv-out", "s-lse"])
def test_single_tf32_product_misses_forward_tolerance(sim_fwd, variant,
                                                      which):
    """Why the forward splits both products: one TF32 product on P V puts a
    large share of the outputs outside the float32 tolerance, and one on S
    most of the live lse rows outside theirs (the backward recomputes P
    from lse)."""
    got, want = sim_fwd[variant][which], sim_fwd["exact"][which]
    bad = int((~torch.isclose(got, want, **FWD_TOL[which])).sum())
    assert bad > want.numel() // 10


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


# -- the decode kernel -------------------------------------------------------

def decode_case(shape, seed=0):
    """The rollout's decode at c = 200 over 2 slots x 8 heads, as
    chip_smoke.py times it: the tick, 12 new agent rows (the newest time)
    against 312 live cache rows; the prefill, the scene's first 144 tokens
    (48 map at time 0, 8 steps of 12 agents) against themselves. Scene
    times, 10% of the keys (and of the tick's queries) in segment -1."""
    rng = np.random.default_rng(seed)
    b, h, c = 2, 8, 200
    sq, kvl = {"tick": (12, 312), "prefill": (144, 144)}[shape]
    q = torch.from_numpy(rng.standard_normal((b, h, sq, c)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, kvl, c))
                             .astype(np.float32)) for _ in range(2))
    pos = np.arange(kvl)
    k_times = np.where(pos < 48, 0, 1 + (pos - 48) // 12)
    k_times = torch.from_numpy(np.tile(k_times, (b, 1)).astype(np.int32))
    k_seg = torch.from_numpy(np.where(rng.random((b, kvl)) < 0.1, -1, 0)
                             .astype(np.int32))
    if shape == "tick":
        q_times = torch.full((b, sq), int(k_times.max()) + 1,
                             dtype=torch.int32)
        q_seg = torch.from_numpy(np.where(rng.random((b, sq)) < 0.1, -1, 0)
                                 .astype(np.int32))
    else:
        q_times, q_seg = k_times[:, -sq:], k_seg[:, -sq:]
    opts = dict(q_times=q_times, k_times=k_times, q_segment_ids=q_seg,
                k_segment_ids=k_seg, scale=1.0 / np.sqrt(24.0))
    mask = ((k_times[:, None, :] <= q_times[:, :, None])
            & (q_seg[:, :, None] == k_seg[:, None, :])
            & (k_seg[:, None, :] >= 0))[:, None]
    return q, k, v, torch.full((b,), kvl, dtype=torch.int32), mask, opts


def decode_kernel(q, k, v, mask, scale, mm_scores, mm, k_scale=None,
                  v_scale=None):
    """The decode kernel's arithmetic over all live keys at once: S from
    mm_scores times int8's k_scale by column, P times v_scale by row before
    P V (masked pairs give P = 0); a row with no live key gives 0."""
    s = mm_scores(q, k.transpose(-1, -2))
    if k_scale is not None:
        s = s * k_scale[..., None, :]
    s = torch.where(mask, s * scale, torch.full((), -1e30))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros(()))
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    if v_scale is not None:
        p = p * v_scale[..., None, :]
    return mm(p, v) / l[..., None]


@pytest.fixture(scope="module", params=["tick", "prefill"])
def dec(request):
    """The decode at one shape: exact (decode_plain of float64 inputs) and
    as the kernel computes it with a float32 cache, with one TF32 product
    on S or on P V in place of a split one, and with an int8 cache."""
    q, k, v, kvl, mask, opts = decode_case(request.param)
    scale = opts["scale"]
    exact = fd.decode_plain(q.double(), k.double(), v.double(), kvl,
                            **opts).float()
    (k8, ks), (v8, vs) = fd.quantize_kv(k), fd.quantize_kv(v)
    exact8 = fd.decode_plain(q.double(), k8, v8, kvl, k_scale=ks.double(),
                             v_scale=vs.double(), **opts).float()
    run = lambda mm_s, mm, *a: decode_kernel(q, k, v, mask, scale, mm_s, mm)  # noqa
    return dict(
        exact=exact, split=run(mm_split_compensated, mm_split),
        single_s=run(mm_tf32, mm_split),
        single_pv=run(mm_split_compensated, mm_tf32), exact8=exact8,
        int8=decode_kernel(q, k8.float(), v8.float(), mask, scale,
                           mm_split_compensated, mm_split, ks, vs))


def test_split_tf32_decode_meets_float32_tolerance(dec):
    got, want = dec["split"], dec["exact"]
    tol = DECODE_TOL["float32"]
    assert int((~torch.isclose(got, want, **tol)).sum()) == 0
    torch.testing.assert_close(got, want, **tol)
    allowed = tol["atol"] + tol["rtol"] * want.abs()
    assert float(((got - want).abs() / allowed).max()) < 0.5


def test_split_tf32_decode_int8_meets_its_tolerance(dec):
    """The int8 cache as the kernel reads it: integers exact in TF32, the
    scales applied outside the products, held to the same cache's float64
    decode at the int8 tolerance, and in fact at the float32 one."""
    got, want = dec["int8"], dec["exact8"]
    torch.testing.assert_close(got, want, **DECODE_TOL["int8"])
    torch.testing.assert_close(got, want, **DECODE_TOL["float32"])


@pytest.mark.parametrize("variant", ["single_s", "single_pv"])
def test_single_tf32_product_misses_decode_tolerance(dec, variant):
    """Why the decode splits: one TF32 product on S (|s| ~ 14 before the
    scale) or on P V puts a large share of the outputs outside the float32
    tolerance."""
    got, want = dec[variant], dec["exact"]
    bad = int((~torch.isclose(got, want, **DECODE_TOL["float32"])).sum())
    assert bad > want.numel() // 10


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_decode_cache_operands_have_no_small_part(cache_dtype):
    """A bf16 value or an int8 integer is exact in TF32, so the kernel
    reads the cache operand as one TF32 part; int8's dequantized values
    (integer x scale) are not, which is why the scales stay outside."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((64, 200)).astype(np.float32))
    if cache_dtype == "bfloat16":
        vals = x.to(torch.bfloat16).float()
    else:
        x8, scale = fd.quantize_kv(x)
        vals = x8.float()
        assert bool(split(x8.float() * scale[:, None])[1].any())
    big, small = split(vals)
    assert torch.equal(big, vals)
    assert not bool(small.any())
