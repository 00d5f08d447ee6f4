"""The CUDA kernels against their plain versions, on a card.

These need nvcc and a CUDA device, so they skip on a CPU-only machine; the
file imports nothing of JAX, so it runs where the port runs:

    python -m pytest -q tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the rollout's full size.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.encodings import SE2Fourier  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import se2_project as sp  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc there")
    return torch.device("cuda")


# (head_dim, F): the main path's compiled widths, and odd nb (c = 3 (4F + 2)
# and head_dim 18 not multiples of 4, so rows are not 16-byte aligned)
SE2_WIDTHS = [(24, 12), (18, 5), (30, 7)]
# (B, H, n): whole 16-token tiles; ragged last tiles and a head count that
# is no power of two; few tokens, so the heads split over CTAs
SE2_SHAPES = [(2, 8, 32), (3, 3, 37), (5, 8, 12)]


def _se2_case(dev, head_dim, num_terms, shape, transposed, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = SE2Fourier(head_dim=head_dim, num_terms=num_terms)
    b, h, n = shape
    width = enc.expanded_dim if transposed else head_dim
    x = torch.randn((b, h, n, width), generator=g, device=dev)
    pose = torch.cat([torch.rand((b, n, 2), generator=g, device=dev) * 6 - 3,
                      torch.rand((b, n, 1), generator=g, device=dev) * 6.3
                      - 3.15], -1).contiguous()
    return enc, x.to(getattr(torch, dtype)), pose


def _se2_run(x, pose, enc, mode, transposed):
    fn = sp.se2_fourier_project_t if transposed else sp.se2_fourier_project
    return fn(x, pose, enc, mode)


def _se2_plain(x, pose, enc, mode, transposed):
    fn = sp.se2_project_t_plain if transposed else sp.se2_project_plain
    return fn(x, pose, enc, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("mode", ["q", "k"])
@pytest.mark.parametrize("widths", SE2_WIDTHS)
@pytest.mark.parametrize("shape", SE2_SHAPES)
def test_se2_project_kernel_matches_plain(dev, mode, x_dtype, transposed,
                                          widths, shape):
    """All four modes against their plain versions, run twice and required
    bitwise equal."""
    enc, x, pose = _se2_case(dev, *widths, shape, transposed, x_dtype)
    got = _se2_run(x, pose, enc, mode, transposed)
    again = _se2_run(x, pose, enc, mode, transposed)
    want = _se2_plain(x, pose, enc, mode, transposed)
    assert got.dtype == x.dtype and got.shape == want.shape
    tol = dict(atol=1e-5, rtol=1e-4) if x_dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("mode", ["q", "k"])
def test_se2_project_unaligned_and_flat_inputs(dev, mode, transposed):
    """An input that starts off a 16-byte boundary, and the flat (T, d)
    layout, give the aligned (B, H, n, d) call's result."""
    enc, x, pose = _se2_case(dev, 18, 5, (1, 1, 37), transposed, "float32")
    buf = torch.empty(x.numel() + 1, device=dev)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    want = _se2_run(x, pose, enc, mode, transposed)
    assert torch.equal(_se2_run(shifted, pose, enc, mode, transposed), want)
    flat = _se2_run(x[0, 0], pose[0], enc, mode, transposed)
    assert torch.equal(flat, want[0, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["q", "k"])
def test_se2_project_gradients_match_plain(dev, mode):
    """Gradients through the kernels (each direction's backward is the
    other's kernel) against autograd through the plain versions."""
    enc, x, pose = _se2_case(dev, 24, 12, (3, 3, 37), False, "float32")
    _, g, _ = _se2_case(dev, 24, 12, (3, 3, 37), True, "float32", seed=1)
    grads = []
    for fwd, bwd in ((sp.se2_fourier_project, sp.se2_fourier_project_t),
                     (sp.se2_project_plain, sp.se2_project_t_plain)):
        sp.cuda.reset_launches()
        xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        y = fwd(xr, pose, enc, mode)
        o = bwd(gr, pose, enc, mode)
        grads.append(torch.autograd.grad((y * g).sum() + (o * x).sum(),
                                         (xr, gr)))
        if not grads[1:]:       # through the kernels: 2 launches each
            assert sp.cuda.LAUNCHES == {f"se2_project_{mode}": 2,
                                        f"se2_project_{mode}_t": 2}
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_se2_project_raises_on_what_it_does_not_take(dev):
    """Nothing falls back to the plain version on a CUDA tensor."""
    enc = SE2Fourier(head_dim=24, num_terms=12)
    x = torch.zeros((2, 3, 5, 24), device=dev)
    pose = torch.zeros((2, 5, 3), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        sp.se2_fourier_project(x.transpose(1, 2), pose, enc, "q")
    with pytest.raises(ValueError, match="feature dim"):
        sp.se2_fourier_project_t(x, pose, enc, "q")
    with pytest.raises(TypeError, match="float32"):
        sp.se2_fourier_project(x.half(), pose, enc, "k")
    with pytest.raises(ValueError, match="pose"):
        sp.se2_fourier_project(x, pose[:, :4].contiguous(), enc, "k")
    with pytest.raises(ValueError, match="adaptive"):
        sp.se2_fourier_project_t(
            torch.zeros((1, 1, 1, 156), device=dev), pose[:1, :1],
            SE2Fourier(head_dim=24, num_terms=12, adaptive_terms=True), "k")


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_kernel_matches_plain(dev, cache_dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((2, 3, 2, 96, 200), generator=g, device=dev)
    v = torch.randn((2, 3, 2, 96, 200), generator=g, device=dev)
    q = torch.randn((3, 4, 7, 200), generator=g, device=dev)
    kvl = torch.tensor([0, 33, 96], dtype=torch.int32, device=dev)
    scales = {}
    if cache_dtype == "int8":
        (k, ks), (v, vs) = fd.quantize_kv(k), fd.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(getattr(torch, cache_dtype)), v.to(getattr(torch,
                                                              cache_dtype))
    got = fd.flash_decode(q, k, v, kvl, layer=1, **scales)
    want = fd.decode_plain(q, k, v, kvl, layer=1, **scales)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)


# chip_smoke.py DECODE_TOL: the decode kernel against its plain version
DECODE_TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
              "bfloat16": dict(atol=8e-3, rtol=8e-3),
              "int8": dict(atol=2e-4, rtol=2e-3)}
# name: (b, hq, hkv, sq, s, cursors); c = 200, two layers, read at layer 1
DECODE_CASES = {
    # the prefill's 144 rows (64-row CTAs) against ragged cursors
    "prefill_ragged": (7, 2, 2, 144, 192, [0, 1, 31, 32, 33, 144, 192]),
    # GQA: 14 rows a kv head (one m16 block), then 24 (a 64-row CTA)
    "gqa_one_block": (3, 4, 2, 7, 96, [0, 33, 96]),
    "gqa_two_blocks": (3, 4, 2, 12, 160, [5, 100, 160]),
}
# widths off c = 200, (D, Dv): off the k8 step and unequal (widths read at
# run time, padding columns zeroed), and past 200 (16-key tiles); then
# se2_fourier's c = 50 head_dim / 6 at head_dim 6, 18 and 30 (rows not a
# multiple of 4 wide: 8-byte float32 copies, 2-byte int8 ones) and two odd
# widths (4-byte and 1-byte copies, one column at a time on the way out)
ODD_WIDTHS = {"d20_dv36": (20, 36), "d232": (232, 232), "c50": (50, 50),
              "c150": (150, 150), "c250": (250, 250),
              "d75_dv151": (75, 151), "d13_dv7": (13, 7),
              # past 256: column windows (se2_fourier at head_dim 36 and
              # 60, c = 300 and 500, Q and K staged in shared memory), one
              # side only past 256, and rows too wide to stage (c = 700:
              # every pass reads Q and K from device memory)
              "c300": (300, 300), "c500": (500, 500),
              "d300_dv100": (300, 100), "d40_dv520": (40, 520),
              "c700": (700, 700)}
# the tick's rows (one m16 block a kv head) and the prefill's
ROW_CASES = {"tick": (3, 2, 2, 12, 160, [5, 100, 160]),
             "prefill": (3, 2, 2, 144, 192, [0, 33, 192])}


def _decode_case(dev, shape, cache_dtype, nan_unreached=False,
                 widths=(200, 200)):
    """``shape`` (b, hq, hkv, sq, s, cursors) at ``widths`` (D, Dv).
    Scene-layout times (48 map rows at 0, then 12 a step), query rows at
    the cache's first positions (prefill) or the newest time, 10% of the
    keys and queries in segment -1; rows past each cursor hold NaN (int8:
    NaN scales). With ``nan_unreached``, the V row (int8: both scales) of
    a key within the cursor that no query reaches is NaN too."""
    b, hq, hkv, sq, s, cursors = shape
    d, dv = widths
    g = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn((2, b, hkv, s, d), generator=g, device=dev)
    v = torch.randn((2, b, hkv, s, dv), generator=g, device=dev)
    q = torch.randn((b, hq, sq, d), generator=g, device=dev)
    kvl = torch.tensor(cursors, dtype=torch.int32, device=dev)
    pos = torch.arange(s, device=dev)
    k_times = torch.where(pos < 48, 0, 1 + (pos - 48) // 12).int()
    k_times = k_times[None].expand(b, s).contiguous()
    k_seg = torch.where(torch.rand((b, s), generator=g, device=dev) < 0.1,
                        -1, 0).int()
    if sq == 144:
        q_times, q_seg = k_times[:, :sq].contiguous(), k_seg[:, :sq].clone()
    else:
        q_times = torch.full((b, sq), int(k_times.max()) + 1,
                             dtype=torch.int32, device=dev)
        q_seg = torch.where(torch.rand((b, sq), generator=g, device=dev)
                            < 0.1, -1, 0).int()
    dead = pos[None, :] >= kvl[:, None].long()                 # (b, s)
    if nan_unreached:
        unreached = torch.zeros_like(dead)
        unreached[:, 3] = True
        k_seg[:, 3] = -1
        dead = dead | unreached
    nan = torch.tensor(float("nan"), device=dev)
    scales = {}
    if cache_dtype == "int8":
        (k, ks), (v, vs) = fd.quantize_kv(k), fd.quantize_kv(v)
        scales = {n: torch.where(dead[None, :, None], nan, x).contiguous()
                  for n, x in (("k_scale", ks), ("v_scale", vs))}
    else:
        dt = getattr(torch, cache_dtype)
        past = pos[None, :] >= kvl[:, None].long()
        k = torch.where(past[None, :, None, :, None], nan, k).to(dt)
        v = torch.where(dead[None, :, None, :, None], nan, v).to(dt)
    return q, k.contiguous(), v.contiguous(), kvl, dict(
        q_times=q_times, k_times=k_times, q_segment_ids=q_seg.contiguous(),
        k_segment_ids=k_seg.contiguous(), **scales)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 5, 64])
@pytest.mark.parametrize("name", sorted(DECODE_CASES) + ["nan_unreached"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_cases_match_plain(dev, cache_dtype, name, splits):
    """Each case through the kernel, one split to more than the cache has
    tiles; a row whose cursor is 0 gives exact zeros, and the output is
    bitwise repeatable."""
    nan_unreached = name == "nan_unreached"
    q, k, v, kvl, opts = _decode_case(
        dev, DECODE_CASES["gqa_two_blocks" if nan_unreached else name],
        cache_dtype, nan_unreached)
    _check_decode(q, k, v, kvl, opts, cache_dtype, splits)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("rows", sorted(ROW_CASES))
@pytest.mark.parametrize("widths", sorted(ODD_WIDTHS))
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_odd_widths_match_plain(dev, cache_dtype, widths, rows,
                                             splits):
    """The CTA shapes and strides of widths other than c = 200, with the
    tick's and the prefill's rows, as the cases above."""
    q, k, v, kvl, opts = _decode_case(dev, ROW_CASES[rows], cache_dtype,
                                      widths=ODD_WIDTHS[widths])
    _check_decode(q, k, v, kvl, opts, cache_dtype, splits)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 5])
@pytest.mark.parametrize("rows", sorted(ROW_CASES))
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_c24_matches_plain(dev, cache_dtype, rows, splits):
    """The width of the absolute, rope2d and se2_repr arches' caches (24:
    bf16 rows of 48 bytes, int8 rows of 24, not 16-byte aligned), at the
    tick's and the prefill's rows, with the wrapper's own split count
    too."""
    q, k, v, kvl, opts = _decode_case(dev, ROW_CASES[rows], cache_dtype,
                                      widths=(24, 24))
    _check_decode(q, k, v, kvl, opts, cache_dtype, splits)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("widths", ["c150", "d75_dv151", "sim", "c300"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_bf16_query_matches_plain(dev, cache_dtype, widths,
                                               splits):
    """A bfloat16 query (the bf16 model's) lands converted, and the output
    comes back in bfloat16, as the plain version's and the reference's;
    held at the bf16 tolerance."""
    shape = ROW_CASES["tick"]
    q, k, v, kvl, opts = _decode_case(
        dev, shape, cache_dtype,
        widths=(200, 200) if widths == "sim" else ODD_WIDTHS[widths])
    _check_decode(q.to(torch.bfloat16), k, v, kvl, opts, cache_dtype, splits)


def _check_decode(q, k, v, kvl, opts, cache_dtype, splits):
    got = fd.flash_decode(q, k, v, kvl, layer=1, num_splits=splits, **opts)
    again = fd.flash_decode(q, k, v, kvl, layer=1, num_splits=splits, **opts)
    want = fd.decode_plain(q, k, v, kvl, layer=1, **opts)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all())
    assert got.dtype == want.dtype == q.dtype
    tol = DECODE_TOL["bfloat16" if q.dtype == torch.bfloat16 else cache_dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)
    assert not bool(got[kvl == 0].any())


# (B, A, K, steps): the engine's tick (every lane at one step), the
# server's (each slot at its own step, inactive slots at 0 and past 2^31 as
# int32 wraps), and a ragged one (K off the warp, not a power of two)
CATEGORICAL_CASES = {"tick": (64, 12, 63, "one"), "server": (64, 12, 63,
                                                             "own"),
                     "ragged": (5, 3, 40, "own")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CATEGORICAL_CASES))
def test_categorical_kernel_matches_plain(dev, name):
    """The fused Threefry sampler against ``prng``: the 32-bit words and
    the uniforms bitwise, the Gumbel noise within 1e-6 (float32 log may
    round differently by an ulp), actions equal wherever the top two
    perturbed scores differ by more than 1e-5; bitwise repeatable; a NaN
    logit wins its row at its first index, as argmax has it."""
    from repro_torch import prng
    from repro_torch.kernels import categorical as cat
    b, a, k, steps_kind = CATEGORICAL_CASES[name]
    g = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn((b, a, k), generator=g, device=dev) * 3
    logits[0, 0, 7] = float("nan")
    logits[0, 0, 9] = float("nan")
    base = prng.key(3, device=dev).expand(b, 2)
    keys = prng.fold_in(base, torch.arange(b, device=dev)).contiguous()
    if steps_kind == "one":
        steps = torch.full((b,), 8, dtype=torch.int32, device=dev)
    else:
        steps = torch.randint(0, 40, (b,), generator=g, device=dev,
                              dtype=torch.int32)
        steps[1], steps[2] = 0, -5
    acts, words, unif, noise = cat.categorical_debug(keys, steps, logits)
    got = cat.categorical(keys, steps, logits)
    again = cat.categorical(keys, steps, logits)
    keys_t = prng.fold_in(keys, steps)
    tiny = float(torch.finfo(torch.float32).tiny)
    assert torch.equal(words, prng.random_bits(keys_t, (a, k)))
    assert torch.equal(unif, prng.uniform(keys_t, (a, k), minval=tiny))
    want_noise = prng.gumbel(keys_t, (a, k))
    torch.testing.assert_close(noise, want_noise, atol=1e-6, rtol=0)
    want = cat.categorical_plain(keys, steps, logits)
    assert torch.equal(got, acts) and torch.equal(got, again)
    assert got.dtype == want.dtype == torch.int64
    assert int(got[0, 0]) == int(want[0, 0]) == 7
    top2 = (want_noise + logits).nan_to_num(nan=float("inf")).topk(2).values
    gap = top2[..., 0] - top2[..., 1]
    differ = got != want
    assert bool((gap[differ] < 1e-5).all()), gap[differ]


@pytest.mark.gpu
def test_refused_launch_raises(dev):
    """A launch the card refuses (here: more shared memory than an SM has,
    the constants alone at F = 128 taking 265 KB) raises with CUDA's
    message; nothing falls back to the plain version."""
    enc = SE2Fourier(head_dim=48, num_terms=128)
    x = torch.zeros((1, 1, 32, 48), device=dev)
    pose = torch.zeros((1, 32, 3), device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sp.se2_fourier_project(x, pose, enc, "k")
    torch.cuda.synchronize()


# -- flash attention: forward, dq and dk/dv against their plain versions ----

FLASH_CASES = {
    # b, hq, hkv, sq, sk, d, dv, options
    "plain": (2, 2, 2, 37, 37, 32, 32, {}),
    "causal_gqa": (2, 4, 2, 48, 48, 32, 40, dict(causal=True)),
    "window": (1, 2, 2, 50, 50, 24, 24, dict(window=12)),
    "causal_window_mqa": (2, 4, 1, 33, 65, 16, 16,
                          dict(causal=True, window=16)),
    "softcap": (1, 2, 2, 40, 40, 32, 32, dict(softcap=20.0)),
    # widths not multiples of the tensor cores' k8 step, lengths not of m16
    "odd_widths": (2, 4, 2, 37, 53, 20, 36, dict(causal=True)),
    "times_segments": (2, 2, 2, 64, 64, 200, 200, "scene"),
    "sim_width": (2, 8, 8, 336, 336, 200, 200, "scene"),
    # the absolute / rope2d / se2_repr arches' width
    "sim_c24": (2, 8, 8, 336, 336, 24, 24, "scene"),
    # se2_fourier at head_dim 6, 18, 30 (rows not a multiple of 4 wide)
    # and odd widths, unequal
    "sim_c50": (2, 4, 4, 336, 336, 50, 50, "scene"),
    "sim_c150": (2, 8, 8, 336, 336, 150, 150, "scene"),
    "sim_c250": (2, 4, 4, 336, 336, 250, 250, "scene"),
    "odd_75_151": (2, 4, 2, 37, 53, 75, 151, dict(causal=True)),
    "odd_13_7": (2, 2, 2, 45, 45, 13, 7, "scene"),
    # past 256 columns: balanced column windows (se2_fourier at head_dim
    # 36 and 60: the backward stages its owned rows at c = 300 and reads
    # every operand from device memory at 500), one side only past 256
    # (whole rows staged), and rows too wide to stage anywhere (c = 700)
    "sim_c300": (2, 4, 4, 336, 336, 300, 300, "scene"),
    "sim_c500": (1, 2, 2, 336, 336, 500, 500, "scene"),
    "sim_c700": (1, 2, 2, 96, 96, 700, 700, "scene"),
    "wide_300_100": (2, 4, 2, 37, 53, 300, 100, dict(causal=True)),
    "wide_40_520": (1, 2, 2, 45, 45, 40, 520, "scene"),
    # whisper-base: the encoder's 1,500 frames (no tile divides it),
    # non-causal; the decoder's causal 448; the cross-attention, 448 rows
    # against the 1,500 frames
    "whisper_enc": (1, 8, 8, 1500, 1500, 64, 64, {}),
    "whisper_dec": (1, 8, 8, 448, 448, 64, 64, dict(causal=True)),
    "whisper_cross": (1, 8, 8, 448, 1500, 64, 64, {}),
}


def _flash_case(dev, name, dtype=torch.float32):
    b, hq, hkv, sq, sk, d, dv, opts = FLASH_CASES[name]
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, sk, dv), generator=g, device=dev).to(dtype)
    do = torch.randn((b, hq, sq, dv), generator=g, device=dev).to(dtype)
    if opts == "scene":           # block-causal times, -1 segments
        times = torch.sort(torch.randint(0, 12, (b, sk), generator=g,
                                         device=dev), dim=-1)[0]
        seg = torch.where(torch.rand((b, sk), generator=g, device=dev) < 0.1,
                          -1, 0)
        opts = dict(causal=True, q_times=times.int(), k_times=times.int(),
                    q_segment_ids=seg.int(), k_segment_ids=seg.int())
    return q, k, v, do, opts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(dev, name, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do, opts = _flash_case(dev, name, getattr(torch, dtype))
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **opts)
    got = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    # float32 gradients are held to exact ones: the plain backward of the
    # same inputs in float64, rounded to float32
    wide = torch.float64 if dtype == "float32" else q.dtype
    want = tuple(w.to(q.dtype) for w in fab.flash_bwd_plain(
        q.to(wide), k.to(wide), v.to(wide), out.to(wide), lse, do.to(wide),
        **opts))
    torch.cuda.synchronize()
    # f32: tests/test_kernels.py's forward and gradient tolerances; bf16:
    # both sides round their outputs to bf16
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    live = want_lse > -1e29
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-5,
                               rtol=1e-5)
    gtol = dict(atol=1e-5, rtol=1e-3) if dtype == "float32" else \
        dict(atol=1e-2, rtol=4e-2)
    for which, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == w.dtype
        torch.testing.assert_close(a.float(), w.float(), **gtol, msg=which)


@pytest.mark.gpu
def test_flash_backward_is_bitwise_repeatable(dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do, opts = _flash_case(dev, "causal_gqa")
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    first = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    second = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_are_bitwise_repeatable_at_c24(dev, dtype):
    """Forward and backward at the Table-I arches' width, on the scene
    mask."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do, opts = _flash_case(dev, "sim_c24", getattr(torch, dtype))
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    again = fa.flash_attention_fwd(q, k, v, **opts)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    first = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    second = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_is_bitwise_repeatable_at_odd_widths(dev, dtype):
    """The zero-padded contraction and the masked ragged edges of the
    tensor-core tiles keep one writer per row and a fixed order."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do, opts = _flash_case(dev, "odd_widths", getattr(torch, dtype))
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    first = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    second = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sim_width", "odd_widths"])
def test_flash_forward_is_bitwise_repeatable(dev, name, dtype):
    """Each output row has one writer, and the two warps of a query block
    merge their softmax states in a fixed order."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _, opts = _flash_case(dev, name, getattr(torch, dtype))
    first = fa.flash_attention_fwd(q, k, v, **opts)
    second = fa.flash_attention_fwd(q, k, v, **opts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_ragged_tile_with_large_padding_rows(dev, dtype):
    """85 keys: the last 32-key tile holds 21, in the buffer that held the
    first tile, whose rows 21-31 are padding (segment -1) with V = 1e4. A
    pad row of the ragged tile that is not zeroed, or a padding key that
    gets P > 0, shows at that size; rows of segment -1 give 0."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    b, h, sq, sk, d = 2, 4, 40, 85, 40
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dt)
    k = torch.randn((b, h // 2, sk, d), generator=g, device=dev)
    v = torch.randn((b, h // 2, sk, d), generator=g, device=dev)
    k_seg = torch.zeros((b, sk), dtype=torch.int32, device=dev)
    k_seg[:, 21:32] = -1
    k_seg[:, 60] = -1
    v[:, :, 21:32] = 1e4
    v[:, :, 60] = 1e4
    q_seg = torch.zeros((b, sq), dtype=torch.int32, device=dev)
    q_seg[:, 7] = -1
    opts = dict(q_segment_ids=q_seg, k_segment_ids=k_seg)
    k, v = k.to(dt), v.to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **opts)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float(want_out.float().abs().max()) < 10.0
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    assert not bool(out[:, :, 7].any())
    live = want_lse > -1e29
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.gpu
def test_flash_kernels_raise_on_what_they_do_not_take(dev):
    """Empty rows and non-contiguous inputs raise before any launch;
    nothing falls back to the plain version. (Rows of any width are taken:
    past 256 columns the kernels run column windows.)"""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = torch.zeros((1, 1, 8, 0), device=dev)
    with pytest.raises(ValueError, match="widths.*positive"):
        fa.flash_attention_fwd(q, q, q)
    k = torch.zeros((1, 1, 1, 8, 0), device=dev)
    with pytest.raises(ValueError, match="widths.*positive"):
        fd.flash_decode(q, k, k,
                        torch.full((1,), 8, dtype=torch.int32, device=dev),
                        layer=0)
    q = torch.zeros((1, 2, 8, 32), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q, q, q, impl="flash")


# chip_smoke.py MODEL_TOL: the model's logits through the kernels against
# the plain versions
MODEL_TOL = {"float32": dict(atol=2e-4, rtol=2e-3),
             "int8": dict(atol=8e-2, rtol=8e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_decode_over_mixed_families_matches_plain(dev, cache_dtype):
    """Prefill and every step at the reduced arch over one scene of each of
    the seven families (most of them with padded, segment-masked agents):
    the card's kernels against the plain versions on the CPU, on valid
    agents."""
    _check_mixed_family_decode(dev, "sim-se2-fourier", cache_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch_name", ["sim-absolute", "sim-rope2d",
                                       "sim-se2-repr"])
def test_table1_arch_decode_over_mixed_families_matches_plain(
        dev, arch_name, cache_dtype):
    """The same for the other three Table-I arches, whose decode runs at
    c = 24 (and whose transforms, if any, are plain PyTorch on both
    sides)."""
    _check_mixed_family_decode(dev, arch_name, cache_dtype)


def _check_mixed_family_decode(dev, arch_name, cache_dtype):
    import numpy as np
    from repro_torch import configs, scenarios
    from repro_torch.kernels import cuda
    from repro_torch.nn.agent_sim import AgentSimModel
    arch = configs.get_sim_arch(arch_name).reduced()
    scen = arch.scenario_config()
    scenes = [scenarios.generate_scene(f, 0, 1, scen)
              for f in scenarios.registry.names()]
    assert min(s.num_valid_agents for s in scenes) < scen.num_agents
    batch = {k: np.stack([s.tensors[k] for s in scenes])
             for k in ("map_feats", "map_pose", "map_valid", "agent_feats",
                       "agent_pose", "agent_valid")}
    valid = torch.as_tensor(batch["agent_valid"])
    t_hist = scen.num_steps // 2
    logits = {}
    for device in (dev, torch.device("cpu")):
        model = AgentSimModel(arch.agent_sim_config(), device=device,
                              generator=torch.Generator().manual_seed(0))
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        cache = model.init_cache(len(scenes), 128, cache_dtype)
        hist = {k: (v[:, :t_hist] if k.startswith("agent") else v)
                for k, v in b.items()}
        cuda.reset_launches()
        with torch.no_grad():
            out, cache = model.prefill(cache, hist)
            steps = [out]
            for t in range(t_hist, scen.num_steps):
                lt, cache = model.step(
                    cache, b["agent_feats"][:, t], b["agent_pose"][:, t],
                    b["agent_valid"][:, t],
                    torch.full((len(scenes),), t, dtype=torch.int32,
                               device=device))
                steps.append(lt[:, None])
        logits[device.type] = torch.cat(steps, 1).cpu()
        if device.type == "cuda":
            assert cuda.LAUNCHES["flash_decode"] == arch.num_layers * (
                1 + scen.num_steps - t_hist)
    got, want = logits["cuda"][valid], logits["cpu"][valid]
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **MODEL_TOL[cache_dtype])


def _trainer_on_card(dev, ckpt_dir, total_steps):
    """A 2-layer sim-se2-fourier (full width, c = 200) Trainer over 4
    freeform scenes a batch, weights from seed 0."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import ShardedIterator
    from repro_torch.nn.agent_sim import AgentSimModel
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.training.data import make_batch_fn
    from repro_torch.training.steps import bc_optimizer, make_sim_train_step
    arch = dataclasses.replace(configs.get_sim_arch("sim-se2-fourier"),
                               num_layers=2)
    model = AgentSimModel(arch.agent_sim_config(), device=dev,
                          generator=torch.Generator().manual_seed(0))
    assert model.blocks[0].attn.enc.expanded_dim == 200
    opt = bc_optimizer(3e-3, 8)
    data = ShardedIterator(make_batch_fn(arch.scenario_config(),
                                         ("freeform",)), batch_size=4)
    return Trainer(make_sim_train_step(model, opt), model,
                   opt.init(dict(model.named_parameters())), data,
                   str(ckpt_dir), TrainerConfig(total_steps=total_steps,
                                                ckpt_every=3, log_every=100))


def _trainer_state(tr):
    return ({k: v.clone() for k, v in tr.model.state_dict().items()},
            tr.opt_state[1]["step"],
            {m: {k: v.clone() for k, v in tr.opt_state[1][m].items()}
             for m in ("mu", "nu")})


def _assert_state_bitwise(a, b):
    assert a[1] == b[1]
    for x, y in ((a[0], b[0]), (a[2]["mu"], b[2]["mu"]),
                 (a[2]["nu"], b[2]["nu"])):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.gpu
def test_trainer_restart_and_nan_skip_bitwise_on_the_card(dev, tmp_path):
    """Kill-and-resume (3 + 3 steps against 6 straight) gives bitwise the
    same history, parameters and AdamW moments on the card, and a step
    whose loss is NaN leaves them bitwise as they were."""
    full = _trainer_on_card(dev, tmp_path / "full", 6)
    assert full.run()["status"] == "done"
    first = _trainer_on_card(dev, tmp_path / "r", 3)
    first.run()
    second = _trainer_on_card(dev, tmp_path / "r", 6)
    assert second.restore_if_available() and second.step == 3
    assert second.data.cursor == 3
    second.run()
    assert second.history == full.history[3:]
    _assert_state_bitwise(_trainer_state(second), _trainer_state(full))

    tr = _trainer_on_card(dev, tmp_path / "nan", 2)
    inner = tr.step_fn
    seen = {}

    class NaNFirst:
        update = inner.update

        @staticmethod
        def grads(batch):
            if not seen:
                seen["before"] = _trainer_state(tr)
                g, m = inner.grads(batch)
                return g, dict(m, loss=torch.tensor(float("nan"),
                                                    device=dev))
            _assert_state_bitwise(_trainer_state(tr), seen["before"])
            seen["checked"] = True
            return inner.grads(batch)

    tr.step_fn = NaNFirst
    out = tr.run()
    assert out["nan_skipped"] == 1 and seen["checked"]
    for t in (full, first, second, tr):
        t.data.close()


# -- the continuous-batching server on the card --------------------------------

SERVER_SCEN = dict(num_map=8, num_agents=3, num_steps=6)


def _server_on_card(dev, num_slots=2, cache_dtype="float32"):
    from repro_torch import obs
    from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
    from repro_torch.runtime import SimServer
    from repro_torch.scenarios.core import ScenarioConfig
    scen = ScenarioConfig(**SERVER_SCEN)
    model = AgentSimModel(AgentSimConfig(
        d_model=32, num_layers=2, num_heads=2, head_dim=12, d_ff=64,
        num_actions=scen.num_actions, encoding="se2_fourier"), device=dev,
        generator=torch.Generator().manual_seed(0))
    return SimServer(model, scen, num_slots=num_slots,
                     cache_dtype=cache_dtype, device=dev, registry=obs.NULL)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_server_gauntlet_bitwise_on_the_card(dev, cache_dtype):
    """The churn gauntlet through the kernels: an eviction mid-prefill, a
    retirement, every stale row scribbled with NaN garbage, then the victim
    in slot 1 beside a neighbour is bitwise the victim alone in slot 0 of
    a fresh server."""
    from repro_torch.kernels import cuda
    from repro_torch.runtime import SceneRequest
    from repro_torch.scenarios.registry import generate_mixed, generate_scene
    from test_torch_serving_utils import (assert_bit_identical,
                                          scribble_stale_rows)
    srv = _server_on_card(dev, cache_dtype=cache_dtype)
    scen = srv.scen
    victim = generate_scene("signalized_intersection", 40, 0, scen)

    def victim_request():
        return SceneRequest(uid=0, tensors=victim, t_hist=3, seed=9,
                            scene_id=0)
    solo = _server_on_card(dev, cache_dtype=cache_dtype)
    solo.submit(victim_request())
    solo.run_until_drained()
    evictees = generate_mixed(7, 100, 2, scen)
    for i, scene in enumerate(evictees):
        srv.submit(SceneRequest(uid=100 + i, tensors=scene, t_hist=2,
                                t_total=4, seed=1, scene_id=50 + i))
    cuda.reset_launches()
    srv.tick()
    assert srv.evict(101)
    while any(s.req for s in srv.slots):
        srv.tick()
    srv.flush()
    assert cuda.LAUNCHES["flash_decode"] == 2 * (srv.ticks + srv.admitted)
    scribble_stale_rows(srv.cache, [0, 0], srv.max_len, seed=3)
    srv.submit(SceneRequest(uid=1, tensors=evictees[0], t_hist=2, seed=2,
                            scene_id=77))
    srv.submit(victim_request())
    srv.tick()
    assert srv.slots[1].req.uid == 0
    done = srv.run_until_drained()
    assert_bit_identical(done[0].actions, solo.done[0].actions, "actions")
    assert_bit_identical(done[0].future, solo.done[0].future, "poses")


@pytest.mark.gpu
def test_server_quarantine_on_the_card(dev):
    """NaN in one resident slot mid-rollout: that lane fails with
    nonfinite_pose, the others are bitwise the no-fault run's, and the
    scrubbed slot's next tenant is bitwise its run in a fresh server."""
    from repro_torch import chaos
    from repro_torch.runtime import SceneRequest
    from repro_torch.scenarios.registry import generate_mixed, generate_scene
    from test_torch_serving_utils import assert_bit_identical

    def serve(poison_tick=None):
        srv = _server_on_card(dev)
        for i, scene in enumerate(generate_mixed(5, 0, 3, srv.scen)):
            srv.submit(SceneRequest(uid=i, tensors=scene, t_hist=3, seed=11,
                                    scene_id=i))
        tick = 0
        while srv.queue or any(s.req for s in srv.slots):
            if tick == poison_tick:
                chaos.poison_server_slot(srv, 0)
            srv.tick()
            tick += 1
        srv.flush()
        return srv
    ref, srv = serve(), serve(poison_tick=4)
    assert (srv.done[0].status, srv.done[0].reason) == ("failed",
                                                        "nonfinite_pose")
    assert srv.quarantined == 1
    for uid in (1, 2):
        assert srv.done[uid].status == "ok"
        assert_bit_identical(srv.done[uid].future, ref.done[uid].future,
                             f"lane {uid}")
    tenant = generate_scene("highway", 123, 0, srv.scen)
    solo = _server_on_card(dev)
    for s in (srv, solo):
        s.submit(SceneRequest(uid=99, tensors=tenant, t_hist=3, seed=21,
                              scene_id=0))
        s.run_until_drained()
    assert_bit_identical(srv.done[99].future, solo.done[99].future, "tenant")


# The LM serving path: the decode at phi4-mini-3.8b's tick (24 / 8 heads of
# 128, cursors spread over 1-2,048), a chunk of 40 tokens causal through
# their positions (q_times / k_times), stablelm-3b's 80-wide MHA and
# granite-20b's MQA (a group of 48). name: (b, hq, hkv, d, sq, s, cursors)
LM_DECODE_CASES = {
    "phi4_tick": (8, 24, 8, 128, 1, 2048,
                  [1, 2, 255, 256, 257, 1000, 2047, 2048]),
    "phi4_chunk": (2, 24, 8, 128, 40, 512, [40, 300]),
    "stablelm_mha": (4, 32, 32, 80, 1, 512, [1, 64, 300, 512]),
    "granite_mqa": (4, 48, 1, 128, 1, 512, [1, 77, 256, 512]),
}
# the flash forward at the prefill: causal, (b, hq, hkv, s, d)
LM_FLASH_CASES = {"phi4_prefill": (2, 24, 8, 1024, 128),
                  "stablelm_mha": (1, 32, 32, 256, 80),
                  "granite_mqa": (1, 48, 1, 256, 128)}


def _lm_decode_case(dev, case, cache_dtype, q_dtype):
    """A two-layer stacked cache (rows past each cursor NaN; int8: NaN
    scales) and query rows at the last sq positions before each cursor."""
    b, hq, hkv, d, sq, s, cursors = case
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((2, b, hkv, s, d), generator=g, device=dev)
    v = torch.randn((2, b, hkv, s, d), generator=g, device=dev)
    q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(
        getattr(torch, q_dtype))
    kvl = torch.tensor(cursors, dtype=torch.int32, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= kvl[:, None].long()
    nan = torch.tensor(float("nan"), device=dev)
    opts = {}
    if cache_dtype == "int8":
        (k, ks), (v, vs) = fd.quantize_kv(k), fd.quantize_kv(v)
        opts = {n: torch.where(past[None, :, None], nan, x).contiguous()
                for n, x in (("k_scale", ks), ("v_scale", vs))}
    else:
        dt = getattr(torch, cache_dtype)
        k = torch.where(past[None, :, None, :, None], nan, k).to(dt)
        v = torch.where(past[None, :, None, :, None], nan, v).to(dt)
    if sq > 1:
        opts["q_times"] = (kvl[:, None] - sq + torch.arange(
            sq, device=dev)).int().contiguous()
        opts["k_times"] = torch.arange(s, dtype=torch.int32, device=dev)[
            None].expand(b, s).contiguous()
    return q, k.contiguous(), v.contiguous(), kvl, opts


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(LM_DECODE_CASES))
def test_lm_decode_shapes_match_plain(dev, name, cache_dtype, q_dtype):
    q, k, v, kvl, opts = _lm_decode_case(dev, LM_DECODE_CASES[name],
                                         cache_dtype, q_dtype)
    got = fd.flash_decode(q, k, v, kvl, layer=1, **opts)
    again = fd.flash_decode(q, k, v, kvl, layer=1, **opts)
    want = fd.decode_plain(q, k, v, kvl, layer=1, **opts)
    assert got.dtype == q.dtype
    tol = DECODE_TOL["bfloat16" if q_dtype == "bfloat16" else cache_dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LM_FLASH_CASES))
def test_lm_flash_forward_shapes_match_plain(dev, name, dtype):
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, s, d = LM_FLASH_CASES[name]
    g = torch.Generator(device=dev).manual_seed(6)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, s, d), generator=g, device=dev).to(dt)
    k = torch.randn((b, hkv, s, d), generator=g, device=dev).to(dt)
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    want, want_lse = fa.flash_fwd_plain(q, k, v, causal=True)
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_lm_served_on_the_card_matches_the_cpu(dev, cache_dtype):
    """The reduced phi4-mini-3.8b on the card against the same weights on
    the CPU: the prefill step's logits, and a 3-slot server's greedy tokens
    for 5 requests, with the decode kernel launched once a layer a tick and
    no full-forward kernel on the serving path."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.nn.transformer import build_model
    from repro_torch.runtime.server import Request, Server
    from repro_torch.runtime.steps import make_prefill_step
    cfg = get_config("phi4-mini-3.8b").reduced(dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)))
    want = make_prefill_step(cpu)({"tokens": toks})
    got = make_prefill_step(card)({"tokens": toks.to(dev)})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-3)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(3, 20))
               for _ in range(5)]
    served = []
    for model in (cpu, card):
        srv = Server(model, num_slots=3, max_len=64, cache_dtype=cache_dtype)
        for uid, p in enumerate(prompts):
            srv.submit(Request(uid=uid, prompt=p, max_new_tokens=8))
        cuda.reset_launches()
        done = srv.run_until_drained()
        served.append({uid: r.generated for uid, r in done.items()})
    assert dict(cuda.LAUNCHES) == {"flash_decode": cfg.num_layers * srv.ticks}
    assert served[0] == served[1]


# -- the decode with a sliding window and a softcap (gemma2) ------------------

# (b, hq, hkv, sq, s, cursors, window): gemma2's GQA at one row a slot, its
# cursors on either side of the window (one inside it); a chunk of 40 rows
# a slot (64-row CTAs that test the window before loading a tile); MQA
WINDOW_CASES = {
    "tick": (4, 4, 2, 1, 640, [1, 100, 300, 640], 256),
    "tick_window_past_cursors": (3, 4, 2, 1, 320, [5, 200, 320], 4096),
    "chunk": (2, 4, 2, 40, 512, [40, 512], 96),
    "mqa": (3, 8, 1, 1, 384, [7, 129, 384], 64),
}


def _window_case(dev, name, cache_dtype, q_dtype):
    """An LM cache of two layers read at layer 1, rows past each cursor NaN
    (int8: NaN scales); query rows at the positions before each cursor,
    times = positions."""
    b, hq, hkv, sq, s, cursors, window = WINDOW_CASES[name]
    g = torch.Generator(device=dev).manual_seed(9)
    k = torch.randn((2, b, hkv, s, 128), generator=g, device=dev)
    v = torch.randn((2, b, hkv, s, 128), generator=g, device=dev)
    q = torch.randn((b, hq, sq, 128), generator=g, device=dev) * 3
    kvl = torch.tensor(cursors, dtype=torch.int32, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= kvl[:, None].long()
    nan = torch.tensor(float("nan"), device=dev)
    opts = {}
    if cache_dtype == "int8":
        (k, ks), (v, vs) = fd.quantize_kv(k), fd.quantize_kv(v)
        opts = {n: torch.where(past[None, :, None], nan, x).contiguous()
                for n, x in (("k_scale", ks), ("v_scale", vs))}
    else:
        dt = getattr(torch, cache_dtype)
        k = torch.where(past[None, :, None, :, None], nan, k).to(dt)
        v = torch.where(past[None, :, None, :, None], nan, v).to(dt)
    opts["q_times"] = (kvl[:, None] - sq + torch.arange(sq, device=dev)
                       ).clamp(min=0).to(torch.int32).contiguous()
    opts["k_times"] = torch.arange(s, dtype=torch.int32, device=dev)[
        None].expand(b, s).contiguous()
    return (q.to(getattr(torch, q_dtype)), k.contiguous(), v.contiguous(),
            kvl, opts, window)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 5])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_flash_decode_window_softcap_matches_plain(dev, cache_dtype, q_dtype,
                                                   name, softcap, splits):
    """The window (and the softcap, on the query scaled so that it bites)
    through the kernel against the plain version, one split to more;
    bitwise repeatable."""
    q, k, v, kvl, opts, window = _window_case(dev, name, cache_dtype,
                                              q_dtype)
    _check_decode(q, k, v, kvl, dict(opts, window=window, softcap=softcap),
                  cache_dtype, splits)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_flash_decode_softcap_alone_matches_plain(dev, cache_dtype):
    """gemma2's global layers: a softcap and no window (no times)."""
    q, k, v, kvl, opts, _ = _window_case(dev, "tick", cache_dtype, "float32")
    opts = {n: t for n, t in opts.items() if "times" not in n}
    _check_decode(q, k, v, kvl, dict(opts, softcap=50.0), cache_dtype, None)


@pytest.mark.gpu
def test_flash_decode_window_refuses_what_it_does_not_take(dev):
    q, k, v, kvl, opts, _ = _window_case(dev, "tick", "float32", "float32")
    with pytest.raises(ValueError, match="needs q_times"):
        fd.flash_decode(q, k, v, kvl, layer=1, window=16)
    wide = torch.zeros((1, 2, 2, 8, 256), device=dev)
    with pytest.raises(ValueError, match="at most 200 columns"):
        fd.flash_decode(torch.zeros((2, 2, 1, 256), device=dev), wide, wide,
                        torch.ones(2, dtype=torch.int32, device=dev),
                        layer=0, softcap=5.0)


# (b, hq, hkv, s, d, options): phi4-mini-3.8b's train attention (cut to 256
# tokens), gemma2's local layer (window, softcap, query_pre_attn_scalar
# 144) and its global one, and a softcap of 2 that bends the unit-scale
# scores (50 barely does)
LM_TRAIN_FLASH = {
    "phi4_train": (2, 24, 8, 256, 128, dict(causal=True)),
    "gemma2_local": (1, 32, 16, 384, 128, dict(causal=True, window=128,
                                                softcap=50.0,
                                                scale=144 ** -0.5)),
    "gemma2_global": (1, 32, 16, 384, 128, dict(causal=True, softcap=50.0,
                                                 scale=144 ** -0.5)),
    "softcap_bends": (1, 8, 4, 300, 128, dict(causal=True, window=100,
                                               softcap=2.0)),
    # hymba-1.5b's heads (25 / 5 x 64), windowed past its first keys and
    # global (its window 1,024 cut to 128 with the sequence)
    "hymba_local": (2, 25, 5, 384, 64, dict(causal=True, window=128)),
    "hymba_global": (2, 25, 5, 384, 64, dict(causal=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LM_TRAIN_FLASH))
def test_lm_train_flash_kernels_match_plain(dev, name, dtype):
    """The forward, dq and dk/dv at the LM train shapes, as
    test_flash_kernels_match_plain holds them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    b, hq, hkv, s, d, opts = LM_TRAIN_FLASH[name]
    g = torch.Generator(device=dev).manual_seed(10)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, hq, s, d)))
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    want_out, want_lse = fa.flash_fwd_plain(q, k, v, **opts)
    got = fab.flash_attention_bwd(q, k, v, out, lse, do, **opts)
    wide = torch.float64 if dtype == "float32" else q.dtype
    want = tuple(w.to(q.dtype) for w in fab.flash_bwd_plain(
        q.to(wide), k.to(wide), v.to(wide), out.to(wide), lse, do.to(wide),
        **opts))
    tol = dict(atol=2e-5, rtol=2e-4) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    gtol = dict(atol=1e-5, rtol=1e-3) if dtype == "float32" else \
        dict(atol=1e-2, rtol=4e-2)
    for which, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), w.float(), **gtol, msg=which)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma2-27b"])
def test_lm_train_step_on_the_card_matches_the_cpu(dev, arch):
    """The reduced config's train step (remat) on the card against the
    same weights on the CPU: the loss, every gradient within 1e-4 of its
    tensor's largest, and the flash kernels launched exactly (the forward
    twice a layer under remat, dq and dk/dv once)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm
    from repro_torch.kernels import cuda
    from repro_torch.nn.transformer import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step
    cfg = get_config(arch).reduced(dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = synthetic_lm.generate_batch(0, 0, 2, synthetic_lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=48))
    want_g, want_m = make_train_step(cpu, adamw(1e-3)).grads(batch)
    cuda.reset_launches()
    got_g, got_m = make_train_step(card, adamw(1e-3)).grads(batch)
    torch.cuda.synchronize()
    n = cfg.num_layers
    assert dict(cuda.LAUNCHES) == {"flash_attention_fwd": 2 * n,
                                   "flash_attention_dq": n,
                                   "flash_attention_dkv": n}
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    for name, w in want_g.items():
        err = float((got_g[name].cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7, (name, err)


# -- MoE and MLA (deepseek-v2-lite, kimi-k2) ----------------------------------

# (b, hq, sq, s, cursors, r, dr): MLA's absorbed decode, 16 heads against
# one latent kv head whose values are the rows' first r columns; a tick at
# deepseek's widths, a 40-row chunk, and narrow rows (the reduced config)
MLA_DECODE_CASES = {
    "tick": (4, 16, 1, 600, [1, 77, 544, 600], 512, 64),
    "chunk": (2, 16, 40, 320, [40, 300], 512, 64),
    "narrow": (3, 4, 1, 64, [5, 33, 64], 32, 16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MLA_DECODE_CASES))
def test_mla_pitch_decode_matches_plain(dev, name, cache_dtype, q_dtype):
    """V as the leading r columns of the cached (r + dr)-wide rows (the
    kernel reads them at the rows' pitch) against the plain version, and
    bitwise equal to the same call on a contiguous copy of V."""
    b, hq, sq, s, cursors, r, dr = MLA_DECODE_CASES[name]
    g = torch.Generator(device=dev).manual_seed(11)
    rows = torch.randn((2, b, 1, s, r + dr), generator=g, device=dev)
    kvl = torch.tensor(cursors, dtype=torch.int32, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= kvl[:, None].long()
    rows = torch.where(past[None, :, None, :, None], float("nan"), rows).to(
        getattr(torch, cache_dtype))
    q = torch.randn((b, hq, sq, r + dr), generator=g, device=dev).to(
        getattr(torch, q_dtype))
    opts = dict(scale=(128 + dr) ** -0.5)
    if sq > 1:
        opts["q_times"] = (kvl[:, None] - sq + torch.arange(
            sq, device=dev)).int().contiguous()
        opts["k_times"] = torch.arange(s, dtype=torch.int32, device=dev)[
            None].expand(b, s).contiguous()
    v = rows[..., :r]
    assert not v.is_contiguous()
    got = fd.flash_decode(q, rows, v, kvl, layer=1, **opts)
    copy = fd.flash_decode(q, rows, v.contiguous(), kvl, layer=1, **opts)
    want = fd.decode_plain(q, rows, v, kvl, layer=1, **opts)
    assert got.shape == (b, hq, sq, r)
    tol = DECODE_TOL["bfloat16" if q_dtype == "bfloat16" else cache_dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, copy)


@pytest.mark.gpu
def test_flash_decode_refuses_a_strided_value_it_cannot_read(dev):
    rows = torch.zeros((1, 2, 1, 64, 48), device=dev)
    q = torch.zeros((2, 4, 1, 48), device=dev)
    kvl = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="leading"):
        fd.flash_decode(q, rows, rows[..., ::2][..., :16], kvl, layer=0)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_on_the_card_matches_the_cpu(dev, capacity_factor):
    """The reduced MoE layer (with shared experts) on the card against the
    same weights on the CPU: its output, aux loss and gradients, with and
    without dropped assignments; bitwise repeatable on the card, and no
    host synchronisation in the forward."""
    from repro_torch.nn.module import init_params
    from repro_torch.nn.moe import MoE
    kw = dict(d_model=64, num_experts=8, top_k=2, expert_ff=32,
              num_shared=2, capacity_factor=capacity_factor)
    cpu = init_params(MoE(**kw, device="cpu"),
                      torch.Generator().manual_seed(0))
    card = MoE(**kw, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(1))
    outs = []
    for m, xi in ((cpu, x), (card, x.to(dev)), (card, x.to(dev))):
        m.requires_grad_(True)
        xi = xi.clone().requires_grad_(True)
        y, aux = m(xi)
        grads = torch.autograd.grad((y.square().sum() + aux),
                                    [xi] + list(m.parameters()))
        outs.append([y, aux] + list(grads))
    x_dev = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            card(x_dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(outs[1][:2], outs[0][:2]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4)
    # the gradients (of x, then the parameters): each within 1e-4 of its
    # tensor's largest |g|, tests/test_torch_moe.py's rule
    for a, b in zip(outs[1][2:], outs[0][2:]):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()) + 1e-7, err
    for a, b in zip(outs[1], outs[2]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_moe_lm_on_the_card_matches_the_cpu(dev, arch):
    """The reduced MoE config on the card against the same weights on the
    CPU: the full forward (the flash forward, MLA's at D 32 / Dv 32), the
    cached decode of 8 tokens (deepseek: the latent rows through the
    decode kernel's pitch) and the train step's gradients, with the
    kernels' launches exact."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm
    from repro_torch.kernels import cuda
    from repro_torch.nn.transformer import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step
    cfg = get_config(arch).reduced(dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    n = cfg.num_layers
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)))
    logits = []
    for m, t in ((cpu, toks), (card, toks.to(dev))):
        with torch.no_grad():
            full, aux, _ = m(t)
            cache = m.init_cache(2, 8, torch.float32)
            cuda.reset_launches()
            steps = [m(t[:, i:i + 1], cache=cache, cache_index=i)[0]
                     for i in range(8)]
        logits.append((full, aux, torch.cat(steps, 1)))
    assert dict(cuda.LAUNCHES) == {"flash_decode": 8 * n}
    for a, b in zip(logits[1], logits[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(logits[1][2], logits[1][0], atol=2e-3,
                               rtol=2e-2)
    batch = synthetic_lm.generate_batch(0, 0, 2, synthetic_lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=48))
    want_g, want_m = make_train_step(cpu, adamw(1e-3)).grads(batch)
    cuda.reset_launches()
    got_g, got_m = make_train_step(card, adamw(1e-3)).grads(batch)
    torch.cuda.synchronize()
    assert dict(cuda.LAUNCHES) == {"flash_attention_fwd": 2 * n,
                                   "flash_attention_dq": n,
                                   "flash_attention_dkv": n}
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5)
    for name, w in want_g.items():
        err = float((got_g[name].cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7, (name, err)


# -- the SSM families (hymba-1.5b, rwkv6-7b) ----------------------------------

# (cursors, window): hymba's tick, 25 query heads over 5 kv heads of 64, its
# windowed layers' window 1,024 with every cursor past it, and its global
# layers (no window)
HYMBA_DECODE_CASES = {"windowed": ([1100, 1500, 2048], 1024),
                      "global": ([1100, 1500, 2048], None)}


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(HYMBA_DECODE_CASES))
def test_hymba_decode_matches_plain(dev, name, cache_dtype, q_dtype):
    """The decode at hymba's heads, windowed and global, against the plain
    version; rows past each cursor NaN (int8: NaN scales); bitwise
    repeatable."""
    cursors, window = HYMBA_DECODE_CASES[name]
    b, s = len(cursors), max(cursors)
    g = torch.Generator(device=dev).manual_seed(12)
    k = torch.randn((2, b, 5, s, 64), generator=g, device=dev)
    v = torch.randn((2, b, 5, s, 64), generator=g, device=dev)
    q = torch.randn((b, 25, 1, 64), generator=g, device=dev).to(
        getattr(torch, q_dtype))
    kvl = torch.tensor(cursors, dtype=torch.int32, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= kvl[:, None].long()
    opts = {}
    if cache_dtype == "int8":
        (k, ks), (v, vs) = fd.quantize_kv(k), fd.quantize_kv(v)
        opts = {n: torch.where(past[None, :, None], float("nan"),
                               x).contiguous()
                for n, x in (("k_scale", ks), ("v_scale", vs))}
    else:
        dt = getattr(torch, cache_dtype)
        k = torch.where(past[None, :, None, :, None], float("nan"), k).to(dt)
        v = torch.where(past[None, :, None, :, None], float("nan"), v).to(dt)
    if window is not None:
        opts.update(window=window,
                    q_times=(kvl[:, None] - 1).contiguous(),
                    k_times=torch.arange(s, dtype=torch.int32, device=dev)[
                        None].expand(b, s).contiguous())
    _check_decode(q, k.contiguous(), v.contiguous(), kvl, opts, cache_dtype,
                  None)


def _ssm_pair(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.nn.transformer import build_model
    cfg = get_config(arch).reduced(dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_ssm_lm_on_the_card_matches_the_cpu(dev, arch):
    """The reduced SSM config on the card against the same weights on the
    CPU: the full forward, a 16-token chunk and 16 decoded tokens (hymba's
    window of 16 biting), and the train step's gradients, with the
    attention kernels' launches exact (rwkv6 has none)."""
    import numpy as np
    from repro_torch.data import synthetic_lm
    from repro_torch.kernels import cuda
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step
    cfg, cpu, card = _ssm_pair(dev, arch)
    n = cfg.num_layers if cfg.attention_kind != "none" else 0
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)))
    logits = []
    for m, t in ((cpu, toks), (card, toks.to(dev))):
        with torch.no_grad():
            full, _, _ = m(t)
            cache = m.init_cache(2, 32, torch.float32)
            cuda.reset_launches()
            steps = [m(t[:, :16], cache=cache, cache_index=0)[0]]
            steps += [m(t[:, i:i + 1], cache=cache, cache_index=i)[0]
                      for i in range(16, 32)]
        logits.append((full, torch.cat(steps, 1)))
    assert dict(cuda.LAUNCHES) == ({"flash_decode": 17 * n} if n else {})
    for a, b in zip(logits[1], logits[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(logits[1][1], logits[1][0], atol=2e-3,
                               rtol=2e-2)
    batch = synthetic_lm.generate_batch(0, 0, 2, synthetic_lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=48))
    want_g, want_m = make_train_step(cpu, adamw(1e-3)).grads(batch)
    cuda.reset_launches()
    got_g, got_m = make_train_step(card, adamw(1e-3)).grads(batch)
    torch.cuda.synchronize()
    assert dict(cuda.LAUNCHES) == ({"flash_attention_fwd": 2 * n,
                                    "flash_attention_dq": n,
                                    "flash_attention_dkv": n} if n else {})
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    for name, w in want_g.items():
        err = float((got_g[name].cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_ssm_server_zeroes_state_at_admission_on_the_card(dev, arch):
    """Five requests through two slots on the card: an admitted slot's
    recurrent state is zero, and each request (three re-admitted into a
    used slot) equals its solo run."""
    import numpy as np
    from repro_torch.runtime.server import Request, Server
    cfg, _, card = _ssm_pair(dev, arch)
    rng = np.random.default_rng(4)
    requests = [(uid, rng.integers(1, cfg.vocab_size, rng.integers(2, 9)),
                 int(rng.integers(3, 9))) for uid in range(5)]

    def serve(reqs, slots):
        srv = Server(card, num_slots=slots, max_len=48)
        for uid, prompt, new in reqs:
            srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
        while srv.queue or any(sl.request for sl in srv.slots):
            fresh = [i for i, sl in enumerate(srv.slots)
                     if sl.request is None and srv.queue]
            srv._admit()
            for gc in srv.cache.values():
                for key in ("ssm", "cmix_shift"):
                    if key in gc:
                        state = gc[key]
                        for t in (state.values() if isinstance(state, dict)
                                  else (state,)):
                            assert not t[:, fresh].any(), key
            srv.step()
        return {uid: r.generated for uid, r in srv.done.items()}

    got = serve(requests, 2)
    for req in requests:
        assert got[req[0]] == serve([req], 1)[req[0]], req[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_cross_decode_layer_none(dev, dtype):
    """The decode at whisper's cross-attention tick: 8 slots x 8 heads x 1
    row x 64 against the 1,500 frames' keys, a 4-d key set (``layer=None``),
    every row's kv_length 1,500 and no times (unmasked), against the plain
    version; bitwise repeatable."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(17)
    dt = getattr(torch, dtype)
    q = torch.randn((8, 8, 1, 64), generator=g, device=dev).to(dt)
    k, v = (torch.randn((8, 8, 1500, 64), generator=g, device=dev).to(dt)
            for _ in range(2))
    kvl = torch.full((8,), 1500, dtype=torch.int32, device=dev)
    run = lambda impl: ops.decode_attention(  # noqa: E731
        q, k, v, kv_length=kvl, impl=impl, scale=0.125)
    got, again, want = run("flash_decode"), run("flash_decode"), run("plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **DECODE_TOL[dtype])
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_whisper_on_the_card_matches_the_cpu(dev):
    """The reduced whisper on the card against the same weights on the CPU:
    the encoder, the full forward, a 3-token chunk and 5 decoded tokens
    (the decode kernel for self- and cross-attention), and the train step's
    gradients, the kernels' launches exact."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_serve_step, make_train_step
    from repro_torch.nn.transformer import build_model
    cfg = get_config("whisper-base").reduced(dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.normal(size=(2, 32, 128)).astype(
        np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    outs = []
    for m, f, t in ((cpu, frames, toks), (card, frames.to(dev),
                                          toks.to(dev))):
        serve = make_serve_step(m)
        cuda.reset_launches()
        with torch.no_grad():
            full, _, _ = m(f, t)
            enc = m.encode(f)
            cache = m.init_cache(2, 8, "float32")
            steps = [m.decode(t[:, :3], enc, cache=cache, cache_index=0)[0]]
            steps += [serve(cache, t[:, i:i + 1], i, enc_out=enc)[0][:, None]
                      for i in range(3, 8)]
        outs.append((full, torch.cat(steps, 1)))
    assert dict(cuda.LAUNCHES) == {
        "flash_attention_fwd": 2 * n_enc + 2 * n_dec,
        "flash_decode": 2 * n_dec * 6}
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(outs[1][1], outs[1][0], atol=2e-3, rtol=2e-2)
    batch = {"tokens": toks.numpy(), "labels": np.roll(toks.numpy(), -1, 1),
             "frames": frames.numpy()}
    want_g, want_m = make_train_step(cpu, adamw(1e-3)).grads(batch)
    cuda.reset_launches()
    got_g, got_m = make_train_step(card, adamw(1e-3)).grads(batch)
    torch.cuda.synchronize()
    n = n_enc + 2 * n_dec
    assert dict(cuda.LAUNCHES) == {"flash_attention_fwd": n,
                                   "flash_attention_dq": n,
                                   "flash_attention_dkv": n}
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    for name, w in want_g.items():
        err = float((got_g[name].cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7, (name, err)


@pytest.mark.gpu
def test_cost_gauges_on_the_card_match_the_formulas(dev):
    """The reduced sim model's engine, server and train step on the card:
    each path's counted FLOPs within 1% of ``analytic_flops`` at the same
    call's shapes and its kernels' share equal, as on the CPU."""
    from repro_torch import obs
    from repro_torch import scenarios as tscen
    from repro_torch.nn.agent_sim import AgentSimConfig, AgentSimModel
    from repro_torch.obs import cost
    from repro_torch.runtime import RolloutEngine
    from repro_torch.runtime.sim_server import SceneRequest, SimServer
    from repro_torch.training.data import make_sim_batch
    from repro_torch.training.steps import bc_optimizer, make_sim_train_step
    scen = tscen.ScenarioConfig(num_map=8, num_agents=3, num_steps=7)
    model = AgentSimModel(AgentSimConfig(
        d_model=48, num_layers=2, num_heads=2, head_dim=24, d_ff=96,
        fourier_terms=8, num_actions=scen.num_actions), device=dev)
    scenes = [tscen.generate_scene("freeform", 0, i, scen) for i in range(2)]
    eng = RolloutEngine(model, scen, num_slots=2, registry=obs.NULL)
    srv = SimServer(model, scen, num_slots=2, registry=obs.NULL)
    seen = {}
    wrapped = {"rollout.prefill": (eng._prefill, eng._prefill_body),
               "rollout.step": (eng._step, eng._step_body),
               "sim_server.tick": (srv._tick, srv._tick_body),
               "sim_server.admit": (srv._admit, srv._admit_impl)}
    for path, (w, _) in wrapped.items():
        inner = w._fn

        def spy(*args, _inner=inner, _path=path):
            seen.setdefault(_path, args)
            return _inner(*args)
        w._fn = spy
    eng.run(scenes, t_hist=3, n_samples=1, seed=0)
    srv.submit(SceneRequest(uid=0, tensors=scenes[0], t_hist=3))
    srv.run_until_drained()
    checks = []
    for path, (w, body) in wrapped.items():
        with torch.no_grad():
            checks.append((path, w.cost, cost.analytic_flops(
                model, lambda: body(*seen[path]))))
    step = make_sim_train_step(model, bc_optimizer(1e-3, 2))
    counted = obs.CostAccounted(step, "train.step", registry=obs.NULL)
    batch = make_sim_batch(0, 0, 2, scen)
    counted.grads(batch)
    counted.grads(batch)          # an update skipped: the count is recorded
    checks.append(("train.step", counted.cost, cost.analytic_flops(
        model, lambda: step.grads(batch))))
    for path, rec, (flops, kernel) in checks:
        assert rec["kernel_flops"] == kernel > 0, path
        assert abs(rec["flops"] - flops) <= 0.01 * flops, (path, rec, flops)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_dryrun_flops_equal_the_cards_count(dev, mode):
    """``launch/dryrun.py``'s count (FLOPs and bytes accessed) on the
    ``meta`` device equals ``CostAccounted``'s count of the same step on
    the card, through the kernels: a reduced phi4-mini's train step
    (AdamW) and serve step."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.nn.transformer import build_model
    from repro_torch.obs import NULL, CostAccounted
    from repro_torch.runtime import steps
    cfg = configs.get_config("phi4-mini-3.8b").reduced()
    shape = ShapeConfig("small", 64, 2, mode)
    rec = dryrun.lower_cell(cfg.name, shape.name, False, cfg=cfg,
                            shape=shape, mesh={"data": 1, "model": 1})
    model = build_model(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(1, cfg.vocab_size, (2, 64), generator=g,
                         device=dev, dtype=torch.int32)
    if mode == "train":
        opt = dryrun.choose_optimizer(cfg)
        state = opt.init(dict(model.named_parameters()))
        step = CostAccounted(steps.make_train_step(model, opt), "t",
                             registry=NULL)
        grads, _ = step.grads({"tokens": toks, "labels": toks})
        step.update(state, grads)
    else:
        cache = model.init_cache(2, 64, cfg.compute_dtype)
        step = CostAccounted(steps.make_serve_step(model), "d",
                             registry=NULL)
        step(cache, toks[:, :1], 63)
    torch.cuda.synchronize()
    assert rec["full_depth"]["flops"] == step.cost["flops"] > 0
    assert rec["full_depth"]["kernel_flops"] == step.cost["kernel_flops"]
    assert rec["full_depth"]["bytes_accessed"] == \
        step.cost["bytes_accessed"]
