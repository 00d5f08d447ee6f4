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
# run time, padding columns zeroed), and past 200 (16-key tiles)
ODD_WIDTHS = {"d20_dv36": (20, 36), "d232": (232, 232)}
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


def _check_decode(q, k, v, kvl, opts, cache_dtype, splits):
    got = fd.flash_decode(q, k, v, kvl, layer=1, num_splits=splits, **opts)
    again = fd.flash_decode(q, k, v, kvl, layer=1, num_splits=splits, **opts)
    want = fd.decode_plain(q, k, v, kvl, layer=1, **opts)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, **DECODE_TOL[cache_dtype])
    assert torch.equal(got, again)
    assert not bool(got[kvl == 0].any())


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
    """Widths the kernels do not take, and non-contiguous inputs, raise
    before any launch; nothing falls back to the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = torch.zeros((1, 1, 8, 260), device=dev)
    with pytest.raises(ValueError, match="widths"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 1, 8, 30), device=dev)
    with pytest.raises(ValueError, match="widths"):
        fa.flash_attention_fwd(q, q, q)
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
    import numpy as np
    from repro_torch import configs, scenarios
    from repro_torch.kernels import cuda
    from repro_torch.nn.agent_sim import AgentSimModel
    arch = configs.get_sim_arch("sim-se2-fourier").reduced()
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
