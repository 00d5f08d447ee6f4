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


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["q", "k"])
def test_se2_project_kernel_matches_plain(dev, mode, x_dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    enc = SE2Fourier(head_dim=24, num_terms=12)
    x = torch.randn((3, 2, 5, 24), generator=g, device=dev)
    pose = torch.randn((3, 5, 3), generator=g, device=dev)
    x = x.to(getattr(torch, x_dtype))
    got = sp.se2_fourier_project(x, pose, enc, mode)
    want = sp.se2_project_plain(x, pose, enc, mode)
    assert got.dtype == x.dtype
    tol = dict(atol=1e-5, rtol=1e-4) if x_dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


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


@pytest.mark.gpu
def test_refused_launch_raises(dev):
    """A launch the card refuses (here: more shared memory than an SM has)
    raises with CUDA's message; nothing falls back to the plain version."""
    enc = SE2Fourier(head_dim=48, num_terms=64)
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
