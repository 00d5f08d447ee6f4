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
