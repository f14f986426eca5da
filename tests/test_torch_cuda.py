"""The CUDA kernels K1-K7 against their plain PyTorch versions on the card,
at small shapes (K5-K7 also at the full streaming width), float32 and
bfloat16 (marker `cuda`; skips without a GPU).

Run on the card:  python -m pytest tests/test_torch_cuda.py -q

Bounds: float32 outputs differ only by summation order and rounding ties
of the int8 codes (see test_torch_kernels); bfloat16 outputs additionally by
one bf16 ulp (2^-8 relative) where the two sides round differently. K4's
arithmetic is identical on both sides, so its codes and scales must match
exactly. The attention cores K5-K7 have no int8 step: float32 within 1e-5
of the output scale (summation order, expf against torch.exp), bfloat16
within the rounding of the output and of the probabilities (two bf16 ulps,
2^-7 relative to the largest output).
"""

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.ops.kernels import attention_cuda, corr_cuda, mlp_int8_cuda

pytestmark = pytest.mark.cuda
C, HID, H, D = 384, 1536, 8, 48


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lin(g, o, i, dev):
    w = torch.randn(o, i, generator=g) * 0.05
    return mlp_int8_cuda.quantize_linear(w.to(dev), (torch.randn(o, generator=g) * 0.1).to(dev))


def _close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    scale = ref.abs().mean()
    tight = 1e-4 if dtype == torch.float32 else 8e-3
    assert (err > tight * scale).float().mean().item() <= 0.02
    assert err.max().item() <= 0.05 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,T", [(37, 6), (20, 60)])
def test_time_block(dev, dtype, M, T):
    g = torch.Generator().manual_seed(M * T)
    w = mlp_int8_cuda.TimeBlockWeights(_lin(g, 3 * C, C, dev), _lin(g, C, C, dev),
                                       _lin(g, HID, C, dev), _lin(g, C, HID, dev))
    x = torch.randn(M, T, C, generator=g).to(dev, dtype)
    n = mlp_int8_cuda.fused_time_block_int8.launches
    out = mlp_int8_cuda.fused_time_block_int8(x, w, H, D)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_time_block_int8.launches == n + 1
    _close(out, mlp_int8_cuda.time_block_plain(x, w, H, D), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_space_block(dev, dtype):
    g = torch.Generator().manual_seed(1)
    N, T, V = 300, 5, 64
    w = mlp_int8_cuda.SpaceBlockWeights(_lin(g, C, C, dev), _lin(g, C, C, dev),
                                        _lin(g, HID, C, dev), _lin(g, C, HID, dev))
    x = torch.randn(N, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(T, V, 2 * C, generator=g).to(dev, dtype)
    out = mlp_int8_cuda.fused_space_block_int8(x, kv, w, H, D)
    _close(out, mlp_int8_cuda.space_block_plain(x, kv, w, H, D), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_virtual_from_points_proj(dev, dtype):
    g = torch.Generator().manual_seed(2)
    N, T, V = 1000, 3, 64
    wkv = _lin(g, 2 * C, C, dev)
    q = (torch.randn(T, V, C, generator=g) * 0.3).to(dev, dtype)
    x = torch.randn(N, T, C, generator=g).to(dev, dtype)
    gamma = (1 + 0.2 * torch.randn(C, generator=g)).to(dev)
    beta = (0.1 * torch.randn(C, generator=g)).to(dev)
    bias = torch.zeros(N, device=dev)
    bias[700:] = attention_cuda.NEG_BIG
    out = attention_cuda.fused_virtual_from_points_proj(q, x, wkv, gamma, beta, H, D, bias)
    ref = attention_cuda.v2p_proj_plain(q, x, wkv, gamma, beta, H, D, bias)
    _close(out, ref, dtype)


@pytest.mark.parametrize("T", [5, 8])
def test_corr_volume(dev, T):
    g = torch.Generator().manual_seed(T)
    B, Hh, W, NP = 2, 24, 32, 40
    fm = torch.nn.functional.normalize(torch.randn(B, T, Hh, W, 128, generator=g), dim=-1)
    fmq = corr_cuda.build_int8_level(fm.to(dev), 3)
    sup = torch.nn.functional.normalize(torch.randn(B, 49, NP // B, 128, generator=g), dim=-1)
    supq, _ = corr_cuda.quantize_support(sup.to(dev), torch.float32)
    coords = (torch.rand(B, T, NP // B, 2, generator=g) * torch.tensor([W + 6.0, Hh + 6.0]) - 3)
    starts, wxy = corr_cuda.level_operands(coords.to(dev), B, T, Hh, W, 3)
    vol, scale = corr_cuda.corr_volume_int8(fmq, supq.reshape(NP, 49, 128), starts, wxy)
    rvol, rscale = corr_cuda.corr_volume_plain(fmq, supq.reshape(NP, 49, 128), starts, wxy)
    assert torch.equal(scale, rscale)
    assert torch.equal(vol, rvol)


def _core_close(out, ref, dtype):
    assert out.dtype == dtype and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    assert err <= tol * max(ref.float().abs().max().item(), 1.0), err


CORE_SHAPES = [(37, 6), (64, 60), (10240, 16)]  # (rows or tracks, frames)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,T", CORE_SHAPES + [(3, 512)])
def test_time_attention(dev, dtype, M, T):
    g = torch.Generator().manual_seed(M + T)
    q = torch.randn(M, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(M, T, 2 * C, generator=g).to(dev, dtype)
    n = attention_cuda.fused_time_attention.launches
    out = attention_cuda.fused_time_attention(q, kv, H, D)
    torch.cuda.synchronize()
    assert attention_cuda.fused_time_attention.launches == n + 1
    _core_close(out, attention_cuda.time_attention_plain(q, kv, H, D), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T", CORE_SHAPES)
def test_points_from_virtual(dev, dtype, N, T):
    g = torch.Generator().manual_seed(N + T)
    q = torch.randn(N, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(T, 64, 2 * C, generator=g).to(dev, dtype)
    n = attention_cuda.fused_points_from_virtual.launches
    out = attention_cuda.fused_points_from_virtual(q, kv, H, D)
    torch.cuda.synchronize()
    assert attention_cuda.fused_points_from_virtual.launches == n + 1
    _core_close(out, attention_cuda.p2v_plain(q, kv, H, D), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", ["none", "tail", "all"])
@pytest.mark.parametrize("N,T", CORE_SHAPES)
def test_virtual_from_points(dev, dtype, masked, N, T):
    g = torch.Generator().manual_seed(N + T)
    q = (0.3 * torch.randn(T, 64, C, generator=g)).to(dev, dtype)
    kv = torch.randn(N, T, 2 * C, generator=g).to(dev, dtype)
    bias = None
    if masked != "none":
        bias = torch.zeros(N, device=dev)
        bias[(N * 2 // 3 if masked == "tail" else 0):] = attention_cuda.NEG_BIG
    n = attention_cuda.fused_virtual_from_points.launches
    out = attention_cuda.fused_virtual_from_points(q, kv, H, D, key_bias=bias)
    torch.cuda.synchronize()
    assert attention_cuda.fused_virtual_from_points.launches == n + 1
    assert torch.isfinite(out.float()).all()
    _core_close(out, attention_cuda.v2p_plain(q, kv, H, D, key_bias=bias), dtype)


def test_cores_raise_instead_of_falling_back(dev):
    q = torch.randn(4, 5, C, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.fused_time_attention(q, torch.randn(4, 5, 2 * C), H, D)
    with pytest.raises(TypeError, match="dtype"):
        attention_cuda.fused_time_attention(q, torch.randn(4, 5, 2 * C, device=dev).bfloat16(), H, D)
    with pytest.raises(ValueError, match="at most"):
        attention_cuda.fused_time_attention(torch.randn(1, 513, C, device=dev),
                                            torch.randn(1, 513, 2 * C, device=dev), H, D)
