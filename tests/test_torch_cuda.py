"""The CUDA kernels K1-K12, K4r, K4f and K4m against their plain PyTorch
versions on the card, at small shapes (K5-K7 also at the full streaming
width), float32 and bfloat16, every W8A8 body in the two variant modes
(bf16 LayerNorm, GELU-quant fold), and the training autograd wrapper's
gradients against plain autograd (marker `cuda`; skips without a GPU).
K6 and K7 also at ragged shapes and, K7, at the quasi-dense key count
(several blocks per key range, merged); K5 past 512 frames and at the
edges of every route of k5_plan; K1 in bf16 (two launches) at every route
of k1_plan the frame gate reaches; K2 in bf16 (the fused front, then K1's
tail: two launches) and K3 in bf16 (one fused kernel, and the merge of its
key ranges) from 1 to 250 frames at ragged track counts; the K2 and K3
chains (the f32 routes) at the streaming width; the wrapper with
corr_fuse_mlp1 (K4m). K8 in bf16 (the streamed body) bit for bit against
its first body, and K10 in bf16 (the same body) against its own first
body; K4m's two launches (code rows, then MLP1) on every route of its
plan, its code rows, scales and rows bit for bit against its plain
version.

Run on the card:  python -m pytest tests/test_torch_cuda.py --noconftest -q

Bounds: float32 outputs differ only by summation order and rounding ties
of the int8 codes (see test_torch_kernels); bfloat16 outputs additionally by
one bf16 ulp (2^-8 relative) where the two sides round differently. K4's
arithmetic is identical on both sides, so its codes and scales must match
exactly. The attention cores K5-K7 have no int8 step: float32 within 1e-5
of the output scale (summation order, expf against torch.exp), bfloat16
within the rounding of the output and of the probabilities (two bf16 ulps,
2^-7 relative to the largest output). K4 is held so on every route of its plan (one pass in a
cluster, two passes past 64 frames). K4r runs K4's cluster kernel in its
K4r mode: its integer products are exact and its arithmetic the plain
version's, so codes and scales match exactly on every route of k4_plan.
K4f sums float32 products in another order in float32 (3xTF32 on the
tensor cores, whose dropped terms are under 2^-21 of sum|a b|): 1e-5 of
the largest output; in bfloat16 it sums in the plain version's order, one
bf16 ulp (2^-8) of it. K4m's arithmetic is its
plain version's, integer products and epilogue order alike: its rows match
exactly. K10, K12 and the variant modes take the W8A8 bound above; K11
runs K2's code, so it matches K2's wrapper bit for bit, and K12 matches its
first body bit for bit.
"""

import ctypes

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.ops.corr import fused_corr_embs
from cotracker_tpu_torch.ops.kernels import attention_cuda, corr_cuda, mlp_int8_cuda
from cotracker_tpu_torch.utils.profiling import device_launches

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


def _beyond_tight(out, ref, dtype):
    """Share of the elements of out beyond the W8A8 band's tight bound."""
    err = (out.float() - ref.float()).abs()
    tight = 1e-4 if dtype == torch.float32 else 8e-3
    return (err > tight * ref.float().abs().mean()).float().mean().item()


def _close(out, ref, dtype, share=0.02):
    assert _beyond_tight(out, ref, dtype) <= share
    assert (out.float() - ref.float()).abs().max().item() <= 0.05 * ref.float().abs().max().item()


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


def _time_pack(g, dev):
    return mlp_int8_cuda.TimeBlockWeights(_lin(g, 3 * C, C, dev), _lin(g, C, C, dev),
                                          _lin(g, HID, C, dev), _lin(g, C, HID, dev))


# K8 and K9: a ragged row count (not a multiple of their 128- and 64-row
# tiles) and the virtual tokens of a 250-frame video
SPLIT_SHAPES = [(37, 6), (64, 250)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,T", SPLIT_SHAPES)
def test_ln_qkv(dev, dtype, M, T):
    g = torch.Generator().manual_seed(M + T)
    w = _time_pack(g, dev)
    x = torch.randn(M, T, C, generator=g).to(dev, dtype)
    n = mlp_int8_cuda.fused_ln_qkv_int8.launches
    q, kv = mlp_int8_cuda.fused_ln_qkv_int8(x, w.qkv)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_ln_qkv_int8.launches == n + 1
    rq, rkv = mlp_int8_cuda.ln_qkv_plain(x, w.qkv)
    for o, r in ((q, rq), (kv, rkv)):
        assert o.dtype == dtype and o.shape == r.shape
        _close(o, r, dtype)


@pytest.mark.parametrize("bf16_ln", [False, True])
@pytest.mark.parametrize("M,T", SPLIT_SHAPES + [(300, 7), (1000, 40)])
def test_ln_qkv_stream_matches_first_body(dev, M, T, bf16_ln):
    """K8 in bfloat16 (the streamed body on k8_plan's persistent blocks) is
    bit-identical to the PR 4 body at the same inputs: the same LayerNorm and
    quantization device code, exact s8 products, the same epilogue order.
    Row counts: a ragged last tile (222, 2,100), whole tiles (16,000), and
    more tiles than SMs (40,000: runs of 2-3 tiles a block); both LN modes.
    The plan's shared-memory bytes are the kernel's."""
    g = torch.Generator().manual_seed(M + T)
    w = _time_pack(g, dev)
    x = torch.randn(M, T, C, generator=g).to(dev, torch.bfloat16)
    plan = mlp_int8_cuda.k8_plan(M * T, x.dtype)
    assert plan.route == "stream" and plan.smem == mlp_int8_cuda._lib()["k8_smem"]()
    n = mlp_int8_cuda.fused_ln_qkv_int8.launches
    q, kv = mlp_int8_cuda.fused_ln_qkv_int8(x, w.qkv, bf16_ln=bf16_ln)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_ln_qkv_int8.launches == n + 1
    fq, fkv = mlp_int8_cuda._ln_qkv_tile(x.reshape(-1, C), w.qkv, 1e-6, bf16_ln)
    assert torch.equal(q.reshape(-1, C), fq) and torch.equal(kv.reshape(-1, 2 * C), fkv)
    assert device_launches(lambda: mlp_int8_cuda.fused_ln_qkv_int8(x, w.qkv)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,T", SPLIT_SHAPES)
def test_attnout_mlp(dev, dtype, M, T):
    g = torch.Generator().manual_seed(M * T)
    w = _time_pack(g, dev)
    a, x = (torch.randn(M, T, C, generator=g).to(dev, dtype) for _ in range(2))
    n = mlp_int8_cuda.fused_attnout_res_mlp_int8.launches
    out = mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, w)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_attnout_res_mlp_int8.launches == n + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, mlp_int8_cuda.attnout_mlp_plain(a, x, w), dtype)


@pytest.mark.parametrize("mode", ["off", "bf16_ln", "gelu_fold"])
@pytest.mark.parametrize("M,T", [(37, 5), (3, 250), (64, 250)])
def test_attnout_mlp_tail(dev, M, T, mode):
    """K9 in bf16 is K1's tail with K9's prologue (a quantized in the tile)
    and last residual r + (y + b2): one launch; rows not a multiple of the
    64-row tile (185, 750), each variant mode; the band of test_attnout_mlp."""
    assert mlp_int8_cuda.k9_route(torch.bfloat16) == "tail"
    g = torch.Generator().manual_seed(M + T)
    w = _fold_pack(g, dev) if mode == "gelu_fold" else _time_pack(g, dev)
    a, x = (torch.randn(M, T, C, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    kw = {} if mode == "off" else {mode: True}
    n = mlp_int8_cuda.fused_attnout_res_mlp_int8.launches
    out = mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, w, **kw)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_attnout_res_mlp_int8.launches == n + 1
    _close(out, mlp_int8_cuda.attnout_mlp_plain(a, x, w, **kw), torch.bfloat16)


@pytest.mark.parametrize("M,T", [(37, 5), (64, 250)])
def test_attnout_mlp_negative_gelu(dev, M, T):
    """K9 in bf16 with every pre-GELU value negative and the fold off: every
    row takes the tail's full |gelu| max (pass 1b)."""
    g = torch.Generator().manual_seed(7)
    w = _fold_pack(g, dev)
    a, x = (torch.randn(M, T, C, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    _close(mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, w),
           mlp_int8_cuda.attnout_mlp_plain(a, x, w), torch.bfloat16)


def test_split_kernels_raise_instead_of_falling_back(dev):
    g = torch.Generator().manual_seed(0)
    w = _time_pack(g, dev)
    x = torch.randn(4, 5, C, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_int8_cuda.fused_attnout_res_mlp_int8(torch.randn(4, 5, C), x, w)
    with pytest.raises(ValueError, match="must match"):
        mlp_int8_cuda.fused_attnout_res_mlp_int8(x.bfloat16(), x, w)
    with pytest.raises(ValueError, match="K8 takes"):
        mlp_int8_cuda.fused_ln_qkv_int8(torch.randn(4, 5, 2 * C, device=dev), w.qkv)


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


def _corr_operands(g, dev, B, T, Hh, W, NP, edge=3.0):
    """K4's operands: unit features and support, coordinates uniform over the
    level widened by `edge` pixels on each side (windows at the map's edge)."""
    fm = torch.nn.functional.normalize(torch.randn(B, T, Hh, W, 128, generator=g), dim=-1)
    fmq = corr_cuda.build_int8_level(fm.to(dev, torch.bfloat16), 3)
    sup = torch.nn.functional.normalize(torch.randn(B, 49, NP // B, 128, generator=g), dim=-1)
    supq, _ = corr_cuda.quantize_support(sup.to(dev, torch.bfloat16), torch.bfloat16)
    coords = (torch.rand(B, T, NP // B, 2, generator=g) * torch.tensor([W + 2 * edge, Hh + 2 * edge])
              - edge)
    starts, wxy = corr_cuda.level_operands(coords.to(dev, torch.bfloat16), B, T, Hh, W, 3)
    return fmq, supq.reshape(NP, 49, 128), starts, wxy


@pytest.mark.parametrize("NP", [37, 256])
@pytest.mark.parametrize("T", [2, 3, 16, 60, 250])
def test_corr_volume_frames(dev, T, NP):
    """K4 on every route of k4_plan, codes and scales bit-identical to the
    plain version: one pass with the volume held on chip (T=2 and the odd
    T=3, padded to 4 frames, in one block a point; 16 in a cluster of 2; 60
    in a cluster of 8, whose blocks take 7 or 8 frames) and two passes (250
    frames, a cluster of 8); 37 points fill no cluster of the grid's point
    tiles, and a quarter of the windows touch the map's edge. The plan's
    shared-memory bytes are the kernel's."""
    g = torch.Generator().manual_seed(T + NP)
    fmq, supq, starts, wxy = _corr_operands(g, dev, 1, T, 24, 32, NP, edge=4.0)
    Tp = starts.shape[1]
    plan = corr_cuda.k4_plan(NP, Tp)
    assert plan.hold == (Tp <= 64) and plan.smem == corr_cuda._bound("ct_k4_smem")()
    n = corr_cuda.corr_volume_int8.launches
    vol, scale = corr_cuda.corr_volume_int8(fmq, supq, starts, wxy)
    torch.cuda.synchronize()
    assert corr_cuda.corr_volume_int8.launches == n + 1
    rvol, rscale = corr_cuda.corr_volume_plain(fmq, supq, starts, wxy)
    assert torch.equal(scale, rscale)
    assert torch.equal(vol, rvol)
    assert vol.abs().amax(dim=(1, 2, 3)).eq(127).all()


def test_corr_volume_raises_instead_of_falling_back(dev):
    g = torch.Generator().manual_seed(0)
    fmq, supq, starts, wxy = _corr_operands(g, dev, 1, 4, 24, 32, 8)
    n = corr_cuda.corr_volume_int8.launches
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.corr_volume_int8(fmq, supq, starts, wxy.cpu())
    with pytest.raises(TypeError, match="K4"):
        corr_cuda.corr_volume_int8(fmq.float(), supq.float(), starts, wxy)
    assert corr_cuda.corr_volume_int8.launches == n


def _raw_operands(g, dev, B, T, Hh, W, NP):
    fm = torch.nn.functional.normalize(torch.randn(B, T, Hh, W, 128, generator=g), dim=-1)
    sup = torch.nn.functional.normalize(torch.randn(NP, 49, 128, generator=g), dim=-1)
    coords = (torch.rand(B, T, NP // B, 2, generator=g) * torch.tensor([W + 6.0, Hh + 6.0]) - 3)
    starts, _ = corr_cuda.level_operands(coords.to(dev), B, T, Hh, W, 3)
    return fm.to(dev), sup.to(dev), starts


@pytest.mark.parametrize("B,NP", [(2, 40), (1, 37)])
@pytest.mark.parametrize("T", [1, 5, 16, 60, 80])
def test_corr_volume_raw(dev, T, B, NP):
    """K4r (K4's cluster kernel in its K4r mode) on every route of k4_plan,
    codes and scales bit-identical to the plain version, one device launch:
    held on chip (T = 1 and 5, padded to 2 and 6 frames, in one block a
    point; 16 in a cluster of 2; 60 in a cluster of 8) and two passes (80
    frames); 37 points fill no whole wave of clusters."""
    g = torch.Generator().manual_seed(30 + T + NP)
    fm, sup, starts = _raw_operands(g, dev, B, T, 24, 32, NP)
    fmq = corr_cuda.build_int8_level(fm, 3)
    supq = torch.round(sup * 127.0).to(torch.int8)
    assert corr_cuda.k4_plan(NP, starts.shape[1]).hold == (starts.shape[1] <= 64)
    n = corr_cuda.corr_volume_raw_int8.launches
    vol, scale = corr_cuda.corr_volume_raw_int8(fmq, supq, starts)
    torch.cuda.synchronize()
    assert corr_cuda.corr_volume_raw_int8.launches == n + 1
    rvol, rscale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
    assert torch.equal(scale, rscale)
    assert torch.equal(vol, rvol)
    assert vol.abs().amax(dim=(1, 2, 3)).eq(127).all()
    assert device_launches(lambda: corr_cuda.corr_volume_raw_int8(fmq, supq, starts)) == 1


@pytest.mark.parametrize("T", [16, 80])
def test_corr_volume_raw_zero_support(dev, T):
    """A point whose support is all zero: its raw volume is 0, so its scale
    is the 1e-20 floor (times 1/127) and its codes all 0, on both routes;
    the other points keep theirs."""
    g = torch.Generator().manual_seed(70 + T)
    fm, sup, starts = _raw_operands(g, dev, 2, T, 24, 32, 40)
    fmq = corr_cuda.build_int8_level(fm, 3)
    supq = torch.round(sup * 127.0).to(torch.int8)
    supq[3] = 0
    vol, scale = corr_cuda.corr_volume_raw_int8(fmq, supq, starts)
    rvol, rscale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
    assert torch.equal(scale, rscale) and torch.equal(vol, rvol)
    floor = torch.tensor(1e-20, dtype=torch.float32) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    assert scale[3].item() == floor.item() and not vol[3].any()
    assert vol[4].abs().amax().item() == 127


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [5, 16, 60])
def test_corr_volume_float(dev, dtype, T):
    """K4f (k4f_plan's persistent tasks: 3xTF32 tensor cores in f32, FMAs in
    k order in bf16) at a small level and at level 0 of the 384x512 input
    (96 x 128) with T = 60; one device launch; the kernel's shared memory
    fits one block an SM."""
    g = torch.Generator().manual_seed(40 + T)
    Hh, W = (96, 128) if T == 60 else (24, 32)
    fm, sup, starts = _raw_operands(g, dev, 2, T, Hh, W, 40)
    level, sup = corr_cuda.build_float_level(fm, 3, dtype), sup.to(dtype)
    n = corr_cuda.corr_volume_float.launches
    vol = corr_cuda.corr_volume_float(level, sup, starts)
    torch.cuda.synchronize()
    assert corr_cuda.corr_volume_float.launches == n + 1 and vol.dtype == dtype
    ref = corr_cuda.corr_volume_float_plain(level, sup, starts)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-8
    assert (vol.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()
    assert device_launches(lambda: corr_cuda.corr_volume_float(level, sup, starts)) == 1
    smem = corr_cuda._bound("ct_k4f_smem", ctypes.c_int)(int(dtype == torch.bfloat16))
    assert 0 < smem <= mlp_int8_cuda.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,blocks", [(1, 1), (3, 5), (4, 2), (7, 300), (16, 1000)])
def test_corr_volume_float_tasks(dev, dtype, group, blocks):
    """K4f on other tilings than the default: one-frame and odd frame groups
    (a step with one frame), few blocks walking many tasks across points,
    as many blocks as tasks; every element within the float tolerance of
    the plain version."""
    g = torch.Generator().manual_seed(group)
    fm, sup, starts = _raw_operands(g, dev, 2, 13, 24, 32, 38)
    level = corr_cuda.build_float_level(fm, 3, dtype)
    NP, Tp, _ = starts.shape
    p = corr_cuda.k4f_plan(NP, Tp, dtype, group=group)
    vol = corr_cuda._k4f_launch(level, sup.to(dtype), starts, p._replace(blocks=min(blocks, p.tasks)))
    ref = corr_cuda.corr_volume_float_plain(level, sup.to(dtype), starts)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-8
    assert (vol.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()


@pytest.mark.parametrize("quant_int8", [False, True])
def test_trainable_corr_on_card(dev, quant_int8):
    """The autograd wrapper on the card: forward within the int8 step (K4r)
    or float32 noise (K4f) of the plain featurizer, gradients equal to
    plain autograd up to the order of the backward's atomic scatter-adds
    (1e-5 of each gradient's largest)."""
    g = torch.Generator().manual_seed(7)
    B, T, N, Hh, W = 1, 6, 37, 24, 32
    fm = torch.nn.functional.normalize(torch.randn(B, T, Hh, W, 128, generator=g), dim=-1)
    sup = torch.nn.functional.normalize(torch.randn(B, N, 49, 128, generator=g), dim=-1)
    coords = torch.rand(B, T, N, 2, generator=g) * torch.tensor([W + 4.0, Hh + 4.0]) - 2
    w = [torch.randn(2401, 64, generator=g) * 0.02, torch.randn(64, generator=g) * 0.1,
         torch.randn(64, 32, generator=g) * 0.1, torch.randn(32, generator=g) * 0.1]
    inputs = [t.to(dev) for t in (fm, sup, coords, *w)]
    level = (corr_cuda.build_int8_level(inputs[0], 3) if quant_int8
             else corr_cuda.build_float_level(inputs[0], 3, torch.float32))
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    out = corr_cuda.fused_corr_embs_trainable(level, *a, chunk=16, quant_int8=quant_int8)
    ref = fused_corr_embs(*b, chunk=16, track_major=True)
    tol = 1e-2 if quant_int8 else 1e-5
    assert (out - ref).abs().max() <= tol * ref.abs().max()
    ct = torch.randn(out.shape, generator=g).to(dev)
    for x, y in zip(torch.autograd.grad(out, a, ct), torch.autograd.grad(ref, b, ct)):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


def test_raw_volumes_raise_instead_of_falling_back(dev):
    fmq = torch.zeros(2, 24, 24, 128, dtype=torch.int8, device=dev)
    starts = torch.zeros(3, 2, 3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        corr_cuda.corr_volume_raw_int8(fmq, torch.zeros(3, 49, 128, dtype=torch.int8), starts)
    with pytest.raises(TypeError, match="one dtype"):
        corr_cuda.corr_volume_float(fmq.float(), torch.zeros(3, 49, 128, device=dev).half(),
                                    starts)


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
        attention_cuda.fused_points_from_virtual(torch.randn(1, 2, C, device=dev),
                                                 torch.randn(2, 513, 2 * C, device=dev), H, D)


# K6 and K7's tensor-core bodies (bf16) and the first versions (f32) at
# ragged shapes: track counts that fill no tile, one frame, the streaming and
# offline windows; K6 also past one 64-key chunk (its two-pass route)
RAGGED = [(300, 1), (300, 5), (10000, 16), (10000, 60)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,V", [(n, t, 64) for n, t in RAGGED] + [(300, 5, 100), (70, 3, 512)])
def test_points_from_virtual_ragged(dev, dtype, N, T, V):
    g = torch.Generator().manual_seed(N + T + V)
    q = torch.randn(N, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(T, V, 2 * C, generator=g).to(dev, dtype)
    out = attention_cuda.fused_points_from_virtual(q, kv, H, D)
    torch.cuda.synchronize()
    _core_close(out, attention_cuda.p2v_plain(q, kv, H, D), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T", RAGGED)
def test_virtual_from_points_ragged(dev, dtype, N, T):
    g = torch.Generator().manual_seed(N + T + 1)
    q = (0.3 * torch.randn(T, 64, C, generator=g)).to(dev, dtype)
    kv = torch.randn(N, T, 2 * C, generator=g).to(dev, dtype)
    bias = torch.zeros(N, device=dev)
    bias[N - N // 7:] = attention_cuda.NEG_BIG
    out = attention_cuda.fused_virtual_from_points(q, kv, H, D, key_bias=bias)
    torch.cuda.synchronize()
    _core_close(out, attention_cuda.v2p_plain(q, kv, H, D, key_bias=bias), dtype)


@pytest.mark.parametrize("masked", ["tail", "all"])
def test_virtual_from_points_key_splits(dev, masked):
    """K7 at the quasi-dense key count (70,656 padded tracks x 16 frames),
    whose keys several blocks share (the partials' merge): the padded tail
    masked, or every key masked (finite, the plain average of the values,
    across the merge as within a block)."""
    N, T = 70656, 16
    assert attention_cuda.v2p_splits(N, T, 64, H, dev) > 1
    g = torch.Generator().manual_seed(3)
    q = (0.3 * torch.randn(T, 64, C, generator=g)).to(dev, torch.bfloat16)
    kv = torch.randn(N, T, 2 * C, generator=g).to(dev, torch.bfloat16)
    bias = torch.zeros(N, device=dev)
    bias[(70225 if masked == "tail" else 0):] = attention_cuda.NEG_BIG
    out = attention_cuda.fused_virtual_from_points(q, kv, H, D, key_bias=bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    _core_close(out, attention_cuda.v2p_plain(q, kv, H, D, key_bias=bias), torch.bfloat16)
    if masked == "all":
        mean_v = kv[..., C:].float().mean(dim=0)[:, None].expand(T, 64, C)
        assert (out.float() - mean_v).abs().max() <= 2.0**-7 * mean_v.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [520, 640])
def test_time_attention_long(dev, dtype, T):
    """K5 past the 512 frames its short route stages: the long route
    (keys in tiles, two passes) against the plain version."""
    g = torch.Generator().manual_seed(T)
    q = torch.randn(5, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(5, T, 2 * C, generator=g).to(dev, dtype)
    n = attention_cuda.fused_time_attention.launches
    out = attention_cuda.fused_time_attention(q, kv, H, D)
    torch.cuda.synchronize()
    assert attention_cuda.fused_time_attention.launches == n + 1
    _core_close(out, attention_cuda.time_attention_plain(q, kv, H, D), dtype)


# K5 at the edges of its routes (k5_plan): several whole tracks a block up
# to 64 frames, 2-4 key chunks in registers up to 256, two passes up to 512,
# the long route past it; small and odd track counts
K5_FRAMES = [1, 15, 16, 17, 60, 64, 65, 250, 512, 513, 640]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 37])
@pytest.mark.parametrize("T", K5_FRAMES)
def test_time_attention_frames(dev, dtype, M, T):
    g = torch.Generator().manual_seed(1000 * M + T)
    q = torch.randn(M, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(M, T, 2 * C, generator=g).to(dev, dtype)
    n = attention_cuda.fused_time_attention.launches
    out = attention_cuda.fused_time_attention(q, kv, H, D)
    torch.cuda.synchronize()
    assert attention_cuda.fused_time_attention.launches == n + 1
    _core_close(out, attention_cuda.time_attention_plain(q, kv, H, D), dtype)


def _k1_close(out, ref):
    """K1's band (chip_smoke): median |err| within 1% of mean |ref|, max
    within 5% of max |ref| (W8A8 code ties spread along a row)."""
    err = (out.float() - ref.float()).abs()
    assert err.median().item() <= 0.01 * ref.float().abs().mean().item()
    assert err.max().item() <= 0.05 * ref.float().abs().max().item()


def _k1_bands(out, x, w, **kw):
    """K1 in bf16 against time_block_plain: chip_smoke's band and the W8A8
    band (_close). The latter's share of elements past its tight bound grows
    with T for any order of the attention sums but the plain version's: the
    launch chain K1 ran before (kept as the f32 route) reads 1.3-2.3% at
    T >= 96 on these inputs, and the tensor cores' accumulation adds ~0.2
    points. So the share may reach the chain's, on the same inputs, plus
    0.5 points where that exceeds the band's 2%."""
    ref = mlp_int8_cuda.time_block_plain(x, w, H, D, **kw)
    chain = mlp_int8_cuda._time_block_chain(x, w, H, D, 1e-6, kw.get("bf16_ln", False),
                                            kw.get("gelu_fold", False))
    _k1_close(out, ref)
    _close(out, ref, torch.bfloat16,
           share=max(0.02, _beyond_tight(chain, ref, torch.bfloat16) + 0.005))


@pytest.mark.parametrize("variants", [False, True])
@pytest.mark.parametrize("M", [64, 37, 10240])
@pytest.mark.parametrize("T", [8, 16, 24, 60, 96, 128, 192])
def test_time_block_frames(dev, T, M, variants):
    """K1 in bf16 (two launches of ct_k1_time_block) at every route of
    k1_plan the frame gate reaches: several whole tracks a 64-row tile up to
    64 frames, one track a block above (key chunks in registers up to 128,
    in two passes to 192); 37 tracks fill no tile; bf16_ln and gelu_fold
    both off or both on. The plan's shared-memory bytes are the kernel's."""
    g = torch.Generator().manual_seed(T + M)
    w = _time_pack(g, dev)
    x = torch.randn(M, T, C, generator=g).to(dev, torch.bfloat16)
    kw = dict(bf16_ln=variants, gelu_fold=variants)
    plan = mlp_int8_cuda.k1_plan(M, T)
    smem = mlp_int8_cuda._lib()["k1_smem"]
    assert (plan.front_smem, plan.tail_smem) == (smem(plan.nc, plan.rows_pad, 0),
                                                 smem(plan.nc, plan.rows_pad, 1))
    n = mlp_int8_cuda.fused_time_block_int8.launches
    out = mlp_int8_cuda.fused_time_block_int8(x, w, H, D, **kw)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_time_block_int8.launches == n + 1
    _k1_bands(out, x, w, **kw)


def test_time_block_raises_past_its_frames(dev):
    """K1 in bf16 holds a track's rows on chip up to K1_MAX_T frames (the
    frame gate sends at most 192): one frame more raises, and launches
    nothing."""
    g = torch.Generator().manual_seed(0)
    w = _time_pack(g, dev)
    x = torch.randn(2, mlp_int8_cuda.K1_MAX_T + 1, C, generator=g).to(dev, torch.bfloat16)
    n = mlp_int8_cuda.fused_time_block_int8.launches
    with pytest.raises(ValueError, match="frames"):
        mlp_int8_cuda.fused_time_block_int8(x, w, H, D)
    assert mlp_int8_cuda.fused_time_block_int8.launches == n


def test_gelu_scale_shortcut_holds(dev):
    """K1's tail takes a row's GELU-code scale from gelu(max pre-GELU value)
    where that exceeds GELU_NEG_BOUND: exact only while gelu_tanh, as the
    kernels evaluate it, never falls on x >= 0 and stays under the bound in
    magnitude on x < 0. Checked over every f32 on the card."""
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    negmax = torch.zeros(1, dtype=torch.int32, device=dev)
    assert mlp_int8_cuda._lib()["k1_gelu_check"](
        bad.data_ptr(), negmax.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert bad.item() == 0
    assert 0.17 < negmax.view(torch.float32).item() < mlp_int8_cuda.GELU_NEG_BOUND


@pytest.mark.parametrize("T", [16, 60, 128])
def test_time_block_negative_gelu(dev, T):
    """K1 with every pre-GELU value negative and the fold off: the tail's
    one-GELU-a-row scale does not hold there, so every row takes the full
    max of |gelu| (pass 1b)."""
    g = torch.Generator().manual_seed(5)
    w = _fold_pack(g, dev)
    x = torch.randn(40, T, C, generator=g).to(dev, torch.bfloat16)
    _k1_bands(mlp_int8_cuda.fused_time_block_int8(x, w, H, D), x, w)


def test_chain_cores_at_width(dev):
    """The K2 and K3 chains (float32's routes; K2's also past the 64 virtual
    tokens its fused front stages), whose attention stages are K6's and
    K7's tensor-core bodies in bf16 (K2's writing f32 for its next
    quantization), at the streaming width: 10,000 tracks x 16 frames, bf16,
    in the W8A8 band."""
    g = torch.Generator().manual_seed(4)
    N, T, V = 10000, 16, 64
    w = mlp_int8_cuda.SpaceBlockWeights(_lin(g, C, C, dev), _lin(g, C, C, dev),
                                        _lin(g, HID, C, dev), _lin(g, C, HID, dev))
    x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
    kv = torch.randn(T, V, 2 * C, generator=g).to(dev, torch.bfloat16)
    _close(mlp_int8_cuda._space_block_chain(x, kv, w, H, D, 1e-6, False, False),
           mlp_int8_cuda.space_block_plain(x, kv, w, H, D), torch.bfloat16)
    wkv = _lin(g, 2 * C, C, dev)
    q = (torch.randn(T, V, C, generator=g) * 0.3).to(dev, torch.bfloat16)
    gamma = (1 + 0.2 * torch.randn(C, generator=g)).to(dev)
    beta = (0.1 * torch.randn(C, generator=g)).to(dev)
    bias = torch.zeros(N, device=dev)
    bias[9000:] = attention_cuda.NEG_BIG
    args = (q, x, wkv, gamma, beta, H, D, bias)
    _close(attention_cuda._v2p_proj_chain(*args, 1e-5), attention_cuda.v2p_proj_plain(*args),
           torch.bfloat16)


def _chain_bands(out, ref, chain):
    """A fused W8A8 body in bf16 against its plain version: chip_smoke's band
    (_k1_close) and the W8A8 band (_close), whose share of elements past its
    tight bound may reach the launch chain's on the same inputs plus 0.5
    points (see _k1_bands)."""
    _k1_close(out, ref)
    _close(out, ref, torch.bfloat16,
           share=max(0.02, _beyond_tight(chain, ref, torch.bfloat16) + 0.005))


def _space_pack(g, dev, fold=False):
    """K2's weights: to_q as the time pack's q rows; with `fold` the fc1
    that leaves every pre-GELU value negative (_fold_pack)."""
    w = _fold_pack(g, dev) if fold else _time_pack(g, dev)
    q = mlp_int8_cuda.QLinear(w.qkv.w[:C].contiguous(), w.qkv.s[:C].contiguous(),
                              w.qkv.b[:C].contiguous())
    return mlp_int8_cuda.SpaceBlockWeights(q, w.out, w.fc1, w.fc2)


# K2 and K3: ragged track counts (37: one partial tile; 300: four whole
# tiles and one partial) at every frame count from one frame to the long
# forward's 250, and the main paths' 10,240 tracks
K2_SHAPES = [(N, T) for T in (1, 5, 16, 60, 250) for N in (37, 300)] + [(10240, 16), (10240, 60)]


@pytest.mark.parametrize("mode", ["off", "bf16_ln", "gelu_fold", "negative_gelu"])
@pytest.mark.parametrize("N,T", K2_SHAPES)
def test_space_block_frames(dev, N, T, mode):
    """K2 in bf16 is two device launches of ct_k2_space_block: the front
    (a block walks a run of 64-track tiles frame after frame, staging each
    frame's keys and values as it enters it), then K1's tail. Each variant
    mode, and the fold's weights with the fold off (every row's GELU-code
    scale from the full |gelu| max); the plan's route and shared memory
    are the kernel's."""
    g = torch.Generator().manual_seed(N + T)
    w = _space_pack(g, dev, fold=mode in ("gelu_fold", "negative_gelu"))
    x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
    kv = torch.randn(T, 64, 2 * C, generator=g).to(dev, torch.bfloat16)
    kw = {mode: True} if mode in ("bf16_ln", "gelu_fold") else {}
    plan = mlp_int8_cuda.k2_plan(N, T, 64, torch.bfloat16,
                                 sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    smem = mlp_int8_cuda._lib()["k2_smem"]
    assert plan.route == "fused" and (plan.front_smem, plan.tail_smem) == (smem(0), smem(1))
    fn = lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, w, H, D, **kw)  # noqa: E731
    n = mlp_int8_cuda.fused_space_block_int8.launches
    out = fn()
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_space_block_int8.launches == n + 1
    assert device_launches(fn) == 2
    chain = mlp_int8_cuda._space_block_chain(x, kv, w, H, D, 1e-6, kw.get("bf16_ln", False),
                                             kw.get("gelu_fold", False))
    _chain_bands(out, mlp_int8_cuda.space_block_plain(x, kv, w, H, D, **kw), chain)


@pytest.mark.parametrize("mask", ["tail", "all"])
@pytest.mark.parametrize("N,T", [(37, 1), (37, 16), (1000, 1), (1000, 16), (1000, 60),
                                 (10240, 1), (10240, 16), (10240, 60)])
def test_v2p_proj_frames(dev, N, T, mask):
    """K3 in bf16 is ct_k3_v2p_proj: LN + the k|v product + the flash step
    in one kernel (the (N*T, 768) kv never in device memory), and K7's merge
    where k3_plan keeps several key ranges: at most two device launches.
    Ragged key tiles (37, 1,000 points), the last eighth of the keys masked,
    and every key masked (finite: the plain average of the values); the
    bands of test_space_block_frames against the chain."""
    g = torch.Generator().manual_seed(7 * N + T)
    wkv = _lin(g, 2 * C, C, dev)
    q = (torch.randn(T, 64, C, generator=g) * 0.3).to(dev, torch.bfloat16)
    x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
    gamma = (1 + 0.2 * torch.randn(C, generator=g)).to(dev)
    beta = (0.1 * torch.randn(C, generator=g)).to(dev)
    bias = torch.zeros(N, device=dev)
    bias[(N - N // 8 if mask == "tail" else 0):] = attention_cuda.NEG_BIG
    args = (q, x, wkv, gamma, beta, H, D, bias)
    plan = attention_cuda.k3_plan(N, T, 64, torch.bfloat16,
                                  sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.route == "fused"
    assert plan.smem == attention_cuda._proj_lib()["k3_smem"](plan.heads)
    fn = lambda: attention_cuda.fused_virtual_from_points_proj(*args)  # noqa: E731
    n = attention_cuda.fused_virtual_from_points_proj.launches
    out = fn()
    torch.cuda.synchronize()
    assert attention_cuda.fused_virtual_from_points_proj.launches == n + 1
    assert device_launches(fn) == (1 if plan.splits == 1 else 2)
    assert torch.isfinite(out.float()).all()
    _chain_bands(out, attention_cuda.v2p_proj_plain(*args),
                 attention_cuda._v2p_proj_chain(*args, 1e-5))


def test_float32_space_and_proj_keep_the_chains(dev):
    """float32 tokens (and K2 past the 64 virtual tokens its front stages)
    take the launch chains, chosen up front by k2_plan / k3_plan: the chain's
    device launches and its numbers, bit for bit."""
    g = torch.Generator().manual_seed(6)
    N, T = 300, 5
    w = _space_pack(g, dev)
    wkv = _lin(g, 2 * C, C, dev)
    gamma = (1 + 0.2 * torch.randn(C, generator=g)).to(dev)
    beta = (0.1 * torch.randn(C, generator=g)).to(dev)
    bias = torch.zeros(N, device=dev)
    for dtype, V in ((torch.float32, 64), (torch.bfloat16, 65)):
        x = torch.randn(N, T, C, generator=g).to(dev, dtype)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, dtype)
        assert mlp_int8_cuda.k2_plan(N, T, V, dtype).route == "chain"
        fn = lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, w, H, D)  # noqa: E731
        chain = lambda: mlp_int8_cuda._space_block_chain(x, kv, w, H, D, 1e-6, False, False)  # noqa: E731
        assert torch.equal(fn(), chain())
        assert device_launches(fn) == device_launches(chain) > 2
    x = torch.randn(N, T, C, generator=g).to(dev)
    q = (torch.randn(T, 64, C, generator=g) * 0.3).to(dev)
    args = (q, x, wkv, gamma, beta, H, D, bias)
    assert attention_cuda.k3_plan(N, T, 64, torch.float32).route == "chain"
    fn = lambda: attention_cuda.fused_virtual_from_points_proj(*args)  # noqa: E731
    chain = lambda: attention_cuda._v2p_proj_chain(*args, 1e-5)  # noqa: E731
    assert torch.equal(fn(), chain())
    assert device_launches(fn) == device_launches(chain) > 2


def test_trainable_fuse_mlp1_on_card(dev):
    """The autograd wrapper with fuse_mlp1 (the corr_fuse_mlp1 variant in
    training): the forward launches K4m once per level-chunk and no K4r,
    and equals the same wrapper on the CPU (K4m's plain version, whose rows
    K4m matches exactly) up to the float32 epilogue (GELU, the W2 product:
    1e-4 of the output scale); the gradients equal plain autograd up to the
    order of the backward's atomic scatter-adds (1e-5 of each gradient's
    largest)."""
    g = torch.Generator().manual_seed(8)
    B, T, N, Hh, W = 1, 6, 37, 24, 32
    fm = torch.nn.functional.normalize(torch.randn(B, T, Hh, W, 128, generator=g), dim=-1)
    sup = torch.nn.functional.normalize(torch.randn(B, N, 49, 128, generator=g), dim=-1)
    coords = torch.rand(B, T, N, 2, generator=g) * torch.tensor([W + 4.0, Hh + 4.0]) - 2
    w = [torch.randn(2401, 384, generator=g) * 0.02, torch.randn(384, generator=g) * 0.1,
         torch.randn(384, 32, generator=g) * 0.1, torch.randn(32, generator=g) * 0.1]
    inputs = [t.to(dev) for t in (fm, sup, coords, *w)]
    level = corr_cuda.build_int8_level(inputs[0], 3)
    a = [t.clone().requires_grad_() for t in inputs]
    b = [t.clone().requires_grad_() for t in inputs]
    n4m, n4r = corr_cuda.corr_mlp1_int8.launches, corr_cuda.corr_volume_raw_int8.launches
    out = corr_cuda.fused_corr_embs_trainable(level, *a, chunk=16, fuse_mlp1=True)
    assert corr_cuda.corr_mlp1_int8.launches == n4m + 3
    assert corr_cuda.corr_volume_raw_int8.launches == n4r
    cpu = corr_cuda.fused_corr_embs_trainable(corr_cuda.build_int8_level(fm, 3), fm, sup,
                                              coords, *w, chunk=16, fuse_mlp1=True)
    assert (out.detach().cpu() - cpu).abs().max() <= 1e-4 * cpu.abs().max()
    ref = fused_corr_embs(*b, chunk=16, track_major=True)
    ct = torch.randn(out.shape, generator=g).to(dev)
    for x, y in zip(torch.autograd.grad(out, a, ct), torch.autograd.grad(ref, b, ct)):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


# ------------------------------------------------ K4m, K10, K11, K12, the modes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [5, 16, 24, 60, 80])
def test_corr_mlp1(dev, dtype, T):
    """K4m: the same integer products, combine, codes and epilogue order as
    its plain version, so the code rows, the points' scales and the rows
    match exactly, on every route of its plan: the volume held on chip (T 5
    padded to 6, 16, 24 the training clip, 60) and two passes past 64
    frames (80); 38 points, so no frame count fills whole 128-row MLP1
    tiles, and windows at the map's edge. The first body matches too."""
    g = torch.Generator().manual_seed(T)
    B, Hh, W, NP = 2, 24, 32, 38
    fm = torch.nn.functional.normalize(torch.randn(B, T, Hh, W, 128, generator=g), dim=-1)
    fmq = corr_cuda.build_int8_level(fm.to(dev), 3)
    sup = torch.nn.functional.normalize(torch.randn(B, 49, NP // B, 128, generator=g), dim=-1)
    supq, sscale = corr_cuda.quantize_support(sup.to(dev), dtype)
    coords = (torch.rand(B, T, NP // B, 2, generator=g) * torch.tensor([W + 6.0, Hh + 6.0]) - 3)
    starts, wxy = corr_cuda.level_operands(coords.to(dev), B, T, Hh, W, 3)
    w1 = (0.02 * torch.randn(2401, 384, generator=g)).to(dev)
    b1 = (0.1 * torch.randn(384, generator=g)).to(dev)
    args = (fmq, supq.reshape(NP, 49, 128), starts, wxy, *corr_cuda.quantize_w1_mlp1(w1), b1,
            sscale.reshape(NP), dtype)
    Tp = starts.shape[1]
    assert corr_cuda.k4m_plan(NP, Tp).volume.hold == (Tp <= 64)
    assert corr_cuda._bound("ct_k4m_gemm_smem")() == corr_cuda.K4M_GEMM_SMEM
    n = corr_cuda.corr_mlp1_int8.launches
    out = corr_cuda.corr_mlp1_int8(*args)
    torch.cuda.synchronize()
    assert corr_cuda.corr_mlp1_int8.launches == n + 1
    ref = corr_cuda.corr_mlp1_plain(*args)
    assert out.dtype == dtype and out.shape == ref.shape == (NP, Tp, 384)
    assert torch.equal(out, ref)
    _, codes, gscale = corr_cuda._k4m_launch(*args)
    rcodes, rscale = corr_cuda._mlp1_codes_plain(*args[:4])
    assert torch.equal(gscale, rscale) and torch.equal(codes, rcodes)
    assert torch.equal(corr_cuda._corr_mlp1_first(*args), ref)
    assert device_launches(lambda: corr_cuda.corr_mlp1_int8(*args)) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,V", [(300, 16, 64), (70, 8, 64), (70, 8, 96)])
def test_space_block_allt(dev, dtype, N, T, V):
    """K11 computes K2's function and takes K2's route: bit for bit K2's
    wrapper on the same inputs (a ragged 64-track tile at every shape), in
    bf16 with up to 64 virtual tokens K2's two device launches, in f32 and
    past 64 virtual tokens (96) K2's launch chain; within the W8A8 band of
    space_block_plain. This pins the repair of K11's last residual: its
    first body added r + (y + b2), where the JAX body, K2 and
    space_block_plain add (r + y) + b2."""
    g = torch.Generator().manual_seed(N + T + V)
    w = mlp_int8_cuda.SpaceBlockWeights(_lin(g, C, C, dev), _lin(g, C, C, dev),
                                        _lin(g, HID, C, dev), _lin(g, C, HID, dev))
    x = torch.randn(N, T, C, generator=g).to(dev, dtype)
    kv = torch.randn(T, V, 2 * C, generator=g).to(dev, dtype)
    fn = lambda: mlp_int8_cuda.fused_space_block_allt_int8(x, kv, w, H, D)  # noqa: E731
    n = mlp_int8_cuda.fused_space_block_allt_int8.launches
    n2 = mlp_int8_cuda.fused_space_block_int8.launches
    out = fn()
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_space_block_allt_int8.launches == n + 1
    assert mlp_int8_cuda.fused_space_block_int8.launches == n2
    assert torch.equal(out, mlp_int8_cuda.fused_space_block_int8(x, kv, w, H, D))
    _close(out, mlp_int8_cuda.space_block_plain(x, kv, w, H, D), dtype)
    if dtype == torch.bfloat16 and V <= mlp_int8_cuda.K2_MAX_V:
        assert device_launches(fn) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln,affine,residual", [
    (ln, af, res) for ln in (False, True) for af in (False, True) for res in (False, True)])
def test_ln_dense(dev, dtype, ln, affine, residual):
    g = torch.Generator().manual_seed(1)
    lin = _lin(g, C if residual else 3 * C, C, dev)
    x = torch.randn(136, C, generator=g).to(dev, dtype)  # a ragged 128-row tile
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev) if affine else None
    beta = (0.05 * torch.randn(C, generator=g)).to(dev) if affine else None
    kw = dict(ln=ln, gamma=gamma, beta=beta, residual=residual)
    n = mlp_int8_cuda.fused_ln_dense_int8.launches
    out = mlp_int8_cuda.fused_ln_dense_int8(x, lin, **kw)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_ln_dense_int8.launches == n + 1
    _close(out, mlp_int8_cuda.ln_dense_plain(x, lin, **kw), dtype)


@pytest.mark.parametrize("bf16_ln", [False, True])
@pytest.mark.parametrize("rows", [136, 1000])
@pytest.mark.parametrize("ln,affine,residual,N", [
    (ln, af, res, C if res else 3 * C)
    for ln in (False, True) for af in (False, True) for res in (False, True)] + [
    (ln, af, False, 4 * C) for ln in (False, True) for af in (False, True)])
def test_ln_dense_stream_matches_first_body(dev, ln, affine, residual, N, rows, bf16_ln):
    """K10 in bfloat16 (K8's streamed body on k10_plan's persistent blocks)
    is bit-identical to its first body at the same inputs in every (ln,
    affine, residual) combination: the same LayerNorm, affine and
    quantization device code, exact s8 products, the same epilogue order
    (dequant, bias, x). N = 1,536 takes the body's other branch (the weight
    scales and biases from device memory past 1,152 columns). Ragged row
    counts (136: two tiles, the second of 8 rows; 1,000); one device
    launch a call."""
    g = torch.Generator().manual_seed(rows + 4 * ln + 2 * affine + residual + N)
    lin = _lin(g, N, C, dev)
    x = torch.randn(rows, C, generator=g).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev) if affine else None
    beta = (0.05 * torch.randn(C, generator=g)).to(dev) if affine else None
    kw = dict(ln=ln, gamma=gamma, beta=beta, residual=residual, bf16_ln=bf16_ln)
    plan = mlp_int8_cuda.k10_plan(rows, lin.w.shape[0], x.dtype)
    assert plan.route == "stream" and plan.smem == mlp_int8_cuda._lib()["k8_smem"]()
    n = mlp_int8_cuda.fused_ln_dense_int8.launches
    out = mlp_int8_cuda.fused_ln_dense_int8(x, lin, **kw)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_ln_dense_int8.launches == n + 1
    first = mlp_int8_cuda._ln_dense_first(x, lin, 1e-6, ln, gamma, beta, residual, bf16_ln)
    assert torch.equal(out, first)
    assert device_launches(lambda: mlp_int8_cuda.fused_ln_dense_int8(x, lin, **kw)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln", [True, False])
def test_ln_mlp(dev, dtype, ln):
    g = torch.Generator().manual_seed(2)
    fc1, fc2 = _lin(g, HID, C, dev), _lin(g, C, HID, dev)
    x = torch.randn(3, 40, C, generator=g).to(dev, dtype)  # 120 rows: a ragged 64-row tile
    n = mlp_int8_cuda.fused_ln_mlp_int8.launches
    out = mlp_int8_cuda.fused_ln_mlp_int8(x, fc1, fc2, ln=ln)
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_ln_mlp_int8.launches == n + 1
    _close(out, mlp_int8_cuda.ln_mlp_plain(x, fc1, fc2, ln=ln), dtype)


@pytest.mark.parametrize("rows", [8, 120, 64 * 8 * 3 + 40])
@pytest.mark.parametrize("bf16_ln,gelu_fold", [(False, False), (True, False), (False, True),
                                               (True, True)])
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_mlp_cluster_matches_first_body(dev, dtype, ln, bf16_ln, gelu_fold, rows):
    """K12 (8-block clusters, resident weights, one fc1 pass) is bit-identical
    to its first body (one block a 64-row tile, fc1 twice): the same LN,
    GELU and epilogue device code, exact s8 products, an order-free row
    max. Row counts: one tile with most clusters idle (8), a ragged last
    tile (120), several tiles a cluster (1,576: 25 tiles; and again on 3
    clusters, 8-9 tiles each). One device launch a call; the plan's shared
    memory is the kernel's; within the W8A8 band of ln_mlp_plain, taken on
    the CPU (torch._int_mm on the card takes more than 16 rows)."""
    g = torch.Generator().manual_seed(rows + 2 * ln + bf16_ln)
    fc1, fc2 = _lin(g, HID, C, dev), _lin(g, C, HID, dev)
    x = torch.randn(rows, C, generator=g).to(dev, dtype)
    kw = dict(ln=ln, bf16_ln=bf16_ln, gelu_fold=gelu_fold)
    fn = lambda: mlp_int8_cuda.fused_ln_mlp_int8(x, fc1, fc2, **kw)  # noqa: E731
    n = mlp_int8_cuda.fused_ln_mlp_int8.launches
    out = fn()
    torch.cuda.synchronize()
    assert mlp_int8_cuda.fused_ln_mlp_int8.launches == n + 1
    first = mlp_int8_cuda._ln_mlp_first(x, fc1, fc2, 1e-6, ln, bf16_ln, gelu_fold)
    assert torch.equal(out, first)
    few = mlp_int8_cuda._ln_mlp_cluster(x, fc1, fc2, 1e-6, ln, bf16_ln, gelu_fold,
                                        mlp_int8_cuda.k12_plan(rows, 3))
    assert torch.equal(few, first)
    cpu = [mlp_int8_cuda.QLinear(*(t.cpu() for t in lin)) for lin in (fc1, fc2)]
    _close(out.cpu(), mlp_int8_cuda.ln_mlp_plain(x.cpu(), *cpu, **kw), dtype)
    assert device_launches(fn) == 1
    assert mlp_int8_cuda._lib()["k12_smem"]() == mlp_int8_cuda.K12_SMEM
    assert mlp_int8_cuda._k12_max_clusters(dev) >= 1


def _fold_pack(g, dev):
    """fc1 leaving every pre-GELU value negative: the fold's scale then
    differs from the absmax one on every row."""
    w = _time_pack(g, dev)
    w1 = 0.3 * torch.randn(HID, C, generator=g) / C**0.5
    fc1 = mlp_int8_cuda.quantize_linear(w1.to(dev), (-3.0 + 0.05 * torch.randn(HID, generator=g)).to(dev))
    return w._replace(fc1=fc1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bf16_ln", "gelu_fold"])
@pytest.mark.parametrize("name", ["K1", "K2", "K8", "K9", "K10", "K11", "K12"])
def test_w8a8_modes(dev, name, mode, dtype):
    g = torch.Generator().manual_seed(3)
    w = _fold_pack(g, dev) if mode == "gelu_fold" else _time_pack(g, dev)
    sw = mlp_int8_cuda.SpaceBlockWeights(
        mlp_int8_cuda.QLinear(w.qkv.w[:C].contiguous(), w.qkv.s[:C].contiguous(),
                              w.qkv.b[:C].contiguous()), w.out, w.fc1, w.fc2)
    x = torch.randn(70, 16, C, generator=g).to(dev, dtype)
    a = torch.randn(70, 16, C, generator=g).to(dev, dtype)
    kv = torch.randn(16, 64, 2 * C, generator=g).to(dev, dtype)
    kw = {mode: True}
    lnkw = {"bf16_ln": True} if mode == "bf16_ln" else {}
    m = mlp_int8_cuda
    kern, plain = {
        "K1": (lambda: m.fused_time_block_int8(x, w, H, D, **kw),
               lambda: m.time_block_plain(x, w, H, D, **kw)),
        "K2": (lambda: m.fused_space_block_int8(x, kv, sw, H, D, **kw),
               lambda: m.space_block_plain(x, kv, sw, H, D, **kw)),
        "K8": (lambda: torch.cat(m.fused_ln_qkv_int8(x, w.qkv, **lnkw), -1),
               lambda: torch.cat(m.ln_qkv_plain(x, w.qkv, **lnkw), -1)),
        "K9": (lambda: m.fused_attnout_res_mlp_int8(a, x, w, **kw),
               lambda: m.attnout_mlp_plain(a, x, w, **kw)),
        "K10": (lambda: m.fused_ln_dense_int8(x, w.qkv, ln=True, **lnkw),
                lambda: m.ln_dense_plain(x, w.qkv, ln=True, **lnkw)),
        "K11": (lambda: m.fused_space_block_allt_int8(x, kv, sw, H, D, **kw),
                lambda: m.space_block_plain(x, kv, sw, H, D, **kw)),
        "K12": (lambda: m.fused_ln_mlp_int8(x, w.fc1, w.fc2, **kw),
                lambda: m.ln_mlp_plain(x, w.fc1, w.fc2, **kw)),
    }[name]
    out = kern()
    torch.cuda.synchronize()
    _close(out, plain(), dtype)


def test_variant_kernels_raise_instead_of_falling_back(dev):
    g = torch.Generator().manual_seed(4)
    w = _time_pack(g, dev)
    sw = mlp_int8_cuda.SpaceBlockWeights(w.out, w.out, w.fc1, w.fc2)
    x = torch.randn(8, 16, C, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_int8_cuda.fused_space_block_allt_int8(x, torch.randn(16, 64, 2 * C), sw, H, D)
    with pytest.raises(ValueError, match="K11 takes"):
        mlp_int8_cuda.fused_space_block_allt_int8(x, torch.randn(16, 200, 2 * C, device=dev),
                                                  sw, H, D)
    with pytest.raises(ValueError, match="K12 takes"):
        mlp_int8_cuda.fused_ln_mlp_int8(x, w.fc1, _lin(g, C, 2 * HID, dev))
    with pytest.raises(ValueError, match="K10 takes"):
        mlp_int8_cuda.fused_ln_dense_int8(torch.randn(8, 2 * C, device=dev), _lin(g, C, 2 * C, dev))
