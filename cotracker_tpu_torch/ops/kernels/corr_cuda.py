"""K4, K4r, K4f, K4m: the correlation kernels, and the plain PyTorch
around them (port of cotracker_tpu/ops/kernels/corr_pallas.py).

K4 is the inference fast path (quant_int8 + fuse_combine:
`_corr_level_plan.hidden` and `fused_corr_tokens_pallas`):

Per pyramid level and chunk of points, `corr_volume_int8` (the kernel,
csrc/corr_window.cu, on `k4_plan`'s tiling: a thread-block cluster a point)
emits each point's bilinearly combined correlation volume as int8 codes
with one f32 scale per point; the epilogue here applies
the first correlation-MLP layer as an s8 x s8 -> s32 product with a
zero-padded, per-output-channel int8 W1 (`torch._int_mm`: exact integer
results, as XLA's s8 dot in the JAX package), dequantizes, adds the bias and
applies the exact-erf GELU. The folded second layer and the small token
terms are accumulated per chunk, so per-level embeddings never exist at full N.

K4m is the `corr_fuse_mlp1` variant (corr_pallas.py `fuse_mlp1`,
COTRACKER_CORR_FUSE_MLP1): `corr_mlp1_int8` runs the combine, a per-point
quantization whose scale comes from the RAW volume, and the s8 MLP1 + b1 in
two launches on `k4m_plan` (K4's cluster kernel in its K4m mode writes each
frame's code row of the 2,401 real taps, then a 128-row MLP1 kernel) and
emits pre-GELU hidden rows in the compute dtype; only the exact-erf GELU and
what follows stay outside. Its W1 is quantized from
the float32 weights (`quantize_w1_mlp1`), K4's from the compute dtype, and
its bias is added in float32 before the rounding, K4's after it: in bf16
the two are different functions, as in the JAX package. Both the fold path
(`fused_corr_tokens(..., w1m=...)`) and the per-level path
(`fused_corr_embs_kernel(..., fuse_mlp1=True)`) take it; it requires the
int8 correlation.

K4r and K4f emit the RAW window volume (no combine): K4r as int8 codes with
a per-point scale over the raw volume (quant_int8), K4f in the compute
dtype. `fused_corr_embs_kernel` runs either per level with the XLA epilogue
of `fused_corr_embs_pallas` (combine, MLP1, exact GELU, fc2), and
`fused_corr_embs_trainable` wraps it in an autograd Function whose backward
is the plain `fused_corr_embs` (port of `fused_corr_embs_pallas_trainable`):
the training path.

The JAX kernel's eight x-shifted copies of the map are TPU DMA alignment
work: the port pads (and quantizes) each level once per forward.
"""

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cotracker_tpu_torch.ops.corr import (
    edge_pad_index, fused_corr_embs, pad_fmaps, window_starts_and_weights,
)
from cotracker_tpu_torch.ops.kernels import _build

F32 = torch.float32
WIN = 8
S = 49


def build_int8_level(fmaps, radius: int):
    """(B, T, H, W, C) level map -> (B*T, H+2p, W+2p, C) edge-padded int8
    codes clip(rint(f * 128), -127, 127), p = 2*radius + 2."""
    B, T, H, W, C = fmaps.shape
    pad = 2 * radius + 2
    iy = edge_pad_index(H, pad, fmaps.device)
    ix = edge_pad_index(W, pad, fmaps.device)
    padded = fmaps[:, :, iy][:, :, :, ix].to(F32)
    q = torch.round(padded * 128.0).clamp(-127.0, 127.0).to(torch.int8)
    return q.reshape(B * T, H + 2 * pad, W + 2 * pad, C).contiguous()


def build_float_level(fmaps, radius: int, dtype):
    """(B, T, H, W, C) level map -> (B*T, H+2p, W+2p, C) edge-padded in
    `dtype`, p = 2*radius + 2: the K4f operand."""
    B, T, H, W, C = fmaps.shape
    pad = 2 * radius + 2
    return pad_fmaps(fmaps, radius).to(dtype).reshape(B * T, H + 2 * pad, W + 2 * pad, C).contiguous()


def quantize_support(support, dtype):
    """(B, P*P, N, C) support -> ((B, N, P*P, C) int8 codes, (B, N) f32 scale
    amax/127/128); the 1/128 of the window codes rides the support scale."""
    snt = support.transpose(1, 2).to(dtype)
    amax = snt.abs().amax(dim=(2, 3)).to(F32).clamp_min(1e-20)
    sq = torch.round(snt.to(F32) * (127.0 / amax[..., None, None])).to(torch.int8)
    return sq.contiguous(), amax * (1.0 / 127.0 / 128.0)


def quantize_w1(w1, compute_dtype):
    """Corr-MLP W1 (P^4, Dh), rows d = i_x*P*S + j_y*S + s -> the epilogue's
    per-output-channel int8 matrix over the volume's (y, x, s) flatten of the
    8x8 window, zero at x == 7 and y == 7, stored (Dh, 64*S); and its f32
    channel absmax (Dh,)."""
    P = int(round(math.sqrt(math.sqrt(w1.shape[0]))))
    Dh = w1.shape[1]
    w1r = w1.detach().reshape(P, P, S, Dh).to(compute_dtype).to(F32)  # (x, y, s, k)
    w1p = torch.zeros((WIN, WIN, S, Dh), dtype=F32, device=w1.device)
    w1p[:P, :P] = w1r.transpose(0, 1)  # (y, x, s, k)
    amax = w1p.abs().amax(dim=(0, 1, 2)).clamp_min(1e-20)
    w1q = torch.round(w1p * (127.0 / amax)).to(torch.int8)
    return w1q.reshape(WIN * WIN * S, Dh).t().contiguous(), amax


def quantize_w1_mlp1(w1):
    """K4m's W1 (corr_pallas.py:518-524): per-output-channel int8 codes of
    the float32 W1 over the 7 x 7 x 49 real taps in (y, x, s) order, stored
    (Dh, 2432) with zero columns past 2,401, and the f32 channel scales
    amax / 127 (Dh,)."""
    w1q, amax = quantize_w1(w1, F32)
    Dh = w1q.shape[0]
    P = 7
    w1c = w1q.reshape(Dh, WIN, WIN, S)[:, :P, :P].reshape(Dh, P * P * S)
    return F.pad(w1c, (0, KM - P * P * S)).contiguous(), amax * (1.0 / 127.0)


KM = 2432  # K4m's padded MLP1 depth: 2,401 taps in whole 64-byte slices


# ------------------------------------------------------------ the kernel


def _window_products(fm, sup, starts):
    """g (NP, Tp*64, 49) in f32: every frame's 8x8 window of `fm` (F, Hp, Wp,
    C) at starts (NP, Tp, 3) int32 (frame, wsy, wsx) against sup (NP, 49, C),
    rows in (t, y, x) order."""
    NP, Tp, _ = starts.shape
    C = fm.shape[-1]
    d = torch.arange(WIN, device=fm.device)
    f = starts[..., 0].long()[..., None, None]
    yy = (starts[..., 1].long()[..., None] + d)[..., :, None]
    xx = (starts[..., 2].long()[..., None] + d)[..., None, :]
    win = fm[f, yy, xx].reshape(NP, Tp * WIN * WIN, C)
    return torch.bmm(win.to(F32), sup.to(F32).transpose(1, 2))


def corr_volume_plain(fmq, supq, starts, wxy):
    """Plain K4. fmq (F, Hp, Wp, C) int8 level codes; supq (NP, 49, C) int8;
    starts (NP, Tp, 3) int32 (frame, wsy, wsx); wxy (NP, Tp, 2) f32.
    Returns vol (NP, Tp, 64, 49) int8 and scale (NP,) f32."""
    NP, Tp, _ = starts.shape
    # integer products and partial sums stay below 2^24: exact in float32
    g = _window_products(fmq, supq, starts)  # (NP, R, 49)
    g01 = torch.roll(g, -1, dims=1)  # lane r+1 (x+1), wrapping over the slab
    g10 = torch.roll(g, -WIN, dims=1)  # lane r+8 (y+1)
    g11 = torch.roll(g, -WIN - 1, dims=1)
    wx = wxy[..., 0].repeat_interleave(WIN * WIN, dim=1)[..., None]
    wy = wxy[..., 1].repeat_interleave(WIN * WIN, dim=1)[..., None]
    gx = g + wx * (g01 - g)
    gx1 = g10 + wx * (g11 - g10)
    c = gx + wy * (gx1 - gx)
    return _quantize_volume(c, NP, Tp)


def _quantize_volume(c, NP, Tp):
    scale = c.abs().amax(dim=(1, 2)).clamp_min(1e-20) * (1.0 / 127.0)
    q = torch.round(c * (1.0 / scale)[:, None, None]).to(torch.int8)
    return q.reshape(NP, Tp, WIN * WIN, S), scale


def _mlp1_codes_plain(fmq, supq, starts, wxy):
    """K4m's code rows and per-point scale: the combined volume's 7 x 7 x 49
    real taps in (y, x, s) order, rint(c * (1/s)), zero-padded to KM bytes
    (NP * Tp, KM) int8, and s (NP,) f32 from the RAW volume's absmax."""
    NP, Tp, _ = starts.shape
    P = 7
    g = _window_products(fmq, supq, starts)  # (NP, R, 49), exact integers
    s = g.abs().amax(dim=(1, 2)).clamp_min(1e-20) * (1.0 / 127.0)
    g = g.reshape(NP, Tp, WIN, WIN, S)  # (y, x, s)
    wx = wxy[..., 0][:, :, None, None, None]
    wy = wxy[..., 1][:, :, None, None, None]
    gx0 = g[:, :, :P, :P] + wx * (g[:, :, :P, 1:] - g[:, :, :P, :P])
    gx8 = g[:, :, 1:, :P] + wx * (g[:, :, 1:, 1:] - g[:, :, 1:, :P])
    c = gx0 + wy * (gx8 - gx0)
    codes = torch.round(c * (1.0 / s)[:, None, None, None, None]).to(torch.int8)
    return F.pad(codes.reshape(NP * Tp, P * P * S), (0, KM - P * P * S)), s


def corr_mlp1_plain(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype):
    """Plain K4m. Operands as corr_volume_plain; w1c, w1s from
    quantize_w1_mlp1; b1 (Dh,); sup_scale (NP,) the support codes' scale.
    Returns the pre-GELU hidden rows (NP, Tp, Dh) in out_dtype:

        s = max(absmax(raw g over all taps and frames), 1e-20) / 127
        c = lerp_y(lerp_x(g)) over the 7 x 7 real taps; codes rint(c * (1/s))
        out = (codes . W1c * w1s) * (s * sup_scale) + b1"""
    NP, Tp, _ = starts.shape
    codes, s = _mlp1_codes_plain(fmq, supq, starts, wxy)
    h32 = torch._int_mm(codes, w1c.t()).to(F32).reshape(NP, Tp, -1)
    return ((h32 * w1s) * (s * sup_scale)[:, None, None] + b1.to(F32)).to(out_dtype)


def corr_volume_raw_plain(fmq, supq, starts):
    """Plain K4r: the raw volume g of corr_volume_plain's operands (no
    combine) as int8 codes rint(g * (1/scale)), scale = max(absmax(g),
    1e-20)/127 per point. Returns vol (NP, Tp, 64, 49) int8, scale (NP,) f32."""
    NP, Tp, _ = starts.shape
    return _quantize_volume(_window_products(fmq, supq, starts), NP, Tp)


def corr_volume_float_plain(fm, sup, starts):
    """Plain K4f: fm (F, Hp, Wp, C) and sup (NP, 49, C) in one float dtype;
    the raw volume accumulated in f32 and returned in that dtype as
    (NP, Tp, 64, 49)."""
    NP, Tp, _ = starts.shape
    g = _window_products(fm, sup, starts)
    return g.to(fm.dtype).reshape(NP, Tp, WIN * WIN, S)


_fn = {}


def _bound(name, *argtypes):
    if name not in _fn:
        _fn[name] = _build.bind(_build.load("corr_window"), name, *argtypes)
    return _fn[name]


def _check_operands(fm, sup, starts, dtypes, what):
    for t in (fm, sup, starts):
        if t.device.type != "cuda":
            raise ValueError("kernel inputs must all be CUDA tensors")
    if fm.dtype not in dtypes or sup.dtype != fm.dtype or fm.shape[-1] != 128:
        raise TypeError(f"{what} takes level map and support of one dtype in {dtypes} with C = 128")
    if sup.shape[1:] != (S, 128) or starts.shape[0] != sup.shape[0]:
        raise ValueError(f"{what}: support {tuple(sup.shape)}, starts {tuple(starts.shape)}")


class K4Plan(NamedTuple):
    """K4's tiling (csrc/corr_window.cu) for NP points of Tp frames: each
    point's frames split over a thread-block cluster of `cluster` blocks
    (block k takes k4_frames(Tp, cluster, k), at most `frames`); `hold`
    keeps the combined volume of every frame on chip (one pass over the
    windows), else two passes (the absmax, then the codes); shared memory
    of a block in bytes; blocks in the grid."""

    hold: bool
    cluster: int
    frames: int
    smem: int
    blocks: int


K4_REGIONS = 8  # a block's 12,800-byte frame regions: the frames it can hold
K4_MAX_CLUSTER = 8  # the portable cluster size
# support (56 x 128), the regions (64 rows x 50 f32), the maxima (8 f32)
K4_SMEM = 56 * 128 + K4_REGIONS * 64 * 50 * 4 + 32


def k4_frames(Tp: int, cluster: int, rank: int) -> range:
    """The frames block `rank` of a point's cluster takes."""
    return range(rank * Tp // cluster, (rank + 1) * Tp // cluster)


def k4_plan(NP: int, Tp: int) -> K4Plan:
    """K4's tiling (the arithmetic of corr_volume_kernel / ct_corr_volume):
    clusters of ceil(Tp / 8) blocks hold every frame up to 64 frames; past
    that 8 blocks take two passes."""
    if NP < 1 or Tp < 1:
        raise ValueError(f"K4 takes at least one point and one frame, got NP={NP}, Tp={Tp}")
    cluster = min(K4_MAX_CLUSTER, -(-Tp // K4_REGIONS))
    frames = -(-Tp // cluster)
    return K4Plan(frames <= K4_REGIONS, cluster, frames, K4_SMEM, NP * cluster)


def corr_volume_int8(fmq, supq, starts, wxy):
    """K4: per point, the bilinearly combined int8 correlation volume over
    all frames and its scale; see corr_volume_plain for the layouts. One
    launch on k4_plan's tiling."""
    if fmq.device.type == "cpu":
        return corr_volume_plain(fmq, supq, starts, wxy)
    _check_operands(fmq, supq, starts, (torch.int8,), "K4")
    if wxy.device.type != "cuda":
        raise ValueError("kernel inputs must all be CUDA tensors")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _bound("ct_corr_volume", P, P, P, P, P, P, I, I, I, I, I, I, P)
    NP, Tp, _ = starts.shape
    _, Hp, Wp, _ = fmq.shape
    plan = k4_plan(NP, Tp)
    starts, wxy = starts.to(torch.int32).contiguous(), wxy.to(F32).contiguous()
    fmq, supq = fmq.contiguous(), supq.contiguous()
    vol = torch.empty((NP, Tp, WIN * WIN, S), dtype=torch.int8, device=fmq.device)
    scale = torch.empty((NP,), dtype=F32, device=fmq.device)
    _build.check(fn(
        _build.ptr(fmq), _build.ptr(supq), _build.ptr(starts), _build.ptr(wxy),
        _build.ptr(vol), _build.ptr(scale), NP, Tp, Hp, Wp, plan.cluster, int(plan.hold),
        _build.stream_ptr(fmq)), "ct_corr_volume")
    corr_volume_int8.launches += 1
    return vol, scale


corr_volume_int8.launches = 0


class K4mPlan(NamedTuple):
    """K4m's two launches for NP points of Tp frames: K4's cluster kernel in
    its K4m mode on k4_plan's tiling (`volume`), then the MLP1 product on
    `gemm_blocks` blocks of K4M_ROWS code rows (several points' frames),
    `gemm_smem` bytes of shared memory each."""

    volume: K4Plan
    gemm_blocks: int
    gemm_smem: int


K4M_ROWS, K4M_STAGES = 128, 5  # corr_window.cu's kMlpBM and kMlpStages
# the ring: per stage the rows' codes and W1's 384 rows, 64 + 16 bytes each;
# then the rows' scales
K4M_GEMM_SMEM = K4M_STAGES * (K4M_ROWS + 384) * (64 + 16) + K4M_ROWS * 4


def k4m_plan(NP: int, Tp: int) -> K4mPlan:
    """K4m's tiling (the arithmetic of ct_corr_mlp1 and kMlpSmem)."""
    return K4mPlan(k4_plan(NP, Tp), -(-NP * Tp // K4M_ROWS), K4M_GEMM_SMEM)


def _check_mlp1(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype):
    _check_operands(fmq, supq, starts, (torch.int8,), "K4m")
    NP = starts.shape[0]
    Dh = w1c.shape[0]
    for t in (wxy, w1c, w1s, b1, sup_scale):
        if t.device.type != "cuda":
            raise ValueError("kernel inputs must all be CUDA tensors")
    if tuple(w1c.shape) != (Dh, KM) or w1c.dtype != torch.int8 or Dh != 384 \
            or out_dtype not in (F32, torch.bfloat16) or sup_scale.numel() != NP:
        raise ValueError(f"K4m takes W1 codes (384, {KM}) int8, {NP} support scales and a "
                         f"float32 or bfloat16 output; got W1 {tuple(w1c.shape)} {w1c.dtype}")
    f32 = lambda t: t.to(F32).contiguous()  # noqa: E731
    return (fmq.contiguous(), supq.contiguous(), starts.to(torch.int32).contiguous(), f32(wxy),
            w1c.contiguous(), f32(w1s), f32(b1), f32(sup_scale.reshape(NP)))


def _k4m_launch(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype):
    """K4m's two launches on k4m_plan: returns the rows (NP, Tp, 384) and the
    scratch they passed through, the code rows (NP * Tp, KM) int8 and the
    points' scales (NP,)."""
    args = _check_mlp1(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype)
    NP, Tp, _ = starts.shape
    _, Hp, Wp, _ = fmq.shape
    plan = k4m_plan(NP, Tp)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _bound("ct_corr_mlp1", *([P] * 11), I, I, I, I, I, I, I, I, P)
    dev = fmq.device
    out = torch.empty((NP, Tp, 384), dtype=out_dtype, device=dev)
    codes = torch.empty((NP * Tp, KM), dtype=torch.int8, device=dev)
    gscale = torch.empty((NP,), dtype=F32, device=dev)
    _build.check(fn(*map(_build.ptr, args + (codes, gscale, out)),
                    int(out_dtype == torch.bfloat16), NP, Tp, Hp, Wp, 384, plan.volume.cluster,
                    int(plan.volume.hold), _build.stream_ptr(fmq)), "ct_corr_mlp1")
    return out, codes, gscale


def _corr_mlp1_first(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype):
    """K4m's first body (ct_corr_mlp1_first: one block a point, two passes
    over the windows, MLP1 on 16 rows at a time): the yardstick the card
    runs beside K4m; the port calls it nowhere else."""
    args = _check_mlp1(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype)
    NP, Tp, _ = starts.shape
    _, Hp, Wp, _ = fmq.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _bound("ct_corr_mlp1_first", P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P)
    out = torch.empty((NP, Tp, 384), dtype=out_dtype, device=fmq.device)
    _build.check(fn(*map(_build.ptr, args + (out,)), int(out_dtype == torch.bfloat16), NP, Tp, Hp,
                    Wp, 384, _build.stream_ptr(fmq)), "ct_corr_mlp1_first")
    return out


def corr_mlp1_int8(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype):
    """K4m: per point, the combined volume's per-point codes through MLP1
    + b1, as pre-GELU hidden rows (NP, Tp, Dh) in out_dtype; see
    corr_mlp1_plain. Two launches (k4m_plan): the code rows, then MLP1."""
    if fmq.device.type == "cpu":
        return corr_mlp1_plain(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype)
    out = _k4m_launch(fmq, supq, starts, wxy, w1c, w1s, b1, sup_scale, out_dtype)[0]
    corr_mlp1_int8.launches += 1
    return out


corr_mlp1_int8.launches = 0


def corr_volume_raw_int8(fmq, supq, starts):
    """K4r: per point, the raw int8 correlation volume over all frames and
    its scale; see corr_volume_raw_plain."""
    if fmq.device.type == "cpu":
        return corr_volume_raw_plain(fmq, supq, starts)
    _check_operands(fmq, supq, starts, (torch.int8,), "K4r")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _bound("ct_corr_volume_raw", P, P, P, P, P, I, I, I, I, P)
    NP, Tp, _ = starts.shape
    _, Hp, Wp, _ = fmq.shape
    starts = starts.to(torch.int32).contiguous()
    fmq, supq = fmq.contiguous(), supq.contiguous()
    vol = torch.empty((NP, Tp, WIN * WIN, S), dtype=torch.int8, device=fmq.device)
    scale = torch.empty((NP,), dtype=F32, device=fmq.device)
    _build.check(fn(_build.ptr(fmq), _build.ptr(supq), _build.ptr(starts), _build.ptr(vol),
                    _build.ptr(scale), NP, Tp, Hp, Wp, _build.stream_ptr(fmq)),
                 "ct_corr_volume_raw")
    corr_volume_raw_int8.launches += 1
    return vol, scale


corr_volume_raw_int8.launches = 0


def corr_volume_float(fm, sup, starts):
    """K4f: per point, the raw correlation volume over all frames in the
    input dtype (f32 or bf16), accumulated in f32; see corr_volume_float_plain."""
    if fm.device.type == "cpu":
        return corr_volume_float_plain(fm, sup, starts)
    _check_operands(fm, sup, starts, (F32, torch.bfloat16), "K4f")
    P, I = ctypes.c_void_p, ctypes.c_int
    name = "ct_corr_volume_f32" if fm.dtype == F32 else "ct_corr_volume_bf16"
    fn = _bound(name, P, P, P, P, I, I, I, I, P)
    NP, Tp, _ = starts.shape
    _, Hp, Wp, _ = fm.shape
    starts = starts.to(torch.int32).contiguous()
    fm, sup = fm.contiguous(), sup.contiguous()
    vol = torch.empty((NP, Tp, WIN * WIN, S), dtype=fm.dtype, device=fm.device)
    _build.check(fn(_build.ptr(fm), _build.ptr(sup), _build.ptr(starts), _build.ptr(vol),
                    NP, Tp, Hp, Wp, _build.stream_ptr(fm)), name)
    corr_volume_float.launches += 1
    return vol


corr_volume_float.launches = 0


# ------------------------------------------------------------ around it


def level_operands(coords, B: int, T: int, H: int, W: int, radius: int):
    """Per-(point, frame) kernel operands of one level: coords (B, T, n, 2)
    in this level's pixels -> starts (B*n, Tp, 3) int32 and wxy (B*n, Tp, 2)
    f32, with T padded to even Tp by repeating the last frame's window
    (fractions 0), as the Pallas kernel does."""
    n = coords.shape[2]
    wsx, wsy, wx, wy = window_starts_and_weights(coords.transpose(1, 2), radius, H, W)
    ft = (torch.arange(B, device=coords.device)[:, None, None] * T
          + torch.arange(T, device=coords.device)[None, None, :]).expand(B, n, T)
    starts = torch.stack([ft, wsy, wsx], dim=-1).to(torch.int32)
    Tp = T + T % 2
    if Tp != T:
        starts = torch.cat([starts, starts[:, :, -1:]], dim=2)
    wxy = torch.stack([F.pad(wx, (0, Tp - T)), F.pad(wy, (0, Tp - T))], dim=-1)
    return starts.reshape(B * n, Tp, 3), wxy.reshape(B * n, Tp, 2)


def _mlp1_hidden(level, supq, sup_scale, starts, wxy, w1m, b1, B, n, T, compute_dtype):
    """K4m's rows of one chunk, GELU applied: (B, n, T, Dh)."""
    h = corr_mlp1_int8(level, supq.reshape(B * n, S, -1), starts, wxy, *w1m, b1,
                       sup_scale.reshape(B * n), compute_dtype)
    return F.gelu(h.reshape(B, n, starts.shape[1], -1)[:, :, :T], approximate="none")


def corr_hidden(fmq, supq, sup_scale, coords, w1q, w1amax, b1, H, W, radius, compute_dtype,
                w1m=None):
    """One level, one chunk: GELU(MLP1(combined volume)) as (B, n, T, Dh),
    through K4 and the int8 MLP1 product, or through K4m when its W1 pack
    w1m (quantize_w1_mlp1) is given."""
    B, T, n, _ = coords.shape
    starts, wxy = level_operands(coords, B, T, H, W, radius)
    if w1m is not None:
        return _mlp1_hidden(fmq, supq, sup_scale, starts, wxy, w1m, b1, B, n, T, compute_dtype)
    vol, gscale = corr_volume_int8(fmq, supq.reshape(B * n, S, -1), starts, wxy)
    Tp = starts.shape[1]
    Dh = w1q.shape[0]
    h32 = torch._int_mm(vol.reshape(B * n * Tp, WIN * WIN * S), w1q.t())
    sc = (gscale.reshape(B, n) * sup_scale)[:, :, None, None]
    h = h32.to(F32).reshape(B, n, Tp, Dh) * (sc * (w1amax * (1.0 / 127.0)))
    h = h[:, :, :T].to(compute_dtype) + b1.to(compute_dtype)
    return F.gelu(h, approximate="none")


def fused_corr_tokens(
    levels,
    coords,
    w1q,
    w1amax,
    b1,
    w2f_list,
    b2f_sum,
    radius: int = 3,
    chunk: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    extra_ops=(),
    extra_fn=None,
    w1m=None,
):
    """All pyramid levels -> updateformer token contributions, one chunk loop.

    levels: per level (fmq (B*T, Hp, Wp, C) int8 from build_int8_level,
    supq (B, N, 49, C) int8, sup_scale (B, N) f32, (H, W) unpadded size).
    coords (B, T, N, 2) in level-0 pixels, compute dtype. w2f_list[i] =
    w2 @ Win[level-i rows]; b2f_sum their summed bias. extra_ops are (B, N,
    ...) tensors chunked alongside; extra_fn(*chunk) -> (B, n, T, Dtok) f32
    adds the non-correlation token terms. With w1m (quantize_w1_mlp1(w1)),
    every level runs K4m instead of K4 and the MLP1 product (the
    corr_fuse_mlp1 variant). Returns (B, N, T, Dtok) in the compute dtype."""
    B, T, N, _ = coords.shape
    cd = compute_dtype
    chunk = N if chunk is None else chunk
    out = None
    for s0 in range(0, N, chunk):
        sl = slice(s0, min(s0 + chunk, N))
        acc = None
        for i, (fmq, supq, sup_scale, (H, W)) in enumerate(levels):
            h = corr_hidden(fmq, supq[:, sl], sup_scale[:, sl], coords[:, :, sl] / 2.0**i,
                            w1q, w1amax, b1, H, W, radius, cd, w1m)
            contrib = h.to(F32) @ w2f_list[i].to(cd).to(F32)
            acc = contrib if acc is None else acc + contrib
        if extra_fn is not None:
            acc = acc + extra_fn(*(op[:, sl] for op in extra_ops))
        tok = (acc + b2f_sum).to(cd)
        if out is None:
            out = torch.empty((B, N) + tok.shape[2:], dtype=cd, device=tok.device)
        out[:, sl] = tok
    return out


# ------------------------------------------------------------ per level, trainable


def corr_hidden_raw(level, sup_c, coords, w1, b1, H, W, radius, compute_dtype, quant_int8,
                    w1m=None):
    """One level, one chunk, through K4r (quant_int8) or K4f and the XLA
    epilogue of corr_pallas.py:757-783, or through K4m when its W1 pack w1m
    is given: GELU(MLP1(combined volume)) as (B, n, T, Dh). level:
    build_int8_level / build_float_level output; sup_c (B, n, 49, C);
    coords (B, T, n, 2) in this level's pixels."""
    B, T, n, _ = coords.shape
    cd = compute_dtype
    P = 2 * radius + 1
    starts, wxy = level_operands(coords, B, T, H, W, radius)
    Tp = starts.shape[1]
    if quant_int8:
        # per-point support quantization, per chunk, from the compute dtype
        amax = sup_c.to(cd).abs().amax(dim=(2, 3)).to(F32).clamp_min(1e-20)  # (B, n)
        supq = torch.round(sup_c.to(cd).to(F32) * (127.0 / amax[..., None, None])).to(torch.int8)
        if w1m is not None:
            return _mlp1_hidden(level, supq, amax * (1.0 / 127.0 / 128.0), starts, wxy, w1m, b1,
                                B, n, T, cd)
        vol, kscale = corr_volume_raw_int8(level, supq.reshape(B * n, S, -1), starts)
        gscale = kscale.reshape(B, n) * (amax * (1.0 / 127.0 / 128.0))
    else:
        vol = corr_volume_float(level, sup_c.to(cd).reshape(B * n, S, -1), starts)
    g = vol.reshape(B, n, Tp, WIN, WIN, S)[:, :, :T].to(cd)  # (B, n, T, y, x, s)
    wxy = wxy.reshape(B, n, Tp, 2)[:, :, :T]
    wxb = wxy[..., 0].to(cd)[..., None, None, None]
    wyb = wxy[..., 1].to(cd)[..., None, None, None]
    oyb, oxb = 1 - wyb, 1 - wxb
    if quant_int8:
        # the per-point dequant scale rides the y-weight pair: every combine
        # term carries exactly one of wy / (1 - wy)
        sc = gscale.to(cd)[:, :, None, None, None, None]
        wyb = wyb * sc
        oyb = oyb * sc
    corr = (oyb * oxb * g[..., :P, :P, :] + oyb * wxb * g[..., :P, 1:, :]
            + wyb * oxb * g[..., 1:, :P, :] + wyb * wxb * g[..., 1:, 1:, :])  # (B, n, T, y, x, s)
    # w1 rows d = i_x*P*S + j_y*S + s, reordered to the volume's (y, x, s)
    w1r = w1.reshape(P, P, S, -1).transpose(0, 1).reshape(P * P * S, -1)
    h = corr.reshape(B, n, T, P * P * S) @ w1r.to(cd) + b1.to(cd)
    return F.gelu(h, approximate="none")


def fused_corr_embs_kernel(level, fmaps_hw, support, coords, w1, b1, w2, b2, radius: int = 3,
                           chunk: Optional[int] = None, compute_dtype=F32,
                           quant_int8: bool = True, fuse_mlp1: bool = False):
    """Port of fused_corr_embs_pallas (track-major, unfolded): the same
    contract as ops.corr.fused_corr_embs(track_major=True), the window
    products on K4r (quant_int8) or K4f, or with fuse_mlp1 (the
    corr_fuse_mlp1 variant, int8 only, as in the JAX package) the whole
    epilogue up to MLP1 + b1 on K4m. level: this level's codes or float
    map (build_int8_level / build_float_level); fmaps_hw: its unpadded
    (H, W); support (B, N, 49, C); coords (B, T, N, 2) in level pixels.
    Returns (B, N, T, Do) in the compute dtype."""
    N = coords.shape[2]
    cd = compute_dtype
    H, W = fmaps_hw
    if fuse_mlp1 and not quant_int8:
        raise ValueError("fuse_mlp1 rides the int8 window/support path: set quant_int8")
    w1m = quantize_w1_mlp1(w1) if fuse_mlp1 else None
    chunk = N if chunk is None else chunk
    outs = []
    for s0 in range(0, N, chunk):
        sl = slice(s0, min(s0 + chunk, N))
        h = corr_hidden_raw(level, support[:, sl], coords[:, :, sl], w1, b1, H, W, radius, cd,
                            quant_int8, w1m)
        outs.append(h @ w2.to(cd) + b2.to(cd))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class _TrainableCorr(torch.autograd.Function):
    """K4r / K4f / K4m forward, plain-PyTorch backward (see fused_corr_embs_trainable)."""

    @staticmethod
    def forward(ctx, level, fmaps, support, coords, w1, b1, w2, b2, opts):
        radius, chunk, cd, quant_int8, fuse_mlp1 = opts
        ctx.opts = opts
        ctx.save_for_backward(fmaps, support, coords, w1, b1, w2, b2)
        return fused_corr_embs_kernel(level, fmaps.shape[2:4], support, coords, w1, b1, w2, b2,
                                      radius, chunk, cd, quant_int8, fuse_mlp1)

    @staticmethod
    def backward(ctx, ct):
        radius, chunk, cd = ctx.opts[:3]
        needs = ctx.needs_input_grad[1:8]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = fused_corr_embs(*inputs, radius=radius, chunk=chunk, compute_dtype=cd,
                                      track_major=True)
            grads = iter(torch.autograd.grad(out, wanted, ct))
        return (None, *(next(grads) if t.requires_grad else None for t in inputs), None)


def fused_corr_embs_trainable(level, fmaps, support, coords, w1, b1, w2, b2, radius: int = 3,
                              chunk: Optional[int] = None, compute_dtype=F32,
                              quant_int8: bool = True, fuse_mlp1: bool = False):
    """Differentiable fused_corr_embs_kernel (port of
    fused_corr_embs_pallas_trainable): K4r or K4f plus the epilogue forward,
    or with fuse_mlp1 (the corr_fuse_mlp1 variant, int8 only; the JAX
    wrapper reads COTRACKER_CORR_FUSE_MLP1 at trace time, the model passes
    its resolved switch) K4m, and as backward the exact autograd of the
    plain ops.corr.fused_corr_embs evaluated at the same inputs, recomputed
    from them. With quant_int8 the forward is quantized while the backward
    stays full precision: a straight-through estimator, as in the JAX
    package.

    The backward is plain PyTorch on purpose: the JAX package's is XLA
    autodiff (jax.vjp of fused_corr_embs), not a kernel, so there is none
    to port. `level` is build_int8_level / build_float_level(fmaps) and gets
    no gradient; `fmaps` (B, T, H, W, C) is the raw map, the gradient
    channel to the encoder. Gradients reach fmaps, support, coords and the
    MLP weights (the model detaches coords at each iteration)."""
    return _TrainableCorr.apply(level, fmaps, support, coords, w1, b1, w2, b2,
                                (radius, chunk, compute_dtype, quant_int8, fuse_mlp1))
