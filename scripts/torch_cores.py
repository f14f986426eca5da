"""The attention cores of the port on the card, alone: K5 (time, its long
route past 512 frames too), K6 (points <- virtual), K7 (virtual <- points),
each against its plain version (max |err| / max |ref|) and timed with
CUDA events beside one scaled_dot_product_attention call on the same
operands (a yardstick; the port never calls it) and its byte bound. Then
K1, the whole W8A8 time block whose attention stage is K5's time core: its
two launches (the front's and the tail's device time read from the
profiler's kernel records of the same calls), the launch chain it replaced
(kept as the f32 route), the same block as a library chain (its five
products through torch._int_mm plus SDPA: how close the hand-written
products come to cuBLAS int8; never called by the port), its operation
bound and its device launches a call (the kernel nodes of a CUDA graph
captured from one call); then, from 8 to 256 frames, the share of K1's
elements past the W8A8 band's tight bound, its two launches beside the
launch chain.

Then K4 (the int8 correlation volume with the bilinear combine) at the
shapes the forwards launch it with (2,048-point chunks: level 0 of the
offline window and of a streaming window, levels 1-3 of the offline window,
level 0 of the long forward's 250 frames), its codes and scales against
corr_volume_plain (bit for bit), and K9 (the split time block's out + MLP
half) at the long forward's row counts (2,048, 2,560 and 64 tracks x 250
frames) against attnout_mlp_plain, each with its bound. Then K2 (the whole
points<-virtual block: in bf16 a fused front and K1's tail) and
K3 (virtual <- points with the norm and the k|v projection: in bf16 one
fused kernel and the merge of its key ranges) at 10,240 tracks x 60 and x
16 frames (K3 also at 70,656 x 16), each against its plain version, with
its kernels' device time from the profiler's records, its device launches,
the launch chain it replaced (kept as the f32 route) and its bound; on an
earlier checkout (--root) the same records time that checkout's body.
Then K8 (the split time block's LN + W8A8 q|kv) at the long forward's row
counts, bit for bit against its PR 4 body, and K4m (correlation + combine
+ MLP1) at every pyramid level of the streaming and offline windows, its
rows against corr_mlp1_plain, beside its first body and, per level-chunk
with GELU, beside K4 + the int8 MLP1 product it replaces. Then K11 (the
`space_allt` points<-virtual block, on K2's launches) at 10,240 and 70,656
tracks x 16 frames against K2 bit for bit, with its kernels' device time,
beside K2; and K12 (LN + W8A8 MLP, 8-block clusters) at the
micro-benchmark's 604,800 rows and at 1,576, bit for bit against its first
body, beside the first body and a library chain (LN in torch,
torch._int_mm for fc1 and fc2), with its plan and device launches. Then
K4f (the raw float correlation volume of the training path) at 768 x 16
and 2,048 x 60 in f32 and bf16, against corr_volume_float_plain, beside the
plain version (the gather + torch.bmm chain, also its library chain) and
torch.bmm alone, with its bytes and operation bounds and, on a checkout
with k4f_plan, at each frame group of its tasks; and K10 (LN + W8A8
dense) at the micro-benchmark's 604,800 rows in each (ln, affine,
residual) combination, bit for bit against its first body, beside it and a
library chain. Then K4r (the raw int8 volume of the training path: K4's
cluster kernel in its K4r mode) at 768 x 16, 2,048 x 60 and 256 x 80 (two
passes), bit for bit against corr_volume_raw_plain, beside the plain
version, with its plan, device launches and bound; on an earlier checkout
(--root) its first body.

    python3 scripts/torch_cores.py              # the main paths' shapes
    python3 scripts/torch_cores.py --sweep      # also K7 at each key-range
                                                # count, K5's register and
                                                # two-pass routes side by side
    python3 scripts/torch_cores.py --only k4 k9 # some sections
    python3 scripts/torch_cores.py --only k2 k3 --root build/parent
    python3 scripts/torch_cores.py --only k8 k4m --root build/parent
    python3 scripts/torch_cores.py --only k11 k12 --root build/parent
    python3 scripts/torch_cores.py --only k4f k10 --root build/parent
    python3 scripts/torch_cores.py --only k4r k4 k4m --root build/parent
    python3 scripts/torch_cores.py --only k4 k9 --root path/to/checkout
                                                # the same sections on
                                                # another checkout's package
                                                # (its kernels built there)

One JSON line per measurement. Needs a CUDA card; bf16, random operands
from seed 0.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa  # yardstick only


def _root() -> str:
    """The checkout whose package this run imports: --root, else this one."""
    if "--root" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


sys.path.insert(0, _root())

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, corr_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels import mlp_int8_cuda  # noqa: E402
from cotracker_tpu_torch.utils.profiling import device_launches, kernel_ms  # noqa: E402
from torch_library_chains import k4f_windows, k10_library_chain, k12_library_chain  # noqa: E402

C, H, D, V, HID = 384, 8, 48, 64, 1536
HBM_BPS, INT8_OPS, BF16_OPS, F32_OPS = 3.35e12, 1979e12, 989e12, 67e12  # H100 SXM, dense, 700 W
TF32_OPS = 494.7e12
# K5 at the default paths' shapes: streaming (b) and evaluation (10,240 x 16),
# the offline window (x 60), the long forward's point and virtual tokens
# (2,560 / 64 x 250), the 600-frame video (512 x 600, the long route) and
# 256 x 640
K5_SHAPES = ((10240, 16), (10240, 60), (2560, 250), (64, 250), (512, 600), (256, 640))
K1_SHAPES = ((10240, 60), (10240, 16), (64, 60))


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def hm(t):
    return t.unflatten(-1, (H, D)).transpose(-2, -3)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def window_bytes(fmq, starts):
    """The level map's bytes that the 8 x 8 windows at `starts` (frame, wy,
    wx) read: each (frame, y, x) pixel that some window covers, once (the
    padded map's rim and the pixels no window reaches are not read)."""
    F, Hp, Wp, C = fmq.shape
    s = starts.reshape(-1, 3).long()
    d = torch.arange(8, device=s.device)
    f, wy, wx = (s[:, i, None, None] for i in range(3))
    pix = (f * Hp + wy + d[:, None]) * Wp + wx + d
    covered = torch.zeros(F * Hp * Wp, dtype=torch.bool, device=s.device)
    covered[pix.flatten()] = True
    return int(covered.sum().item()) * C * fmq.element_size()


def emit(**rec):
    print(json.dumps(rec), flush=True)


def bound_ms(nbytes_moved, op_seconds):
    """The larger of the bytes over the memory rate and the operations'
    time at their peak, in ms."""
    return 1e3 * max(nbytes_moved / HBM_BPS, op_seconds)


def first_version_ms(q, kv):
    """K5's first-version body (keys staged as f32, products on the CUDA
    cores), as the K1 launch chain still runs it (ct_time_attention, f32
    output), on the same operands as one [q | k | v] buffer; None past the
    512 frames it stages."""
    M, T, _ = q.shape
    if T > mlp_int8_cuda.MAX_KEYS:
        return None
    qkv = torch.cat([q, kv], -1).reshape(M * T, 3 * C)
    a = torch.empty((M * T, C), dtype=torch.float32, device=q.device)
    fn = mlp_int8_cuda._lib()["time_attn"]
    return time_ms(lambda: _build.check(fn(qkv.data_ptr(), 1, a.data_ptr(), M, T, H, D, D**-0.5,
                                           _build.stream_ptr(q)), "ct_time_attention"), reps=3)


def k7_with_splits(q, kv, bias, splits):
    """ct_k7_virtual_from_points with an explicit key-range count."""
    T, _, _ = q.shape
    part = torch.empty((splits * T * V * (C + 2 * H),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.check(attention_cuda._cores_lib()["k7"](
        q.data_ptr(), kv.data_ptr(), bias.data_ptr(), 1, out.data_ptr(), part.data_ptr(), splits,
        kv.shape[0], T, V, H, D, D**-0.5, _build.stream_ptr(q)), "ct_k7_virtual_from_points")
    return out


def beyond_tight(out, ref):
    """Share of out's elements past the bf16 W8A8 band's tight bound, 8e-3
    of mean |ref| (tests/test_torch_cuda.py::_close)."""
    err = (out.float() - ref.float()).abs()
    return (err > 8e-3 * ref.float().abs().mean()).float().mean().item()


def k1_bands(dev):
    """K1's two launches and the launch chain K1 ran before, each against
    time_block_plain, by that share, on the card tests' inputs
    (test_time_block_frames: seed T + M, weights 0.05 randn) from 8 to 256
    frames, bf16_ln and gelu_fold both off or both on."""
    for T in (8, 16, 60, 96, 128, 192, 256):
        for N in (64, 37):
            for var in (False, True):
                g = torch.Generator().manual_seed(T + N)
                w = mlp_int8_cuda.TimeBlockWeights(*(mlp_int8_cuda.quantize_linear(
                    (torch.randn(o, i, generator=g) * 0.05).to(dev),
                    (torch.randn(o, generator=g) * 0.1).to(dev))
                    for o, i in ((3 * C, C), (C, C), (HID, C), (C, HID))))
                x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
                ref = mlp_int8_cuda.time_block_plain(x, w, H, D, bf16_ln=var, gelu_fold=var)
                emit(block="K1", tracks=N, frames=T, variants=var, beyond_tight=beyond_tight(
                    mlp_int8_cuda.fused_time_block_int8(x, w, H, D, bf16_ln=var, gelu_fold=var),
                    ref), chain_beyond_tight=beyond_tight(mlp_int8_cuda._time_block_chain(
                        x, w, H, D, 1e-6, var, var), ref))


# K4's shapes: (name, level size, points, frames); the level sizes are the
# 384x512 input's pyramid (stride 4, then 2x pooling)
K4_SHAPES = (("l0_t60", (96, 128), 2048, 60), ("l0_t16", (96, 128), 2048, 16),
             ("l1_t60", (48, 64), 2048, 60), ("l2_t60", (24, 32), 2048, 60),
             ("l3_t60", (12, 16), 2048, 60), ("l0_t250", (96, 128), 2048, 250))
K9_SHAPES = ((2048, 250), (2560, 250), (64, 250))
PLAIN_POINTS = 256  # points a plain K4 call takes at once (its f32 gather grows with T)


def k4_operands(g, dev, hw, n, T):
    """K4's operands at one pyramid level, as chip_smoke makes them: unit
    features, a unit support, coordinates uniform over the level."""
    bf = torch.bfloat16
    Hh, W = hw
    fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g), dim=-1)
    fmq = corr_cuda.build_int8_level(fm.to(dev, bf), 3)
    del fm
    sup = torch.nn.functional.normalize(torch.randn(1, 49, n, 128, generator=g), dim=-1)
    supq, _ = corr_cuda.quantize_support(sup.to(dev, bf), bf)
    coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev, bf)
    starts, wxy = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
    return fmq, supq.reshape(n, 49, 128), starts, wxy


def k4_plain_chunked(fmq, supq, starts, wxy):
    """corr_volume_plain over PLAIN_POINTS points at a time (per point
    independent, so the same function)."""
    parts = [corr_cuda.corr_volume_plain(fmq, supq[i:i + PLAIN_POINTS], starts[i:i + PLAIN_POINTS],
                                         wxy[i:i + PLAIN_POINTS])
             for i in range(0, supq.shape[0], PLAIN_POINTS)]
    return torch.cat([v for v, _ in parts]), torch.cat([s for _, s in parts])


def k4_section(dev, g):
    for name, hw, n, T in K4_SHAPES:
        fmq, supq, starts, wxy = k4_operands(g, dev, hw, n, T)
        vol, scale = corr_cuda.corr_volume_int8(fmq, supq, starts, wxy)
        rvol, rscale = k4_plain_chunked(fmq, supq, starts, wxy)
        Tp = starts.shape[1]
        plan = corr_cuda.k4_plan(n, Tp)._asdict() if hasattr(corr_cuda, "k4_plan") else None
        emit(kernel="K4", shape=name, points=n, frames=T, level_hw=list(hw), plan=plan,
             code_mismatches=int((vol != rvol).sum().item()),
             scale_mismatches=int((scale != rscale).sum().item()),
             ms=time_ms(lambda: corr_cuda.corr_volume_int8(fmq, supq, starts, wxy), reps=10),
             bound_ms=bound_ms(nbytes(fmq, supq, starts, wxy, vol, scale),
                               n * Tp * 64 * 49 * 128 * 2 / INT8_OPS
                               + n * Tp * 64 * 49 * 10 / F32_OPS))
        del fmq, supq, starts, wxy, vol, rvol


def k9_section(dev, g):
    M = mlp_int8_cuda
    w = M.TimeBlockWeights(*(lin(g, dev, o, i) for o, i in ((3 * C, C), (C, C), (HID, C), (C, HID))))
    wbytes = nbytes(*[t for q in w for t in q])
    for N, T in K9_SHAPES:
        rows = N * T
        x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
        a = (0.5 * torch.randn(N, T, C, generator=g)).to(dev, torch.bfloat16)
        out, ref = M.fused_attnout_res_mlp_int8(a, x, w), M.attnout_mlp_plain(a, x, w)
        err = (out.float() - ref.float()).abs()
        emit(kernel="K9", tracks=N, frames=T,
             route=M.k9_route(x.dtype) if hasattr(M, "k9_route") else "tile",
             max_abs_err=err.max().item(), median_abs_err=err.median().item(),
             mean_abs_ref=ref.float().abs().mean().item(), max_abs_ref=ref.float().abs().max().item(),
             ms=time_ms(lambda: M.fused_attnout_res_mlp_int8(a, x, w), reps=10),
             device_launches=device_launches(lambda: M.fused_attnout_res_mlp_int8(a, x, w)),
             bound_ms=bound_ms(3 * nbytes(x) + wbytes, rows * 2 * (C * C + 2 * C * HID) / INT8_OPS))
        del x, a, out, ref


K8_SHAPES = ((2048, 250), (2560, 250), (64, 250))
# K4m's shapes: every pyramid level of the quasi-dense (c) window (T=16) and
# of the offline (c) window (T=60), one 2,048-point chunk each
K4M_SHAPES = tuple((f"l{lv}_t{T}", (96 >> lv, 128 >> lv), 2048, T)
                   for T in (16, 60) for lv in range(4))


def k8_section(dev, g):
    """K8 (the split time block's LN + W8A8 q|kv) at the long forward's row
    counts: the wrapper's body (in bf16 the streamed body on k8_plan's
    persistent blocks; on an earlier checkout the PR 4 body), bit for bit
    against the PR 4 body where the checkout keeps it beside (in both LN
    modes), its device launches and its byte bound."""
    M = mlp_int8_cuda
    qkv = lin(g, dev, 3 * C, C)
    first = getattr(M, "_ln_qkv_tile", None)
    for N, T in K8_SHAPES:
        x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
        rec = dict(kernel="K8", tracks=N, frames=T,
                   plan=M.k8_plan(N * T, x.dtype)._asdict() if hasattr(M, "k8_plan") else None,
                   ms=time_ms(lambda: M.fused_ln_qkv_int8(x, qkv), reps=10),
                   device_launches=device_launches(lambda: M.fused_ln_qkv_int8(x, qkv)),
                   bound_ms=bound_ms(4 * nbytes(x) + nbytes(*qkv), N * T * 2 * C * 3 * C / INT8_OPS))
        if first is not None:
            x2d = x.reshape(-1, C)
            for ln in (False, True):
                q, kv = M.fused_ln_qkv_int8(x, qkv, bf16_ln=ln)
                fq, fkv = first(x2d, qkv, 1e-6, ln)
                rec["mismatches" + ("_bf16_ln" if ln else "")] = int(
                    (q.reshape(-1, C) != fq).sum().item() + (kv.reshape(-1, 2 * C) != fkv).sum().item())
            rec["first_ms"] = time_ms(lambda: first(x2d, qkv, 1e-6, False), reps=10)
            rec["ms_bf16_ln"] = time_ms(lambda: M.fused_ln_qkv_int8(x, qkv, bf16_ln=True), reps=10)
        emit(**rec)
        del x


def k4m_section(dev, g):
    """K4m (correlation + combine + MLP1) at every level of the (c) windows:
    the wrapper's body (two launches: the code rows on K4's cluster tiling,
    then MLP1 on 128-row tiles; on an earlier checkout the first body) with
    its kernels' device time, the rows against corr_mlp1_plain bit for bit,
    the first body where the checkout keeps it beside, and per level-chunk
    with GELU the K4m path against K4 + the int8 MLP1 product (corr_hidden)."""
    bf = torch.bfloat16
    w1 = (0.02 * torch.randn(2401, 384, generator=g)).to(dev)
    b1 = (0.1 * torch.randn(384, generator=g)).to(dev)
    w1c, w1s = corr_cuda.quantize_w1_mlp1(w1)
    w1q, w1amax = corr_cuda.quantize_w1(w1, bf)
    first = getattr(corr_cuda, "_corr_mlp1_first", None)
    for name, (Hh, W), n, T in K4M_SHAPES:
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g), dim=-1)
        fmq = corr_cuda.build_int8_level(fm.to(dev, bf), 3)
        del fm
        sup = torch.nn.functional.normalize(torch.randn(1, 49, n, 128, generator=g), dim=-1)
        supq, sscale = corr_cuda.quantize_support(sup.to(dev, bf), bf)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev, bf)
        starts, wxy = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        args = (fmq, supq.reshape(n, 49, 128), starts, wxy, w1c, w1s, b1, sscale.reshape(n), bf)
        fn = lambda: corr_cuda.corr_mlp1_int8(*args)  # noqa: E731
        out = fn()
        ref = torch.cat([corr_cuda.corr_mlp1_plain(fmq, *(a[i:i + PLAIN_POINTS] for a in args[1:4]),
                                                   w1c, w1s, b1, args[7][i:i + PLAIN_POINTS], bf)
                         for i in range(0, n, PLAIN_POINTS)])
        Tp = starts.shape[1]
        by_kernel = kernel_ms(fn)
        chain = lambda mlp1: corr_cuda.corr_hidden(  # noqa: E731
            fmq, supq, sscale, coords, w1q, w1amax, b1, Hh, W, 3, bf,
            (w1c, w1s) if mlp1 else None)
        rec = dict(kernel="K4m", shape=name, points=n, frames=T,
                   plan=corr_cuda.k4m_plan(n, Tp)._asdict() if hasattr(corr_cuda, "k4m_plan") else None,
                   row_mismatches=int((out != ref).any(-1).sum().item()),
                   ms=time_ms(fn, reps=10),
                   volume_ms=sum(t for k, t in by_kernel.items() if "corr_volume_kernel" in k),
                   gemm_ms=sum(t for k, t in by_kernel.items() if "mlp1_gemm_kernel" in k),
                   kernels_ms={k[:60]: round(t, 4) for k, t in by_kernel.items()},
                   device_launches=device_launches(fn),
                   k4_chain_ms=time_ms(lambda: chain(False), reps=5),
                   k4m_chain_ms=time_ms(lambda: chain(True), reps=5),
                   bound_ms=bound_ms(nbytes(*args[:-1], out),
                                     n * Tp * (64 * 49 * 128 + 2401 * 384) * 2 / INT8_OPS
                                     + n * Tp * 2401 * 6 / F32_OPS))
        if first is not None:
            rec["first_row_mismatches"] = int((first(*args) != ref).any(-1).sum().item())
            rec["first_ms"] = time_ms(lambda: first(*args), reps=5)
        emit(**rec)
        del fmq, supq, starts, wxy, out, ref


# K4r: the training shape, the inference chunk (level 0 of the 384x512
# input) and 80 frames (K4's cluster kernel in two passes)
K4R_SHAPES = ((768, 16), (2048, 60), (256, 80))


def k4r_section(dev, g):
    """K4r (the raw int8 volume of the training path) at the training shape,
    the inference chunk and 80 frames: the wrapper's body (K4's cluster
    kernel in its K4r mode on k4_plan; on an earlier checkout its first
    body) against corr_volume_raw_plain bit for bit, its time, its device
    launches, the plain version's time, the plan where the checkout runs
    K4r on it, and the bound (bytes against the s8 products at the int8
    peak; of the level map only the pixels the windows cover)."""
    Hh, W = 96, 128
    on_plan = hasattr(corr_cuda, "_k4_launch")
    for n, T in K4R_SHAPES:
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g), dim=-1).to(dev)
        sup = torch.nn.functional.normalize(torch.randn(1, 49, n, 128, generator=g), dim=-1).to(dev)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, _ = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        fmq = corr_cuda.build_int8_level(fm, 3)
        supq = corr_cuda.quantize_support(sup, torch.float32)[0].reshape(n, 49, 128)
        del fm, sup
        Tp = starts.shape[1]
        fn = lambda: corr_cuda.corr_volume_raw_int8(fmq, supq, starts)  # noqa: E731
        vol, scale = fn()
        rvol, rscale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
        emit(kernel="K4r", points=n, frames=T,
             plan=corr_cuda.k4_plan(n, Tp)._asdict() if on_plan else None,
             code_mismatches=int((vol != rvol).sum().item()),
             scale_mismatches=int((scale != rscale).sum().item()),
             ms=time_ms(fn), device_launches=device_launches(fn),
             plain_ms=time_ms(lambda: corr_cuda.corr_volume_raw_plain(fmq, supq, starts), reps=2),
             bound_ms=bound_ms(window_bytes(fmq, starts) + nbytes(supq, starts, vol, scale),
                               n * Tp * 64 * 49 * 128 * 2 / INT8_OPS))
        del fmq, supq, starts, vol, rvol


SECTIONS = ("k4", "k9", "cores", "k1", "k2", "k3", "k8", "k4m", "k11", "k12", "k4f", "k10",
            "k4r")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="K7 at 1-16 key ranges; K5's register routes against two passes")
    ap.add_argument("--only", nargs="+", choices=SECTIONS, default=SECTIONS,
                    help="the sections to run (default all)")
    ap.add_argument("--root", default=None,
                    help="import the package (and build its kernels) from this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_cores: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi, root=_root(),
         build_s=round(_build.build_all()[0], 1))
    dev = torch.device("cuda")
    # each section draws its operands from its own seed, so --only repeats them
    seeds = dict(zip(SECTIONS, range(len(SECTIONS))))
    run = dict(k4=k4_section, k9=k9_section, cores=lambda d, g: cores_section(d, g, args.sweep),
               k1=k1_section, k2=k2_section, k3=k3_section, k8=k8_section, k4m=k4m_section,
               k11=k11_section, k12=k12_section, k4f=k4f_section, k10=k10_section,
               k4r=k4r_section)
    for name in SECTIONS:
        if name in args.only:
            run[name](dev, torch.Generator().manual_seed(seeds[name]))


def lin(g, dev, o, i):
    w = torch.randn(o, i, generator=g) / math.sqrt(i)
    return mlp_int8_cuda.quantize_linear(w.to(dev), (0.05 * torch.randn(o, generator=g)).to(dev))


def cores_section(dev, g, sweep):
    bf = torch.bfloat16
    A = attention_cuda

    for N, T in ((10240, 16), (10240, 60)):
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        q6 = hm(x.transpose(0, 1))
        emit(core="K6", tracks=N, frames=T,
             err=rel_err(A.fused_points_from_virtual(x, kv, H, D), A.p2v_plain(x, kv, H, D)),
             ms=time_ms(lambda: A.fused_points_from_virtual(x, kv, H, D)),
             sdpa_ms=time_ms(lambda: sdpa(q6, hm(kv[..., :C]), hm(kv[..., C:]))),
             bound_ms=1e3 * 2 * nbytes(x) / HBM_BPS)
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        kv7 = torch.randn(N, T, 2 * C, generator=g).to(dev, bf)
        bias = torch.zeros(N, device=dev)
        k7t, mask = kv7.transpose(0, 1), bias.to(bf)[None, None, None, :]
        emit(core="K7", tracks=N, frames=T, splits=A.v2p_splits(N, T, V, H, dev),
             err=rel_err(A.fused_virtual_from_points(q, kv7, H, D, key_bias=bias),
                         A.v2p_plain(q, kv7, H, D, key_bias=bias)),
             ms=time_ms(lambda: A.fused_virtual_from_points(q, kv7, H, D, key_bias=bias)),
             sdpa_ms=time_ms(lambda: sdpa(hm(q), hm(k7t[..., :C]), hm(k7t[..., C:]),
                                          attn_mask=mask)),
             bound_ms=1e3 * nbytes(kv7) / HBM_BPS)
        if sweep:
            emit(core="K7", tracks=N, frames=T, ms_by_splits={
                s: time_ms(lambda: k7_with_splits(q, kv7, bias, s)) for s in (1, 2, 3, 4, 6, 8,
                                                                              12, 16)})
        del x, kv, kv7

    for M5, T5 in K5_SHAPES:
        x = torch.randn(M5, T5, C, generator=g).to(dev, bf)
        kv5 = torch.randn(M5, T5, 2 * C, generator=g).to(dev, bf)
        plan = A.k5_plan(T5, H, True)
        rec = dict(core="K5", tracks=M5, frames=T5, route=plan.route, nc=plan.nc, hs=plan.hs,
                   err=rel_err(A.fused_time_attention(x, kv5, H, D),
                               A.time_attention_plain(x, kv5, H, D)),
                   ms=time_ms(lambda: A.fused_time_attention(x, kv5, H, D), reps=10),
                   sdpa_ms=time_ms(lambda: sdpa(hm(x), hm(kv5[..., :C]), hm(kv5[..., C:])),
                                   reps=10),
                   bound_ms=bound_ms(nbytes(x, kv5, x), M5 * T5 * H * 4 * T5 * D / BF16_OPS),
                   first_version_ms=first_version_ms(x, kv5))
        if sweep and plan.route == "tc" and plan.nc > 1:  # registers against two passes
            rec["ms_two_pass"] = time_ms(lambda: A._k5_launch(x, kv5, H, D, plan._replace(nc=0)))
        emit(**rec)
        del x, kv5
    if sweep:
        x = torch.randn(2048, 128, C, generator=g).to(dev, bf)
        kv5 = torch.randn(2048, 128, 2 * C, generator=g).to(dev, bf)
        plan = A.k5_plan(128, H, True)
        emit(core="K5", tracks=2048, frames=128, ms=time_ms(lambda: A.fused_time_attention(
            x, kv5, H, D)), ms_two_pass=time_ms(lambda: A._k5_launch(x, kv5, H, D,
                                                                      plan._replace(nc=0))))
        del x, kv5


def k1_section(dev, g):
    bf = torch.bfloat16
    M = mlp_int8_cuda
    tw = M.TimeBlockWeights(*(lin(g, dev, o, i) for o, i in ((3 * C, C), (C, C), (HID, C), (C, HID))))
    for N, T in K1_SHAPES:
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        rows = N * T
        new = lambda: M.fused_time_block_int8(x, tw, H, D)  # noqa: E731
        chain = lambda: M._time_block_chain(x, tw, H, D, 1e-6, False, False)  # noqa: E731
        # the library chain: the block's five products through cuBLAS int8 and
        # one SDPA, on codes of the same shapes (no quantization or epilogue)
        a8 = torch.randint(-127, 128, (rows, C), dtype=torch.int8, device=dev)
        u8 = torch.randint(-127, 128, (rows, HID), dtype=torch.int8, device=dev)
        wq, wkv = tw.qkv.w[:C], tw.qkv.w[C:]
        q, kv = x, torch.randn(N, T, 2 * C, generator=g).to(dev, bf)
        library = [lambda: torch._int_mm(a8, wq.t()), lambda: torch._int_mm(a8, wkv.t()),
                   lambda: sdpa(hm(q), hm(kv[..., :C]), hm(kv[..., C:])),
                   lambda: torch._int_mm(a8, tw.out.w.t()), lambda: torch._int_mm(a8, tw.fc1.w.t()),
                   lambda: torch._int_mm(u8, tw.fc2.w.t())]
        lib_ms = [time_ms(f) for f in library]
        by_kernel = kernel_ms(new)
        emit(block="K1", tracks=N, frames=T, plan=M.k1_plan(N, T)._asdict(),
             err=rel_err(new(), M.time_block_plain(x, tw, H, D)), ms=time_ms(new),
             front_ms=sum(t for k, t in by_kernel.items() if "k1_front_kernel" in k),
             tail_ms=sum(t for k, t in by_kernel.items() if "k1_tail_kernel" in k),
             chain_ms=time_ms(chain, reps=5), library_chain_ms=sum(lib_ms),
             library_chain_parts_ms=lib_ms, device_launches=device_launches(new),
             chain_device_launches=device_launches(chain),
             bound_ms=bound_ms(2 * nbytes(x) + nbytes(*[t for ql in tw for t in ql]),
                               rows * 2 * C * (3 * C + C + 2 * HID) / INT8_OPS
                               + rows * H * 4 * T * D / BF16_OPS))
        del x, a8, u8, q, kv
    k1_bands(dev)


K2_SHAPES = ((10240, 60), (10240, 16))
K3_SHAPES = ((10240, 60), (10240, 16), (70656, 16))


def _emit_block(kernel, fn, ref, parts, chain, rec, bound):
    """One record of a whole W8A8 block: the wrapper's body against its plain
    version, its time, the device time of its kernels by name (`parts`:
    record key -> substring of the kernel names), its device launches a
    call, the launch chain where the checkout keeps one, and its bound."""
    out = fn()
    err = (out.float() - ref.float()).abs()
    by_kernel = kernel_ms(fn)
    rec.update(
        kernel=kernel, max_abs_err=err.max().item(), median_abs_err=err.median().item(),
        mean_abs_ref=ref.float().abs().mean().item(), max_abs_ref=ref.float().abs().max().item(),
        beyond_tight=beyond_tight(out, ref), ms=time_ms(fn, reps=10),
        **{k: sum(t for n, t in by_kernel.items() if sub in n) for k, sub in parts.items()},
        kernels_ms={n[:60]: round(t, 4) for n, t in by_kernel.items()},
        device_launches=device_launches(fn),
        chain_ms=None if chain is None else time_ms(chain, reps=5), bound_ms=bound)
    emit(**rec)


def k2_section(dev, g):
    """K2, the whole points<-virtual block, at the main paths' shapes: the
    wrapper's body (in bf16 the fused front then K1's tail; on
    an earlier checkout its launch chain) with the front's and the tail's
    device time, beside the launch chain where the checkout keeps it."""
    M = mlp_int8_cuda
    sw = M.SpaceBlockWeights(*(lin(g, dev, o, i) for o, i in ((C, C), (C, C), (HID, C), (C, HID))))
    wbytes = nbytes(*[t for q in sw for t in q])
    chain = getattr(M, "_space_block_chain", None)
    for N, T in K2_SHAPES:
        x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, torch.bfloat16)
        rows = N * T
        plan = M.k2_plan(N, T, V, x.dtype, sms=torch.cuda.get_device_properties(dev)
                         .multi_processor_count)._asdict() if hasattr(M, "k2_plan") else None
        _emit_block("K2", lambda: M.fused_space_block_int8(x, kv, sw, H, D),
                    M.space_block_plain(x, kv, sw, H, D),
                    dict(front_ms="k2_front_kernel", tail_ms="k1_tail_kernel"),
                    None if chain is None else lambda: chain(x, kv, sw, H, D, 1e-6, False, False),
                    dict(tracks=N, frames=T, plan=plan),
                    bound_ms(2 * nbytes(x) + nbytes(kv) + wbytes,
                             rows * 2 * C * (2 * C + 2 * HID) / INT8_OPS
                             + rows * H * 4 * V * D / BF16_OPS))
        del x, kv


def k3_section(dev, g):
    """K3, virtual<-points with the context norm and the k|v projection, at
    the main paths' shapes and the quasi-dense point count (the last eighth
    of the keys masked): the wrapper's body (in bf16 one fused kernel and
    the merge of its key ranges; on an earlier checkout its
    launch chain) with the kernel's and the merge's device time, beside the
    launch chain where the checkout keeps it."""
    A = attention_cuda
    wkv = lin(g, dev, 2 * C, C)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    chain = getattr(A, "_v2p_proj_chain", None)
    for N, T in K3_SHAPES:
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, torch.bfloat16)
        x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
        bias = torch.zeros(N, device=dev)
        bias[N - N // 8:] = A.NEG_BIG
        args = (q, x, wkv, gamma, beta, H, D, bias)
        plan = A.k3_plan(N, T, V, q.dtype, sms=torch.cuda.get_device_properties(dev)
                         .multi_processor_count)._asdict() if hasattr(A, "k3_plan") else None
        _emit_block("K3", lambda: A.fused_virtual_from_points_proj(*args), A.v2p_proj_plain(*args),
                    dict(fused_ms="k3_proj_flash_kernel", merge_ms="v2p_merge_kernel"),
                    None if chain is None else lambda: chain(*args, 1e-5),
                    dict(tracks=N, frames=T, plan=plan),
                    bound_ms(nbytes(q, x, wkv.w, bias, q),
                             N * T * 2 * C * 2 * C / INT8_OPS + T * H * V * N * 4 * D / BF16_OPS))
        del q, x


K11_SHAPES = ((10240, 16), (70656, 16))


def k11_section(dev, g):
    """K11 at the quasi-dense (c) window's shape and at 10,240 tracks: the
    wrapper's body (K2's two launches, the front under K11's name; on an
    earlier checkout the first body) against K2 bit for bit and against its
    plain version, its kernels' device time, its device launches, K2's time
    and the bound."""
    M = mlp_int8_cuda
    sw = M.SpaceBlockWeights(*(lin(g, dev, o, i) for o, i in ((C, C), (C, C), (HID, C), (C, HID))))
    wbytes = nbytes(*[t for q in sw for t in q])
    for N, T in K11_SHAPES:
        x = torch.randn(N, T, C, generator=g).to(dev, torch.bfloat16)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, torch.bfloat16)
        rows = N * T
        fn = lambda: M.fused_space_block_allt_int8(x, kv, sw, H, D)  # noqa: E731
        k2 = lambda: M.fused_space_block_int8(x, kv, sw, H, D)  # noqa: E731
        _emit_block("K11", fn, M.space_block_plain(x, kv, sw, H, D),
                    dict(front_ms="k11_front_kernel", tail_ms="k1_tail_kernel",
                         first_body_ms="space_block_allt_kernel"), None,
                    dict(tracks=N, frames=T, k2_mismatches=int((fn() != k2()).sum().item()),
                         k2_ms=time_ms(k2, reps=10)),
                    bound_ms(2 * nbytes(x) + nbytes(kv) + wbytes,
                             rows * 2 * C * (2 * C + 2 * HID) / INT8_OPS
                             + rows * H * 4 * V * D / BF16_OPS))
        del x, kv


K12_ROWS = (604800, 1576)


def k12_section(dev, g):
    """K12 at the micro-benchmark's rows: the wrapper's body (8-block
    clusters; on an earlier checkout the first body) bit for bit against
    the first body where the checkout keeps it beside (LN on and off), its
    time, the first body's, the library chain's, its device launches, its
    plan and its bound."""
    M = mlp_int8_cuda
    fc1, fc2 = lin(g, dev, HID, C), lin(g, dev, C, HID)
    first = getattr(M, "_ln_mlp_first", None)
    for rows in K12_ROWS:
        x = torch.randn(rows, C, generator=g).to(dev, torch.bfloat16)
        rec = dict(kernel="K12", rows=rows,
                   ms=time_ms(lambda: M.fused_ln_mlp_int8(x, fc1, fc2), reps=10),
                   ms_ln0=time_ms(lambda: M.fused_ln_mlp_int8(x, fc1, fc2, ln=False), reps=10),
                   device_launches=device_launches(lambda: M.fused_ln_mlp_int8(x, fc1, fc2)),
                   library_chain_ms=time_ms(lambda: k12_library_chain(x, fc1, fc2, True), reps=3),
                   bound_ms=bound_ms(2 * nbytes(x) + nbytes(*fc1, *fc2), rows * 4 * C * HID / INT8_OPS))
        if hasattr(M, "k12_plan"):
            rec["plan"] = M.k12_plan(rows, M._k12_max_clusters(dev))._asdict()
        if first is not None:
            for ln in (True, False):
                rec["mismatches" + ("" if ln else "_ln0")] = int(
                    (M.fused_ln_mlp_int8(x, fc1, fc2, ln=ln)
                     != first(x, fc1, fc2, 1e-6, ln, False, False)).sum().item())
            rec["first_ms"] = time_ms(lambda: first(x, fc1, fc2, 1e-6, True, False, False), reps=5)
        emit(**rec)
        del x


# K4f: the training shape (768 points x 16 frames) and the inference chunk
# (2,048 x 60), level 0 of the 384x512 input
K4F_SHAPES = ((768, 16), (2048, 60))
K4F_GROUPS = (2, 4, 8, 16, 30, 60)


def k4f_section(dev, g):
    """K4f (the raw float volume of the training path) at the training shape
    and the inference chunk, f32 and bf16: the wrapper's body (on an earlier
    checkout its first body) against corr_volume_float_plain (max |err| /
    max |ref|), its time, its device launches, the plain version's time
    (the window gather + torch.bmm with TF32 off: also the library chain),
    torch.bmm alone on windows gathered beforehand, the byte bound and the
    operation bounds (3xTF32's three tf32 products at the tf32 peak, the
    products at the f32 FMA peak and at the bf16 peak), the bound of the
    dtype (bytes against 3xTF32 in f32, against the bf16 peak in bf16), and
    where the checkout has k4f_plan the kernel at each frame group of its
    tasks."""
    Hh, W = 96, 128
    for n, T in K4F_SHAPES:
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g), dim=-1).to(dev)
        sup = torch.nn.functional.normalize(torch.randn(1, n, 49, 128, generator=g), dim=-1).to(dev)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, _ = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        Tp = starts.shape[1]
        mm = n * Tp * 64 * 49 * 128 * 2
        for dtype in (torch.float32, torch.bfloat16):
            fmf = corr_cuda.build_float_level(fm, 3, dtype)
            supf = sup.reshape(n, 49, 128).to(dtype).contiguous()
            fn = lambda: corr_cuda.corr_volume_float(fmf, supf, starts)  # noqa: E731
            vol = fn()
            ref = corr_cuda.corr_volume_float_plain(fmf, supf, starts)
            byte_ms = bound_ms(nbytes(fmf, supf, starts, vol), 0.0)
            ops = {"tf32_3x": 1e3 * 3 * mm / TF32_OPS, "f32_fma": 1e3 * mm / F32_OPS,
                   "bf16": 1e3 * mm / BF16_OPS}
            op_ms = ops["tf32_3x" if dtype == torch.float32 else "bf16"]
            rec = dict(kernel="K4f", points=n, frames=T, dtype=str(dtype).split(".")[-1],
                       rel_err=rel_err(vol, ref), elements_differing=int((vol != ref).sum().item()),
                       ms=time_ms(fn, reps=10),
                       device_launches=device_launches(fn),
                       plain_ms=time_ms(lambda: corr_cuda.corr_volume_float_plain(fmf, supf, starts),
                                        reps=3),
                       bound_bytes_ms=byte_ms, bound_ops_ms=ops, bound_ms=max(byte_ms, op_ms),
                       bound_by="bytes" if byte_ms >= op_ms else "operations")
            del vol, ref
            win = k4f_windows(fmf, starts)
            rec["bmm_only_ms"] = time_ms(lambda: torch.bmm(win, supf.transpose(1, 2)), reps=5)
            del win
            if hasattr(corr_cuda, "k4f_plan"):
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                rec["plan"] = corr_cuda.k4f_plan(n, Tp, dtype, sms)._asdict()
                rec["ms_by_group"] = {
                    gr: round(time_ms(lambda: corr_cuda._k4f_launch(
                        fmf, supf, starts, corr_cuda.k4f_plan(n, Tp, dtype, sms, gr)), reps=10), 4)
                    for gr in K4F_GROUPS if gr <= Tp}
            emit(**rec)
            del fmf, supf
        del fm, sup, starts


K10_ROWS = 604_800  # the micro-benchmark's rows (scripts/torch_ubench.py int8pallas)


def k10_section(dev, g):
    """K10 (LN + W8A8 dense) at the micro-benchmark's 604,800 bf16 rows in
    each (ln, affine, residual) combination (384 -> 1,152, or 384 -> 384
    with the residual): the wrapper's body (in bf16 K8's streamed body; on
    an earlier checkout the first body), bit for bit against the first body
    where the checkout keeps it beside, both times, the library chain's
    time, the device launches, the plan and the byte bound (x read once,
    the output written once, the weights)."""
    M = mlp_int8_cuda
    qkv, out_l = lin(g, dev, 3 * C, C), lin(g, dev, C, C)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    x = torch.randn(K10_ROWS, C, generator=g).to(dev, torch.bfloat16)
    first = getattr(M, "_ln_dense_first", None)
    for ln in (True, False):
        for affine in (False, True):
            for residual in (False, True):
                lin_ = out_l if residual else qkv
                N = lin_.w.shape[0]
                gm, bt = (gamma, beta) if affine else (None, None)
                kw = dict(ln=ln, gamma=gm, beta=bt, residual=residual)
                fn = lambda: M.fused_ln_dense_int8(x, lin_, **kw)  # noqa: E731
                rec = dict(kernel="K10", rows=K10_ROWS, N=N, ln=ln, affine=affine, residual=residual,
                           ms=time_ms(fn, reps=10), device_launches=device_launches(fn),
                           library_chain_ms=time_ms(lambda: k10_library_chain(
                               x, lin_, ln, gm, bt, residual), reps=3),
                           bound_ms=bound_ms(nbytes(x) + K10_ROWS * N * 2 + nbytes(*lin_),
                                             K10_ROWS * 2 * C * N / INT8_OPS))
                if hasattr(M, "k10_plan"):
                    rec["plan"] = M.k10_plan(K10_ROWS, N, x.dtype,
                                             torch.cuda.get_device_properties(dev)
                                             .multi_processor_count)._asdict()
                if first is not None:
                    ref = first(x, lin_, 1e-6, ln, gm, bt, residual, False)
                    rec["mismatches"] = int((fn() != ref).sum().item())
                    rec["first_ms"] = time_ms(lambda: first(x, lin_, 1e-6, ln, gm, bt, residual,
                                                            False), reps=5)
                    del ref
                emit(**rec)
    del x


if __name__ == "__main__":
    main()
