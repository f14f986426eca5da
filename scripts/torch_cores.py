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

    python3 scripts/torch_cores.py              # the main paths' shapes
    python3 scripts/torch_cores.py --sweep      # also K7 at each key-range
                                                # count, K5's register and
                                                # two-pass routes side by side
    python3 scripts/torch_cores.py --only k4 k9 # some sections
    python3 scripts/torch_cores.py --only k2 k3 --root build/parent
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

C, H, D, V, HID = 384, 8, 48, 64, 1536
HBM_BPS, INT8_OPS, BF16_OPS, F32_OPS = 3.35e12, 1979e12, 989e12, 67e12  # H100 SXM, dense, 700 W
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


SECTIONS = ("k4", "k9", "cores", "k1", "k2", "k3")


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
               k1=k1_section, k2=k2_section, k3=k3_section)
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


if __name__ == "__main__":
    main()
