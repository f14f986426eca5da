"""On-card smoke run of the PyTorch/CUDA port (cotracker_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit; exits non-zero and prints no result
without them (or when the port's package is missing next to this file).
Phases, each raising on failure:
  1. header: versions, and the card's name and power limit from nvidia-smi;
  2. build: the hand-written kernels (csrc/*.cu), all nvcc runs in parallel;
  3. each kernel K1-K7 against its plain PyTorch version on the same inputs
     on the card, in bf16 at the shapes of both main paths (10,240 tracks,
     384 channels, 60 frames offline and 16 frames streaming; K4 at level 0,
     96x128, a 2,048-point chunk; K7 with the padded tracks' keys masked and
     once with every key masked), with errors against stated bounds,
     CUDA-event times, the bytes/operations bound and, for K5-K7, the time
     of the one PyTorch call that computes the same function
     (scaled_dot_product_attention: a yardstick, never called by the port);
  4. the offline main path: CoTrackerPredictor(fast=True) at full width
     (384x512, 4 levels, 3+3 blocks, iters=6) on a synthetic
     (1, 60, 3, 384, 512) video with a 100x100 grid of queries (10,000
     points x 60 frames), launch counters zeroed before and read after one
     forward (K1 36, K2 18, K3 18, K4 120); shapes, finiteness and snap-back
     checked; and the fast path against the plain PyTorch path of the same
     weights on a small input;
  5. streaming (a): CoTrackerOnlinePredictor(fast=True), the same grid on a
     64-frame video resident on the card, fed as the first step plus 7
     windows of 16 frames at step 8, twice through the same object; counters
     zeroed before and read after one window (K1 36, K2 18, K3 18, K4 120,
     K5-K7 0); shapes and finiteness checked, the second stream repeats the
     first; seconds per steady window, points*frames/s and peak memory;
  6. streaming (b): the same weights in CoTrackerThree with the W8A8 block
     kernels off and the attention cores on, driven through online_init /
     online_step over the same windows (K4 120, K5 36, K6 18, K7 18, K1-K3 0
     per window), its tracks within a stated band of (a)'s, and on a small
     input against the same model's plain path on the CPU.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa  # library_ms yardstick only

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, corr_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels import mlp_int8_cuda  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_OPS = 989e12
F32_OPS = 67e12

N_TRACKS, T_FRAMES, C, HID, HEADS, DH, V = 10240, 60, 384, 1536, 8, 48, 64
CHUNK, LVL0 = 2048, (96, 128)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=5):
    """Mean ms per call after one warm-up, with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """Least time (ms) for the work: bytes over HBM rate vs operations over
    the peak of their type (summed over types)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / rate for n, rate in ops)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check_close(name, out, ref, med_tol, max_tol):
    """bf16 bounds: median |err| <= med_tol * mean|ref| (bf16 rounding and
    int8 rounding ties), max |err| <= max_tol * max|ref|."""
    err = (out.float() - ref.float()).abs()
    med, mx = err.median().item(), err.max().item()
    lim_med = med_tol * ref.float().abs().mean().item()
    lim_max = max_tol * ref.float().abs().max().item()
    log(f"  {name}: max_abs_err {mx:.3e} (bound {lim_max:.3e}), median {med:.3e} "
        f"(bound {lim_med:.3e})")
    if not (math.isfinite(mx) and med <= lim_med and mx <= lim_max):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def lin(g, o, i, dev):
    w = torch.randn(o, i, generator=g) / math.sqrt(i)
    return mlp_int8_cuda.quantize_linear(w.to(dev), (0.05 * torch.randn(o, generator=g)).to(dev))


SRC_BLOCKS = "cotracker_tpu_torch/csrc/int8_blocks.cu"
SRC_CORR = "cotracker_tpu_torch/csrc/corr_window.cu"
SRC_CORES = "cotracker_tpu_torch/csrc/attention_cores.cu"
T_STREAM = 16  # the streaming window; T_FRAMES is the offline window
# K5-K7 against their plain versions in bf16: both sides round the
# probabilities and the output to bf16 at the same places, so the median
# error is within the rounding of the output (2^-8 of its mean) and the
# largest within two ulps of the largest output (2^-6)
CORE_TOL = (2.0**-8, 2.0**-6)
# streaming configuration (b) against (a) after 7 warm-started windows of 6
# iterations with random weights: W8A8 quantization noise separates them;
# (median, 90th percentile, max) of the per-point distance in pixels, about
# 2.5x what an H100 (700 W) measures with these seeds (0.41, 0.72, 1.81)
AB_BAND = (1.0, 2.0, 8.0)


def kernel_phase(dev):
    """Every kernel against its plain version at the offline (T=60) and the
    streaming (T=16) shape. One entry per kernel: K1-K4 carry the offline
    shape's numbers in the contract's keys and the streaming shape's in
    `*_t16`; K5-K7, which only the streaming path launches, the other way
    round (`*_t60`)."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    results = {}

    def entry(name, source, replaces, T, main_T, err, ms, plain_ms, bnd, library_ms=None):
        e = results.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=0,
            max_abs_err=0.0, ms=None, plain_ms=None, bound_ms=None, bound_by=None,
            library_ms=None, shape=f"{N_TRACKS} tracks x {main_T} frames, bf16"))
        sfx = "" if T == main_T else f"_t{T}"
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms, "bound_ms" + sfx: bnd[0],
                  "bound_by" + sfx: bnd[1], "library_ms" + sfx: library_ms})
        lib = "" if library_ms is None else f", library call {library_ms:.3f} ms"
        log(f"  {name} T={T}: {ms:.3f} ms (plain {plain_ms:.3f} ms{lib}, bound {bnd[0]:.3f} ms "
            f"by {bnd[1]})")

    tw = mlp_int8_cuda.TimeBlockWeights(lin(g, 3 * C, C, dev), lin(g, C, C, dev),
                                        lin(g, HID, C, dev), lin(g, C, HID, dev))
    sw = mlp_int8_cuda.SpaceBlockWeights(lin(g, C, C, dev), lin(g, C, C, dev),
                                         lin(g, HID, C, dev), lin(g, C, HID, dev))
    wkv = lin(g, 2 * C, C, dev)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    kbias = torch.zeros(N_TRACKS, device=dev)
    kbias[10000:] = attention_cuda.NEG_BIG  # the predictors' padded tracks
    all_masked = torch.full((N_TRACKS,), attention_cuda.NEG_BIG, device=dev)

    for T in (T_FRAMES, T_STREAM):
        rows = N_TRACKS * T
        x = torch.randn(N_TRACKS, T, C, generator=g).to(dev, bf)

        # K1: time block on the point tokens
        out = mlp_int8_cuda.fused_time_block_int8(x, tw, HEADS, DH)
        ref = mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH)
        err = check_close(f"K1 time block T={T}", out, ref, 0.01, 0.05)
        del out, ref
        entry("K1_time_block", SRC_BLOCKS, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:672",
              T, T_FRAMES, err,
              time_ms(lambda: mlp_int8_cuda.fused_time_block_int8(x, tw, HEADS, DH)),
              time_ms(lambda: mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH), reps=2),
              bound(2 * nbytes(x) + nbytes(*[t for q in tw for t in q]),
                    [(rows * 2 * C * (3 * C + C + 2 * HID), INT8_OPS),
                     (rows * HEADS * 4 * T * DH, BF16_OPS)]))

        # K2: points <- virtual block
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        out = mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH)
        ref = mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH)
        err = check_close(f"K2 space block T={T}", out, ref, 0.01, 0.05)
        del out, ref
        entry("K2_space_block", SRC_BLOCKS, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:418",
              T, T_FRAMES, err,
              time_ms(lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH)),
              time_ms(lambda: mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH), reps=2),
              bound(2 * nbytes(x) + nbytes(kv) + nbytes(*[t for q in sw for t in q]),
                    [(rows * 2 * C * (2 * C + 2 * HID), INT8_OPS),
                     (rows * HEADS * 4 * V * DH, BF16_OPS)]))

        # K3: virtual <- points with the projection
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        args = (q, x, wkv, gamma, beta, HEADS, DH, kbias)
        out = attention_cuda.fused_virtual_from_points_proj(*args)
        ref = attention_cuda.v2p_proj_plain(*args)
        err = check_close(f"K3 virtual<-points T={T}", out, ref, 0.01, 0.05)
        entry("K3_virtual_from_points_proj", SRC_BLOCKS,
              "cotracker_tpu/ops/kernels/attention_pallas.py:279", T, T_FRAMES, err,
              time_ms(lambda: attention_cuda.fused_virtual_from_points_proj(*args)),
              time_ms(lambda: attention_cuda.v2p_proj_plain(*args), reps=2),
              bound(nbytes(q, x, wkv.w, kbias, out),
                    [(rows * 2 * C * 2 * C, INT8_OPS),
                     (T * HEADS * V * N_TRACKS * 4 * DH, BF16_OPS)]))
        del out, ref

        # K5: time attention core; the library call is SDPA on head-major views
        kv5 = torch.randn(N_TRACKS, T, 2 * C, generator=g).to(dev, bf)
        out = attention_cuda.fused_time_attention(x, kv5, HEADS, DH)
        ref = attention_cuda.time_attention_plain(x, kv5, HEADS, DH)
        err = check_close(f"K5 time attention T={T}", out, ref, *CORE_TOL)
        hm = lambda t: t.unflatten(-1, (HEADS, DH)).transpose(-2, -3)  # (.., L, C) -> (.., H, L, D)
        lib = sdpa(hm(x), hm(kv5[..., :C]), hm(kv5[..., C:]))
        check_close(f"   SDPA vs K5 T={T}", lib.transpose(1, 2).flatten(-2), out, 2.0**-6, 2.0**-4)
        entry("K5_time_attention", SRC_CORES, "cotracker_tpu/ops/kernels/attention_pallas.py:50",
              T, T_STREAM, err,
              time_ms(lambda: attention_cuda.fused_time_attention(x, kv5, HEADS, DH)),
              time_ms(lambda: attention_cuda.time_attention_plain(x, kv5, HEADS, DH), reps=2),
              bound(nbytes(x, kv5, out), [(rows * HEADS * 4 * T * DH, BF16_OPS)]),
              time_ms(lambda: sdpa(hm(x), hm(kv5[..., :C]), hm(kv5[..., C:]))))
        del kv5, out, ref, lib

        # K6: points <- virtual core
        out = attention_cuda.fused_points_from_virtual(x, kv, HEADS, DH)
        ref = attention_cuda.p2v_plain(x, kv, HEADS, DH)
        err = check_close(f"K6 points<-virtual T={T}", out, ref, *CORE_TOL)
        q6 = hm(x.transpose(0, 1))  # (T, H, N, D)
        lib = sdpa(q6, hm(kv[..., :C]), hm(kv[..., C:]))
        check_close(f"   SDPA vs K6 T={T}", lib.permute(2, 0, 1, 3).flatten(-2), out,
                    2.0**-6, 2.0**-4)
        entry("K6_points_from_virtual", SRC_CORES,
              "cotracker_tpu/ops/kernels/attention_pallas.py:119", T, T_STREAM, err,
              time_ms(lambda: attention_cuda.fused_points_from_virtual(x, kv, HEADS, DH)),
              time_ms(lambda: attention_cuda.p2v_plain(x, kv, HEADS, DH), reps=2),
              bound(nbytes(x, kv, out), [(rows * HEADS * 4 * V * DH, BF16_OPS)]),
              time_ms(lambda: sdpa(q6, hm(kv[..., :C]), hm(kv[..., C:]))))
        del out, ref, lib, q6

        # K7: virtual <- points core, the last 240 keys masked; once all masked
        kv7 = torch.randn(N_TRACKS, T, 2 * C, generator=g).to(dev, bf)
        out = attention_cuda.fused_virtual_from_points(q, kv7, HEADS, DH, key_bias=kbias)
        ref = attention_cuda.v2p_plain(q, kv7, HEADS, DH, key_bias=kbias)
        err = check_close(f"K7 virtual<-points T={T}", out, ref, *CORE_TOL)
        dead = attention_cuda.fused_virtual_from_points(q, kv7, HEADS, DH, key_bias=all_masked)
        if not torch.isfinite(dead.float()).all():
            raise AssertionError("K7: non-finite output with every key masked")
        err = max(err, check_close(
            f"K7 all keys masked T={T}", dead,
            attention_cuda.v2p_plain(q, kv7, HEADS, DH, key_bias=all_masked), *CORE_TOL))
        k7t = kv7.transpose(0, 1)  # (T, N, 2C)
        mask = kbias.to(bf)[None, None, None, :]
        lib = sdpa(hm(q), hm(k7t[..., :C]), hm(k7t[..., C:]), attn_mask=mask)
        check_close(f"   SDPA vs K7 T={T}", lib.transpose(1, 2).flatten(-2), out, 2.0**-6, 2.0**-4)
        entry("K7_virtual_from_points", SRC_CORES,
              "cotracker_tpu/ops/kernels/attention_pallas.py:181", T, T_STREAM, err,
              time_ms(lambda: attention_cuda.fused_virtual_from_points(
                  q, kv7, HEADS, DH, key_bias=kbias)),
              time_ms(lambda: attention_cuda.v2p_plain(q, kv7, HEADS, DH, key_bias=kbias),
                      reps=2),
              bound(nbytes(q, kv7, kbias, out), [(T * HEADS * V * N_TRACKS * 4 * DH, BF16_OPS)]),
              time_ms(lambda: sdpa(hm(q), hm(k7t[..., :C]), hm(k7t[..., C:]), attn_mask=mask)))
        del x, kv, kv7, out, ref, dead, lib

        # K4: correlation volume, level 0, one chunk
        Hh, W = LVL0
        fm = torch.nn.functional.normalize(
            torch.randn(1, T, Hh, W, 128, generator=g).to(dev), dim=-1).to(bf)
        fmq = corr_cuda.build_int8_level(fm, 3)
        sup = torch.nn.functional.normalize(
            torch.randn(1, 49, CHUNK, 128, generator=g).to(dev), dim=-1).to(bf)
        supq, _ = corr_cuda.quantize_support(sup, bf)
        coords = (torch.rand(1, T, CHUNK, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, wxy = corr_cuda.level_operands(coords.to(bf), 1, T, Hh, W, 3)
        supq = supq.reshape(CHUNK, 49, 128)
        vol, scale = corr_cuda.corr_volume_int8(fmq, supq, starts, wxy)
        rvol, rscale = corr_cuda.corr_volume_plain(fmq, supq, starts, wxy)
        diff = (vol.int() - rvol.int()).abs()
        mism = (diff > 0).float().mean().item()
        serr = ((scale - rscale).abs() / rscale).max().item()
        log(f"  K4 corr volume T={T}: code mismatches {mism:.2e} (bound 1e-4), max code diff "
            f"{diff.max().item()} (bound 1), scale rel err {serr:.2e} (bound 1e-6)")
        if mism > 1e-4 or diff.max().item() > 1 or serr > 1e-6:
            raise AssertionError("K4: kernel disagrees with its plain version")
        Tp = starts.shape[1]
        entry("K4_corr_volume", SRC_CORR, "cotracker_tpu/ops/kernels/corr_pallas.py:105",
              T, T_FRAMES, float(diff.max().item()),
              time_ms(lambda: corr_cuda.corr_volume_int8(fmq, supq, starts, wxy)),
              time_ms(lambda: corr_cuda.corr_volume_plain(fmq, supq, starts, wxy), reps=2),
              bound(nbytes(fmq, supq, starts, wxy, vol, scale),
                    [(CHUNK * Tp * 64 * 49 * 128 * 2, INT8_OPS),
                     (CHUNK * Tp * 64 * 49 * 10, F32_OPS)]))
        del fm, fmq, sup, supq, vol, rvol, diff
    results["K4_corr_volume"]["shape"] = f"level 0 (96x128), {CHUNK} points x {T_FRAMES} frames"
    return [results[k] for k in sorted(results)]


def synthetic_video(T, H, W, dev):
    """A smooth random texture drifting a few pixels per frame, in [0, 255]."""
    g = torch.Generator().manual_seed(1)
    tex = torch.nn.functional.interpolate(
        torch.rand(1, 3, H // 8 + 8, W // 8 + 8, generator=g), scale_factor=8, mode="bicubic")
    frames = [tex[..., 2 * t % 48: 2 * t % 48 + H, t % 48: t % 48 + W] for t in range(T)]
    return (torch.stack(frames, dim=1).clamp(0, 1) * 255).to(dev)


def main_path(dev):
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    pred = CoTrackerPredictor(fast=True, device="cuda")
    video = synthetic_video(T_FRAMES, 384, 512, dev)
    grid = 100
    n_pad = -(-grid * grid // 512) * 512  # the predictor's fast-path track bucket
    n_chunks = -(-n_pad // pred.model.corr_chunk)
    expected = {**dict.fromkeys(WRAPPERS, 0), "K1_time_block": 36, "K2_space_block": 18,
                "K3_virtual_from_points_proj": 18, "K4_corr_volume": 4 * 6 * n_chunks}
    t0 = time.perf_counter()
    pred(video, grid_size=grid)  # warm-up
    torch.cuda.synchronize()
    log(f"  warm-up forward {time.perf_counter() - t0:.2f} s")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks, vis = pred(video, grid_size=grid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    n = grid * grid
    log(f"  forward {dt:.3f} s for {n} points x {T_FRAMES} frames: "
        f"{n * T_FRAMES / dt:.0f} points*frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  launches per forward {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the main path did not launch every kernel as expected")
    if tuple(tracks.shape) != (1, T_FRAMES, n, 2) or tuple(vis.shape) != (1, T_FRAMES, n):
        raise AssertionError(f"shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
    if not torch.isfinite(tracks).all():
        raise AssertionError("non-finite tracks")
    from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid

    q = get_points_on_a_grid(grid, (384, 512)).to(dev)[0]
    if not (torch.equal(tracks[0, 0], q) and bool(vis[0, 0].all())):
        raise AssertionError("snap-back: frame-0 tracks differ from the grid queries")
    log("  shapes, finiteness and snap-back ok")

    # the fast path against the plain PyTorch path of the same weights, small input
    small = CoTrackerThree(model_resolution=(64, 96), **{
        k: getattr(pred.model, k) for k in ("dtype", "corr_chunk", "fold_input_proj", "kernels")})
    small.load_state_dict(pred.model.state_dict())
    small = small.to(dev).eval()
    g = torch.Generator().manual_seed(2)
    v = synthetic_video(8, 64, 96, dev).permute(0, 1, 3, 4, 2)
    qs = torch.stack([torch.zeros(256), torch.rand(256, generator=g) * 95,
                      torch.rand(256, generator=g) * 63], -1)[None].to(dev)
    with torch.inference_mode():
        fast = small(v, qs, iters=1)
        plain = small.cpu()(v.cpu(), qs.cpu(), iters=1)
    err = (fast[0].float().cpu() - plain[0].float()).abs()
    verr = max((a.float().cpu() - b.float()).abs().max().item() for a, b in zip(fast[1:3], plain[1:3]))
    log(f"  small input, kernels on the card vs plain path on the CPU (bf16, iters=1): "
        f"coords median {err.median().item():.3e} px max {err.max().item():.3e} px "
        f"(bounds 0.5, 4), vis/conf max {verr:.3e} (bound 0.1)")
    if not (err.median().item() <= 0.5 and err.max().item() <= 4.0 and verr <= 0.1):
        raise AssertionError("fast path disagrees with the plain path")
    return launches, n * T_FRAMES / dt


WRAPPERS = {
    "K1_time_block": mlp_int8_cuda.fused_time_block_int8,
    "K2_space_block": mlp_int8_cuda.fused_space_block_int8,
    "K3_virtual_from_points_proj": attention_cuda.fused_virtual_from_points_proj,
    "K4_corr_volume": corr_cuda.corr_volume_int8,
    "K5_time_attention": attention_cuda.fused_time_attention,
    "K6_points_from_virtual": attention_cuda.fused_points_from_virtual,
    "K7_virtual_from_points": attention_cuda.fused_virtual_from_points,
}


def zero_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in WRAPPERS.items()}


def drive_stream(step_fn, n_windows, n_points, step, counted_window=3):
    """Feed `n_windows` windows through step_fn(ind) -> (tracks, vis), each
    synchronized and timed; the launch counts are zeroed before window
    `counted_window` and read after it. Returns the last outputs, the
    counts, and the mean seconds of the steady windows 2..n-1."""
    secs, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for w in range(n_windows):
        if w == counted_window:
            zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(w * step)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if w == counted_window:
            counts = read_counts()
    steady = sum(secs[1:-1]) / len(secs[1:-1])
    log(f"  seconds per window {[round(x, 3) for x in secs]}; steady windows 2-{n_windows - 1}: "
        f"{steady:.4f} s = {n_points * step / steady:.0f} points*frames/s of new frames; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return out, counts, steady


def check_stream(name, tracks, vis, frames, n, counts, expected):
    log(f"  launches per window {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{name}: a window did not launch the kernels as expected")
    if tuple(tracks.shape) != (1, frames, n, 2) or tuple(vis.shape) != (1, frames, n):
        raise AssertionError(f"{name}: shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
    if not torch.isfinite(tracks).all():
        raise AssertionError(f"{name}: non-finite tracks")


def px_stats(a, b):
    err = (a.float() - b.float()).norm(dim=-1).flatten()
    return err.median().item(), err.quantile(0.9).item(), err.max().item()


def streaming_paths(dev):
    """Streaming tracking in both kernel configurations at 10,000 points,
    384x512, 64 frames as 7 windows of 16 at step 8, iters=6: (a) the online
    predictor's fast path (K1-K4), (b) the same weights with the W8A8 block
    kernels off and the attention cores on (K4-K7), driven through
    online_init / online_step."""
    from cotracker_tpu_torch import CoTrackerOnlinePredictor
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

    grid, frames, S = 100, 64, T_STREAM
    n, step, n_windows = grid * grid, S // 2, 7
    video = synthetic_video(frames, 384, 512, dev)
    pred = CoTrackerOnlinePredictor(fast=True, device="cuda", capacity=frames)
    n_pad = -(-n // 512) * 512
    k4 = 4 * 6 * -(-n_pad // pred.model.corr_chunk)
    zeros = dict.fromkeys(WRAPPERS, 0)

    log("streaming (a): CoTrackerOnlinePredictor(fast=True), K1-K4:")
    results = []
    for stream in (1, 2):  # the second stream resets the state of the same object
        pred(video[:, :1], is_first_step=True, grid_size=grid)
        (tracks_a, vis_a), counts_a, steady_a = drive_stream(
            lambda ind: pred(video[:, ind : ind + S]), n_windows, n, step)
        results.append((tracks_a, vis_a))
        if pred.frames_seen != frames:
            raise AssertionError(f"frames_seen {pred.frames_seen}")
        check_stream("streaming (a)", tracks_a, vis_a, frames, n, counts_a,
                     {**zeros, "K1_time_block": 36, "K2_space_block": 18,
                      "K3_virtual_from_points_proj": 18, "K4_corr_volume": k4})
    rep = (results[0][0] - results[1][0]).abs().max().item()
    log(f"  second stream through the same predictor: max |tracks difference| {rep:.3e} px "
        f"(bound 1e-3), visibility equal: {torch.equal(results[0][1], results[1][1])}")
    if not rep <= 1e-3:
        raise AssertionError("the second stream does not repeat the first")

    log("streaming (b): online_init/online_step, W8A8 off, attention cores on, K4-K7:")
    kw = dict(window_len=S, dtype=torch.bfloat16, corr_chunk=2048, fold_input_proj=True,
              kernels=True, attn_quant_int8=False)
    model_b = CoTrackerThree(**kw)
    model_b.load_state_dict(pred.model.state_dict())
    model_b = model_b.to(dev).eval()
    video_cl = video.permute(0, 1, 3, 4, 2)  # already at the model resolution
    box = {"state": model_b.online_init(1, n_pad, frames)}

    def step_b(ind):
        with torch.inference_mode():
            box["state"], coords, vis, conf = model_b.online_step(
                box["state"], video_cl[:, ind : ind + S], pred._queries, iters=6,
                track_mask=pred._track_mask)
        return coords[:, :, :n], (vis * conf)[:, :, :n] > 0.6

    (tracks_b, vis_b), counts_b, steady_b = drive_stream(step_b, n_windows, n, step)
    check_stream("streaming (b)", tracks_b, vis_b, frames, n, counts_b,
                 {**zeros, "K4_corr_volume": k4, "K5_time_attention": 36,
                  "K6_points_from_virtual": 18, "K7_virtual_from_points": 18})

    med, p90, mx = px_stats(tracks_b, tracks_a)
    agree = (vis_b == vis_a).float().mean().item()
    log(f"  (b) against (a), W8A8 noise apart: |tracks difference| median {med:.3f} px, "
        f"p90 {p90:.3f} px, max {mx:.3f} px (bounds {AB_BAND}), visibility agreement {agree:.4f}")
    if not (med <= AB_BAND[0] and p90 <= AB_BAND[1] and mx <= AB_BAND[2]):
        raise AssertionError("configuration (b) is outside its band around (a)")

    # configuration (b) on the card against the same model's plain path on the
    # CPU, small input: 64x96, 256 tracks, 3 windows of 16 frames, iters=1
    small = CoTrackerThree(model_resolution=(64, 96), **kw)
    small.load_state_dict(pred.model.state_dict())
    g = torch.Generator().manual_seed(2)
    v = synthetic_video(32, 64, 96, dev).permute(0, 1, 3, 4, 2)
    qs = torch.stack([torch.randint(0, 30, (256,), generator=g).float(),
                      torch.rand(256, generator=g) * 95, torch.rand(256, generator=g) * 63],
                     -1)[None]
    outs = {}
    for where in ("cuda", "cpu"):
        small = small.to(where).eval()
        state = small.online_init(1, 256, 32)
        with torch.inference_mode():
            for ind in (0, 8, 16):
                state, *out = small.online_step(state, v[:, ind : ind + S].to(where),
                                                qs.to(where), iters=1)
        outs[where] = [o.float().cpu() for o in out]
    med, p90, mx = px_stats(outs["cuda"][0], outs["cpu"][0])
    verr = max((a - b).abs().max().item() for a, b in zip(outs["cuda"][1:], outs["cpu"][1:]))
    log(f"  small input, (b) on the card vs its plain path on the CPU (bf16, 3 windows, "
        f"iters=1): coords median {med:.3e} px max {mx:.3e} px (bounds 0.5, 4), vis/conf max "
        f"{verr:.3e} (bound 0.1)")
    if not (med <= 0.5 and mx <= 4.0 and verr <= 0.1):
        raise AssertionError("configuration (b) disagrees with its plain path")
    return counts_a, counts_b, n * step / steady_a, n * step / steady_b


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)

    log("build:")
    seconds, logs = _build.build_all()
    log(f"  {len(logs)} of {len(_build.SOURCES)} sources compiled in {seconds:.1f} s "
        "(parallel nvcc; the others were cached)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_build.log"), "w") as f:
        for name, text in logs.items():
            f.write(f"--- {name}.cu ---\n{text}\n")

    log("kernels vs plain versions (bf16, offline T=60 and streaming T=16 shapes):")
    kernels = kernel_phase(dev)
    torch.cuda.empty_cache()

    log("offline main path: CoTrackerPredictor(fast=True), 384x512, iters=6:")
    launches, pfs = main_path(dev)
    torch.cuda.empty_cache()
    counts_a, counts_b, pfs_a, pfs_b = streaming_paths(dev)
    for k in kernels:
        # K1-K4 from the offline forward, K5-K7 from a window of streaming (b)
        k["launches"] = launches[k["name"]] or counts_b[k["name"]]
        k["launches_per_window"] = {"a": counts_a[k["name"]], "b": counts_b[k["name"]]}
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was never launched on a main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"points*frames/s: offline {pfs:.0f}, streaming (a) {pfs_a:.0f}, streaming (b) {pfs_b:.0f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
