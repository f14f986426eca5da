"""On-card smoke run of the PyTorch/CUDA port (cotracker_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit; exits non-zero and prints no result
without them (or when the port's package is missing next to this file).
Phases, each raising on failure:
  1. header: versions, and the card's name and power limit from nvidia-smi;
  2. build: the hand-written kernels (csrc/*.cu), all nvcc runs in parallel;
  3. each kernel K1-K9 against its plain PyTorch version on the same inputs
     on the card, in bf16 at the shapes of both main paths (10,240 tracks,
     384 channels, 60 frames offline and 16 frames streaming; K4 at level 0,
     96x128, a 2,048-point chunk, then at levels 1-3 of the offline window
     and at level 0 of 250 frames (the long forward's chunk: two passes),
     its codes and scales bit-identical to its plain version at every
     shape; K7 with the padded tracks' keys masked and
     once with every key masked), with errors against stated bounds,
     CUDA-event times, the bytes/operations bound and, for K5-K7, the time
     of the one PyTorch call that computes the same function
     (scaled_dot_product_attention: a yardstick, never called by the port);
     K1 in bf16 is two launches (counted from a captured CUDA graph) and
     the launch chain it replaced (nine launches, kept as the f32 route) is
     timed beside it; so are K2 in bf16 (the fused front, then K1's tail:
     two launches; its chain nine) and K3 in bf16 (one fused kernel and the
     merge of its key ranges; its chain four), each also beside its library
     chain (the block's products through torch._int_mm plus one
     scaled_dot_product_attention, on codes of the same shapes: a
     yardstick, never called by the port), and K3 at 70,656 points x 16
     frames too; K5 in bf16 is the tensor-core time core (k5_plan's route);
     then the training kernels K4r (raw int8 volume) and K4f (raw float
     volume) at level 0 at the training shape (768 points x 16 frames, f32)
     and the inference chunk (2,048 points x 60 frames): K4r's codes and
     scales bit-identical to its plain version, K4f within a float32 bound;
     then K7 at the quasi-dense key count (70,656 padded tracks x 16 frames,
     the keys of each frame and head shared by several blocks and merged;
     once with every key masked) and K5 on its other bf16 routes (256
     tracks x 640 frames: the long route; 2,560 and 64 tracks x 250, the
     long forward's shapes: four key chunks in registers; 256 x 400: two
     passes over the staged keys); then K8 (LN + W8A8
     q|kv) and K9 (W8A8 out + MLP), the two halves of the
     time block's split, in bf16 at the long path's point tokens (2,048
     and 2,560 tracks x 250 frames) and virtual tokens (64 x 250); K8 in
     bf16 is the streamed body (persistent blocks on a weight stream),
     held bit for bit to its PR 4 body, which is timed beside it; K9 in
     bf16 is K1's streamed tail with K9's prologue;
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
     input against the same model's plain path on the CPU;
  7. training at full width: train(args, dataset=...) of the online model
     (384x512, 24-frame clips in windows of 16, 768 tracks, iters=4, f32,
     K4r + autograd wrapper, remat, AdamW) on an in-memory clip of a texture
     moving at constant velocity, 8 steps with a checkpoint at step 4, then
     the step-8 checkpoint removed and a second train() that auto-resumes at
     step 4 and ends at step 8 with the same losses; losses finite and
     decreasing, K4r 64 launches per step (4 levels x 4 iterations x 2
     windows x 2: the checkpointed forward runs again in the backward), K4f
     and K1-K7 none; ms per step and peak memory. Then 3 steps of the
     offline model (one 16-frame window, K4r 32 per step), 2 steps of the
     online model with K4f instead of K4r (corr_quant_int8=False, K4f 64 per
     step, K4r none) and 2 with COTRACKER_CORR_FUSE_MLP1=1 (the wrapper's
     forward through K4m: K4m 64 per step, K4r none);
  8. gradients on the card: one batch at 64x96, 8 frames, 32 tracks,
     iters=2 through the K4r, the K4f and the plain training models of the
     same weights; the loss within rtol 1e-3 and every gradient within rtol
     2e-2, atol max(2e-3 x its largest, 1e-7) of the plain model's (the
     bounds of tests/test_training.py for the JAX package's kernel model);
  9. the long offline path: CoTrackerPredictor(fast=True) at full width on a
     (1, 250, 3, 384, 512) video with a 50x50 grid (2,500 points, padded to
     2,560), counters zeroed before and read after one forward: videos over
     128 frames take the time block's split, K8 36, K5 36, K9 36, K1 0, K2 18,
     K3 18, K4 48; shapes, finiteness, snap-back, seconds per forward,
     points*frames/s and peak memory;
 10. evaluation: a synthetic TAP-Vid DAVIS pickle (a texture moving at
     constant velocity, from a seed) with sequence A (250 frames, 231 tracks:
     with the 5x5 grid 256 tracks, the track gate on, both token kinds
     split) and B (80 frames, 40 tracks: 128 padded tracks, the track gate
     off, K5 between plain projections, plain space blocks), through
     evaluate.run_eval(fast=True) in joint mode, launch counts asserted per
     sequence, metric keys finite, expconfig.json and result_eval_.json
     written; then the single-point protocol on three of B's queries;
 11. the kernels of the four variant switches (ops/kernels/variants.py)
     against their plain versions in bf16: K4m (correlation + combine +
     per-point quantization + MLP1; two launches: the code rows on K4's
     cluster tiling, then MLP1 on 128-row tiles) at level 0, 2,048 points x
     16 and x 60 frames and 256 points x 80 frames (two passes), its code
     rows, scales and rows bit-identical to its plain version, with its
     first body (PR 5) and the K4 + int8-MLP1 chain timed beside it; K11
     (the all-frames points<-virtual block: K2's function on K2's two
     launches) at 10,240 and 70,656 tracks x 16 frames, bit-identical to
     K2 with K2 and K2's library chain timed beside it; K10 in each flag
     combination; K12 (8-block clusters) with the LN on and off at 604,800
     rows, bit-identical to its first body, with the first body and a
     library chain (LN in torch, torch._int_mm for fc1 and fc2) timed
     beside it and its device launches a call; then
     every W8A8 body (K1, K2, K8-K12) in each variant mode (bf16 LayerNorm,
     GELU-quant fold) at 2,048 tracks x 16 frames;
 12. quasi-dense streaming: CoTrackerOnlinePredictor(fast=True) with a
     265x265 grid (70,225 points, 70,656 padded), 384x512, windows of 16
     at step 8, iters=6, a 48-frame video (5 windows), (a) the variants off
     (K4 840, K2 18, K1 36, K3 18 in the fourth window) and (c) all four on
     (K4m 840, K11 18, K1 36, K3 18, K4 and K2 0); seconds per steady
     window, points*frames/s of new frames, peak memory; (c) within 1 px
     (median) of (a);
 13. the offline bench workload with all four variants on: K4m 120, K2 18
     (no K11 at 60 frames), K1 36, K3 18, K4 0; seconds and points*frames/s;
 14. the micro-benchmark entry point, scripts/torch_ubench.py int8pallas
     corr, in this process: K10 and K12 9 launches each (a warm-up and 8
     timed), K4 and K4m 18;
 15. (run after phase 9) a 600-frame video (384x512, a 16x16 grid: 256
     points, 512 padded) through CoTrackerPredictor(fast=True), one forward:
     past K5's 512-frame short route, K8 36, K5 36, K9 36, K2 18, K3 18, K4
     24; shapes, finiteness, snap-back.
No phase is cut in depth. The line before the last is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa  # library_ms yardstick only

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, corr_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels import mlp_int8_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels.variants import ENV, KernelVariants  # noqa: E402
from cotracker_tpu_torch.utils.profiling import device_launches  # noqa: E402

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


def library_chain(gd, dev, rows, widths, attn):
    """ms of a W8A8 block's products through torch._int_mm on int8 codes of
    their shapes ((K, N) each, `rows` rows) and of one SDPA call `attn`:
    the library yardstick of a fused block (no quantization or epilogue),
    never called by the port. Returns (sum, parts)."""
    parts = []
    for k, n in widths:
        a8 = torch.randint(-127, 128, (rows, k), dtype=torch.int8, device=dev, generator=gd)
        w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gd)
        parts.append(time_ms(lambda: torch._int_mm(a8, w8.t())))
        del a8, w8
    parts.append(time_ms(attn))
    return sum(parts), parts


def k3_library_chain(gd, dev, q, x, bias):
    """K3's library chain: the k|v product of x's rows through torch._int_mm,
    then SDPA of the frames' queries over the point keys|values (bf16, the
    key bias as the mask)."""
    T, N = q.shape[0], x.shape[0]
    kv = torch.randn(N, T, 2 * C, device=dev, generator=gd).to(torch.bfloat16).transpose(0, 1)
    mask = bias.to(torch.bfloat16)[None, None, None, :]
    out = library_chain(gd, dev, N * T, ((C, 2 * C),),
                        lambda: sdpa(hm(q), hm(kv[..., :C]), hm(kv[..., C:]), attn_mask=mask))
    del kv
    return out


SRC_BLOCKS = "cotracker_tpu_torch/csrc/int8_blocks.cu"
SRC_K1 = "cotracker_tpu_torch/csrc/int8_time_block.cu"  # K1, K9 and K2 in bf16
SRC_K3 = "cotracker_tpu_torch/csrc/int8_v2p_proj.cu"
SRC_CORR = "cotracker_tpu_torch/csrc/corr_window.cu"
SRC_CORES = "cotracker_tpu_torch/csrc/attention_cores.cu"
T_STREAM = 16  # the streaming window; T_FRAMES is the offline window
# K5-K7 against their plain versions in bf16: both sides round the
# probabilities and the output to bf16 at the same places, so the median
# error is within the rounding of the output (2^-8 of its mean) and the
# largest within two ulps of the largest output (2^-6)
CORE_TOL = (2.0**-8, 2.0**-6)
# K4f against its plain version: float32 sums of 128 products of unit-norm
# features in another order (FMA chains against cuBLAS's tiling); 1e-5 of
# the largest |g| is ~80 float32 ulps of it
K4F_TOL = 1e-5
# the training shape (768 points x 16 frames) and the inference chunk
TRAIN_SHAPE, INFER_SHAPE = (768, 16), (CHUNK, T_FRAMES)
# streaming configuration (b) against (a) after 7 warm-started windows of 6
# iterations with random weights: W8A8 quantization noise separates them;
# (median, 90th percentile, max) of the per-point distance in pixels, about
# 2.5x what an H100 (700 W) measures with these seeds (0.41, 0.72, 1.81)
AB_BAND = (1.0, 2.0, 8.0)
# K5 on each bf16 route of k5_plan beyond the streaming and offline shapes,
# against its plain version: (tracks, frames, route, register key chunks,
# key suffix) -- the long route past 512 frames, the long forward's point
# and virtual tokens (four key chunks in registers) and the two-pass route
K5_ROUTES = ((256, 640, "long", 0, "_t640"), (2560, 250, "tc", 4, "_m2560_t250"),
             (64, 250, "tc", 4, "_m64_t250"), (256, 400, "tc", 0, "_t400"))
# the offline predictor on a video past K5's 512-frame short route
VIDEO600_T, VIDEO600_GRID = 600, 16


def hm(t):
    """(..., L, C) -> (..., H, L, D): the head-major view SDPA takes."""
    return t.unflatten(-1, (HEADS, DH)).transpose(-2, -3)


# K4's shapes beyond level 0 of the offline and streaming windows: (key
# suffix, level size, frames): the 384x512 input's levels 1-3 (stride 4, then
# 2x pooling) at the offline window, level 0 at the long forward's 250 frames
K4_MORE = (("_l1", (48, 64), 60), ("_l2", (24, 32), 60), ("_l3", (12, 16), 60),
           ("_t250", LVL0, 250))
K4_PLAIN_POINTS = 256  # points a plain K4 call takes (its f32 window gather grows with T)


def k4_operands(g, dev, hw, T):
    """K4's operands at one pyramid level for a CHUNK-point chunk: unit
    features and support in bf16, coordinates uniform over the level."""
    bf = torch.bfloat16
    Hh, W = hw
    fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g).to(dev), dim=-1)
    fmq = corr_cuda.build_int8_level(fm.to(bf), 3)
    del fm
    sup = torch.nn.functional.normalize(
        torch.randn(1, 49, CHUNK, 128, generator=g).to(dev), dim=-1).to(bf)
    supq, _ = corr_cuda.quantize_support(sup, bf)
    coords = (torch.rand(1, T, CHUNK, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
    starts, wxy = corr_cuda.level_operands(coords.to(bf), 1, T, Hh, W, 3)
    return fmq, supq.reshape(CHUNK, 49, 128), starts, wxy


def k4_plain(fmq, supq, starts, wxy):
    """corr_volume_plain, K4_PLAIN_POINTS points at a time (per point
    independent: the same function)."""
    parts = [corr_cuda.corr_volume_plain(fmq, supq[i:i + K4_PLAIN_POINTS],
                                         starts[i:i + K4_PLAIN_POINTS], wxy[i:i + K4_PLAIN_POINTS])
             for i in range(0, supq.shape[0], K4_PLAIN_POINTS)]
    return torch.cat([v for v, _ in parts]), torch.cat([s for _, s in parts])


def k4_exact(what, ops):
    """K4 against its plain version: codes and scales bit-identical (the two
    share every rounding); returns the kernel's output."""
    vol, scale = corr_cuda.corr_volume_int8(*ops)
    rvol, rscale = k4_plain(*ops)
    codes, scales = int((vol != rvol).sum().item()), int((scale != rscale).sum().item())
    log(f"  K4 corr volume {what}: {codes} codes and {scales} scales differ (bound 0)")
    if codes or scales:
        raise AssertionError("K4: kernel disagrees with its plain version")
    return vol, scale


def k4_bound(ops, vol, scale):
    fmq, supq, starts, wxy = ops
    n = CHUNK * starts.shape[1] * 64 * 49
    return bound(nbytes(fmq, supq, starts, wxy, vol, scale),
                 [(n * 128 * 2, INT8_OPS), (n * 10, F32_OPS)])


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

    def fused_extras(name, T, lib_parts, chain, fused):
        """A redesigned block's launch chain (its earlier body, kept as its f32
        route) on the same inputs and its device launches a call."""
        sfx = "" if T == T_FRAMES else f"_t{T}"
        e = results[name]
        e.update({"chain_ms" + sfx: time_ms(chain, reps=2),
                  "device_launches" + sfx: device_launches(fused),
                  "library_chain_parts_ms" + sfx: lib_parts})
        log(f"  {name} T={T}: the launch chain it replaced {e['chain_ms' + sfx]:.3f} ms; "
            f"{e['device_launches' + sfx]} device launches a call; library chain "
            f"{sum(lib_parts):.3f} ms ({', '.join(f'{t:.3f}' for t in lib_parts)})")

    gd = torch.Generator(device=dev).manual_seed(0)  # the library chains' int8 codes
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
        entry("K1_time_block", SRC_K1, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:672",
              T, T_FRAMES, err,
              time_ms(lambda: mlp_int8_cuda.fused_time_block_int8(x, tw, HEADS, DH)),
              time_ms(lambda: mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH), reps=2),
              bound(2 * nbytes(x) + nbytes(*[t for q in tw for t in q]),
                    [(rows * 2 * C * (3 * C + C + 2 * HID), INT8_OPS),
                     (rows * HEADS * 4 * T * DH, BF16_OPS)]))
        sfx = "" if T == T_FRAMES else f"_t{T}"
        results["K1_time_block"].update({
            "chain_ms" + sfx: time_ms(lambda: mlp_int8_cuda._time_block_chain(
                x, tw, HEADS, DH, 1e-6, False, False), reps=2),
            "device_launches" + sfx: device_launches(
                lambda: mlp_int8_cuda.fused_time_block_int8(x, tw, HEADS, DH))})
        log(f"  K1 T={T}: the launch chain it replaced {results['K1_time_block']['chain_ms' + sfx]:.3f} ms; "
            f"{results['K1_time_block']['device_launches' + sfx]} device launches a call")

        # K2: points <- virtual block; beside it the launch chain it replaced (kept
        # as the f32 route) and its library chain
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        out = mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH)
        ref = mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH)
        err = check_close(f"K2 space block T={T}", out, ref, 0.01, 0.05)
        del out, ref
        q6 = hm(x.transpose(0, 1))  # (T, H, N, D)
        lib_ms, lib_parts = library_chain(
            gd, dev, rows, ((C, C), (C, C), (C, HID), (HID, C)),
            lambda: sdpa(q6, hm(kv[..., :C]), hm(kv[..., C:])))
        entry("K2_space_block", SRC_K1, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:418",
              T, T_FRAMES, err,
              time_ms(lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH)),
              time_ms(lambda: mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH), reps=2),
              bound(2 * nbytes(x) + nbytes(kv) + nbytes(*[t for q in sw for t in q]),
                    [(rows * 2 * C * (2 * C + 2 * HID), INT8_OPS),
                     (rows * HEADS * 4 * V * DH, BF16_OPS)]), lib_ms)
        fused_extras("K2_space_block", T, lib_parts,
                     lambda: mlp_int8_cuda._space_block_chain(x, kv, sw, HEADS, DH, 1e-6, False,
                                                              False),
                     lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH))
        del q6

        # K3: virtual <- points with the projection; beside it the chain it replaced
        # (kept as the f32 route) and its library chain
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        args = (q, x, wkv, gamma, beta, HEADS, DH, kbias)
        out = attention_cuda.fused_virtual_from_points_proj(*args)
        ref = attention_cuda.v2p_proj_plain(*args)
        err = check_close(f"K3 virtual<-points T={T}", out, ref, 0.01, 0.05)
        lib_ms, lib_parts = k3_library_chain(gd, dev, q, x, kbias)
        entry("K3_virtual_from_points_proj", SRC_K3,
              "cotracker_tpu/ops/kernels/attention_pallas.py:279", T, T_FRAMES, err,
              time_ms(lambda: attention_cuda.fused_virtual_from_points_proj(*args)),
              time_ms(lambda: attention_cuda.v2p_proj_plain(*args), reps=2),
              bound(nbytes(q, x, wkv.w, kbias, out),
                    [(rows * 2 * C * 2 * C, INT8_OPS),
                     (T * HEADS * V * N_TRACKS * 4 * DH, BF16_OPS)]), lib_ms)
        fused_extras("K3_virtual_from_points_proj", T, lib_parts,
                     lambda: attention_cuda._v2p_proj_chain(*args, 1e-5),
                     lambda: attention_cuda.fused_virtual_from_points_proj(*args))
        del out, ref

        # K5: time attention core; the library call is SDPA on head-major views
        kv5 = torch.randn(N_TRACKS, T, 2 * C, generator=g).to(dev, bf)
        out = attention_cuda.fused_time_attention(x, kv5, HEADS, DH)
        ref = attention_cuda.time_attention_plain(x, kv5, HEADS, DH)
        err = check_close(f"K5 time attention T={T}", out, ref, *CORE_TOL)
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
        ops = k4_operands(g, dev, LVL0, T)
        vol, scale = k4_exact(f"level 0, T={T}", ops)
        entry("K4_corr_volume", SRC_CORR, "cotracker_tpu/ops/kernels/corr_pallas.py:105",
              T, T_FRAMES, 0.0, time_ms(lambda: corr_cuda.corr_volume_int8(*ops)),
              time_ms(lambda: k4_plain(*ops), reps=2), k4_bound(ops, vol, scale))
        del ops, vol, scale
    e = results["K4_corr_volume"]
    e["shape"] = f"level 0 (96x128), {CHUNK} points x {T_FRAMES} frames"
    # K4 at the forwards' other shapes: levels 1-3 of the offline window and
    # level 0 of the long forward's 250 frames (k4_plan's two-pass route)
    for sfx, hw, T in K4_MORE:
        ops = k4_operands(g, dev, hw, T)
        vol, scale = k4_exact(f"{hw[0]}x{hw[1]}, T={T}", ops)
        bnd = k4_bound(ops, vol, scale)
        e.update({"ms" + sfx: time_ms(lambda: corr_cuda.corr_volume_int8(*ops)),
                  "plain_ms" + sfx: time_ms(lambda: k4_plain(*ops), reps=1),
                  "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1],
                  "plan" + sfx: corr_cuda.k4_plan(CHUNK, ops[2].shape[1])._asdict(),
                  "shape" + sfx: f"{hw[0]}x{hw[1]}, {CHUNK} points x {T} frames"})
        log(f"  K4_corr_volume {e['shape' + sfx]}: {e['ms' + sfx]:.3f} ms (plain "
            f"{e['plain_ms' + sfx]:.3f} ms, bound {bnd[0]:.3f} ms by {bnd[1]})")
        del ops, vol, scale

    # K7 at the quasi-dense key count (K3's chain in a quasi-dense window):
    # several blocks share each (frame, head)'s keys, then the merge
    N, T = QD_PAD, T_STREAM
    q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
    kv7 = torch.randn(N, T, 2 * C, generator=g).to(dev, bf)
    qbias = torch.zeros(N, device=dev)
    qbias[QD_GRID**2:] = attention_cuda.NEG_BIG
    out = attention_cuda.fused_virtual_from_points(q, kv7, HEADS, DH, key_bias=qbias)
    err = check_close(f"K7 virtual<-points {N} tracks x {T}", out,
                      attention_cuda.v2p_plain(q, kv7, HEADS, DH, key_bias=qbias), *CORE_TOL)
    dead = attention_cuda.fused_virtual_from_points(
        q, kv7, HEADS, DH, key_bias=torch.full((N,), attention_cuda.NEG_BIG, device=dev))
    if not torch.isfinite(dead.float()).all():
        raise AssertionError("K7: non-finite output with every key masked")
    k7t = kv7.transpose(0, 1)
    mask = qbias.to(bf)[None, None, None, :]
    e = results["K7_virtual_from_points"]
    e["max_abs_err"] = max(e["max_abs_err"], err)
    e.update(
        splits_n70656=attention_cuda.v2p_splits(N, T, V, HEADS, dev),
        ms_n70656=time_ms(lambda: attention_cuda.fused_virtual_from_points(
            q, kv7, HEADS, DH, key_bias=qbias)),
        bound_ms_n70656=bound(nbytes(q, kv7, qbias, out),
                              [(T * HEADS * V * N * 4 * DH, BF16_OPS)])[0],
        library_ms_n70656=time_ms(lambda: sdpa(hm(q), hm(k7t[..., :C]), hm(k7t[..., C:]),
                                               attn_mask=mask)))
    log(f"  K7 {N} tracks x {T}: {e['ms_n70656']:.3f} ms ({e['splits_n70656']} key ranges; "
        f"library call {e['library_ms_n70656']:.3f} ms, bound {e['bound_ms_n70656']:.3f} ms)")
    del kv7, k7t, out, dead

    # K3 at the quasi-dense point count: the fused kernel's key ranges merged
    x = torch.randn(N, T, C, generator=g).to(dev, bf)
    args = (q, x, wkv, gamma, beta, HEADS, DH, qbias)
    out = attention_cuda.fused_virtual_from_points_proj(*args)
    err = check_close(f"K3 virtual<-points {N} tracks x {T}", out,
                      attention_cuda.v2p_proj_plain(*args), 0.01, 0.05)
    e = results["K3_virtual_from_points_proj"]
    e["max_abs_err"] = max(e["max_abs_err"], err)
    lib_ms, lib_parts = k3_library_chain(gd, dev, q, x, qbias)
    bnd = bound(nbytes(q, x, wkv.w, qbias, out),
                [(N * T * 2 * C * 2 * C, INT8_OPS), (T * HEADS * V * N * 4 * DH, BF16_OPS)])
    plan = attention_cuda.k3_plan(N, T, V, bf,
                                  sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    e.update(plan_n70656=plan._asdict(),
             ms_n70656=time_ms(lambda: attention_cuda.fused_virtual_from_points_proj(*args)),
             chain_ms_n70656=time_ms(lambda: attention_cuda._v2p_proj_chain(*args, 1e-5), reps=2),
             bound_ms_n70656=bnd[0], bound_by_n70656=bnd[1], library_ms_n70656=lib_ms,
             library_chain_parts_ms_n70656=lib_parts,
             device_launches_n70656=device_launches(
                 lambda: attention_cuda.fused_virtual_from_points_proj(*args)))
    log(f"  K3 {N} tracks x {T}: {e['ms_n70656']:.3f} ms (the launch chain it replaced "
        f"{e['chain_ms_n70656']:.3f} ms, library chain {lib_ms:.3f} ms, bound {bnd[0]:.3f} ms "
        f"by {bnd[1]}; {e['device_launches_n70656']} device launches)")
    del q, x, out

    # K5 on its other bf16 routes, each pinned to k5_plan's choice
    e = results["K5_time_attention"]
    for M, T, route, nc, sfx in K5_ROUTES:
        plan = attention_cuda.k5_plan(T, HEADS, True)
        if (plan.route, plan.nc) != (route, nc):
            raise AssertionError(f"K5 at {M} x {T}: k5_plan gives {plan}, not {route} nc={nc}")
        x = torch.randn(M, T, C, generator=g).to(dev, bf)
        kv5 = torch.randn(M, T, 2 * C, generator=g).to(dev, bf)
        out = attention_cuda.fused_time_attention(x, kv5, HEADS, DH)
        err = check_close(f"K5 time attention {M} tracks x {T}", out,
                          attention_cuda.time_attention_plain(x, kv5, HEADS, DH), *CORE_TOL)
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e.update({
            "err" + sfx: err,
            "ms" + sfx: time_ms(lambda: attention_cuda.fused_time_attention(x, kv5, HEADS, DH)),
            "plain_ms" + sfx: time_ms(lambda: attention_cuda.time_attention_plain(
                x, kv5, HEADS, DH), reps=2),
            "bound_ms" + sfx: bound(nbytes(x, kv5, out),
                                    [(M * T * HEADS * 4 * T * DH, BF16_OPS)])[0],
            "library_ms" + sfx: time_ms(lambda: sdpa(hm(x), hm(kv5[..., :C]), hm(kv5[..., C:]))),
            "shape" + sfx: f"{M} tracks x {T} frames, bf16 (route {route}, nc={nc})"})
        log(f"  K5 {M} tracks x {T} ({route}, nc={nc}): {e['ms' + sfx]:.3f} ms (plain "
            f"{e['plain_ms' + sfx]:.3f} ms, library call {e['library_ms' + sfx]:.3f} ms, "
            f"bound {e['bound_ms' + sfx]:.3f} ms)")
        del x, kv5, out
    return [results[k] for k in sorted(results)]


def train_kernel_phase(dev):
    """K4r and K4f against their plain versions at level 0 (96x128), f32
    level maps and support, at the training shape (the contract's keys) and
    the inference chunk (`*_t60`)."""
    g = torch.Generator().manual_seed(3)
    Hh, W = LVL0
    out = {}
    for (n, T) in (TRAIN_SHAPE, INFER_SHAPE):
        sfx = "" if (n, T) == TRAIN_SHAPE else f"_t{T}"
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g).to(dev), dim=-1)
        sup = torch.nn.functional.normalize(torch.randn(1, n, 49, 128, generator=g).to(dev), dim=-1)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, wxy = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        Tp = starts.shape[1]
        mm = n * Tp * 64 * 49 * 128 * 2  # multiply-adds of the window products, as operations

        fmq = corr_cuda.build_int8_level(fm, 3)
        supq, _ = corr_cuda.quantize_support(sup.transpose(1, 2), torch.float32)
        supq = supq.reshape(n, 49, 128)
        vol, scale = corr_cuda.corr_volume_raw_int8(fmq, supq, starts)
        rvol, rscale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
        same = torch.equal(vol, rvol) and torch.equal(scale, rscale)
        log(f"  K4r raw int8 volume {n} points x {T} frames: codes and scales bit-identical: {same}")
        if not same:
            raise AssertionError("K4r: kernel disagrees with its plain version")
        e = out.setdefault("K4r_corr_volume_raw", dict(
            name="K4r_corr_volume_raw", route="cuda", source=SRC_CORR,
            replaces="cotracker_tpu/ops/kernels/corr_pallas.py:105", launches=0, max_abs_err=0.0,
            shape=f"level 0 (96x128), {TRAIN_SHAPE[0]} points x {TRAIN_SHAPE[1]} frames"))
        bnd = bound(nbytes(fmq, supq, starts, vol, scale), [(mm, INT8_OPS)])
        e.update({"ms" + sfx: time_ms(lambda: corr_cuda.corr_volume_raw_int8(fmq, supq, starts)),
                  "plain_ms" + sfx: time_ms(lambda: corr_cuda.corr_volume_raw_plain(fmq, supq, starts),
                                            reps=2),
                  "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1], "library_ms" + sfx: None})
        del fmq, supq, vol, rvol

        fmf = corr_cuda.build_float_level(fm, 3, torch.float32)
        supf = sup.reshape(n, 49, 128).contiguous()
        vol = corr_cuda.corr_volume_float(fmf, supf, starts)
        ref = corr_cuda.corr_volume_float_plain(fmf, supf, starts)
        err = (vol - ref).abs().max().item()
        lim = K4F_TOL * ref.abs().max().item()
        log(f"  K4f raw f32 volume {n} points x {T} frames: max_abs_err {err:.3e} (bound {lim:.3e})")
        if not err <= lim:
            raise AssertionError("K4f: kernel disagrees with its plain version")
        e = out.setdefault("K4f_corr_volume_float", dict(
            name="K4f_corr_volume_float", route="cuda", source=SRC_CORR,
            replaces="cotracker_tpu/ops/kernels/corr_pallas.py:105", launches=0, max_abs_err=0.0,
            shape=f"level 0 (96x128), {TRAIN_SHAPE[0]} points x {TRAIN_SHAPE[1]} frames, f32"))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        bnd = bound(nbytes(fmf, supf, starts, vol), [(mm, F32_OPS)])
        e.update({"ms" + sfx: time_ms(lambda: corr_cuda.corr_volume_float(fmf, supf, starts)),
                  "plain_ms" + sfx: time_ms(lambda: corr_cuda.corr_volume_float_plain(fmf, supf, starts),
                                            reps=2),
                  "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1], "library_ms" + sfx: None})
        for k in out.values():
            if ("ms" + sfx) in k:
                log(f"  {k['name']} {n}x{T}: {k['ms' + sfx]:.3f} ms (plain {k['plain_ms' + sfx]:.3f} ms, "
                    f"bound {k['bound_ms' + sfx]:.3f} ms by {k['bound_by' + sfx]})")
        del fm, fmf, sup, supf, vol, ref
    return [out[k] for k in sorted(out)]


LONG_T, LONG_TRACKS = 250, 2048  # the long path's point tokens (2,048 tracks x 250 frames)
LONG_FORWARD_TRACKS = 2560  # the long forward's own point-token count (2,500 points, padded)


def bf16_ulp_frac(out, ref):
    """Fraction of elements further than one bf16 ulp of the reference
    element (2^(floor(log2|ref|) - 7)) from it."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return ((out.float() - r).abs() > ulp).float().mean().item()


def split_kernel_phase(dev):
    """K8 and K9 against their plain versions in bf16 at the long path's
    point tokens (the contract's keys) and virtual tokens (`*_virtual`).
    K8 within one bf16 ulp: the two sides differ only where the LayerNorm's
    last float32 ulp (reduction order, rsqrt against 1/sqrt) moves an int8
    code at a rounding tie, so its median error is within half a bf16 ulp of
    the mean output, its largest within one ulp of the largest output
    (2^-7 of it), and at most 1% of the elements further than one ulp of
    their reference; K9 within K1's bounds (median 1% of the mean, max 5% of
    the largest: its GELU codes' row scale moves with a last-ulp tanh)."""
    g = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    w = mlp_int8_cuda.TimeBlockWeights(lin(g, 3 * C, C, dev), lin(g, C, C, dev),
                                       lin(g, HID, C, dev), lin(g, C, HID, dev))
    wbytes = nbytes(*[t for q in w for t in q])
    out = {}
    for M, sfx in ((LONG_TRACKS, ""), (LONG_FORWARD_TRACKS, "_m2560"), (V, "_virtual")):
        rows = M * LONG_T
        x = torch.randn(M, LONG_T, C, generator=g).to(dev, bf)
        a = (0.5 * torch.randn(M, LONG_T, C, generator=g)).to(dev, bf)

        q, kv = mlp_int8_cuda.fused_ln_qkv_int8(x, w.qkv)
        rq, rkv = mlp_int8_cuda.ln_qkv_plain(x, w.qkv)
        o, r = torch.cat([q, kv], -1), torch.cat([rq, rkv], -1)
        err = check_close(f"K8 ln + q|kv {M}x{LONG_T}", o, r, 2.0**-9, 2.0**-7)
        frac = bf16_ulp_frac(o, r)
        log(f"    elements further than one bf16 ulp: {frac:.2e} (bound 1e-2)")
        if frac > 1e-2:
            raise AssertionError("K8: kernel disagrees with its plain version")
        # the streamed body against the PR 4 body (ct_k8_ln_qkv): bit for bit
        x2d = x.reshape(-1, C)
        fq, fkv = mlp_int8_cuda._ln_qkv_tile(x2d, w.qkv, 1e-6, False)
        diff = int((q.reshape(-1, C) != fq).sum().item() + (kv.reshape(-1, 2 * C) != fkv).sum().item())
        log(f"    against the PR 4 body: {diff} elements differ (bound 0)")
        if diff:
            raise AssertionError("K8: the streamed body differs from the PR 4 body")
        del q, kv, rq, rkv, o, r, fq, fkv
        e = out.setdefault("K8_ln_qkv", dict(
            name="K8_ln_qkv", route="cuda", source=SRC_K1,
            replaces="cotracker_tpu/ops/kernels/mlp_int8_pallas.py:269", launches=0,
            max_abs_err=0.0, shape=f"{LONG_TRACKS} tracks x {LONG_T} frames, bf16"))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        bnd = bound(nbytes(x) * 4 + wbytes, [(rows * 2 * C * 3 * C, INT8_OPS)])
        e.update({"ms" + sfx: time_ms(lambda: mlp_int8_cuda.fused_ln_qkv_int8(x, w.qkv)),
                  "first_ms" + sfx: time_ms(
                      lambda: mlp_int8_cuda._ln_qkv_tile(x2d, w.qkv, 1e-6, False)),
                  "plain_ms" + sfx: time_ms(lambda: mlp_int8_cuda.ln_qkv_plain(x, w.qkv), reps=2),
                  "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1], "library_ms" + sfx: None})

        y = mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, w)
        ry = mlp_int8_cuda.attnout_mlp_plain(a, x, w)
        err = check_close(f"K9 out + MLP {M}x{LONG_T}", y, ry, 0.01, 0.05)
        del y, ry
        e = out.setdefault("K9_attnout_mlp", dict(
            name="K9_attnout_mlp", route="cuda", source=SRC_K1,
            replaces="cotracker_tpu/ops/kernels/mlp_int8_pallas.py:335", launches=0,
            max_abs_err=0.0, shape=f"{LONG_TRACKS} tracks x {LONG_T} frames, bf16"))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        bnd = bound(nbytes(x) * 3 + wbytes, [(rows * 2 * (C * C + 2 * C * HID), INT8_OPS)])
        e.update({"ms" + sfx: time_ms(lambda: mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, w)),
                  "plain_ms" + sfx: time_ms(lambda: mlp_int8_cuda.attnout_mlp_plain(a, x, w),
                                            reps=2),
                  "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1], "library_ms" + sfx: None})
        for k in out.values():
            first = f", PR 4 body {k['first_ms' + sfx]:.3f} ms" if "first_ms" + sfx in k else ""
            log(f"  {k['name']} {M}x{LONG_T}: {k['ms' + sfx]:.3f} ms (plain "
                f"{k['plain_ms' + sfx]:.3f} ms, bound {k['bound_ms' + sfx]:.3f} ms by "
                f"{k['bound_by' + sfx]}{first})")
        del x, a
    return [out[k] for k in sorted(out)]


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
    "K4r_corr_volume_raw": corr_cuda.corr_volume_raw_int8,
    "K4f_corr_volume_float": corr_cuda.corr_volume_float,
    "K8_ln_qkv": mlp_int8_cuda.fused_ln_qkv_int8,
    "K9_attnout_mlp": mlp_int8_cuda.fused_attnout_res_mlp_int8,
    "K4m_corr_mlp1": corr_cuda.corr_mlp1_int8,
    "K10_ln_dense": mlp_int8_cuda.fused_ln_dense_int8,
    "K11_space_block_allt": mlp_int8_cuda.fused_space_block_allt_int8,
    "K12_ln_mlp": mlp_int8_cuda.fused_ln_mlp_int8,
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


class MovingClip:
    """One T-frame clip of a smooth random texture moving (-2, -1) px per
    frame, and N tracks of texture points that start inside frame 0: track
    n at (x0 - 2t, y0 - t), visible while inside the frame. In-memory, from
    a seed; the trainer's dataset interface (data_loader)."""

    def __init__(self, T, H, W, N, seed=0):
        from cotracker_tpu_torch.training.data_loader import Sample

        g = torch.Generator().manual_seed(seed)
        tex = torch.nn.functional.interpolate(
            torch.rand(1, 3, (H + T) // 8 + 2, (W + 2 * T) // 8 + 2, generator=g),
            scale_factor=8, mode="bicubic")[0].clamp(0, 1) * 255
        video = torch.stack([tex[:, t : t + H, 2 * t : 2 * t + W] for t in range(T)])
        x0 = torch.rand(N, generator=g) * (W - 1)
        y0 = torch.rand(N, generator=g) * (H - 1)
        t = torch.arange(T, dtype=torch.float32)[:, None]
        trajs = torch.stack([x0 - 2 * t, y0 - t], dim=-1)  # (T, N, 2)
        vis = ((trajs[..., 0] >= 0) & (trajs[..., 1] >= 0)).float()
        self.sample = Sample(video.numpy(), trajs.numpy(), vis.numpy(), np.ones((T, N), np.float32))

    def __len__(self):
        return 1

    def get(self, ix, rng):
        return self.sample, True


TRAIN_RES, TRAIN_TRACKS, TRAIN_ITERS = (384, 512), 768, 4


def train_run(exp_dir, clip, steps, **kw):
    """train() on `clip` for `steps` steps (resuming from exp_dir when it
    holds a checkpoint); a visualisation hook at every step reads and zeroes
    the launch counts and times the step. Returns per-step (step, counts, ms)."""
    from cotracker_tpu_torch.training.trainer import TrainerArgs, train

    args = TrainerArgs(exp_dir=exp_dir, batch_size=1, traj_per_sample=TRAIN_TRACKS,
                       num_steps=steps, train_iters=TRAIN_ITERS, crop_size=TRAIN_RES,
                       save_vis_every_n_steps=1, num_loader_workers=1, loader_prefetch=2,
                       dataset_repeats=1, device="cuda", **kw)
    per_step = []
    clock = {}

    def hook(model, batch, step):
        torch.cuda.synchronize()
        now = time.perf_counter()
        per_step.append((step, read_counts(), 1e3 * (now - clock["t"])))
        zero_counts()
        clock["t"] = time.perf_counter()

    zero_counts()
    torch.cuda.synchronize()
    clock["t"] = time.perf_counter()
    train(args, dataset=clip, vis_hook=hook)
    return per_step


def read_losses(exp_dir):
    with open(os.path.join(exp_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_launches(name, per_step, expected):
    for step, counts, _ in per_step:
        if counts != expected:
            raise AssertionError(f"{name}: step {step} launched {counts}, expected {expected}")
    log(f"  launches per step, every step: {[k for k, v in expected.items() if v]} "
        f"{[v for v in expected.values() if v]}, every other kernel 0")


def training_phase(dev, smi):
    """Phase 7 (see the module docstring). Returns the per-step launch
    counts of the online K4r run and of the K4f run, and the metrics."""
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    zeros = dict.fromkeys(WRAPPERS, 0)
    try:
        log(f"training (a): online model, {TRAIN_RES[0]}x{TRAIN_RES[1]}, 24 frames in windows "
            f"of 16, {TRAIN_TRACKS} tracks, iters={TRAIN_ITERS}, f32, K4r + remat, AdamW:")
        clip = MovingClip(24, *TRAIN_RES, TRAIN_TRACKS)
        online = dict(seq_len=24, offline_model=False, model_window_len=16, save_every_n_steps=4)
        exp = os.path.join(root, "online")
        torch.cuda.reset_peak_memory_stats()
        run1 = train_run(exp, clip, 8, **online)
        peak = torch.cuda.max_memory_allocated() / 2**30
        windows = 2  # 24 frames in windows of 16 at step 8
        k4r = 4 * TRAIN_ITERS * windows * 2
        check_launches("training (a)", run1, {**zeros, "K4r_corr_volume_raw": k4r})
        losses = [r["total_loss"] for r in read_losses(exp)]
        ms = sorted(m for _, _, m in run1[2:])
        ms_step = ms[len(ms) // 2] if len(ms) % 2 else 0.5 * (ms[len(ms) // 2 - 1] + ms[len(ms) // 2])
        log(f"  total loss per step {[round(x, 4) for x in losses]}")
        log(f"  ms per step {[round(m, 1) for _, _, m in run1]}; median of steps 3-8 "
            f"{ms_step:.1f} ms; peak memory {peak:.2f} GiB ({smi})")
        if not all(math.isfinite(x) for x in losses) or not min(losses) < losses[0]:
            raise AssertionError("training (a): losses not finite or not decreasing")
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        if ckpts != ["model_000000004.pth", "model_000000008.pth", "model_final.pth"]:
            raise AssertionError(f"checkpoints {ckpts}")
        os.remove(os.path.join(exp, "checkpoints", "model_000000008.pth"))
        run2 = train_run(exp, clip, 8, **online)
        resumed = read_losses(exp)[8:]
        steps2 = [r["step"] for r in resumed]
        diff = max(abs(a["total_loss"] - b["total_loss"]) / abs(a["total_loss"])
                   for a, b in zip(read_losses(exp)[4:8], resumed))
        log(f"  resumed from the step-4 checkpoint: steps {steps2}, hooks at {[s for s, _, _ in run2]}; "
            f"losses of steps 4-7 against the first run: max relative difference {diff:.2e} "
            f"(bound 1e-3: atomics in the backward's scatter-adds sum in another order)")
        if steps2 != [4, 5, 6, 7] or [s for s, _, _ in run2] != [5, 6, 7, 8] or not diff <= 1e-3:
            raise AssertionError("training (a): auto-resume did not continue from step 4")
        check_launches("training (a) resumed", run2, {**zeros, "K4r_corr_volume_raw": k4r})

        log("training (b): offline model, one 16-frame window, 3 steps:")
        exp = os.path.join(root, "offline")
        run = train_run(exp, MovingClip(16, *TRAIN_RES, TRAIN_TRACKS), 3, seq_len=16,
                        offline_model=True, model_window_len=16, save_every_n_steps=0)
        check_launches("training (b)", run, {**zeros, "K4r_corr_volume_raw": 4 * TRAIN_ITERS * 2})
        off = [r["total_loss"] for r in read_losses(exp)]
        log(f"  total loss per step {[round(x, 4) for x in off]}; ms per step "
            f"{[round(m, 1) for _, _, m in run]}")
        if not all(math.isfinite(x) for x in off):
            raise AssertionError("training (b): non-finite loss")

        log("training (c): online model with K4f (corr_quant_int8=False), 2 steps:")
        exp = os.path.join(root, "k4f")
        run_f = train_run(exp, clip, 2, corr_quant_int8=False, **online)
        check_launches("training (c)", run_f, {**zeros, "K4f_corr_volume_float": k4r})
        fl = [r["total_loss"] for r in read_losses(exp)]
        log(f"  total loss per step {[round(x, 4) for x in fl]}; ms per step "
            f"{[round(m, 1) for _, _, m in run_f]}")
        if not all(math.isfinite(x) for x in fl):
            raise AssertionError("training (c): non-finite loss")

        log("training (d): online model with COTRACKER_CORR_FUSE_MLP1=1 (K4m forward), "
            "2 steps:")
        exp = os.path.join(root, "k4m")
        os.environ[ENV["corr_fuse_mlp1"]] = "1"  # read once, when the trainer builds
        try:
            run_m = train_run(exp, clip, 2, **online)
        finally:
            os.environ.pop(ENV["corr_fuse_mlp1"])
        check_launches("training (d)", run_m, {**zeros, "K4m_corr_mlp1": k4r})
        ml = [r["total_loss"] for r in read_losses(exp)]
        log(f"  total loss per step {[round(x, 4) for x in ml]}; ms per step "
            f"{[round(m, 1) for _, _, m in run_m]}")
        if not all(math.isfinite(x) for x in ml):
            raise AssertionError("training (d): non-finite loss")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return run1[-1][1], run_f[-1][1], run_m[-1][1], dict(
        ms_per_step=ms_step, peak_gib=peak, ms_per_step_offline=[m for _, _, m in run],
        ms_per_step_k4f=[m for _, _, m in run_f], ms_per_step_k4m=[m for _, _, m in run_m])


def gradient_phase(dev):
    """Phase 8: the K4r and K4f training models against the plain one."""
    from cotracker_tpu_torch.models.build import build_training_model
    from cotracker_tpu_torch.training.train_step import (
        TrainConfig, sample_queries_from_gt, tracker_loss_fn,
    )

    T, (H, W), N = 8, (64, 96), 32
    clip = MovingClip(T, H, W, N, seed=4).sample
    video = torch.from_numpy(clip.video).permute(0, 2, 3, 1)[None].to(dev)
    trajs, vis = (torch.from_numpy(x)[None].to(dev) for x in (clip.trajectory, clip.visibility))
    valids = torch.ones_like(vis)
    queries = sample_queries_from_gt(trajs, vis, torch.Generator().manual_seed(0))
    cfg = TrainConfig(iters=2, offline_model=True, sliding_window_len=T)
    out = {}
    for name, kw in (("plain", dict(corr_kernels=False)),
                     ("K4r", dict(corr_kernels=True, corr_quant_int8=True)),
                     ("K4f", dict(corr_kernels=True, corr_quant_int8=False))):
        model = build_training_model(offline=True, window_len=T, model_resolution=(H, W),
                                     device="cuda", seed=0, **kw)
        loss, _ = tracker_loss_fn(model, video, trajs, vis, valids, queries, cfg)
        loss.backward()
        out[name] = (loss.item(), {k: p.grad.double().cpu() for k, p in model.named_parameters()})
    loss0, g0 = out["plain"]
    for name in ("K4r", "K4f"):
        loss, g = out[name]
        worst, worst_k = 0.0, None
        for k, ref in g0.items():
            tol = 2e-2 * ref.abs() + max(2e-3 * ref.abs().max().item(), 1e-7)
            r = ((g[k] - ref).abs() / tol).max().item()
            if r > worst:
                worst, worst_k = r, k
        rel = abs(loss - loss0) / abs(loss0)
        log(f"  {name} against plain, 64x96, 8 frames, 32 tracks, iters=2: loss {loss:.6f} vs "
            f"{loss0:.6f} (rel {rel:.2e}, bound 1e-3); largest gradient error / its bound "
            f"{worst:.3f} ({worst_k})")
        if not (rel <= 1e-3 and worst <= 1.0):
            raise AssertionError(f"{name}: training gradients disagree with the plain model")


def long_path(dev):
    """Phase 9: the offline predictor on a 250-frame video (see the module
    docstring). Returns the launch counts of one forward and its metrics."""
    from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    pred = CoTrackerPredictor(fast=True, device="cuda")
    video = synthetic_video(LONG_T, 384, 512, dev)
    grid = 50
    n, n_pad = grid * grid, -(-grid * grid // 512) * 512
    expected = {**dict.fromkeys(WRAPPERS, 0), "K8_ln_qkv": 36, "K5_time_attention": 36,
                "K9_attnout_mlp": 36, "K2_space_block": 18, "K3_virtual_from_points_proj": 18,
                "K4_corr_volume": 4 * 6 * -(-n_pad // pred.model.corr_chunk)}
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  forward {dt:.3f} s for {n} points x {LONG_T} frames: {n * LONG_T / dt:.0f} "
        f"points*frames/s; peak memory {peak:.1f} GiB")
    log(f"  launches per forward {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the long path did not launch every kernel as expected")
    if tuple(tracks.shape) != (1, LONG_T, n, 2) or tuple(vis.shape) != (1, LONG_T, n):
        raise AssertionError(f"shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
    if not torch.isfinite(tracks).all():
        raise AssertionError("non-finite tracks")
    q = get_points_on_a_grid(grid, (384, 512)).to(dev)[0]
    if not (torch.equal(tracks[0, 0], q) and bool(vis[0, 0].all())):
        raise AssertionError("snap-back: frame-0 tracks differ from the grid queries")
    log("  shapes, finiteness and snap-back ok")
    return launches, dict(seconds=dt, points_frames_per_s=n * LONG_T / dt, peak_gib=peak)


def video600_path(dev):
    """Phase 15: the offline predictor on a 600-frame video (past the 512
    frames K5's short route stages; the frame gate sends it to the split):
    one forward at 256 points, counters zeroed before and read after it."""
    from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    pred = CoTrackerPredictor(fast=True, device="cuda")
    T, grid = VIDEO600_T, VIDEO600_GRID
    video = synthetic_video(T, 384, 512, dev)
    n, n_pad = grid * grid, -(-grid * grid // 512) * 512
    expected = {**dict.fromkeys(WRAPPERS, 0), "K8_ln_qkv": 36, "K5_time_attention": 36,
                "K9_attnout_mlp": 36, "K2_space_block": 18, "K3_virtual_from_points_proj": 18,
                "K4_corr_volume": 4 * 6 * -(-n_pad // pred.model.corr_chunk)}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks, vis = pred(video, grid_size=grid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  first forward {dt:.3f} s for {n} points x {T} frames; peak memory {peak:.1f} GiB")
    log(f"  launches per forward {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the 600-frame video did not launch every kernel as expected")
    if tuple(tracks.shape) != (1, T, n, 2) or tuple(vis.shape) != (1, T, n):
        raise AssertionError(f"shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
    if not torch.isfinite(tracks).all():
        raise AssertionError("non-finite tracks")
    q = get_points_on_a_grid(grid, (384, 512)).to(dev)[0]
    if not (torch.equal(tracks[0, 0], q) and bool(vis[0, 0].all())):
        raise AssertionError("snap-back: frame-0 tracks differ from the grid queries")
    log("  shapes, finiteness and snap-back ok")
    return launches, dict(seconds=dt, peak_gib=peak)


# the evaluation phase's sequences: (name, frames, tracks, launches per
# forward). A: 231 queries + the 5x5 grid = 256 tracks (the track gate on;
# at 250 frames both token kinds take the split). B: 40 + 25 = 65 tracks,
# padded to 128 (the gate off: K5 between plain projections in the time
# blocks, the space blocks plain); the single-point protocol's 1 + 64 + 25
# = 90 tracks pad to 128 too.
EVAL_SEQS = (
    ("A", LONG_T, 231, dict(K8_ln_qkv=36, K5_time_attention=36, K9_attnout_mlp=36,
                            K2_space_block=18, K3_virtual_from_points_proj=18, K4_corr_volume=24)),
    ("B", 80, 40, dict(K5_time_attention=36, K4_corr_volume=24)),
)


def write_tapvid_pickle(path):
    """A TAP-Vid DAVIS-format pickle of EVAL_SEQS at the 256x256 raster:
    MovingClip's texture and tracks, every track visible at frame 0."""
    import pickle

    data = {}
    for i, (name, T, N, _) in enumerate(EVAL_SEQS):
        clip = MovingClip(T, 256, 256, N, seed=10 + i).sample
        data[name] = {
            "video": np.ascontiguousarray(clip.video.transpose(0, 2, 3, 1)).round().astype(np.uint8),
            "points": (clip.trajectory.transpose(1, 0, 2) / 255.0).astype(np.float32),
            "occluded": ~clip.visibility.T.astype(bool),
        }
    with open(path, "wb") as f:
        pickle.dump(data, f)


def evaluation_phase(dev):
    """Phase 10 (see the module docstring). Returns the launch counts of
    sequence A's forward and the seconds per sequence."""
    from cotracker_tpu_torch.datasets.tap_vid import TapVidDataset
    from cotracker_tpu_torch.evaluation import evaluation_predictor as ep
    from cotracker_tpu_torch.evaluation.evaluate import DefaultConfig, run_eval
    from cotracker_tpu_torch.models.build import build_cotracker

    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    zeros = dict.fromkeys(WRAPPERS, 0)
    per_call = []
    call = ep.EvaluationPredictor.__call__

    def counted(self, video, queries):  # counts and seconds of each sequence
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, video, queries)
        torch.cuda.synchronize()
        per_call.append((read_counts(), time.perf_counter() - t0, video.shape[1]))
        return out

    try:
        pkl = os.path.join(root, "tapvid_davis.pkl")
        write_tapvid_pickle(pkl)
        cfg = DefaultConfig(exp_dir=os.path.join(root, "exp"), dataset_root=pkl,
                            dataset_name="tapvid_davis_first", fast=True, device="cuda")
        ep.EvaluationPredictor.__call__ = counted
        try:
            metrics = run_eval(cfg)
        finally:
            ep.EvaluationPredictor.__call__ = call
        secs = {}
        for (name, T, N, want), (counts, sec, frames) in zip(EVAL_SEQS, per_call):
            expected = {**zeros, **want}
            log(f"  sequence {name}: {frames} frames, {N} queries + 25 grid points: {sec:.2f} s; "
                f"launches {counts}")
            if frames != T or counts != expected:
                raise AssertionError(f"evaluation sequence {name}: expected {expected}")
            secs[name] = sec
        keys = ("average_jaccard", "average_pts_within_thresh", "occlusion_accuracy")
        avg = metrics["avg"]
        log(f"  TAP-Vid metrics (random weights: the values mean nothing) {avg}")
        if len(per_call) != 2 or not all(k in avg and math.isfinite(avg[k]) for k in keys):
            raise AssertionError("evaluation: missing or non-finite metrics")
        for f in ("expconfig.json", "result_eval_.json", "result_tapvid_davis_first.json"):
            if not os.path.exists(os.path.join(cfg.exp_dir, f)):
                raise AssertionError(f"evaluation: {f} not written")

        # the single-point protocol on three of B's queries: one forward each
        sample = TapVidDataset(pkl, "davis")[1]
        qp = sample.query_points[:3]
        queries = np.stack([qp[:, 0], qp[:, 2], qp[:, 1]], axis=1)[None]
        single = ep.EvaluationPredictor(build_cotracker(fast=True, device="cuda"),
                                        single_point=True)
        zero_counts()
        t0 = time.perf_counter()
        tracks, vis = single(sample.video[None], queries)
        sec = time.perf_counter() - t0
        counts = read_counts()
        expected = {**zeros, "K5_time_attention": 3 * 36, "K4_corr_volume": 3 * 24}
        log(f"  single-point protocol, 3 queries of B: {sec:.2f} s; launches {counts}")
        if counts != expected or tracks.shape != (1, 80, 3, 2) or not np.isfinite(tracks).all():
            raise AssertionError(f"single-point evaluation: expected {expected}")
        secs["B_single_point_3"] = sec
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return per_call[0][0], secs


# ---------------------------------------------------------------- the variants
# (phases 11-15): the four kernels of the round-5 variant switches, the
# quasi-dense streaming cell in both settings, the offline bench workload
# with the variants on, and the micro-benchmark entry point

SRC_FUSED = "cotracker_tpu_torch/csrc/int8_fused.cu"
SRC_K12 = "cotracker_tpu_torch/csrc/int8_mlp_cluster.cu"
ALL_ON = KernelVariants(corr_fuse_mlp1=True, space_allt=True, bf16_ln=True, gelu_quant_fold=True)
QD_GRID, QD_FRAMES = 265, 48  # 70,225 points (70,656 padded), 5 windows of 16 at step 8
QD_PAD = -(-QD_GRID**2 // 512) * 512
UB_ROWS, UB_REPS = 604_800, 8  # scripts/torch_ubench.py int8pallas rows; launches = 1 + reps
MODE_SHAPE = (2048, T_STREAM)  # each W8A8 body in both modes
K8_TOL = (2.0**-9, 2.0**-7)  # K8's band (split_kernel_phase), for K10
K4M_PAST_HOLD = 80  # frames past the 64 that K4m's code rows hold on chip: two passes
K9_TOL = (0.01, 0.05)  # K1/K2/K9's band, for K11 and K12


def variant_entry(name, source, replaces, shape, err, ms, plain_ms, bnd, library_ms=None,
                  **extra):
    e = dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
             max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
             library_ms=library_ms, shape=shape, **extra)
    lib = "" if library_ms is None else f", library chain {library_ms:.3f} ms"
    log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms{lib}, bound {bnd[0]:.3f} ms by {bnd[1]})")
    return e


def fold_pack(g, dev):
    """A time-block pack whose fc1 leaves every pre-GELU value negative
    (about N(-3, 0.3)): there the GELU-quant fold's scale differs from the
    absmax one on every row."""
    w = mlp_int8_cuda.TimeBlockWeights(lin(g, 3 * C, C, dev), lin(g, C, C, dev),
                                       lin(g, HID, C, dev), lin(g, C, HID, dev))
    w1 = 0.3 * torch.randn(HID, C, generator=g) / math.sqrt(C)
    fc1 = mlp_int8_cuda.quantize_linear(w1.to(dev), (-3.0 + 0.05 * torch.randn(HID, generator=g)).to(dev))
    return w._replace(fc1=fc1)


def space_pack(tw):
    return mlp_int8_cuda.SpaceBlockWeights(
        mlp_int8_cuda.QLinear(tw.qkv.w[:C].contiguous(), tw.qkv.s[:C].contiguous(),
                              tw.qkv.b[:C].contiguous()), tw.out, tw.fc1, tw.fc2)


def mode_phase(dev):
    """Every W8A8 body against its plain version in each variant mode, bf16
    at 2,048 tracks x 16 frames (one row per track and frame for K8-K10,
    K12); the GELU-quant fold with fold_pack's weights."""
    g = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    M, T = MODE_SHAPE
    x = torch.randn(M, T, C, generator=g).to(dev, bf)
    a = (0.5 * torch.randn(M, T, C, generator=g)).to(dev, bf)
    kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
    errs = {}
    for mode in ("bf16_ln", "gelu_fold"):
        tw = fold_pack(g, dev) if mode == "gelu_fold" else mlp_int8_cuda.TimeBlockWeights(
            lin(g, 3 * C, C, dev), lin(g, C, C, dev), lin(g, HID, C, dev), lin(g, C, HID, dev))
        sw = space_pack(tw)
        kw = {mode: True}
        lnkw = {"bf16_ln": True} if mode == "bf16_ln" else {}
        m = mlp_int8_cuda
        bodies = {
            "K1": (lambda: m.fused_time_block_int8(x, tw, HEADS, DH, **kw),
                   lambda: m.time_block_plain(x, tw, HEADS, DH, **kw), K9_TOL),
            "K2": (lambda: m.fused_space_block_int8(x, kv, sw, HEADS, DH, **kw),
                   lambda: m.space_block_plain(x, kv, sw, HEADS, DH, **kw), K9_TOL),
            "K8": (lambda: torch.cat(m.fused_ln_qkv_int8(x, tw.qkv, **lnkw), -1),
                   lambda: torch.cat(m.ln_qkv_plain(x, tw.qkv, **lnkw), -1), K8_TOL),
            "K9": (lambda: m.fused_attnout_res_mlp_int8(a, x, tw, **kw),
                   lambda: m.attnout_mlp_plain(a, x, tw, **kw), K9_TOL),
            "K10": (lambda: m.fused_ln_dense_int8(x, tw.qkv, ln=True, **lnkw),
                    lambda: m.ln_dense_plain(x, tw.qkv, ln=True, **lnkw), K8_TOL),
            "K11": (lambda: m.fused_space_block_allt_int8(x, kv, sw, HEADS, DH, **kw),
                    lambda: m.space_block_plain(x, kv, sw, HEADS, DH, **kw), K9_TOL),
            "K12": (lambda: m.fused_ln_mlp_int8(x, tw.fc1, tw.fc2, **kw),
                    lambda: m.ln_mlp_plain(x, tw.fc1, tw.fc2, **kw), K9_TOL),
        }
        for name, (kern, plain, tol) in bodies.items():
            err = check_close(f"{name} {mode} {M}x{T}", kern(), plain(), *tol)
            errs[f"{name}_{mode}"] = err
    torch.cuda.synchronize()
    return errs


def k12_library_chain(x, fc1, fc2, ln):
    """K12's library chain, never called by the port: LN in torch, the row
    codes, torch._int_mm for fc1, the plain GELU codes, torch._int_mm for
    fc2, the epilogue."""
    x32 = x.float()
    h = torch.nn.functional.layer_norm(x32, (C,), eps=1e-6) if ln else x32
    hq, s0 = mlp_int8_cuda.quant_rows(h)
    uq, s1 = mlp_int8_cuda.quant_gelu(mlp_int8_cuda.qlinear_plain(hq, s0, fc1))
    return (x32 + mlp_int8_cuda.qlinear_plain(uq, s1, fc2)).to(x.dtype)


def variant_kernel_phase(dev):
    """K4m, K11, K10 and K12 against their plain versions on the card (see
    the module docstring), with the K4 chain and K2 timed beside K4m and
    K11 at the same shapes."""
    g = torch.Generator().manual_seed(11)
    bf = torch.bfloat16
    out = []

    # K4m: level 0, one 2,048-point chunk, the streaming and offline windows
    Hh, W = LVL0
    w1 = (0.02 * torch.randn(2401, 384, generator=g)).to(dev)
    b1 = (0.1 * torch.randn(384, generator=g)).to(dev)
    w1c, w1s = corr_cuda.quantize_w1_mlp1(w1)
    w1q, w1amax = corr_cuda.quantize_w1(w1, bf)
    e = None
    for T, npts in ((T_STREAM, CHUNK), (T_FRAMES, CHUNK), (K4M_PAST_HOLD, 256)):
        # the check past the hold draws from its own seed: the later phases' inputs stay
        g_ = g if T != K4M_PAST_HOLD else torch.Generator().manual_seed(12)
        fm = torch.nn.functional.normalize(
            torch.randn(1, T, Hh, W, 128, generator=g_).to(dev), dim=-1).to(bf)
        fmq = corr_cuda.build_int8_level(fm, 3)
        sup = torch.nn.functional.normalize(
            torch.randn(1, 49, npts, 128, generator=g_).to(dev), dim=-1).to(bf)
        supq, sscale = corr_cuda.quantize_support(sup, bf)
        coords = (torch.rand(1, T, npts, 2, generator=g_) * torch.tensor([W, Hh])).to(dev).to(bf)
        starts, wxy = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        args = (fmq, supq.reshape(npts, 49, 128), starts, wxy, w1c, w1s, b1,
                sscale.reshape(npts), bf)
        h, codes, gscale = corr_cuda._k4m_launch(*args)
        ref = corr_cuda.corr_mlp1_plain(*args)
        rcodes, rscale = corr_cuda._mlp1_codes_plain(*args[:4])
        rows = int((h != ref).any(-1).sum().item())
        diff = int((codes != rcodes).sum().item()) + int((gscale != rscale).sum().item())
        err = (h.float() - ref.float()).abs().max().item()
        log(f"  K4m corr + MLP1 {npts} points x {T} frames (plan "
            f"{corr_cuda.k4m_plan(npts, starts.shape[1])}): rows differing {rows}, codes and "
            f"scales differing {diff} (bound 0 each), max_abs_err {err:.3e}")
        if rows or diff:
            raise AssertionError("K4m: kernel disagrees with its plain version")
        del codes, gscale, rcodes, rscale
        if T == K4M_PAST_HOLD:  # a correctness check only: the main paths stay under 64 frames
            del fm, fmq, sup, supq, h, ref
            continue
        Tp = starts.shape[1]
        bnd = bound(nbytes(*args[:-1], h), [(CHUNK * Tp * (64 * 49 * 128 + 2401 * 384) * 2, INT8_OPS),
                                           (CHUNK * Tp * 2401 * 6, F32_OPS)])
        chain = lambda mlp1: corr_cuda.corr_hidden(  # noqa: E731
            fmq, supq, sscale, coords, w1q, w1amax, b1, Hh, W, 3, bf,
            (w1c, w1s) if mlp1 else None)
        vals = dict(ms=time_ms(lambda: corr_cuda.corr_mlp1_int8(*args)),
                    first_ms=time_ms(lambda: corr_cuda._corr_mlp1_first(*args)),
                    plain_ms=time_ms(lambda: corr_cuda.corr_mlp1_plain(*args), reps=2),
                    k4_chain_ms=time_ms(lambda: chain(False)),
                    k4m_chain_ms=time_ms(lambda: chain(True)))
        log(f"  K4m T={T}: {vals['ms']:.3f} ms (first body {vals['first_ms']:.3f}, plain "
            f"{vals['plain_ms']:.3f}, bound {bnd[0]:.3f} by {bnd[1]}); per level-chunk with GELU: "
            f"K4 + int8 MLP1 {vals['k4_chain_ms']:.3f} ms, K4m {vals['k4m_chain_ms']:.3f} ms")
        if e is None:
            e = variant_entry("K4m_corr_mlp1", SRC_CORR,
                              "cotracker_tpu/ops/kernels/corr_pallas.py:244",
                              f"level 0 (96x128), {CHUNK} points x {T_STREAM} frames, bf16", err,
                              vals["ms"], vals["plain_ms"], bnd, first_ms=vals["first_ms"],
                              k4_chain_ms=vals["k4_chain_ms"], k4m_chain_ms=vals["k4m_chain_ms"])
        else:
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e.update({f"{k}_t{T}": v for k, v in vals.items()},
                     bound_ms_t60=bnd[0], bound_by_t60=bnd[1])
        del fm, fmq, sup, supq, h, ref
    out.append(e)
    torch.cuda.empty_cache()

    # K11: 10,240 and 70,656 tracks x 16 frames; it runs K2's code, so it
    # must equal K2 bit for bit; K2 and K2's library chain timed beside it
    gd = torch.Generator(device=dev).manual_seed(11)
    tw = mlp_int8_cuda.TimeBlockWeights(lin(g, 3 * C, C, dev), lin(g, C, C, dev),
                                        lin(g, HID, C, dev), lin(g, C, HID, dev))
    sw = space_pack(tw)
    e = None
    for N in (N_TRACKS, QD_PAD):
        T = T_STREAM
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        k11 = lambda: mlp_int8_cuda.fused_space_block_allt_int8(x, kv, sw, HEADS, DH)  # noqa: E731
        o = k11()
        diff = int((o != mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH)).sum().item())
        log(f"  K11 {N}x{T}: elements differing from K2 {diff} (bound 0)")
        if diff:
            raise AssertionError("K11 differs from K2, whose function it computes")
        ref = mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH)
        err = check_close(f"K11 all-frames block {N}x{T}", o, ref, *K9_TOL)
        del o, ref
        rows = N * T
        bnd = bound(2 * nbytes(x) + nbytes(kv) + nbytes(*[t for q in sw for t in q]),
                    [(rows * 2 * C * (2 * C + 2 * HID), INT8_OPS),
                     (rows * HEADS * 4 * V * DH, BF16_OPS)])
        q6 = hm(x.transpose(0, 1))  # (T, H, N, D)
        lib_ms, lib_parts = library_chain(
            gd, dev, rows, ((C, C), (C, C), (C, HID), (HID, C)),
            lambda: sdpa(q6, hm(kv[..., :C]), hm(kv[..., C:])))
        del q6
        vals = dict(ms=time_ms(k11),
                    plain_ms=time_ms(lambda: mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH),
                                     reps=2),
                    k2_ms=time_ms(lambda: mlp_int8_cuda.fused_space_block_int8(
                        x, kv, sw, HEADS, DH)),
                    library_ms=lib_ms, library_chain_parts_ms=lib_parts,
                    device_launches=device_launches(k11))
        log(f"  K11 {N}x{T}: {vals['ms']:.3f} ms (plain {vals['plain_ms']:.3f}, bound "
            f"{bnd[0]:.3f} by {bnd[1]}); K2 {vals['k2_ms']:.3f} ms; library chain {lib_ms:.3f} ms; "
            f"{vals['device_launches']} device launches a call")
        if e is None:
            e = variant_entry("K11_space_block_allt", SRC_K1,
                              "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:471",
                              f"{N} tracks x {T} frames, bf16", err, vals["ms"], vals["plain_ms"],
                              bnd, **{k: v for k, v in vals.items() if k not in ("ms", "plain_ms")})
        else:
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e.update({f"{k}_n{N}": v for k, v in vals.items()},
                     **{f"bound_ms_n{N}": bnd[0], f"bound_by_n{N}": bnd[1]})
        del x, kv
        torch.cuda.empty_cache()
    out.append(e)

    # K10 in each flag combination, K12 with the LN on and off: 604,800 bf16 rows
    x = torch.randn(UB_ROWS, C, generator=g).to(dev, bf)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    e = None
    for ln in (True, False):
        for affine in (False, True):
            for residual in (False, True):
                lin_ = tw.out if residual else tw.qkv
                kw = dict(ln=ln, residual=residual, gamma=gamma if affine else None,
                          beta=beta if affine else None)
                o = mlp_int8_cuda.fused_ln_dense_int8(x, lin_, **kw)
                ref = mlp_int8_cuda.ln_dense_plain(x, lin_, **kw)
                tag = f"ln={int(ln)} affine={int(affine)} residual={int(residual)}"
                err = check_close(f"K10 {tag}", o, ref, *K8_TOL)
                frac = bf16_ulp_frac(o, ref)
                if frac > 1e-2:
                    raise AssertionError(f"K10 {tag}: {frac:.2e} of the elements beyond one ulp")
                del o, ref
                if e is None:  # the micro-benchmark's to_qkv with the LN
                    N = lin_.w.shape[0]
                    bnd = bound(nbytes(x) + UB_ROWS * N * 2 + nbytes(*lin_),
                                [(UB_ROWS * 2 * C * N, INT8_OPS)])
                    e = variant_entry(
                        "K10_ln_dense", SRC_FUSED, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:203",
                        f"{UB_ROWS} rows x 384 -> {N}, bf16, ln=1", err,
                        time_ms(lambda: mlp_int8_cuda.fused_ln_dense_int8(x, lin_, **kw)),
                        time_ms(lambda: mlp_int8_cuda.ln_dense_plain(x, lin_, **kw), reps=2), bnd,
                        ms_by_flags={})
                e["max_abs_err"] = max(e["max_abs_err"], err)
                e["ms_by_flags"][tag] = time_ms(
                    lambda: mlp_int8_cuda.fused_ln_dense_int8(x, lin_, **kw))
    log(f"  K10 ms by flags {e['ms_by_flags']}")
    out.append(e)
    e = None
    for ln in (True, False):
        k12 = lambda: mlp_int8_cuda.fused_ln_mlp_int8(x, tw.fc1, tw.fc2, ln=ln)  # noqa: E731
        first = lambda: mlp_int8_cuda._ln_mlp_first(  # noqa: E731
            x, tw.fc1, tw.fc2, 1e-6, ln, False, False)
        o = k12()
        diff = int((o != first()).sum().item())
        log(f"  K12 ln={int(ln)}: elements differing from its first body {diff} (bound 0)")
        if diff:
            raise AssertionError("K12 differs from its first body")
        ref = mlp_int8_cuda.ln_mlp_plain(x, tw.fc1, tw.fc2, ln=ln)
        err = check_close(f"K12 ln={int(ln)}", o, ref, *K9_TOL)
        del o, ref
        vals = dict(ms=time_ms(k12), first_ms=time_ms(first, reps=2),
                    library_ms=time_ms(lambda: k12_library_chain(x, tw.fc1, tw.fc2, ln), reps=2),
                    device_launches=device_launches(k12))
        log(f"  K12 ln={int(ln)}: {vals['ms']:.3f} ms (first body {vals['first_ms']:.3f}, library "
            f"chain {vals['library_ms']:.3f}); {vals['device_launches']} device launches a call; "
            f"plan {mlp_int8_cuda.k12_plan(UB_ROWS, mlp_int8_cuda._k12_max_clusters(dev))}")
        if vals["device_launches"] != 1:
            raise AssertionError("K12 is one device launch a call")
        if e is None:
            bnd = bound(2 * nbytes(x) + nbytes(*tw.fc1, *tw.fc2), [(UB_ROWS * 4 * C * HID, INT8_OPS)])
            e = variant_entry(
                "K12_ln_mlp", SRC_K12, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:134",
                f"{UB_ROWS} rows x 384, bf16, ln=1", err, vals["ms"],
                time_ms(lambda: mlp_int8_cuda.ln_mlp_plain(x, tw.fc1, tw.fc2), reps=2), bnd,
                **{k: v for k, v in vals.items() if k != "ms"})
        else:
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e.update({f"{k}_ln0": v for k, v in vals.items()})
    out.append(e)
    del x
    torch.cuda.empty_cache()
    log("  every W8A8 body in each variant mode:")
    mode_errs = mode_phase(dev)
    for e in out:
        if e["name"] in ("K10_ln_dense", "K11_space_block_allt", "K12_ln_mlp"):
            k = e["name"].split("_")[0]
            e["modes_max_abs_err"] = {m: mode_errs[f"{k}_{m}"] for m in ("bf16_ln", "gelu_fold")}
    return out


def quasi_dense_phase(dev):
    """Phase 12: CoTrackerOnlinePredictor(fast=True) at 70,225 grid points,
    384x512, windows of 16 at step 8, iters=6, over a 48-frame video (5
    windows), (a) variants off and (c) all four on; the launches of the
    fourth window asserted, (c) within 1 px median of (a)."""
    from cotracker_tpu_torch import CoTrackerOnlinePredictor

    grid, frames, S = QD_GRID, QD_FRAMES, T_STREAM
    n, step = grid * grid, S // 2
    n_windows = len(range(0, frames - step, step))
    video = synthetic_video(frames, 384, 512, dev)
    zeros = dict.fromkeys(WRAPPERS, 0)
    runs = {}
    for name, variants in (("a", KernelVariants()), ("c", ALL_ON)):
        pred = CoTrackerOnlinePredictor(fast=True, device="cuda", capacity=frames,
                                        variants=variants)
        n_pad = -(-n // 512) * 512
        k4 = 4 * 6 * -(-n_pad // pred.model.corr_chunk)
        expected = {**zeros, "K1_time_block": 36, "K3_virtual_from_points_proj": 18}
        if name == "a":
            expected.update(K4_corr_volume=k4, K2_space_block=18)
        else:
            expected.update(K4m_corr_mlp1=k4, K11_space_block_allt=18)
        log(f"quasi-dense streaming ({name}): {n} points ({n_pad} padded), variants {variants}:")
        pred(video[:, :1], is_first_step=True, grid_size=grid)
        (tracks, vis), counts, steady = drive_stream(
            lambda ind: pred(video[:, ind : ind + S]), n_windows, n, step)
        check_stream(f"quasi-dense ({name})", tracks, vis, frames, n, counts, expected)
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[name] = dict(tracks=tracks, counts=counts, seconds_per_window=steady,
                          points_frames_per_s=n * step / steady, peak_gib=peak)
        del pred
        torch.cuda.empty_cache()
    med, p90, mx = px_stats(runs["c"]["tracks"], runs["a"]["tracks"])
    p99 = (runs["c"]["tracks"].float() - runs["a"]["tracks"].float()).norm(dim=-1).flatten()
    p99 = p99.sort().values[int(0.99 * (p99.numel() - 1))].item()
    log(f"  (c) against (a): |tracks difference| median {med:.3f} px (bound 1), p90 {p90:.3f}, "
        f"p99 {p99:.3f}, max {mx:.3f} px")
    if not med <= 1.0:
        raise AssertionError("quasi-dense (c) is more than 1 px (median) from (a)")
    for r in runs.values():
        del r["tracks"]
    return runs, dict(median_px=med, p90_px=p90, p99_px=p99, max_px=mx)


def offline_variants_phase(dev, pfs_a):
    """Phase 13: the offline bench workload with all four variants on
    (10,000 points, 60 frames, iters=6): K4m 120, K2 18 (no K11 at T=60),
    K1 36, K3 18, K4 0."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    pred = CoTrackerPredictor(fast=True, device="cuda", variants=ALL_ON)
    video = synthetic_video(T_FRAMES, 384, 512, dev)
    grid = 100
    n_pad = -(-grid * grid // 512) * 512
    expected = {**dict.fromkeys(WRAPPERS, 0), "K1_time_block": 36, "K2_space_block": 18,
                "K3_virtual_from_points_proj": 18,
                "K4m_corr_mlp1": 4 * 6 * -(-n_pad // pred.model.corr_chunk)}
    pred(video, grid_size=grid)  # warm-up
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks, vis = pred(video, grid_size=grid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    n = grid * grid
    log(f"  forward {dt:.3f} s: {n * T_FRAMES / dt:.0f} points*frames/s (variants off, phase 4: "
        f"{pfs_a:.0f}); launches {counts}")
    if counts != expected:
        raise AssertionError(f"offline (c): expected {expected}")
    if tuple(tracks.shape) != (1, T_FRAMES, n, 2) or not torch.isfinite(tracks).all():
        raise AssertionError("offline (c): shapes or non-finite tracks")
    return counts, dict(seconds=dt, points_frames_per_s=n * T_FRAMES / dt)


def ubench_phase():
    """Phase 14: scripts/torch_ubench.py int8pallas corr in this process;
    its launches of K10, K12, K4 and K4m asserted."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_ubench.py")
    spec = importlib.util.spec_from_file_location("torch_ubench", path)
    ub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ub)
    zero_counts()
    res = ub.run(["int8pallas", "corr"], "cuda", reps=UB_REPS)
    counts = read_counts()
    per = 1 + UB_REPS  # one warm-up and UB_REPS timed launches per measurement
    expected = {**dict.fromkeys(WRAPPERS, 0), "K10_ln_dense": per, "K12_ln_mlp": per,
                "K4_corr_volume": 2 * per, "K4m_corr_mlp1": 2 * per}
    log(f"  launches {counts}")
    if counts != expected:
        raise AssertionError(f"micro-benchmark: expected {expected}")
    return counts, res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    for name in ENV.values():  # the variants are set per phase, never by the environment
        os.environ.pop(name, None)
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
    log("training kernels vs plain versions (f32, level 0, training shape and inference chunk):")
    train_kernels = train_kernel_phase(dev)
    torch.cuda.empty_cache()
    log(f"split time-block kernels K8, K9 vs plain versions (bf16, {LONG_TRACKS} and {V} tracks x "
        f"{LONG_T} frames):")
    kernels += split_kernel_phase(dev)
    torch.cuda.empty_cache()

    log("offline main path: CoTrackerPredictor(fast=True), 384x512, iters=6:")
    launches, pfs = main_path(dev)
    torch.cuda.empty_cache()
    counts_a, counts_b, pfs_a, pfs_b = streaming_paths(dev)
    torch.cuda.empty_cache()
    step_r, step_f, step_m, train_metrics = training_phase(dev, smi)
    torch.cuda.empty_cache()
    log("gradients on the card, K4r and K4f training models against the plain model:")
    gradient_phase(dev)
    torch.cuda.empty_cache()
    log(f"long offline path: CoTrackerPredictor(fast=True), 384x512, {LONG_T} frames, iters=6:")
    long_counts, long_metrics = long_path(dev)
    torch.cuda.empty_cache()
    log(f"600-frame video: CoTrackerPredictor(fast=True), 384x512, {VIDEO600_T} frames, "
        f"{VIDEO600_GRID**2} points, iters=6:")
    v600_counts, v600 = video600_path(dev)
    torch.cuda.empty_cache()
    log("evaluation: evaluate.run_eval(fast=True) on a synthetic TAP-Vid DAVIS pickle:")
    eval_counts, eval_secs = evaluation_phase(dev)
    torch.cuda.empty_cache()
    log("variant kernels K4m, K11, K10, K12 vs plain versions (bf16), and every W8A8 body "
        "in each variant mode:")
    variant_kernels = variant_kernel_phase(dev)
    torch.cuda.empty_cache()
    qd_runs, qd_diff = quasi_dense_phase(dev)
    torch.cuda.empty_cache()
    log("offline bench workload with all four variants on: CoTrackerPredictor(fast=True), "
        "10,000 points x 60 frames, iters=6:")
    off_c_counts, off_c = offline_variants_phase(dev, pfs)
    torch.cuda.empty_cache()
    log(f"micro-benchmark: scripts/torch_ubench.py int8pallas corr (reps={UB_REPS}):")
    ub_counts, ub_res = ubench_phase()
    for k in kernels:
        # K1-K4 from the offline forward, K5-K7 from a window of streaming
        # (b), K8 and K9 from the long forward
        name = k["name"]
        k["launches"] = launches[name] or counts_b[name] or long_counts[name]
        k["launches_per_window"] = {"a": counts_a[name], "b": counts_b[name]}
        k["launches_long_forward"] = long_counts[name]
        k["launches_600_frame_forward"] = v600_counts[name]
        k["launches_eval_sequence_a"] = eval_counts[name]
    for k in train_kernels:
        # per training step: K4r in the online K4r run, K4f in the K4f run
        k["launches"] = step_r[k["name"]] or step_f[k["name"]]
        k["launches_per_step"] = {"k4r_run": step_r[k["name"]], "k4f_run": step_f[k["name"]]}
    kernels += train_kernels
    for k in variant_kernels:
        # K4m and K11 from a quasi-dense window with the variants on, K10 and
        # K12 from the micro-benchmark; every kernel's count in each run
        name = k["name"]
        k["launches"] = qd_runs["c"]["counts"][name] or ub_counts[name]
        k["launches_quasi_dense_window"] = {r: qd_runs[r]["counts"][name] for r in qd_runs}
        k["launches_offline_variants_forward"] = off_c_counts[name]
        k["launches_ubench"] = ub_counts[name]
        k["launches_per_train_step_fuse_mlp1"] = step_m[name]
    kernels += variant_kernels
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was never launched on a main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"points*frames/s: offline {pfs:.0f}, streaming (a) {pfs_a:.0f}, streaming (b) {pfs_b:.0f}")
    log(f"training: {train_metrics['ms_per_step']:.1f} ms per online step "
        f"({TRAIN_RES[0]}x{TRAIN_RES[1]}, 24 frames, {TRAIN_TRACKS} tracks, iters={TRAIN_ITERS}), "
        f"peak memory {train_metrics['peak_gib']:.2f} GiB")
    log(f"long offline forward ({LONG_T} frames, 2,500 points): {long_metrics['seconds']:.3f} s, "
        f"{long_metrics['points_frames_per_s']:.0f} points*frames/s, peak memory "
        f"{long_metrics['peak_gib']:.1f} GiB; 600-frame video ({VIDEO600_GRID**2} points, "
        f"first forward): {v600['seconds']:.3f} s, peak memory {v600['peak_gib']:.1f} GiB; "
        f"evaluation seconds {eval_secs} ({smi})")
    for r, v in qd_runs.items():
        log(f"quasi-dense streaming ({r}), {QD_GRID**2} points: {v['seconds_per_window']:.4f} s "
            f"per steady window, {v['points_frames_per_s']:.0f} points*frames/s of new frames, "
            f"peak memory {v['peak_gib']:.1f} GiB")
    log(f"quasi-dense (c) vs (a): {qd_diff}; offline with the variants: {off_c['seconds']:.3f} s, "
        f"{off_c['points_frames_per_s']:.0f} points*frames/s (off: {pfs:.0f}); "
        f"micro-benchmark {json.dumps(ub_res)} ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
