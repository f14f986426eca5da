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
     and the inference chunk (2,048 points x 60 frames), K4r also at 256
     points x 80 frames (two passes) and at the default eval hook's shapes
     (phase 21: 256 x 250 and 128 x 80, levels 0-3): K4r's codes and
     scales bit-identical to its plain version in one device launch, its
     k4_plan printed, K4f
     (3xTF32 tensor cores in f32, FMAs in k order in bf16) within a float32
     bound and, in bf16, within one bf16 ulp, with the bound of each dtype
     under the peak of its products (tf32 for 3xTF32's three, bf16), the
     f32 FMA peak's beside it, and the plain version's gather + torch.bmm
     chain and torch.bmm alone timed beside it;
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
     bf16 is K1's streamed tail with K9's prologue; then every kernel that
     phases 16-19 launch at the shapes they give it (SURFACE: 16,384 x 24,
     3,072 x 60, 2,560 x 24 and 320 x 300 padded tracks x frames, on the
     route the gates pick: K1 or K8 -> K5 -> K9 for the point tokens and
     for the 64 virtual tokens, K2, K3, and K4 at levels 0-3 of one chunk),
     against their plain versions with the bounds above, each phase
     failing if its forward ran at another shape;
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
     offline model (one 16-frame window, K4r 32 per step), 4 steps of the
     online model with K4f instead of K4r (corr_quant_int8=False, K4f 64 per
     step, K4r none; its median ms per step beside (a)'s) and 2 with
     COTRACKER_CORR_FUSE_MLP1=1 (the wrapper's
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
     combination (in bf16 K8's streamed body), bit-identical to its first
     body, both timed, with a library chain (LN in torch, the row codes,
     torch._int_mm) and its device launches a call; K12 (8-block clusters) with the LN on and off at 604,800
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
     24; shapes, finiteness, snap-back;
 16. dense mode: CoTrackerPredictor(fast=True) with no queries and no grid
     on a 24-frame 384x512 video: a grid step of 6 (85x64 points an
     offset), 36 offsets, 3 a forward: 12 forwards of 16,320 tracks (16,384
     padded), the launches of each forward as the gates route it (K1 36, K2
     18, K3 18, K4 192); output (1, 24, 195,840, 2), each track at frame 0
     within 1e-3 px of its pixel, the queries tiling the 510x384 area once;
     seconds and points*frames/s;
 17. a segmentation mask: a 100x100 grid inside a seeded two-ellipse mask at
     60 frames: the kept count against one computed here from the mask, the
     tracks at frame 0 on the kept grid points, the forward's launches;
 18. the reference-format export and the hub: save_reference_checkpoint of
     phase 4's model, hub.cotracker3_offline(checkpoint=path, fast=True):
     state_dict, tracks and visibility bit for bit the original
     predictor's (24 frames, 2,500 points), its launches; a URL raises;
 19. Dynamic Replica: a seeded tree (one sequence of 300 left-camera frames,
     the CLI's sample_len, at 1280x720, uint8, each with a right-camera record; 1,000
     trajectories a frame) through evaluate.run_eval(dataset_name=
     "dynamic_replica", fast=True): the forward's launches as the gates
     route its track and frame count, finite metrics, the result files;
     seconds per sequence;
 20. the demos as their entry points build them (the plain float32 model)
     on a seeded 24-frame 384x512 .npy video: demo.track_video's tracks and
     rendered frames, online_demo.track_stream's tracks against its
     predictor driven by hand with the loop's chunks; where OpenCV is
     missing, no mp4 (save_video's ImportError names cv2);
 21. training from a Kubric tree: a MOVi-f-shaped tree written from a seed
     with write_png (3 sequences of 24 frames at 512x512, 2,000 tracks,
     the filter types mixed by row); read_png's ms per frame (a sequence
     decoded together, one frame alone) against the frames written; a
     24-frame sample's read with and without augmentations; then the
     trainer's command line, trainer.main, at its full width (384x512
     crop, the online model in windows of 16, 768 tracks, iters=4,
     augmentations on, the clip length and frame rate drawn per sample)
     for 6 steps with a checkpoint and the default eval hook (run_test_eval
     on phase 10's TAP-Vid pickle) every 3: every step's K4r count that of
     its clip's windows (4 levels x 4 iterations x windows x 2), no other
     kernel; losses finite, the checkpoints and eval_records.jsonl there,
     each eval hook K4r 48 (2 sequences x 4 levels x 6 iterations) at the
     (points, frames) that phase 3 held to the plain version; the loader
     reads in processes (the reader's read_in_processes): the median ms of
     its two-window steps beside training (a)'s and beside the same command
     line with the reads in the loader's threads (6 steps, no eval); a
     host loop of 10,000 small torch ops alone and beside the loader
     reading in threads and in processes; the eval forward's kernel
     launches by kernel (torch.profiler); the
     visualisation hook's render_train_batch on the card on one batch (K4r
     16; an mp4 where OpenCV imports); with cv2 made unimportable, its
     cadence raises before step 0, naming cv2;
 22. the interactive demo's server in a thread (the plain float32 model as
     its entry point builds it) on a seeded 24-frame .npy video: the page,
     /frame.png (frame 0 bit for bit), /track with two points and a 10x10
     grid (the mp4 where OpenCV imports); with cv2 made unimportable, its
     JSON says why no mp4 was written and /result.mp4 answers 404 with
     those words.
No phase is cut in depth. The line before the last is a JSON object with
one entry per kernel; the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa  # library_ms yardstick only

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))

from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, corr_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels import mlp_int8_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels.variants import ENV, KernelVariants  # noqa: E402
from cotracker_tpu_torch.utils.profiling import device_launches  # noqa: E402
from torch_library_chains import k4f_windows, k10_library_chain, k12_library_chain  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_OPS = 989e12
F32_OPS = 67e12
TF32_OPS = 494.7e12  # tensor cores, dense: K4f's f32 route (3xTF32)

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
# the training shape (768 points x 16 frames) and the inference chunk;
# K4r past 64 frames, where K4's cluster kernel takes two passes
TRAIN_SHAPE, INFER_SHAPE, K4R_TWO_PASS = (768, 16), (CHUNK, T_FRAMES), (256, 80)
# the default eval hook's K4r calls (the training model in eval mode on the
# evaluation phase's sequences, one call a level and iteration over the
# whole clip): A's 256 tracks x 250 frames (8 blocks of 32 frames each), B's
# 128 padded tracks x 80 frames; their keys' suffixes
K4R_EVAL = {(256, 250): "_t250", (128, 80): "_m128_t80"}
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


def k4_operands(g, dev, hw, T, points=CHUNK):
    """K4's operands at one pyramid level for a chunk of `points` points:
    unit features and support in bf16, coordinates uniform over the level."""
    bf = torch.bfloat16
    Hh, W = hw
    fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g).to(dev), dim=-1)
    fmq = corr_cuda.build_int8_level(fm.to(bf), 3)
    del fm
    sup = torch.nn.functional.normalize(
        torch.randn(1, 49, points, 128, generator=g).to(dev), dim=-1).to(bf)
    supq, _ = corr_cuda.quantize_support(sup, bf)
    coords = (torch.rand(1, T, points, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
    starts, wxy = corr_cuda.level_operands(coords.to(bf), 1, T, Hh, W, 3)
    return fmq, supq.reshape(points, 49, 128), starts, wxy


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
    """Bytes (of the level map only the pixels the windows read) against the
    s8 products at the int8 peak and the combine at the f32 peak."""
    fmq, supq, starts, wxy = ops
    n = supq.shape[0] * starts.shape[1] * 64 * 49
    return bound(window_bytes(fmq, starts) + nbytes(supq, starts, wxy, vol, scale),
                 [(n * 128 * 2, INT8_OPS), (n * 10, F32_OPS)])


def k1_bound(x, w):
    """K1 (and K8 -> K5 -> K9's work): x read and written once, the weights
    once; the W8A8 products at the int8 peak, the time core at bf16's."""
    M, T, _ = x.shape
    return bound(2 * nbytes(x) + nbytes(*[t for q in w for t in q]),
                 [(M * T * 2 * C * (3 * C + C + 2 * HID), INT8_OPS),
                  (M * T * HEADS * 4 * T * DH, BF16_OPS)])


def k2_bound(x, kv, w):
    M, T, _ = x.shape
    return bound(2 * nbytes(x) + nbytes(kv) + nbytes(*[t for q in w for t in q]),
                 [(M * T * 2 * C * (2 * C + 2 * HID), INT8_OPS),
                  (M * T * HEADS * 4 * kv.shape[1] * DH, BF16_OPS)])


def k3_bound(q, x, wkv, kbias, out):
    N, T, _ = x.shape
    return bound(nbytes(q, x, wkv.w, kbias, out),
                 [(N * T * 2 * C * 2 * C, INT8_OPS), (T * HEADS * q.shape[1] * N * 4 * DH, BF16_OPS)])


def k5_bound(x, kv, out):
    M, T, _ = x.shape
    return bound(nbytes(x, kv, out), [(M * T * HEADS * 4 * T * DH, BF16_OPS)])


def k8_bound(x, w):
    M, T, _ = x.shape
    return bound(nbytes(x) * 4 + nbytes(*[t for q in w for t in q]),
                 [(M * T * 2 * C * 3 * C, INT8_OPS)])


def k9_bound(x, w):
    M, T, _ = x.shape
    return bound(nbytes(x) * 3 + nbytes(*[t for q in w for t in q]),
                 [(M * T * 2 * (C * C + 2 * C * HID), INT8_OPS)])


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
              k1_bound(x, tw))
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
              k2_bound(x, kv, sw), lib_ms)
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
              k3_bound(q, x, wkv, kbias, out), lib_ms)
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
              k5_bound(x, kv5, out),
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
    bnd = k3_bound(q, x, wkv, qbias, out)
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
            "bound_ms" + sfx: k5_bound(x, kv5, out)[0],
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
    the inference chunk (`*_t60`); K4r also past 64 frames (`*_t80`: K4's
    cluster kernel in two passes) and at the eval hook's shapes (K4R_EVAL),
    where levels 1-3 are held bit for bit to the plain version too."""
    g = torch.Generator().manual_seed(3)
    Hh, W = LVL0
    out = {}
    for (n, T) in (TRAIN_SHAPE, INFER_SHAPE, K4R_TWO_PASS, *K4R_EVAL):
        sfx = "" if (n, T) == TRAIN_SHAPE else K4R_EVAL.get((n, T), f"_t{T}")
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g).to(dev), dim=-1)
        sup = torch.nn.functional.normalize(torch.randn(1, n, 49, 128, generator=g).to(dev), dim=-1)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, wxy = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        Tp = starts.shape[1]
        mm = n * Tp * 64 * 49 * 128 * 2  # multiply-adds of the window products, as operations
        k4r_entry(out, fm, sup, starts, n, T, mm, sfx)
        if (n, T) in K4R_EVAL:
            k4r_levels_check(out, g, sup, coords, n, T, sfx)
        elif (n, T) != K4R_TWO_PASS:
            for dtype in (torch.float32, torch.bfloat16):
                k4f_entry(out, fm, sup, starts, n, T, Tp, mm, dtype, sfx)
        for k in out.values():
            if ("ms" + sfx) in k:
                log(f"  {k['name']} {n}x{T}: {k['ms' + sfx]:.3f} ms (plain {k['plain_ms' + sfx]:.3f} ms, "
                    f"bound {k['bound_ms' + sfx]:.3f} ms by {k['bound_by' + sfx]})")
        del fm, sup
    return [out[k] for k in sorted(out)]


def k4r_entry(out, fm, sup, starts, n, T, mm, sfx):
    """K4r (K4's cluster kernel in its K4r mode, on k4_plan) against its
    plain version: codes and scales bit-identical, one device launch a
    call; its plan, time, the plain version's and the bound (bytes against
    the s8 products at the int8 peak; of the level map only the pixels the
    windows cover)."""
    fmq = corr_cuda.build_int8_level(fm, 3)
    supq, _ = corr_cuda.quantize_support(sup.transpose(1, 2), torch.float32)
    supq = supq.reshape(n, 49, 128)
    fn = lambda: corr_cuda.corr_volume_raw_int8(fmq, supq, starts)  # noqa: E731
    vol, scale = fn()
    rvol, rscale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
    codes, scales = int((vol != rvol).sum().item()), int((scale != rscale).sum().item())
    plan = corr_cuda.k4_plan(n, starts.shape[1])
    launches = device_launches(fn)
    log(f"  K4r raw int8 volume {n} points x {T} frames: {codes} codes and {scales} scales differ "
        f"(bound 0); plan: clusters of {plan.cluster}, {plan.frames} frames a block, "
        f"{'held on chip' if plan.hold else 'two passes'}; {launches} device launch(es) a call")
    if codes or scales:
        raise AssertionError("K4r: kernel disagrees with its plain version")
    if launches != 1:
        raise AssertionError("K4r is one device launch a call")
    e = out.setdefault("K4r_corr_volume_raw", dict(
        name="K4r_corr_volume_raw", route="cuda", source=SRC_CORR,
        replaces="cotracker_tpu/ops/kernels/corr_pallas.py:105", launches=0, max_abs_err=0.0,
        shape=f"level 0 (96x128), {TRAIN_SHAPE[0]} points x {TRAIN_SHAPE[1]} frames "
              f"(also *_t{INFER_SHAPE[1]}: {INFER_SHAPE[0]} x {INFER_SHAPE[1]}; "
              f"*_t{K4R_TWO_PASS[1]}: {K4R_TWO_PASS[0]} x {K4R_TWO_PASS[1]}, two passes; "
              + "; ".join(f"*{k}: {m} x {t}, the eval hook's" for (m, t), k in K4R_EVAL.items())
              + ")"))
    bnd = bound(window_bytes(fmq, starts) + nbytes(supq, starts, vol, scale),
                [(mm, INT8_OPS)])
    e.update({"ms" + sfx: time_ms(fn),
              "plain_ms" + sfx: time_ms(lambda: corr_cuda.corr_volume_raw_plain(fmq, supq, starts),
                                        reps=2),
              "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1], "library_ms" + sfx: None,
              "plan" + sfx: plan._asdict(), "device_launches" + sfx: launches})
    del fmq, supq, vol, rvol


def k4r_levels_check(out, g, sup, coords, n, T, sfx):
    """K4r at levels 1-3 (48x64 to 12x16) of `n` points x `T` frames: codes
    and scales bit-identical to its plain version, one device launch a call."""
    supq, _ = corr_cuda.quantize_support(sup.transpose(1, 2), torch.float32)
    supq = supq.reshape(n, 49, 128)
    for lvl in (1, 2, 3):
        Hh, W = LVL0[0] >> lvl, LVL0[1] >> lvl
        fm = torch.nn.functional.normalize(
            torch.randn(1, T, Hh, W, 128, generator=g).to(supq.device), dim=-1)
        fmq = corr_cuda.build_int8_level(fm, 3)
        starts, _ = corr_cuda.level_operands(coords / (1 << lvl), 1, T, Hh, W, 3)
        fn = lambda: corr_cuda.corr_volume_raw_int8(fmq, supq, starts)  # noqa: E731
        vol, scale = fn()
        rvol, rscale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
        codes, scales = int((vol != rvol).sum().item()), int((scale != rscale).sum().item())
        launches = device_launches(fn)
        log(f"  K4r {n} points x {T} frames at level {lvl} ({Hh}x{W}): {codes} codes and "
            f"{scales} scales differ (bound 0); {launches} device launch(es) a call")
        if codes or scales or launches != 1:
            raise AssertionError(f"K4r at level {lvl}: disagrees with its plain version or "
                                 "is not one launch")
        out["K4r_corr_volume_raw"].setdefault("levels_exact" + sfx, [0]).append(lvl)
        del fm, fmq, vol, rvol


def k4f_entry(out, fm, sup, starts, n, T, Tp, mm, dtype, sfx):
    """K4f in `dtype` against its plain version: f32 (3xTF32 on the tensor
    cores) within K4F_TOL of the largest |g|, bf16 (f32 FMAs in the plain
    version's k order) within one bf16 ulp (2^-8) of it, the elements that
    differ counted. Its time, the plain version's (the window gather +
    torch.bmm, TF32 off: also the library chain), torch.bmm alone, and the
    bound of its dtype: bytes (of the level map only the pixels the windows
    read) against the products at the peak of their type, 3xTF32's three
    tf32 products at the tf32 peak (f32) or one bf16 product at the bf16
    peak (bf16); beside it the products at the f32 FMA
    peak (bound_f32_fma_ms: the first body's bound, and the peak of the bf16
    route's CUDA-core FMAs)."""
    f32 = dtype == torch.float32
    sfx = sfx + ("" if f32 else "_bf16")
    fmf = corr_cuda.build_float_level(fm, 3, dtype)
    supf = sup.reshape(n, 49, 128).to(dtype).contiguous()
    vol = corr_cuda.corr_volume_float(fmf, supf, starts)
    ref = corr_cuda.corr_volume_float_plain(fmf, supf, starts)
    err = (vol.float() - ref.float()).abs().max().item()
    lim = (K4F_TOL if f32 else 2.0**-8) * ref.float().abs().max().item()
    what = "f32" if f32 else "bf16"
    differ = int((vol != ref).sum().item())
    log(f"  K4f raw {what} volume {n} points x {T} frames: max_abs_err {err:.3e} (bound {lim:.3e}), "
        f"{differ} of {vol.numel()} elements differ")
    if not err <= lim:
        raise AssertionError(f"K4f ({what}): kernel disagrees with its plain version")
    e = out.setdefault("K4f_corr_volume_float", dict(
        name="K4f_corr_volume_float", route="cuda", source=SRC_CORR,
        replaces="cotracker_tpu/ops/kernels/corr_pallas.py:105", launches=0, max_abs_err=0.0,
        shape=f"level 0 (96x128), {TRAIN_SHAPE[0]} points x {TRAIN_SHAPE[1]} frames, f32 "
              f"(also *_t60: {INFER_SHAPE[0]} x {INFER_SHAPE[1]}; *_bf16: bf16)"))
    if f32:
        e["max_abs_err"] = max(e["max_abs_err"], err)
    else:
        e["max_abs_err_bf16"] = max(e.get("max_abs_err_bf16", 0.0), err)
    nb = window_bytes(fmf, starts) + nbytes(supf, starts, vol)
    ops = (3 * mm, TF32_OPS) if f32 else (mm, BF16_OPS)
    bnd = bound(nb, [ops])
    fn = lambda: corr_cuda.corr_volume_float(fmf, supf, starts)  # noqa: E731
    plain = lambda: corr_cuda.corr_volume_float_plain(fmf, supf, starts)  # noqa: E731
    plain_ms = time_ms(plain, reps=2)
    win = k4f_windows(fmf, starts)
    e.update({"ms" + sfx: time_ms(fn), "plain_ms" + sfx: plain_ms,
              "bound_ms" + sfx: bnd[0], "bound_by" + sfx: bnd[1],
              "bound_bytes_ms" + sfx: 1e3 * nb / HBM_BPS,
              "bound_ops_ms" + sfx: 1e3 * ops[0] / ops[1],
              "bound_f32_fma_ms" + sfx: 1e3 * mm / F32_OPS,
              "elements_differing" + sfx: differ,
              "library_ms" + sfx: plain_ms,
              "library_bmm_only_ms" + sfx: time_ms(lambda: torch.bmm(win, supf.transpose(1, 2))),
              "device_launches" + sfx: device_launches(fn)})
    if e["device_launches" + sfx] != 1:
        raise AssertionError("K4f is one device launch a call")
    log(f"  K4f {what} {n}x{T}: {e['ms' + sfx]:.3f} ms (plain version = library chain "
        f"{plain_ms:.3f} ms, torch.bmm alone "
        f"{e['library_bmm_only_ms' + sfx]:.3f} ms, bound {bnd[0]:.3f} ms by {bnd[1]}: bytes "
        f"{e['bound_bytes_ms' + sfx]:.3f}, operations {e['bound_ops_ms' + sfx]:.3f})")
    del fmf, supf, vol, ref, win


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
    out = {}
    for M, sfx in ((LONG_TRACKS, ""), (LONG_FORWARD_TRACKS, "_m2560"), (V, "_virtual")):
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
        bnd = k8_bound(x, w)
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
        bnd = k9_bound(x, w)
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
    return launches, n * T_FRAMES / dt, pred


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


def median_ms(per_step):
    """The median of train_run's step times."""
    ms = sorted(m for _, _, m in per_step)
    return ms[len(ms) // 2] if len(ms) % 2 else 0.5 * (ms[len(ms) // 2 - 1] + ms[len(ms) // 2])


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
        ms_step = median_ms(run1[2:])
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

        log("training (c): online model with K4f (corr_quant_int8=False), 4 steps:")
        exp = os.path.join(root, "k4f")
        run_f = train_run(exp, clip, 4, corr_quant_int8=False, **online)
        check_launches("training (c)", run_f, {**zeros, "K4f_corr_volume_float": k4r})
        fl = [r["total_loss"] for r in read_losses(exp)]
        ms_step_f = median_ms(run_f[1:])
        log(f"  total loss per step {[round(x, 4) for x in fl]}; ms per step "
            f"{[round(m, 1) for _, _, m in run_f]}; median of steps 2-4 {ms_step_f:.1f} ms "
            f"(training (a): {ms_step:.1f} ms, median of steps 3-8)")
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
        ms_per_step_k4f=[m for _, _, m in run_f], ms_per_step_k4f_median=ms_step_f,
        ms_per_step_k4m=[m for _, _, m in run_m])


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


def run_eval_counted(cfg):
    """evaluate.run_eval(cfg) with the launch counts zeroed before and read
    after each sequence's EvaluationPredictor call; returns the metrics and,
    per sequence, (counts, seconds, video shape, queries)."""
    from cotracker_tpu_torch.evaluation import evaluation_predictor as ep
    from cotracker_tpu_torch.evaluation.evaluate import run_eval

    per_call, call = [], ep.EvaluationPredictor.__call__

    def counted(self, video, queries):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, video, queries)
        torch.cuda.synchronize()
        per_call.append((read_counts(), time.perf_counter() - t0, video.shape, queries.shape[1]))
        return out

    ep.EvaluationPredictor.__call__ = counted
    try:
        return run_eval(cfg), per_call
    finally:
        ep.EvaluationPredictor.__call__ = call


def evaluation_phase(dev):
    """Phase 10 (see the module docstring). Returns the launch counts of
    sequence A's forward and the seconds per sequence."""
    from cotracker_tpu_torch.datasets.tap_vid import TapVidDataset
    from cotracker_tpu_torch.evaluation import evaluation_predictor as ep
    from cotracker_tpu_torch.evaluation.evaluate import DefaultConfig
    from cotracker_tpu_torch.models.build import build_cotracker

    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    zeros = dict.fromkeys(WRAPPERS, 0)
    try:
        pkl = os.path.join(root, "tapvid_davis.pkl")
        write_tapvid_pickle(pkl)
        cfg = DefaultConfig(exp_dir=os.path.join(root, "exp"), dataset_root=pkl,
                            dataset_name="tapvid_davis_first", fast=True, device="cuda")
        metrics, per_call = run_eval_counted(cfg)
        secs = {}
        for (name, T, N, want), (counts, sec, shape, _) in zip(EVAL_SEQS, per_call):
            frames = shape[1]
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
        bnd = k2_bound(x, kv, sw)
        q6 = hm(x.transpose(0, 1))  # (T, H, N, D)
        lib_ms, lib_parts = library_chain(
            gd, dev, N * T, ((C, C), (C, C), (C, HID), (HID, C)),
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
                k10 = lambda: mlp_int8_cuda.fused_ln_dense_int8(x, lin_, **kw)  # noqa: E731
                first = lambda: mlp_int8_cuda._ln_dense_first(  # noqa: E731
                    x, lin_, 1e-6, ln, kw["gamma"], kw["beta"], residual, False)
                o = k10()
                tag = f"ln={int(ln)} affine={int(affine)} residual={int(residual)}"
                diff = int((o != first()).sum().item())
                log(f"  K10 {tag}: elements differing from its first body {diff} (bound 0)")
                if diff:
                    raise AssertionError(f"K10 {tag} differs from its first body")
                ref = mlp_int8_cuda.ln_dense_plain(x, lin_, **kw)
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
                        "K10_ln_dense", SRC_K1, "cotracker_tpu/ops/kernels/mlp_int8_pallas.py:203",
                        f"{UB_ROWS} rows x 384 -> {N}, bf16, ln=1", err, time_ms(k10),
                        time_ms(lambda: mlp_int8_cuda.ln_dense_plain(x, lin_, **kw), reps=2), bnd,
                        time_ms(lambda: k10_library_chain(x, lin_, **kw), reps=2),
                        ms_by_flags={}, first_ms_by_flags={}, device_launches=device_launches(k10))
                e["max_abs_err"] = max(e["max_abs_err"], err)
                e["ms_by_flags"][tag] = time_ms(k10)
                e["first_ms_by_flags"][tag] = time_ms(first, reps=2)
                if device_launches(k10) != 1:
                    raise AssertionError(f"K10 {tag} is one device launch a call")
    log(f"  K10 ms by flags {e['ms_by_flags']}; its first body {e['first_ms_by_flags']}")
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


# ------------------------------------------------- the inference surface
# (phases 16-20): dense and segmentation-mask queries, the reference-format
# export and the hub, Dynamic Replica evaluation, the demos

DENSE_T = 24  # dense mode's video: 36 pixel offsets of an 85x64 grid, 3 a forward
SEGM_T, SEGM_GRID = 60, 100
HUB_T, HUB_GRID = 24, 50
# Dynamic Replica's sequence: the CLI's sample_len of 300 frames at 1280x720
DR_T, DR_HW, DR_TRACKS = 300, (720, 1280), 1000
# the shapes phases 16-19 give the kernels: (padded tracks, frames, real
# tracks, the rest masked as padding); each phase fails if its forward ran
# at another shape, so the kernels checked at these are the path's
SURFACE = {"dense": (16384, DENSE_T, 16320), "segm": (3072, SEGM_T, 2873),
           "hub": (2560, HUB_T, 2500), "dynamic_replica": (320, DR_T, 276)}


def check_surface_shape(phase, n_pad, T):
    if SURFACE[phase][:2] != (n_pad, T):
        raise AssertionError(f"{phase}: the forward ran at {n_pad} tracks x {T} frames, not at "
                             f"the shape the kernels were checked at, {SURFACE[phase][:2]}")
DEMO_T = 24


def route_counts(n_pad, T, corr_chunk=CHUNK):
    """The launches of one offline forward (iters=6, 3 time and 3 space
    blocks) at n_pad tracks of T frames, as the JAX package's gates route
    it (ops/kernels/gates.py): no W8A8 block below the track gate (K5
    between plain projections); else K2, K3, and each token kind's time
    blocks on K1 or, past its tile cap, the split K8 -> K5 -> K9."""
    from cotracker_tpu_torch.ops.kernels import gates

    want = {**dict.fromkeys(WRAPPERS, 0), "K4_corr_volume": 4 * 6 * -(-n_pad // corr_chunk)}
    if not gates.space_tile_ok(n_pad):
        want["K5_time_attention"] = 36
        return want
    want.update(K2_space_block=18, K3_virtual_from_points_proj=18)
    for rows, cap in ((n_pad, gates.POINT_TOKENS), (V, gates.FLAT_TOKENS)):
        if gates.pick_time_tile(rows, T, cap) is not None:
            want["K1_time_block"] += 18
        else:
            for k in ("K8_ln_qkv", "K5_time_attention", "K9_attnout_mlp"):
                want[k] += 18
    return want


def per_forward_counts(pred):
    """Record the launch counts of each forward of `pred` (a
    CoTrackerPredictor) in the returned list, which its _sparse_forward
    appends to."""
    rec, forward = [], pred._sparse_forward

    def counted(*a, **k):
        before = read_counts()
        out = forward(*a, **k)
        rec.append({n: c - before[n] for n, c in read_counts().items()})
        return out

    pred._sparse_forward = counted
    return rec


def surface_kernel_phase(dev, kernels):
    """Every kernel that phases 16-19 launch, against its plain version at
    the shapes those phases give it (SURFACE), on the route that
    route_counts derives from the gates: the point tokens' time block (K1,
    or past the frame gate K8 -> K5 -> K9, K5 on K8's q and kv and K9 on
    K5's output), the virtual tokens' (V tracks), K2 and K3 at the padded
    tracks, K4 at each pyramid level on one chunk of the forward. Bounds as
    in the earlier kernel phases. The numbers go into each kernel's entry
    of `kernels` under `*_m{tracks}_t{frames}` (K4: `*_m{points}_t{frames}_l{level}`)."""
    from cotracker_tpu_torch.ops.kernels import gates

    g = torch.Generator().manual_seed(21)
    bf = torch.bfloat16
    by_name = {k["name"]: k for k in kernels}
    tw = mlp_int8_cuda.TimeBlockWeights(lin(g, 3 * C, C, dev), lin(g, C, C, dev),
                                        lin(g, HID, C, dev), lin(g, C, HID, dev))
    sw = mlp_int8_cuda.SpaceBlockWeights(lin(g, C, C, dev), lin(g, C, C, dev),
                                         lin(g, HID, C, dev), lin(g, C, HID, dev))
    wkv = lin(g, 2 * C, C, dev)
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # shapes already checked, and by which kernels: kernel_phase's offline chunk, every level
    checked = {("K4_corr_volume", CHUNK, T_FRAMES): {"K4_corr_volume"}}

    def record(name, sfx, err, fn, plain, bnd, library=None, **extra):
        e = by_name[name]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        vals = {"err": err, "ms": time_ms(fn), "plain_ms": time_ms(plain, reps=1),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None if library is None else time_ms(library), **extra}
        e.update({k + sfx: v for k, v in vals.items()})
        lib = "" if library is None else f", library call {vals['library_ms']:.3f} ms"
        log(f"  {name}{sfx}: {vals['ms']:.3f} ms (plain {vals['plain_ms']:.3f} ms{lib}, bound "
            f"{bnd[0]:.3f} ms by {bnd[1]})")

    def time_block(M, T, cap):
        """K1 where the frame gate takes M x T, else K8 -> K5 -> K9."""
        sfx = f"_m{M}_t{T}"
        x = torch.randn(M, T, C, generator=g).to(dev, bf)
        if gates.pick_time_tile(M, T, cap) is not None:
            out = mlp_int8_cuda.fused_time_block_int8(x, tw, HEADS, DH)
            err = check_close(f"K1 time block {M}x{T}", out,
                              mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH), 0.01, 0.05)
            record("K1_time_block", sfx, err,
                   lambda: mlp_int8_cuda.fused_time_block_int8(x, tw, HEADS, DH),
                   lambda: mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH), k1_bound(x, tw),
                   plan=mlp_int8_cuda.k1_plan(M, T)._asdict())
            return {"K1_time_block"}
        q, kv = mlp_int8_cuda.fused_ln_qkv_int8(x, tw.qkv)
        rq, rkv = mlp_int8_cuda.ln_qkv_plain(x, tw.qkv)
        o, r = torch.cat([q, kv], -1), torch.cat([rq, rkv], -1)
        err = check_close(f"K8 ln + q|kv {M}x{T}", o, r, 2.0**-9, 2.0**-7)
        frac = bf16_ulp_frac(o, r)
        log(f"    elements further than one bf16 ulp: {frac:.2e} (bound 1e-2)")
        if frac > 1e-2:
            raise AssertionError("K8: kernel disagrees with its plain version")
        del o, r, rq, rkv
        record("K8_ln_qkv", sfx, err, lambda: mlp_int8_cuda.fused_ln_qkv_int8(x, tw.qkv),
               lambda: mlp_int8_cuda.ln_qkv_plain(x, tw.qkv), k8_bound(x, tw))
        a = attention_cuda.fused_time_attention(q, kv, HEADS, DH)
        err = check_close(f"K5 time attention {M}x{T}", a,
                          attention_cuda.time_attention_plain(q, kv, HEADS, DH), *CORE_TOL)
        record("K5_time_attention", sfx, err,
               lambda: attention_cuda.fused_time_attention(q, kv, HEADS, DH),
               lambda: attention_cuda.time_attention_plain(q, kv, HEADS, DH),
               k5_bound(q, kv, a), lambda: sdpa(hm(q), hm(kv[..., :C]), hm(kv[..., C:])),
               plan=attention_cuda.k5_plan(T, HEADS, True)._asdict())
        y = mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, tw)
        err = check_close(f"K9 out + MLP {M}x{T}", y,
                          mlp_int8_cuda.attnout_mlp_plain(a, x, tw), 0.01, 0.05)
        record("K9_attnout_mlp", sfx, err,
               lambda: mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, tw),
               lambda: mlp_int8_cuda.attnout_mlp_plain(a, x, tw), k9_bound(x, tw))
        return {"K8_ln_qkv", "K5_time_attention", "K9_attnout_mlp"}

    def space_blocks(N, T, real):
        """K2 and K3 at N tracks, the last N - real masked as the predictors'
        padding."""
        sfx = f"_m{N}_t{T}"
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        kv = torch.randn(T, V, 2 * C, generator=g).to(dev, bf)
        out = mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH)
        err = check_close(f"K2 space block {N}x{T}", out,
                          mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH), 0.01, 0.05)
        record("K2_space_block", sfx, err,
               lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, sw, HEADS, DH),
               lambda: mlp_int8_cuda.space_block_plain(x, kv, sw, HEADS, DH),
               k2_bound(x, kv, sw))
        kbias = torch.zeros(N, device=dev)
        kbias[real:] = attention_cuda.NEG_BIG
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        args = (q, x, wkv, gamma, beta, HEADS, DH, kbias)
        out = attention_cuda.fused_virtual_from_points_proj(*args)
        err = check_close(f"K3 virtual<-points {N}x{T}", out,
                          attention_cuda.v2p_proj_plain(*args), 0.01, 0.05)
        record("K3_virtual_from_points_proj", sfx, err,
               lambda: attention_cuda.fused_virtual_from_points_proj(*args),
               lambda: attention_cuda.v2p_proj_plain(*args), k3_bound(*args[:3], kbias, out),
               plan=attention_cuda.k3_plan(N, T, V, bf, sms=sms)._asdict())
        return {"K2_space_block", "K3_virtual_from_points_proj"}

    def corr(points, T):
        for level, hw in enumerate((LVL0,) + tuple(m[1] for m in K4_MORE[:3])):
            ops = k4_operands(g, dev, hw, T, points)
            vol, scale = k4_exact(f"{hw[0]}x{hw[1]}, {points} points x {T}", ops)
            record("K4_corr_volume", f"_m{points}_t{T}_l{level}", 0.0,
                   lambda: corr_cuda.corr_volume_int8(*ops), lambda: k4_plain(*ops),
                   k4_bound(ops, vol, scale), plan=corr_cuda.k4_plan(points, T)._asdict())
            del ops, vol, scale
        return {"K4_corr_volume"}

    for phase, (n_pad, T, real) in SURFACE.items():
        want = {k for k, c in route_counts(n_pad, T).items() if c}
        covered = set()
        for key, fn in ((("time", n_pad, T), lambda: time_block(n_pad, T, gates.POINT_TOKENS)),
                        (("time", V, T), lambda: time_block(V, T, gates.FLAT_TOKENS)),
                        (("space", n_pad, T), lambda: space_blocks(n_pad, T, real)),
                        (("K4_corr_volume", min(n_pad, CHUNK), T),
                         lambda: corr(min(n_pad, CHUNK), T))):
            if key[0] == "space" and not gates.space_tile_ok(n_pad):
                continue
            if key not in checked:
                checked[key] = fn()
                torch.cuda.empty_cache()
            covered |= checked[key]
        log(f"  {phase} ({n_pad} x {T}): its forward launches {sorted(want)}, checked at its "
            f"shapes {sorted(covered)}")
        if covered != want:
            raise AssertionError(f"{phase}: the kernels checked are not those its route launches")


def dense_phase(dev):
    """Phase 16: dense mode, CoTrackerPredictor(fast=True) with no queries
    and no grid on a 384x512 video: a grid step of 6 (85 x 64 = 5,440
    points an offset), 36 offsets, 3 a forward: 12 forwards of 16,320
    tracks (16,384 padded). Launches of each forward, shapes, snap-back of
    every track at frame 0 onto its pixel, the union of the queries tiling
    the 510 x 384 area once; seconds and points*frames/s."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    pred = CoTrackerPredictor(fast=True, device="cuda")
    video = synthetic_video(DENSE_T, 384, 512, dev)
    step = 512 // 80
    gw, gh = 512 // step, 384 // step
    per = pred.dense_offsets_per_forward
    n_fwd, n = -(-step * step // per), gw * gh * step * step
    n_pad = -(-gw * gh * per // 512) * 512
    check_surface_shape("dense", n_pad, DENSE_T)
    want = route_counts(n_pad, DENSE_T)
    # warm-up: one forward at the dense track count
    q = torch.zeros(1, gw * gh * per, 3)
    q[..., 1:] = torch.rand(1, gw * gh * per, 2, generator=torch.Generator().manual_seed(16)) * 383
    pred(video, queries=q)
    rec = per_forward_counts(pred)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks, vis = pred(video)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {n_fwd} forwards of {gw * gh * per} tracks ({n_pad} padded): {dt:.3f} s for {n} points "
        f"x {DENSE_T} frames = {n * DENSE_T / dt:.0f} points*frames/s; peak memory {peak:.1f} GiB")
    log(f"  launches per forward {rec[0]} (expected {want}); in all {total}")
    if len(rec) != n_fwd or any(r != want for r in rec):
        raise AssertionError(f"dense: a forward did not launch the kernels as expected: {rec}")
    if total != {k: n_fwd * c for k, c in want.items()}:
        raise AssertionError("dense: launches outside the forwards")
    if tuple(tracks.shape) != (1, DENSE_T, n, 2) or tuple(vis.shape) != (1, DENSE_T, n):
        raise AssertionError(f"dense: shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
    if not torch.isfinite(tracks).all():
        raise AssertionError("dense: non-finite tracks")
    offs = np.arange(step * step)
    qx = (np.tile(np.arange(gw), gh)[None] * step + (offs % step)[:, None]).reshape(-1)
    qy = (np.repeat(np.arange(gh), gw)[None] * step + (offs // step)[:, None]).reshape(-1)
    first = tracks[0, 0].cpu().numpy()
    snap = float(np.abs(first - np.stack([qx, qy], -1)).max())
    xy = np.rint(first).astype(np.int64)
    inside = (xy >= 0).all() and (xy[:, 0] < gw * step).all() and (xy[:, 1] < gh * step).all()
    hits = np.bincount(xy[:, 1] * gw * step + xy[:, 0], minlength=gw * gh * step * step)
    log(f"  frame 0: max |track - its pixel| {snap:.2e} px (bound 1e-3); every pixel of the "
        f"{gw * step}x{gh * step} area queried once: {bool(inside and (hits == 1).all())}")
    if not (snap <= 1e-3 and inside and (hits == 1).all() and bool(vis[0, 0].all())):
        raise AssertionError("dense: the queries do not tile the frame, or snap-back failed")
    return rec[0], dict(seconds=dt, points_frames_per_s=n * DENSE_T / dt, peak_gib=peak,
                        forwards=n_fwd, tracks_per_forward=gw * gh * per)


def segm_phase(dev):
    """Phase 17: a 100 x 100 grid inside a seeded segmentation mask (two
    ellipses) at 60 frames: the kept count against one computed from the
    mask and a grid built here, the tracks at frame 0 on the kept grid
    points, the launches of the forward."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[:384, :512]
    mask = np.zeros((384, 512), np.float32)
    for _ in range(2):
        cy, cx, ry, rx = rng.uniform(80, 300), rng.uniform(100, 400), *rng.uniform(50, 140, 2)
        mask[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 1
    margin = 512 / 64  # the grid: SEGM_GRID^2 points, W/64 from each border, row-major
    gy, gx = np.meshgrid(np.linspace(margin, 384 - margin, SEGM_GRID),
                         np.linspace(margin, 512 - margin, SEGM_GRID), indexing="ij")
    pts = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)
    keep = mask[np.rint(pts[:, 1]).astype(int), np.rint(pts[:, 0]).astype(int)] > 0
    n = int(keep.sum())
    n_pad = -(-(n + 36) // 512) * 512
    check_surface_shape("segm", n_pad, SEGM_T)
    want = route_counts(n_pad, SEGM_T)
    pred = CoTrackerPredictor(fast=True, device="cuda")
    video = synthetic_video(SEGM_T, 384, 512, dev)
    pred(video, grid_size=SEGM_GRID, segm_mask=mask[None, None])  # warm-up
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks, vis = pred(video, grid_size=SEGM_GRID, segm_mask=mask[None, None])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    err = (tracks[0, 0].cpu() - torch.from_numpy(pts[keep])).abs().max().item() \
        if tracks.shape[2] == n else float("inf")
    log(f"  mask keeps {mask.mean():.3f} of the frame: {tracks.shape[2]} of {SEGM_GRID**2} grid "
        f"points tracked (computed here: {n}), + 36 support, {n_pad} padded; {dt:.3f} s; frame 0 "
        f"against the kept grid points: max {err:.2e} px; launches {counts} (expected {want})")
    if tuple(tracks.shape) != (1, SEGM_T, n, 2) or not torch.isfinite(tracks).all():
        raise AssertionError(f"segmentation mask: shape {tuple(tracks.shape)}, expected {n} tracks")
    if not (err <= 1e-3 and bool(vis[0, 0].all())) or counts != want:
        raise AssertionError("segmentation mask: snap-back or launches wrong")
    return counts, dict(seconds=dt, kept=n, padded=n_pad)


def hub_phase(dev, pred):
    """Phase 18: save_reference_checkpoint of phase 4's model, then
    hub.cotracker3_offline(checkpoint=path, fast=True): its state_dict, its
    tracks and visibility on a video bit for bit the original predictor's,
    the launches of its forward; a URL raises with the URL."""
    from cotracker_tpu_torch import hub
    from cotracker_tpu_torch.models.checkpoint import save_reference_checkpoint

    root = tempfile.mkdtemp(prefix="chip_smoke_hub_")
    try:
        path = os.path.join(root, "scaled_offline.pth")
        save_reference_checkpoint(path, pred.model)
        loaded = hub.cotracker3_offline(checkpoint=path, fast=True)
        a, b = pred.model.state_dict(), loaded.model.state_dict()
        same_sd = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        video = synthetic_video(HUB_T, 384, 512, dev)
        ref = pred(video, grid_size=HUB_GRID)
        zero_counts()
        out = loaded(video, grid_size=HUB_GRID)
        counts = read_counts()
        check_surface_shape("hub", -(-HUB_GRID**2 // 512) * 512, HUB_T)
        want = route_counts(-(-HUB_GRID**2 // 512) * 512, HUB_T)
        same = torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])
        log(f"  {os.path.getsize(path) / 2**20:.1f} MiB reference checkpoint; state_dict equal: "
            f"{same_sd}; tracks and visibility bit for bit the original's: {same}; launches "
            f"{counts} (expected {want})")
        if not (same_sd and same) or counts != want:
            raise AssertionError("hub: the loaded predictor differs from the original")
        url = hub.CHECKPOINT_URLS["cotracker3_offline"]
        try:
            hub.cotracker3_offline(url)
        except ValueError as e:
            if url not in str(e):
                raise AssertionError(f"hub: the URL's error does not name it: {e}") from e
            log(f"  a URL raises: {e}")
        else:
            raise AssertionError("hub: a URL did not raise")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def write_dynamic_replica(root):
    """A Dynamic Replica tree from a seed: one sequence of DR_T left-camera
    frames at DR_HW (uint8), each with a right-camera record, and
    DR_TRACKS trajectories a frame on a texture drifting at constant
    velocity (10% of the points occluded at random, some leaving the
    frame)."""
    import gzip

    rng = np.random.default_rng(19)
    H, W = DR_HW
    vel = np.array([1.5, 0.75])  # pixels a frame the texture moves by
    pad = int(np.ceil(vel.max() * DR_T)) + 8
    tex = rng.integers(0, 256, ((H + pad) // 8 + 1, (W + pad) // 8 + 1, 3), dtype=np.uint8)
    tex = np.repeat(np.repeat(tex, 8, axis=0), 8, axis=1)
    start = rng.uniform([0, 0], [W - 1, H - 1], (DR_TRACKS, 2))
    split = os.path.join(root, "valid")
    os.makedirs(os.path.join(split, "seq", "traj"))
    records = []
    for t in range(DR_T):
        ox, oy = np.floor(pad - vel * t).astype(int)  # the crop's origin in the texture
        img = np.ascontiguousarray(tex[oy: oy + H, ox: ox + W])
        xy = start + [pad - ox, pad - oy]
        rec = {"sequence_name": "seq", "frame_number": t, "frame_timestamp": t / 30.0,
               "image": {"path": f"seq/images/{t:05d}.png", "size": [H, W]},
               "trajectories": {"path": f"seq/traj/{t:05d}.pth"}}
        records += [{**rec, "camera_name": "left"}, {**rec, "camera_name": "right"}]
        torch.save({"img": torch.from_numpy(img),
                    "traj_2d": torch.from_numpy(
                        np.concatenate([xy, np.ones((DR_TRACKS, 1))], 1).astype(np.float32)),
                    "verts_inds_vis": torch.from_numpy(rng.random(DR_TRACKS) > 0.1)},
                   os.path.join(split, "seq", "traj", f"{t:05d}.pth"))
    with gzip.open(os.path.join(split, "frame_annotations_valid.jgz"), "wt") as f:
        json.dump(records, f)


def dynamic_replica_phase(dev):
    """Phase 19: evaluate.run_eval(dataset_name="dynamic_replica",
    fast=True) on write_dynamic_replica's tree: the forward's launches
    against route_counts at its track count and frame count, the metrics
    finite, the result files written; seconds per sequence."""
    from cotracker_tpu_torch.evaluation.evaluate import DefaultConfig

    root = tempfile.mkdtemp(prefix="chip_smoke_dr_")
    try:
        t0 = time.perf_counter()
        write_dynamic_replica(root)
        log(f"  tree written in {time.perf_counter() - t0:.1f} s")
        cfg = DefaultConfig(exp_dir=os.path.join(root, "exp"), dataset_root=root,
                            dataset_name="dynamic_replica", fast=True, device="cuda")
        t0 = time.perf_counter()
        metrics, per_call = run_eval_counted(cfg)
        wall = time.perf_counter() - t0
        if len(per_call) != 1:
            raise AssertionError(f"Dynamic Replica: {len(per_call)} sequences, expected 1")
        counts, sec, shape, n = per_call[0]
        n_pad = -(-(n + 25) // 64) * 64  # the 5x5 support grid; the evaluation predictor's bucket
        check_surface_shape("dynamic_replica", n_pad, DR_T)
        want = route_counts(n_pad, DR_T)
        log(f"  sequence: {shape[1]} frames of {shape[3]}x{shape[4]}, {n} tracks + 25 grid "
            f"points = {n_pad} padded: forward {sec:.2f} s, run_eval {wall:.2f} s; launches "
            f"{counts} (expected {want})")
        if tuple(shape[1:]) != (DR_T, 3, *DR_HW) or counts != want:
            raise AssertionError("Dynamic Replica: the sequence or its launches are wrong")
        avg = metrics["avg"]
        log(f"  Dynamic Replica metrics (random weights: the values mean nothing) {avg}")
        if not avg or not all(math.isfinite(v) for v in avg.values()):
            raise AssertionError("Dynamic Replica: missing or non-finite metrics")
        for f in ("expconfig.json", "result_eval_.json", "result_dynamic_replica.json"):
            if not os.path.exists(os.path.join(cfg.exp_dir, f)):
                raise AssertionError(f"Dynamic Replica: {f} not written")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, dict(seconds_per_sequence=sec, run_eval_seconds=wall, tracks=n, padded=n_pad)


def demos_phase(dev):
    """Phase 20: the demos as built by their entry points (the plain float32
    model, no kernel) on a seeded .npy video at 384x512: demo.track_video
    (a 10 x 10 grid; its rendered frames), online_demo.track_stream (its
    tracks against the same online predictor driven by hand with the
    loop's chunks; rendered frames). No mp4: without OpenCV save_video
    raises an ImportError naming cv2."""
    from cotracker_tpu_torch import demo, online_demo
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor
    from cotracker_tpu_torch.utils.visualizer import Visualizer

    root = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        path = os.path.join(root, "clip.npy")
        np.save(path, synthetic_video(DEMO_T, 384, 512, dev)[0].permute(0, 2, 3, 1)
                .round().to(torch.uint8).cpu().numpy())
        video = demo.read_video(path)
        zero_counts()
        t0 = time.perf_counter()
        tracks, vis, frames = demo.track_video(video, grid_size=10)
        dt = time.perf_counter() - t0
        counts = read_counts()
        log(f"  demo: tracks {tuple(tracks.shape)} on {tracks.device}, rendered "
            f"{frames.shape} {frames.dtype} in {dt:.2f} s; launches {sum(counts.values())}")
        if (tuple(tracks.shape) != (1, DEMO_T, 100, 2) or tracks.device.type != dev.type
                or not torch.isfinite(tracks).all()
                or frames.shape != (10 + DEMO_T - 1, 384 + 240, 512 + 240, 3)):
            raise AssertionError("demo: wrong tracks or rendered frames")

        pred = CoTrackerOnlinePredictor(device="cuda")
        t0 = time.perf_counter()
        tracks, vis, read = online_demo.track_stream(iter(video), pred, grid_size=10)
        dt = time.perf_counter() - t0
        # by hand: a chunk every 8 frames of the last 16 read, then the tail
        chunk = torch.from_numpy(video).permute(0, 3, 1, 2)[None].float()
        step = pred.step
        pred(chunk[:, :1], is_first_step=True, grid_size=10)
        for end in range(step + 1, DEMO_T + 1, step):
            ref = pred(chunk[:, max(0, end - 2 * step):end])
        ref = pred(chunk[:, DEMO_T - (DEMO_T % step + step):])
        err = (tracks - ref[0]).abs().max().item()
        rendered = online_demo.render(read, tracks, vis)
        log(f"  online demo: tracks {tuple(tracks.shape)} in {dt:.2f} s; against the predictor "
            f"driven by hand: max {err:.2e} px (bound 1e-3), visibility equal "
            f"{torch.equal(vis, ref[1])}; rendered {rendered.shape}")
        if not (err <= 1e-3 and torch.equal(vis, ref[1]) and tracks.shape[1] == DEMO_T
                and rendered.shape == (10 + DEMO_T - 1, 384 + 240, 512 + 240, 3)):
            raise AssertionError("online demo: its tracks differ from the loop by hand")
        try:
            import cv2  # noqa: F401
        except ImportError:
            try:
                Visualizer(save_dir=root).save_video(frames[:2], "clip")
            except ImportError as e:
                if "cv2" not in str(e):
                    raise AssertionError(f"save_video's ImportError does not name cv2: {e}") from e
                log(f"  no mp4: {e}")
            else:
                raise AssertionError("save_video wrote an mp4 without OpenCV")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------- training from Kubric
# (phases 21-22): the trainer's command line on a MOVi-f-shaped tree, and the
# interactive demo's server

KUBRIC_SEQS, KUBRIC_T, KUBRIC_HW, KUBRIC_TRACKS = 3, 24, (512, 512), 2000
KUBRIC_STEPS, KUBRIC_EVAL_EVERY = 6, 3


def write_kubric_tree(root):
    """A tree in MOVi-f's layout and frame size, from a seed: KUBRIC_SEQS
    sequences of KUBRIC_T 512x512 frames (MovingClip's smooth texture,
    written by write_png with the five filter types by row in turn) and
    KUBRIC_TRACKS tracks each (MovingClip's, occluded outside the frame).
    The files are written by 8 threads (zlib and numpy release the GIL).
    Returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    from cotracker_tpu_torch.datasets.png import write_png

    t0 = time.perf_counter()
    rows = np.arange(KUBRIC_HW[0]) % 5
    jobs = []
    with ThreadPoolExecutor(8) as pool:
        for s in range(KUBRIC_SEQS):
            clip = MovingClip(KUBRIC_T, *KUBRIC_HW, KUBRIC_TRACKS, seed=20 + s).sample
            name = f"seq{s:03d}"
            os.makedirs(os.path.join(root, name, "frames"))
            frames = clip.video.transpose(0, 2, 3, 1).round().astype(np.uint8)
            for t, frame in enumerate(frames):
                jobs.append(pool.submit(write_png, os.path.join(root, name, "frames",
                                                                f"{t:03d}.png"), frame, rows))
            np.save(os.path.join(root, name, name + ".npy"),
                    {"coords": clip.trajectory.transpose(1, 0, 2),
                     "visibility": ~clip.visibility.T.astype(bool)}, allow_pickle=True)
        for job in jobs:
            job.result()
    return time.perf_counter() - t0


@contextlib.contextmanager
def signals_restored():
    """train() installs the SLURM handlers (SIGTERM ignored): put back this
    process's own afterwards, so that it stays stoppable."""
    found = {sig: signal.getsignal(sig) for sig in (signal.SIGUSR1, signal.SIGTERM)}
    try:
        yield
    finally:
        for sig, handler in found.items():
            signal.signal(sig, handler)


@contextlib.contextmanager
def without_cv2():
    """`import cv2` raises ImportError inside (as where OpenCV is missing)."""
    found = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if found is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = found


def check_kubric_steps(steps, zeros):
    """Every step of the Kubric runs launched K4r as its clip's windows
    need, and nothing else."""
    for frames, counts, _ in steps:
        expected = {**zeros, "K4r_corr_volume_raw": k4r_per_step(frames)}
        if counts != expected:
            raise AssertionError(f"Kubric training: a step of {frames} frames launched "
                                 f"{counts}, expected {expected}")


def two_window_median(steps):
    """Median ms of the steps after the first whose clip takes two windows
    (over 16 frames: training (a)'s shape once padded), or None."""
    two = sorted(m for f, _, m in steps[1:] if f > 16)
    return two[len(two) // 2] if two else None


def host_loop_probe(tree):
    """Seconds of a loop of 10,000 small torch ops on the host (a
    launch-bound step's pattern: the interpreter lock taken back after
    every op) alone, then beside the command line's loader (4 workers, the
    Kubric reader with its augmentations and random clips) reading in its
    threads and in its processes; each loader is timed once its first batch
    is out, with room in its queue to go on reading."""
    from cotracker_tpu_torch.datasets.kubric import KubricMovifDataset
    from cotracker_tpu_torch.training.data_loader import PrefetchLoader

    def loop():
        x = torch.zeros(10)
        t0 = time.perf_counter()
        for _ in range(10000):
            x = x + 1
        return time.perf_counter() - t0

    ds = KubricMovifDataset(tree, crop_size=TRAIN_RES, seq_len=KUBRIC_T,
                            traj_per_sample=TRAIN_TRACKS, use_augs=True, random_seq_len=True,
                            random_frame_rate=True)
    out = {"alone": loop()}
    for mode in ("threads", "processes"):
        ds.read_in_processes = mode == "processes"
        loader = PrefetchLoader(ds, 1, seed=0, num_workers=4, prefetch=32)
        try:
            next(loader)
            if not any(t.is_alive() for t in loader._threads):
                raise AssertionError("host_loop_probe: the loader's workers stopped")
            out[mode] = loop()
        finally:
            loader.close()
    out["alone_again"] = loop()
    return out


def k4r_per_step(frames):
    """K4r launches of one online training step of a clip of `frames`
    frames: 4 levels x TRAIN_ITERS iterations x its windows of 16 at step 8
    x 2 (the checkpointed forward runs again in the backward)."""
    windows = max(1, -(-(frames - 16) // 8) + 1)
    return 4 * TRAIN_ITERS * windows * 2


def kubric_phase(dev, smi, moving_ms):
    """Phase 21 (see the module docstring). Returns the per-step and
    per-eval launch counts and the metrics."""
    from cotracker_tpu_torch.datasets.kubric import KubricMovifDataset
    from cotracker_tpu_torch.datasets.png import read_png, read_pngs
    from cotracker_tpu_torch.training import trainer
    from cotracker_tpu_torch.training.data_loader import collate_batch
    from cotracker_tpu_torch.utils.profiling import kernel_launches
    from cotracker_tpu_torch.utils.visualizer import Visualizer

    root = tempfile.mkdtemp(prefix="chip_smoke_kubric_")
    zeros = dict.fromkeys(WRAPPERS, 0)
    metrics = {}
    try:
        tree = os.path.join(root, "movi_f")
        metrics["tree_write_s"] = write_kubric_tree(tree)
        log(f"  wrote {KUBRIC_SEQS} sequences x {KUBRIC_T} frames of {KUBRIC_HW[1]}x"
            f"{KUBRIC_HW[0]} and {KUBRIC_TRACKS} tracks in {metrics['tree_write_s']:.2f} s")

        # PNG decoding on the card's host: a sequence's frames in one sweep, one frame alone
        paths = sorted(os.path.join(tree, "seq000", "frames", f)
                       for f in os.listdir(os.path.join(tree, "seq000", "frames")))
        want = MovingClip(KUBRIC_T, *KUBRIC_HW, KUBRIC_TRACKS, seed=20).sample.video
        want = want.transpose(0, 2, 3, 1).round().astype(np.uint8)
        per_seq, per_one = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            frames = read_pngs(paths)
            per_seq.append(1e3 * (time.perf_counter() - t0) / len(paths))
            t0 = time.perf_counter()
            one = read_png(paths[0])
            per_one.append(1e3 * (time.perf_counter() - t0))
        if not (np.array_equal(np.stack(frames), want) and np.array_equal(one, want[0])):
            raise AssertionError("read_png: the decoded frames differ from those written")
        metrics["png_ms_per_frame"] = sorted(per_seq)[1]
        metrics["png_ms_one_frame"] = sorted(per_one)[1]
        log(f"  read_png, {KUBRIC_HW[1]}x{KUBRIC_HW[0]} RGB, filters mixed by row: "
            f"{metrics['png_ms_per_frame']:.2f} "
            f"ms a frame decoding a sequence's {len(paths)} together, "
            f"{metrics['png_ms_one_frame']:.2f} ms for one frame alone (medians of 3)")

        # a sample's read: the whole 24-frame sequence, with and without augmentations
        for augs in (False, True):
            ds = KubricMovifDataset(tree, crop_size=TRAIN_RES, seq_len=KUBRIC_T,
                                    traj_per_sample=TRAIN_TRACKS, use_augs=augs)
            rng = np.random.default_rng(0)
            secs = []
            for i in range(3):
                t0 = time.perf_counter()
                sample, ok = ds.get(i, rng)
                secs.append(time.perf_counter() - t0)
                if not ok or sample.video.shape != (KUBRIC_T, 3, *TRAIN_RES):
                    raise AssertionError(f"Kubric read (use_augs={augs}): failed sample")
            metrics[f"sample_read_s_augs_{'on' if augs else 'off'}"] = sorted(secs)[1]
            log(f"  a sample's read, {KUBRIC_T} frames, use_augs={augs}: "
                f"{[round(x, 3) for x in secs]} s (median {sorted(secs)[1]:.3f})")

        # the trainer's command line, online model at full width, with the eval hook
        pkl = os.path.join(root, "tapvid_davis.pkl")
        write_tapvid_pickle(pkl)
        exp = os.path.join(root, "exp")
        argv = ["--dataset_root", tree, "--exp_dir", exp, "--offline_model",
                "--model_window_len", "16", "--num_steps", str(KUBRIC_STEPS),
                "--save_every_n_steps", str(KUBRIC_EVAL_EVERY),
                "--eval_every_n_steps", str(KUBRIC_EVAL_EVERY),
                "--eval_datasets", f"tapvid_davis_first={pkl}", "--device", dev.type]
        args = trainer.parse_args(argv)
        if (args.crop_size, args.traj_per_sample, args.train_iters, args.offline_model,
                args.use_augs, args.use_corr_kernels) != (TRAIN_RES, TRAIN_TRACKS, TRAIN_ITERS,
                                                          False, True, True):
            raise AssertionError(f"the command line parsed to {args}")
        steps, evals = [], []
        sink = [steps]  # where counted_step records (frames, counts, ms)
        step_fn, eval_fn = trainer.train_step, trainer.run_test_eval

        def counted_step(model, optimizer, scheduler, batch, generator, cfg):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(model, optimizer, scheduler, batch, generator, cfg)
            torch.cuda.synchronize()
            sink[0].append((batch["video"].shape[1], read_counts(),
                            1e3 * (time.perf_counter() - t0)))
            return out

        launch, shapes = corr_cuda._k4_launch, set()

        def recorded(fmq, supq, starts, wxy, plan):  # (points, padded frames) of each K4r
            if wxy is None:
                shapes.add(tuple(starts.shape[:2]))
            return launch(fmq, supq, starts, wxy, plan)

        def counted_eval(model, *a, **kw):
            zero_counts()
            shapes.clear()
            corr_cuda._k4_launch = recorded
            t0 = time.perf_counter()
            try:
                out = eval_fn(model, *a, **kw)
            finally:
                corr_cuda._k4_launch = launch
            torch.cuda.synchronize()
            evals.append((read_counts(), time.perf_counter() - t0, sorted(shapes)))
            return out

        trainer.train_step, trainer.run_test_eval = counted_step, counted_eval
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            model = trainer.main(argv)
        finally:
            trainer.train_step, trainer.run_test_eval = step_fn, eval_fn
        metrics["cli_s"] = time.perf_counter() - t0
        metrics["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check_kubric_steps(steps, zeros)
        losses = [r["total_loss"] for r in read_losses(exp)]
        log(f"  trainer.main: {len(steps)} steps in {metrics['cli_s']:.1f} s (model build, "
            f"loader and evals included), peak memory {metrics['peak_gib']:.2f} GiB; clip "
            f"frames per step {[f for f, _, _ in steps]}, K4r per step "
            f"{[c['K4r_corr_volume_raw'] for _, c, _ in steps]} (4 levels x {TRAIN_ITERS} "
            f"iterations x windows x 2), every other kernel 0; ms per step "
            f"{[round(m, 1) for _, _, m in steps]}; total loss {[round(x, 4) for x in losses]}")
        if len(losses) != KUBRIC_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError("Kubric training: losses missing or not finite")
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        if ckpts != ["model_000000003.pth", "model_000000006.pth", "model_final.pth"]:
            raise AssertionError(f"Kubric training: checkpoints {ckpts}")
        with open(os.path.join(exp, "eval_records.jsonl")) as f:
            records = [json.loads(line) for line in f]
        per_seq = dict(K4r_corr_volume_raw=4 * 6 * len(EVAL_SEQS))  # levels x n_iters=6
        if ([r["step"] for r in records] != [3, 6] or len(evals) != 2
                or any(c != {**zeros, **per_seq} for c, _, _ in evals)):
            raise AssertionError(f"Kubric training: eval records {records}, launches {evals}")
        checked = sorted((m, t + t % 2) for m, t in K4R_EVAL)  # K4r's phase, padded frames
        if any(sh != checked for _, _, sh in evals):
            raise AssertionError(f"the eval hook ran K4r at {[sh for _, _, sh in evals]} "
                                 f"(points, padded frames), the K4r phase checked {checked}")
        avg = records[-1]["results"]["tapvid_davis_first"]
        log(f"  eval hook at steps {[r['step'] for r in records]}: {[round(s, 2) for _, s, _ in evals]}"
            f" s each, launches {evals[0][0]['K4r_corr_volume_raw']} K4r ({len(EVAL_SEQS)} "
            f"sequences x 4 levels x 6 iterations) at {evals[0][2]} (points, padded frames), "
            f"each held to its plain version in the K4r phase; every other kernel 0; metrics {avg}")
        metrics["ms_per_step"] = [m for _, _, m in steps]
        metrics["frames_per_step"] = [f for f, _, _ in steps]
        metrics["ms_per_step_two_windows_median"] = two_window_median(steps)

        # the same command line with the samples read in the loader's threads
        # (the reader's read_in_processes off), as many steps, no eval: what
        # reading in processes takes off the step
        threads_steps = []
        sink[0] = threads_steps
        KubricMovifDataset.read_in_processes = False
        trainer.train_step = counted_step
        try:
            trainer.main(argv[:2] + ["--exp_dir", os.path.join(root, "exp_threads")] + argv[4:9]
                         + ["--device", dev.type])
        finally:
            del KubricMovifDataset.read_in_processes
            trainer.train_step = step_fn
        check_kubric_steps(threads_steps, zeros)
        metrics["ms_per_step_threads"] = [m for _, _, m in threads_steps]
        metrics["frames_per_step_threads"] = [f for f, _, _ in threads_steps]
        metrics["ms_per_step_two_windows_median_threads"] = two_window_median(threads_steps)
        threads_ms = [round(m, 1) for m in metrics["ms_per_step_threads"]]
        log(f"  steps after the first with two windows ({TRAIN_RES[0]}x{TRAIN_RES[1]}, 24 frames "
            f"padded, {TRAIN_TRACKS} tracks), median: "
            f"{metrics['ms_per_step_two_windows_median']} ms with the reads in the loader's "
            f"processes (the default); {metrics['ms_per_step_two_windows_median_threads']} ms "
            f"with them in its threads (ms per step {threads_ms} at "
            f"{metrics['frames_per_step_threads']} frames); "
            f"MovingClip's training (a) in this call: {moving_ms:.1f} ms ({smi})")
        metrics["host_loop_s"] = host_loop_probe(tree)
        log(f"  a host loop of 10,000 small torch ops (a launch-bound step's pattern), seconds: "
            f"{metrics['host_loop_s']}")

        # the eval forward's device launches by kernel (sequence B at the model's resolution)
        from cotracker_tpu_torch.datasets.tap_vid import TapVidDataset
        from cotracker_tpu_torch.ops.bilinear import resize_bilinear

        sample = TapVidDataset(pkl, "davis")[1]
        video = torch.from_numpy(sample.video[None]).to(dev).float()
        video_cl = resize_bilinear(video.permute(0, 1, 3, 4, 2), TRAIN_RES, align_corners=True)
        qp = sample.query_points
        q = np.zeros((1, 128, 3), np.float32)
        q[0, : len(qp)] = np.stack([qp[:, 0], qp[:, 2] * 511 / 255, qp[:, 1] * 383 / 255], 1)
        mask = torch.zeros(1, 128, dtype=torch.bool, device=dev)
        mask[0, : len(qp)] = True
        q = torch.from_numpy(q).to(dev)
        model.eval()
        with torch.inference_mode():
            by_kernel = kernel_launches(lambda: model(video_cl, q, iters=6, track_mask=mask))
        model.train()
        metrics["eval_forward_launches"] = sum(by_kernel.values())
        k4r = {k: v for k, v in by_kernel.items() if "k4r" in k}
        log(f"  the eval forward (80 frames, 128 tracks, iters=6) on the card: "
            f"{metrics['eval_forward_launches']} kernel launches (profiler; copies and memsets "
            f"apart), K4r kernels {k4r}; "
            f"the five largest counts {sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]}")
        if sum(k4r.values()) != 24:
            raise AssertionError(f"the eval forward ran K4r {k4r}, expected 24")

        # the visualisation hook: its render on the card; its cadence raises before step 0
        # where the video has no sink (no cv2, and no TensorBoard writer with moviepy)
        ds = KubricMovifDataset(tree, crop_size=TRAIN_RES, seq_len=KUBRIC_T,
                                traj_per_sample=TRAIN_TRACKS)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in collate_batch(
            [ds.get(0, np.random.default_rng(0))[0]]).items()}
        zero_counts()
        rendered = trainer.render_train_batch(model, batch, TRAIN_ITERS,
                                              Visualizer(save_dir=root, fps=6))
        counts = read_counts()
        log(f"  render_train_batch on the card: {rendered.shape} {rendered.dtype}, K4r "
            f"{counts['K4r_corr_volume_raw']} (4 levels x {TRAIN_ITERS} iterations)")
        if (rendered.shape != (KUBRIC_T + 9, *TRAIN_RES, 3)
                or counts != {**zeros, "K4r_corr_volume_raw": 4 * TRAIN_ITERS}):
            raise AssertionError("render_train_batch: wrong frames or launches")
        if importlib.util.find_spec("cv2") is not None:
            path = Visualizer(save_dir=root, fps=6).save_video(rendered, "train_step")
            log(f"  OpenCV is here: the rendered batch as an mp4, {os.path.getsize(path)} bytes")
        exp2 = os.path.join(root, "exp_vis")
        with without_cv2():
            try:
                trainer.main(argv[:2] + ["--exp_dir", exp2, "--save_vis_every_n_steps", "1",
                                         "--num_steps", "1", "--device", dev.type])
            except ImportError as e:
                if "cv2" not in str(e) or os.path.exists(os.path.join(exp2, "train_log.jsonl")):
                    raise AssertionError(f"the visualisation cadence: {e}") from e
                log(f"  without cv2, save_vis_every_n_steps raises before step 0: {e}")
            else:
                raise AssertionError("the visualisation cadence trained without a video sink")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return steps, evals, metrics


def interactive_demo_phase(dev):
    """Phase 22 (see the module docstring)."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from cotracker_tpu_torch.datasets.png import read_png
    from cotracker_tpu_torch.interactive_demo import DemoState, make_handler

    root = tempfile.mkdtemp(prefix="chip_smoke_idemo_")
    srv = None
    try:
        video = synthetic_video(DEMO_T, 384, 512, dev)[0].permute(0, 2, 3, 1).round()
        video = video.to(torch.uint8).cpu().numpy()
        np.save(os.path.join(root, "clip.npy"), video)
        state = DemoState(os.path.join(root, "clip.npy"), max_frames=DEMO_T, device=dev.type,
                          save_dir=root)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def get(path):
            return urllib.request.urlopen(base + path, timeout=300).read()

        def track(body):
            req = urllib.request.Request(base + "/track", data=json.dumps(body).encode(),
                                         method="POST")
            return json.loads(urllib.request.urlopen(req, timeout=300).read())

        if "/frame.png" not in get("/").decode():
            raise AssertionError("interactive demo: the page does not show /frame.png")
        with open(os.path.join(root, "frame.png"), "wb") as f:
            f.write(get("/frame.png"))
        if not np.array_equal(read_png(os.path.join(root, "frame.png")), video[0]):
            raise AssertionError("interactive demo: /frame.png is not frame 0")
        zero_counts()
        points = track({"points": [[100, 120], [300, 200]], "grid_size": 0})
        grid = track({"points": [], "grid_size": 10})
        log(f"  /track with 2 points: {points}; with a 10x10 grid: {grid}; kernel launches "
            f"{sum(read_counts().values())} (the plain model); tracks on "
            f"{next(state.predictor().model.parameters()).device}")
        if (points["n_tracks"], grid["n_tracks"], points["n_frames"]) != (2, 100, DEMO_T):
            raise AssertionError("interactive demo: wrong track counts")
        if importlib.util.find_spec("cv2") is not None:
            if points["mp4"] != "/result.mp4" or len(get("/result.mp4")) < 500:
                raise AssertionError("interactive demo: OpenCV is here but no mp4 was served")
            log("  OpenCV is here: /result.mp4 served")
        with without_cv2():
            out = track({"points": [[100, 120]], "grid_size": 0})
        try:
            get("/result.mp4")
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            if (e.code != 404 or body != out["no_mp4"] or "cv2" not in body
                    or out["mp4"] is not None or out["n_tracks"] != 1):
                raise AssertionError(f"interactive demo: /result.mp4 {e.code} {body}") from e
            log(f"  without cv2: /track {out}; /result.mp4 404 {body}")
        else:
            raise AssertionError("interactive demo: an mp4 was served without OpenCV")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(root, ignore_errors=True)


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
    log("the inference surface's kernels vs plain versions (bf16) at the shapes of phases 16-19:")
    surface_kernel_phase(dev, kernels)
    torch.cuda.empty_cache()

    log("offline main path: CoTrackerPredictor(fast=True), 384x512, iters=6:")
    launches, pfs, main_pred = main_path(dev)
    torch.cuda.empty_cache()
    counts_a, counts_b, pfs_a, pfs_b = streaming_paths(dev)
    torch.cuda.empty_cache()
    with signals_restored():
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
    torch.cuda.empty_cache()
    log(f"dense mode: CoTrackerPredictor(fast=True), 384x512, {DENSE_T} frames, no queries:")
    dense_counts, dense = dense_phase(dev)
    torch.cuda.empty_cache()
    log(f"segmentation mask: CoTrackerPredictor(fast=True), a {SEGM_GRID}x{SEGM_GRID} grid, "
        f"{SEGM_T} frames:")
    segm_counts, segm = segm_phase(dev)
    torch.cuda.empty_cache()
    log("reference-format export and hub: save_reference_checkpoint, hub.cotracker3_offline:")
    hub_counts = hub_phase(dev, main_pred)
    del main_pred
    torch.cuda.empty_cache()
    log(f"Dynamic Replica: evaluate.run_eval(fast=True), {DR_T} frames of "
        f"{DR_HW[1]}x{DR_HW[0]}, {DR_TRACKS} trajectories a frame:")
    dr_counts, dr = dynamic_replica_phase(dev)
    torch.cuda.empty_cache()
    log(f"demos: demo.track_video and online_demo.track_stream on a {DEMO_T}-frame .npy video:")
    demos_phase(dev)
    torch.cuda.empty_cache()
    log(f"training from a Kubric tree: trainer.main, online model, {TRAIN_RES[0]}x{TRAIN_RES[1]}, "
        f"{TRAIN_TRACKS} tracks, iters={TRAIN_ITERS}, augmentations on, the eval hook:")
    t0 = time.perf_counter()
    with signals_restored():
        kubric_steps, kubric_evals, kubric = kubric_phase(dev, smi, train_metrics["ms_per_step"])
    kubric["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"interactive demo: its server in a thread, a {DEMO_T}-frame .npy video:")
    interactive_demo_phase(dev)
    torch.cuda.empty_cache()
    for k in kernels:
        # K1-K4 from the offline forward, K5-K7 from a window of streaming
        # (b), K8 and K9 from the long forward
        name = k["name"]
        k["launches"] = launches[name] or counts_b[name] or long_counts[name]
        k["launches_per_window"] = {"a": counts_a[name], "b": counts_b[name]}
        k["launches_long_forward"] = long_counts[name]
        k["launches_600_frame_forward"] = v600_counts[name]
        k["launches_eval_sequence_a"] = eval_counts[name]
        k["launches_dense_forward"] = dense_counts[name]
        k["launches_segm_forward"] = segm_counts[name]
        k["launches_hub_forward"] = hub_counts[name]
        k["launches_dynamic_replica_forward"] = dr_counts[name]
    for k in train_kernels:
        # per training step: K4r in the online K4r run, K4f in the K4f run
        k["launches"] = step_r[k["name"]] or step_f[k["name"]]
        k["launches_per_step"] = {"k4r_run": step_r[k["name"]], "k4f_run": step_f[k["name"]]}
        k["launches_per_step_kubric_cli"] = [c[k["name"]] for _, c, _ in kubric_steps]
        k["launches_per_eval_hook"] = [c[k["name"]] for c, _, _ in kubric_evals]
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
    log(f"dense mode ({dense['forwards']} forwards of {dense['tracks_per_forward']} tracks, "
        f"{DENSE_T} frames): {dense['seconds']:.3f} s, {dense['points_frames_per_s']:.0f} "
        f"points*frames/s, peak memory {dense['peak_gib']:.1f} GiB; segmentation mask "
        f"({segm['kept']} points, {SEGM_T} frames): {segm['seconds']:.3f} s; Dynamic Replica "
        f"({dr['tracks']} tracks, {DR_T} frames): {dr['seconds_per_sequence']:.3f} s per sequence "
        f"({smi})")
    log(f"training from a Kubric tree: read_png {kubric['png_ms_per_frame']:.2f} ms a 512x512 "
        f"frame ({kubric['png_ms_one_frame']:.2f} alone); a 24-frame sample's read "
        f"{kubric['sample_read_s_augs_off']:.3f} s without augmentations, "
        f"{kubric['sample_read_s_augs_on']:.3f} s with; ms per step "
        f"{[round(m, 1) for m in kubric['ms_per_step']]} at {kubric['frames_per_step']} frames, "
        f"two-window median {kubric['ms_per_step_two_windows_median']} against MovingClip's "
        f"{train_metrics['ms_per_step']:.1f}; phase {kubric['phase_s']:.1f} s ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
