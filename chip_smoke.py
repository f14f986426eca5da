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
     phases 16-19 and phase 24's fast teacher launch at the shapes they
     give it (SURFACE: 16,384 x 24, 3,072 x 60, 2,560 x 24, 320 x 300 and
     448 x 64 padded tracks x frames, on the
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
     those words;
 23. the legacy CoTracker2 family (plain PyTorch: the JAX package has no
     kernel for it), its random weights damped as the CPU tests damp them
     (damp_v2): (a) CoTrackerPredictor(v2=True, fast=True) with window 8
     (v2) and 16 (v2.1), 384x512, a 50x50 grid (2,500 points), 60 frames,
     iters=6: the median of 3 forwards after a warm-up, points*frames/s,
     peak memory, snap-back, and one float32 forward of the same weights,
     the bf16 tracks within 1 px of it (median); (b)
     CoTrackerOnlinePredictor(v2=True, window_len=16, fast=True) at the
     distillation teacher's shape, 384 queries + the 5x5 support grid over
     64 frames (7 windows at step 8): seconds per steady window, peak
     memory; (c) the same weights and inputs at 48x64, iters=2, f32: the
     card against the CPU (an offline forward with masked padding and three
     streaming chunks) within the CPU tests' tolerances; (d) the port's
     export of (a)'s v2 and (b)'s v2.1 models through hub.cotracker2 and
     hub.cotracker2v1_online on the card, bit for bit the originals, and a
     URL raises; (e) the launch counters zeroed before (a) and read after
     (d): every kernel zero;
 24. pseudo-label distillation: two MJPG .avi clips (96 frames of
     MovingClip's texture at 480x360) written with OpenCV and decoded back;
     random-weight v2.1 (damp_v2), v3 online and v3 offline teachers saved
     as reference-format checkpoints and loaded by default_teacher_ensemble,
     each run twice on a 64-frame 384x512 clip with 384 SIFT queries + the
     5x5 support grid (seconds, peak memory), and the v3 offline teacher
     with fast=True the same way (448 padded tracks x 64 frames, the shape
     phase 3 held K1-K4 at; its launches those route_counts gives);
     TAPIRPredictor() raises an ImportError naming tapnet; the command
     line, distill_trainer.main, on the offline student at full width (64
     frames, 384 queries, iters=4, K4r) for 3 steps with a checkpoint, again
     to 4 steps (it auto-resumes at 3), then one step of the online student
     (--offline_model, windows of 16: 7): each step's K4r count exact (32
     offline, 224 online: 4 levels x 4 iterations x windows x 2) and no
     other kernel, K4r run only at (384, 64) and (384, 16) (points, padded
     frames); the students' vis_conf_head bit for bit their first values,
     their flow_head moved; ms per step, the host's query and teacher
     seconds a step, each run's peak memory; then K4r at those two shapes
     held to its plain version at levels 0-3 (its `*_distill*` keys). The
     launch counters are zeroed before the teachers and read after the
     online step (`launches_distill_phase` on every kernel); K4r's
     `launches_per_distill_step` is the counts the steps measured.
25. parallelism over torch.distributed (cotracker_tpu_torch/parallel/):
     rank processes of this script (`--parallel-rank`), started fresh after
     the build, each failing the phase if it fails or hangs past its
     timeout: (0) one rank over NCCL, the track-sharded forward on a (1, 1)
     mesh at the offline cell's shape (10,240 tracks x 60 frames, iters=6,
     update heads x 0.05): route_counts(10240, 60) with K3 0 (the track
     group's two-pass softmax bypasses it), within main_path's band of the
     unsharded forward; then two gloo ranks sharing cuda:0: (a) the same
     forward over 2 track ranks (5,120 a rank: route_counts(5120, 60), K3 0,
     per rank), within 0.25 px / 0.01 of (0) and main_path's band of the
     unsharded forward; (b) two steps of the online model's training at
     384x512 x 768 tracks on a (1, 2) and a (2, 1) mesh from the same
     parameters as two unsharded steps on the whole batch: loss within 1e-3,
     gradients within 1e-3 of the largest gradient and of the vector's norm,
     parameters within 5e-4 and bit for bit equal on both ranks, K4r 64 a
     step per rank; (c) window_pipeline_forward on two stages, 3 videos x 64
     frames, 2,048 tracks, windows of 16 (route_counts(2048, 16) a window
     run) against forward_windows in main_path's band; (d)
     CoTrackerOnlinePredictor(mesh=(1, 2)) on 10,000 points over 64 frames
     against the unsharded stream (window 3: route_counts(5120, 16), K3 0,
     per rank); (e) `python -m cotracker_tpu_torch.training.trainer
     --distributed` as two processes on phase 21's Kubric tree, 2 steps
     then again to 3 (it resumes): both exit 0, equal parameters, only rank
     0 wrote, K4r 32 a step per rank. Seconds for each part, labelled as 2
     ranks sharing one card (not a scaling figure); `launches_parallel_phase`
     on every kernel sums the counted runs of every rank process.
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
    out = {}
    for (n, T) in (TRAIN_SHAPE, INFER_SHAPE, K4R_TWO_PASS, *K4R_EVAL):
        sfx = "" if (n, T) == TRAIN_SHAPE else K4R_EVAL.get((n, T), f"_t{T}")
        fm, sup, coords, starts, mm = level0_operands(g, dev, n, T)
        Tp = starts.shape[1]
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


def level0_operands(g, dev, n, T):
    """Random operands of one correlation level at level 0 (96x128) for n
    points x T frames: the f32 map and support (L2-normalised), coords
    inside the map, the windows' starts, and the window products'
    multiply-adds (as operations)."""
    Hh, W = LVL0
    fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g).to(dev), dim=-1)
    sup = torch.nn.functional.normalize(torch.randn(1, n, 49, 128, generator=g).to(dev), dim=-1)
    coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
    starts, _ = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
    return fm, sup, coords, starts, n * starts.shape[1] * 64 * 49 * 128 * 2


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
    `counted_window` and read after it (-1: left alone, counts None).
    Returns the last outputs, the counts, and the mean seconds of the
    steady windows 2..n-1."""
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
# at another shape, so the kernels checked at these are the path's (phase
# 24's fast teacher adds its own below DISTILL_T)
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
    """Every kernel that phases 16-19 and phase 24's fast teacher launch,
    against its plain version at
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


V2_T, V2_GRID, V2_RUNS = 60, 50, 3  # (a): 2,500 points x 60 frames, the median of 3 forwards
V2_STREAM_T, V2_STREAM_QUERIES, V2_SUPPORT = 64, 384, 5  # (b): the distillation teacher's shape
V2_WINDOWS = (("v2", 8), ("v2.1", 16))


def damp_v2(model):
    """The CPU tests' damping of random CoTracker2 weights
    (tests/test_torch_cotracker2.py): the flow head x 0.1 and the input
    projection's columns of the sin/cos flow embedding x 0.02. Random
    weights otherwise turn the embedding's ~970 radians a feature-map pixel
    into chaos: two float roundings of one input part by pixels within two
    windows."""
    uf = model.updateformer
    with torch.no_grad():
        uf.flow_head.weight.mul_(0.1)
        uf.flow_head.bias.mul_(0.1)
        uf.input_transform.weight[:, 2:130].mul_(0.02)
    return model


def within(name, out, ref, rtol, atol):
    """|out - ref| <= atol + rtol |ref| everywhere, else raises; returns
    the max |diff| and the largest excess over the bound, as text."""
    out, ref = out.float().cpu(), ref.float().cpu()
    err = (out - ref).abs()
    excess = (err - (atol + rtol * ref.abs())).max().item()
    if not (math.isfinite(err.max().item()) and excess <= 0):
        raise AssertionError(f"{name}: outside rtol {rtol} / atol {atol}")
    return (f"{name} max |diff| {err.max().item():.3e} (rtol {rtol}, atol {atol}; "
            f"{-excess:.3e} inside the bound)")


def v2_offline(dev, smi):
    """(a): CoTrackerPredictor(v2=True, fast=True) for v2 and v2.1 at 2,500
    points x 60 frames, iters=6: the median of 3 timed forwards after a
    warm-up, and one float32 forward of the same weights."""
    from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    video = synthetic_video(V2_T, 384, 512, dev)
    grid_pts = get_points_on_a_grid(V2_GRID, (384, 512)).to(dev)[0]
    n = V2_GRID**2
    preds, res = {}, {}
    for name, window in V2_WINDOWS:
        pred = CoTrackerPredictor(window_len=window, fast=True, v2=True)
        damp_v2(pred.model)
        t0 = time.perf_counter()
        pred(video, grid_size=V2_GRID)  # warm-up
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(V2_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracks, vis = pred(video, grid_size=V2_GRID)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if tuple(tracks.shape) != (1, V2_T, n, 2) or tuple(vis.shape) != (1, V2_T, n):
            raise AssertionError(f"{name}: shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
        if not torch.isfinite(tracks).all():
            raise AssertionError(f"{name}: non-finite tracks")
        if not (torch.equal(tracks[0, 0], grid_pts) and bool(vis[0, 0].all())):
            raise AssertionError(f"{name}: snap-back: frame-0 tracks differ from the queries")
        f32 = CoTrackerPredictor(window_len=window, v2=True)
        f32.model.load_state_dict(pred.model.state_dict())
        t0 = time.perf_counter()
        ref, _ = f32(video, grid_size=V2_GRID)
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
        med, p90, mx = px_stats(tracks, ref)
        sec = sorted(secs)[len(secs) // 2]
        windows = max((V2_T - window + window // 2 - 1) // (window // 2) + 1, 1)
        res[name] = dict(window_len=window, windows=windows, seconds=secs, median_s=sec,
                         points_frames_per_s=n * V2_T / sec, peak_gib=peak, warm_up_s=warm,
                         f32_s=f32_s, bf16_vs_f32_px=(med, p90, mx))
        log(f"  {name} (window {window}, {windows} windows): forwards {[round(s, 3) for s in secs]}"
            f" s, median {sec:.3f} s = {n * V2_T / sec:.0f} points*frames/s, peak memory "
            f"{peak:.2f} GiB (warm-up {warm:.2f} s); float32 forward {f32_s:.3f} s; bf16 vs f32 "
            f"tracks median {med:.3e} px, p90 {p90:.3e}, max {mx:.3e} ({smi})")
        if not med <= 1.0:
            raise AssertionError(f"{name}: bf16 tracks over 1 px (median) from float32")
        preds[name] = pred
        del f32, ref
        torch.cuda.empty_cache()
    return preds, res


def v2_stream_queries(dev):
    """384 seeded queries at frames in [0, 64) and the 5x5 support grid at
    frame 0: the distillation teacher's 409, at 384x512."""
    from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid

    g = torch.Generator().manual_seed(4)
    q = torch.stack([torch.randint(0, V2_STREAM_T, (V2_STREAM_QUERIES,), generator=g).float(),
                     torch.rand(V2_STREAM_QUERIES, generator=g) * 511,
                     torch.rand(V2_STREAM_QUERIES, generator=g) * 383], -1)
    grid = get_points_on_a_grid(V2_SUPPORT, (384, 512))[0]
    support = torch.cat([torch.zeros(V2_SUPPORT**2, 1), grid], -1)
    return torch.cat([q, support])[None].to(dev)


def v2_streaming(dev, smi):
    """(b): CoTrackerOnlinePredictor(v2=True, window_len=16, fast=True),
    409 queries over 64 frames, 7 windows at step 8."""
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    pred = CoTrackerOnlinePredictor(window_len=16, capacity=V2_STREAM_T, fast=True, v2=True)
    damp_v2(pred.model)
    video = synthetic_video(V2_STREAM_T, 384, 512, dev)
    queries = v2_stream_queries(dev)
    n, n_windows = queries.shape[1], (V2_STREAM_T - 16) // 8 + 1
    log(f"  {n} queries, {n_windows} windows:")
    pred(video[:, :1], is_first_step=True, queries=queries)
    (tracks, vis), _, steady = drive_stream(lambda ind: pred(video[:, ind : ind + 16]),
                                            n_windows, n, 8, counted_window=-1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {steady:.4f} s a steady window, peak memory {peak:.2f} GiB ({smi})")
    if tuple(tracks.shape) != (1, V2_STREAM_T, n, 2) or tuple(vis.shape) != (1, V2_STREAM_T, n):
        raise AssertionError(f"v2 streaming: shapes {tuple(tracks.shape)}, {tuple(vis.shape)}")
    if not torch.isfinite(tracks).all():
        raise AssertionError("v2 streaming: non-finite tracks")
    return pred, dict(steady_s=steady, peak_gib=peak, queries=n, windows=n_windows)


def v2_card_vs_cpu(dev, smi):
    """(c): the same damped random weights and inputs at 48x64, iters=2, f32
    with TF32 off: the offline forward (v2, 12 frames, 4 real + 5 masked
    padding queries) and three streaming chunks, on the card against the
    CPU, within the CPU tests' tolerances."""
    import copy

    from cotracker_tpu_torch.models.cotracker2 import CoTracker2

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        cpu = damp_v2(CoTracker2(window_len=8, model_resolution=(48, 64)).eval())
    card = copy.deepcopy(cpu).to(dev)
    g = torch.Generator().manual_seed(5)
    video = torch.rand(1, 16, 48, 64, 3, generator=g) * 255
    q = torch.stack([torch.randint(0, 12, (9,), generator=g).float(),
                     torch.rand(9, generator=g) * 63, torch.rand(9, generator=g) * 47], -1)[None]
    q[:, 4:, 0] = 0
    mask = (torch.arange(9) < 4)[None]
    with torch.inference_mode():
        a = card(video[:, :12].to(dev), q.to(dev), iters=2, track_mask=mask.to(dev))
        b = cpu(video[:, :12], q, iters=2, track_mask=mask)
        res = [within("offline coords", a[0][:, :, :4], b[0][:, :, :4], 1e-3, 2e-2),
               within("offline vis", a[1][:, :, :4], b[1][:, :, :4], 1e-3, 1e-3)]
        sa, sb = card.online_init(1, 9, 32), cpu.online_init(1, 9, 32)
        for ind in (0, 4, 8):
            sa, ca, va = card.online_step(sa, video[:, ind : ind + 8].to(dev), q.to(dev),
                                          iters=2, track_mask=mask.to(dev))
            sb, cb, vb = cpu.online_step(sb, video[:, ind : ind + 8], q, iters=2, track_mask=mask)
        res += [within("three chunks' coords", ca[:, :16, :4], cb[:, :16, :4], 1e-3, 2e-2),
                within("three chunks' vis", va[:, :16, :4], vb[:, :16, :4], 1e-3, 2e-3)]
    log(f"  real tracks, card against CPU: {'; '.join(res)} ({smi})")


def v2_hub(dev, smi, offline_pred, stream_pred):
    """(d): the port's export of the v2 model of (a) and the v2.1 model of
    (b), loaded through hub.cotracker2 and hub.cotracker2v1_online on the
    card: state_dicts, tracks and visibility bit for bit the in-memory
    predictors'."""
    from cotracker_tpu_torch import hub
    from cotracker_tpu_torch.models.checkpoint import save_reference_checkpoint

    root = tempfile.mkdtemp(prefix="chip_smoke_v2hub_")
    try:
        same = {}
        p2, p21 = os.path.join(root, "cotracker2.pth"), os.path.join(root, "cotracker2v1.pth")
        save_reference_checkpoint(p2, offline_pred.model)
        save_reference_checkpoint(p21, stream_pred.model)
        loaded = hub.cotracker2(p2, fast=True)
        a, b = offline_pred.model.state_dict(), loaded.model.state_dict()
        same["v2 state_dict"] = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        video = synthetic_video(HUB_T, 384, 512, dev)
        ref, out = offline_pred(video, grid_size=HUB_GRID), loaded(video, grid_size=HUB_GRID)
        same["v2 outputs"] = torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])
        online = hub.cotracker2v1_online(p21, fast=True, capacity=V2_STREAM_T)
        a, b = stream_pred.model.state_dict(), online.model.state_dict()
        same["v2.1 online state_dict"] = (a.keys() == b.keys()
                                          and all(torch.equal(a[k], b[k]) for k in a))
        video = synthetic_video(V2_STREAM_T, 384, 512, dev)
        queries = v2_stream_queries(dev)

        def stream(pred):  # the first step and three windows
            pred(video[:, :1], is_first_step=True, queries=queries)
            return [pred(video[:, ind : ind + 16]) for ind in (0, 8, 16)][-1]

        (rt, rv), (ot, ov) = stream(stream_pred), stream(online)
        same["v2.1 online outputs"] = torch.equal(rt, ot) and torch.equal(rv, ov)
        log(f"  {os.path.getsize(p2) / 2**20:.1f} MiB reference checkpoint each; bit for bit: "
            f"{same} ({smi})")
        if not all(same.values()):
            raise AssertionError("v2 hub: a loaded predictor differs from the original")
        for name in ("cotracker2", "cotracker2v1_online"):
            url = hub.CHECKPOINT_URLS[name.removesuffix("_online")]
            try:
                getattr(hub, name)(url)
            except ValueError as e:
                if url not in str(e):
                    raise AssertionError(f"v2 hub: the URL's error does not name it: {e}") from e
            else:
                raise AssertionError("v2 hub: a URL did not raise")
        log(f"  a URL raises with the URL ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def v2_phase(dev, smi):
    """Phase 23 (see the module docstring): (a)-(d) with the launch counters
    zeroed before and read after, (e) every count zero."""
    t0 = time.perf_counter()
    zero_counts()
    log("  (a) offline, CoTrackerPredictor(v2=True, fast=True), "
        f"{V2_GRID**2} points x {V2_T} frames, iters=6:")
    offline_preds, offline = v2_offline(dev, smi)
    log("  (b) streaming, CoTrackerOnlinePredictor(v2=True, window_len=16, fast=True), "
        f"the distillation teacher's shape, {V2_STREAM_T} frames:")
    stream_pred, stream = v2_streaming(dev, smi)
    log("  (c) card against CPU, f32, TF32 off, 48x64, iters=2:")
    v2_card_vs_cpu(dev, smi)
    log("  (d) hub: hub.cotracker2 and hub.cotracker2v1_online from the port's export:")
    v2_hub(dev, smi, offline_preds["v2"], stream_pred)
    counts = read_counts()
    log(f"  (e) kernel launches across (a)-(d): {counts} ({smi})")
    if any(counts.values()):
        raise AssertionError("v2: the legacy model's path launched a kernel")
    return counts, dict(offline=offline, streaming=stream, phase_s=time.perf_counter() - t0)


DISTILL_T, DISTILL_Q, DISTILL_SUPPORT = 64, 384, 5  # the distillation defaults: seq_len, sift_size
DISTILL_CLIPS, DISTILL_CLIP_T, DISTILL_CLIP_HW = 2, 96, (360, 480)
DISTILL_STEPS = 3  # then a second run to DISTILL_STEPS + 1, which auto-resumes
# the student's K4r calls: the offline student's one window of 64 frames,
# the online student's windows of 16 (384 points each); their keys' suffixes
K4R_DISTILL = {(DISTILL_Q, DISTILL_T): "_distill", (DISTILL_Q, 16): "_distill_online"}
# the fast v3 teacher's forward: the queries and the support grid, padded to
# the evaluation predictor's bucket of 64
SURFACE["distill_fast"] = (-(-(DISTILL_Q + DISTILL_SUPPORT**2) // 64) * 64, DISTILL_T,
                           DISTILL_Q + DISTILL_SUPPORT**2)


def k4r_per_distill_step(frames, window):
    """K4r launches of one student step: 4 levels x TRAIN_ITERS iterations x
    the clip's windows (one for the offline student) x 2 (the checkpointed
    forward runs again in the backward)."""
    windows = 1 if window is None else max(1, -(-(frames - window) // (window // 2)) + 1)
    return 4 * TRAIN_ITERS * windows * 2


def write_distill_clips(root):
    """DISTILL_CLIPS MJPG .avi clips written with OpenCV, DISTILL_CLIP_T
    frames of MovingClip's texture at DISTILL_CLIP_HW each, then decoded
    back: every frame there, within 12 (mean absolute, of 255) of the frame
    written (MJPG is lossy: ~7 on this texture). Returns the seconds both
    took."""
    import cv2

    H, W = DISTILL_CLIP_HW
    t0 = time.perf_counter()
    os.makedirs(root)
    for i in range(DISTILL_CLIPS):
        path = os.path.join(root, f"clip{i}.avi")
        frames = MovingClip(DISTILL_CLIP_T, H, W, 1, seed=40 + i).sample.video
        frames = frames.transpose(0, 2, 3, 1).round().astype(np.uint8)
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
        if not wr.isOpened():
            raise AssertionError(f"OpenCV cannot write {path}")
        for f in frames:
            wr.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        wr.release()
        cap, back = cv2.VideoCapture(path), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            back.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        cap.release()
        err = (np.abs(np.stack(back).astype(np.float32) - frames).mean()
               if len(back) == len(frames) else math.inf)
        if err > 12:
            raise AssertionError(f"{path}: {len(back)} of {len(frames)} frames decode back, "
                                 f"mean error {err}")
    return time.perf_counter() - t0


def write_teacher_checkpoints(root):
    """Random-weight v2.1 (damped as damp_v2 says), v3 online and v3
    offline models saved as reference-format checkpoints; their paths."""
    from cotracker_tpu_torch.models.build import build_cotracker
    from cotracker_tpu_torch.models.checkpoint import save_reference_checkpoint

    paths = {}
    for seed, (name, kw) in enumerate((("v21", dict(v2=True, window_len=16)),
                                       ("v3_online", dict(offline=False)),
                                       ("v3_offline", dict(offline=True))), start=1):
        model = build_cotracker(device="cpu", seed=seed, **kw)
        if "v2" in kw:
            damp_v2(model)
        paths[name] = os.path.join(root, f"{name}.pth")
        save_reference_checkpoint(paths[name], model)
    return paths


def run_teacher(teacher, video, queries):
    """One pseudo-label call of one teacher with the support grid, timed
    (synchronised) with the peak memory; its tracks and vis checked."""
    from cotracker_tpu_torch.training.distill import TeacherEnsemble

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tracks, vis = TeacherEnsemble([teacher], DISTILL_SUPPORT).pseudo_label(video, queries)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if tracks.shape != (1, DISTILL_T, DISTILL_Q, 2) or vis.shape != (1, DISTILL_T, DISTILL_Q):
        raise AssertionError(f"a teacher answered {tracks.shape}, {vis.shape}")
    if not (np.isfinite(tracks).all() and np.isfinite(vis).all()):
        raise AssertionError("a teacher's tracks or visibility are not finite")
    return secs, torch.cuda.max_memory_allocated() / 2**30


def distill_teachers(dev, smi, videos, ckpts):
    """Step 3 of phase 24: each teacher of default_teacher_ensemble twice on
    a 64-frame 384x512 clip with 384 SIFT queries + the 5x5 support grid
    (the first call and the second), and the v3 offline teacher built with
    fast=True the same way: the tracks and frames its model is given must
    be SURFACE's (where phase 3 held K1-K4 to their plain versions), and
    its launches those route_counts gives there."""
    from cotracker_tpu_torch.datasets.real_videos import LocalVideoDataset
    from cotracker_tpu_torch.evaluation.bootstap_predictor import TAPIRPredictor
    from cotracker_tpu_torch.training.distill import default_teacher_ensemble, sample_distill_queries

    sample, ok = LocalVideoDataset(videos, crop_size=TRAIN_RES, seq_len=DISTILL_T)[0]
    if not ok or sample.video.shape != (DISTILL_T, 3, *TRAIN_RES):
        raise AssertionError("LocalVideoDataset: no 64-frame clip at the crop")
    video_np = sample.video[None]
    t0 = time.perf_counter()
    queries = sample_distill_queries(video_np, DISTILL_Q, np.random.default_rng(0))
    out = {"sift_s": time.perf_counter() - t0}
    video = torch.from_numpy(video_np).to(dev)
    ens = default_teacher_ensemble(ckpts["v21"], ckpts["v3_online"], ckpts["v3_offline"],
                                   support_grid_size=DISTILL_SUPPORT, device=dev)
    for name, teacher in zip(("v21", "v3_online", "v3_offline"), ens.teachers):
        out[name] = [run_teacher(teacher, video, queries) for _ in range(2)]
    del ens
    fast = default_teacher_ensemble(v3_offline_checkpoint=ckpts["v3_offline"], fast=True,
                                    device=dev).teachers[0]
    model, seen = fast.model, []

    def observed(video_cl, queries, **kw):  # (padded tracks, frames) of each forward
        seen.append((queries.shape[1], video_cl.shape[1]))
        return model(video_cl, queries, **kw)

    fast.model = observed
    before = read_counts()
    out["v3_offline_fast"] = [run_teacher(fast, video, queries) for _ in range(2)]
    out["v3_offline_fast_launches"] = {k: v - before[k] for k, v in read_counts().items()}
    del fast, model
    if len(seen) != 2:
        raise AssertionError(f"the fast v3 teacher ran {len(seen)} forwards in two calls")
    for shape in seen:
        check_surface_shape("distill_fast", *shape)
    want = {k: 2 * c for k, c in route_counts(*seen[0]).items()}
    if out["v3_offline_fast_launches"] != want:
        raise AssertionError(f"the fast v3 teacher launched {out['v3_offline_fast_launches']}, "
                             f"expected {want} in two calls")
    for name in ("v21", "v3_online", "v3_offline", "v3_offline_fast"):
        (s1, g1), (s2, g2) = out[name]
        log(f"  teacher {name}, {DISTILL_Q} + {DISTILL_SUPPORT**2} queries x {DISTILL_T} frames "
            f"at {TRAIN_RES[0]}x{TRAIN_RES[1]}: {s1:.3f} s the first call, {s2:.3f} s the second, "
            f"peak memory {g2:.2f} GiB ({smi})")
    log(f"  the fast v3 teacher's two calls, at {seen[0][0]} padded tracks x {seen[0][1]} frames, "
        f"launched { {k: v for k, v in out['v3_offline_fast_launches'].items() if v} }; SIFT queries on "
        f"the host: {out['sift_s']:.3f} s ({sum(1 for t in queries[0, :, 0] if t < 16)} of "
        f"{DISTILL_Q} from the first 16 frames)")
    try:
        TAPIRPredictor()
    except ImportError as e:
        if "tapnet" not in str(e):
            raise
        log(f"  TAPIRPredictor() raises: {e}")
    else:
        raise AssertionError("TAPIRPredictor() built without a model_fn")
    return out


def distill_runs(dev, smi, videos, ckpts, root):
    """Steps 5-6 of phase 24: the command line on the offline student for
    DISTILL_STEPS steps with a checkpoint at the last, again to one step
    more (it auto-resumes), then one step of the online student (windows
    of 16); each step's launches, ms and K4r shapes recorded, the host's
    query and teacher seconds. Returns the steps, shapes, timings and the
    two students."""
    from cotracker_tpu_torch.training import distill, distill_trainer

    teachers = ["--teacher_v21", ckpts["v21"], "--teacher_v3_online", ckpts["v3_online"],
                "--teacher_v3_offline", ckpts["v3_offline"]]
    exp = os.path.join(root, "exp")
    argv = ["--dataset_root", videos, "--exp_dir", exp, *teachers, "--seq_len", str(DISTILL_T),
            "--sift_size", str(DISTILL_Q), "--num_steps", str(DISTILL_STEPS),
            "--save_every_n_steps", str(DISTILL_STEPS), "--device", dev.type]
    args = distill_trainer.parse_args(argv)
    if (args.crop_size, args.seq_len, args.sift_size, args.train_iters, args.offline_model,
            args.use_corr_kernels, args.corr_quant_int8, args.device) != (
            TRAIN_RES, DISTILL_T, DISTILL_Q, TRAIN_ITERS, True, True, True, dev.type):
        raise AssertionError(f"the command line parsed to {args}")
    steps, host = [], {"queries_s": [], "teacher_s": []}
    step_fn, query_fn = distill_trainer.distill_step, distill_trainer.sample_distill_queries
    label_fn, launch, shapes = distill.TeacherEnsemble.pseudo_label, corr_cuda._k4_launch, []

    def counted_step(*a, **kw):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*a, **kw)
        torch.cuda.synchronize()
        steps[-1].append(({k: v - before[k] for k, v in read_counts().items()},
                          1e3 * (time.perf_counter() - t0)))
        return out

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[key].append(time.perf_counter() - t0)
            return out
        return call

    def recorded(fmq, supq, starts, wxy, plan):  # (points, padded frames) of each K4r
        if wxy is None:
            shapes.append(tuple(starts.shape[:2]))
        return launch(fmq, supq, starts, wxy, plan)

    distill_trainer.distill_step = counted_step
    distill_trainer.sample_distill_queries = timed("queries_s", query_fn)
    distill.TeacherEnsemble.pseudo_label = timed("teacher_s", label_fn)
    corr_cuda._k4_launch = recorded
    t0 = time.perf_counter()
    try:
        runs, host["peak_gib"] = {}, {}
        for name, extra in (("first", []), ("resumed", ["--num_steps", str(DISTILL_STEPS + 1)]),
                            ("online", ["--exp_dir", os.path.join(root, "exp_online"),
                                        "--offline_model", "--model_window_len", "16",
                                        "--num_steps", "1", "--save_every_n_steps", "0"])):
            steps.append([])
            torch.cuda.reset_peak_memory_stats()
            runs[name] = distill_trainer.main(argv + extra)
            host["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        distill_trainer.distill_step, distill_trainer.sample_distill_queries = step_fn, query_fn
        distill.TeacherEnsemble.pseudo_label, corr_cuda._k4_launch = label_fn, launch
    host["cli_s"] = time.perf_counter() - t0
    with open(os.path.join(exp, "train_log.jsonl")) as f:
        host["losses"] = [json.loads(line)["total_loss"] for line in f]
    ckpts_written = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    if ([len(s) for s in steps] != [DISTILL_STEPS, 1, 1] or len(host["losses"]) != DISTILL_STEPS + 1
            or ckpts_written != [f"model_{DISTILL_STEPS:09d}.pth", "model_final.pth"]
            or not all(math.isfinite(x) for x in host["losses"])):
        raise AssertionError(f"distillation runs: steps {[len(s) for s in steps]}, losses "
                             f"{host['losses']}, checkpoints {ckpts_written}")
    return steps, shapes, host, runs


def check_frozen_head(name, model, window):
    """The student's vis_conf_head bit for bit its first values (a fresh
    build_training_model from the same seed), and its flow_head moved."""
    from cotracker_tpu_torch.models.build import build_training_model

    start = build_training_model(offline=window is None, window_len=window or 60,
                                 model_resolution=TRAIN_RES, device="cpu", seed=0).updateformer
    uf = model.updateformer
    same = all(torch.equal(getattr(uf.vis_conf_head, p).cpu(), getattr(start.vis_conf_head, p))
               for p in ("weight", "bias"))
    moved = not torch.equal(uf.flow_head.weight.cpu(), start.flow_head.weight)
    log(f"  {name} student: vis_conf_head bit for bit its first values: {same}; "
        f"flow_head moved: {moved}")
    if not (same and moved):
        raise AssertionError(f"{name} student: the frozen head moved or nothing trained")


def distill_phase(dev, smi, k4r_row):
    """Phase 24 (see the module docstring): steps 1-7, the launch counters
    zeroed before step 3 and read after step 6; then step 8 on `k4r_row`
    (the K4r entry of the kernels line) and step 9. Returns the phase's
    launches, the K4r launches each student step made (checked against
    k4r_per_distill_step) and the metrics."""
    root = tempfile.mkdtemp(prefix="chip_smoke_distill_")
    t_phase = time.perf_counter()
    try:
        videos = os.path.join(root, "videos")
        clip_s = write_distill_clips(videos)
        ckpts = write_teacher_checkpoints(root)
        log(f"  wrote {DISTILL_CLIPS} clips of {DISTILL_CLIP_T} frames at {DISTILL_CLIP_HW[1]}x"
            f"{DISTILL_CLIP_HW[0]} (MJPG .avi, decoded back) in {clip_s:.2f} s, and the three "
            "teachers' reference-format checkpoints")
        zero_counts()
        teachers = distill_teachers(dev, smi, videos, ckpts)
        torch.cuda.empty_cache()
        steps, shapes, host, runs = distill_runs(dev, smi, videos, ckpts, root)
        phase_counts = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    zeros = dict.fromkeys(WRAPPERS, 0)
    want = {"offline": k4r_per_distill_step(DISTILL_T, None),
            "online": k4r_per_distill_step(DISTILL_T, 16)}
    offline = [c for c, _ in steps[0] + steps[1]]
    measured = {"offline": [c["K4r_corr_volume_raw"] for c in offline],
                "online": steps[2][0][0]["K4r_corr_volume_raw"]}
    if (any(c != {**zeros, "K4r_corr_volume_raw": want["offline"]} for c in offline)
            or steps[2][0][0] != {**zeros, "K4r_corr_volume_raw": want["online"]}):
        raise AssertionError(f"distillation steps launched {offline}, {steps[2][0][0]}; "
                             f"expected K4r {want} a step and nothing else")
    if sorted(set(shapes)) != sorted(K4R_DISTILL):
        raise AssertionError(f"the students ran K4r at {sorted(set(shapes))} (points, padded "
                             f"frames), the phase holds {sorted(K4R_DISTILL)}")
    check_frozen_head("offline (after the resumed run)", runs["resumed"], None)
    check_frozen_head("online", runs["online"], 16)
    del runs
    torch.cuda.empty_cache()
    ms = [m for _, m in steps[0] + steps[1]]
    log(f"  distill_trainer.main: {DISTILL_STEPS} offline steps, then resumed at step "
        f"{DISTILL_STEPS} for one more, then one online step "
        f"({max(1, -(-(DISTILL_T - 16) // 8) + 1)} "
        f"windows of 16): ms per step "
        f"{[round(m, 1) for m in ms]} offline, {steps[2][0][1]:.1f} online; K4r a step "
        f"{[c['K4r_corr_volume_raw'] for c in offline]} offline, "
        f"{steps[2][0][0]['K4r_corr_volume_raw']} online (4 levels x {TRAIN_ITERS} iterations x "
        f"windows x 2), every other kernel 0; host seconds a step: queries "
        f"{[round(x, 3) for x in host['queries_s']]}, teacher "
        f"{[round(x, 3) for x in host['teacher_s']]}; total loss "
        f"{[round(x, 4) for x in host['losses']]}; the three runs {host['cli_s']:.1f} s, peak "
        f"memory by run {({k: round(v, 2) for k, v in host['peak_gib'].items()})} GiB ({smi})")
    log("  K4r at the students' shapes against its plain version, levels 0-3:")
    out = {"K4r_corr_volume_raw": k4r_row}
    g = torch.Generator().manual_seed(24)
    for (n, T), sfx in K4R_DISTILL.items():
        fm, sup, coords, starts, mm = level0_operands(g, dev, n, T)
        k4r_entry(out, fm, sup, starts, n, T, mm, sfx)
        k4r_levels_check(out, g, sup, coords, n, T, sfx)
        log(f"  K4r {n}x{T}: {k4r_row['ms' + sfx]:.3f} ms (plain {k4r_row['plain_ms' + sfx]:.3f} "
            f"ms, bound {k4r_row['bound_ms' + sfx]:.3f} ms by {k4r_row['bound_by' + sfx]})")
        del fm, sup
    metrics = dict(teachers=teachers, ms_per_offline_step=ms, ms_online_step=steps[2][0][1],
                   phase_s=time.perf_counter() - t_phase, **host)
    return phase_counts, measured, metrics



# (phase 25): data, track and window parallelism over torch.distributed.
# The ranks are processes of this script (`--parallel-rank PART DIR`),
# started fresh (never forked after CUDA started), after the kernels are
# built: they load the same build directory.

PAR_GRID, PAR_N, PAR_LOCAL = 100, 10240, 5120  # (a), (d): 10,000 points, 5,120 a rank
PAR_DAMP = 0.05  # the update heads' scale: the JAX tests' contractive regime
PAR_PIPE = (3, 64, 2048, 16)  # (c) videos, frames, tracks, window
PAR_STREAM_T = 64
PAR_TIMEOUT_S = 420  # every rank job; every collective waits at most 240 s
PAR_LABEL = "2 ranks sharing one card; not a scaling figure"
FAST_TOL = (0.5, 4.0, 0.1)  # coords median, max px; vis/conf max: main_path's card-vs-plain band
SAME_ROUTE_TOL = (0.25, 0.01)  # coords max px, vis/conf max: the same route over 1 and 2 ranks


def damp_heads(model, k=PAR_DAMP):
    uf = model.updateformer
    with torch.no_grad():
        for head in (uf.flow_head, uf.vis_conf_head):
            head.weight.mul_(k)
            head.bias.mul_(k)
    return model


def par_queries(n_real, n_pad, T, H, W, dev, spread=False):
    """(1, n_pad, 3) queries of a grid over (H, W), the tail padding masked;
    with `spread` the query frames cycle through the video."""
    from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid

    grid = int(math.isqrt(n_real))
    xy = get_points_on_a_grid(grid, (H, W))[0][:n_real]
    t = (torch.arange(n_real) * 7 % (T - 8)).float() if spread else torch.zeros(n_real)
    q = torch.zeros(1, n_pad, 3)
    q[0, :n_real] = torch.cat([t[:, None], xy], -1)
    mask = torch.zeros(1, n_pad, dtype=torch.bool)
    mask[0, :n_real] = True
    return q.to(dev), mask.to(dev)


def par_expected(n_local, T, runs=1, k3=True):
    """route_counts at this rank's tracks, `runs` forwards, K3 0 where the
    track group bypasses it."""
    want = {k: v * runs for k, v in route_counts(n_local, T).items()}
    if not k3:
        want["K3_virtual_from_points_proj"] = 0
    return want


def par_close(name, out, ref, tol):
    """coords median and max px and vis / conf max between two (coords,
    vis, conf) triples, against `tol` (median, max, vis) or (max, vis)."""
    err = (out[0].float() - ref[0].float()).norm(dim=-1).flatten()
    verr = max((a.float() - b.float()).abs().max().item() for a, b in zip(out[1:], ref[1:]))
    got = (err.median().item(), err.max().item(), verr)
    ok = (got[0] <= tol[0] and got[1] <= tol[1] and got[2] <= tol[2]) if len(tol) == 3 else (
        got[1] <= tol[0] and got[2] <= tol[1])
    log(f"    {name}: coords median {got[0]:.3e} px, max {got[1]:.3e} px, vis/conf max "
        f"{got[2]:.3e} (bounds {tol})")
    if not ok:
        raise AssertionError(f"parallel: {name} outside its bounds")
    return got


def par_forward(mesh, dev):
    """(a), or the NCCL world-1 run: the track-sharded offline forward at
    full width, 384x512, 60 frames, PAR_N tracks over the mesh's track
    ranks, iters=6, damped heads; its counts from the second call."""
    from cotracker_tpu_torch.models.build import build_cotracker
    from cotracker_tpu_torch.parallel.mesh import (
        COORDS_PSPEC, MASK_PSPEC, QUERY_PSPEC, TN_PSPEC, gather, replicate, shard_batch,
        track_sharded_forward,
    )

    model = damp_heads(build_cotracker(fast=True, device=dev))
    replicate(mesh, model)
    video = synthetic_video(T_FRAMES, 384, 512, dev).permute(0, 1, 3, 4, 2)
    queries, mask = par_queries(PAR_GRID**2, PAR_N, T_FRAMES, 384, 512, dev)
    fwd = track_sharded_forward(model, mesh, iters=6)
    q, m = shard_batch(mesh, queries, QUERY_PSPEC), shard_batch(mesh, mask, MASK_PSPEC)
    fwd(video, q, m)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fwd(video, q, m)
    torch.cuda.synchronize()
    res = {"seconds": time.perf_counter() - t0, "counts": read_counts(), "n_local": q.shape[1]}
    n = PAR_GRID**2  # the real tracks
    full = (gather(mesh, out[0], COORDS_PSPEC), gather(mesh, out[1], TN_PSPEC),
            gather(mesh, out[2], TN_PSPEC))
    res["out"] = tuple(x[:, :, :n].cpu() for x in full)
    if mesh.index["track"] == 0:
        with torch.inference_mode():
            res["unsharded"] = tuple(x[:, :, :n].cpu() for x in model(
                video, queries, iters=6, track_mask=mask)[:3])
    return res


def par_params_digest(model):
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def par_train(dev):
    """(b): the online model at TRAIN_RES, 2 rows of TRAIN_TRACKS tracks, 24
    frames (two windows of 16), iters=TRAIN_ITERS: rank 0 runs two unsharded
    steps on the whole batch, then every rank two sharded steps from the same
    parameters on a (1, 2) mesh (each rank both rows' halves of the tracks)
    and on a (2, 1) mesh (each rank one row). K4r's count a step per rank."""
    import copy

    from cotracker_tpu_torch.models.build import build_training_model
    from cotracker_tpu_torch.parallel.distributed import is_main_process
    from cotracker_tpu_torch.parallel.mesh import (
        BATCH_PSPECS, make_fast_sharded_train_step, make_mesh, replicate, shard_batch,
    )
    from cotracker_tpu_torch.training.train_step import (
        TrainConfig, make_optimizer, train_step,
    )

    rows = [MovingClip(24, *TRAIN_RES, TRAIN_TRACKS, seed=30 + b).sample for b in range(2)]
    batch = {"video": torch.from_numpy(np.stack([r.video.transpose(0, 2, 3, 1) for r in rows])),
             "trajs_g": torch.from_numpy(np.stack([r.trajectory for r in rows])),
             "vis_g": torch.from_numpy(np.stack([r.visibility for r in rows])),
             "valids": torch.from_numpy(np.stack([r.valid for r in rows]))}
    cfg = TrainConfig(iters=TRAIN_ITERS, offline_model=False, sliding_window_len=16)
    base = build_training_model(offline=False, window_len=16, model_resolution=TRAIN_RES,
                                device=dev, seed=0)
    first = is_main_process()
    out = {}
    if first:
        model = copy.deepcopy(base)
        opt, sched = make_optimizer(model, 1e-4, 1e-5, 100)
        gen = torch.Generator().manual_seed(0)
        full = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        aux = train_step(model, opt, sched, full, gen, cfg)
        out["ref_loss"] = aux["total_loss"].item()
        out["ref_grads"] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        train_step(model, opt, sched, full, gen, cfg)
        torch.cuda.synchronize()
        out["ref_s"] = time.perf_counter() - t0
        out["ref_params"] = [p.detach().cpu().clone() for p in model.parameters()]
        del model, opt, full
    for shape in ((1, 2), (2, 1)):
        t_part = time.perf_counter()
        mesh = make_mesh(shape)
        model = copy.deepcopy(base)
        replicate(mesh, model)
        opt, sched = make_optimizer(model, 1e-4, 1e-5, 100)
        step = make_fast_sharded_train_step(model, opt, sched, cfg, mesh)
        gen = torch.Generator().manual_seed(0)
        local = {k: shard_batch(mesh, v, BATCH_PSPECS[k]) for k, v in batch.items()}
        res = {"counts": [], "seconds": []}
        for i in range(2):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            aux = step(local, gen)
            torch.cuda.synchronize()
            res["seconds"].append(time.perf_counter() - t0)
            res["counts"].append(read_counts())
            if i == 0 and first:  # every rank holds the same (the digests)
                res["loss"] = aux["total_loss"].item()
                res["grads"] = {n: p.grad.detach().cpu().clone()
                                for n, p in model.named_parameters()}
        res["digest"] = par_params_digest(model)
        if first:
            res.update(out, params=[p.detach().cpu().clone() for p in model.parameters()])
        res["part_s"] = time.perf_counter() - t_part
        out[str(shape)] = res
        del model, opt, step
        torch.cuda.empty_cache()
    return {k: out[k] for k in ("(1, 2)", "(2, 1)")}


def par_pipeline(dev):
    """(c): window_pipeline_forward on two stages (PAR_PIPE), damped heads;
    the first stage also runs forward_windows. The counts of the pipeline's
    call, and the windows this stage ran."""
    from cotracker_tpu_torch.models.build import build_cotracker
    from cotracker_tpu_torch.parallel.mesh import replicate
    from cotracker_tpu_torch.parallel.window_pipeline import (
        make_window_mesh, window_pipeline_forward,
    )

    B, T, N, S = PAR_PIPE
    mesh = make_window_mesh(2)
    model = damp_heads(build_cotracker(fast=True, offline=False, window_len=S, device=dev))
    replicate(mesh, model)
    base = synthetic_video(T, 384, 512, dev).permute(0, 1, 3, 4, 2)
    video = torch.cat([base, base.flip(2), base.flip(3)])
    q, mask = par_queries(45 * 45, N, T, 384, 512, dev, spread=True)
    queries, mask = q.expand(B, -1, -1).contiguous(), mask.expand(B, -1).contiguous()
    fwd = window_pipeline_forward(model, mesh, iters=6)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fwd(video, queries, mask)
    torch.cuda.synchronize()
    res = {"seconds": time.perf_counter() - t0, "counts": read_counts(),
           "out": tuple(x.cpu() for x in out)}
    num_windows = -(-(T - S) // (S // 2)) + 1
    wloc = -(-num_windows // 2)
    res["windows_run"] = B * min(wloc, num_windows - mesh.index["window"] * wloc)
    if mesh.index["window"] == 0:
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = model.forward_windows(video, queries, iters=6, track_mask=mask)[:3]
            torch.cuda.synchronize()
            res["ref_seconds"] = time.perf_counter() - t0
        res["ref"] = tuple(x.cpu() for x in ref)
    return res


def par_stream(dev):
    """(d): CoTrackerOnlinePredictor(fast=True, mesh=(1, 2)) on PAR_GRID**2
    points over PAR_STREAM_T frames, damped heads; rank 0 also streams
    unsharded. The counts of window 3 of the sharded stream."""
    from cotracker_tpu_torch.parallel.distributed import is_main_process
    from cotracker_tpu_torch.parallel.mesh import make_mesh
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    video = synthetic_video(PAR_STREAM_T, 384, 512, dev)
    res = {}
    for name, mesh in (("sharded", make_mesh((1, 2))), ("ref", None)):
        if mesh is None and not is_main_process():
            continue
        p = CoTrackerOnlinePredictor(fast=True, capacity=PAR_STREAM_T, mesh=mesh)
        damp_heads(p.model)
        p(video[:, :1], is_first_step=True, grid_size=PAR_GRID)
        secs = []
        for w, ind in enumerate(range(0, PAR_STREAM_T - p.step, p.step)):
            if w == 3:
                zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracks, vis = p(video[:, ind : ind + 2 * p.step])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if w == 3:
                res[f"{name}_counts"] = read_counts()
        res[name] = (tracks.cpu(), vis.cpu())
        res[f"{name}_seconds"] = secs
        del p
    return res


def par_trainer_rank(argv, out_path):
    """(e): one rank of the trainer's command line: main(argv), the paths
    it wrote, its launch counts and a digest of its parameters."""
    import builtins

    from cotracker_tpu_torch.training import trainer

    written = []
    real_open, real_save = builtins.open, torch.save

    def open_w(path, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(path))
        return real_open(path, mode, *a, **k)

    def save_w(obj, f, *a, **k):
        written.append(str(f))
        return real_save(obj, f, *a, **k)

    zero_counts()
    builtins.open, torch.save = open_w, save_w
    try:
        with signals_restored():
            model = trainer.main(argv)
    finally:
        builtins.open, torch.save = real_open, real_save
    torch.save({"written": written, "counts": read_counts(),
                "digest": par_params_digest(model)}, out_path)


def parallel_rank(part, root, extra):
    """A rank process of phase 25 (`chip_smoke.py --parallel-rank PART DIR
    [ARGS]`): joins the job from the RANK / WORLD_SIZE / MASTER_* variables,
    runs its part and writes DIR/PART_rank{r}.pt; a failure writes
    DIR/PART_rank{r}.err."""
    import torch.distributed as dist

    from cotracker_tpu_torch.parallel import distributed as pdist
    from cotracker_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    out = os.path.join(root, f"{part}_rank{rank}")
    try:
        if part == "trainer":
            par_trainer_rank(extra, out + ".pt")
            return
        backend = "nccl" if part == "nccl1" else "gloo"
        pdist.initialize(backend=backend, device="cuda", timeout_s=240)
        dev = pdist.rank_device()
        res = {"device": str(dev), "backend": dist.get_backend()}
        if part == "nccl1":
            res["forward"] = par_forward(make_mesh((1, 1)), dev)
        else:
            t0 = time.perf_counter()
            res["forward"] = par_forward(make_mesh((1, 2)), dev)
            res["forward"]["part_s"] = time.perf_counter() - t0
            for shape, r in par_train(dev).items():
                res[f"train_{shape}"] = r
            t0 = time.perf_counter()
            res["pipeline"] = par_pipeline(dev)
            res["pipeline"]["part_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res["stream"] = par_stream(dev)
            res["stream"]["part_s"] = time.perf_counter() - t0
        pdist.sync_global_devices()
        torch.save(res, out + ".pt")
        dist.destroy_process_group()
    except BaseException:
        import traceback

        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(root, part, world, extra=()):
    """Start `world` rank processes of `part`, wait for all (PAR_TIMEOUT_S),
    stop every one still running, and return their results; a rank that
    fails or hangs fails the phase with its error and output's tail."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    logs = [open(os.path.join(root, f"{part}_rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", part, root, *extra],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PAR_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            for ext in (".err", ".log"):
                path = os.path.join(root, f"{part}_rank{r}{ext}")
                if os.path.exists(path):
                    with open(path) as f:
                        tails.append(f"--- rank {r}{ext} ---\n{f.read()[-3000:]}")
        raise AssertionError(f"parallel {part}: ranks {bad} failed or hung (exit codes "
                             f"{[p.returncode for p in procs]})\n" + "\n".join(tails))
    return [torch.load(os.path.join(root, f"{part}_rank{r}.pt"), weights_only=False)
            for r in range(world)], time.perf_counter() - t0


def par_check_counts(name, got, want):
    if got != want:
        raise AssertionError(f"parallel {name}: launched {got}, expected {want}")


def par_check_train(name, ranks):
    """(b)'s checks: loss and gradients against the unsharded step, the
    parameters after two steps too, bit for bit equal on every rank, K4r's
    count a step per rank. A gradient's difference is measured against the
    largest gradient of the model: the encoder's biases that an instance
    norm removes have gradients of float32 noise only, different in each
    summation order."""
    ref = ranks[0]
    k4r = 4 * TRAIN_ITERS * 2 * 2  # levels x iterations x windows x (forward + remat)
    want = {**dict.fromkeys(WRAPPERS, 0), "K4r_corr_volume_raw": k4r}
    for r in ranks:
        for c in r["counts"]:
            par_check_counts(f"{name} step", c, want)
    loss_err = abs(ref["loss"] - ref["ref_loss"]) / abs(ref["ref_loss"])
    scale = max(h.abs().max().item() for h in ref["ref_grads"].values())
    worst = sorted(((ref["grads"][n] - h).abs().max().item() / scale, n)
                   for n, h in ref["ref_grads"].items())[-3:]
    grad_err = worst[-1][0]
    norm = lambda d: torch.cat([v.flatten() for v in d.values()])  # noqa: E731
    norm_err = ((norm(ref["grads"]) - norm(ref["ref_grads"])).norm()
                / norm(ref["ref_grads"]).norm()).item()
    param_err = max((p - q).abs().max().item() for p, q in zip(ref["params"], ref["ref_params"]))
    log(f"    {name}: loss {ref['loss']:.6f} (unsharded {ref['ref_loss']:.6f}, relative "
        f"{loss_err:.2e}, bound 1e-3); gradients: the largest difference over the largest "
        f"gradient ({scale:.3e}) {grad_err:.2e} (bound 1e-3; the three worst "
        f"{[(n, round(e, 8)) for e, n in worst]}), of the whole vector's norm {norm_err:.2e} "
        f"(bound 1e-3); parameters after 2 steps {param_err:.2e} (bound 5e-4); K4r {k4r} a "
        f"step on every rank; seconds a step {[round(s, 3) for s in ranks[0]['seconds']]} "
        f"(the unsharded two steps on the whole batch {ref['ref_s']:.3f} s)")
    if loss_err > 1e-3 or grad_err > 1e-3 or norm_err > 1e-3 or param_err > 5e-4:
        raise AssertionError(f"parallel {name}: the sharded step differs from the unsharded one")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError(f"parallel {name}: the ranks' parameters differ")
    return {"loss_rel": loss_err, "grad_rel": grad_err, "grad_norm_rel": norm_err,
            "param_abs": param_err,
            "step_s": ranks[0]["seconds"], "part_s": ranks[0]["part_s"]}


def parallel_phase(dev, smi):
    """Phase 25 (see the module docstring). Returns the launch counts of
    every rank process summed, and the metrics."""
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    metrics, total = {}, dict.fromkeys(WRAPPERS, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    try:
        log(f"  world 1 over NCCL: the track-sharded forward on a (1, 1) mesh, {PAR_N} tracks x "
            f"{T_FRAMES} frames:")
        (one,), secs = run_ranks(root, "nccl1", 1)
        f1 = one["forward"]
        want = par_expected(PAR_N, T_FRAMES, k3=False)
        par_check_counts("world 1", f1["counts"], want)
        add(f1["counts"])
        log(f"    backend {one['backend']} on {one['device']}: forward {f1['seconds']:.3f} s, "
            f"launches {want} (K3 0: the track group bypasses it); job {secs:.1f} s ({smi})")
        par_close("world 1 vs the unsharded forward (K3)", f1["out"], f1["unsharded"], FAST_TOL)
        metrics["world1_forward_s"] = f1["seconds"]

        log(f"  two gloo ranks on {dev} ({PAR_LABEL}):")
        ranks, secs = run_ranks(root, "gloo2", 2)
        metrics["gloo2_job_s"] = secs
        fa = [r["forward"] for r in ranks]
        want = par_expected(PAR_LOCAL, T_FRAMES, k3=False)
        for r, f in enumerate(fa):
            par_check_counts(f"(a) rank {r}", f["counts"], want)
            if f["n_local"] != PAR_LOCAL:
                raise AssertionError(f"(a) rank {r} held {f['n_local']} tracks")
        log(f"  (a) track-sharded forward, {PAR_N} tracks ({PAR_LOCAL} a rank) x {T_FRAMES} "
            f"frames, iters=6: {[round(f['seconds'], 3) for f in fa]} s a forward by rank, "
            f"part {fa[0]['part_s']:.1f} s; launches per rank {want} ({PAR_LABEL}; {smi})")
        par_close("(a) vs the same route on one rank (NCCL)", fa[0]["out"], f1["out"],
                  SAME_ROUTE_TOL)
        par_close("(a) vs the unsharded forward (K3)", fa[0]["out"], fa[0]["unsharded"], FAST_TOL)
        metrics["a_forward_s"] = [f["seconds"] for f in fa]
        metrics["a_part_s"] = fa[0]["part_s"]
        for shape in ((1, 2), (2, 1)):
            key = f"train_{shape}"
            metrics[key] = par_check_train(f"(b) training step on a {shape} mesh",
                                           [r[key] for r in ranks])
        log(f"  (b) ({PAR_LABEL}; {smi})")
        pl = [r["pipeline"] for r in ranks]
        B, T, N, S = PAR_PIPE
        for r, p in enumerate(pl):
            par_check_counts(f"(c) stage {r}", p["counts"], par_expected(N, S, p["windows_run"]))
        log(f"  (c) window pipeline, 2 stages, {B} videos x {T} frames, {N} tracks, window {S}, "
            f"iters=6: {pl[0]['seconds']:.3f} s (forward_windows on one rank "
            f"{pl[0]['ref_seconds']:.3f} s); windows run by stage "
            f"{[p['windows_run'] for p in pl]} ({PAR_LABEL}; {smi})")
        par_close("(c) pipeline vs forward_windows", pl[0]["out"], pl[0]["ref"], FAST_TOL)
        if not all(torch.equal(a, b) for a, b in zip(pl[0]["out"], pl[1]["out"])):
            raise AssertionError("(c) the stages returned different results")
        metrics["c_pipeline_s"], metrics["c_ref_s"] = pl[0]["seconds"], pl[0]["ref_seconds"]
        st = [r["stream"] for r in ranks]
        want = par_expected(PAR_LOCAL, T_STREAM, k3=False)
        for r, s in enumerate(st):
            par_check_counts(f"(d) rank {r} window 3", s["sharded_counts"], want)
        t1, v1 = st[0]["sharded"]
        t0_, v0 = st[0]["ref"]
        err = (t1 - t0_).norm(dim=-1).flatten()
        agree = (v1 == v0).float().mean().item()
        log(f"  (d) streaming, mesh (1, 2), {PAR_GRID**2} points: seconds a window "
            f"{[round(x, 3) for x in st[0]['sharded_seconds']]} (unsharded "
            f"{[round(x, 3) for x in st[0]['ref_seconds']]}); tracks vs the unsharded stream "
            f"median {err.median().item():.3e} px, max {err.max().item():.3e} px (bounds "
            f"{FAST_TOL[:2]}), visibility agreement {agree:.4f} (bound 0.99); launches a "
            f"window per rank {want} ({PAR_LABEL}; {smi})")
        if not (err.median().item() <= FAST_TOL[0] and err.max().item() <= FAST_TOL[1]
                and agree >= 0.99 and torch.equal(st[1]["sharded"][0], t1)):
            raise AssertionError("(d) the sharded stream differs from the unsharded one")
        metrics["d_window_s"] = st[0]["sharded_seconds"]
        for r in ranks:
            for part in ("forward", "train_(1, 2)", "train_(2, 1)", "pipeline"):
                add(r[part]["counts"] if part[:5] != "train" else
                    {k: sum(c[k] for c in r[part]["counts"]) for k in WRAPPERS})
            add(r["stream"]["sharded_counts"])

        log(f"  (e) trainer --distributed, two gloo ranks, the Kubric tree of phase 21, "
            f"{TRAIN_TRACKS} tracks, the offline model, augmentations off:")
        tree = os.path.join(root, "movi_f")
        write_kubric_tree(tree)
        exp = os.path.join(root, "exp")
        argv = ["--distributed", "--dist_backend", "gloo", "--dataset_root", tree,
                "--exp_dir", exp, "--traj_per_sample", str(TRAIN_TRACKS), "--save_every_n_steps",
                "1", "--num_loader_workers", "1", "--dataset_repeats", "1", "--use_augs"]
        runs = []
        for steps in (2, 3):
            tr, secs = run_ranks(root, "trainer", 2, argv + ["--num_steps", str(steps)])
            runs.append((tr, secs))
            if tr[1]["written"] or not tr[0]["written"]:
                raise AssertionError(f"(e) rank 1 wrote {tr[1]['written']}")
            if tr[0]["digest"] != tr[1]["digest"]:
                raise AssertionError("(e) the ranks' parameters differ")
            for r in tr:
                add(r["counts"])
        with open(os.path.join(exp, "train_log.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
        ckpts = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        k4r = [r["counts"]["K4r_corr_volume_raw"] for tr, _ in runs for r in tr]
        log(f"    exit 0 twice; steps logged {logged} (the second run resumed at 2); "
            f"checkpoints {ckpts}; only rank 0 wrote; parameters equal; K4r by run and rank "
            f"{k4r} (32 a step: one 24-frame window, 4 levels x 4 iterations x 2); jobs "
            f"{[round(s, 1) for _, s in runs]} s ({PAR_LABEL}; {smi})")
        if logged != [0, 1, 2] or k4r != [64, 64, 32, 32]:
            raise AssertionError("(e) the distributed trainer did not resume as expected")
        metrics["e_jobs_s"] = [s for _, s in runs]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    return total, metrics


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
    log("the inference surface's kernels vs plain versions (bf16) at the shapes of phases 16-19 "
        "and of phase 24's fast teacher:")
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
    log("legacy CoTracker2 family (v2 / v2.1), plain PyTorch, no kernel on its path:")
    v2_counts, v2 = v2_phase(dev, smi)
    torch.cuda.empty_cache()
    log(f"distillation: distill_trainer.main, {TRAIN_RES[0]}x{TRAIN_RES[1]}, {DISTILL_T} frames, "
        f"{DISTILL_Q} queries, the v2.1, v3 online and v3 offline teachers:")
    k4r_row = next(k for k in train_kernels if k["name"] == "K4r_corr_volume_raw")
    with signals_restored():
        distill_counts, distill_k4r, distill = distill_phase(dev, smi, k4r_row)
    torch.cuda.empty_cache()
    log("parallelism over torch.distributed: NCCL with one rank, then two gloo ranks on one "
        "card (track-sharded forward, training steps, window pipeline, streaming, the "
        "distributed trainer):")
    par_counts, par = parallel_phase(dev, smi)
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
        if k["name"] == "K4r_corr_volume_raw":
            k["launches_per_distill_step"] = distill_k4r
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
        k["launches_v2_phase"] = v2_counts[k["name"]]
        k["launches_distill_phase"] = distill_counts[k["name"]]
        k["launches_parallel_phase"] = par_counts[k["name"]]
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
    for name, r in v2["offline"].items():
        log(f"{name} offline ({V2_GRID**2} points x {V2_T} frames, {r['windows']} windows of "
            f"{r['window_len']}): {r['median_s']:.3f} s, {r['points_frames_per_s']:.0f} "
            f"points*frames/s, peak memory {r['peak_gib']:.2f} GiB, bf16 vs f32 median "
            f"{r['bf16_vs_f32_px'][0]:.3e} px ({smi})")
    st = v2["streaming"]
    log(f"v2.1 streaming ({st['queries']} queries, {st['windows']} windows of 16): "
        f"{st['steady_s']:.4f} s per steady window, peak memory {st['peak_gib']:.2f} GiB; "
        f"v2 phase {v2['phase_s']:.1f} s ({smi})")
    th = distill["teachers"]
    log(f"distillation ({DISTILL_Q} queries x {DISTILL_T} frames, {TRAIN_RES[0]}x{TRAIN_RES[1]}, "
        f"iters={TRAIN_ITERS}): ms per offline student step "
        f"{[round(m, 1) for m in distill['ms_per_offline_step']]}, online (windows of 16) "
        f"{distill['ms_online_step']:.1f}; a teacher's second call: v2.1 {th['v21'][1][0]:.3f} s, "
        f"v3 online {th['v3_online'][1][0]:.3f} s, v3 offline {th['v3_offline'][1][0]:.3f} s, "
        f"fast {th['v3_offline_fast'][1][0]:.3f} s; host query sampling "
        f"{[round(x, 3) for x in distill['queries_s']]} s a step; peak memory by run "
        f"{({k: round(v, 2) for k, v in distill['peak_gib'].items()})} GiB; phase "
        f"{distill['phase_s']:.1f} s ({smi})")
    log(f"parallelism ({PAR_LABEL}): NCCL world-1 forward {par['world1_forward_s']:.3f} s; "
        f"(a) {PAR_N} tracks x {T_FRAMES} frames over two ranks "
        f"{[round(x, 3) for x in par['a_forward_s']]} s a forward; (b) training step "
        f"(1, 2) {[round(x, 3) for x in par['train_(1, 2)']['step_s']]} s, (2, 1) "
        f"{[round(x, 3) for x in par['train_(2, 1)']['step_s']]} s; (c) pipeline "
        f"{par['c_pipeline_s']:.3f} s against forward_windows' {par['c_ref_s']:.3f} s; (d) "
        f"stream {[round(x, 3) for x in par['d_window_s']]} s a window; (e) trainer jobs "
        f"{[round(x, 1) for x in par['e_jobs_s']]} s; phase {par['phase_s']:.1f} s ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
