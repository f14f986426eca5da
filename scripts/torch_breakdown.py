"""Device-time breakdown of the PyTorch/CUDA port on the GPU.

    python3 scripts/torch_breakdown.py [--frames 60] [--grid 100]
    python3 scripts/torch_breakdown.py --frames 250 --grid 50
    python3 scripts/torch_breakdown.py --online
    python3 scripts/torch_breakdown.py --quasi-dense
    python3 scripts/torch_breakdown.py --train
    python3 scripts/torch_breakdown.py --v2

Profiles (torch.profiler, CUDA activity) one call of each kernel wrapper
K1-K5, K8 and K9 at the forward's token shape (the grid's points padded to
512, x --frames; by default the bench shape, 10,240 tracks x 60 frames,
bf16; K4 at level 0, one 2,048-point chunk) and one forward of
CoTrackerPredictor(fast=True) on a synthetic 384x512 video with a
--grid x --grid query grid, and prints the device time by kernel name and by
group, the forward's wall time and its device-busy share. Videos over 128
frames run the time blocks through the split K8 -> K5 -> K9. Writes the same
as JSON to torch_breakdown.json in the output directory chip_smoke.py uses.

With --online it profiles instead one steady-state streaming window (16
frames at step 8, 10,000 grid points, 384x512, iters=6; the fourth window of
a stream) in each kernel configuration: (a) CoTrackerOnlinePredictor(fast=True)
with K1-K4, and (b) the same weights with the W8A8 block kernels off and the
attention-core kernels K5-K7 on, driven through online_step; device time is
also summed by group (the hand-written kernels by name, library GEMMs,
convolutions, everything else), and the window's feature stage (fnet on the
8 new frames plus the pyramid) is profiled on its own. Writes chiprun_out/torch_breakdown_online.json.

With --quasi-dense it profiles one steady window (the fourth) of
quasi-dense streaming, CoTrackerOnlinePredictor(fast=True) with a 265x265
grid (70,225 points, 70,656 padded), 384x512, iters=6, (a) with the kernel
variants off and (c) with all four on (K4m, K11, bf16 LayerNorm,
GELU-quant fold), by kernel and by group. Writes
chiprun_out/torch_breakdown_quasi_dense.json.

With --train it profiles one steady online training step (the third) at
the reference training shape: 384x512, a 24-frame clip in two windows of
16, 768 tracks, iters=4, f32, K4r with the autograd wrapper and remat,
AdamW; the clip is chip_smoke's moving texture. Device time by group (K4r,
the plain backward's gathers and scatters, library GEMMs, convolutions,
the optimizer, everything else) and device busy against wall. Writes
chiprun_out/torch_breakdown_train.json.

With --v2 it profiles the legacy CoTracker2 family, which runs no kernel of
the port: one forward of CoTrackerPredictor(v2=True, fast=True) for v2
(window 8) and v2.1 (window 16) at chip_smoke's phase 23 (a) shape (2,500
grid points, 60 frames, 384x512, iters=6), and one steady window (the
fourth) of its (b) stream (CoTrackerOnlinePredictor(v2=True, window_len=16,
fast=True), 409 queries), both with phase 23's damped random weights; device
time by kernel and by group, wall and device-busy share, and the number of
device kernels a call launches. Builds no kernel. Writes
chiprun_out/torch_breakdown_v2.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, corr_cuda, mlp_int8_cuda  # noqa: E402
from cotracker_tpu_torch.predictor import CoTrackerPredictor  # noqa: E402


def device_table(prof, top=12):
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t > 0 and e.device_type.name == "CUDA":
            rows.append((e.key, t / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows[:top], sum(r[1] for r in rows)


GROUPS = (  # first match wins, on the device kernel's name
    ("K4m corr_mlp1_kernel", ("corr_mlp1_kernel",)),
    ("K11 front (bf16) k11_front_kernel", ("k11_front_kernel",)),
    ("K8 ln_qkv_kernel", ("ln_qkv_kernel",)),
    ("K9 k9_tail_kernel (f32: attnout_mlp_kernel)", ("k9_tail_kernel", "attnout_mlp_kernel")),
    ("K1 front (bf16) k1_front_kernel", ("k1_front_kernel",)),
    ("K1 tail (bf16; also K2's and K11's second launch) k1_tail_kernel", ("k1_tail_kernel",)),
    ("K1-K3 s8 GEMM (gemm_s8_kernel)", ("gemm_s8_kernel",)),
    ("K1-K3 LN + row quant (ln_quant_kernel)", ("ln_quant_kernel",)),
    ("K4 corr_volume_kernel", ("corr_volume_kernel",)),
    ("time core (K5; K1's f32 chain) time_tc_kernel (f32: time_attention_kernel)",
     ("time_tc_kernel", "time_attention_kernel", "time_attention_long")),
    ("points<-virtual core (K2 stage / K6) p2v_tc_kernel (f32: p2v_attention_kernel)",
     ("p2v_tc_kernel", "p2v_attention_kernel")),
    ("virtual<-points core (K3 stage / K7) v2p_tc_kernel + merge (f32: v2p_flash_kernel)",
     ("v2p_tc_kernel", "v2p_merge_kernel", "v2p_flash_kernel")),
    ("convolutions (fnet)", ("conv", "cudnn", "fprop", "implicit_gemm", "nchw", "nhwc")),
    ("library GEMMs (cuBLAS / CUTLASS)", ("gemm", "cutlass", "cublas", "xmma", "gemv", "nvjet")),
)


TRAIN_GROUPS = (
    ("K4r k4r_volume_kernel (K4's cluster kernel in its K4r mode)", ("k4r_volume_kernel",)),
    ("K4f k4f_volume_kernel", ("k4f_volume_kernel",)),
    ("gathers and scatters (window gathers, their backward)", ("index", "gather", "scatter")),
    ("convolutions (fnet, forward and backward)",
     ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm", "nchw", "nhwc")),
    ("library GEMMs (cuBLAS / CUTLASS)", ("gemm", "cutlass", "cublas", "xmma", "gemv", "nvjet")),
    ("optimizer (multi-tensor AdamW)", ("multi_tensor", "foreach")),
)


V2_GROUPS = (
    ("convolutions (fnet)", ("conv", "cudnn", "fprop", "implicit_gemm", "nchw", "nhwc")),
    ("library GEMMs (cuBLAS / CUTLASS)", ("gemm", "cutlass", "cublas", "xmma", "gemv", "nvjet")),
    ("gathers (bilinear taps, indexing)", ("index", "gather")),
    ("softmax", ("softmax",)),
    ("reductions (norms, means)", ("reduce",)),
)


def group_table(prof, groups=GROUPS):
    """Device ms by group of `groups`; what matches none is 'other'."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t <= 0 or e.device_type.name != "CUDA":
            continue
        key = e.key.lower()
        name = next((g for g, pats in groups if any(p in key for p in pats)),
                    "other (elementwise, reductions, copies, gathers)")
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + t / 1e3, n + e.count)
    return sorted(out.items(), key=lambda kv: -kv[1][0])


def run(name, fn, warm=True, groups=False, group_spec=GROUPS):
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows, busy = device_table(prof)
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)))
    print(f"\n{name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {launches} device operations", flush=True)
    for key, ms, n in rows:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:110]}")
    res = dict(name=name, wall_ms=wall, device_ms=busy, device_operations=launches,
               kernels=[dict(name=k, ms=m, count=n) for k, m, n in rows])
    if groups:
        print("  by group:")
        res["groups"] = []
        for g, (ms, n) in group_table(prof, group_spec):
            print(f"  {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{n:<5d} {g}")
            res["groups"].append(dict(group=g, ms=ms, count=n))
    return res


def online(dev, smi):
    """One steady window of each streaming configuration (see the module
    docstring). The profiled window is not warmed by a repeat: the stream's
    first three windows are the warm-up."""
    from cotracker_tpu_torch import CoTrackerOnlinePredictor
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

    S, frames, grid = 16, 64, 100
    video = chip_smoke.synthetic_video(frames, 384, 512, dev)
    pred = CoTrackerOnlinePredictor(fast=True, device="cuda", capacity=frames)
    pred(video[:, :1], is_first_step=True, grid_size=grid)
    for ind in (0, 8, 16):
        pred(video[:, ind : ind + S])
    out = [run("streaming (a) window 4: predictor fast path, K1-K4",
               lambda: pred(video[:, 24 : 24 + S]), warm=False, groups=True)]

    model = CoTrackerThree(window_len=S, dtype=torch.bfloat16, corr_chunk=2048,
                           fold_input_proj=True, kernels=True, attn_quant_int8=False)
    model.load_state_dict(pred.model.state_dict())
    model = model.to(dev).eval()
    video_cl = video.permute(0, 1, 3, 4, 2)
    box = {"state": model.online_init(1, pred._queries.shape[1], frames)}

    def step(ind):
        with torch.inference_mode():
            box["state"], *_ = model.online_step(
                box["state"], video_cl[:, ind : ind + S], pred._queries, iters=6,
                track_mask=pred._track_mask)

    for ind in (0, 8, 16):
        step(ind)
    out.append(run("streaming (b) window 4: online_step, attention cores K5-K7 + K4",
                   lambda: step(24), warm=False, groups=True))
    # what a steady window spends on features: fnet on its 8 new frames
    # (convolutions, instance norms, resizes) plus the pyramid's pooling
    new = video_cl[:, 24 + S // 2 : 24 + S]

    def features():
        with torch.inference_mode():
            model.build_pyramid(torch.cat([box["state"].fmaps_tail, model.compute_fmaps(new)], 1))

    out.append(run("features of one window: fnet on 8 new frames + 4-level pyramid", features))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_breakdown_online.json", "w") as f:
        json.dump({"device": smi, "runs": out}, f, indent=1)


def quasi_dense(dev, smi):
    """One steady quasi-dense window in each variant setting (see the
    module docstring); the stream's first three windows are the warm-up."""
    from cotracker_tpu_torch import CoTrackerOnlinePredictor
    from cotracker_tpu_torch.ops.kernels.variants import KernelVariants

    S, frames, grid = 16, chip_smoke.QD_FRAMES, chip_smoke.QD_GRID
    video = chip_smoke.synthetic_video(frames, 384, 512, dev)
    out = []
    for name, variants in (("a", KernelVariants()), ("c", chip_smoke.ALL_ON)):
        pred = CoTrackerOnlinePredictor(fast=True, device="cuda", capacity=frames,
                                        variants=variants)
        pred(video[:, :1], is_first_step=True, grid_size=grid)
        for ind in (0, 8, 16):
            pred(video[:, ind : ind + S])
        out.append(run(f"quasi-dense ({name}) window 4: {grid * grid} points, {variants}",
                       lambda: pred(video[:, 24 : 24 + S]), warm=False, groups=True))
        del pred
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_breakdown_quasi_dense.json", "w") as f:
        json.dump({"device": smi, "runs": out}, f, indent=1)


def train(dev, smi):
    """One steady online training step (see the module docstring)."""
    from cotracker_tpu_torch.models.build import build_training_model
    from cotracker_tpu_torch.training.data_loader import collate_batch
    from cotracker_tpu_torch.training.train_step import TrainConfig, make_optimizer, train_step

    clip = chip_smoke.MovingClip(24, 384, 512, 768)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in collate_batch([clip.sample]).items()}
    model = build_training_model(offline=False, window_len=16, device="cuda")
    optimizer, scheduler = make_optimizer(model, num_steps=100)
    generator = torch.Generator().manual_seed(0)
    cfg = TrainConfig(iters=4, offline_model=False, sliding_window_len=16)

    def step():
        train_step(model, optimizer, scheduler, batch, generator, cfg)

    step()
    step()
    torch.cuda.reset_peak_memory_stats()
    out = [run("online training step 3: 384x512, 24 frames, 768 tracks, iters=4, K4r + remat",
               step, warm=False, groups=True, group_spec=TRAIN_GROUPS)]
    out[0]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak memory {out[0]['peak_memory_gib']:.2f} GiB")
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_breakdown_train.json", "w") as f:
        json.dump({"device": smi, "runs": out}, f, indent=1)


def v2(dev, smi):
    """The legacy model's forward and streaming window (see the module
    docstring)."""
    from cotracker_tpu_torch import CoTrackerOnlinePredictor

    video = chip_smoke.synthetic_video(chip_smoke.V2_T, 384, 512, dev)
    out = []
    for name, window in chip_smoke.V2_WINDOWS:
        pred = CoTrackerPredictor(window_len=window, fast=True, v2=True)
        chip_smoke.damp_v2(pred.model)
        out.append(run(f"{name} offline forward (window {window}, {chip_smoke.V2_GRID**2} "
                       f"points x {chip_smoke.V2_T} frames)",
                       lambda: pred(video, grid_size=chip_smoke.V2_GRID), groups=True,
                       group_spec=V2_GROUPS))
        del pred
        torch.cuda.empty_cache()
    S = 16
    video = chip_smoke.synthetic_video(chip_smoke.V2_STREAM_T, 384, 512, dev)
    pred = CoTrackerOnlinePredictor(window_len=S, capacity=chip_smoke.V2_STREAM_T, fast=True,
                                    v2=True)
    chip_smoke.damp_v2(pred.model)
    pred(video[:, :1], is_first_step=True, queries=chip_smoke.v2_stream_queries(dev))
    for ind in (0, 8, 16):
        pred(video[:, ind : ind + S])
    out.append(run("v2.1 streaming window 4 (409 queries, 512 padded)",
                   lambda: pred(video[:, 24 : 24 + S]), warm=False, groups=True,
                   group_spec=V2_GROUPS))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_breakdown_v2.json", "w") as f:
        json.dump({"device": smi, "runs": out}, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--grid", type=int, default=100, help="the forward's query grid size")
    ap.add_argument("--online", action="store_true",
                    help="profile one steady streaming window in each kernel configuration")
    ap.add_argument("--quasi-dense", action="store_true",
                    help="profile one steady quasi-dense window, variants off and on")
    ap.add_argument("--train", action="store_true",
                    help="profile one steady online training step at the reference shape")
    ap.add_argument("--v2", action="store_true",
                    help="profile the legacy CoTracker2 family's forward and streaming window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if args.v2:
        return v2(dev, smi)
    _build.build_all()
    if args.online:
        return online(dev, smi)
    if args.quasi_dense:
        return quasi_dense(dev, smi)
    if args.train:
        return train(dev, smi)
    g = torch.Generator().manual_seed(0)
    C, HID, H, D = chip_smoke.C, chip_smoke.HID, chip_smoke.HEADS, chip_smoke.DH
    lin = lambda o, i: chip_smoke.lin(g, o, i, dev)
    tracks = -(-args.grid**2 // 512) * 512  # the predictor's fast-path bucket
    x = torch.randn(tracks, args.frames, C, generator=g).to(dev, torch.bfloat16)
    tw = mlp_int8_cuda.TimeBlockWeights(lin(3 * C, C), lin(C, C), lin(HID, C), lin(C, HID))
    sw = mlp_int8_cuda.SpaceBlockWeights(lin(C, C), lin(C, C), lin(HID, C), lin(C, HID))
    kv = torch.randn(args.frames, 64, 2 * C, generator=g).to(dev, torch.bfloat16)
    q = torch.randn(args.frames, 64, C, generator=g).to(dev, torch.bfloat16)
    ones, zeros = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    kbias = torch.zeros(tracks, device=dev)
    q8, kv8 = mlp_int8_cuda.fused_ln_qkv_int8(x, tw.qkv)
    a5 = attention_cuda.fused_time_attention(q8, kv8, H, D)
    out = [
        run("K1 time block", lambda: mlp_int8_cuda.fused_time_block_int8(x, tw, H, D)),
        run("K8 LN + q|kv", lambda: mlp_int8_cuda.fused_ln_qkv_int8(x, tw.qkv)),
        run("K5 time attention core", lambda: attention_cuda.fused_time_attention(q8, kv8, H, D)),
        run("K9 out + MLP", lambda: mlp_int8_cuda.fused_attnout_res_mlp_int8(a5, x, tw)),
        run("K2 space block", lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, sw, H, D)),
        run("K3 virtual<-points", lambda: attention_cuda.fused_virtual_from_points_proj(
            q, x, lin(2 * C, C), ones, zeros, H, D, kbias)),
    ]
    del x, q8, kv8, a5
    Hh, W = chip_smoke.LVL0
    fm = torch.nn.functional.normalize(torch.randn(1, args.frames, Hh, W, 128, device=dev), dim=-1)
    fmq = corr_cuda.build_int8_level(fm, 3)
    supq = torch.randint(-127, 128, (chip_smoke.CHUNK, 49, 128), dtype=torch.int8, device=dev)
    coords = torch.rand(1, args.frames, chip_smoke.CHUNK, 2, device=dev) * torch.tensor(
        [W, Hh], device=dev)
    starts, wxy = corr_cuda.level_operands(coords, 1, args.frames, Hh, W, 3)
    out.append(run("K4 corr volume", lambda: corr_cuda.corr_volume_int8(fmq, supq, starts, wxy)))
    pred = CoTrackerPredictor(fast=True, device="cuda")
    video = chip_smoke.synthetic_video(args.frames, 384, 512, dev)
    out.append(run(f"predictor forward (fast, N={args.grid**2}, T={args.frames})",
                   lambda: pred(video, grid_size=args.grid), groups=True))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_breakdown.json", "w") as f:
        json.dump({"device": smi, "frames": args.frames, "grid": args.grid, "runs": out}, f,
                  indent=1)


if __name__ == "__main__":
    main()
