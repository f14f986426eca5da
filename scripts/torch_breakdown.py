"""Device-time breakdown of the PyTorch/CUDA port on the GPU.

    python3 scripts/torch_breakdown.py [--frames 60]
    python3 scripts/torch_breakdown.py --online

Profiles (torch.profiler, CUDA activity) one call of each kernel wrapper
K1-K4 at the bench shape (10,240 tracks x 60 frames, bf16; K4 at level 0,
one 2,048-point chunk) and one forward of CoTrackerPredictor(fast=True) on
a synthetic 384x512 video with a 100x100 query grid, and prints the device
time by kernel name, the forward's wall time and its device-busy share.
Writes the same as JSON to chiprun_out/torch_breakdown.json.

With --online it profiles instead one steady-state streaming window (16
frames at step 8, 10,000 grid points, 384x512, iters=6; the fourth window of
a stream) in each kernel configuration: (a) CoTrackerOnlinePredictor(fast=True)
with K1-K4, and (b) the same weights with the W8A8 block kernels off and the
attention-core kernels K5-K7 on, driven through online_step; device time is
also summed by group (the hand-written kernels by name, library GEMMs,
convolutions, everything else), and the window's feature stage (fnet on the
8 new frames plus the pyramid) is profiled on its own. Writes chiprun_out/torch_breakdown_online.json.
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
    ("K1-K3 s8 GEMM (gemm_s8_kernel)", ("gemm_s8_kernel",)),
    ("K1-K3 LN + row quant (ln_quant_kernel)", ("ln_quant_kernel",)),
    ("K4 corr_volume_kernel", ("corr_volume_kernel",)),
    ("time core (K1 stage / K5) time_attention_kernel", ("time_attention_kernel",)),
    ("points<-virtual core (K2 stage / K6) p2v_attention_kernel", ("p2v_attention_kernel",)),
    ("virtual<-points core (K3 stage / K7) v2p_flash_kernel", ("v2p_flash_kernel",)),
    ("convolutions (fnet)", ("conv", "cudnn", "fprop", "implicit_gemm", "nchw", "nhwc")),
    ("library GEMMs (cuBLAS / CUTLASS)", ("gemm", "cutlass", "cublas", "xmma", "gemv", "nvjet")),
)


def group_table(prof):
    """Device ms by group of GROUPS; what matches none is 'other'."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t <= 0 or e.device_type.name != "CUDA":
            continue
        key = e.key.lower()
        name = next((g for g, pats in GROUPS if any(p in key for p in pats)),
                    "other (elementwise, reductions, copies, gathers)")
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + t / 1e3, n + e.count)
    return sorted(out.items(), key=lambda kv: -kv[1][0])


def run(name, fn, warm=True, groups=False):
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows, busy = device_table(prof)
    print(f"\n{name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%)", flush=True)
    for key, ms, n in rows:
        print(f"  {ms:9.3f} ms  x{n:<5d} {key[:110]}")
    res = dict(name=name, wall_ms=wall, device_ms=busy,
               kernels=[dict(name=k, ms=m, count=n) for k, m, n in rows])
    if groups:
        print("  by group:")
        res["groups"] = []
        for g, (ms, n) in group_table(prof):
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--online", action="store_true",
                    help="profile one steady streaming window in each kernel configuration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _build.build_all()
    if args.online:
        return online(dev, smi)
    g = torch.Generator().manual_seed(0)
    C, HID, H, D = chip_smoke.C, chip_smoke.HID, chip_smoke.HEADS, chip_smoke.DH
    lin = lambda o, i: chip_smoke.lin(g, o, i, dev)
    x = torch.randn(chip_smoke.N_TRACKS, args.frames, C, generator=g).to(dev, torch.bfloat16)
    tw = mlp_int8_cuda.TimeBlockWeights(lin(3 * C, C), lin(C, C), lin(HID, C), lin(C, HID))
    sw = mlp_int8_cuda.SpaceBlockWeights(lin(C, C), lin(C, C), lin(HID, C), lin(C, HID))
    kv = torch.randn(args.frames, 64, 2 * C, generator=g).to(dev, torch.bfloat16)
    q = torch.randn(args.frames, 64, C, generator=g).to(dev, torch.bfloat16)
    ones, zeros = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    kbias = torch.zeros(chip_smoke.N_TRACKS, device=dev)
    out = [
        run("K1 time block", lambda: mlp_int8_cuda.fused_time_block_int8(x, tw, H, D)),
        run("K2 space block", lambda: mlp_int8_cuda.fused_space_block_int8(x, kv, sw, H, D)),
        run("K3 virtual<-points", lambda: attention_cuda.fused_virtual_from_points_proj(
            q, x, lin(2 * C, C), ones, zeros, H, D, kbias)),
    ]
    del x
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
    out.append(run("predictor forward (fast, N=10000)", lambda: pred(video, grid_size=100)))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_breakdown.json", "w") as f:
        json.dump({"device": smi, "frames": args.frames, "runs": out}, f, indent=1)


if __name__ == "__main__":
    main()
