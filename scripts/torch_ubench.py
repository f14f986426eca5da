"""Micro-benchmarks of the PyTorch/CUDA port (the counterpart of
scripts/ubench.py, with its section names and shapes).

    python3 scripts/torch_ubench.py [section ...] [--device cuda|cpu]

Sections: peak, mlp, int8, int8mlp, int8pallas, stream, corr, uf (default:
all but int8mlp and int8pallas, as scripts/ubench.py). Each op is timed
with CUDA events over `reps` launches after a warm-up, with no host
synchronisation inside the timed loop. `int8pallas` runs K12 (LN + W8A8
MLP) and K10 (LN + W8A8 to_qkv, 384 -> 1,152) at 604,800 bf16 rows;
`corr` runs K4 (+ the int8 MLP1 product) and K4m at the quasi-dense chunk
(2,048 points x 16 frames) at levels 0 and 3; `uf` runs the update
transformer with the kernel variants off and all on, at the bench shape
(10,240 tracks x 60 frames) and the quasi-dense window (70,656 x 16).

It runs on the GPU and raises without one; `--device cpu` runs every
section at small shapes through the plain PyTorch versions, as a smoke
test of the script only (its times are the CPU's). Each section prints
one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from cotracker_tpu_torch import resolve_device  # noqa: E402
from cotracker_tpu_torch.ops.kernels import corr_cuda, mlp_int8_cuda  # noqa: E402
from cotracker_tpu_torch.ops.kernels.variants import KernelVariants  # noqa: E402

SECTIONS = ("peak", "mlp", "int8", "int8mlp", "int8pallas", "stream", "corr", "uf")
DEFAULT = ("peak", "mlp", "int8", "stream", "corr", "uf")


class Bench:
    """Shapes and a timer for one device: the scripts/ubench.py shapes on
    the card, small ones on the CPU."""

    def __init__(self, device: torch.device, reps: int = 8):
        self.dev = device
        self.cuda = device.type == "cuda"
        self.reps = reps
        self.g = torch.Generator().manual_seed(0)
        self.M = 604_800 if self.cuda else 2_048  # MLP rows: 10,080 tracks x 60 frames
        self.n_peak = 4096 if self.cuda else 256
        self.stream_n = 256 * 1024 * 1024 // 4 if self.cuda else 1 << 20

    def randn(self, *shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(*shape, generator=self.g)).to(self.dev, dtype)

    def ms(self, fn, reps=None):
        """Mean ms per call of fn(), after one warm-up call."""
        reps = reps or self.reps
        fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize(self.dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(self.dev)
        return start.elapsed_time(end) / reps

    def qlin(self, out, inp, scale=0.05):
        w = self.randn(out, inp, scale=scale)
        return mlp_int8_cuda.quantize_linear(w, torch.zeros(out, device=self.dev))


def emit(section, **values):
    print(json.dumps({"section": section, **values}), flush=True)
    return values


def sec_peak(b: Bench):
    n = b.n_peak
    x, y = b.randn(n, n, dtype=torch.bfloat16), b.randn(n, n, dtype=torch.bfloat16)
    t = b.ms(lambda: x @ y, reps=16)
    return emit("peak", what=f"bf16 matmul {n}^3", ms=t, tflops=2 * n**3 / t / 1e9)


def sec_mlp(b: Bench):
    M, K, N = b.M, 384, 1536
    x = b.randn(M, K, dtype=torch.bfloat16)
    w1, w2 = b.randn(K, N, dtype=torch.bfloat16), b.randn(N, K, dtype=torch.bfloat16)
    t1 = b.ms(lambda: x @ w1)
    t2 = b.ms(lambda: F.gelu(x @ w1, approximate="tanh") @ w2)
    return emit("mlp", rows=M, fc1_ms=t1, fc1_tflops=2 * M * K * N / t1 / 1e9, pair_gelu_ms=t2,
                pair_tflops=4 * M * K * N / t2 / 1e9)


def sec_int8(b: Bench):
    """Raw s8 x s8 -> s32 throughput (torch._int_mm) and the W8A8 step with
    a dynamic per-tensor activation quantization, in plain PyTorch."""
    M, K, N = b.M, 384, 1536
    x8 = torch.randint(-127, 128, (M, K), generator=b.g, dtype=torch.int8).to(b.dev)
    w8 = torch.randint(-127, 128, (N, K), generator=b.g, dtype=torch.int8).to(b.dev)
    xf = b.randn(M, K, dtype=torch.bfloat16)
    t = b.ms(lambda: torch._int_mm(x8, w8.t()))

    def w8a8():
        x32 = xf.float()
        s = x32.abs().amax().clamp_min(1e-20) / 127.0
        xq = torch.round(x32 / s).clamp(-127, 127).to(torch.int8)
        return (torch._int_mm(xq, w8.t()).float() * s).to(torch.bfloat16)

    t2 = b.ms(w8a8)
    return emit("int8", rows=M, raw_s8_ms=t, raw_tops=2 * M * K * N / t / 1e9, w8a8_ms=t2,
                w8a8_tops_equiv=2 * M * K * N / t2 / 1e9)


def sec_int8mlp(b: Bench):
    """The LN + MLP block in bf16 against W8A8 with per-row activation
    scales, both in plain PyTorch."""
    M, K, N = b.M, 384, 1536
    x = b.randn(M, K, dtype=torch.bfloat16)
    w1f, w2f = b.randn(N, K, scale=0.05), b.randn(K, N, scale=0.05)
    fc1, fc2 = (mlp_int8_cuda.quantize_linear(w, torch.zeros(w.shape[0], device=b.dev))
                for w in (w1f, w2f))
    w1b, w2b = w1f.to(torch.bfloat16), w2f.to(torch.bfloat16)

    def bf16_block():
        h = mlp_int8_cuda.ln_rows(x.float(), 1e-6).to(torch.bfloat16)
        return F.gelu(h @ w1b.t(), approximate="tanh") @ w2b.t()

    t = b.ms(bf16_block)
    t2 = b.ms(lambda: mlp_int8_cuda.ln_mlp_plain(x, fc1, fc2))
    return emit("int8mlp", rows=M, bf16_block_ms=t, w8a8_plain_ms=t2,
                tflops_bf16=4 * M * K * N / t / 1e9)


def sec_int8pallas(b: Bench):
    """K12 (LN + W8A8 MLP, one launch) and K10 (LN + W8A8 to_qkv) at the
    ubench rows, bf16, against their plain versions."""
    M, K, N = b.M, 384, 1536
    x = b.randn(M, K, dtype=torch.bfloat16)
    fc1, fc2 = b.qlin(N, K), b.qlin(K, N)
    qkv = b.qlin(3 * K, K)
    t12 = b.ms(lambda: mlp_int8_cuda.fused_ln_mlp_int8(x, fc1, fc2))
    t10 = b.ms(lambda: mlp_int8_cuda.fused_ln_dense_int8(x, qkv, ln=True))
    p12 = b.ms(lambda: mlp_int8_cuda.ln_mlp_plain(x, fc1, fc2), reps=2)
    p10 = b.ms(lambda: mlp_int8_cuda.ln_dense_plain(x, qkv, ln=True), reps=2)
    return emit("int8pallas", rows=M, k12_ms=t12, k12_tops_equiv=4 * M * K * N / t12 / 1e9,
                k12_plain_ms=p12, k10_ms=t10, k10_tops_equiv=2 * M * K * 3 * K / t10 / 1e9,
                k10_plain_ms=p10)


def sec_stream(b: Bench):
    n = b.stream_n
    x = b.randn(n)
    t = b.ms(lambda: x * 1.0000001, reps=16)
    return emit("stream", mbytes=n * 4 / 2**20, ms=t, gbps=2 * n * 4 / t / 1e6)


def corr_chunk_operands(b: Bench, T, n, hw):
    """One level's K4 / K4m operands at n points x T frames: unit-norm bf16
    map and support, random coordinates, the corr MLP1 weights."""
    Hh, W = hw
    fm = F.normalize(b.randn(1, T, Hh, W, 128), dim=-1).to(torch.bfloat16)
    sup = F.normalize(b.randn(1, 49, n, 128), dim=-1).to(torch.bfloat16)
    supq, sup_scale = corr_cuda.quantize_support(sup, torch.bfloat16)
    coords = (torch.rand(1, T, n, 2, generator=b.g) * torch.tensor([W, Hh])).to(b.dev)
    w1 = b.randn(2401, 384, scale=0.02)
    b1 = b.randn(384, scale=0.1)
    return dict(fmq=corr_cuda.build_int8_level(fm, 3), supq=supq, sup_scale=sup_scale,
                coords=coords.to(torch.bfloat16), w1=w1, b1=b1, hw=hw)


def sec_corr(b: Bench):
    """K4 + the int8 MLP1 product against K4m, one level-chunk of the
    quasi-dense window (2,048 points x 16 frames), GELU included on both."""
    T, n = 16, (2048 if b.cuda else 64)
    out = {}
    for lvl in (0, 3):
        hw = (96 >> lvl, 128 >> lvl) if b.cuda else (24 >> lvl, 32 >> lvl)
        o = corr_chunk_operands(b, T, n, hw)
        w1q, w1amax = corr_cuda.quantize_w1(o["w1"], torch.bfloat16)
        w1m = corr_cuda.quantize_w1_mlp1(o["w1"])

        def hidden(mlp1):
            return corr_cuda.corr_hidden(o["fmq"], o["supq"], o["sup_scale"], o["coords"], w1q,
                                         w1amax, o["b1"], *hw, 3, torch.bfloat16,
                                         w1m if mlp1 else None)

        out[f"level{lvl}"] = dict(hw=list(hw), k4_ms=b.ms(lambda: hidden(False)),
                                  k4m_ms=b.ms(lambda: hidden(True)))
    return emit("corr", points=n, frames=T, **out)


def sec_uf(b: Bench):
    """One update-transformer call (3 time blocks, 3 space rounds, bf16,
    W8A8 kernels), the variants off and all on."""
    from cotracker_tpu_torch.models.updateformer import EfficientUpdateFormer

    shapes = [(10_240, 60), (70_656, 16)] if b.cuda else [(256, 16)]
    out = {}
    torch.manual_seed(0)
    for name, v in (("off", KernelVariants()), ("all", KernelVariants(True, True, True, True))):
        uf = EfficientUpdateFormer(dtype=torch.bfloat16, attn_kernels=True, quant_int8=True,
                                   variants=v).to(b.dev).eval()
        packs = uf.quantize()
        for N, T in shapes:
            x = b.randn(1, N, T, 384, dtype=torch.bfloat16)
            with torch.inference_mode():
                t = b.ms(lambda: uf(x, x_is_tokens=True, packs=packs), reps=3)
            out[f"{name}_n{N}_t{T}_ms"] = t
            del x
    return emit("uf", **out)


FNS = {"peak": sec_peak, "mlp": sec_mlp, "int8": sec_int8, "int8mlp": sec_int8mlp,
       "int8pallas": sec_int8pallas, "stream": sec_stream, "corr": sec_corr, "uf": sec_uf}


def run(sections, device="cuda", reps=8):
    """Run the named sections on `device` (CUDA by default; raises without
    it). Returns {section: values}."""
    dev = resolve_device(device)
    for s in sections:
        if s not in FNS:
            raise ValueError(f"unknown section {s!r}; choose from {SECTIONS}")
    b = Bench(dev, reps)
    if b.cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({"device": torch.cuda.get_device_name(dev),
                          "nvidia_smi": smi.stdout.strip()}), flush=True)
    else:
        print(json.dumps({"device": "cpu (smoke run: CPU times, not a device metric)"}))
    return {s: FNS[s](b) for s in sections}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", default=list(DEFAULT), help=f"of {SECTIONS}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    run(args.sections, args.device, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
