"""Where K8's time goes on the card: copies of csrc/int8_time_block.cu built
with one part of the streamed K8 body's work taken out, timed beside the
kernel itself and its PR 4 body on the same inputs (the outputs of the
copies that drop work are wrong by design; only their times mean
anything).

    python3 scripts/torch_k8_parts.py

Parts: the products' tensor-core instructions (`no_mma`: the weight stream
kept), the LayerNorm and row quantization of the x rows (`no_ln`: the rows
still arrive, their codes are whatever the buffer holds), the stores of q
and kv (`no_store`), and plain stores in place of the streaming
(evict-first) ones (`plain_store`, exact). Each copy is built into
build/k8_parts/ with the flags of ops/kernels/_build.py, all nvcc processes
at once, and bound through ctypes like the kernel's own entry. One JSON
line per shape (the long forward's point tokens, 2,048 and 2,560 tracks x
250 frames, and its virtual tokens, 64 x 250). Needs a CUDA card; bf16,
random operands from seed 0.
"""

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cotracker_tpu_torch.ops.kernels import _build, mlp_int8_cuda  # noqa: E402

C = 384
SHAPES = ((2048, 250), (2560, 250), (64, 250))
OUT = _build.BUILD_DIR.parent / "k8_parts"
MMA = ("      warp_mma<MI, NI, BK, LDB>(acc, a_base + kt * BK, lda, ring + slot * K1T_SLOT, b_off, 0);\n",
       "      acc[0][0][0] += ring[slot * K1T_SLOT + lane];\n")
LN = ("          sc = ln_quant_row<bf16, VPL, kBf16Ln>(xw + ((r / LN_WARPS) % K8_XBUF) * KC, lane, nullptr,\n"
      "                                                nullptr, eps, 1, Ab + r * LDA_C);\n",
      "          sc = 1.f;\n")
STORE = ("            __stcs(reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * ld + c0 + wn * 32 +\n"
         "                                            8 * t),\n"
         "                   val);\n")
VARIANTS = {
    "kernel": (),
    "no_mma": (MMA,),
    "no_ln": (LN,),
    "no_store": ((STORE, "            if (val.x == 0x7f7f1234u) *reinterpret_cast<uint4*>(dst) = val;\n"),),
    "plain_store": ((STORE, STORE.replace("__stcs(", "*").replace("),\n                   val);",
                                                                  ") = val;")),),
}


def sources():
    """Writes the headers and one copy of int8_time_block.cu per variant."""
    OUT.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, OUT / f.name)
    src = (_build.CSRC / "int8_time_block.cu").read_text()
    paths = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"int8_time_block.cu: the part {name} is not where this probe "
                                   "expects it")
            text = text.replace(old, new)
        paths[name] = OUT / f"k8_{name}.cu"
        paths[name].write_text(text)
    return paths


def build(paths):
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                  str(p.with_suffix(".so")), str(p)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, p in paths.items()}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"k8_{name}.cu did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(paths[name].with_suffix(".so")))
        fns[name] = _build.bind(lib, "ct_k8_stream", P, I, I, P, P, P, F, I, I, P, P, P)
    return fns


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


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_k8_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    shutil.rmtree(OUT, ignore_errors=True)
    fns = build(sources())
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    qkv = mlp_int8_cuda.quantize_linear(
        (torch.randn(3 * C, C, generator=g) / math.sqrt(C)).to(dev),
        (0.05 * torch.randn(3 * C, generator=g)).to(dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for N, T in SHAPES:
        rows = N * T
        x = torch.randn(rows, C, generator=g).to(dev, bf)
        plan = mlp_int8_cuda.k8_plan(rows, bf, sms=sms)
        fq, fkv = mlp_int8_cuda._ln_qkv_tile(x, qkv, 1e-6, False)
        ms, exact = {"pr4_body": time_ms(lambda: mlp_int8_cuda._ln_qkv_tile(x, qkv, 1e-6, False))}, {}
        for name, fn in fns.items():
            q, kv = torch.empty_like(fq), torch.empty_like(fkv)
            args = (x.data_ptr(), rows, C, qkv.w.data_ptr(), qkv.s.data_ptr(), qkv.b.data_ptr(),
                    1e-6, 0, plan.blocks, q.data_ptr(), kv.data_ptr())
            ms[name] = time_ms(lambda: _build.check(
                fn(*args, torch.cuda.current_stream().cuda_stream), f"k8_{name}"))
            if name in ("kernel", "plain_store"):
                exact[name] = bool(torch.equal(q, fq) and torch.equal(kv, fkv))
        print(json.dumps(dict(nvidia_smi=smi, tracks=N, frames=T, blocks=plan.blocks,
                              ms={k: round(v, 4) for k, v in ms.items()},
                              bit_identical_to_pr4_body=exact)), flush=True)
        del x, fq, fkv


if __name__ == "__main__":
    main()
