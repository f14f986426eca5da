"""Where K12's time goes on the card: copies of csrc/int8_mlp_cluster.cu
built with one part of the cluster body's work taken out, timed beside the
kernel itself and its first body on the same inputs (the outputs of the
copies that drop work are wrong by design; only their times mean
anything).

    python3 scripts/torch_k12_parts.py

Parts: the products' tensor-core instructions, fc1's and fc2's (`no_mma`:
the resident weights and the codes stay where they are); the exchange
through distributed shared memory (`no_exchange`: no LN codes written to
the peers, each block's row max its own, each peer's chunk of GELU codes
read from the block's own buffer; the cluster barriers kept); the
LayerNorm and row quantization (`no_ln`); the tanh-GELU of fc1's epilogue
(`no_gelu`); the cluster barriers inside the tile loop, replaced by block
barriers (`no_cluster_sync`: the blocks then read their peers' maxima and
codes unsynchronized, but every address stays valid, since the last
barrier before a block exits is kept); the output stores (`no_store`).
Each copy is built into build/k12_parts/ with the flags of
ops/kernels/_build.py, all nvcc processes at once, and bound through ctypes
like the kernel's own entry. One JSON line per row count (the
micro-benchmark's 604,800 rows, and 1,576). Needs a CUDA card; bf16,
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

C, HID = 384, 1536
ROWS = (604800, 1576)
OUT = _build.BUILD_DIR.parent / "k12_parts"
MMA = (("      warp_mma<2, 6, KC, K12_LDW1>(acc, a1, LDA_C, W1, b1_pair, 0);\n",
        "      acc[0][0][0] += W1[lane];\n"),
       ("    warp_mma<2, 3, K12_HB / 2, K12_LDW2>(acc2, U + a2, K12_LDU, W2 + K12_HB * rank, b2_pair,\n"
        "                                         b2_last);\n",
        "    acc2[0][0][0] += U[lane];\n"),
       ("      warp_mma<2, 3, K12_HB / 2, K12_LDW2>(acc2, buf + a2, K12_LDU,\n"
        "                                           W2 + K12_HB * ((rank + k) % K12_CLUSTER), b2_pair,\n"
        "                                           b2_last);\n",
        "      acc2[0][0][0] += buf[lane];\n"))
EXCHANGE = (("        cluster_st16(ar + 16 * lane, (rank + k) % K12_CLUSTER, v);\n",
             "        if (v.x == 0x7f7f1234u) *reinterpret_cast<uint4*>(ar) = v;\n"),
            ("      for (int k = 0; k < K12_CLUSTER; ++k) cluster_st(sh + lr, k, sc);\n",
             "      sh[lr] = sc;\n"),
            ("      for (int k = 0; k < K12_CLUSTER; ++k) m = fmaxf(m, cluster_ld(amax + tid, k));\n",
             "      m = amax[tid];\n"),
            ("        d[j] = cluster_ld16(U + r * K12_LDU + 16 * c, p);\n",
             "        d[j] = *reinterpret_cast<const uint4*>(U + r * K12_LDU + 16 * c);\n"))
LN = (("      sc = ln_quant_row<T, KC / 32, kBf16Ln>(xs + warp * KC, lane, nullptr, nullptr, eps, do_ln,\n"
       "                                             ar);\n",
       "      sc = 1.f;\n"),)
GELU = (("              const float gl = gelu_tanh(pre);\n", "              const float gl = pre;\n"),)
SYNC = (("    cluster_arrive();\n    cluster_wait();\n\n    // (3)", "    __syncthreads();\n\n    // (3)"),
        ("    cluster_arrive();  // this block's codes and its rows of the next tile are ready\n",
         "    __syncthreads();\n"),
        ("    cluster_wait();  // every block's codes (and the peers have read this block's maxima)\n",
         "    __syncthreads();\n"))
STORE = (("          store2(out + o, __fadd_rn(xv[mi][h][ni].x, y0), __fadd_rn(xv[mi][h][ni].y, y1));\n",
          "          if (y0 == 1234.5f) store2(out + o, xv[mi][h][ni].x, y1);\n"),)
VARIANTS = {"kernel": (), "no_mma": MMA, "no_exchange": EXCHANGE, "no_ln": LN, "no_gelu": GELU,
            "no_cluster_sync": SYNC, "no_store": STORE}


def sources():
    """Writes the headers and one copy of int8_mlp_cluster.cu per variant."""
    OUT.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, OUT / f.name)
    src = (_build.CSRC / "int8_mlp_cluster.cu").read_text()
    paths = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"int8_mlp_cluster.cu: the part {name} is not where this probe "
                                   "expects it")
            text = text.replace(old, new)
        paths[name] = OUT / f"k12_{name}.cu"
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
            raise RuntimeError(f"k12_{name}.cu did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(paths[name].with_suffix(".so")))
        fns[name] = _build.bind(lib, "ct_k12_cluster", P, I, I, I, I, I, P, P, P, P, P, P, F, I, I,
                                I, P, P)
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
        sys.exit("torch_k12_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    shutil.rmtree(OUT, ignore_errors=True)
    fns = build(sources())
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    lins = [mlp_int8_cuda.quantize_linear((torch.randn(o, i, generator=g) / math.sqrt(i)).to(dev),
                                          (0.05 * torch.randn(o, generator=g)).to(dev))
            for o, i in ((HID, C), (C, HID))]
    ptrs = [t.data_ptr() for lin in lins for t in lin]
    max_clusters = mlp_int8_cuda._k12_max_clusters(dev)
    for rows in ROWS:
        x = torch.randn(rows, C, generator=g).to(dev, bf)
        plan = mlp_int8_cuda.k12_plan(rows, max_clusters)
        first = mlp_int8_cuda._ln_mlp_first(x, *lins, 1e-6, True, False, False)
        ms = {"first_body": time_ms(lambda: mlp_int8_cuda._ln_mlp_first(
            x, *lins, 1e-6, True, False, False), reps=3)}
        exact = {}
        for name, fn in fns.items():
            out = torch.empty_like(x)
            args = (x.data_ptr(), 1, rows, C, HID, 1, *ptrs, 1e-6, 0, 0, plan.clusters,
                    out.data_ptr())
            ms[name] = time_ms(lambda: _build.check(
                fn(*args, torch.cuda.current_stream().cuda_stream), f"k12_{name}"))
            if name == "kernel":
                exact[name] = bool(torch.equal(out, first))
        print(json.dumps(dict(nvidia_smi=smi, rows=rows, plan=plan._asdict(),
                              ms={k: round(v, 4) for k, v in ms.items()},
                              bit_identical_to_first_body=exact)), flush=True)
        del x, first


if __name__ == "__main__":
    main()
