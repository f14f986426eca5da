"""Where K3's time goes on the card: copies of csrc/int8_v2p_proj.cu built
with one part of the fused kernel's work compiled out, timed beside the
kernel itself on the same inputs (the outputs of the copies are wrong by
design; only their times mean anything).

    python3 scripts/torch_k3_parts.py

Parts: the LayerNorm, affine and row quantization of the point tokens
(`no_ln`: constant codes instead), the online-softmax step (`no_attn`),
the products' tensor-core instructions (`no_mma`: the weight stream
kept), the weight stream (`no_wload`: the products on whatever the ring
holds), and the ring at 64 bytes of K a stage (`bk64`, exact: the integer
products do not depend on the staging). Each copy is built into build/k3_parts/ with the
flags of ops/kernels/_build.py, all nvcc processes at once, and bound
through ctypes like the kernel's own entry. One JSON line per shape and
head group. Needs a CUDA card; bf16, random operands from seed 0.
"""

import ctypes
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_parts as parts  # noqa: E402
from cotracker_tpu_torch.ops.kernels import _build, attention_cuda, mlp_int8_cuda  # noqa: E402

C, H, D, V = 384, 8, 48, 64
SHAPES = ((10240, 60), (10240, 16))
RING = "using K3KvGemm = RingGemm<2, 4, 2, 6, 128, 3>;"
# (source text, the same text guarded by a macro) of each part
GUARDS = {
    "int8_tile.cuh": [
        ("      cp_async16(buf + n * LDB + 16 * c, wrow(n) + kt * BK + 16 * c, true);\n", "NO_WLOAD"),
        ("      warp_mma<MI, NI, BK, LDB>(acc, a_base + kt * BK, lda, ring + (kt % STAGES) * STAGE, "
         "b_off,\n                                b_last);\n", "NO_MMA"),
    ],
}
LN = ("        ln_affine_quant2(xs + r * KC, xs + (r + 8) * KC, lane, gm, bt, eps, A + r * LDA_C,\n"
      "                         A + (r + 8) * LDA_C, sc[0], sc[1]);\n")
ATTN_BEGIN = "      // K7's step for"
ATTN_END = "      chunk_pv_ilv(acc[p], S, vt + hh * TS);\n"
VARIANTS = {"kernel": "", "no_ln": "NO_LN", "no_attn": "NO_ATTN", "no_mma": "NO_MMA",
            "no_wload": "NO_WLOAD", "bk64": ""}


def guarded(text, macro):
    return f"#ifndef PROBE_{macro}\n{text}#endif\n"


def sources():
    """Writes the probe copies of the headers and one .cu per variant."""
    out = parts.fresh_dir("k3")
    for f in _build.CSRC.glob("*.cuh"):
        text = f.read_text()
        for old, macro in GUARDS.get(f.name, ()):
            if old not in text:
                raise RuntimeError(f"{f.name}: the part {macro} is not where this probe expects it")
            text = text.replace(old, guarded(old, macro))
        (out / f.name).write_text(text)
    src = (_build.CSRC / "int8_v2p_proj.cu").read_text()
    a, b = src.index(ATTN_BEGIN), src.index(ATTN_END) + len(ATTN_END)
    if LN not in src or RING not in src:
        raise RuntimeError("int8_v2p_proj.cu: the LayerNorm call or the ring is not where this "
                           "probe expects it")
    src = src[:a] + guarded(src[a:b], "NO_ATTN") + src[b:]
    src = src.replace(LN, guarded(LN, "NO_LN").replace(
        "#endif\n", "#else\n        for (int c = lane; c < KC; c += 32) A[r * LDA_C + c] = "
        "A[(r + 8) * LDA_C + c] = 1;\n        sc[0] = sc[1] = 1.f;\n#endif\n"))
    paths = {}
    for name, macro in VARIANTS.items():
        text = (f"#define PROBE_{macro}\n" if macro else "") + src
        if name == "bk64":
            text = text.replace(RING, RING.replace("128, 3>", "64, 3>"))
        paths[name] = out / f"k3_{name}.cu"
        paths[name].write_text(text)
    return paths


def main():
    smi = parts.card("torch_k3_parts")
    fns = parts.build(sources(), "ct_k3_v2p_proj", *([ctypes.c_void_p] * 8), *([ctypes.c_int] * 9),
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p)
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    wkv = mlp_int8_cuda.quantize_linear(
        (torch.randn(2 * C, C, generator=g) / math.sqrt(C)).to(dev),
        (0.05 * torch.randn(2 * C, generator=g)).to(dev))
    gamma = (1 + 0.1 * torch.randn(C, generator=g)).to(dev)
    beta = (0.05 * torch.randn(C, generator=g)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for N, T in SHAPES:
        q = (0.3 * torch.randn(T, V, C, generator=g)).to(dev, bf)
        x = torch.randn(N, T, C, generator=g).to(dev, bf)
        bias = torch.zeros(N, device=dev)
        planned = attention_cuda.k3_plan(N, T, V, bf, sms=sms)
        for heads in (8, 4):
            plan = planned._replace(heads=heads)
            part = torch.empty((plan.splits * T * V * (C + 2 * H),), dtype=torch.float32,
                               device=dev)
            outs, ms = {}, {}
            for name, fn in fns.items():
                out = torch.empty_like(q)
                args = (q.data_ptr(), x.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
                        beta.data_ptr(), wkv.w.data_ptr(), wkv.s.data_ptr(), wkv.b.data_ptr(),
                        N, T, V, C, H, D, plan.splits, plan.split_keys, heads, 1e-5, D**-0.5,
                        out.data_ptr(), part.data_ptr())
                ms[name] = parts.time_ms(lambda: _build.check(
                    fn(*args, torch.cuda.current_stream().cuda_stream), f"k3_{name}"), reps=10)
                outs[name] = out
            print(json.dumps(dict(
                nvidia_smi=smi, tracks=N, frames=T, heads=heads, splits=plan.splits,
                planned=heads == planned.heads, ms={k: round(v, 4) for k, v in ms.items()},
                bk64_exact=bool(torch.equal(outs["bk64"], outs["kernel"])))), flush=True)
        del q, x


if __name__ == "__main__":
    main()
