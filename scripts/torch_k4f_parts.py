"""Where K4f's time goes on the card: copies of csrc/corr_window.cu built
with one part of the K4f body's work taken out, timed beside the kernel
itself on the same inputs (the outputs of the copies that drop work are
wrong by design; only their times mean anything).

    python3 scripts/torch_k4f_parts.py

Parts (float32, the training path's route): the tensor-core products
(`no_mma`: the three tf32 products of each k step replaced by one add), the
tf32 split of the window values (`no_split`: hi = lo = the raw bits), the
windows' copies into shared memory (`no_windows`: the products read
whatever the buffers hold), the staging of the outputs in shared memory
(`no_stage`) and their stores to device memory (`no_store`); in bfloat16
(f32 FMAs in k order) the FMAs (`no_fma`: one add a row instead of 56
FMAs). Each copy is built into build/k4f_parts/ with the flags of
ops/kernels/_build.py, all nvcc processes at once, and bound through ctypes
like the kernel's own entry. One JSON line per shape and dtype (768 points
x 16 frames and 2,048 x 60, level 0 of the 384x512 input). Needs a CUDA
card; random operands from seed 0.
"""

import ctypes
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_parts as parts  # noqa: E402
from cotracker_tpu_torch.ops.kernels import _build, corr_cuda  # noqa: E402

SHAPES = ((768, 16), (2048, 60))
MMA = tuple((f"        for (int n = 0; n < NT; ++n) mma_tf32_1688(acc[m][n], {a}[m], b[n].{x}, b[n].{y});\n",
             f"        for (int n = 0; n < NT; ++n) acc[m][n][0] += __uint_as_float({a}[m][0] ^ b[n].{x});\n")
            for a, x, y in (("al", "x", "y"), ("ah", "z", "w"), ("ah", "x", "y")))
SPLIT = (("          ah[m][k] = tf32_rna(v);\n          al[m][k] = tf32_rna(__fsub_rn(v, __uint_as_float(ah[m][k])));\n",
          "          ah[m][k] = al[m][k] = __float_as_uint(v);\n"),)
WINDOWS = (("          cp_async16(dst + r * L::kLdw + 16 * c,\n",
            "          if (f < 0) cp_async16(dst + r * L::kLdw + 16 * c,\n"),)
STAGE = tuple((f"          k4f_mma_stage<1, {nt}>(out, acc, row0, {n0});\n",
               f"          if (acc[0][0][0] == 1234.5f) k4f_mma_stage<1, {nt}>(out, acc, row0, {n0});\n")
              for nt, n0 in (("4", "0"), ("kFNt - 4", "4")))
STORE = (("    for (int i = tid; i < nj * (L::kStage / 16); i += L::kThreads) __stcs(dst + i, src[i]);\n",
          "    if (nj < 0) __stcs(dst + tid, src[tid]);\n"),)
FMA = (("        for (int j = 0; j < 7; ++j) acc[i][j] = fmaf(a[kk], b[j][kk], acc[i][j]);\n",
        "        acc[i][kk % 7] += a[kk];\n"),)
VARIANTS = {"kernel": (), "no_mma": MMA, "no_split": SPLIT, "no_windows": WINDOWS,
            "no_stage": STAGE, "no_store": STORE, "no_fma": FMA}


def main():
    smi = parts.card("torch_k4f_parts")
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = parts.build(parts.edited_copies("corr_window.cu", "k4f", VARIANTS),
                      "ct_corr_volume_float", P, P, P, P, I, I, I, I, I, I, I, P)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    Hh, W = 96, 128
    for n, T in SHAPES:
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g), dim=-1).to(dev)
        sup = torch.nn.functional.normalize(torch.randn(n, 49, 128, generator=g), dim=-1).to(dev)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, _ = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        Tp = starts.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            fmf, supf = corr_cuda.build_float_level(fm, 3, dtype), sup.to(dtype).contiguous()
            plan = corr_cuda.k4f_plan(n, Tp, dtype, sms)
            ref = corr_cuda._k4f_launch(fmf, supf, starts, plan)
            ms, exact = {}, None
            for name, fn in fns.items():
                if name in (("no_fma",) if dtype == torch.float32 else
                            ("no_mma", "no_split", "no_stage")):
                    continue
                vol = torch.empty_like(ref)
                args = (fmf.data_ptr(), supf.data_ptr(), starts.data_ptr(), vol.data_ptr(),
                        int(dtype == torch.bfloat16), n, Tp, fmf.shape[1], fmf.shape[2], plan.group,
                        plan.blocks)
                ms[name] = parts.time_ms(lambda: _build.check(
                    fn(*args, torch.cuda.current_stream().cuda_stream), f"k4f_{name}"))
                if name == "kernel":
                    exact = bool(torch.equal(vol, ref))
            print(json.dumps(dict(nvidia_smi=smi, points=n, frames=T, dtype=str(dtype).split(".")[-1],
                                  plan=plan._asdict(), ms={k: round(v, 4) for k, v in ms.items()},
                                  kernel_equals_wrapper=exact)), flush=True)
            del fmf, supf, ref
        del fm, sup, starts


if __name__ == "__main__":
    main()
