"""Where K4r's time goes on the card: copies of csrc/corr_window.cu built
with one part of the work of K4's cluster kernel in its K4r mode taken
out, timed beside the kernel itself on the same inputs (the outputs of the
copies that drop work are wrong by design; only their times mean anything).

    python3 scripts/torch_k4r_parts.py

Parts: the code write after the cluster's scale (`no_codes`: the loop that
reads the held g, quantizes it and stores 16 bytes a thread; `no_store`:
only its 16-byte stores), the windows' copies into shared memory
(`no_windows`: the products read whatever the regions hold), the s8
products and their fragment loads (`no_products`), the raw g's writes into
the regions (`no_hold`), and the cluster's barriers and distributed
shared-memory exchange of the maxima (`no_cluster`: each block scales by
its own maximum). Each copy is built into build/k4r_parts/ with the flags
of ops/kernels/_build.py, all nvcc processes at once, and bound through
ctypes like the kernel's own entry. One JSON line per shape (768 points x
16 frames and 2,048 x 60, level 0 of the 384x512 input: K4r's shapes in
chip_smoke). Needs a CUDA card; random operands from seed 0.
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
CODES = (("    for (int i = tid; i < nf * kPieces; i += kK4Threads) {\n"
          "      const int j = i / kPieces, e0 = (i - j * kPieces) * 16;\n"
          "      const float* cf = reinterpret_cast<const float*>(regions + j * kK4Region);\n"
          "      int r = e0 / kS,",
          "    for (int i = tid; i < 0 * nf * kPieces; i += kK4Threads) {\n"
          "      const int j = i / kPieces, e0 = (i - j * kPieces) * 16;\n"
          "      const float* cf = reinterpret_cast<const float*>(regions + j * kK4Region);\n"
          "      int r = e0 / kS,"),)
STORE = (("      *reinterpret_cast<uint4*>(outp + static_cast<size_t>(f0 + j) * (kR * kS) + e0) =\n",
          "      if (w[0] == 0x5a5a5a5au && w[1] == w[2])\n"
          "      *reinterpret_cast<uint4*>(outp + static_cast<size_t>(f0 + j) * (kR * kS) + e0) =\n"),)
WINDOWS = (("        cp_async16(win + k4_swz(row, c), fm + pix * kC + 16 * c, true);\n",
            "        if (Hp < 0) cp_async16(win + k4_swz(row, c), fm + pix * kC + 16 * c, true);\n"),)
PRODUCTS = (("#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {\n          uint32_t af[4];\n"
              "          ldsm_x4(af, win + k4_swz(16 * m + (lane & 15), 2 * kk + (lane >> 4)));\n"
              "#pragma unroll\n"
              "          for (int nt = 0; nt < 7; ++nt) mma_s8_16832(acc[nt], af, bfr[nt][kk]);\n"
              "        }\n",
              "        acc[m][0] = lane;\n"),)
HOLD = (("          *reinterpret_cast<float2*>(cr) = make_float2(c0, c1);\n",
         "          if (c0 == 1234.5f) *reinterpret_cast<float2*>(cr) = make_float2(c0, c1);\n"),)
CLUSTER = (("  cluster_arrive();\n  cluster_wait();\n  if (tid == 0) {\n    float m = 0.f;\n"
            "    for (int r = 0; r < cs; ++r) m = fmaxf(m, cluster_ld(red + 4, r));\n",
            "  if (tid == 0) {\n    float m = red[4];\n"),
           ("  cluster_arrive();  // this block has read the others' maxima\n", ""),
           ("  cluster_wait();  // no block leaves while another may still read its maximum\n", ""))
VARIANTS = {"kernel": (), "no_codes": CODES, "no_store": STORE, "no_windows": WINDOWS,
            "no_products": PRODUCTS, "no_hold": HOLD, "no_cluster": CLUSTER}


def main():
    smi = parts.card("torch_k4r_parts")
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = parts.build(parts.edited_copies("corr_window.cu", "k4r", VARIANTS),
                      "ct_corr_volume_raw", P, P, P, P, P, I, I, I, I, I, I, P)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    Hh, W = 96, 128
    for n, T in SHAPES:
        fm = torch.nn.functional.normalize(torch.randn(1, T, Hh, W, 128, generator=g), dim=-1).to(dev)
        sup = torch.nn.functional.normalize(torch.randn(1, 49, n, 128, generator=g), dim=-1).to(dev)
        coords = (torch.rand(1, T, n, 2, generator=g) * torch.tensor([W, Hh])).to(dev)
        starts, _ = corr_cuda.level_operands(coords, 1, T, Hh, W, 3)
        fmq = corr_cuda.build_int8_level(fm, 3)
        supq = corr_cuda.quantize_support(sup, torch.float32)[0].reshape(n, 49, 128)
        Tp = starts.shape[1]
        plan = corr_cuda.k4_plan(n, Tp)
        ref, rscale = corr_cuda.corr_volume_raw_int8(fmq, supq, starts)
        ms, exact = {}, None
        for name, fn in fns.items():
            vol, scale = torch.empty_like(ref), torch.empty_like(rscale)
            args = (fmq.data_ptr(), supq.data_ptr(), starts.data_ptr(), vol.data_ptr(),
                    scale.data_ptr(), n, Tp, fmq.shape[1], fmq.shape[2], plan.cluster,
                    int(plan.hold))
            ms[name] = parts.time_ms(lambda: _build.check(
                fn(*args, torch.cuda.current_stream().cuda_stream), f"k4r_{name}"))
            if name == "kernel":
                exact = bool(torch.equal(vol, ref) and torch.equal(scale, rscale))
        print(json.dumps(dict(nvidia_smi=smi, points=n, frames=T, plan=plan._asdict(),
                              ms={k: round(v, 4) for k, v in ms.items()},
                              kernel_equals_wrapper=exact)), flush=True)
        del fm, sup, fmq, supq, ref, starts


if __name__ == "__main__":
    main()
