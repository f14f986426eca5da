// Stand-alone attention-core kernels of the updateformer (sm_90a): bf16 or
// f32 attention without W8A8, on projections computed outside the kernel.
//
// Replaces, on the H100, the Pallas bodies of
// cotracker_tpu/ops/kernels/attention_pallas.py:
//   K5 ::_kernel      (wrapper fused_time_attention)       ct_k5_time_attention
//   K6 ::_p2v_kernel  (wrapper fused_points_from_virtual)  ct_k6_points_from_virtual
//   K7 ::_v2p_kernel  (wrapper fused_virtual_from_points)  ct_k7_virtual_from_points
// driven from ops/kernels/attention_cuda.py. The device code is shared with
// the attention stages of K1-K3 (attention_cores.cuh); these entries take
// the Pallas wrappers' operands (q and the unsplit K|V projection as two
// tensors) and write the output once, rounded from the f32 accumulator to
// the query dtype.
//
// What bounds them: bytes, all three. At 10,240 tracks x 16 frames in bf16
// the products are ~4 GFLOP (K5) and ~16 GFLOP (K6, K7 each), under 0.02 ms
// at the card's 989 TFLOP/s, against ~0.5 GB of q, kv and out for K5
// (~0.15 ms at 3.35 TB/s) and ~0.25 GB for K6 (point queries in, out) and
// K7 (point keys|values in), ~0.08 ms each.
//
// K6 and K7 in bf16 are the tensor-core bodies of attention_cores.cuh, which
// stream every operand once in whole 16-byte pieces (cp.async) and do both
// products on mma.sync m16n8k16 with f32 accumulation, the score fragment
// reused as P's A fragment in registers. K6: a block per (frame, track
// range, head group) stages the frame's keys and values once; each warp
// takes (16 tracks, head) tasks, its q head slices staged through its own
// shared buffer one task ahead and its output written back through it (the
// first design read q with 8-byte loads straight into fragments and wrote
// 4-byte pieces: 0.245 ms at T=16 with the math removed, against 0.086 ms
// for a copy of the same bytes). K7 is flash-decoding: a block per (head,
// key range, frame) walks its range in 64-key tiles through a 3-stage ring
// and writes f32 partials (max, sum, accumulator) that a second launch
// merges; the 8 head blocks of a range are neighbours in the grid, so each
// 1,536-byte key|value row is read from device memory once. A range takes
// at least 2,048 keys (each rounds its probabilities against its own
// running max). mma.sync and cp.async, not wgmma and TMA: both kernels
// run within ~2x of their byte bound and under one SDPA call on the same
// operands, and the products are ~20% of the bound's time.
//
// K5 in bf16 (the time core, also K1's attention stage in
// int8_time_block.cu) is time_tc_kernel up to 512 frames: a block holds
// whole tracks (64 // T of them up to 64 frames, one above) x a group of
// heads (48 KB of shared memory a block where a head allows), neighbours in
// the grid; every 16-byte piece of its q, k and v head slices is moved once
// by cp.async into the interleaved layout; warps take (head, 16 query rows)
// tasks with both products on mma.sync m16n8k16 and the fragments by
// ldmatrix; a tile of several tracks masks the other tracks' keys. The
// contract's softmax, normalized before its rounding to bf16, needs each
// row's max and sum before the first probability: up to 4 key chunks (256
// frames) the scores stay in registers (one pass), above the keys already
// in shared memory are read twice (online max and sum, then the
// probabilities and P.V); at 128 and 250 frames the registers win (0.57
// against 0.77 ms at 2,048 x 128, 2.52 against 2.87 at 2,560 x 250). The
// output goes back through the task's q rows to 16-byte stores. Past 512
// frames the long route streams keys in 64-frame chunks, twice per
// 128-frame query tile, the 8 head blocks of a track neighbours, fragments
// by ldmatrix. What bounds it: bytes, ~0.56 ms at 10,240 x 60. How far it
// got (chip_smoke and scripts/torch_cores.py, one NVIDIA H100 80GB HBM3 at
// 700 W): 0.30 / 1.09 ms at 10,240 x 16 / 60 against SDPA's 1.31 / 1.31
// and the first version's 1.28 / 7.64 (2.0x / 1.9x the byte bound); 2.52
// ms at 2,560 x 250 (SDPA 1.07, first version 26.9), 3.80 at 512 x 600 and
// 1.93 at 256 x 640 on the long route (SDPA 1.12 / 0.53): past 128 frames
// the two passes, or the 254 registers of four chunks, leave it over SDPA.
//
// Every f32 operand keeps the first-version bodies (keys and values staged
// as f32, products on the CUDA cores; TF32 tensor cores would change the
// f32 function): K5 up to 512 frames and, past them, a warp-per-query walk
// over the keys in device memory, which only the tests reach.

#include "attention_cores.cuh"

using namespace ct;

// All entry points return a cudaError_t code (0 = launched); `bf16` selects
// the element type of every tensor argument (else float32); the stream is
// PyTorch's current stream, passed as an opaque pointer.
extern "C" {

// q (M, T, C); kv (M, T, 2C) = [K | V]; out (M, T, C), C = H * D. In bf16
// up to kMaxKeys frames the plan (nc, hs, tracks, rows_pad) of
// attention_cuda.k5_plan picks the tensor-core body's tiling; the long route
// and f32 ignore it.
int ct_k5_time_attention(const void* q, const void* kv, int bf16, void* out, int M, int T, int H,
                         int D, float scale, int nc, int hs, int tracks, int rows_pad,
                         void* stream) {
  if (!time_shape_ok(M, T, H, D, /*capped=*/false)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * D;
  if (bf16) {
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(kv);
    if (T <= kMaxKeys)
      return launch_time_tc(static_cast<const __nv_bfloat16*>(q), C, k, k + C, 2 * C,
                            static_cast<__nv_bfloat16*>(out), M, T, H, scale, nc, hs, tracks,
                            rows_pad, s);
    return launch_time_attention<__nv_bfloat16, __nv_bfloat16>(q, C, k, k + C, 2 * C, out, M, T,
                                                               H, scale, s);
  }
  const float* k = static_cast<const float*>(kv);
  return launch_time_attention<float, float>(q, C, k, k + C, 2 * C, out, M, T, H, scale, s);
}

// q (N, T, C); kv (T, V, 2C); out (N, T, C).
int ct_k6_points_from_virtual(const void* q, const void* kv, int bf16, void* out, int N, int T,
                              int V, int H, int D, float scale, void* stream) {
  if (!p2v_shape_ok(N, T, V, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_p2v_attention<__nv_bfloat16, __nv_bfloat16>(q, kv, out, N, T, V, H, scale, s)
              : launch_p2v_attention<float, float>(q, kv, out, N, T, V, H, scale, s);
}

// q (T, V, C); kv (N, T, 2C); bias (N,) f32; out (T, V, C); part: bf16's
// scratch of splits * T * V * (C + 2H) floats (unused in f32).
int ct_k7_virtual_from_points(const void* q, const void* kv, const float* bias, int bf16,
                              void* out, float* part, int splits, int N, int T, int V, int H,
                              int D, float scale, void* stream) {
  if (!v2p_shape_ok(N, T, V, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_v2p_flash<__nv_bfloat16>(q, kv, bias, out, part, splits, N, T, V, H,
                                                scale, s)
              : launch_v2p_flash<float>(q, kv, bias, out, part, splits, N, T, V, H, scale, s);
}

}  // extern "C"
