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
// K5 up to 512 frames, and every f32 operand, keep the first-version
// bodies: keys and values staged in shared memory as f32, products on the
// CUDA cores (TF32 tensor cores would change the f32 function), one warp
// per query (K5, K6) or four threads per query (K7). K5 past 512 frames
// (more than the 227 KB of an SM can stage) takes its long route: in bf16 a
// 64-frame query tile on mma.sync with the keys streamed in 64-frame
// chunks, pass 1 for each row's max and sum and pass 2 for the normalized
// probabilities and P.V (the contract exactly: softmax normalized before
// the rounding); in f32 a simple warp-per-query walk over the keys in
// device memory, which only the tests reach.

#include "attention_cores.cuh"

using namespace ct;

// All entry points return a cudaError_t code (0 = launched); `bf16` selects
// the element type of every tensor argument (else float32); the stream is
// PyTorch's current stream, passed as an opaque pointer.
extern "C" {

// q (M, T, C); kv (M, T, 2C) = [K | V]; out (M, T, C), C = H * D.
int ct_k5_time_attention(const void* q, const void* kv, int bf16, void* out, int M, int T, int H,
                         int D, float scale, void* stream) {
  if (!time_shape_ok(M, T, H, D, /*capped=*/false)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * D;
  if (bf16) {
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(kv);
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
