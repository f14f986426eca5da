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
// K7 (point keys|values in), ~0.08 ms each. This first version stages each
// block's keys and values in shared memory as f32 and does the products on
// the CUDA cores, one warp per query (K5, K6) or four threads per query
// (K7), so it runs at the f32 instruction rate and not at the memory rate; K7's
// grid is (frames, heads), 128 blocks at 16 frames, which does not fill the
// card's 132 SMs. Tensor-core products (mma.sync or wgmma on bf16 tiles),
// wider coalesced loads and a split of K7's keys across blocks are the
// next steps.

#include "attention_cores.cuh"

using namespace ct;

// All entry points return a cudaError_t code (0 = launched); `bf16` selects
// the element type of every tensor argument (else float32); the stream is
// PyTorch's current stream, passed as an opaque pointer.
extern "C" {

// q (M, T, C); kv (M, T, 2C) = [K | V]; out (M, T, C), C = H * D.
int ct_k5_time_attention(const void* q, const void* kv, int bf16, void* out, int M, int T, int H,
                         int D, float scale, void* stream) {
  if (!time_shape_ok(M, T, H, D)) return cudaErrorInvalidValue;
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

// q (T, V, C); kv (N, T, 2C); bias (N,) f32; out (T, V, C).
int ct_k7_virtual_from_points(const void* q, const void* kv, const float* bias, int bf16,
                              void* out, int N, int T, int V, int H, int D, float scale,
                              void* stream) {
  if (!v2p_shape_ok(N, T, V, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_v2p_flash<__nv_bfloat16>(q, kv, bias, out, N, T, V, H, scale, s)
              : launch_v2p_flash<float>(q, kv, bias, out, N, T, V, H, scale, s);
}

}  // extern "C"
