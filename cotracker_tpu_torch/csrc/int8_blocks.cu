// W8A8 transformer-block kernels of the updateformer (sm_90a).
//
// Replaces, on the H100, the Pallas bodies
//   K1 cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_time_block_kernel
//   K2 cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_space_block_kernel
//   K3 cotracker_tpu/ops/kernels/attention_pallas.py::_v2p_proj_kernel
// Each block body is a short chain of the launches below, driven from
// ops/kernels/{mlp_int8,attention}_cuda.py:
//   ct_ln_quant       LayerNorm (optionally affine) + per-row absmax int8
//   ct_gemm_s8        s8 x s8 -> s32 GEMM on tensor cores (mma.sync) with a
//                     fused f32 epilogue: dequant (row x column scale) + bias,
//                     then tanh-GELU or + residual, stored f32 or bf16
//   ct_time_attention per-track softmax attention over T (K1)
//   ct_p2v_attention  per-(track, frame) attention over the V virtual tokens (K2)
//   ct_v2p_flash      virtual queries over all N point keys, online softmax (K3)
// The three attention cores are the device code of attention_cores.cuh, here
// reading the chains' fused buffers and writing f32 for the next quantization.
//
// What bounds them: at the bench shape (10,240 tracks x 60 frames, C=384)
// a points time block is ~2.2 s8 TOP, near 1.1 ms at the card's 1,979 TOP/s
// int8 peak, against ~0.5 GB of token reads and writes (~0.15 ms at
// 3.35 TB/s): compute-bound. This first version keeps the products on the
// tensor cores (mma.sync, synchronous shared-memory tiles) and stages each
// attention core's keys and values in shared memory once per block (per
// track for K1, per frame and 64 tracks for K2), but q|kv, the attention
// output and the 1,536-wide GELU activations still round-trip device memory
// between launches (~8 GB per block); fusing the chain so they stay on chip,
// and wgmma/TMA GEMMs, are the next steps.
//
// Numerics follow the JAX contract exactly: two-pass f32 LayerNorm
// statistics, scale = max(absmax, 1e-20) / 127 and codes rint(v * (1/scale))
// (half to even), weights quantized per output channel on the host, f32
// dequant, q|kv rounded to the token dtype before attention, f32 logits and
// softmax, probabilities rounded to the value dtype before P.V with f32
// accumulation. Epilogue arithmetic uses explicit _rn intrinsics so the
// compiler does not contract it into FMAs the PyTorch reference lacks.

#include "attention_cores.cuh"

namespace ct {

// ---------------------------------------------------------------- LN + quant
// One warp per row of C = 32 * VPL values. do_ln = 0 quantizes the row as is.
template <typename InT, int VPL>
__global__ void ln_quant_kernel(const InT* __restrict__ x, int rows,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, float eps, int do_ln,
                                int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int C = 32 * VPL;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const InT* xr = x + static_cast<size_t>(row) * C;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = to_f(xr[lane + 32 * i]);
  if (do_ln) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) s += v[i];
    const float mean = warp_sum(s) / C;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      v[i] = __fsub_rn(v[i], mean);
      s2 += v[i] * v[i];
    }
    const float inv = 1.0f / sqrtf(__fadd_rn(warp_sum(s2) / C, eps));
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      v[i] = __fmul_rn(v[i], inv);
      if (gamma != nullptr) {
        const int c = lane + 32 * i;
        v[i] = __fadd_rn(__fmul_rn(v[i], gamma[c]), beta[c]);
      }
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-20f), 1.0f / 127.0f);
  const float inv = 1.0f / s;
  int8_t* qr = q + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < VPL; ++i) qr[lane + 32 * i] = quant8(v[i], inv);
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------- s8 GEMM
enum { MODE_AFFINE = 0, MODE_GELU = 1, MODE_RESID = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, x3));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// out[M, N] = epilogue(A[M, K] . W[N, K]^T): A and W int8, K-contiguous.
// 128 x 128 block tile, 8 warps of 64 x 32, K step 64 through shared memory
// (rows padded to 80 bytes: conflict-free fragment loads).
template <int MODE, typename ResT, typename OutT>
__global__ void __launch_bounds__(256)
gemm_s8_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
               const int8_t* __restrict__ W, const float* __restrict__ sw,
               const float* __restrict__ bias, const ResT* __restrict__ res,
               OutT* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 128, BN = 128, BK = 64, LDS = BK + 16;
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * (BK / 16); i += 256) {
      const int r = i >> 2, c = (i & 3) * 16;
      int4 va = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        va = *reinterpret_cast<const int4*>(A + static_cast<size_t>(m0 + r) * K + k0 + c);
      *reinterpret_cast<int4*>(As + r * LDS + c) = va;
      *reinterpret_cast<int4*>(Bs + r * LDS + c) =
          *reinterpret_cast<const int4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = As + (wm * 64 + mt * 16 + g) * LDS + kk + t4 * 4;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * LDS);
        af[mt][2] = ld32(p + 16);
        af[mt][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = Bs + (wn * 32 + nt * 8 + g) * LDS + kk + t4 * 4;
        bfr[nt][0] = ld32(p);
        bfr[nt][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (row >= M) continue;
      const float sr = sa[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + nt * 8 + t4 * 2 + j;
          const size_t o = static_cast<size_t>(row) * N + col;
          const float v = __fmul_rn(static_cast<float>(acc[mt][nt][half * 2 + j]),
                                    __fmul_rn(sr, sw[col]));
          float y;
          if (MODE == MODE_RESID) {
            y = __fadd_rn(__fadd_rn(to_f(res[o]), v), bias[col]);
          } else {
            y = __fadd_rn(v, bias[col]);
            if (MODE == MODE_GELU) y = gelu_tanh(y);
          }
          out[o] = from_f<OutT>(y);
        }
      }
    }
  }
}

template <int MODE, typename ResT, typename OutT>
cudaError_t launch_gemm(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
                        const float* bias, const void* res, void* out, int M, int N, int K,
                        cudaStream_t stream) {
  dim3 grid((M + 127) / 128, N / 128);
  gemm_s8_kernel<MODE, ResT, OutT><<<grid, 256, 0, stream>>>(
      A, sa, W, sw, bias, static_cast<const ResT*>(res), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t launch_ln_quant(const void* x, int rows, int C, const float* gamma,
                            const float* beta, float eps, int do_ln, int8_t* q, float* scale,
                            cudaStream_t stream) {
  const int grid = (rows + 7) / 8;
  const InT* xp = static_cast<const InT*>(x);
  if (C == 384)
    ln_quant_kernel<InT, 12><<<grid, 256, 0, stream>>>(xp, rows, gamma, beta, eps, do_ln, q, scale);
  else if (C == 1536)
    ln_quant_kernel<InT, 48><<<grid, 256, 0, stream>>>(xp, rows, gamma, beta, eps, do_ln, q, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace ct

using namespace ct;

// All entry points return a cudaError_t code (0 = launched); the stream is
// PyTorch's current stream, passed as an opaque pointer.
extern "C" {

int ct_ln_quant(const void* x, int in_bf16, int rows, int C, const float* gamma,
                const float* beta, float eps, int do_ln, int8_t* q, float* scale,
                void* stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_ln_quant<__nv_bfloat16>(x, rows, C, gamma, beta, eps, do_ln, q, scale, s)
                 : launch_ln_quant<float>(x, rows, C, gamma, beta, eps, do_ln, q, scale, s);
}

int ct_gemm_s8(const int8_t* A, const float* sa, const int8_t* W, const float* sw,
               const float* bias, const void* res, int res_bf16, void* out, int out_bf16,
               int M, int N, int K, int mode, void* stream) {
  if (M < 1 || N % 128 != 0 || K % 64 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (mode == MODE_AFFINE)
    return out_bf16 ? launch_gemm<MODE_AFFINE, float, bf>(A, sa, W, sw, bias, res, out, M, N, K, s)
                    : launch_gemm<MODE_AFFINE, float, float>(A, sa, W, sw, bias, res, out, M, N, K, s);
  if (mode == MODE_GELU && !out_bf16)
    return launch_gemm<MODE_GELU, float, float>(A, sa, W, sw, bias, res, out, M, N, K, s);
  if (mode == MODE_RESID) {
    if (res_bf16)
      return out_bf16 ? launch_gemm<MODE_RESID, bf, bf>(A, sa, W, sw, bias, res, out, M, N, K, s)
                      : launch_gemm<MODE_RESID, bf, float>(A, sa, W, sw, bias, res, out, M, N, K, s);
    return out_bf16 ? launch_gemm<MODE_RESID, float, bf>(A, sa, W, sw, bias, res, out, M, N, K, s)
                    : launch_gemm<MODE_RESID, float, float>(A, sa, W, sw, bias, res, out, M, N, K, s);
  }
  return cudaErrorInvalidValue;
}

int ct_time_attention(const void* qkv, int bf16, float* out, int M, int T, int H, int D,
                      float scale, void* stream) {
  if (!time_shape_ok(M, T, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * D;
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(qkv);
    return launch_time_attention<__nv_bfloat16, float>(p, 3 * C, p + C, p + 2 * C, 3 * C, out, M,
                                                       T, H, scale, s);
  }
  const float* p = static_cast<const float*>(qkv);
  return launch_time_attention<float, float>(p, 3 * C, p + C, p + 2 * C, 3 * C, out, M, T, H,
                                             scale, s);
}

int ct_p2v_attention(const void* q, const void* kv, int bf16, float* out, int N, int T, int V,
                     int H, int D, float scale, void* stream) {
  if (!p2v_shape_ok(N, T, V, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_p2v_attention<__nv_bfloat16, float>(q, kv, out, N, T, V, H, scale, s)
              : launch_p2v_attention<float, float>(q, kv, out, N, T, V, H, scale, s);
}

int ct_v2p_flash(const void* q, const void* kv, const float* bias, int bf16, void* out, int N,
                 int T, int V, int H, int D, float scale, void* stream) {
  if (!v2p_shape_ok(N, T, V, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_v2p_flash<__nv_bfloat16>(q, kv, bias, out, N, T, V, H, scale, s)
              : launch_v2p_flash<float>(q, kv, bias, out, N, T, V, H, scale, s);
}

}  // extern "C"
