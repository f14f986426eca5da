// W8A8 transformer-block kernels of the updateformer (sm_90a).
//
// Replaces, on the H100, the Pallas bodies
//   K1 cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_time_block_kernel
//   K2 cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_space_block_kernel
//   K3 cotracker_tpu/ops/kernels/attention_pallas.py::_v2p_proj_kernel
//   K8 cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_qkv_kernel
//   K9 cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_out_mlp_kernel
// K1 and K2 (f32 tokens, K2 also past 64 virtual tokens; bf16 takes
// csrc/int8_time_block.cu) and K3 (f32; bf16 takes csrc/int8_v2p_proj.cu)
// are each a short chain of the launches below, driven from
// ops/kernels/{mlp_int8,attention}_cuda.py:
//   ct_ln_quant       LayerNorm (optionally affine) + per-row absmax int8
//   ct_gemm_s8        s8 x s8 -> s32 GEMM on tensor cores (mma.sync) with a
//                     fused f32 epilogue: dequant (row x column scale) + bias,
//                     then tanh-GELU or + residual, stored f32 or bf16
//   ct_time_attention per-track softmax attention over T (K1)
//   ct_p2v_attention  per-(track, frame) attention over the V virtual tokens (K2)
//   ct_v2p_flash      virtual queries over all N point keys, online softmax (K3)
// The three attention cores are the device code of attention_cores.cuh, here
// reading the chains' fused buffers (K2's core writes f32 for the next
// quantization); in bf16 K2's and K3's are K6's and K7's tensor-core bodies.
// K8 and K9, the two W8A8 halves of the time block's three-kernel split
// around the K5 attention core (videos whose frames leave no whole-block
// track tile), are one launch each:
//   ct_k8_ln_qkv      one read of x -> LN + row quant into shared memory ->
//                     the q and kv products -> q, kv in the token dtype
//   ct_k9_attnout_mlp float32 tokens only: one read of a and x -> r = x +
//                     to_out(a) kept in shared memory (f32) -> LN + quant ->
//                     fc1 + GELU -> quant (the 1,536-wide codes stay in
//                     shared memory) -> fc2 + r. K9 in bfloat16 runs K1's
//                     streamed tail with K9's prologue (ct_k9_tail,
//                     int8_time_block.cu): 19.56 -> 6.96 ms at 2,048 tracks
//                     x 250 frames on an H100.
//
// What bounds them: at the bench shape (10,240 tracks x 60 frames, C=384)
// a points time block is ~2.2 s8 TOP, near 1.1 ms at the card's 1,979 TOP/s
// int8 peak, against ~0.5 GB of token reads and writes (~0.15 ms at
// 3.35 TB/s): compute-bound. The chains keep the products on the tensor
// cores (mma.sync, synchronous shared-memory tiles) and stage each
// attention core's keys and values in shared memory once per block, but
// their q|kv, attention output and 1,536-wide GELU activations round-trip
// device memory between launches (~8 GB per block). K1 in bf16 no longer
// runs here: csrc/int8_time_block.cu takes it in two launches with those
// activations on chip (24.2 -> 11.7 ms at the bench shape on an H100; its
// note says what bounds it now); its f32 route is the K1 chain below
// (ct_time_attention with the first-version time core). K2 and K3 in bf16
// left too: K2 is a fused front and K1's tail (int8_time_block.cu), K3 one
// kernel that projects each key tile on chip (int8_v2p_proj.cu). K8 moves
// 3,072 bytes a bf16 row for 0.88 M int8 operations (~290 a byte, under the
// card's int8 balance of ~590: bytes-bound), K9 2,304 bytes for 2.65 M
// (compute-bound); both re-read the weights from L2 for every row tile (128
// rows for K8, 64 for K9's f32 body, whose tile is bounded by the 227 KB of
// shared memory a block may hold), and K9 computes fc1 twice (the GELU
// codes' row scale needs the row's absmax before the first code is
// written): 1.45x its operations.
//
// The shared device routines (LN + row quant, GELU, the tile GEMM and the
// MLP-tail stages) live in int8_tile.cuh, with the two variant flags of the
// JAX package (bf16 LayerNorm, GELU-quant fold) as template parameters:
// ct_ln_quant takes them as a mode, K8 and K9 as arguments.
//
// Numerics follow the JAX contract exactly: two-pass f32 LayerNorm
// statistics, scale = max(absmax, 1e-20) / 127 and codes rint(v * (1/scale))
// (half to even), weights quantized per output channel on the host, f32
// dequant, q|kv rounded to the token dtype before attention, f32 logits and
// softmax, probabilities rounded to the value dtype before P.V with f32
// accumulation. Epilogue arithmetic uses explicit _rn intrinsics so the
// compiler does not contract it into FMAs the PyTorch reference lacks, and
// keeps each JAX body's order of additions (K1's last residual is
// (r + y) + b, K9's r + (y + b)).

#include "int8_tile.cuh"

namespace ct {

// ---------------------------------------------------------------- LN + quant
// One warp per row of the (rows, C) input.
template <typename InT, int VPL, bool kBf16Ln, bool kGeluFold>
__global__ void ln_quant_kernel(const InT* __restrict__ x, int rows,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta, float eps, int do_ln,
                                int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int C = 32 * VPL;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float s = ln_quant_row<InT, VPL, kBf16Ln, kGeluFold>(
      x + static_cast<size_t>(row) * C, lane, gamma, beta, eps, do_ln,
      q + static_cast<size_t>(row) * C);
  if (lane == 0) scale[row] = s;
}

// ---------------------------------------------------------------- s8 GEMM
enum { MODE_AFFINE = 0, MODE_GELU = 1, MODE_RESID = 2 };

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

template <typename InT, bool kBf16Ln, bool kGeluFold>
cudaError_t launch_ln_quant(const void* x, int rows, int C, const float* gamma,
                            const float* beta, float eps, int do_ln, int8_t* q, float* scale,
                            cudaStream_t stream) {
  const int grid = (rows + 7) / 8;
  const InT* xp = static_cast<const InT*>(x);
  if (C == 384)
    ln_quant_kernel<InT, 12, kBf16Ln, kGeluFold><<<grid, 256, 0, stream>>>(
        xp, rows, gamma, beta, eps, do_ln, q, scale);
  else if (C == 1536)
    ln_quant_kernel<InT, 48, kBf16Ln, kGeluFold><<<grid, 256, 0, stream>>>(
        xp, rows, gamma, beta, eps, do_ln, q, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// mode bit 0: bf16 LayerNorm; bit 1: GELU-quant fold (see int8_tile.cuh)
template <typename InT>
cudaError_t launch_ln_quant_mode(const void* x, int rows, int C, const float* gamma,
                                 const float* beta, float eps, int do_ln, int mode, int8_t* q,
                                 float* scale, cudaStream_t s) {
  switch (mode) {
    case 0: return launch_ln_quant<InT, false, false>(x, rows, C, gamma, beta, eps, do_ln, q, scale, s);
    case 1: return launch_ln_quant<InT, true, false>(x, rows, C, gamma, beta, eps, do_ln, q, scale, s);
    case 2: return launch_ln_quant<InT, false, true>(x, rows, C, gamma, beta, eps, do_ln, q, scale, s);
    case 3: return launch_ln_quant<InT, true, true>(x, rows, C, gamma, beta, eps, do_ln, q, scale, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- K8, K9
// Both hold a row tile's int8 activations in shared memory and run their
// products through the block-level tile_gemm_s8 (int8_tile.cuh).

// K8: x (rows, 384) -> q (rows, 384), kv (rows, 768) in x's dtype.
//   h = LN(x) (eps, two-pass f32 or the bf16 variant); hq, sr = row quant(h)
//   [q | kv] = hq . w^T * (sr * sw) + bias, w = [to_q; to_kv] (1152, 384)
constexpr int K8_MT = 4, K8_BM = 32 * K8_MT, K8_BK = 64;
constexpr int K8_SMEM = K8_BM * LDA_C + 128 * (K8_BK + 16) + K8_BM * 4;

template <typename T, bool kBf16Ln>
__global__ void __launch_bounds__(256)
ln_qkv_kernel(const T* __restrict__ x, int rows, const int8_t* __restrict__ w,
              const float* __restrict__ sw, const float* __restrict__ bias, float eps,
              T* __restrict__ q, T* __restrict__ kv) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = A + K8_BM * LDA_C;
  float* sr = reinterpret_cast<float*>(Bs + 128 * (K8_BK + 16));
  const int m0 = blockIdx.x * K8_BM;
  stage_quant_rows<K8_BM, T, kBf16Ln>(x, Rows{static_cast<size_t>(m0), 1, min(K8_BM, rows - m0)},
                                      eps, 1, nullptr, nullptr, A, sr);
  __syncthreads();
  for (int n0 = 0; n0 < 3 * KC; n0 += 128) {
    int acc[K8_MT][4][4];
    tile_gemm_s8<K8_MT, K8_BK>(A, LDA_C, w, KC, n0, Bs, acc);
    T* dst = n0 < KC ? q : kv;  // 128-column tiles never straddle q | kv
    const int ld = n0 < KC ? KC : 2 * KC, c0 = n0 < KC ? 0 : KC;
#pragma unroll
    for (int mt = 0; mt < K8_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = acc_row<K8_MT>(mt, k), col = acc_col(n0, nt, k);
          if (m0 + r >= rows) continue;
          const float v = __fadd_rn(dequant(acc[mt][nt][k], sr[r], sw[col]), bias[col]);
          dst[static_cast<size_t>(m0 + r) * ld + col - c0] = from_f<T>(v);
        }
  }
}

// K9: a, x (rows, 384) -> out (rows, 384), all in the token dtype.
//   aq, sa = row quant(a); r = (x + aq . wo^T * (sa * so)) + bo        (f32)
//   hq, sh = row quant(LN(r)); u = hq . w1^T * (sh * s1) + b1; g = gelu(u)
//   gq, su = row quant(g); out = r + (gq . w2^T * (su * s2) + b2)
// r stays in shared memory as f32 and the GELU codes as int8; fc1 runs twice,
// once for the rows' absmax of g and once for the codes. 64-row tiles:
// 230,656 of the 232,448 bytes of shared memory a block may use.
constexpr int K9_MT = 2, K9_BM = 32 * K9_MT, K9_BK = 32;
constexpr int K9_SMEM = TileSmem<K9_BM, K9_BK>::kBytes;

template <typename T, bool kBf16Ln, bool kGeluFold>
__global__ void __launch_bounds__(256, 1)
attnout_mlp_kernel(const T* __restrict__ a, const T* __restrict__ x, int rows,
                   const int8_t* __restrict__ wo, const float* __restrict__ so,
                   const float* __restrict__ bo, const int8_t* __restrict__ w1,
                   const float* __restrict__ s1, const float* __restrict__ b1,
                   const int8_t* __restrict__ w2, const float* __restrict__ s2,
                   const float* __restrict__ b2, float eps, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem<K9_BM, K9_BK> s(smem);
  const int m0 = blockIdx.x * K9_BM;
  const Rows tile{static_cast<size_t>(m0), 1, min(K9_BM, rows - m0)};
  stage_quant_rows<K9_BM, T, false>(a, tile, 0.f, 0, nullptr, nullptr, s.A, s.sa);
  __syncthreads();
  stage_out_residual<K9_MT, K9_BK, T>(s.A, wo, so, bo, s.sa, x, tile, s.R, s.Bs);
  __syncthreads();
  stage_mlp_tail<K9_MT, K9_BK, T, kBf16Ln, kGeluFold>(s, w1, s1, b1, w2, s2, b2, eps, tile, out);
}

template <typename T, bool kBf16Ln>
cudaError_t launch_ln_qkv(const void* x, int rows, const int8_t* w, const float* sw,
                          const float* bias, float eps, void* q, void* kv, cudaStream_t stream) {
  auto kern = ln_qkv_kernel<T, kBf16Ln>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K8_SMEM);
  if (e != cudaSuccess) return e;
  kern<<<(rows + K8_BM - 1) / K8_BM, 256, K8_SMEM, stream>>>(
      static_cast<const T*>(x), rows, w, sw, bias, eps, static_cast<T*>(q), static_cast<T*>(kv));
  return cudaGetLastError();
}

template <typename T, bool kBf16Ln, bool kGeluFold>
cudaError_t launch_attnout_mlp(const void* a, const void* x, int rows, const int8_t* wo,
                               const float* so, const float* bo, const int8_t* w1,
                               const float* s1, const float* b1, const int8_t* w2,
                               const float* s2, const float* b2, float eps, void* out,
                               cudaStream_t stream) {
  auto kern = attnout_mlp_kernel<T, kBf16Ln, kGeluFold>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K9_SMEM);
  if (e != cudaSuccess) return e;
  kern<<<(rows + K9_BM - 1) / K9_BM, 256, K9_SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), rows, wo, so, bo, w1, s1, b1, w2, s2,
      b2, eps, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attnout_mlp_mode(int bf16_ln, int gelu_fold, const void* a, const void* x,
                                    int rows, const int8_t* wo, const float* so, const float* bo,
                                    const int8_t* w1, const float* s1, const float* b1,
                                    const int8_t* w2, const float* s2, const float* b2,
                                    float eps, void* out, cudaStream_t s) {
  if (bf16_ln)
    return gelu_fold ? launch_attnout_mlp<T, true, true>(a, x, rows, wo, so, bo, w1, s1, b1, w2,
                                                         s2, b2, eps, out, s)
                     : launch_attnout_mlp<T, true, false>(a, x, rows, wo, so, bo, w1, s1, b1,
                                                          w2, s2, b2, eps, out, s);
  return gelu_fold ? launch_attnout_mlp<T, false, true>(a, x, rows, wo, so, bo, w1, s1, b1, w2,
                                                        s2, b2, eps, out, s)
                   : launch_attnout_mlp<T, false, false>(a, x, rows, wo, so, bo, w1, s1, b1, w2,
                                                         s2, b2, eps, out, s);
}

}  // namespace ct

using namespace ct;

// All entry points return a cudaError_t code (0 = launched); the stream is
// PyTorch's current stream, passed as an opaque pointer.
extern "C" {

// mode: bit 0 the bf16 LayerNorm, bit 1 the GELU-quant fold (int8_tile.cuh).
int ct_ln_quant(const void* x, int in_bf16, int rows, int C, const float* gamma,
                const float* beta, float eps, int do_ln, int mode, int8_t* q, float* scale,
                void* stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_ln_quant_mode<__nv_bfloat16>(x, rows, C, gamma, beta, eps, do_ln, mode,
                                                       q, scale, s)
                 : launch_ln_quant_mode<float>(x, rows, C, gamma, beta, eps, do_ln, mode, q,
                                               scale, s);
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

int ct_v2p_flash(const void* q, const void* kv, const float* bias, int bf16, void* out,
                 float* part, int splits, int N, int T, int V, int H, int D, float scale,
                 void* stream) {
  if (!v2p_shape_ok(N, T, V, H, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_v2p_flash<__nv_bfloat16>(q, kv, bias, out, part, splits, N, T, V, H,
                                                scale, s)
              : launch_v2p_flash<float>(q, kv, bias, out, part, splits, N, T, V, H, scale, s);
}

int ct_k8_ln_qkv(const void* x, int bf16, int rows, int C, const int8_t* w, const float* sw,
                 const float* bias, float eps, int bf16_ln, void* q, void* kv, void* stream) {
  if (rows < 1 || C != KC) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (bf16_ln)
    return bf16 ? launch_ln_qkv<bf, true>(x, rows, w, sw, bias, eps, q, kv, s)
                : launch_ln_qkv<float, true>(x, rows, w, sw, bias, eps, q, kv, s);
  return bf16 ? launch_ln_qkv<bf, false>(x, rows, w, sw, bias, eps, q, kv, s)
              : launch_ln_qkv<float, false>(x, rows, w, sw, bias, eps, q, kv, s);
}

// K9 in float32 (bf16 takes ct_k9_tail in int8_time_block.cu).
int ct_k9_attnout_mlp(const float* a, const float* x, int rows, int C, int H, const int8_t* wo,
                      const float* so, const float* bo, const int8_t* w1, const float* s1,
                      const float* b1, const int8_t* w2, const float* s2, const float* b2,
                      float eps, int bf16_ln, int gelu_fold, float* out, void* stream) {
  if (rows < 1 || C != KC || H != KH) return cudaErrorInvalidValue;
  return launch_attnout_mlp_mode<float>(bf16_ln, gelu_fold, a, x, rows, wo, so, bo, w1, s1, b1,
                                        w2, s2, b2, eps, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
