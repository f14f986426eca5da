// K10, K11, K12: the last three W8A8 bodies of the JAX package (sm_90a),
// one launch each, on the shared routines of int8_tile.cuh.
//
//   K10 ct_k10_ln_dense   replaces mlp_int8_pallas.py::_dense_kernel
//       [x +] (LN(x) [* gamma + beta]) @ W + b, W8A8 (fused_ln_dense_int8).
//       128-row tiles as K8: one read of x, LN (optional), the optional
//       affine, row quantization into shared memory (51 KB of codes), then
//       every 128-column tile of W through tile_gemm_s8; the epilogue
//       (acc * (s_row * s_w) + b) [+ x] in f32, in that order.
//   K11 ct_k11_space_allt replaces mlp_int8_pallas.py::_space_block_allt_kernel
//       the whole points<-virtual block (K2's function: q rounded to the kv
//       dtype, the attention output kept in f32 before its quantization, the
//       MLP row-wise) on a tile of 64 tracks x ALL frames, one block per
//       tile looping over the frames; per frame the 64 rows (the tracks at
//       that frame) go through LN + quant, to_q, the attention over the
//       frame's V virtual keys|values (staged one head at a time), to_out +
//       residual, LN + quant, fc1 + GELU, fc2 + residual with everything in
//       shared memory. Shared memory (64 rows): the f32 residual R
//       (98,304 B; it holds q, then the attention output, then r: a warp
//       reads its query row of a head into registers before it writes that
//       head's output over it), the GELU codes U (99,328 B; the staged keys
//       and values, 64 x 97 floats, and the 8 warps' score rows live there
//       during the attention), the C-wide codes A (25,600 B), a 128 x 48
//       weight slice (6,144 B) and five row-scale vectors (1,280 B):
//       230,656 of the 232,448 bytes a block may use, as K9.
//   K12 ct_k12_ln_mlp     replaces mlp_int8_pallas.py::_mlp_kernel
//       x + fc2(gelu(fc1(LN(x)))) (LN optional), W8A8: K9 without its
//       to_out stage (r = x), 64-row tiles, the same 230,656 bytes.
//
// What bounds them. At the micro-benchmark's 604,800 bf16 rows of 384:
// K10 to_qkv (384 -> 1,152) moves 3,072 B a row for 0.88 M int8
// operations (bytes-bound, as K8), K12 768 B a row for 2.36 M operations
// (compute-bound: ~0.72 ms at the int8 peak). K11 at 70,656 tracks x 16
// frames: 2.95 M operations a row (compute-bound), and its first version
// re-reads the 1.47 MB of weights from L2 for every 64-row step, runs fc1
// twice (1.45x its GEMM operations) and its attention on the CUDA cores.
// All three keep the bf16-LayerNorm and GELU-quant-fold variants as
// template flags.

#include "int8_tile.cuh"

namespace ct {

// ---------------------------------------------------------------- K10
constexpr int K10_MT = 4, K10_BM = 32 * K10_MT, K10_BK = 64;
constexpr int K10_SMEM = K10_BM * LDA_C + 128 * (K10_BK + 16) + K10_BM * 4;

template <typename T, bool kBf16Ln>
__global__ void __launch_bounds__(256)
ln_dense_kernel(const T* __restrict__ x, int rows, int N, const int8_t* __restrict__ w,
                const float* __restrict__ sw, const float* __restrict__ bias,
                const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                int do_ln, int residual, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = A + K10_BM * LDA_C;
  float* sr = reinterpret_cast<float*>(Bs + 128 * (K10_BK + 16));
  const int m0 = blockIdx.x * K10_BM;
  stage_quant_rows<K10_BM, T, kBf16Ln>(x, Rows{static_cast<size_t>(m0), 1, min(K10_BM, rows - m0)},
                                       eps, do_ln, gamma, beta, A, sr);
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += 128) {
    int acc[K10_MT][4][4];
    tile_gemm_s8<K10_MT, K10_BK>(A, LDA_C, w, KC, n0, Bs, acc);
#pragma unroll
    for (int mt = 0; mt < K10_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = acc_row<K10_MT>(mt, k), col = acc_col(n0, nt, k);
          if (m0 + r >= rows) continue;
          const size_t row = static_cast<size_t>(m0 + r);
          float y = __fadd_rn(dequant(acc[mt][nt][k], sr[r], sw[col]), bias[col]);
          if (residual) y = __fadd_rn(y, to_f(x[row * KC + col]));
          out[row * N + col] = from_f<T>(y);
        }
  }
}

// ---------------------------------------------------------------- K11
constexpr int K11_MT = 2, K11_BM = 32 * K11_MT, K11_BK = 32, K11_MAX_V = 128;
constexpr int K11_SMEM = TileSmem<K11_BM, K11_BK>::kBytes;
static_assert(K11_MAX_V * (2 * kDimHead + 1 + 8) * 4 <= K11_BM * LDA_H,
              "the staged keys, values and score rows fit the GELU-code buffer");

template <typename T, bool kBf16Ln, bool kGeluFold>
__global__ void __launch_bounds__(256, 1)
space_block_allt_kernel(const T* __restrict__ x, const T* __restrict__ kv, int N, int Tn, int V,
                        const int8_t* __restrict__ wq, const float* __restrict__ sq,
                        const float* __restrict__ bq, const int8_t* __restrict__ wo,
                        const float* __restrict__ so, const float* __restrict__ bo,
                        const int8_t* __restrict__ w1, const float* __restrict__ s1,
                        const float* __restrict__ b1, const int8_t* __restrict__ w2,
                        const float* __restrict__ s2, const float* __restrict__ b2, float eps,
                        float scale, T* __restrict__ out) {
  constexpr int D = kDimHead, LK = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem<K11_BM, K11_BK> s(smem);
  float* ks = reinterpret_cast<float*>(s.U);  // V * LK, during the attention
  float* vs = ks + V * LK;                    // V * D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * K11_BM;
  float* p = vs + V * D + warp * V;
  for (int t = 0; t < Tn; ++t) {
    const Rows tile{static_cast<size_t>(n0) * Tn + t, static_cast<size_t>(Tn),
                    min(K11_BM, N - n0)};
    // q = to_q(LN(x)) rounded to the kv dtype, into R
    stage_quant_rows<K11_BM, T, kBf16Ln>(x, tile, eps, 1, nullptr, nullptr, s.A, s.sh);
    __syncthreads();
    for (int c0 = 0; c0 < KC; c0 += 128) {
      int acc[K11_MT][4][4];
      tile_gemm_s8<K11_MT, K11_BK>(s.A, LDA_C, wq, KC, c0, s.Bs, acc);
#pragma unroll
      for (int mt = 0; mt < K11_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = acc_row<K11_MT>(mt, k), col = acc_col(c0, nt, k);
            s.R[r * KC + col] = to_f(from_f<T>(
                __fadd_rn(dequant(acc[mt][nt][k], s.sh[r], sq[col]), bq[col])));
          }
    }
    __syncthreads();
    // the attention over frame t's V virtual tokens, one head at a time
    const T* kvt = kv + static_cast<size_t>(t) * V * 2 * KC;
    for (int h = 0; h < KC / D; ++h) {
      stage_head_kv(kvt + h * D, V, KC, ks, vs);
      __syncthreads();
      for (int r = warp; r < K11_BM; r += 8) {
        float* row = s.R + r * KC + h * D;
        float qv[D];
#pragma unroll
        for (int d = 0; d < D; ++d) qv[d] = row[d];
        float a0, a1;
        attend_staged<T>(qv, ks, vs, p, V, scale, a0, a1);
        row[lane] = a0;
        if (lane < D - 32) row[lane + 32] = a1;
        __syncwarp();
      }
      __syncthreads();
    }
    // r = x + to_out(a), then the MLP tail
    stage_quant_rows<K11_BM, float, false>(s.R, Rows{0, 1, K11_BM}, 0.f, 0, nullptr, nullptr,
                                           s.A, s.sa);
    __syncthreads();
    stage_out_residual<K11_MT, K11_BK, T>(s.A, wo, so, bo, s.sa, x, tile, s.R, s.Bs);
    __syncthreads();
    stage_mlp_tail<K11_MT, K11_BK, T, kBf16Ln, kGeluFold>(s, w1, s1, b1, w2, s2, b2, eps, tile,
                                                          out);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K12
constexpr int K12_MT = 2, K12_BM = 32 * K12_MT, K12_BK = 32;
constexpr int K12_SMEM = TileSmem<K12_BM, K12_BK>::kBytes;

template <typename T, bool kBf16Ln, bool kGeluFold>
__global__ void __launch_bounds__(256, 1)
ln_mlp_kernel(const T* __restrict__ x, int rows, int do_ln, const int8_t* __restrict__ w1,
              const float* __restrict__ s1, const float* __restrict__ b1,
              const int8_t* __restrict__ w2, const float* __restrict__ s2,
              const float* __restrict__ b2, float eps, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem<K12_BM, K12_BK> s(smem);
  const int m0 = blockIdx.x * K12_BM;
  const Rows tile{static_cast<size_t>(m0), 1, min(K12_BM, rows - m0)};
  for (int i = threadIdx.x; i < K12_BM * KC; i += blockDim.x) {
    const int r = i / KC;
    s.R[i] = r < tile.n ? to_f(x[tile(r) * KC + (i - r * KC)]) : 0.f;
  }
  stage_quant_rows<K12_BM, T, kBf16Ln>(x, tile, eps, do_ln, nullptr, nullptr, s.A, s.sh);
  __syncthreads();
  stage_fc1_gelu<K12_MT, K12_BK, kGeluFold>(s.A, w1, s1, b1, s.sh, s.U, s.su, s.iu, s.amax, s.Bs);
  stage_fc2_out<K12_MT, K12_BK, T>(s.U, w2, s2, b2, s.su, s.R, tile, out, s.Bs);
}

// ---------------------------------------------------------------- launchers
// One struct per kernel: run<T, kBf16Ln, kGeluFold>(...) sets its shared
// memory and launches it; `dispatch` picks the instantiation for the runtime
// flags.
struct K10 {
  template <typename T, bool kBf16Ln, bool kGeluFold>
  static cudaError_t run(const void* x, int rows, int N, const int8_t* w, const float* sw,
                         const float* bias, const float* gamma, const float* beta, float eps,
                         int do_ln, int residual, void* out, cudaStream_t s) {
    auto kern = ln_dense_kernel<T, kBf16Ln>;
    cudaError_t e = set_smem(kern, K10_SMEM);
    if (e != cudaSuccess) return e;
    kern<<<(rows + K10_BM - 1) / K10_BM, 256, K10_SMEM, s>>>(
        static_cast<const T*>(x), rows, N, w, sw, bias, gamma, beta, eps, do_ln, residual,
        static_cast<T*>(out));
    return cudaGetLastError();
  }
};

struct K11 {
  template <typename T, bool kBf16Ln, bool kGeluFold>
  static cudaError_t run(const void* x, const void* kv, int N, int Tn, int V, const int8_t* wq,
                         const float* sq, const float* bq, const int8_t* wo, const float* so,
                         const float* bo, const int8_t* w1, const float* s1, const float* b1,
                         const int8_t* w2, const float* s2, const float* b2, float eps,
                         float scale, void* out, cudaStream_t s) {
    auto kern = space_block_allt_kernel<T, kBf16Ln, kGeluFold>;
    cudaError_t e = set_smem(kern, K11_SMEM);
    if (e != cudaSuccess) return e;
    kern<<<(N + K11_BM - 1) / K11_BM, 256, K11_SMEM, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(kv), N, Tn, V, wq, sq, bq, wo, so, bo,
        w1, s1, b1, w2, s2, b2, eps, scale, static_cast<T*>(out));
    return cudaGetLastError();
  }
};

struct K12 {
  template <typename T, bool kBf16Ln, bool kGeluFold>
  static cudaError_t run(const void* x, int rows, int do_ln, const int8_t* w1, const float* s1,
                         const float* b1, const int8_t* w2, const float* s2, const float* b2,
                         float eps, void* out, cudaStream_t s) {
    auto kern = ln_mlp_kernel<T, kBf16Ln, kGeluFold>;
    cudaError_t e = set_smem(kern, K12_SMEM);
    if (e != cudaSuccess) return e;
    kern<<<(rows + K12_BM - 1) / K12_BM, 256, K12_SMEM, s>>>(
        static_cast<const T*>(x), rows, do_ln, w1, s1, b1, w2, s2, b2, eps,
        static_cast<T*>(out));
    return cudaGetLastError();
  }
};

template <typename K, typename T, typename... Args>
cudaError_t dispatch_modes(int bf16_ln, int gelu_fold, Args... args) {
  if (bf16_ln)
    return gelu_fold ? K::template run<T, true, true>(args...)
                     : K::template run<T, true, false>(args...);
  return gelu_fold ? K::template run<T, false, true>(args...)
                   : K::template run<T, false, false>(args...);
}

template <typename K, typename... Args>
cudaError_t dispatch(int bf16, int bf16_ln, int gelu_fold, Args... args) {
  return bf16 ? dispatch_modes<K, __nv_bfloat16>(bf16_ln, gelu_fold, args...)
              : dispatch_modes<K, float>(bf16_ln, gelu_fold, args...);
}

}  // namespace ct

using namespace ct;

// Every entry returns a cudaError_t code (0 = launched); the stream is
// PyTorch's current stream. bf16: tokens in bfloat16 (else float32);
// bf16_ln / gelu_fold: the two variant flags.
extern "C" {

int ct_k10_ln_dense(const void* x, int bf16, int rows, int C, int N, const int8_t* w,
                    const float* sw, const float* bias, const float* gamma, const float* beta,
                    float eps, int do_ln, int residual, int bf16_ln, void* out, void* stream) {
  if (rows < 1 || C != KC || N < 128 || N % 128 != 0 || (residual && N != C))
    return cudaErrorInvalidValue;
  // K10 has no GELU: its fold flag is always off
  return dispatch<K10>(bf16, bf16_ln, 0, x, rows, N, w, sw, bias, gamma, beta, eps, do_ln,
                       residual, out, static_cast<cudaStream_t>(stream));
}

int ct_k11_space_allt(const void* x, const void* kv, int bf16, int N, int T, int V, int C,
                      const int8_t* wq, const float* sq, const float* bq, const int8_t* wo,
                      const float* so, const float* bo, const int8_t* w1, const float* s1,
                      const float* b1, const int8_t* w2, const float* s2, const float* b2,
                      float eps, float scale, int bf16_ln, int gelu_fold, void* out,
                      void* stream) {
  if (N < 1 || T < 1 || V < 1 || V > K11_MAX_V || C != KC) return cudaErrorInvalidValue;
  return dispatch<K11>(bf16, bf16_ln, gelu_fold, x, kv, N, T, V, wq, sq, bq, wo, so, bo, w1, s1,
                       b1, w2, s2, b2, eps, scale, out, static_cast<cudaStream_t>(stream));
}

int ct_k12_ln_mlp(const void* x, int bf16, int rows, int C, int H, int do_ln, const int8_t* w1,
                  const float* s1, const float* b1, const int8_t* w2, const float* s2,
                  const float* b2, float eps, int bf16_ln, int gelu_fold, void* out,
                  void* stream) {
  if (rows < 1 || C != KC || H != KH) return cudaErrorInvalidValue;
  return dispatch<K12>(bf16, bf16_ln, gelu_fold, x, rows, do_ln, w1, s1, b1, w2, s2, b2, eps,
                       out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
