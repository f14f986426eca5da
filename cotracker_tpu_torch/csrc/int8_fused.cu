// K10's and K12's first bodies: two W8A8 bodies of the JAX package (sm_90a),
// one launch each, on the shared routines of int8_tile.cuh.
//
//   K10 ct_k10_ln_dense   the first body of mlp_int8_pallas.py::_dense_kernel
//       [x +] (LN(x) [* gamma + beta]) @ W + b, W8A8 (fused_ln_dense_int8).
//       128-row tiles as K8's first body: one read of x, LN (optional), the
//       optional affine, row quantization into shared memory (51 KB of
//       codes), then every 128-column tile of W through tile_gemm_s8; the
//       epilogue (acc * (s_row * s_w) + b) [+ x] in f32, in that order. It
//       is K10's route for float32 tokens; bfloat16 tokens take K8's
//       streamed body (int8_time_block.cu, ct_k10_stream), which is held to
//       this one bit for bit (mlp_int8_cuda._ln_dense_first).
//   K12 ct_k12_ln_mlp     the first body of mlp_int8_pallas.py::_mlp_kernel
//       x + fc2(gelu(fc1(LN(x)))) (LN optional), W8A8: K9's f32 body
//       (int8_blocks.cu) without its to_out stage (r = x), 64-row tiles,
//       one block each, 230,656 bytes of shared memory. K12 runs
//       int8_mlp_cluster.cu's cluster body; this one stays as the
//       yardstick that body is held to bit for bit
//       (mlp_int8_cuda._ln_mlp_first).
//
// What bounds them. At the micro-benchmark's 604,800 bf16 rows of 384:
// K10 to_qkv (384 -> 1,152) moves 3,072 B a row for 0.88 M int8
// operations (bytes-bound, as K8); this body (4.19 ms there) stages every
// weight slice synchronously and stores each 2-byte element on its own.
// K12 moves 768 B a row for 2.36 M operations (compute-bound: ~0.72 ms at
// the int8 peak); K12's first body re-reads the 1.18 MB of weights from L2
// for every 64-row tile and runs fc1 twice. Both keep the bf16-LayerNorm and
// GELU-quant-fold variants as template flags.

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

int ct_k12_ln_mlp(const void* x, int bf16, int rows, int C, int H, int do_ln, const int8_t* w1,
                  const float* s1, const float* b1, const int8_t* w2, const float* s2,
                  const float* b2, float eps, int bf16_ln, int gelu_fold, void* out,
                  void* stream) {
  if (rows < 1 || C != KC || H != KH) return cudaErrorInvalidValue;
  return dispatch<K12>(bf16, bf16_ln, gelu_fold, x, rows, do_ln, w1, s1, b1, w2, s2, b2, eps,
                       out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
