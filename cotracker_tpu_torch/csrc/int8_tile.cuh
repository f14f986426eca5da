// Device routines shared by the W8A8 bodies (sm_90a): the LayerNorm + row
// quantization of one row, tanh-GELU, the block-level s8 tile GEMM and the
// stages of a pre-norm block's post-attention tail on a row tile held in
// shared memory. int8_blocks.cu (the K1-K3 chains, K8, K9) and
// int8_fused.cu (K10, K11, K12) build on them.
//
// Two template flags carry the JAX package's variant switches into every
// W8A8 body at once:
//   kBf16Ln    (COTRACKER_BF16_LN, mlp_int8_pallas.py::_ln): the LayerNorm
//              in bf16, in the order XLA:CPU evaluates it (the CPU tests'
//              oracle, read from its compiled HLO): x rounded to bf16;
//              mean = bf16(sum(x) * (1/C)) with an f32 sum;
//              c = bf16(x - mean); var = bf16(sum(c * c) * (1/C)) with f32
//              products and sum; inv = bf16(1 / sqrt(var + eps)); the
//              result c * inv in f32, not rounded again;
//   kGeluFold  (COTRACKER_GELU_QUANT_FOLD, ::_quant_gelu_rows): the GELU
//              codes' row scale is max(gelu(max(rowmax(a), 0)), 0.1700001)
//              / 127 from the PRE-GELU row max, not the absmax of gelu(a);
//              the codes stay rint(gelu(a) * (1/scale)).
#pragma once

#include "attention_cores.cuh"

namespace ct {

constexpr int KC = 384;         // token width
constexpr int KH = 1536;        // MLP hidden width
constexpr int LDA_C = KC + 16;  // padded row stride of C-wide codes: conflict-free fragments
constexpr int LDA_H = KH + 16;  // the same for the hidden codes

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, x3));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// The GELU-quant fold's row scale from m = max(rowmax(a), 0).
__device__ __forceinline__ float gelu_fold_scale(float m) {
  return __fmul_rn(fmaxf(gelu_tanh(m), 0.1700001f), 1.0f / 127.0f);
}

// One warp quantizes one row xr of C = 32 * VPL values (device or shared
// memory): optional LayerNorm, the optional affine v * gamma + beta, then
// per-row int8 codes into qr (device or shared memory). Returns the row
// scale. do_ln = 0 quantizes the row as is. kGeluFold quantizes gelu(v)
// with the fold's scale instead of v with its absmax.
template <typename InT, int VPL, bool kBf16Ln = false, bool kGeluFold = false>
__device__ __forceinline__ float ln_quant_row(const InT* xr, int lane,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, float eps,
                                              int do_ln, int8_t* qr) {
  constexpr int C = 32 * VPL;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = to_f(xr[lane + 32 * i]);
  if (do_ln) {
    if (kBf16Ln) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        v[i] = bf16_round(v[i]);
        s = __fadd_rn(s, v[i]);
      }
      const float mean = bf16_round(__fmul_rn(warp_sum(s), 1.0f / C));
      float s2 = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        v[i] = bf16_round(__fsub_rn(v[i], mean));
        s2 = __fadd_rn(s2, __fmul_rn(v[i], v[i]));
      }
      const float var = bf16_round(__fmul_rn(warp_sum(s2), 1.0f / C));
      const float inv = bf16_round(1.0f / sqrtf(__fadd_rn(var, eps)));
#pragma unroll
      for (int i = 0; i < VPL; ++i) v[i] = __fmul_rn(v[i], inv);
    } else {
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
      for (int i = 0; i < VPL; ++i) v[i] = __fmul_rn(v[i], inv);
    }
  }
  if (gamma != nullptr) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = __fadd_rn(__fmul_rn(v[i], gamma[c]), beta[c]);
    }
  }
  if (kGeluFold) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) m = fmaxf(m, v[i]);
    const float s = gelu_fold_scale(__fadd_rn(warp_max(m), 0.f));
    const float inv = 1.0f / s;
#pragma unroll
    for (int i = 0; i < VPL; ++i) qr[lane + 32 * i] = quant8(gelu_tanh(v[i]), inv);
    return s;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-20f), 1.0f / 127.0f);
  const float inv = 1.0f / s;
#pragma unroll
  for (int i = 0; i < VPL; ++i) qr[lane + 32 * i] = quant8(v[i], inv);
  return s;
}

// acc = A[tile rows, 0:K) . W[n0:n0+128, 0:K)^T over a (32 * MT) x 128
// output tile: the 8 warps as 2 (rows) x 4 (columns), warp tiles
// (16 * MT) x 32 of mma.sync m16n8k32. A in shared memory (row stride lda
// bytes), W K-contiguous in device memory, staged through Bs 128 x (BK + 16)
// BK bytes of K at a time.
template <int MT, int BK>
__device__ __forceinline__ void tile_gemm_s8(const int8_t* A, int lda,
                                             const int8_t* __restrict__ W, int K, int n0,
                                             int8_t* Bs, int (&acc)[MT][4][4]) {
  constexpr int LDB = BK + 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < 128 * (BK / 16); i += 256) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      *reinterpret_cast<int4*>(Bs + r * LDB + c) =
          *reinterpret_cast<const int4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* p = A + (wm * 16 * MT + mt * 16 + g) * lda + k0 + kk + t4 * 4;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * lda);
        af[mt][2] = ld32(p + 16);
        af[mt][3] = ld32(p + 8 * lda + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = Bs + (wn * 32 + nt * 8 + g) * LDB + kk + t4 * 4;
        bfr[nt][0] = ld32(p);
        bfr[nt][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }
}

// Dequantized product of one accumulator: acc * (row scale * column scale).
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(static_cast<float>(acc), __fmul_rn(s_row, s_col));
}

// Position of accumulator (mt, nt, k) of tile_gemm_s8 in its output tile.
template <int MT>
__device__ __forceinline__ int acc_row(int mt, int k) {
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) >> 2;
  return wm * 16 * MT + mt * 16 + (lane >> 2) + (k >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int n0, int nt, int k) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
  return n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + (k & 1);
}

// Row i < n of a tile <-> device row base + i * stride (stride 1 for a
// contiguous run of tokens, T for one frame of consecutive tracks).
struct Rows {
  size_t base, stride;
  int n;
  __device__ __forceinline__ size_t operator()(int i) const {
    return base + static_cast<size_t>(i) * stride;
  }
};

// ------------------------------------------------ stages of a row tile
// Each stage ends with its results in shared memory or device memory and
// starts no earlier than the caller's __syncthreads after the previous one.

// A[i] <- codes of (LN(x[row i]) [* gamma + beta]) and s[i] its row scale;
// rows past rows.n get zero codes and scale 0. x rows of KC values.
template <int BM, typename T, bool kBf16Ln>
__device__ __forceinline__ void stage_quant_rows(const T* x, Rows rows, float eps, int do_ln,
                                                 const float* gamma, const float* beta,
                                                 int8_t* A, float* s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += 8) {
    if (r < rows.n) {
      const float sc = ln_quant_row<T, KC / 32, kBf16Ln>(x + rows(r) * KC, lane, gamma, beta,
                                                         eps, do_ln, A + r * LDA_C);
      if (lane == 0) s[r] = sc;
    } else {
      for (int i = lane; i < KC; i += 32) A[r * LDA_C + i] = 0;
      if (lane == 0) s[r] = 0.f;
    }
  }
}

// R[i] = (x[row i] + A[i] . wo^T * (sa[i] * so)) + bo in f32 (x taken as 0
// past rows.n).
template <int MT, int BK, typename T>
__device__ __forceinline__ void stage_out_residual(const int8_t* A, const int8_t* __restrict__ wo,
                                                   const float* __restrict__ so,
                                                   const float* __restrict__ bo,
                                                   const float* sa, const T* __restrict__ x,
                                                   Rows rows, float* R, int8_t* Bs) {
  for (int n0 = 0; n0 < KC; n0 += 128) {
    int acc[MT][4][4];
    tile_gemm_s8<MT, BK>(A, LDA_C, wo, KC, n0, Bs, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = acc_row<MT>(mt, k), col = acc_col(n0, nt, k);
          const float xv = r < rows.n ? to_f(x[rows(r) * KC + col]) : 0.f;
          R[r * KC + col] = __fadd_rn(__fadd_rn(xv, dequant(acc[mt][nt][k], sa[r], so[col])),
                                      bo[col]);
        }
  }
}

// U[i] <- codes of gelu(A[i] . w1^T * (sh[i] * s1) + b1), su / iu the row
// scales and their reciprocals. fc1 runs twice: once for the rows' absmax
// of gelu (kGeluFold: the max of the pre-GELU values and 0), once for the
// codes.
template <int MT, int BK, bool kGeluFold>
__device__ __forceinline__ void stage_fc1_gelu(const int8_t* A, const int8_t* __restrict__ w1,
                                               const float* __restrict__ s1,
                                               const float* __restrict__ b1, const float* sh,
                                               int8_t* U, float* su, float* iu, unsigned* amax,
                                               int8_t* Bs) {
  constexpr int BM = 32 * MT;
  const int tid = threadIdx.x, t4 = tid & 3;
  if (tid < BM) amax[tid] = 0u;  // visible after tile_gemm_s8's first barrier
  for (int pass = 0; pass < 2; ++pass) {
    for (int n0 = 0; n0 < KH; n0 += 128) {
      int acc[MT][4][4];
      tile_gemm_s8<MT, BK>(A, LDA_C, w1, KC, n0, Bs, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = acc_row<MT>(mt, half * 2);
          float m = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int k = half * 2 + j, col = acc_col(n0, nt, k);
              const float pre = __fadd_rn(dequant(acc[mt][nt][k], sh[r], s1[col]), b1[col]);
              if (pass == 0)
                m = kGeluFold ? fmaxf(m, pre) : fmaxf(m, fabsf(gelu_tanh(pre)));
              else
                U[r * LDA_H + col] = quant8(gelu_tanh(pre), iu[r]);
            }
          }
          if (pass == 0) {
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            // m >= 0 (+0 after the add): ordered as unsigned bits
            if (t4 == 0) atomicMax(amax + r, __float_as_uint(__fadd_rn(m, 0.f)));
          }
        }
      }
    }
    __syncthreads();
    if (pass == 0 && tid < BM) {
      const float m = __uint_as_float(amax[tid]);
      su[tid] = kGeluFold ? gelu_fold_scale(m) : __fmul_rn(fmaxf(m, 1e-20f), 1.0f / 127.0f);
      iu[tid] = 1.0f / su[tid];
    }
    __syncthreads();
  }
}

// out[row i] = R[i] + (U[i] . w2^T * (su[i] * s2) + b2), rows i < rows.n.
template <int MT, int BK, typename T>
__device__ __forceinline__ void stage_fc2_out(const int8_t* U, const int8_t* __restrict__ w2,
                                              const float* __restrict__ s2,
                                              const float* __restrict__ b2, const float* su,
                                              const float* R, Rows rows, T* __restrict__ out,
                                              int8_t* Bs) {
  for (int n0 = 0; n0 < KC; n0 += 128) {
    int acc[MT][4][4];
    tile_gemm_s8<MT, BK>(U, LDA_H, w2, KH, n0, Bs, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = acc_row<MT>(mt, k), col = acc_col(n0, nt, k);
          if (r >= rows.n) continue;
          const float y = __fadd_rn(dequant(acc[mt][nt][k], su[r], s2[col]), b2[col]);
          out[rows(r) * KC + col] = from_f<T>(__fadd_rn(R[r * KC + col], y));
        }
  }
}

// The shared memory of a row tile of BM rows through the MLP tail:
//   R  (BM, KC) f32 residual      U  (BM, LDA_H) GELU codes
//   A  (BM, LDA_C) codes          Bs 128 x (BK + 16) weight slice
//   five (BM,) scale vectors
template <int BM, int BK>
struct TileSmem {
  static constexpr int kBytes =
      BM * KC * 4 + BM * LDA_H + BM * LDA_C + 128 * (BK + 16) + 5 * BM * 4;
  float* R;
  int8_t *U, *A, *Bs;
  float *sa, *sh, *su, *iu;
  unsigned* amax;
  __device__ explicit TileSmem(unsigned char* smem) {
    R = reinterpret_cast<float*>(smem);
    U = reinterpret_cast<int8_t*>(R + BM * KC);
    A = U + BM * LDA_H;
    Bs = A + BM * LDA_C;
    sa = reinterpret_cast<float*>(Bs + 128 * (BK + 16));
    sh = sa + BM;
    su = sh + BM;
    iu = su + BM;
    amax = reinterpret_cast<unsigned*>(iu + BM);
  }
};

// The MLP tail after R holds the residual stream of the tile's rows:
//   A, sh <- codes of LN(R); U <- gelu codes of fc1; out = R + fc2(U).
template <int MT, int BK, typename T, bool kBf16Ln, bool kGeluFold>
__device__ __forceinline__ void stage_mlp_tail(const TileSmem<32 * MT, BK>& s,
                                               const int8_t* w1, const float* s1,
                                               const float* b1, const int8_t* w2,
                                               const float* s2, const float* b2, float eps,
                                               Rows rows, T* out) {
  constexpr int BM = 32 * MT;
  stage_quant_rows<BM, float, kBf16Ln>(s.R, Rows{0, 1, BM}, eps, 1, nullptr, nullptr, s.A, s.sh);
  __syncthreads();
  stage_fc1_gelu<MT, BK, kGeluFold>(s.A, w1, s1, b1, s.sh, s.U, s.su, s.iu, s.amax, s.Bs);
  stage_fc2_out<MT, BK, T>(s.U, w2, s2, b2, s.su, s.R, rows, out, s.Bs);
}

// ------------------------------------------ streamed products and barriers
// The weight-streaming GEMM of the fused W8A8 kernels (K1's front,
// int8_time_block.cu; K2's front; K3, int8_v2p_proj.cu) and the mbarrier
// helpers of K1's tail stream and of the fronts' bulk row copies.

// One warp's products over BK bytes of K: acc[MI][NI] += the warp's A rows
// (a: this K slice of its first row's ldmatrix address, row stride lda) x
// the stage's B rows (b: the stage's base; b_pair / b_last the lane's
// ldmatrix offsets of the column-tile pairs and of an odd last tile).
template <int MI, int NI, int BK, int LDB>
__device__ __forceinline__ void warp_mma(int (&acc)[MI][NI][4], const int8_t* a, int lda,
                                         const int8_t* b, int b_pair, int b_last) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) ldsm_x4(af[mi], a + mi * 16 * lda + kk);
#pragma unroll
    for (int ni = 0; ni + 1 < NI; ni += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + b_pair + ni * 8 * LDB + kk);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_s8_16832(acc[mi][ni], af[mi], bf);
        mma_s8_16832(acc[mi][ni + 1], af[mi], bf + 2);
      }
    }
    if constexpr (NI % 2 == 1) {
      uint32_t bf[2];
      ldsm_x2(bf, b + b_last + kk);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma_s8_16832(acc[mi][NI - 1], af[mi], bf);
    }
  }
}

// ------------------------------------------------------------- RingGemm
// acc[MI][NI][4] (+)= A[rows, 0:K) . W[col(n), 0:K)^T over a block tile of
// (MW * 16 * MI) rows x BN = NW * 8 * NI columns; the block's MW x NW warps,
// warp tiles (16 * MI) x (8 * NI) of mma.sync m16n8k32. A: int8 codes in shared
// memory, row stride lda (lda % 128 == 16: the 8 rows of an ldmatrix hit 8
// different 16-byte bank groups). W: K-contiguous int8 rows in device
// memory, wrow(n) the row of output column n, streamed BK bytes of K at a
// time through STAGES ring buffers of BN x (BK + 16) bytes by cp.async.
// prefetch() issues the first STAGES - 1 stages (no other cp.async group
// may be committed between it and run()); run() waits for them, keeps
// STAGES - 1 stages in flight, and ends with the ring free (every copy
// landed, every warp past its last read).
template <int MW, int NW, int MI, int NI, int BK, int STAGES>
struct RingGemm {
  static_assert(BK % 32 == 0 && STAGES >= 2, "k32 steps");
  static constexpr int kThreads = 32 * MW * NW;
  static constexpr int BM = MW * 16 * MI, BN = NW * NI * 8, LDB = BK + 16, STAGE = BN * LDB;
  static constexpr int CH = BK / 16, kMI = MI, kNI = NI, kRingBytes = STAGES * STAGE;

  template <typename WRow>
  __device__ static void load(WRow wrow, int kt, int8_t* buf) {
    for (int i = threadIdx.x; i < BN * CH; i += kThreads) {
      const int n = i / CH, c = i - n * CH;
      cp_async16(buf + n * LDB + 16 * c, wrow(n) + kt * BK + 16 * c, true);
    }
  }

  template <typename WRow>
  __device__ static void prefetch(WRow wrow, int K, int8_t* ring) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < K / BK) load(wrow, s, ring + s * STAGE);
      cp_async_commit();
    }
  }

  template <bool kZero, typename WRow>
  __device__ static void run(const int8_t* A, int lda, int K, WRow wrow, int8_t* ring,
                             int (&acc)[MI][NI][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / NW, wn = warp % NW;
    if constexpr (kZero) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
    }
    const int8_t* a_base = A + (wm * 16 * MI + (lane & 15)) * lda + (lane >> 4) * 16;
    const int b_off = (wn * 8 * NI + (lane >> 4) * 8 + (lane & 7)) * LDB + ((lane >> 3) & 1) * 16;
    const int b_last = (wn * 8 * NI + 8 * (NI - 1) + (lane & 7)) * LDB + ((lane >> 3) & 1) * 16;
    const int KT = K / BK;
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nx = kt + STAGES - 1;
      if (nx < KT) load(wrow, nx, ring + (nx % STAGES) * STAGE);
      cp_async_commit();
      warp_mma<MI, NI, BK, LDB>(acc, a_base + kt * BK, lda, ring + (kt % STAGES) * STAGE, b_off,
                                b_last);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // Position of accumulator (mi, ni, k) in the block tile.
  __device__ static int row(int mi, int k) {
    const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / NW;
    return wm * 16 * MI + mi * 16 + (lane >> 2) + (k >> 1) * 8;
  }
  __device__ static int col(int ni, int k) {
    const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) % NW;
    return wn * 8 * NI + ni * 8 + (lane & 3) * 2 + (k & 1);
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
// Waits for the phase of parity `parity` to complete; a wait that never ends
// (a lost arrival) traps, so a fault fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  for (long long spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 24)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// arrives on b once every cp.async this thread issued before has landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// One bulk copy (the Tensor Memory Accelerator's 1D form) of `bytes` (a
// multiple of 16, both addresses 16-byte aligned) from device memory to
// this block's shared memory; its bytes complete the transaction count of
// mbarrier b, whose phase the caller armed with mbar_expect_tx.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}
// arrives on b (count 1) expecting `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// orders this thread's shared-memory accesses before later bulk copies
// (the async proxy) and makes an initialized mbarrier visible to them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

}  // namespace ct
