// K3 on Hopper: virtual<-points attention with the context norm and the
// W8A8 key|value projection fused in, one pass (sm_90a).
//
// Replaces, on the H100, the Pallas body
//   cotracker_tpu/ops/kernels/attention_pallas.py::_v2p_proj_kernel
// (wrapper fused_virtual_from_points_proj) for bfloat16 tokens, driven
// from ops/kernels/attention_cuda.py (the plan: k3_plan). float32 tokens
// keep the launch chain of int8_blocks.cu (ct_ln_quant -> ct_gemm_s8 ->
// ct_v2p_flash).
//
// Contract (v2p_proj_plain): per frame t the V virtual queries attend over
// all N point tokens, whose keys|values are to_kv(LN(x) * gamma + beta),
// LN two-pass f32 with eps 1e-5 (no bf16 variant), per-row int8 codes
// rint(h * (1/scale)), per-channel int8 weights, dequant + bias rounded to
// the query dtype; then K7's flash step: f32 logits s = (q.k) * scale +
// key_bias, running max from -0.7 * FLT_MAX (a row whose keys are all
// masked stays finite: the plain average of the values), keys past the
// range -inf, the unnormalized probabilities rounded to bf16 before P.V,
// f32 row sums of the unrounded ones; key ranges merged by K7's
// v2p_merge_kernel (unchanged), one rounding of the result to bf16.
//
// Its bound is int8 operations (0.24 ms at the bench shape). At 10,240
// points x 60 frames the projection is 0.36 T int8 operations (~0.18 ms at
// 1,979 TOP/s) and the attention 60 GFLOP of bf16 (0.06 ms); the point
// tokens are 0.47 GB (0.14 ms at 3.35 TB/s). The chain it replaces wrote the projected
// kv (N*T x 768 bf16, 0.94 GB) to device memory and read it back in a
// separate flash launch, after an LN launch and a first-version GEMM. Here
// kv never leaves the chip:
//   * a block takes (frame, key range, group of heads), with the frame's 64
//     queries of its heads staged once (K6's interleaved layout); per tile of
//     64 points its x rows arrive by bulk copies (the next tile's issued as
//     this one starts), LN + affine + row quant go to shared memory, and per
//     head pair the tile's k|v columns (192) come from the int8 tensor cores
//     (K3KvGemm: mma.sync m16n8k32 from a cp.async weight ring, the next
//     pair's first stages issued before this pair's epilogue), rounded to
//     bf16 into the keys' and values' interleaved tiles;
//   * K7's online-softmax step then runs on mma.sync m16n8k16 for the
//     pair: warp w takes queries 16 (w % 4).. of head 2p + w / 4 and keeps
//     its accumulators, maxima and sums of every pair in registers across
//     the whole key range;
//   * the weights (295 KB) are read from L2 once per 64-point tile and
//     head group (~2.8 GB at the bench shape), through 3 stages of 128
//     bytes of K (192 x 144 bytes each).
// One launch where the plan keeps one key range (its block writes the
// bf16 result), else the partials go to v2p_merge_kernel: two launches.
// Key ranges hold at least 2,048 points (a range rounds its probabilities
// against its own running max), chosen with the head groups (8 heads a
// block, 231,952 bytes of shared memory, or 4, 207,376) by k3_plan to fill
// the SMs, one block each.
// What bounds it now (scripts/torch_k3_parts.py: copies with one part
// compiled out, one NVIDIA H100 80GB HBM3 at 700 W): 2.21 ms at 10,240 x 60
// (8 heads a block), of which the LN + affine + quant cost 0.36 (0.44
// before its rows went two a warp at once, bit-identical), the flash step
// 0.50, the products' instructions 0.42 and the weight stream 0.09; at x 16
// (4 heads) 0.70 ms: 0.17, 0.12, 0.09, 0.10. No part dominates: the block's
// eight warps pass every phase together between barriers, one block an SM,
// so the phases add up instead of overlapping; the rest (~0.85 ms at x 60)
// is the k|v epilogue, the barriers and the waits. The chain it replaced
// reads 3.6 ms at x 60 and 1.0-1.1 at x 16 in the same calls (chip_smoke,
// scripts/torch_cores.py); the 1.2 / 0.40 ms targets are missed. Tried:
// 64-byte ring stages, 4.4% slower at x 60 (kept 128); 4 heads a block at
// x 60, 23% slower (the LN repeats per head group), at x 16 38% faster
// (128 blocks fill the SMs where 64 do not). Not built: warps specialized
// by phase (a group that runs the next tile's LN and the weight stream
// while the others compute, as K1's tail streams its weights; the flash
// warps need setmaxnreg for their 255 registers), or two 4-warp blocks an
// SM (each head group would repeat the LN).

#include "int8_tile.cuh"

namespace ct {

constexpr int K3_KEYS = 64;    // points a tile
constexpr int K3_QROWS = 64;   // virtual queries a block
constexpr int K3_HEADS = 8;
using K3KvGemm = RingGemm<2, 4, 2, 6, 128, 3>;  // 64 points x (k|v of two heads = 192 columns)

// Shared-memory bytes of a block of `hp` heads (attention_cuda.k3_plan
// mirrors it).
inline int k3_smem(int hp) {
  return hp * K3_QROWS * kDimHead * 2 + K3_KEYS * KC * 2 + K3_KEYS * LDA_C +
         4 * K3_KEYS * kDimHead * 2 + K3KvGemm::kRingBytes + 2 * K3_KEYS * 4 + 16;
}

// LN + affine + row quant of two rows a warp at once (ra, rb of the
// tile's x rows in shared memory): ln_quant_row<bf16, 12>'s arithmetic for
// each row, with do_ln and the affine, the two rows' reductions interleaved
// and the lane's affine columns (gm, bt) loaded once a tile by the caller.
__device__ __forceinline__ void ln_affine_quant2(const bf16* xa, const bf16* xb, int lane,
                                                 const float (&gm)[KC / 32],
                                                 const float (&bt)[KC / 32], float eps,
                                                 int8_t* qa, int8_t* qb, float& sa, float& sb) {
  constexpr int VPL = KC / 32;
  float v[2][VPL], s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    v[0][i] = to_f(xa[lane + 32 * i]);
    v[1][i] = to_f(xb[lane + 32 * i]);
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    s[0] += v[0][i];
    s[1] += v[1][i];
  }
  const float mean[2] = {warp_sum(s[0]) / KC, warp_sum(s[1]) / KC};
  float s2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v[r][i] = __fsub_rn(v[r][i], mean[r]);
      s2[r] += v[r][i] * v[r][i];
    }
  const float inv[2] = {1.0f / sqrtf(__fadd_rn(warp_sum(s2[0]) / KC, eps)),
                        1.0f / sqrtf(__fadd_rn(warp_sum(s2[1]) / KC, eps))};
  float amax[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v[r][i] = __fadd_rn(__fmul_rn(__fmul_rn(v[r][i], inv[r]), gm[i]), bt[i]);
      amax[r] = fmaxf(amax[r], fabsf(v[r][i]));
    }
  sa = __fmul_rn(fmaxf(warp_max(amax[0]), 1e-20f), 1.0f / 127.0f);
  sb = __fmul_rn(fmaxf(warp_max(amax[1]), 1e-20f), 1.0f / 127.0f);
  const float ia = 1.0f / sa, ib = 1.0f / sb;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    qa[lane + 32 * i] = quant8(v[0][i], ia);
    qb[lane + 32 * i] = quant8(v[1][i], ib);
  }
}

template <int HP>
__global__ void __launch_bounds__(256, 1)
k3_proj_flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ x,
                     const float* __restrict__ bias, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const int8_t* __restrict__ wkv,
                     const float* __restrict__ skv, const float* __restrict__ bkv, int N, int Tn,
                     int V, int split_keys, float eps, float scale, bf16* __restrict__ out,
                     float* __restrict__ part) {
  using G = K3KvGemm;
  constexpr int D = kDimHead, PAIRS = HP / 2, TS = K3_KEYS * D;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);              // [HP][64 queries x 48] (ilv)
  bf16* xs = qs + HP * K3_QROWS * D;                     // the tile's x rows (64 x 384)
  int8_t* A = reinterpret_cast<int8_t*>(xs + K3_KEYS * KC);
  bf16* kt = reinterpret_cast<bf16*>(A + K3_KEYS * LDA_C);  // [2][64 keys x 48] (ilv)
  bf16* vt = kt + 2 * TS;                                   // the same for the values
  int8_t* ring = reinterpret_cast<int8_t*>(vt + 2 * TS);
  float* sr = reinterpret_cast<float*>(ring + G::kRingBytes);
  float* bs = sr + K3_KEYS;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(bs + K3_KEYS);

  const int QG = (V + K3_QROWS - 1) / K3_QROWS, t = blockIdx.x / QG;
  const int v0 = (blockIdx.x % QG) * K3_QROWS, split = blockIdx.y, h0 = blockIdx.z * HP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int kb = split * split_keys, ke = min(N, kb + split_keys);
  const int ntile = (ke - kb + K3_KEYS - 1) / K3_KEYS;
  // k|v column n of head pair p: its k or v half, head h0 + 2p + n % 96 / 48
  auto wrow_of = [&](int p) {
    return [=](int n) {
      const int which = n / (2 * D), within = n - which * 2 * D;
      return wkv + static_cast<size_t>(which * KC + (h0 + 2 * p) * D + within) * KC;
    };
  };
  auto load_x = [&](int i) {  // warp 0: the x rows of tile i, completing xbar's phase
    const int k0 = kb + i * K3_KEYS, rows = min(K3_KEYS, ke - k0);
    if (lane == 0) mbar_expect_tx(xbar, rows * KC * 2);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_g2s(xs + r * KC, x + (static_cast<size_t>(k0 + r) * Tn + t) * KC, KC * 2, xbar);
  };
  if (tid == 0) {
    mbar_init(xbar, 1);
    fence_mbar_init();
  }
  // the frame's queries of the block's heads, zero past V
  for (int c = tid; c < HP * K3_QROWS * 6; c += 256) {
    const int ch = c % 6, r = (c / 6) % K3_QROWS, hh = c / (6 * K3_QROWS);
    const bool ok = v0 + r < V;
    cp_async16(qs + hh * K3_QROWS * D + ilv(r, ch),
               q + (static_cast<size_t>(t) * V + (ok ? v0 + r : 0)) * KC + (h0 + hh) * D + 8 * ch,
               ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) load_x(0);
  G::prefetch(wrow_of(0), KC, ring);

  const int qg = warp & 3, hh = warp >> 2;
  float acc[PAIRS][6][4], m[PAIRS][2], l[PAIRS][2];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
#pragma unroll
    for (int mm = 0; mm < 6; ++mm) acc[p][mm][0] = acc[p][mm][1] = acc[p][mm][2] = acc[p][mm][3] = 0.f;
    m[p][0] = m[p][1] = -0.7f * 3.4028234663852886e38f;
    l[p][0] = l[p][1] = 0.f;
  }
  unsigned phase = 0;
  for (int i = 0; i < ntile; ++i) {
    const int k0 = kb + i * K3_KEYS, valid = min(K3_KEYS, ke - k0);
    mbar_wait(xbar, phase);
    phase ^= 1u;
    {
      float gm[KC / 32], bt[KC / 32];
#pragma unroll
      for (int c = 0; c < KC / 32; ++c) {
        gm[c] = gamma[lane + 32 * c];
        bt[c] = beta[lane + 32 * c];
      }
      for (int r = warp; r < K3_KEYS; r += 16) {  // rows r and r + 8
        float sc[2];
        ln_affine_quant2(xs + r * KC, xs + (r + 8) * KC, lane, gm, bt, eps, A + r * LDA_C,
                         A + (r + 8) * LDA_C, sc[0], sc[1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows past the tile's keys: zero codes (read as zeros)
          const int rr = r + 8 * h;
          if (rr >= valid)
            for (int c = lane; c < KC; c += 32) A[rr * LDA_C + c] = 0;
          if (lane == 0) sr[rr] = rr < valid ? sc[h] : 0.f;
        }
      }
    }
    if (tid < K3_KEYS) bs[tid] = tid < valid ? bias[k0 + tid] : 0.f;
    __syncthreads();
    if (warp == 0 && i + 1 < ntile) {
      fence_async_smem();
      load_x(i + 1);
    }
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      int kacc[G::kMI][G::kNI][4];
      G::template run<true>(A, LDA_C, KC, wrow_of(p), ring, kacc);
      if (p + 1 < PAIRS || i + 1 < ntile) G::prefetch(wrow_of((p + 1) % PAIRS), KC, ring);
      // this pair's keys and values, rounded to bf16, into their tiles
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::kNI; ++ni)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = G::row(mi, 2 * h2), n = G::col(ni, 2 * h2);
            const int which = n / (2 * D), within = n - which * 2 * D, d = within % D;
            const int wr = which * KC + (h0 + 2 * p) * D + within;
            const float a0 = __fadd_rn(dequant(kacc[mi][ni][2 * h2], sr[r], skv[wr]), bkv[wr]);
            const float a1 =
                __fadd_rn(dequant(kacc[mi][ni][2 * h2 + 1], sr[r], skv[wr + 1]), bkv[wr + 1]);
            *reinterpret_cast<uint32_t*>((which ? vt : kt) + (within / D) * TS + ilv(r, d >> 3) +
                                         (d & 7)) = pack_bf16(a0, a1);
          }
      __syncthreads();
      // K7's step for (queries 16 qg.., head h0 + 2p + hh) over the tile's keys
      uint32_t qa[3][4];
      load_q_ilv(qa, qs + (2 * p + hh) * K3_QROWS * D, qg * 16);
      float S[8][4], alpha[2];
      chunk_scores_ilv(S, qa, kt + hh * TS);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t4 + (e & 1);
          S[j][e] = key < valid ? __fadd_rn(__fmul_rn(S[j][e], scale), bs[key]) : -INFINITY;
        }
      online_update(S, m[p], l[p], alpha);
#pragma unroll
      for (int mm = 0; mm < 6; ++mm)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mm][e] = __fmul_rn(acc[p][mm][e], alpha[e >> 1]);
      chunk_pv_ilv(acc[p], S, vt + hh * TS);
    }
    __syncthreads();  // the tiles, A, sr and bs are the next tile's
  }

  const int va = v0 + qg * 16 + g, vb = va + 8;
  if (gridDim.y == 1) {  // one key range: the result, as the merge writes it
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int h = h0 + 2 * p + hh;
#pragma unroll
      for (int mm = 0; mm < 6; ++mm) {
        const int c = h * D + 8 * mm + 2 * t4;
        if (va < V)
          *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(t) * V + va) * KC + c) =
              pack_bf16(__fdiv_rn(acc[p][mm][0], l[p][0]), __fdiv_rn(acc[p][mm][1], l[p][0]));
        if (vb < V)
          *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(t) * V + vb) * KC + c) =
              pack_bf16(__fdiv_rn(acc[p][mm][2], l[p][1]), __fdiv_rn(acc[p][mm][3], l[p][1]));
      }
    }
  } else {  // K7's partials: the unnormalized f32 rows, then (max, sum) a row and head
    const size_t rows = static_cast<size_t>(Tn) * V;
    float* ml = part + static_cast<size_t>(gridDim.y) * rows * KC;
    const size_t rowa = (static_cast<size_t>(split) * Tn + t) * V + va;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int h = h0 + 2 * p + hh;
      store_rows<float>(acc[p], va < V ? part + rowa * KC + h * D : nullptr,
                        vb < V ? part + (rowa + 8) * KC + h * D : nullptr);
      if (t4 == 0) {
        if (va < V)
          *reinterpret_cast<float2*>(ml + (rowa * K3_HEADS + h) * 2) = make_float2(m[p][0], l[p][0]);
        if (vb < V)
          *reinterpret_cast<float2*>(ml + ((rowa + 8) * K3_HEADS + h) * 2) =
              make_float2(m[p][1], l[p][1]);
      }
    }
  }
}

}  // namespace ct

using namespace ct;

extern "C" {

// Shared-memory bytes of a block of `hp` heads (8 or 4).
int ct_k3_smem(int hp) { return k3_smem(hp); }

// K3 in bfloat16: q (T, V, 384) the projected virtual queries; x (N, T,
// 384) raw point tokens; bias (N,) f32 additive key mask; gamma, beta (384,)
// f32 the context norm; wkv (768, 384) int8, skv, bkv (768,) f32 -> out
// (T, V, 384) bf16. The plan (k3_plan): `splits` key ranges of split_keys
// points (whole 64-point tiles; every range non-empty) and `hp` heads a
// block; part holds splits * T * V * (384 + 16) floats where splits > 1
// (then v2p_merge_kernel writes out).
int ct_k3_v2p_proj(const void* q, const void* x, const float* bias, const float* gamma,
                   const float* beta, const int8_t* wkv, const float* skv, const float* bkv, int N,
                   int T, int V, int C, int H, int D, int splits, int split_keys, int hp, float eps,
                   float scale, void* out, float* part, void* stream) {
  if (N < 1 || T < 1 || V < 1 || C != KC || H != K3_HEADS || D != kDimHead ||
      (hp != 8 && hp != 4) || splits < 1 || split_keys < K3_KEYS || split_keys % K3_KEYS != 0 ||
      static_cast<long long>(splits - 1) * split_keys >= N ||
      static_cast<long long>(splits) * split_keys < N || (splits > 1 && part == nullptr) ||
      static_cast<long long>(T) * ((V + K3_QROWS - 1) / K3_QROWS) > 0x7fffffffLL || splits > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(T * ((V + K3_QROWS - 1) / K3_QROWS), splits, K3_HEADS / hp);
  const int smem = k3_smem(hp);
  auto kern = hp == 8 ? k3_proj_flash_kernel<8> : k3_proj_flash_kernel<4>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, 256, smem, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(x), bias,
                               gamma, beta, wkv, skv, bkv, N, T, V, split_keys, eps, scale,
                               static_cast<bf16*>(out), part);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  v2p_merge_kernel<bf16><<<T * V, kTcThreads, 0, s>>>(part, static_cast<bf16*>(out), splits, T, V,
                                                      K3_HEADS);
  return cudaGetLastError();
}

}  // extern "C"
