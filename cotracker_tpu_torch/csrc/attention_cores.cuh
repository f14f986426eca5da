// The three attention cores of the updateformer (sm_90a), shared by the
// W8A8 block chains K1-K3 (int8_blocks.cu) and by the stand-alone bf16/f32
// attention kernels K5-K7 (attention_cores.cu).
//
//   time_attention_kernel  per-track softmax attention over T frames
//   p2v_attention_kernel   per-(track, frame) attention over V virtual tokens
//   v2p_flash_kernel       V virtual queries over all N point keys, online
//                          softmax with an additive key bias
//
// Common contract (the Pallas bodies of
// cotracker_tpu/ops/kernels/attention_pallas.py): 8 heads of 48, f32 logits
// and softmax, probabilities rounded to the value dtype T before P.V, f32
// accumulation, one rounding of the f32 result to the output dtype OutT.
//
// Two generations of device code live here. The first-version bodies above
// stage keys and values as f32 and do the products on the CUDA cores; they
// serve every f32 operand (TF32 tensor cores would change the function),
// the K1 launch chain's bf16 time core (kept as K1's f32 route and as a
// yardstick) and K11's stages (int8_fused.cu). The tensor-core bodies below
// (p2v_tc_kernel, v2p_tc_kernel + v2p_merge_kernel, the time core
// time_task / time_tc_kernel, also K1's attention stage, and
// time_attention_long_tc_kernel) serve bf16 operands: both products on
// mma.sync m16n8k16 (bf16 x bf16 -> f32), keys and values moved through
// shared memory as bf16 with cp.async, the score fragment reused in
// registers as P's A fragment.
#pragma once

#include "common.cuh"

#include <math.h>

#include <algorithm>
#include <type_traits>

namespace ct {

constexpr int kDimHead = 48;
// Keys staged per block (frames for the time core, virtual tokens for the
// points<-virtual core): 105 floats each in shared memory, so at most 512 of
// them fit the 227 KB of an SM.
constexpr int kMaxKeys = 512;
constexpr int kCoreThreads = 256;

// Softmax of one warp's scores p[0..n) in place: exp(s - max) / sum, then
// rounded to the value dtype T (kept as float). Lane j owns p[j], p[j+32], ...
template <typename T>
__device__ __forceinline__ void warp_softmax(float* p, int n, float mx) {
  const int lane = threadIdx.x & 31;
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(__fsub_rn(p[j], mx));
    p[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += 32) p[j] = to_f(from_f<T>(__fdiv_rn(p[j], sum)));
  __syncwarp();
}

// Time core. Row (m, t) of q is q + (m*Tn + t)*ldq, of k and v likewise with
// ldkv (K1 passes one [q | k | v] buffer with ldq = ldkv = 3C; K5 passes q
// with ldq = C and k, v as the two halves of kv with ldkv = 2C). out
// (M*Tn, C). Block (track, head): the head's K and V for all Tn frames are
// staged in shared memory as float (K rows padded to 49: conflict-free when
// lanes read different keys), then one warp per query frame.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kCoreThreads)
time_attention_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k,
                      const T* __restrict__ v, int ldkv, OutT* __restrict__ out, int Tn,
                      int H, float scale) {
  constexpr int D = kDimHead, LK = D + 1;
  extern __shared__ float sm[];
  float* ks = sm;            // Tn * LK
  float* vs = ks + Tn * LK;  // Tn * D
  const int m = blockIdx.x, h = blockIdx.y;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = H * D;
  const size_t row0 = static_cast<size_t>(m) * Tn;
  for (int i = threadIdx.x; i < Tn * D; i += blockDim.x) {
    const int j = i / D, d = i - j * D;
    const size_t o = (row0 + j) * ldkv + h * D + d;
    ks[j * LK + d] = to_f(k[o]);
    vs[j * D + d] = to_f(v[o]);
  }
  __syncthreads();
  float* p = vs + Tn * D + warp * Tn;
  for (int i = warp; i < Tn; i += nw) {
    const T* qr = q + (row0 + i) * ldq + h * D;
    float qv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = to_f(qr[d]);
    float mx = -INFINITY;
    for (int j = lane; j < Tn; j += 32) {
      const float* kr = ks + j * LK;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += qv[d] * kr[d];
      s = __fmul_rn(s, scale);
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    warp_softmax<T>(p, Tn, mx);
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < Tn; ++j) {
      const float pj = p[j];
      a0 += pj * vs[j * D + lane];
      if (lane < D - 32) a1 += pj * vs[j * D + lane + 32];
    }
    OutT* orow = out + (row0 + i) * C + h * D;
    orow[lane] = from_f<OutT>(a0);
    if (lane < D - 32) orow[lane + 32] = from_f<OutT>(a1);
    __syncwarp();
  }
}

// Stages one head's V keys and values of one frame, kvt = the frame's
// (V, 2C) keys|values offset to the head, as float: K rows padded to 49.
template <typename T>
__device__ __forceinline__ void stage_head_kv(const T* __restrict__ kvt, int V, int C, float* ks,
                                              float* vs) {
  constexpr int D = kDimHead, LK = D + 1;
  for (int i = threadIdx.x; i < V * D; i += blockDim.x) {
    const int j = i / D, d = i - j * D;
    ks[j * LK + d] = to_f(kvt[static_cast<size_t>(j) * 2 * C + d]);
    vs[j * D + d] = to_f(kvt[static_cast<size_t>(j) * 2 * C + C + d]);
  }
}

// One warp: softmax(q . K^T * scale) . V of one query row of one head over
// V staged keys (p: the warp's V-float score row). Lane l returns output
// dims l (a0) and 32 + l (a1, lanes < 16).
template <typename T>
__device__ __forceinline__ void attend_staged(const float (&qv)[kDimHead], const float* ks,
                                              const float* vs, float* p, int V, float scale,
                                              float& a0, float& a1) {
  constexpr int D = kDimHead, LK = D + 1;
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int j = lane; j < V; j += 32) {
    const float* kr = ks + j * LK;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s += qv[d] * kr[d];
    s = __fmul_rn(s, scale);
    p[j] = s;
    mx = fmaxf(mx, s);
  }
  warp_softmax<T>(p, V, mx);
  a0 = 0.f;
  a1 = 0.f;
  for (int j = 0; j < V; ++j) {
    const float pj = p[j];
    a0 += pj * vs[j * D + lane];
    if (lane < D - 32) a1 += pj * vs[j * D + lane + 32];
  }
}

// Points<-virtual core. q (N*Tn, C) rows (track-major); kv (Tn, V, 2C);
// out (N*Tn, C). Block (frame, head, 64 tracks): the frame's V keys and
// values of the head are staged in shared memory once and reused by the 64
// tracks, one warp per (track, head) at a time.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kCoreThreads)
p2v_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                     OutT* __restrict__ out, int N, int Tn, int V, float scale) {
  constexpr int D = kDimHead, LK = D + 1, NB = 64;
  extern __shared__ float sm[];
  float* ks = sm;           // V * LK
  float* vs = ks + V * LK;  // V * D
  const int t = blockIdx.x, h = blockIdx.y, n0 = blockIdx.z * NB;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = gridDim.y * D;
  stage_head_kv(kv + static_cast<size_t>(t) * V * 2 * C + h * D, V, C, ks, vs);
  __syncthreads();
  float* p = vs + V * D + warp * V;
  const int n_end = min(n0 + NB, N);
  for (int n = n0 + warp; n < n_end; n += nw) {
    const size_t row = static_cast<size_t>(n) * Tn + t;
    const T* qr = q + row * C + h * D;
    float qv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = to_f(qr[d]);
    float a0, a1;
    attend_staged<T>(qv, ks, vs, p, V, scale, a0, a1);
    OutT* orow = out + row * C + h * D;
    orow[lane] = from_f<OutT>(a0);
    if (lane < D - 32) orow[lane + 32] = from_f<OutT>(a1);
    __syncwarp();
  }
}

// Virtual<-points core. q (Tn, V, C); kv (N*Tn, 2C) rows (track-major); bias
// (N,) f32 additive key mask; out (Tn, V, C). Block (frame, head, 64-query
// group), 4 threads per query: each owns 8 keys of a 32-key tile and 12 of
// the 48 output dims. Online softmax exactly as the Pallas flash bodies:
// running max from -0.7 * FLT_MAX (so a row whose keys are all masked stays
// finite: every exp(s - m) is 1 and the result is the plain average), f32
// row sums of the unrounded p, P.V with p rounded to T.
template <typename T>
__global__ void __launch_bounds__(kCoreThreads)
v2p_flash_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                 const float* __restrict__ bias, T* __restrict__ out, int N, int Tn,
                 int V, int H, float scale) {
  constexpr int D = kDimHead, KT = 32, QG = 64, DPT = D / 4;
  __shared__ float ks[KT][D + 1];
  __shared__ float vs[KT][D];
  __shared__ float ps[QG][KT + 1];
  __shared__ float bs[KT];
  const int t = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, r = tid >> 2, qd = tid & 3;
  const int vq = blockIdx.z * QG + r;
  const bool active = vq < V;
  const int C = H * D;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qv[d] = active ? to_f(q[(static_cast<size_t>(t) * V + vq) * C + h * D + d]) : 0.f;
  float m = -0.7f * 3.4028234663852886e38f, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;

  for (int n0 = 0; n0 < N; n0 += KT) {
    for (int i = tid; i < KT * D; i += kCoreThreads) {
      const int j = i / D, d = i - j * D, n = n0 + j;
      float kval = 0.f, vval = 0.f;
      if (n < N) {
        const T* rowp = kv + (static_cast<size_t>(n) * Tn + t) * 2 * C;
        kval = to_f(rowp[h * D + d]);
        vval = to_f(rowp[C + h * D + d]);
      }
      ks[j][d] = kval;
      vs[j][d] = vval;
    }
    if (tid < KT) bs[tid] = (n0 + tid < N) ? bias[n0 + tid] : -INFINITY;
    __syncthreads();
    float s[8];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = qd * 8 + jj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qv[d] * ks[j][d];
      s[jj] = __fadd_rn(__fmul_rn(dot, scale), bs[j]);
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(__fsub_rn(m, m_new));
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float e = expf(__fsub_rn(s[jj], m_new));
      psum += e;
      ps[r][qd * 8 + jj] = to_f(from_f<T>(e));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = __fadd_rn(__fmul_rn(l, alpha), psum);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = qd * DPT + dd;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < KT; ++j) pv += ps[r][j] * vs[j][d];
      acc[dd] = __fadd_rn(__fmul_rn(acc[dd], alpha), pv);
    }
    __syncthreads();
  }
  if (active) {
    T* orow = out + (static_cast<size_t>(t) * V + vq) * C + h * D + qd * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) orow[dd] = from_f<T>(__fdiv_rn(acc[dd], l));
  }
}

// ------------------------------------------------------ tensor-core bodies
//
// Warp tiles: a warp owns 16 query rows and the mma.sync m16n8k16 fragments
// (PTX ISA "Matrix fragments for mma.m16n8k16", g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                a3 = A[g+8][2t+8..]
//   B (16 x 8):  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// The product q . k sums over the 48 head dims in any order, so the dims are
// permuted: in k-step s lane t's four A (and B) columns are dims 12t + 4s
// .. 12t + 4s + 3. A lane then reads dims 12t .. 12t + 11 of a row, 24
// contiguous bytes: its q rows straight from device memory, its key rows from
// a shared tile of plain 96-byte rows with 8-byte loads that no two lanes of
// a half-warp share a bank for. The S accumulator of keys 16kk .. 16kk+15
// (n-tiles 2kk, 2kk+1) is then exactly P's A fragment for k-step kk, and V's
// B fragments come from ldmatrix.trans on rows padded to 56 bf16 (112 bytes:
// eight consecutive rows hit eight different 16-byte bank groups).

using bf16 = __nv_bfloat16;
constexpr int kKeyTile = 64;           // keys per shared-memory chunk
constexpr int kVRow = kDimHead + 8;    // padded V row (bf16)
constexpr int kTcThreads = 128;        // K7 and the long time core: 4 warps x 16 rows
constexpr int kP2vThreads = 256;       // K6: 8 warps
constexpr int kV2pStages = 3;          // K7's cp.async ring
// A K6 block stages `heads x padded keys` <= this many key rows of one frame
// (4 heads at V=64, one head from V=257): with its warps' task buffers
// 73,728 bytes of shared memory at V=64 (bf16 out; 98,304 with f32 out)
constexpr int kP2vStagedRows = 256;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragments of a warp's query rows g (ra) and g + 8 (rb), each the row's
// head slice in device memory or null past the end (zeros).
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[3][4], const bf16* ra,
                                             const bf16* rb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const uint2 w0 = ra ? *reinterpret_cast<const uint2*>(ra + 12 * t + 4 * s) : make_uint2(0, 0);
    const uint2 w1 = rb ? *reinterpret_cast<const uint2*>(rb + 12 * t + 4 * s) : make_uint2(0, 0);
    qa[s][0] = w0.x;
    qa[s][1] = w1.x;
    qa[s][2] = w0.y;
    qa[s][3] = w1.y;
  }
}

// S (16 x 64) = q . K^T over one chunk of 64 keys (ks: [key][48] bf16).
__device__ __forceinline__ void chunk_scores(float (&S)[8][4], const uint32_t (&qa)[3][4],
                                             const bf16* ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.f;
    const uint2* kr = reinterpret_cast<const uint2*>(ks + (8 * j + g) * kDimHead + 12 * t);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint2 b = kr[s];
      mma_bf16_16816(S[j], qa[s], b.x, b.y);
    }
  }
}

// acc (16 x 48) += P . V over one chunk (P rounded to bf16 here; vs: [key][kVRow]).
__device__ __forceinline__ void chunk_pv(float (&acc)[6][4], const float (&P)[8][4],
                                         const bf16* vs) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(P[2 * kk][0], P[2 * kk][1]),
                           pack_bf16(P[2 * kk][2], P[2 * kk][3]),
                           pack_bf16(P[2 * kk + 1][0], P[2 * kk + 1][1]),
                           pack_bf16(P[2 * kk + 1][2], P[2 * kk + 1][3])};
#pragma unroll
    for (int mp = 0; mp < 6; mp += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (16 * kk + (mi & 1) * 8 + r) * kVRow + 8 * (mp + (mi >> 1)));
      mma_bf16_16816(acc[mp], a, b[0], b[1]);
      mma_bf16_16816(acc[mp + 1], a, b[2], b[3]);
    }
  }
}

// Scaled logits of one chunk; keys at or past `valid` get -inf. Element e
// of S[j] is key 8j + 2t + (e & 1) of row g (e < 2) or g + 8.
__device__ __forceinline__ void scale_mask(float (&S)[8][4], float scale, int valid) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[j][e] = (8 * j + 2 * t + (e & 1) < valid) ? __fmul_rn(S[j][e], scale) : -INFINITY;
}

// Online update of the rows' running max m and sum l (of the unrounded
// exponentials) by one chunk of logits; returns the rescale factors and
// leaves exp(s - m_new) in S.
__device__ __forceinline__ void online_update(float (&S)[8][4], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY}, ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], S[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = expf(__fsub_rn(m[r], mn));
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      S[j][e] = expf(__fsub_rn(S[j][e], m[e >> 1]));
      ps[e >> 1] += S[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(ps[r]));
}

// Softmax of one chunk that holds every key of its rows (K6 at V <= 64):
// exp(s - max) times the reciprocal of the row's sum (one division a row).
__device__ __forceinline__ void softmax_chunk(float (&S)[8][4]) {
  float mx[2] = {-INFINITY, -INFINITY}, ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], S[j][e]);
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      S[j][e] = expf(__fsub_rn(S[j][e], mx[e >> 1]));
      ps[e >> 1] += S[j][e];
    }
  const float r[2] = {__frcp_rn(quad_sum(ps[0])), __frcp_rn(quad_sum(ps[1]))};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = __fmul_rn(S[j][e], r[e >> 1]);
}

// Normalized probabilities of one chunk against the rows' final max and sum.
__device__ __forceinline__ void normalize_chunk(float (&S)[8][4], const float (&m)[2],
                                          const float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[j][e] = __fdiv_rn(expf(__fsub_rn(S[j][e], m[e >> 1])), l[e >> 1]);
}

// Stores a warp's 16 x 48 accumulator (rows ra, rb: the head slices of the
// output rows, or null past the end), rounded once from f32.
template <typename OutT>
__device__ __forceinline__ void store_rows(const float (&acc)[6][4], OutT* ra, OutT* rb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int mm = 0; mm < 6; ++mm) {
    const int d = 8 * mm + 2 * t;
    if constexpr (std::is_same<OutT, float>::value) {
      if (ra) *reinterpret_cast<float2*>(ra + d) = make_float2(acc[mm][0], acc[mm][1]);
      if (rb) *reinterpret_cast<float2*>(rb + d) = make_float2(acc[mm][2], acc[mm][3]);
    } else {
      if (ra) *reinterpret_cast<uint32_t*>(ra + d) = pack_bf16(acc[mm][0], acc[mm][1]);
      if (rb) *reinterpret_cast<uint32_t*>(rb + d) = pack_bf16(acc[mm][2], acc[mm][3]);
    }
  }
}

// Points<-virtual core, bf16 (K6 and K2's core). q (N*Tn, C) track-major;
// kv (Tn, V, 2C); out (N*Tn, C) in OutT. Block (frame, range of tracks,
// group of `hs` heads): the frame's keys and values of the group are staged
// once; each warp then walks (16-track tile, head) tasks. A task's 16 q head
// slices (96 bytes each) arrive in the warp's own shared buffer by 16-byte
// cp.async one task ahead, the A fragments come from it by ldmatrix, and the
// output goes back through the same buffer to 16-byte stores: every access
// to device memory is a whole 16-byte piece of a contiguous 96-byte slice.
// Keys and values sit chunk-interleaved (the 16-byte chunk c of 8 keys
// together), so every ldmatrix reads 8 consecutive 16-byte rows. Softmax as
// the Pallas body: f32 logits, the row's max and sum over all V keys, p =
// e / sum rounded to bf16, f32 P.V. Up to 64 keys the chunk's scores stay
// in registers; above, a first pass over the 64-key chunks takes each row's
// max and sum (online) and a second recomputes the scores and accumulates.

// Element offset of (key, 16-byte chunk c) of one head in the interleaved
// layout: 8 keys x 6 chunks x 8 elements per key group.
__device__ __forceinline__ int ilv(int key, int c) {
  return ((key >> 3) * 6 + c) * 64 + (key & 7) * 8;
}

// S (16 x 64) = q . K^T over one chunk of 64 keys in the interleaved layout.
__device__ __forceinline__ void chunk_scores_ilv(float (&S)[8][4], const uint32_t (&qa)[3][4],
                                                 const bf16* ks) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; j += 2)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      uint32_t b[4];  // (keys 8j.., dims 16s..), (8j.., 16s+8..), then key group j+1
      ldsm_x4(b, ks + ((j + (mi >> 1)) * 6 + 2 * s + (mi & 1)) * 64 + r * 8);
      mma_bf16_16816(S[j], qa[s], b[0], b[1]);
      mma_bf16_16816(S[j + 1], qa[s], b[2], b[3]);
    }
}

// acc (16 x 48) += P . V over one chunk in the interleaved layout.
__device__ __forceinline__ void chunk_pv_ilv(float (&acc)[6][4], const float (&P)[8][4],
                                             const bf16* vs) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(P[2 * kk][0], P[2 * kk][1]),
                           pack_bf16(P[2 * kk][2], P[2 * kk][3]),
                           pack_bf16(P[2 * kk + 1][0], P[2 * kk + 1][1]),
                           pack_bf16(P[2 * kk + 1][2], P[2 * kk + 1][3])};
#pragma unroll
    for (int mp = 0; mp < 6; mp += 2) {
      uint32_t b[4];  // keys 16kk.. / 16kk+8.. of dims 8mp.., then of dims 8(mp+1)..
      ldsm_x4_trans(b, vs + ((2 * kk + (mi & 1)) * 6 + mp + (mi >> 1)) * 64 + r * 8);
      mma_bf16_16816(acc[mp], a, b[0], b[1]);
      mma_bf16_16816(acc[mp + 1], a, b[2], b[3]);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kP2vThreads, 2)
p2v_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv, OutT* __restrict__ out,
              int N, int Tn, int V, int H, int hs, int vpad, int tracks, float scale) {
  constexpr int D = kDimHead, TR = 16;                     // rows of a task
  constexpr int OCH = D * static_cast<int>(sizeof(OutT)) / 16;  // 16-byte chunks of an out row
  constexpr int STAGE = TR * D * static_cast<int>(sizeof(OutT) > 2 ? sizeof(OutT) : 2);
  extern __shared__ __align__(16) unsigned char p2v_smem[];
  const int t = blockIdx.x, h0 = blockIdx.z * hs, nh = min(hs, H - h0), C = H * D;
  const int n_begin = blockIdx.y * tracks, n_end = min(N, n_begin + tracks);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  bf16* ks = reinterpret_cast<bf16*>(p2v_smem);  // nh heads x vpad keys x D, interleaved
  bf16* vs = ks + hs * vpad * D;                 // the same for V
  unsigned char* stage = p2v_smem + 2 * hs * vpad * D * sizeof(bf16) + warp * 2 * STAGE;

  const bf16* kvt = kv + static_cast<size_t>(t) * V * 2 * C;
  for (int i = threadIdx.x; i < nh * vpad * 6; i += blockDim.x) {
    const int c = i % 6, key = (i / 6) % vpad, hh = i / (6 * vpad);
    const bool ok = key < V;
    const bf16* src = kvt + static_cast<size_t>(ok ? key : 0) * 2 * C + (h0 + hh) * D + 8 * c;
    cp_async16(ks + hh * vpad * D + ilv(key, c), src, ok);
    cp_async16(vs + hh * vpad * D + ilv(key, c), src + C, ok);
  }
  cp_async_commit();

  const int ntiles = (n_end - n_begin + TR - 1) / TR;
  const int mine = ntiles > warp ? (ntiles - warp + nw - 1) / nw : 0, tasks = mine * nh;
  // task i: tile warp + nw * (i / nh), head h0 + i % nh
  auto prefetch = [&](int i) {
    bf16* buf = reinterpret_cast<bf16*>(stage + (i & 1) * STAGE);
    const int n0 = n_begin + (warp + nw * (i / nh)) * TR, h = h0 + i % nh;
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // 16 rows x 6 chunks
      const int c = lane + 32 * k, row = c / 6, ch = c % 6, n = n0 + row;
      const bool ok = n < n_end;
      cp_async16(buf + row * D + 8 * ch,
                 q + (static_cast<size_t>(ok ? n : n_begin) * Tn + t) * C + h * D + 8 * ch, ok);
    }
  };
  if (tasks > 0) prefetch(0);
  cp_async_commit();
  for (int i = 0; i < tasks; ++i) {
    __syncwarp();  // the buffer task i + 1 takes was read back by task i - 1
    if (i + 1 < tasks) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    if (i == 0) __syncthreads();  // the staged keys and values, from every thread
    __syncwarp();
    unsigned char* buf = stage + (i & 1) * STAGE;
    const bf16* qb = reinterpret_cast<const bf16*>(buf);
    uint32_t qa[3][4];
#pragma unroll
    for (int s = 0; s < 3; ++s)
      ldsm_x4(qa[s], qb + ((lane & 7) + ((lane >> 3) & 1) * 8) * D + 16 * s + (lane >> 4) * 8);
    const int hh = i % nh;
    const bf16* kh = ks + hh * vpad * D;
    const bf16* vh = vs + hh * vpad * D;
    float acc[6][4] = {};
    float S[8][4];
    if (vpad == kKeyTile) {
      chunk_scores_ilv(S, qa, kh);
      if (V == kKeyTile) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) S[j][e] = __fmul_rn(S[j][e], scale);
      } else {
        scale_mask(S, scale, V);
      }
      softmax_chunk(S);
      chunk_pv_ilv(acc, S, vh);
    } else {
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      for (int c = 0; c < vpad; c += kKeyTile) {
        chunk_scores_ilv(S, qa, kh + c * D);
        scale_mask(S, scale, V - c);
        online_update(S, m, l, alpha);
      }
      for (int c = 0; c < vpad; c += kKeyTile) {
        chunk_scores_ilv(S, qa, kh + c * D);
        scale_mask(S, scale, V - c);
        normalize_chunk(S, m, l);
        chunk_pv_ilv(acc, S, vh + c * D);
      }
    }
    // the task's output through its buffer (row-major 16 x 48 OutT), then
    // whole 16-byte pieces to device memory
    __syncwarp();
    OutT* ob = reinterpret_cast<OutT*>(buf);
    store_rows<OutT>(acc, ob + g * D, ob + (g + 8) * D);
    __syncwarp();
    const int n0 = n_begin + (warp + nw * (i / nh)) * TR, h = h0 + hh;
    for (int c = lane; c < TR * OCH; c += 32) {
      const int row = c / OCH, ch = c % OCH, n = n0 + row;
      if (n < n_end)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(n) * Tn + t) * C + h * D +
                                  ch * (16 / sizeof(OutT))) =
            *reinterpret_cast<const uint4*>(buf + row * D * sizeof(OutT) + ch * 16);
    }
  }
  cp_async_wait<0>();
  if (tasks == 0) __syncthreads();  // every thread waits once for the staged keys
}

// Virtual<-points core, bf16 (K7 and K3's core), flash-decoding. q (Tn, V,
// C); kv (N*Tn, 2C) track-major; bias (N,) f32; part: per key split the
// unnormalized f32 accumulators (S, Tn, V, C) then the rows' (max, sum)
// (S, Tn, V, H, 2). Block (head, key split, frame x 64-query group); the 8
// head blocks of a (frame, split) are neighbours in the grid, so the 1,536-
// byte key|value rows they slice are read from device memory once and from
// L2 seven times. 64-key tiles of the head's keys and values (and the bias)
// stream through a 3-stage cp.async ring. Online softmax as the Pallas body:
// running max from -0.7 * FLT_MAX (a row whose keys are all masked stays
// finite: every exp(s - m) is 1, the plain average), keys past the split's
// end -inf, s = fadd_rn(fmul_rn(dot, scale), bias), row sums of the
// unrounded exponentials, P.V with them rounded to bf16.
__global__ void __launch_bounds__(kTcThreads)
v2p_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
              const float* __restrict__ bias, float* __restrict__ part, int N, int Tn, int V,
              int H, int split_keys, float scale) {
  constexpr int D = kDimHead, KS = kKeyTile * D, VS = kKeyTile * kVRow;
  __shared__ __align__(16) unsigned char v2p_smem[kV2pStages * (KS + VS) * sizeof(bf16)];
  __shared__ float bs[kV2pStages][kKeyTile];
  bf16* const ks0 = reinterpret_cast<bf16*>(v2p_smem);  // kV2pStages x KS
  bf16* const vs0 = ks0 + kV2pStages * KS;                // kV2pStages x VS
  const int h = blockIdx.x, split = blockIdx.y, S_ = gridDim.y;
  const int QG = (V + 63) / 64, t = blockIdx.z / QG, qg = blockIdx.z % QG;
  const int C = H * D, tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int kb = split * split_keys, ke = min(N, kb + split_keys);
  const int ntile = (ke - kb + kKeyTile - 1) / kKeyTile;
  const int va = qg * 64 + warp * 16 + g, vb = va + 8;
  uint32_t qa[3][4];
  load_q_frags(qa, va < V ? q + (static_cast<size_t>(t) * V + va) * C + h * D : nullptr,
               vb < V ? q + (static_cast<size_t>(t) * V + vb) * C + h * D : nullptr);

  auto load_tile = [&](int i, int buf) {
    const int k0 = kb + i * kKeyTile;
    for (int c = tid; c < kKeyTile * 12; c += kTcThreads) {
      const int key = c / 12, p = c % 12, n = k0 + key;
      const bool ok = n < ke;
      const bf16* src = kv + (static_cast<size_t>(ok ? n : 0) * Tn + t) * 2 * C + h * D;
      if (p < 6) cp_async16(ks0 + buf * KS + key * D + 8 * p, src + 8 * p, ok);
      else cp_async16(vs0 + buf * VS + key * kVRow + 8 * (p - 6), src + C + 8 * (p - 6), ok);
    }
    if (tid < kKeyTile) {
      const int n = k0 + tid;
      cp_async4(&bs[buf][tid], bias + (n < ke ? n : 0), n < ke);
    }
  };

  float m[2] = {-0.7f * 3.4028234663852886e38f, -0.7f * 3.4028234663852886e38f};
  float l[2] = {0.f, 0.f}, alpha[2];
  float acc[6][4] = {};
#pragma unroll
  for (int s = 0; s < kV2pStages - 1; ++s) {
    if (s < ntile) load_tile(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<kV2pStages - 2>();
    __syncthreads();
    const int nx = i + kV2pStages - 1;
    if (nx < ntile) load_tile(nx, nx % kV2pStages);
    cp_async_commit();
    const int buf = i % kV2pStages, valid = min(kKeyTile, ke - (kb + i * kKeyTile));
    float S[8][4];
    chunk_scores(S, qa, ks0 + buf * KS);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * tq + (e & 1);
        S[j][e] = key < valid ? __fadd_rn(__fmul_rn(S[j][e], scale), bs[buf][key]) : -INFINITY;
      }
    online_update(S, m, l, alpha);
#pragma unroll
    for (int mm = 0; mm < 6; ++mm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mm][e] = __fmul_rn(acc[mm][e], alpha[e >> 1]);
    chunk_pv(acc, S, vs0 + buf * VS);
  }
  cp_async_wait<0>();

  const size_t rows = static_cast<size_t>(Tn) * V;
  float* ml = part + static_cast<size_t>(S_) * rows * C;
  const size_t rowa = (static_cast<size_t>(split) * Tn + t) * V + va;
  store_rows<float>(acc, va < V ? part + rowa * C + h * D : nullptr,
                    vb < V ? part + (rowa + 8) * C + h * D : nullptr);
  if (tq == 0) {
    if (va < V) *reinterpret_cast<float2*>(ml + (rowa * H + h) * 2) = make_float2(m[0], l[0]);
    if (vb < V)
      *reinterpret_cast<float2*>(ml + ((rowa + 8) * H + h) * 2) = make_float2(m[1], l[1]);
  }
}

// Merges K7's key splits: out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = exp(m_s - max_s m_s), rounded once; one split is acc / l exactly.
// Block per (frame, query) row.
template <typename OutT>
__global__ void v2p_merge_kernel(const float* __restrict__ part, OutT* __restrict__ out,
                                 int splits, int Tn, int V, int H) {
  const int C = H * kDimHead;
  const size_t rows = static_cast<size_t>(Tn) * V, row = blockIdx.x;
  const float* ml = part + static_cast<size_t>(splits) * rows * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int h = c / kDimHead;
    float M = -INFINITY;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[((s * rows + row) * H + h) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(ml + ((s * rows + row) * H + h) * 2);
      const float w = expf(__fsub_rn(v.x, M));
      L = __fadd_rn(L, __fmul_rn(v.y, w));
      A = __fadd_rn(A, __fmul_rn(part[(s * rows + row) * C + c], w));
    }
    out[row * C + c] = from_f<OutT>(__fdiv_rn(A, L));
  }
}

// ------------------------------------------- the time core on tensor cores
//
// K5's body in bf16 (every frame count) and the attention stage of K1's
// fused block (int8_time_block.cu). Operands of one head sit in shared
// memory in the interleaved layout (ilv: 8 rows x 6 chunks of 16 bytes per
// row group), q, k and v alike, so every ldmatrix reads 128 contiguous
// bytes. A warp takes 16 query rows of one head; key j is valid for query
// row i iff lo(i) <= j < hi(i): a tile of several whole tracks of T frames
// (T <= 64, one 64-key chunk) masks the other tracks' keys, one track of
// more frames takes keys 0..T-1 in ceil(T / 64) chunks. The contract is the
// Pallas body's: f32 logits, scaled after the product; the softmax
// normalized (exp(s - max) times the reciprocal of the row's sum, as K6's
// body) before its rounding to bf16; P.V in f32. NC > 0 holds the NC
// chunks' scores in registers (one pass); NC == 0 takes two passes over the
// chunks in shared memory (online max and sum, then the normalized
// probabilities and P.V), the logits recomputed.

// A fragments of the 16 query rows row0.. (row0 % 16 == 0) of one head.
__device__ __forceinline__ void load_q_ilv(uint32_t (&qa)[3][4], const bf16* qs, int row0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const int row = row0 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
  for (int s = 0; s < 3; ++s) ldsm_x4(qa[s], qs + ilv(row, 2 * s + (mi >> 1)));
}

// Scaled logits of chunk c (keys 64c..) with the rows' key ranges applied
// (a chunk inside both rows' ranges, every chunk but the last of one track,
// is only scaled).
__device__ __forceinline__ void mask_rows(float (&S)[8][4], int c, float scale,
                                          const int (&lo)[2], const int (&hi)[2]) {
  const int t = threadIdx.x & 3, k0 = kKeyTile * c;
  if (k0 >= max(lo[0], lo[1]) && k0 + kKeyTile <= min(hi[0], hi[1])) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = __fmul_rn(S[j][e], scale);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kKeyTile * c + 8 * j + 2 * t + (e & 1), r = e >> 1;
      S[j][e] = (key >= lo[r] && key < hi[r]) ? __fmul_rn(S[j][e], scale) : -INFINITY;
    }
}

// Normalized probabilities of one chunk: exp(s - max) * (1 / sum).
__device__ __forceinline__ void normalize_rcp(float (&S)[8][4], const float (&m)[2],
                                              const float (&rl)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = __fmul_rn(expf(__fsub_rn(S[j][e], m[e >> 1])), rl[e >> 1]);
}

// acc (16 x 48, f32) = softmax(q . K^T * scale) . V for one warp's task.
template <int NC>
__device__ __forceinline__ void time_task(float (&acc)[6][4], const uint32_t (&qa)[3][4],
                                          const bf16* ks, const bf16* vs, int nch,
                                          const int (&lo)[2], const int (&hi)[2], float scale) {
  constexpr int CH = kKeyTile * kDimHead;  // elements of one 64-key chunk
#pragma unroll
  for (int mm = 0; mm < 6; ++mm) acc[mm][0] = acc[mm][1] = acc[mm][2] = acc[mm][3] = 0.f;
  if constexpr (NC > 0) {
    float S[NC][8][4];
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      chunk_scores_ilv(S[c], qa, ks + c * CH);
      mask_rows(S[c], c, scale, lo, hi);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], S[c][j][e]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[c][j][e] = expf(__fsub_rn(S[c][j][e], mx[e >> 1]));
          l[e >> 1] += S[c][j][e];
        }
    const float rl[2] = {__frcp_rn(quad_sum(l[0])), __frcp_rn(quad_sum(l[1]))};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[c][j][e] = __fmul_rn(S[c][j][e], rl[e >> 1]);
      chunk_pv_ilv(acc, S[c], vs + c * CH);
    }
  } else {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float S[8][4];
    for (int c = 0; c < nch; ++c) {
      chunk_scores_ilv(S, qa, ks + c * CH);
      mask_rows(S, c, scale, lo, hi);
      online_update(S, m, l, alpha);
    }
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    for (int c = 0; c < nch; ++c) {
      chunk_scores_ilv(S, qa, ks + c * CH);
      mask_rows(S, c, scale, lo, hi);
      normalize_rcp(S, m, rl);
      chunk_pv_ilv(acc, S, vs + c * CH);
    }
  }
}

// The rows' key ranges of a task (rows row0 + g, row0 + g + 8 of a tile of
// whole tracks of Tn frames).
__device__ __forceinline__ void task_ranges(int row0, int Tn, int (&lo)[2], int (&hi)[2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] = (row0 + g + 8 * r) / Tn * Tn;
    hi[r] = lo[r] + Tn;
  }
}

// K5 in bf16 up to kMaxKeys frames. Block: `tracks` whole tracks (rows =
// tracks x Tn <= rows_pad, zero-filled to rows_pad) x a group of `hs` heads;
// the groups of a tile are neighbours in the grid (blockIdx.x = tile *
// groups + group). Every 16-byte piece of the block's q, k and v head
// slices is moved once, by cp.async, into the interleaved layout; each
// warp then takes (head, 16 query rows) tasks and writes its output over
// the task's q rows (read into registers first), and the block stores the
// tile's output in 16-byte pieces.
template <int NC>
constexpr int time_tc_threads() {  // NC = 0 (many query tiles a block): 8 warps
  return NC == 0 ? 256 : kTcThreads;
}

template <int NC>
__global__ void __launch_bounds__(time_tc_threads<NC>())
time_tc_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int ldkv, bf16* __restrict__ out, int M, int Tn,
               int H, int hs, int tracks, int rows_pad, float scale) {
  constexpr int D = kDimHead;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(tc_smem);  // [q | k | v][hs][rows_pad x D] (ilv)
  const int groups = (H + hs - 1) / hs, tile = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * hs, nh = min(hs, H - h0), C = H * D;
  const int m0 = tile * tracks, rows = min(tracks, M - m0) * Tn;
  const size_t row0 = static_cast<size_t>(m0) * Tn;
  const int hsz = rows_pad * D;  // elements of one head's operand
  for (int i = threadIdx.x; i < 3 * nh * rows_pad * 6; i += blockDim.x) {
    const int c = i % 6, hh = (i / 6) % nh, which = (i / (6 * nh)) % 3, r = i / (18 * nh);
    const bool ok = r < rows;
    const size_t o = row0 + (ok ? r : 0);
    const bf16* src = which == 0 ? q + o * ldq : (which == 1 ? k : v) + o * ldkv;
    cp_async16(sm + (which * hs + hh) * hsz + ilv(r, c), src + (h0 + hh) * D + 8 * c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qtiles = (rows + 15) / 16, nch = (rows_pad + kKeyTile - 1) / kKeyTile;
  for (int task = warp; task < qtiles * nh; task += blockDim.x >> 5) {
    const int hh = task % nh, r0 = (task / nh) * 16;
    bf16* qs = sm + hh * hsz;
    uint32_t qa[3][4];
    load_q_ilv(qa, qs, r0);
    int lo[2], hi[2];
    task_ranges(r0, Tn, lo, hi);
    float acc[6][4];
    time_task<NC>(acc, qa, sm + (hs + hh) * hsz, sm + (2 * hs + hh) * hsz, nch, lo, hi, scale);
    __syncwarp();
#pragma unroll
    for (int mm = 0; mm < 6; ++mm) {
      *reinterpret_cast<uint32_t*>(qs + ilv(r0 + g, mm) + 2 * t) = pack_bf16(acc[mm][0], acc[mm][1]);
      *reinterpret_cast<uint32_t*>(qs + ilv(r0 + g + 8, mm) + 2 * t) =
          pack_bf16(acc[mm][2], acc[mm][3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * nh * 6; i += blockDim.x) {
    const int c = i % 6, hh = (i / 6) % nh, r = i / (6 * nh);
    *reinterpret_cast<uint4*>(out + (row0 + r) * C + (h0 + hh) * D + 8 * c) =
        *reinterpret_cast<const uint4*>(sm + hh * hsz + ilv(r, c));
  }
}

// Time core past kMaxKeys frames, bf16 (K5's long route). Block (track,
// head), the 8 head blocks of a track neighbours in the grid (blockIdx.x =
// track * H + head); per 128-frame query tile, the tile's q slices
// arrive by cp.async in the interleaved layout (fragments by ldmatrix), and
// the head's keys (pass 1) and keys and values (pass 2) stream through two
// shared-memory buffers in 64-frame chunks, interleaved too: pass 1 takes
// each row's max and sum over all frames, pass 2 recomputes the logits,
// normalizes (exp(s - max) times 1 / sum), rounds to bf16 and accumulates
// P.V in f32: K5's contract with the keys in tiles. 8 warps take 128 query
// frames a tile, so the keys stream twice per 128 frames.
constexpr int kLongThreads = 256, kLongRows = 2 * kKeyTile;

__global__ void __launch_bounds__(kLongThreads)
time_attention_long_tc_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, int ldkv, bf16* __restrict__ out,
                              int Tn, int H, float scale) {
  constexpr int D = kDimHead, CH = kKeyTile * D;
  __shared__ __align__(16) unsigned char long_smem[6 * CH * sizeof(bf16)];
  bf16* const qs = reinterpret_cast<bf16*>(long_smem);  // the query tile, 2 x CH
  bf16* const ks0 = qs + 2 * CH;                         // 2 x CH
  bf16* const vs0 = qs + 4 * CH;                         // 2 x CH
  const int mtrack = blockIdx.x / H, h = blockIdx.x % H, C = H * D;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2;
  const size_t row0 = static_cast<size_t>(mtrack) * Tn;
  const int nch = (Tn + kKeyTile - 1) / kKeyTile;
  auto load = [&](int c, int buf, bool with_v) {
    const int parts = with_v ? 12 : 6;
    for (int i = tid; i < kKeyTile * parts; i += kLongThreads) {
      const int key = i / parts, p = i % parts, j = c * kKeyTile + key;
      const bool ok = j < Tn;
      const size_t o = (row0 + (ok ? j : 0)) * ldkv + h * D;
      if (p < 6) cp_async16(ks0 + buf * CH + ilv(key, p), k + o + 8 * p, ok);
      else cp_async16(vs0 + buf * CH + ilv(key, p - 6), v + o + 8 * (p - 6), ok);
    }
  };
  const int lo[2] = {0, 0}, hi[2] = {Tn, Tn};
  for (int qt = 0; qt < Tn; qt += kLongRows) {
    __syncthreads();
    for (int i = tid; i < kLongRows * 6; i += kLongThreads) {
      const int r = i / 6, c = i % 6, j = qt + r;
      const bool ok = j < Tn;
      cp_async16(qs + ilv(r, c), q + (row0 + (ok ? j : 0)) * ldq + h * D + 8 * c, ok);
    }
    cp_async_commit();
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2], rl[2] = {0.f, 0.f};
    float acc[6][4] = {};
    uint32_t qa[3][4];
    for (int pass = 0; pass < 2; ++pass) {
      __syncthreads();
      load(0, 0, pass == 1);
      cp_async_commit();
      for (int c = 0; c < nch; ++c) {
        if (c + 1 < nch) load(c + 1, (c + 1) & 1, pass == 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (pass == 0 && c == 0) load_q_ilv(qa, qs, warp * 16);
        float S[8][4];
        chunk_scores_ilv(S, qa, ks0 + (c & 1) * CH);
        mask_rows(S, c, scale, lo, hi);
        if (pass == 0) {
          online_update(S, m, l, alpha);
        } else {
          normalize_rcp(S, m, rl);
          chunk_pv_ilv(acc, S, vs0 + (c & 1) * CH);
        }
        __syncthreads();
      }
      rl[0] = __frcp_rn(l[0]);
      rl[1] = __frcp_rn(l[1]);
    }
    const int ia = qt + warp * 16 + g, ib = ia + 8;
    store_rows<bf16>(acc, ia < Tn ? out + (row0 + ia) * C + h * D : nullptr,
                     ib < Tn ? out + (row0 + ib) * C + h * D : nullptr);
  }
  cp_async_wait<0>();
}

// Time core past kMaxKeys frames, f32 (K5's long route in f32, which only
// the CPU-parity path of the tests reaches on the card): one warp per query
// frame on the CUDA cores, keys read from device memory (L2) in three
// passes, max, sum and P.V, the logits recomputed in each.
__global__ void __launch_bounds__(kCoreThreads)
time_attention_long_f32_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ k,
                               const float* __restrict__ v, int ldkv, float* __restrict__ out,
                               int Tn, int H, float scale) {
  constexpr int D = kDimHead;
  const int mtrack = blockIdx.x, h = blockIdx.y, C = H * D;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(mtrack) * Tn;
  for (int i = warp; i < Tn; i += nw) {
    float qv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qv[d] = q[(row0 + i) * ldq + h * D + d];
    auto logit = [&](int j) {
      const float* kr = k + (row0 + j) * ldkv + h * D;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s += qv[d] * kr[d];
      return __fmul_rn(s, scale);
    };
    float mx = -INFINITY;
    for (int j = lane; j < Tn; j += 32) mx = fmaxf(mx, logit(j));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Tn; j += 32) sum += expf(__fsub_rn(logit(j), mx));
    sum = warp_sum(sum);
    float a0 = 0.f, a1 = 0.f;
    for (int j0 = 0; j0 < Tn; j0 += 32) {
      const int j = j0 + lane, nj = min(32, Tn - j0);
      const float p = j < Tn ? __fdiv_rn(expf(__fsub_rn(logit(j), mx)), sum) : 0.f;
      for (int jj = 0; jj < nj; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = v + (row0 + j0 + jj) * ldkv + h * D;
        a0 += pj * vr[lane];
        if (lane < D - 32) a1 += pj * vr[lane + 32];
      }
    }
    float* orow = out + (row0 + i) * C + h * D;
    orow[lane] = a0;
    if (lane < D - 32) orow[lane + 32] = a1;
  }
}

// ---------------------------------------------------------------- launchers
// Each returns the launch's cudaError_t; shapes are validated by the callers'
// extern "C" entries through the *_ok helpers.

template <typename Kern>
cudaError_t set_smem(Kern k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Shared memory of the two staged cores: `keys` rows of K (49 floats) and V
// (48), plus one score row of `keys` floats per warp.
inline size_t staged_smem(int keys) {
  return static_cast<size_t>(keys) * (2 * kDimHead + 1 + kCoreThreads / 32) * sizeof(float);
}

inline bool time_shape_ok(int M, int T, int H, int D, bool capped = true) {
  return M >= 1 && T >= 1 && (!capped || T <= kMaxKeys) && H >= 1 && H <= 65535 &&
         D == kDimHead;
}

inline bool p2v_shape_ok(int N, int T, int V, int H, int D) {
  return N >= 1 && T >= 1 && V >= 1 && V <= kMaxKeys && H >= 1 && H <= 65535 &&
         (N + 63) / 64 <= 65535 && D == kDimHead;
}

inline bool v2p_shape_ok(int N, int T, int V, int H, int D) {
  return N >= 1 && T >= 1 && V >= 1 && H >= 1 && H <= 65535 &&
         static_cast<long long>(T) * ((V + 63) / 64) <= 65535 && D == kDimHead;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

template <typename T, typename OutT>
cudaError_t launch_time_attention(const void* q, int ldq, const void* k, const void* v,
                                  int ldkv, void* out, int M, int Tn, int H, float scale,
                                  cudaStream_t s) {
  if (Tn > kMaxKeys) {  // the long route: keys in tiles
    if constexpr (std::is_same<T, bf16>::value && std::is_same<OutT, bf16>::value) {
      time_attention_long_tc_kernel<<<M * H, kLongThreads, 0, s>>>(
          static_cast<const bf16*>(q), ldq, static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), ldkv, static_cast<bf16*>(out), Tn, H, scale);
    } else if constexpr (std::is_same<T, float>::value && std::is_same<OutT, float>::value) {
      time_attention_long_f32_kernel<<<dim3(M, H), kCoreThreads, 0, s>>>(
          static_cast<const float*>(q), ldq, static_cast<const float*>(k),
          static_cast<const float*>(v), ldkv, static_cast<float*>(out), Tn, H, scale);
    } else {
      return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
  auto kern = time_attention_kernel<T, OutT>;
  const size_t smem = staged_smem(Tn);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(M, H), kCoreThreads, smem, s>>>(
      static_cast<const T*>(q), ldq, static_cast<const T*>(k), static_cast<const T*>(v), ldkv,
      static_cast<OutT*>(out), Tn, H, scale);
  return cudaGetLastError();
}

// The bf16 time core's plan (ops/kernels/attention_cuda.py::k5_plan):
// NC the chunks held in registers (1-4; 0: two passes over rows_pad / 64
// chunks), hs heads and `tracks` whole tracks a block, rows_pad staged rows.
inline size_t time_tc_smem(int hs, int rows_pad) {
  return 3 * static_cast<size_t>(hs) * rows_pad * kDimHead * sizeof(bf16);
}

inline bool time_tc_plan_ok(int Tn, int H, int nc, int hs, int tracks, int rows_pad) {
  return hs >= 1 && hs <= H && tracks >= 1 && rows_pad % kKeyTile == 0 &&
         static_cast<long long>(tracks) * Tn <= rows_pad && (nc == 0 || rows_pad == kKeyTile * nc) &&
         nc >= 0 && nc <= 4 && time_tc_smem(hs, rows_pad) <= 232448;
}

// q, k, v rows as launch_time_attention; out (M*Tn, C) bf16. Tn <= kMaxKeys.
inline cudaError_t launch_time_tc(const bf16* q, int ldq, const bf16* k, const bf16* v, int ldkv,
                                  bf16* out, int M, int Tn, int H, float scale, int nc, int hs,
                                  int tracks, int rows_pad, cudaStream_t s) {
  if (!time_tc_plan_ok(Tn, H, nc, hs, tracks, rows_pad)) return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>((M + tracks - 1) / tracks) * ((H + hs - 1) / hs);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = time_tc_smem(hs, rows_pad);
  auto kern = time_tc_kernel<0>;
  int threads = time_tc_threads<0>();
  switch (nc) {
    case 1: kern = time_tc_kernel<1>; threads = time_tc_threads<1>(); break;
    case 2: kern = time_tc_kernel<2>; threads = time_tc_threads<2>(); break;
    case 3: kern = time_tc_kernel<3>; threads = time_tc_threads<3>(); break;
    case 4: kern = time_tc_kernel<4>; threads = time_tc_threads<4>(); break;
  }
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(blocks), threads, smem, s>>>(q, ldq, k, v, ldkv, out, M, Tn, H, hs,
                                                             tracks, rows_pad, scale);
  return cudaGetLastError();
}

// bf16 operands take the tensor-core body: a block per (frame, track range,
// head group), the ranges sized for about four blocks per SM in all (two
// waves of two resident blocks: a short tail); f32 the first version.
template <typename T, typename OutT>
cudaError_t launch_p2v_attention(const void* q, const void* kv, void* out, int N, int Tn,
                                 int V, int H, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int vpad = (V + kKeyTile - 1) / kKeyTile * kKeyTile;
    const int hs = std::max(1, std::min(H, kP2vStagedRows / vpad));
    const int groups = (H + hs - 1) / hs;
    const int per_frame =
        std::max(1, std::min((4 * sm_count() + Tn * groups - 1) / (Tn * groups), (N + 15) / 16));
    const int tracks = ((N + per_frame - 1) / per_frame + 15) / 16 * 16;
    const size_t stage = 16 * kDimHead * std::max(sizeof(OutT), sizeof(bf16));
    const size_t smem = 2 * static_cast<size_t>(hs) * vpad * kDimHead * sizeof(bf16) +
                        (kP2vThreads / 32) * 2 * stage;
    auto kern = p2v_tc_kernel<OutT>;
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(Tn, (N + tracks - 1) / tracks, groups), kP2vThreads, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<OutT*>(out), N,
        Tn, V, H, hs, vpad, tracks, scale);
    return cudaGetLastError();
  } else {
    auto kern = p2v_attention_kernel<T, OutT>;
    const size_t smem = staged_smem(V);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(Tn, H, (N + 63) / 64), kCoreThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<OutT*>(out), N, Tn, V,
        scale);
    return cudaGetLastError();
  }
}

// bf16: the keys in `splits` ranges of whole 64-key tiles, partials into
// part (splits * Tn * V * (C + 2H) floats, from the caller), then the merge;
// f32: the first version (part unused).
template <typename T>
cudaError_t launch_v2p_flash(const void* q, const void* kv, const float* bias, void* out,
                             float* part, int splits, int N, int Tn, int V, int H, float scale,
                             cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (splits < 1 || part == nullptr) return cudaErrorInvalidValue;
    const int tiles = (N + kKeyTile - 1) / kKeyTile;
    const int split_keys = (tiles + splits - 1) / splits * kKeyTile;
    const int used = (N + split_keys - 1) / split_keys;
    v2p_tc_kernel<<<dim3(H, used, Tn * ((V + 63) / 64)), kTcThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kv), bias, part, N, Tn, V, H,
        split_keys, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    v2p_merge_kernel<bf16><<<Tn * V, kTcThreads, 0, s>>>(part, static_cast<bf16*>(out), used, Tn,
                                                        V, H);
    return cudaGetLastError();
  } else {
    v2p_flash_kernel<T><<<dim3(Tn, H, (V + 63) / 64), kCoreThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kv), bias, static_cast<T*>(out), N, Tn,
        V, H, scale);
    return cudaGetLastError();
  }
}

}  // namespace ct
