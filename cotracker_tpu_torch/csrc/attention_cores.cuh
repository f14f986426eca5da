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
#pragma once

#include "common.cuh"

#include <math.h>

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

inline bool time_shape_ok(int M, int T, int H, int D) {
  return M >= 1 && T >= 1 && T <= kMaxKeys && H >= 1 && H <= 65535 && D == kDimHead;
}

inline bool p2v_shape_ok(int N, int T, int V, int H, int D) {
  return N >= 1 && T >= 1 && V >= 1 && V <= kMaxKeys && H >= 1 && H <= 65535 &&
         (N + 63) / 64 <= 65535 && D == kDimHead;
}

inline bool v2p_shape_ok(int N, int T, int V, int H, int D) {
  return N >= 1 && T >= 1 && V >= 1 && H >= 1 && H <= 65535 && (V + 63) / 64 <= 65535 &&
         D == kDimHead;
}

template <typename T, typename OutT>
cudaError_t launch_time_attention(const void* q, int ldq, const void* k, const void* v,
                                  int ldkv, void* out, int M, int Tn, int H, float scale,
                                  cudaStream_t s) {
  auto kern = time_attention_kernel<T, OutT>;
  const size_t smem = staged_smem(Tn);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(M, H), kCoreThreads, smem, s>>>(
      static_cast<const T*>(q), ldq, static_cast<const T*>(k), static_cast<const T*>(v), ldkv,
      static_cast<OutT*>(out), Tn, H, scale);
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_p2v_attention(const void* q, const void* kv, void* out, int N, int Tn,
                                 int V, int H, float scale, cudaStream_t s) {
  auto kern = p2v_attention_kernel<T, OutT>;
  const size_t smem = staged_smem(V);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(Tn, H, (N + 63) / 64), kCoreThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<OutT*>(out), N, Tn, V,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_v2p_flash(const void* q, const void* kv, const float* bias, void* out, int N,
                             int Tn, int V, int H, float scale, cudaStream_t s) {
  v2p_flash_kernel<T><<<dim3(Tn, H, (V + 63) / 64), kCoreThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), bias, static_cast<T*>(out), N, Tn, V,
      H, scale);
  return cudaGetLastError();
}

}  // namespace ct
