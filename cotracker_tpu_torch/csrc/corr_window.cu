// K4, K4r and K4f: the correlation volumes of the correlation featurizer (sm_90a).
//
// All three replace cotracker_tpu/ops/kernels/corr_pallas.py::_kernel, one
// mode each. One block per point walks its Tp frames; frame t reads the
// 8x8x128 window at (frame, wsy, wsx) of the edge-padded level map and
// contracts it with the point's 49x128 support: g (64 window taps x 49).
// Every output is (NP, Tp, 64, 49), flatten order (t, y, x, s).
//
// K4 (fuse_combine + g_int8; driven there by _corr_level_plan.hidden and
// fused_corr_tokens_pallas), the inference fast path:
//   1. int8 windows (codes clip(rint(f * 128))) and an int8 support with a
//      per-point scale, contracted on tensor cores (mma.sync m16n8k32,
//      s8 x s8 -> s32);
//   2. combined bilinearly in correlation space with the frame's (wx, wy):
//      c[r] = lerp_y(lerp_x(g[r], g[r+1]), lerp_x(g[r+8], g[r+9])) over the
//      flattened (t, y, x) lane axis of length Tp*64, wrapping mod Tp*64
//      exactly like the Pallas lane roll, so the x==7 / y==7 lanes and the
//      padded frame hold the same junk (zero MLP1 rows kill them downstream,
//      but they enter the per-point scale);
//   3. per-point scale = max(absmax(c), 1e-20) / 127 over the whole slab and
//      codes rint(c * (1/scale)).
// K4r (g_int8 without the combine, corr_pallas.py:391-400), the training
// default: the same device code with the combine skipped, so the scale is
// the absmax of the RAW s32 volume and the codes are rint(g * (1/scale)).
// Both make two passes (absmax, then codes): the scale must be known before
// any code is written, and recomputing the cheap tensor-core contraction
// beats holding 750 KB of s32 volume per point.
// K4f (plain g, corr_pallas.py:401-402): float (f32 or bf16) windows and
// support, f32 FMAs over a window staged in shared memory, the volume
// written in the input dtype. One pass, no scale.
//
// What bounds them: at level 0 of the inference shape (2,048-point chunk,
// T=60) K4 reads ~1 GB of windows (every window twice, mostly from L2) and
// writes ~385 MB of codes; the contraction itself is ~50 s8 GOP. Memory and
// the combine's shared-memory traffic bound K4 and K4r, not the tensor
// cores. K4f does the same contraction as ~100 f32 GFLOP on the CUDA cores
// (no tensor cores), which bounds it.

#include "common.cuh"

namespace ct {

constexpr int kC = 128, kLds = kC + 16, kS = 49, kSp = 56, kR = 64;

// g[r][s] = window_t[r] . support[s] for the 64 window taps of frame t.
__device__ __forceinline__ void frame_corr(const int8_t* __restrict__ fm,
                                           const int* __restrict__ st, int Hp, int Wp,
                                           int8_t* win_s, const int8_t* sup_s, int* G) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int f = st[0], wy = st[1], wx = st[2];
  __syncthreads();  // previous readers of win_s and of G are done
  for (int i = tid; i < kR * (kC / 16); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 16, y = r >> 3, x = r & 7;
    const int8_t* src = fm + ((static_cast<size_t>(f) * Hp + wy + y) * Wp + wx + x) * kC + c;
    *reinterpret_cast<int4*>(win_s + r * kLds + c) = *reinterpret_cast<const int4*>(src);
  }
  __syncthreads();
  int acc[kSp / 8][4];
#pragma unroll
  for (int nt = 0; nt < kSp / 8; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[nt][k] = 0;
#pragma unroll
  for (int kk = 0; kk < kC; kk += 32) {
    const int8_t* pa = win_s + (warp * 16 + g) * kLds + kk + t4 * 4;
    const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * kLds), ld32(pa + 16), ld32(pa + 8 * kLds + 16)};
#pragma unroll
    for (int nt = 0; nt < kSp / 8; ++nt) {
      const int8_t* pb = sup_s + (nt * 8 + g) * kLds + kk + t4 * 4;
      const uint32_t b[2] = {ld32(pb), ld32(pb + 16)};
      mma_s8_16832(acc[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kSp / 8; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp * 16 + g + (k >> 1) * 8, s = nt * 8 + t4 * 2 + (k & 1);
      if (s < kS) G[r * kS + s] = acc[nt][k];
    }
  __syncthreads();
}

// 128 threads = 4 warps, one 16-tap row tile each. kCombine: K4, else K4r.
template <bool kCombine>
__global__ void __launch_bounds__(128)
corr_volume_kernel(const int8_t* __restrict__ fm, const int8_t* __restrict__ sup,
                   const int* __restrict__ starts, const float* __restrict__ wxy,
                   int8_t* __restrict__ vol, float* __restrict__ scale_out, int Tp, int Hp,
                   int Wp) {
  __shared__ __align__(16) int8_t win_s[kR * kLds];
  __shared__ __align__(16) int8_t sup_s[kSp * kLds];
  __shared__ int G[kCombine ? 2 : 1][kR * kS];
  __shared__ float red_s[4];
  const int p = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < kSp * (kC / 16); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < kS) v = *reinterpret_cast<const int4*>(sup + (static_cast<size_t>(p) * kS + r) * kC + c);
    *reinterpret_cast<int4*>(sup_s + r * kLds + c) = v;
  }
  const int* st = starts + static_cast<size_t>(p) * Tp * 3;
  float amax = 0.f, inv = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    if (kCombine) frame_corr(fm, st, Hp, Wp, win_s, sup_s, G[0]);
    for (int t = 0; t < Tp; ++t) {
      const int* Gc = G[kCombine ? (t & 1) : 0];
      const int* Gn = G[kCombine ? ((t + 1) & 1) : 0];
      if (kCombine)
        frame_corr(fm, st + ((t + 1) % Tp) * 3, Hp, Wp, win_s, sup_s, G[(t + 1) & 1]);
      else
        frame_corr(fm, st + t * 3, Hp, Wp, win_s, sup_s, G[0]);
      const float wx = kCombine ? wxy[(static_cast<size_t>(p) * Tp + t) * 2] : 0.f;
      const float wy = kCombine ? wxy[(static_cast<size_t>(p) * Tp + t) * 2 + 1] : 0.f;
      int8_t* out = vol + (static_cast<size_t>(p) * Tp + t) * (kR * kS);
      for (int e = tid; e < kR * kS; e += blockDim.x) {
        float c = static_cast<float>(Gc[e]);
        if (kCombine) {
          const int r = e / kS, s = e - r * kS;
          const float g00 = c;
          const float g01 = static_cast<float>(r + 1 < kR ? Gc[e + kS] : Gn[(r + 1 - kR) * kS + s]);
          const float g10 = static_cast<float>(r + 8 < kR ? Gc[e + 8 * kS] : Gn[(r + 8 - kR) * kS + s]);
          const float g11 = static_cast<float>(r + 9 < kR ? Gc[e + 9 * kS] : Gn[(r + 9 - kR) * kS + s]);
          const float gx = __fadd_rn(g00, __fmul_rn(wx, __fsub_rn(g01, g00)));
          const float gx1 = __fadd_rn(g10, __fmul_rn(wx, __fsub_rn(g11, g10)));
          c = __fadd_rn(gx, __fmul_rn(wy, __fsub_rn(gx1, gx)));
        }
        if (pass == 0)
          amax = fmaxf(amax, fabsf(c));
        else
          out[e] = quant8(c, inv);
      }
    }
    if (pass == 0) {
      amax = warp_max(amax);
      if ((tid & 31) == 0) red_s[tid >> 5] = amax;
      __syncthreads();
      amax = fmaxf(fmaxf(red_s[0], red_s[1]), fmaxf(red_s[2], red_s[3]));
      const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
      inv = 1.0f / sc;
      if (tid == 0) scale_out[p] = sc;
    }
  }
}

// K4f. 128 threads; thread (ry, sx) = (tid / 8, tid % 8) accumulates the
// 4 x 7 outputs at rows ry + 16i and support taps sx + 8j in f32. Window and
// support sit in shared memory as f32 with rows padded to 129 words, so a
// warp's loads of one channel fall on distinct banks or broadcast.
constexpr int kFl = kC + 1;
constexpr size_t kFloatSmem = static_cast<size_t>(kR + kSp) * kFl * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(128)
corr_volume_float_kernel(const T* __restrict__ fm, const T* __restrict__ sup,
                         const int* __restrict__ starts, T* __restrict__ vol, int Tp, int Hp,
                         int Wp) {
  extern __shared__ float smem[];
  float* win_s = smem;               // (64, 129)
  float* sup_s = smem + kR * kFl;    // (56, 129), rows 49.. zero
  const int p = blockIdx.x, tid = threadIdx.x, ry = tid >> 3, sx = tid & 7;
  for (int i = tid; i < kSp * kC; i += blockDim.x) {
    const int r = i / kC, c = i - r * kC;
    sup_s[r * kFl + c] = r < kS ? to_f(sup[(static_cast<size_t>(p) * kS + r) * kC + c]) : 0.f;
  }
  const int* st = starts + static_cast<size_t>(p) * Tp * 3;
  for (int t = 0; t < Tp; ++t) {
    const int f = st[t * 3], wy = st[t * 3 + 1], wx = st[t * 3 + 2];
    __syncthreads();  // the previous frame's readers of win_s are done
    for (int i = tid; i < kR * kC; i += blockDim.x) {
      const int r = i / kC, c = i - r * kC, y = r >> 3, x = r & 7;
      win_s[r * kFl + c] = to_f(fm[((static_cast<size_t>(f) * Hp + wy + y) * Wp + wx + x) * kC + c]);
    }
    __syncthreads();
    float acc[4][7];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 7; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      float a[4], b[7];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = win_s[(ry + 16 * i) * kFl + c];
#pragma unroll
      for (int j = 0; j < 7; ++j) b[j] = sup_s[(sx + 8 * j) * kFl + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 7; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    T* out = vol + (static_cast<size_t>(p) * Tp + t) * (kR * kS);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int s = sx + 8 * j;
        if (s < kS) out[(ry + 16 * i) * kS + s] = from_f<T>(acc[i][j]);
      }
  }
}

template <typename T>
int launch_float(const T* fm, const T* sup, const int* starts, T* vol, int NP, int Tp, int Hp,
                 int Wp, void* stream) {
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      corr_volume_float_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFloatSmem));
  if (e != cudaSuccess) return e;
  corr_volume_float_kernel<T><<<NP, 128, kFloatSmem, static_cast<cudaStream_t>(stream)>>>(
      fm, sup, starts, vol, Tp, Hp, Wp);
  return cudaGetLastError();
}

}  // namespace ct

extern "C" {

// K4 (combine != 0) and K4r (combine == 0).
int ct_corr_volume(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                   int8_t* vol, float* scale, int NP, int Tp, int Hp, int Wp, int combine,
                   void* stream) {
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (combine)
    ct::corr_volume_kernel<true><<<NP, 128, 0, s>>>(fm, sup, starts, wxy, vol, scale, Tp, Hp, Wp);
  else
    ct::corr_volume_kernel<false><<<NP, 128, 0, s>>>(fm, sup, starts, wxy, vol, scale, Tp, Hp, Wp);
  return cudaGetLastError();
}

// K4f in float32 and in bfloat16.
int ct_corr_volume_f32(const float* fm, const float* sup, const int* starts, float* vol, int NP,
                       int Tp, int Hp, int Wp, void* stream) {
  return ct::launch_float(fm, sup, starts, vol, NP, Tp, Hp, Wp, stream);
}

int ct_corr_volume_bf16(const __nv_bfloat16* fm, const __nv_bfloat16* sup, const int* starts,
                        __nv_bfloat16* vol, int NP, int Tp, int Hp, int Wp, void* stream) {
  return ct::launch_float(fm, sup, starts, vol, NP, Tp, Hp, Wp, stream);
}

}  // extern "C"
