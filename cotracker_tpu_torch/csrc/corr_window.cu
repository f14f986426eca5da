// K4, K4r, K4f and K4m: the correlation kernels of the correlation
// featurizer (sm_90a).
//
// All four replace cotracker_tpu/ops/kernels/corr_pallas.py::_kernel, one
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
// K4m (fuse_mlp1, corr_pallas.py:244-333 with the plan :509-560 and the
// epilogue :706-712): the whole correlation epilogue up to MLP1 in one
// launch, per point:
//   1. pass A: the raw s32 volume of every frame (K4r's device code) and
//      its absmax over ALL 64 taps x 49 x Tp rows, junk taps x==7 / y==7
//      and the padded frame included: s = max(absmax, 1e-20) / 127 (from
//      the raw volume, before the combine: a convex combine never exceeds
//      it);
//   2. pass B, frames in groups of 16: the raw volume again, the separable
//      lerps gx = a + wx*(b - a) (b the x+1 tap), c = gx0 + wy*(gx8 - gx0)
//      (gx8 the y+1 row) for the 7 x 7 x 49 = 2,401 real taps only (their
//      taps never leave the frame; the zero MLP1 rows of the JAX layout
//      kill every other tap), codes rint(c * (1/s)) into shared memory;
//   3. the s8 MLP1 product of the group's 16 code rows against the
//      per-output-channel W1 codes (384 x 2,432, zero past 2,401), staged
//      through shared memory 64 bytes of K at a time, on tensor cores;
//   4. out = (h32 * w1scale) * (s * support scale) + b1 in f32, in that
//      order, stored in the compute dtype: pre-GELU hidden rows
//      (NP, Tp, 384).
// At the quasi-dense chunk (2,048 points x 16 frames) the MLP1 product is
// 60 s8 GOP (0.03 ms at the int8 peak) against ~0.6 GB of window reads:
// bytes bound it, and this first version adds a second contraction pass
// and re-reads the 0.9 MB W1 from L2 for every 16 frames of a point.
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

// K4m. 128 threads; shared memory 99,728 bytes (two blocks per SM): the
// window and support as K4, one frame's s32 volume, the 16 code rows of a
// frame group (2,448-byte rows) and a 384 x 80 W1 slice.
constexpr int kTaps = 7 * 7 * kS, kKm = 2432, kLdm = kKm + 16, kDh = 384, kFG = 16;
constexpr int kBKm = 64, kLdb = kBKm + 16;
constexpr size_t kMlp1Smem = static_cast<size_t>(kR) * kLds + kSp * kLds + kR * kS * 4 +
                             kFG * kLdm + kDh * kLdb + 16;

template <typename OutT>
__global__ void __launch_bounds__(128)
corr_mlp1_kernel(const int8_t* __restrict__ fm, const int8_t* __restrict__ sup,
                 const int* __restrict__ starts, const float* __restrict__ wxy,
                 const int8_t* __restrict__ w1, const float* __restrict__ w1s,
                 const float* __restrict__ b1, const float* __restrict__ sup_scale,
                 OutT* __restrict__ out, int Tp, int Hp, int Wp) {
  extern __shared__ __align__(16) unsigned char mlp1_smem[];
  int8_t* win_s = reinterpret_cast<int8_t*>(mlp1_smem);
  int8_t* sup_s = win_s + kR * kLds;
  int* G = reinterpret_cast<int*>(sup_s + kSp * kLds);
  int8_t* codes = reinterpret_cast<int8_t*>(G + kR * kS);
  int8_t* Bs = codes + kFG * kLdm;
  float* red_s = reinterpret_cast<float*>(Bs + kDh * kLdb);
  const int p = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (int i = tid; i < kSp * (kC / 16); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < kS) v = *reinterpret_cast<const int4*>(sup + (static_cast<size_t>(p) * kS + r) * kC + c);
    *reinterpret_cast<int4*>(sup_s + r * kLds + c) = v;
  }
  const int* st = starts + static_cast<size_t>(p) * Tp * 3;

  // pass A: the per-point scale from the raw volume
  float amax = 0.f;
  for (int t = 0; t < Tp; ++t) {
    frame_corr(fm, st + t * 3, Hp, Wp, win_s, sup_s, G);
    for (int e = tid; e < kR * kS; e += blockDim.x) amax = fmaxf(amax, fabsf(static_cast<float>(G[e])));
  }
  amax = warp_max(amax);
  if (lane == 0) red_s[warp] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(red_s[0], red_s[1]), fmaxf(red_s[2], red_s[3]));
  const float sc = __fmul_rn(fmaxf(amax, 1e-20f), 1.0f / 127.0f);
  const float inv = 1.0f / sc;
  const float scale_p = __fmul_rn(sc, sup_scale[p]);

  // pass B: combine + codes per frame group, then MLP1 on the group's rows
  for (int t0 = 0; t0 < Tp; t0 += kFG) {
    const int nf = min(kFG, Tp - t0);
    for (int f = 0; f < nf; ++f) {
      const int t = t0 + f;
      frame_corr(fm, st + t * 3, Hp, Wp, win_s, sup_s, G);
      const float wx = wxy[(static_cast<size_t>(p) * Tp + t) * 2];
      const float wy = wxy[(static_cast<size_t>(p) * Tp + t) * 2 + 1];
      for (int e = tid; e < kTaps; e += blockDim.x) {
        const int w = e / kS, s = e - w * kS, y = w / 7, r = y * 8 + (w - y * 7);
        const float g00 = static_cast<float>(G[r * kS + s]);
        const float g01 = static_cast<float>(G[(r + 1) * kS + s]);
        const float g10 = static_cast<float>(G[(r + 8) * kS + s]);
        const float g11 = static_cast<float>(G[(r + 9) * kS + s]);
        const float gx = __fadd_rn(g00, __fmul_rn(wx, __fsub_rn(g01, g00)));
        const float gx8 = __fadd_rn(g10, __fmul_rn(wx, __fsub_rn(g11, g10)));
        codes[f * kLdm + e] = quant8(__fadd_rn(gx, __fmul_rn(wy, __fsub_rn(gx8, gx))), inv);
      }
    }
    __syncthreads();
    // h32[f][n] = codes[f] . w1[n]: 16 rows x 384 columns, warp w the
    // columns 96w..96w+95 (12 n8 tiles)
    int acc[12][4];
#pragma unroll
    for (int nt = 0; nt < 12; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0;
    for (int k0 = 0; k0 < kKm; k0 += kBKm) {
      for (int i = tid; i < kDh * (kBKm / 16); i += blockDim.x) {
        const int r = i >> 2, c = (i & 3) * 16;
        *reinterpret_cast<int4*>(Bs + r * kLdb + c) =
            *reinterpret_cast<const int4*>(w1 + static_cast<size_t>(r) * kKm + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBKm; kk += 32) {
        const int8_t* pa = codes + g * kLdm + k0 + kk + t4 * 4;
        const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * kLdm), ld32(pa + 16), ld32(pa + 8 * kLdm + 16)};
#pragma unroll
        for (int nt = 0; nt < 12; ++nt) {
          const int8_t* pb = Bs + (warp * 96 + nt * 8 + g) * kLdb + kk + t4 * 4;
          const uint32_t b[2] = {ld32(pb), ld32(pb + 16)};
          mma_s8_16832(acc[nt], a, b);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < 12; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = g + (k >> 1) * 8, col = warp * 96 + nt * 8 + t4 * 2 + (k & 1);
        if (f >= nf) continue;
        const float h = __fmul_rn(__fmul_rn(static_cast<float>(acc[nt][k]), w1s[col]), scale_p);
        out[(static_cast<size_t>(p) * Tp + t0 + f) * kDh + col] = from_f<OutT>(__fadd_rn(h, b1[col]));
      }
  }
}

template <typename OutT>
int launch_mlp1(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                const int8_t* w1, const float* w1s, const float* b1, const float* sup_scale,
                void* out, int NP, int Tp, int Hp, int Wp, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(corr_mlp1_kernel<OutT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kMlp1Smem));
  if (e != cudaSuccess) return e;
  corr_mlp1_kernel<OutT><<<NP, 128, kMlp1Smem, static_cast<cudaStream_t>(stream)>>>(
      fm, sup, starts, wxy, w1, w1s, b1, sup_scale, static_cast<OutT*>(out), Tp, Hp, Wp);
  return cudaGetLastError();
}

}  // namespace ct

extern "C" {

// K4m: out (NP, Tp, 384) pre-GELU MLP1 rows, bf16 (out_bf16) or float32;
// w1 (384, 2432) int8 codes, w1s / b1 (384,) f32, sup_scale (NP,) f32.
int ct_corr_mlp1(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                 const int8_t* w1, const float* w1s, const float* b1, const float* sup_scale,
                 void* out, int out_bf16, int NP, int Tp, int Hp, int Wp, int Dh, void* stream) {
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8 || Dh != ct::kDh) return cudaErrorInvalidValue;
  return out_bf16 ? ct::launch_mlp1<__nv_bfloat16>(fm, sup, starts, wxy, w1, w1s, b1, sup_scale,
                                                   out, NP, Tp, Hp, Wp, stream)
                  : ct::launch_mlp1<float>(fm, sup, starts, wxy, w1, w1s, b1, sup_scale, out, NP,
                                           Tp, Hp, Wp, stream);
}


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
