// K4, K4r, K4f and K4m: the correlation kernels of the correlation
// featurizer (sm_90a).
//
// All four replace cotracker_tpu/ops/kernels/corr_pallas.py::_kernel, one
// mode each. Per point and frame t, the 8x8x128 window at (frame, wsy, wsx)
// of the edge-padded level map is contracted with the point's 49x128
// support: g (64 window taps x 49). Every output is (NP, Tp, 64, 49),
// flatten order (t, y, x, s).
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
// Its design (corr_volume_kernel, below; the tiling is corr_cuda.k4_plan):
// a point's frames are split over a thread-block cluster, each warp takes
// whole frames, the windows arrive by cp.async while the warp's previous
// frame computes, the combine runs on the product fragments in registers,
// and the scale is reduced across the cluster through distributed shared
// memory. Up to 64 frames every block holds its frames' combined volume in
// shared memory, so the windows, products and combines run once (the first
// version ran all of them twice); past 64 frames the cluster takes two
// passes (the absmax, then the codes) with the same pipeline.
// K4r (g_int8 without the combine, corr_pallas.py:391-400), the training
// default: the first version's body with the combine taken out, one block a
// point, two passes (absmax of the RAW s32 volume, then the codes
// rint(g * (1/scale))).
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
// What bounds them (one NVIDIA H100 80GB HBM3, 700 W; PERF.md): K4 at level
// 0 of the inference shape (a 2,048-point chunk, T=60) must write ~385 MB of
// codes and read the 124 MB level: 0.157 ms at the memory's rate, against
// ~50 s8 GOP of products (0.03 ms at the int8 peak). It takes 0.99-1.01 ms
// (2.76 for the first version: two passes, the combine from shared memory
// with an integer division an element), as fast at level 3 (a 1.5 MB map)
// as at level 0: not bytes. By count a warp's frame is ~1,800 instructions
// (140 mma, the combine's shuffles, lerps and stores), and at 254
// registers a thread (the support's fragments held across frames) and
// 109,600 bytes of shared memory a block, two blocks of 4 warps share an
// SM: too few warps to hide the instructions' latency. Not profiled (the
// card's machine runs no ncu).
// K4r reads ~1 GB of windows (every window twice, mostly from L2): memory
// and its shared-memory combine traffic bound it. K4f does the same
// contraction as ~100 f32 GFLOP on the CUDA cores (no tensor cores), which
// bounds it.

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

// K4r: 128 threads = 4 warps, one 16-tap row tile each, two passes over the
// frames (absmax of the raw volume, then its codes).
__global__ void __launch_bounds__(128)
corr_volume_raw_kernel(const int8_t* __restrict__ fm, const int8_t* __restrict__ sup,
                       const int* __restrict__ starts, int8_t* __restrict__ vol,
                       float* __restrict__ scale_out, int Tp, int Hp, int Wp) {
  __shared__ __align__(16) int8_t win_s[kR * kLds];
  __shared__ __align__(16) int8_t sup_s[kSp * kLds];
  __shared__ int G[kR * kS];
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
    for (int t = 0; t < Tp; ++t) {
      frame_corr(fm, st + t * 3, Hp, Wp, win_s, sup_s, G);
      int8_t* out = vol + (static_cast<size_t>(p) * Tp + t) * (kR * kS);
      for (int e = tid; e < kR * kS; e += blockDim.x) {
        const float c = static_cast<float>(G[e]);
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

// ---------------------------------------------------------------- K4
// One point's frames are split over a cluster of `cs` blocks (rank k takes
// frames [k*Tp/cs, (k+1)*Tp/cs)), 4 warps a block, one frame a warp at a
// time. A warp's frame job:
//   * window: the frame's 64 taps and the next frame's first 16 (mod Tp;
//     the combine's wrap) by cp.async into one of the block's 8 regions,
//     128-byte rows with 16-byte chunks XOR-swizzled by row (ldmatrix reads
//     8 rows without a bank conflict); the warp's next job loads into its
//     other region while this one computes;
//   * products: 5 m-tiles (the 64 taps, then the next frame's first 16) x
//     7 n-tiles of mma.m16n8k32 against the support, whose fragments the
//     warp holds in registers for all its frames;
//   * combine in registers: lane (g, t) holds tap x = g of rows y, y + 1 of
//     an m-tile for its 14 columns, so the y+1 neighbour is in the lane (the
//     m-tile before, carried), the x+1 neighbour 4 lanes over (a shuffle;
//     x = 7 takes x = 0 of the next row), in the plain version's order
//     gx = g + wx*(g01 - g), c = gx + wy*(gx1 - gx) with _rn intrinsics;
//     the row absmax runs along.
// kHold (Tp <= 64, at most 8 frames a block): each frame's c stays in its
// region (f32, rows of kK4Ld floats; the window sits at the region's end
// and every c row lands below the taps still to be read); after the
// cluster's absmax (distributed shared memory, below) the block writes its
// frames' codes. Otherwise two passes: the absmax, then every job again
// with codes staged in the region and copied out 16 bytes a lane.
// The scale: each block's max into shared memory, a cluster barrier, each
// block reads the cs maxima through distributed shared memory (mapa +
// ld.shared::cluster), scale = max(absmax, 1e-20) * (1/127), codes
// rint(c * (1/scale)): codes and scales bit-identical to corr_volume_plain.
constexpr int kK4Warps = 4, kK4Threads = 32 * kK4Warps;
constexpr int kK4Regions = 8;                         // frames a block holds / jobs in flight
constexpr int kK4WinRows = kR + 16;                   // 64 taps + the next frame's first 16
constexpr int kK4Ld = 50;                             // row stride (floats) of a held frame's c
constexpr int kK4Region = kR * kK4Ld * 4;             // 12,800 bytes
constexpr int kK4WinOff = kK4Region - kK4WinRows * kC;  // 2,560: the window at the region's end
constexpr int kK4Smem = kSp * kC + kK4Regions * kK4Region + 32;
constexpr int kK4MaxCluster = 8;
static_assert(3200 * 3 <= kK4WinOff + 2048 * 4, "held c rows stay below the taps still read");

// byte offset of 16-byte chunk c of a 128-byte row r, XOR-swizzled
__device__ __forceinline__ int k4_swz(int r, int c) { return r * kC + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at the same shared-memory address in block `rank` of the cluster
__device__ __forceinline__ float cluster_ld(const float* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned ra;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(ra) : "memory");
  return v;
}

template <bool kHold>
__global__ void __launch_bounds__(kK4Threads, 2)
corr_volume_kernel(const int8_t* __restrict__ fm, const int8_t* __restrict__ sup,
                   const int* __restrict__ starts, const float* __restrict__ wxy,
                   int8_t* __restrict__ vol, float* __restrict__ scale_out, int Tp, int Hp,
                   int Wp, int cs) {
  extern __shared__ __align__(128) unsigned char k4_smem[];
  int8_t* sup_s = reinterpret_cast<int8_t*>(k4_smem);
  unsigned char* regions = k4_smem + kSp * kC;
  float* red = reinterpret_cast<float*>(regions + kK4Regions * kK4Region);  // [4] warps, [4] block, [5] 1/scale
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rank = blockIdx.x % cs, p = blockIdx.x / cs;
  const int f0 = rank * Tp / cs, nf = (rank + 1) * Tp / cs - f0;
  const int* st = starts + static_cast<size_t>(p) * Tp * 3;
  const float* wp = wxy + static_cast<size_t>(p) * Tp * 2;
  int8_t* outp = vol + static_cast<size_t>(p) * Tp * (kR * kS);
  const int nwf = nf > warp ? (nf - warp + kK4Warps - 1) / kK4Warps : 0;  // this warp's frames
  const int njobs = (kHold ? 1 : 2) * nwf;

  for (int i = tid; i < kSp * 8; i += kK4Threads) {
    const int r = i >> 3, c = i & 7;
    int8_t* dst = sup_s + k4_swz(r, c);
    if (r < kS)
      cp_async16(dst, sup + (static_cast<size_t>(p) * kS + r) * kC + 16 * c, true);
    else
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  }
  cp_async_commit();

  auto region = [&](int q) { return regions + (warp + kK4Warps * (q & 1)) * kK4Region; };
  auto frame = [&](int q) { return f0 + warp + kK4Warps * (q % nwf); };
  // job q's window; one commit group per job slot, empty past the last job
  auto load_job = [&](int q) {
    if (q < njobs) {
      const int t = frame(q), tn = t + 1 == Tp ? 0 : t + 1;
      const int* s0 = st + t * 3;
      const int* s1 = st + tn * 3;
      const int fa = s0[0], ya = s0[1], xa = s0[2], fb = s1[0], yb = s1[1], xb = s1[2];
      int8_t* win = reinterpret_cast<int8_t*>(region(q)) + kK4WinOff;
#pragma unroll 4
      for (int i = lane; i < kK4WinRows * 8; i += 32) {
        const int row = i >> 3, c = i & 7, tap = row & (kR - 1), y = tap >> 3, x = tap & 7;
        const bool cur = row < kR;
        const size_t pix = (static_cast<size_t>(cur ? fa : fb) * Hp + (cur ? ya : yb) + y) * Wp +
                           (cur ? xa : xb) + x;
        cp_async16(win + k4_swz(row, c), fm + pix * kC + 16 * c, true);
      }
    }
    cp_async_commit();
  };
  load_job(0);
  load_job(1);
  cp_async_wait<2>();  // the support
  __syncthreads();
  uint32_t bfr[7][4][2];  // the support's B fragments, n-tile x k-step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 6; nt += 2) {
      uint32_t r[4];
      ldsm_x4(r, sup_s + k4_swz((nt + (lane >> 4)) * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
      bfr[nt][kk][0] = r[0];
      bfr[nt][kk][1] = r[1];
      bfr[nt + 1][kk][0] = r[2];
      bfr[nt + 1][kk][1] = r[3];
    }
    uint32_t r[2];
    ldsm_x2(r, sup_s + k4_swz(48 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
    bfr[6][kk][0] = r[0];
    bfr[6][kk][1] = r[1];
  }

  float amax = 0.f, inv = 0.f;
  // Runs job q: products and combine; emit(y, nt, c0, c1) takes c of row y
  // (taps 8y .. 8y + 7, this lane's x = g) at columns 8nt + 2t4 + {0, 1}.
  auto run = [&](int q, auto emit) {
    cp_async_wait<1>();
    __syncwarp();
    const int t = frame(q);
    const float wx = wp[2 * t], wy = wp[2 * t + 1];
    const int8_t* win = reinterpret_cast<const int8_t*>(region(q)) + kK4WinOff;
    float P[7][2], SP[7][2], Q[7][2];  // raw row 2m - 1, its x+1 shuffle, gx of row 2m - 2
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      int acc[7][4];
#pragma unroll
      for (int nt = 0; nt < 7; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, win + k4_swz(16 * m + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < 7; ++nt) mma_s8_16832(acc[nt], af, bfr[nt][kk]);
      }
      __syncwarp();  // every lane's reads of this m-tile are done before rows land below it
#pragma unroll
      for (int nt = 0; nt < 7; ++nt) {
        float ca[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < (nt < 6 ? 2 : 1); ++j) {  // n-tile 6: only column 48 is real
          const float y0 = static_cast<float>(acc[nt][j]);      // row 2m, x = g
          const float y1 = static_cast<float>(acc[nt][2 + j]);  // row 2m + 1
          const float s0 = __shfl_sync(0xffffffffu, y0, (lane + 4) & 31);
          const float s1 = __shfl_sync(0xffffffffu, y1, (lane + 4) & 31);
          const float gx0 = __fadd_rn(y0, __fmul_rn(wx, __fsub_rn(g == 7 ? s1 : s0, y0)));
          if (m > 0) {
            const float gxp =
                __fadd_rn(P[nt][j], __fmul_rn(wx, __fsub_rn(g == 7 ? s0 : SP[nt][j], P[nt][j])));
            ca[j] = __fadd_rn(Q[nt][j], __fmul_rn(wy, __fsub_rn(gxp, Q[nt][j])));
            cb[j] = __fadd_rn(gxp, __fmul_rn(wy, __fsub_rn(gx0, gxp)));
          }
          P[nt][j] = y1;
          SP[nt][j] = s1;
          Q[nt][j] = gx0;
        }
        if (m > 0) {
          emit(2 * m - 2, nt, ca[0], ca[1]);
          emit(2 * m - 1, nt, cb[0], cb[1]);
        }
      }
    }
    __syncwarp();
  };
  auto track_max = [&](int, int, float c0, float c1) {
    amax = fmaxf(amax, fmaxf(fabsf(c0), fabsf(c1)));
  };

  for (int q = 0; q < nwf; ++q) {  // pass 1 (kHold: the only one)
    if constexpr (kHold) {
      float* cs_ = reinterpret_cast<float*>(region(q));
      run(q, [&](int y, int nt, float c0, float c1) {
        track_max(y, nt, c0, c1);
        float* cr = cs_ + (8 * y + g) * kK4Ld + 8 * nt + 2 * t4;
        if (nt < 6)
          *reinterpret_cast<float2*>(cr) = make_float2(c0, c1);
        else if (t4 == 0)
          cr[0] = c0;
      });
    } else {
      run(q, track_max);
    }
    load_job(q + 2);
  }

  // the point's scale: block max, then every block's through the cluster
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (tid == 0) red[4] = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  cluster_arrive();
  cluster_wait();
  if (tid == 0) {
    float m = 0.f;
    for (int r = 0; r < cs; ++r) m = fmaxf(m, cluster_ld(red + 4, r));
    const float sc = __fmul_rn(fmaxf(m, 1e-20f), 1.0f / 127.0f);
    red[5] = 1.0f / sc;
    if (rank == 0) scale_out[p] = sc;
  }
  __syncthreads();
  cluster_arrive();  // this block has read the others' maxima
  inv = red[5];

  if constexpr (kHold) {
    // codes of every held frame: a thread takes 16 consecutive bytes of the
    // frame's (r, s) flatten and stores them at once
    constexpr int kPieces = kR * kS / 16;  // 196 a frame
    for (int i = tid; i < nf * kPieces; i += kK4Threads) {
      const int j = i / kPieces, e0 = (i - j * kPieces) * 16;
      const float* cf = reinterpret_cast<const float*>(regions + j * kK4Region);
      int r = e0 / kS, s = e0 - r * kS;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        w[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(quant8(cf[r * kK4Ld + s], inv)))
                     << (8 * (k & 3));
        if (++s == kS) {
          s = 0;
          ++r;
        }
      }
      *reinterpret_cast<uint4*>(outp + static_cast<size_t>(f0 + j) * (kR * kS) + e0) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int q = nwf; q < njobs; ++q) {  // pass 2: codes staged in the region, copied out
      int8_t* qs = reinterpret_cast<int8_t*>(region(q));
      run(q, [&](int y, int nt, float c0, float c1) {
        const int s = 8 * nt + 2 * t4;
        int8_t* qr = qs + (8 * y + g) * kS + s;
        if (s < kS) qr[0] = quant8(c0, inv);
        if (s + 1 < kS) qr[1] = quant8(c1, inv);
      });
      const int4* src = reinterpret_cast<const int4*>(qs);
      int4* dst = reinterpret_cast<int4*>(outp + static_cast<size_t>(frame(q)) * (kR * kS));
      for (int k = lane; k < kR * kS / 16; k += 32) dst[k] = src[k];
      __syncwarp();
      load_job(q + 2);
    }
  }
  cluster_wait();  // no block leaves while another may still read its maximum
}

template <bool kHold>
int launch_k4(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
              int8_t* vol, float* scale, int NP, int Tp, int Hp, int Wp, int cs, void* stream) {
  auto kern = corr_volume_kernel<kHold>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kK4Smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NP * cs);
  cfg.blockDim = dim3(kK4Threads);
  cfg.dynamicSmemBytes = kK4Smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, fm, sup, starts, wxy, vol, scale, Tp, Hp, Wp, cs);
  if (e != cudaSuccess) return e;
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


// K4 on corr_cuda.k4_plan's tiling: `cluster` blocks a point; hold = 1 keeps
// the combined volume on chip (one pass; every block at most 8 frames).
int ct_corr_volume(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                   int8_t* vol, float* scale, int NP, int Tp, int Hp, int Wp, int cluster,
                   int hold, void* stream) {
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8 || cluster < 1 || cluster > ct::kK4MaxCluster ||
      cluster > Tp || (hold && (Tp + cluster - 1) / cluster > ct::kK4Regions))
    return cudaErrorInvalidValue;
  return hold ? ct::launch_k4<true>(fm, sup, starts, wxy, vol, scale, NP, Tp, Hp, Wp, cluster,
                                    stream)
              : ct::launch_k4<false>(fm, sup, starts, wxy, vol, scale, NP, Tp, Hp, Wp, cluster,
                                     stream);
}

// K4's shared-memory bytes a block (k4_plan checks its own arithmetic).
int ct_k4_smem() { return ct::kK4Smem; }

// K4r: the raw volume's codes and scale, one block a point.
int ct_corr_volume_raw(const int8_t* fm, const int8_t* sup, const int* starts, int8_t* vol,
                       float* scale, int NP, int Tp, int Hp, int Wp, void* stream) {
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8) return cudaErrorInvalidValue;
  ct::corr_volume_raw_kernel<<<NP, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      fm, sup, starts, vol, scale, Tp, Hp, Wp);
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
