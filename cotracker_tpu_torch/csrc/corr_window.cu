// K4, K4r, K4f and K4m: the correlation kernels of the correlation
// featurizer (sm_90a).
//
// All four replace cotracker_tpu/ops/kernels/corr_pallas.py::_kernel, one
// mode each. Per point and frame t, the 8x8x128 window at (frame, wsy, wsx)
// of the edge-padded level map is contracted with the point's 49x128
// support: g (64 window taps x 49). K4, K4r and K4f output (NP, Tp, 64,
// 49), flatten order (t, y, x, s); K4m MLP1's rows (NP, Tp, 384).
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
// default: K4's cluster kernel in its K4r mode (k4r_volume_kernel, on
// k4_plan's tiling, below): K4's windows by cp.async, support fragments held
// in registers, the cluster's scale through distributed shared memory and
// 16-byte code stores; each frame's own 64 taps only (four m-tiles), the
// absmax of the RAW s32 products, the raw g held on chip up to 64 frames
// (two passes past that), codes rint(g * (1/scale)).
// K4f (plain g, corr_pallas.py:401-402): float (f32 or bf16) windows and
// support, the volume written in the input dtype. One pass, no scale; its
// design (k4f_volume_kernel, on corr_cuda.k4f_plan: 3xTF32 tensor cores in
// f32, f32 FMAs in k order in bf16) is the note above it.
//
// K4m (fuse_mlp1, corr_pallas.py:244-333 with the plan :509-560 and the
// epilogue :706-712): the whole correlation epilogue up to MLP1, per point:
//   1. s = max(absmax, 1e-20) / 127 from the RAW s32 volume over ALL 64 taps
//      x 49 x Tp rows, junk taps x==7 / y==7 and the padded frame included
//      (before the combine: a convex combine never exceeds it);
//   2. the separable lerps gx = a + wx*(b - a) (b the x+1 tap), c = gx0 +
//      wy*(gx8 - gx0) (gx8 the y+1 row) for the 7 x 7 x 49 = 2,401 real taps
//      only (their taps never leave the frame; the zero MLP1 rows of the JAX
//      layout kill every other tap), codes rint(c * (1/s));
//   3. the s8 MLP1 product of each frame's code row against the
//      per-output-channel W1 codes (384 x 2,432, zero past 2,401);
//   4. out = (h32 * w1scale) * (s * support scale) + b1 in f32, in that
//      order, stored in the compute dtype: pre-GELU hidden rows (NP, Tp, 384).
// Its design (ct_corr_mlp1, two launches on corr_cuda.k4m_plan):
//   (a) K4's cluster kernel in its K4m mode (corr_volume_kernel<hold, true>):
//       the volume runs once, the raw absmax taken on the product fragments,
//       the combined c of every frame held on chip up to 64 frames until the
//       cluster's scale is known (two passes past that), then each frame's
//       2,432-byte code row to device memory;
//   (b) mlp1_gemm_kernel (below): 128 code rows a block, several points'
//       frames, W1 streamed through a cp.async ring once per 128 rows, the
//       epilogue staged in shared memory and stored in 16-byte pieces.
// The code rows cross device memory between the two (2,432 bytes a frame,
// 80 MB at 2,048 points x 16 frames); the first body (corr_mlp1_kernel, kept
// as ct_corr_mlp1_first: the yardstick) kept them on chip but ran every
// window's products twice, combined from shared memory with two integer
// divisions an element, and re-read the 0.93 MB W1 from L2 for every 16 rows
// (~1.9 GB at that shape) on synchronous 64-byte stages.
// What bounds K4m: operations. At 2,048 points x 16 frames the window
// products are 26 G and MLP1 61 G s8 operations (0.044 ms at 1,979 TOP/s)
// and the combine 0.47 G f32 ones (0.007 ms at 67 TFLOP/s): 0.051 ms,
// against ~72 MB of bytes (the level's codes 33 MB, the support 13 MB, W1,
// the bf16 rows 25 MB: 0.021 ms at 3.35 TB/s); x 60 frames 0.191 ms. How
// far it got (scripts/torch_cores.py, one NVIDIA H100 80GB HBM3 at 700 W):
// 0.35 ms at 2,048 x 16 (first body 1.69-1.96) and 1.36-1.43 at x 60
// (6.37-8.79), of which the code rows 0.21 / 0.87-0.94 (K4's own
// instruction-bound pipeline) and MLP1 0.125 / 0.48 (~480 T s8 operations
// a second on mma.sync).
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
// K4r must read the level map's pixels its windows cover and the support
// and write its codes: at 768 points x 16 frames 0.021 ms at the memory's
// rate (2,048 x 60: 0.151), above its 9.9 G s8 operations (0.005 ms). It
// takes 0.075 / 0.76 ms (the first body 0.16 / 1.73: every window and
// product twice, codes a byte at a time), of which its code write after the cluster's scale is 37%, a
// loop of strided shared loads and byte packs (its stores alone 3-7%), the
// windows' copies 16%, the products 11% and the cluster's barriers 9%
// (scripts/torch_k4r_parts.py). K4f's first body did the
// contraction as f32 FMAs on the CUDA cores (0.973 ms at 768 points x 16
// frames, 10.42 at 2,048 x 60), bound by its shared-memory loads; on the
// tensor cores the least time for the work is its bytes (the level map,
// the support and the 154 MB volume at 768 x 16 f32: ~0.085 ms), above the
// 3 x 9.87 G tf32 operations at 494.7 T a second (~0.060 ms); in bf16, on
// the CUDA cores for an exact sum, the 9.87 G f32 operations at 67 T a
// second (0.147 ms) bound it.

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

// ---------------------------------------------------------------- K4f
// K4f (k4f_volume_kernel; tiling corr_cuda.k4f_plan): per (point, frame)
// the 64 x 49 x 128 contraction g = window . support^T.
//   * f32: on tensor cores, 3xTF32 on mma.sync m16n8k8 (CUTLASS's fast-f32
//     split): each operand v = hi + lo, hi = cvt.rna.tf32(v), lo =
//     cvt.rna.tf32(v - hi); per 8-deep k step acc += lo_a.hi_b, then
//     hi_a.lo_b, then hi_a.hi_b (small terms first), in f32. The dropped
//     lo.lo term and lo's own rounding are each under 2^-22 of |a.b|: ~1e-6
//     of sum_c |a_c b_c| (at most 1 for the unit-norm features) at worst.
//     The K axis is permuted alike in both operands, so that a lane's
//     fragments of two k steps are one 16-byte shared-memory load: in each
//     64-byte chunk j of a row, lane (g, t) reads bytes 16t .. 16t + 15,
//     whose four floats are (a0, a2) of step 2j and (a0, a2) of step 2j + 1
//     for row g (a1, a3: row g + 8), and (b0, b1) of the same steps for
//     support row g. Window rows are padded by 64 bytes, so rows g and g + 1
//     (a quarter-warp's 128-bit load) fall on other banks. The support is
//     staged once per task in fragment order, split once: supF[step]
//     [n-tile][lane] = {hi b0, hi b1, lo b0, lo b1}. Warps: two teams of 8,
//     each warp 16 window rows x 4 or 3 n-tiles of 8 support taps.
//   * bf16: on the CUDA cores, f32 FMAs in k order. The products of bf16
//     values are exact in f32, so any other order of the sum (a tensor
//     core's among them) rounds a few elements to the neighbouring bf16
//     value, an error up to 2^-7 of the largest |g|; in k order the sum is
//     the plain version's (cuBLAS's f32 GEMM) bit for bit. A thread holds 8
//     window rows x 7 support taps (64 threads a frame); per 8 k the rows'
//     16 bytes of bf16 are one broadcast load a quarter-warp and the taps'
//     floats (the support staged once per task in f32, rows padded by 16
//     bytes: the 8 taps of a quarter-warp on 8 bank groups) two 16-byte
//     loads, for 448 FMAs. Warps: four teams of 2.
// Block (both): 16 warps (f32) or 8 (bf16), one block an SM, persistent
// over the plan's tasks (a point and a group of its frames; the groups in
// order, so that the blocks in flight read the same frames' windows from
// L2). A step takes one frame a team; the next step's windows arrive by
// cp.async in 16-byte pieces while this step computes (two steps of
// windows in shared memory); each frame's 64 x 49 output (12,544
// contiguous bytes in f32) is staged in shared memory and leaves as 16-byte
// streaming stores; the next task's support is read into registers during
// the last step of the task before. Shared memory: f32 229,888 bytes,
// bf16 185,728.
// What bounds it (one NVIDIA H100 80GB HBM3 at 700 W; scripts/torch_k4f_parts.py
// builds copies with one part taken out): f32 0.29 ms at 768 points x 16
// frames, against 0.091 ms of bytes and 0.060 of tf32 operations. With its
// products replaced by adds it takes as long; without the windows' copies
// 10% less, without the stores 8%, without the staging or the split under
// 2% each: what is left is the block's instruction stream (fragment loads,
// address arithmetic, two block barriers a step) at 16 warps an SM (8
// warps took 0.32 ms). bf16 0.34 ms, of which the FMAs 0.20 (~85% of the
// f32 FMA peak on the 56 padded taps) and the rest 0.15.
template <typename T> struct K4fT;
template <> struct K4fT<float> {  // threads, frames a step (teams), window row stride, support bytes
  static constexpr int kThreads = 512, kFrames = 2, kLdw = kC * 4 + 64, kSup = 8 * 2 * 7 * 32 * 16;
};
template <> struct K4fT<__nv_bfloat16> {
  static constexpr int kThreads = 256, kFrames = 4, kLdw = kC * 2, kSup = kSp * (kC + 4) * 4;
};
constexpr int kFNt = kSp / 8;  // 7 n-tiles of 8 support taps
constexpr int kFSupLd = kC + 4;                  // bf16: the f32 support's row stride (floats)

template <typename T>
struct K4fLayout {
  static constexpr int kThreads = K4fT<T>::kThreads, kFrames = K4fT<T>::kFrames;
  static constexpr int kLdw = K4fT<T>::kLdw, kSup = K4fT<T>::kSup;
  static constexpr int kRow = kC * static_cast<int>(sizeof(T)), kCPR = kRow / 16;
  static constexpr int kWin = kR * kLdw, kStage = kR * kS * static_cast<int>(sizeof(T));
  static constexpr int kSmem = kSup + 2 * kFrames * kWin + kFrames * kStage;
  static constexpr int kSupRegs = (kS * kCPR + kThreads - 1) / kThreads;
};
static_assert(K4fLayout<float>::kSmem <= 232448 && K4fLayout<__nv_bfloat16>::kSmem <= 232448,
              "K4f: one block an SM");

__device__ __forceinline__ uint32_t word4(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// f32: acc[m][n] = window rows row0 + 16 m .. +15 x n-tiles n0 + n.
template <int MT, int NT>
__device__ __forceinline__ void k4f_mma(const unsigned char* win, const uint4* supF, int row0,
                                        int n0, float (&acc)[MT][NT][4]) {
  constexpr int kLdw = K4fT<float>::kLdw;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  const unsigned char* a_base = win + (row0 + g) * kLdw + 16 * t;
  const uint4* b_base = supF + n0 * 32 + lane;
#pragma unroll
  for (int j = 0; j < kC / 16; ++j) {
    uint4 ar[MT][2];  // rows g and g + 8 of each m-tile
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ar[m][h] = *reinterpret_cast<const uint4*>(a_base + (16 * m + 8 * h) * kLdw + 64 * j);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint4 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) b[n] = b_base[((2 * j + u) * kFNt + n) * 32];
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // a0 = word 2u of row g, a1 of row g + 8, a2, a3: 2u + 1
          const float v = __uint_as_float(word4(ar[m][k & 1], 2 * u + (k >> 1)));
          ah[m][k] = tf32_rna(v);
          al[m][k] = tf32_rna(__fsub_rn(v, __uint_as_float(ah[m][k])));
        }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32_1688(acc[m][n], al[m], b[n].x, b[n].y);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32_1688(acc[m][n], ah[m], b[n].z, b[n].w);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32_1688(acc[m][n], ah[m], b[n].x, b[n].y);
    }
  }
}

// f32: the frame's outputs of k4f_mma, in its (r, s) flatten, into `out`.
template <int MT, int NT>
__device__ __forceinline__ void k4f_mma_stage(float* out, const float (&acc)[MT][NT][4], int row0,
                                              int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = row0 + 16 * m + g + 8 * (k >> 1), c = 8 * (n0 + n) + 2 * t + (k & 1);
        if (c < kS) out[r * kS + c] = acc[m][n][k];
      }
}

// bf16: the frame's window rows 8 ry .. 8 ry + 7 x support taps sx + 8 j,
// each summed in k order, into `out`.
__device__ __forceinline__ void k4f_ffma(const unsigned char* win, const float* supR, int ry, int sx,
                                         __nv_bfloat16* out) {
  constexpr int kLdw = K4fT<__nv_bfloat16>::kLdw;
  float acc[8][7];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) acc[i][j] = 0.f;
  const unsigned char* a_base = win + 8 * ry * kLdw;
  const float* b_base = supR + sx * kFSupLd;
#pragma unroll 1
  for (int kc = 0; kc < kC / 8; ++kc) {
    float b[7][8];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float4 lo = *reinterpret_cast<const float4*>(b_base + 8 * j * kFSupLd + 8 * kc);
      const float4 hi = *reinterpret_cast<const float4*>(b_base + 8 * j * kFSupLd + 8 * kc + 4);
      b[j][0] = lo.x, b[j][1] = lo.y, b[j][2] = lo.z, b[j][3] = lo.w;
      b[j][4] = hi.x, b[j][5] = hi.y, b[j][6] = hi.z, b[j][7] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 raw = *reinterpret_cast<const uint4*>(a_base + i * kLdw + 16 * kc);
      float a[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {  // element 2w is the low half of word w
        a[2 * w] = __uint_as_float(word4(raw, w) << 16);
        a[2 * w + 1] = __uint_as_float(word4(raw, w) & 0xffff0000u);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int j = 0; j < 7; ++j) acc[i][j] = fmaf(a[kk], b[j][kk], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j)
      if (sx + 8 * j < kS) out[(8 * ry + i) * kS + sx + 8 * j] = __float2bfloat16_rn(acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(K4fT<T>::kThreads, 1)
k4f_volume_kernel(const T* __restrict__ fm, const T* __restrict__ sup, const int* __restrict__ starts,
                  T* __restrict__ vol, int NP, int Tp, int Hp, int Wp, int group) {
  using L = K4fLayout<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int F = L::kFrames;
  extern __shared__ __align__(16) unsigned char k4f_smem[];
  unsigned char* wins = k4f_smem + L::kSup;              // [step parity][team] windows
  T* stage = reinterpret_cast<T*>(wins + 2 * F * L::kWin);  // [team] one frame's output
  const int tid = threadIdx.x, warp = tid >> 5;
  const int team = warp % F, lw = warp / F;  // this warp's frame of a step, its place in the team
  const int tasks = (Tp + group - 1) / group * NP;
  // task -> point, its first frame and its frame count (groups in order)
  auto point = [&](int task) { return task % NP; };
  auto first = [&](int task) { return task / NP * group; };
  auto frames = [&](int task) { return min(group, Tp - first(task)); };
  auto next = [&](int& task, int& s) {
    if (task < tasks && F * ++s >= frames(task)) {
      task += gridDim.x;
      s = 0;
    }
  };
  int task = blockIdx.x, s = 0;  // the step computing
  int ltask = task, ls = 0;      // the step loading, two ahead
  if (task >= tasks) return;

  // the support rows 49 .. 55 stay zero (f32: their B entries, n-tile 6, g > 0)
  if constexpr (kF32) {
    uint4* supF = reinterpret_cast<uint4*>(k4f_smem);
    for (int i = tid; i < 16 * 28; i += L::kThreads)
      supF[((i / 28) * kFNt + kFNt - 1) * 32 + 4 + i % 28] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    float* supR = reinterpret_cast<float*>(k4f_smem);
    for (int i = tid; i < (kSp - kS) * kC; i += L::kThreads)
      supR[(kS + i / kC) * kFSupLd + i % kC] = 0.f;
  }
  uint4 sreg[L::kSupRegs];  // the support's rows, 16 bytes a piece
  auto load_support = [&](int tk) {
    const uint4* src = reinterpret_cast<const uint4*>(sup + static_cast<size_t>(point(tk)) * kS * kC);
#pragma unroll
    for (int k = 0; k < L::kSupRegs; ++k) {
      const int i = tid + k * L::kThreads;
      if (i < kS * L::kCPR) sreg[k] = __ldg(src + i);
    }
  };
  auto write_support = [&]() {
#pragma unroll
    for (int k = 0; k < L::kSupRegs; ++k) {
      const int i = tid + k * L::kThreads;
      if (i >= kS * L::kCPR) continue;
      const int r = i / L::kCPR, c = i - r * L::kCPR;
      if constexpr (kF32) {
        uint4* dst = reinterpret_cast<uint4*>(k4f_smem) + (r >> 3) * 32 + (r & 7) * 4 + (c & 3);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float v0 = __uint_as_float(word4(sreg[k], 2 * u));
          const float v1 = __uint_as_float(word4(sreg[k], 2 * u + 1));
          const uint32_t h0 = tf32_rna(v0), h1 = tf32_rna(v1);
          dst[(2 * (c >> 2) + u) * kFNt * 32] =
              make_uint4(h0, h1, tf32_rna(__fsub_rn(v0, __uint_as_float(h0))),
                         tf32_rna(__fsub_rn(v1, __uint_as_float(h1))));
        }
      } else {
        float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(k4f_smem) +
                                                r * kFSupLd + 8 * c);
        const uint32_t w[4] = {sreg[k].x, sreg[k].y, sreg[k].z, sreg[k].w};
        dst[0] = make_float4(__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u),
                             __uint_as_float(w[1] << 16), __uint_as_float(w[1] & 0xffff0000u));
        dst[1] = make_float4(__uint_as_float(w[2] << 16), __uint_as_float(w[2] & 0xffff0000u),
                             __uint_as_float(w[3] << 16), __uint_as_float(w[3] & 0xffff0000u));
      }
    }
  };
  // the windows of step (tk, st) into buffer set `slot`; one commit group
  auto load_windows = [&](int tk, int st, int slot) {
    if (tk < tasks) {
      const int p = point(tk), t0 = first(tk) + F * st, nj = min(F, frames(tk) - F * st);
      for (int tm = 0; tm < nj; ++tm) {
        const int* sp = starts + (static_cast<size_t>(p) * Tp + t0 + tm) * 3;
        const int f = sp[0], wy = sp[1], wx = sp[2];
        unsigned char* dst = wins + (F * slot + tm) * L::kWin;
        for (int i = tid; i < kR * L::kCPR; i += L::kThreads) {
          const int r = i / L::kCPR, c = i - r * L::kCPR;
          const size_t pix = (static_cast<size_t>(f) * Hp + wy + (r >> 3)) * Wp + wx + (r & 7);
          cp_async16(dst + r * L::kLdw + 16 * c,
                     reinterpret_cast<const unsigned char*>(fm + pix * kC) + 16 * c, true);
        }
      }
    }
    cp_async_commit();
  };

  load_support(task);
  load_windows(ltask, ls, 0);
  next(ltask, ls);
  load_windows(ltask, ls, 1);
  next(ltask, ls);
  for (int q = 0; task < tasks; ++q) {
    cp_async_wait<1>();
    __syncthreads();  // this step's windows landed; the last step's readers are done
    const int p = point(task), nf = frames(task), t0 = first(task) + F * s;
    const int nj = min(F, nf - F * s);
    if (s == 0) {
      write_support();
      __syncthreads();
    }
    if (F * (s + 1) >= nf && task + static_cast<int>(gridDim.x) < tasks)
      load_support(task + gridDim.x);
    if (team < nj) {
      const unsigned char* win = wins + (F * (q & 1) + team) * L::kWin;
      T* out = stage + team * (kR * kS);
      if constexpr (kF32) {
        const uint4* supF = reinterpret_cast<const uint4*>(k4f_smem);
        const int row0 = 16 * (lw & 3);
        if (lw < 4) {
          float acc[1][4][4];
          k4f_mma<1, 4>(win, supF, row0, 0, acc);
          k4f_mma_stage<1, 4>(out, acc, row0, 0);
        } else {
          float acc[1][kFNt - 4][4];
          k4f_mma<1, kFNt - 4>(win, supF, row0, 4, acc);
          k4f_mma_stage<1, kFNt - 4>(out, acc, row0, 4);
        }
      } else {
        const int lt = lw * 32 + (tid & 31);
        k4f_ffma(win, reinterpret_cast<const float*>(k4f_smem), lt >> 3, lt & 7, out);
      }
    }
    __syncthreads();  // the outputs are staged; this step's windows are read
    load_windows(ltask, ls, q & 1);
    next(ltask, ls);
    // the step's frames t0 .. t0 + nj - 1 are contiguous in vol, as are the stages
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    uint4* dst = reinterpret_cast<uint4*>(vol + (static_cast<size_t>(p) * Tp + t0) * (kR * kS));
    for (int i = tid; i < nj * (L::kStage / 16); i += L::kThreads) __stcs(dst + i, src[i]);
    next(task, s);
  }
  cp_async_wait<0>();
}

template <typename T>
int launch_k4f(const void* fm, const void* sup, const int* starts, void* vol, int NP, int Tp,
               int Hp, int Wp, int group, int blocks, void* stream) {
  auto kern = k4f_volume_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             K4fLayout<T>::kSmem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, K4fT<T>::kThreads, K4fLayout<T>::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fm), static_cast<const T*>(sup), starts, static_cast<T*>(vol), NP,
      Tp, Hp, Wp, group);
  return cudaGetLastError();
}

// K4m's first body (PR 5; ct_corr_mlp1_first, the yardstick of the two
// launches of ct_corr_mlp1 below). 128 threads; shared memory 99,728 bytes
// (two blocks per SM): the window and support as frame_corr stages them,
// one frame's s32 volume, the 16 code rows of a frame group (2,448-byte
// rows) and a 384 x 80 W1 slice; pass A the raw absmax, pass B the volume again, the combine and
// MLP1 per 16 frames.
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
// The same body runs three modes (K4Mode): K4 (above), K4m (the raw
// absmax, each frame's code row of the 7 x 7 real taps) and K4r (the raw
// volume: the frame's own 64 taps, m-tiles 0-3, the absmax on the s32
// products, each m-tile's raw g emitted after the next m-tile's reads, as
// K4's combine lags one m-tile, so that held rows never land on taps still
// to be read; then K4's codes, from the raw g). K4 and K4m launch it as
// corr_volume_kernel, K4r as k4r_volume_kernel (its own name in a trace).
constexpr int kK4Warps = 4, kK4Threads = 32 * kK4Warps;
constexpr int kK4Regions = 8;                         // frames a block holds / jobs in flight
constexpr int kK4WinRows = kR + 16;                   // 64 taps + the next frame's first 16
constexpr int kK4Ld = 50;                             // row stride (floats) of a held frame's c
constexpr int kK4Region = kR * kK4Ld * 4;             // 12,800 bytes
constexpr int kK4WinOff = kK4Region - kK4WinRows * kC;  // 2,560: the window at the region's end
constexpr int kK4Smem = kSp * kC + kK4Regions * kK4Region + 32;
constexpr int kK4MaxCluster = 8;
// the rows of m-tiles 0 .. m - 1 (3,200 bytes each) are emitted after
// m-tile m's reads: they stay below m-tile m + 1's taps (the worst: m = 3)
static_assert(3200 * 3 <= kK4WinOff + 2048 * 4, "held c rows stay below the taps still read");

enum class K4Mode { kCombine, kMlp1, kRaw };

// byte offset of 16-byte chunk c of a 128-byte row r, XOR-swizzled
__device__ __forceinline__ int k4_swz(int r, int c) { return r * kC + ((c ^ (r & 7)) << 4); }

template <bool kHold, K4Mode kMode>
__device__ __forceinline__ void k4_cluster_body(const int8_t* __restrict__ fm,
                                                const int8_t* __restrict__ sup,
                                                const int* __restrict__ starts,
                                                const float* __restrict__ wxy,
                                                int8_t* __restrict__ vol,
                                                float* __restrict__ scale_out, int Tp, int Hp,
                                                int Wp, int cs) {
  constexpr bool kMlp1 = kMode == K4Mode::kMlp1, kRaw = kMode == K4Mode::kRaw;
  // K4m: codes rows of the 2,401 real taps (kKm bytes), the window's own 64
  // taps only (its combine never leaves the frame); K4r: the window's own 64
  // taps; K4: rows of all 64 taps and the next frame's first 16
  constexpr int kRow = kMlp1 ? kKm : kR * kS;
  constexpr int kWinRows = kMode == K4Mode::kCombine ? kK4WinRows : kR;
  extern __shared__ __align__(128) unsigned char k4_smem[];
  int8_t* sup_s = reinterpret_cast<int8_t*>(k4_smem);
  unsigned char* regions = k4_smem + kSp * kC;
  float* red = reinterpret_cast<float*>(regions + kK4Regions * kK4Region);  // [4] warps, [4] block, [5] 1/scale
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rank = blockIdx.x % cs, p = blockIdx.x / cs;
  const int f0 = rank * Tp / cs, nf = (rank + 1) * Tp / cs - f0;
  const int* st = starts + static_cast<size_t>(p) * Tp * 3;
  const float* wp = kRaw ? nullptr : wxy + static_cast<size_t>(p) * Tp * 2;  // K4r: no (wx, wy)
  int8_t* outp = vol + static_cast<size_t>(p) * Tp * kRow;
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
      for (int i = lane; i < kWinRows * 8; i += 32) {
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
  // K4m tracks the RAW products' absmax here (the frame's 64 taps x 49) and
  // runs no product for the fifth m-tile: its rows y = 7 are junk it drops.
  // K4r emits the raw g (no combine) and tracks its absmax here too.
  auto run = [&](int q, auto emit) {
    cp_async_wait<1>();
    __syncwarp();
    const int t = frame(q);
    // K4, K4m: the combine's weights (K4r: none); raw row 2m - 1, its x+1
    // shuffle, gx of row 2m - 2
    [[maybe_unused]] const float wx = kRaw ? 0.f : wp[2 * t], wy = kRaw ? 0.f : wp[2 * t + 1];
    const int8_t* win = reinterpret_cast<const int8_t*>(region(q)) + kK4WinOff;
    [[maybe_unused]] float P[7][2], SP[7][2], Q[7][2];
    // K4r: the m-tile before's g, rows 2m - 2 (k = 0, 1) and 2m - 1 (k = 2, 3)
    [[maybe_unused]] float R[7][4];
#pragma unroll
    for (int m = 0; m < (kRaw ? 4 : 5); ++m) {
      int acc[7][4];
#pragma unroll
      for (int nt = 0; nt < 7; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
      if (!kMlp1 || m < 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4];
          ldsm_x4(af, win + k4_swz(16 * m + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
          for (int nt = 0; nt < 7; ++nt) mma_s8_16832(acc[nt], af, bfr[nt][kk]);
        }
      }
      if ((kMlp1 || kRaw) && m < 4) {  // columns past 48 are zero support rows: |g| = 0
#pragma unroll
        for (int nt = 0; nt < 7; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) amax = fmaxf(amax, fabsf(static_cast<float>(acc[nt][k])));
      }
      __syncwarp();  // every lane's reads of this m-tile are done before rows land below it
      if constexpr (kRaw) {  // the raw g: the m-tile before's rows, then hold this one's
#pragma unroll
        for (int nt = 0; nt < 7; ++nt) {
          if (m > 0) {
            emit(2 * m - 2, nt, R[nt][0], R[nt][1]);
            emit(2 * m - 1, nt, R[nt][2], R[nt][3]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) R[nt][k] = static_cast<float>(acc[nt][k]);
        }
      } else {
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
    }
    if constexpr (kRaw) {  // the last m-tile's rows, after its reads
#pragma unroll
      for (int nt = 0; nt < 7; ++nt) {
        emit(6, nt, R[nt][0], R[nt][1]);
        emit(7, nt, R[nt][2], R[nt][3]);
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
        if (kMode == K4Mode::kCombine) track_max(y, nt, c0, c1);
        float* cr = cs_ + (8 * y + g) * kK4Ld + 8 * nt + 2 * t4;
        if (nt < 6)
          *reinterpret_cast<float2*>(cr) = make_float2(c0, c1);
        else if (t4 == 0)
          cr[0] = c0;
      });
    } else if constexpr (kMode != K4Mode::kCombine) {  // K4m, K4r: the absmax is run's
      run(q, [](int, int, float, float) {});
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

  if constexpr (kHold && kMlp1) {
    // K4m's code rows of every held frame: 16 consecutive bytes of the
    // (y, x, s) flatten of the 7 x 7 real taps a thread, zero past 2,401
    constexpr int kPieces = kKm / 16;  // 152 a frame
    for (int i = tid; i < nf * kPieces; i += kK4Threads) {
      const int j = i / kPieces, e0 = (i - j * kPieces) * 16;
      const float* cf = reinterpret_cast<const float*>(regions + j * kK4Region);
      int w = e0 / kS, s = e0 - w * kS, y = w / 7, x = w - y * 7;
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (e0 + k < kTaps)
          wd[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             quant8(cf[(8 * y + x) * kK4Ld + s], inv)))
                         << (8 * (k & 3));
        if (++s == kS) {
          s = 0;
          if (++x == 7) {
            x = 0;
            ++y;
          }
        }
      }
      *reinterpret_cast<uint4*>(outp + static_cast<size_t>(f0 + j) * kRow + e0) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  } else if constexpr (kHold) {
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
        if (kMlp1 && (y == 7 || g == 7)) return;  // K4m keeps the 7 x 7 real taps
        int8_t* qr = qs + (kMlp1 ? (7 * y + g) : (8 * y + g)) * kS + s;
        if (s < kS) qr[0] = quant8(c0, inv);
        if (s + 1 < kS) qr[1] = quant8(c1, inv);
      });
      if (kMlp1 && lane < kKm - kTaps) qs[kTaps + lane] = 0;
      __syncwarp();
      const int4* src = reinterpret_cast<const int4*>(qs);
      int4* dst = reinterpret_cast<int4*>(outp + static_cast<size_t>(frame(q)) * kRow);
      for (int k = lane; k < kRow / 16; k += 32) dst[k] = src[k];
      __syncwarp();
      load_job(q + 2);
    }
  }
  cluster_wait();  // no block leaves while another may still read its maximum
}

// K4 (kMlp1 false) and K4m's code rows (true)
template <bool kHold, bool kMlp1>
__global__ void __launch_bounds__(kK4Threads, 2)
corr_volume_kernel(const int8_t* __restrict__ fm, const int8_t* __restrict__ sup,
                   const int* __restrict__ starts, const float* __restrict__ wxy,
                   int8_t* __restrict__ vol, float* __restrict__ scale_out, int Tp, int Hp,
                   int Wp, int cs) {
  k4_cluster_body<kHold, kMlp1 ? K4Mode::kMlp1 : K4Mode::kCombine>(fm, sup, starts, wxy, vol,
                                                                   scale_out, Tp, Hp, Wp, cs);
}

// K4r (wxy unused)
template <bool kHold>
__global__ void __launch_bounds__(kK4Threads, 2)
k4r_volume_kernel(const int8_t* __restrict__ fm, const int8_t* __restrict__ sup,
                  const int* __restrict__ starts, const float* __restrict__ wxy,
                  int8_t* __restrict__ vol, float* __restrict__ scale_out, int Tp, int Hp, int Wp,
                  int cs) {
  k4_cluster_body<kHold, K4Mode::kRaw>(fm, sup, starts, wxy, vol, scale_out, Tp, Hp, Wp, cs);
}

template <bool kHold, K4Mode kMode>
int launch_k4(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
              int8_t* vol, float* scale, int NP, int Tp, int Hp, int Wp, int cs, void* stream) {
  auto kern = kMode == K4Mode::kRaw ? k4r_volume_kernel<kHold>
                                    : corr_volume_kernel<kHold, kMode == K4Mode::kMlp1>;
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

// ------------------------------------------------------- K4m's MLP1
// The s8 MLP1 of K4m's code rows (NP * Tp rows of 2,432 bytes, from
// corr_volume_kernel<hold, true>) against W1 (384 x 2,432 codes): a block
// takes 128 rows, several points' frames, so W1 streams from L2 once per
// 128 rows; each K step of 64 bytes brings the rows' codes and W1's 384 rows
// through a kMlpStages-deep cp.async ring; 16 warps as 4 x 4, warp tiles 32
// x 96 on mma.sync m16n8k32. The epilogue (h32 * w1s) * (s * sup_scale) +
// b1, in that order (the point's s and sup_scale multiplied once a row),
// is staged in the ring's shared memory and stored in 16-byte pieces.
constexpr int kMlpBM = 128, kMlpBK = 64, kMlpLd = kMlpBK + 16, kMlpStages = 5;
constexpr int kMlpThreads = 512, kMlpNW = 4, kMlpNI = kDh / (8 * kMlpNW);  // 12
constexpr int kMlpStageA = kMlpBM * kMlpLd, kMlpStage = kMlpStageA + kDh * kMlpLd;
constexpr int kMlpOut = kDh + 8;  // row stride (elements) of the staged output
constexpr int kMlpSmem = kMlpStages * kMlpStage + kMlpBM * 4;
static_assert(kMlpBM * kMlpOut * 4 <= kMlpStages * kMlpStage, "f32 output staged in the ring");
static_assert(kMlpSmem <= 232448, "one block an SM");

template <typename OutT>
__global__ void __launch_bounds__(kMlpThreads, 1)
mlp1_gemm_kernel(const int8_t* __restrict__ codes, const float* __restrict__ gscale,
                 const float* __restrict__ sup_scale, const int8_t* __restrict__ w1,
                 const float* __restrict__ w1s, const float* __restrict__ b1,
                 OutT* __restrict__ out, int rows, int Tp) {
  extern __shared__ __align__(16) unsigned char m1_smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(m1_smem);
  float* rs = reinterpret_cast<float*>(ring + kMlpStages * kMlpStage);  // the rows' s * sup_scale
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp / kMlpNW, wn = warp % kMlpNW;
  const int m0 = blockIdx.x * kMlpBM, n = min(kMlpBM, rows - m0);
  constexpr int KT = kKm / kMlpBK, CH = kMlpBK / 16;
  auto load = [&](int kt) {
    int8_t* st = ring + (kt % kMlpStages) * kMlpStage;
    for (int i = tid; i < (kMlpBM + kDh) * CH; i += kMlpThreads) {
      const int r = i / CH, c = i - r * CH;
      if (r < kMlpBM) {
        const bool ok = r < n;
        cp_async16(st + r * kMlpLd + 16 * c,
                   codes + static_cast<size_t>(m0 + (ok ? r : 0)) * kKm + kt * kMlpBK + 16 * c, ok);
      } else {
        cp_async16(st + kMlpStageA + (r - kMlpBM) * kMlpLd + 16 * c,
                   w1 + static_cast<size_t>(r - kMlpBM) * kKm + kt * kMlpBK + 16 * c, true);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kMlpStages - 1; ++s) {
    load(s);
    cp_async_commit();
  }
  if (tid < kMlpBM) {  // visible after the loop's first barrier
    const int pt = (m0 + min(tid, n - 1)) / Tp;
    rs[tid] = __fmul_rn(gscale[pt], sup_scale[pt]);
  }
  int acc[2][kMlpNI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMlpNI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  const int a_off = (wm * 32 + (lane & 15)) * kMlpLd + (lane >> 4) * 16;
  const int b_off = kMlpStageA + (wn * 8 * kMlpNI + (lane >> 4) * 8 + (lane & 7)) * kMlpLd +
                    ((lane >> 3) & 1) * 16;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kMlpStages - 2>();
    __syncthreads();
    if (kt + kMlpStages - 1 < KT) load(kt + kMlpStages - 1);
    cp_async_commit();
    const int8_t* st = ring + (kt % kMlpStages) * kMlpStage;
    warp_mma<2, kMlpNI, kMlpBK, kMlpLd>(acc, st + a_off, kMlpLd, st, b_off, 0);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the output tile is staged there
  OutT* os = reinterpret_cast<OutT*>(ring);
#pragma unroll
  for (int ni = 0; ni < kMlpNI; ++ni) {
    const int c = wn * 8 * kMlpNI + ni * 8 + 2 * t4;
    const float wa = w1s[c], wb = w1s[c + 1], ba = b1[c], bb = b1[c + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mi * 16 + g + 8 * h;
        const float sc = rs[r];
        const float v0 = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h]), wa), sc), ba);
        const float v1 = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h + 1]), wb), sc), bb);
        if constexpr (sizeof(OutT) == 4)
          *reinterpret_cast<float2*>(os + r * kMlpOut + c) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(os + r * kMlpOut + c) = __floats2bfloat162_rn(v0, v1);
      }
  }
  __syncthreads();
  constexpr int P = kDh * static_cast<int>(sizeof(OutT)) / 16;  // 16-byte pieces a row
  for (int i = tid; i < n * P; i += kMlpThreads) {
    const int r = i / P, c = i - r * P;
    reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + r) * kDh)[c] =
        reinterpret_cast<const uint4*>(os + r * kMlpOut)[c];
  }
}

// K4m: the code rows and scales (K4's cluster kernel in its K4m mode), then
// MLP1 on them.
template <typename OutT>
int launch_k4m(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
               const int8_t* w1, const float* w1s, const float* b1, const float* sup_scale,
               int8_t* codes, float* gscale, void* out, int NP, int Tp, int Hp, int Wp, int cs,
               bool hold, void* stream) {
  int e = hold ? launch_k4<true, K4Mode::kMlp1>(fm, sup, starts, wxy, codes, gscale, NP, Tp, Hp,
                                                Wp, cs, stream)
               : launch_k4<false, K4Mode::kMlp1>(fm, sup, starts, wxy, codes, gscale, NP, Tp, Hp,
                                                 Wp, cs, stream);
  if (e != cudaSuccess) return e;
  auto kern = mlp1_gemm_kernel<OutT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlpSmem);
  if (e != cudaSuccess) return e;
  const int rows = NP * Tp;
  kern<<<(rows + kMlpBM - 1) / kMlpBM, kMlpThreads, kMlpSmem, static_cast<cudaStream_t>(stream)>>>(
      codes, gscale, sup_scale, w1, w1s, b1, static_cast<OutT*>(out), rows, Tp);
  return cudaGetLastError();
}

// k4_plan's tiling, as corr_volume_kernel / k4r_volume_kernel take it
inline bool k4_tiling_ok(int NP, int Tp, int Hp, int Wp, int cluster, int hold) {
  return NP >= 1 && Tp >= 1 && Hp >= 8 && Wp >= 8 && cluster >= 1 && cluster <= kK4MaxCluster &&
         cluster <= Tp && (!hold || (Tp + cluster - 1) / cluster <= kK4Regions);
}

}  // namespace ct

extern "C" {

// K4m's first body (corr_mlp1_kernel, one block a point, two passes over
// the windows; PR 5): kept as the yardstick of the two launches below.
int ct_corr_mlp1_first(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                       const int8_t* w1, const float* w1s, const float* b1,
                       const float* sup_scale, void* out, int out_bf16, int NP, int Tp, int Hp,
                       int Wp, int Dh, void* stream) {
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8 || Dh != ct::kDh) return cudaErrorInvalidValue;
  return out_bf16 ? ct::launch_mlp1<__nv_bfloat16>(fm, sup, starts, wxy, w1, w1s, b1, sup_scale,
                                                   out, NP, Tp, Hp, Wp, stream)
                  : ct::launch_mlp1<float>(fm, sup, starts, wxy, w1, w1s, b1, sup_scale, out, NP,
                                           Tp, Hp, Wp, stream);
}

// K4m: out (NP, Tp, 384) pre-GELU MLP1 rows, bf16 (out_bf16) or float32;
// w1 (384, 2432) int8 codes, w1s / b1 (384,) f32, sup_scale (NP,) f32;
// codes (NP * Tp, 2432) int8 and gscale (NP,) f32: the scratch between the
// two launches, from the caller; `cluster` and `hold` as K4's (k4_plan).
int ct_corr_mlp1(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                 const int8_t* w1, const float* w1s, const float* b1, const float* sup_scale,
                 int8_t* codes, float* gscale, void* out, int out_bf16, int NP, int Tp, int Hp,
                 int Wp, int Dh, int cluster, int hold, void* stream) {
  if (!ct::k4_tiling_ok(NP, Tp, Hp, Wp, cluster, hold) || Dh != ct::kDh ||
      static_cast<long long>(NP) * Tp > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return out_bf16 ? ct::launch_k4m<__nv_bfloat16>(fm, sup, starts, wxy, w1, w1s, b1, sup_scale,
                                                  codes, gscale, out, NP, Tp, Hp, Wp, cluster,
                                                  hold, stream)
                  : ct::launch_k4m<float>(fm, sup, starts, wxy, w1, w1s, b1, sup_scale, codes,
                                          gscale, out, NP, Tp, Hp, Wp, cluster, hold, stream);
}

// K4m's MLP1 kernel's shared-memory bytes a block (k4m_plan checks its arithmetic).
int ct_k4m_gemm_smem() { return ct::kMlpSmem; }

// K4 on corr_cuda.k4_plan's tiling: `cluster` blocks a point; hold = 1 keeps
// the combined volume on chip (one pass; every block at most 8 frames).
int ct_corr_volume(const int8_t* fm, const int8_t* sup, const int* starts, const float* wxy,
                   int8_t* vol, float* scale, int NP, int Tp, int Hp, int Wp, int cluster,
                   int hold, void* stream) {
  if (!ct::k4_tiling_ok(NP, Tp, Hp, Wp, cluster, hold)) return cudaErrorInvalidValue;
  return hold ? ct::launch_k4<true, ct::K4Mode::kCombine>(fm, sup, starts, wxy, vol, scale, NP,
                                                          Tp, Hp, Wp, cluster, stream)
              : ct::launch_k4<false, ct::K4Mode::kCombine>(fm, sup, starts, wxy, vol, scale, NP,
                                                           Tp, Hp, Wp, cluster, stream);
}

// K4's shared-memory bytes a block (k4_plan checks its own arithmetic).
int ct_k4_smem() { return ct::kK4Smem; }

// K4r: the raw volume's codes and scale, K4's cluster kernel in its K4r mode
// on the same tiling (k4_plan: `cluster` and `hold` as ct_corr_volume's).
int ct_corr_volume_raw(const int8_t* fm, const int8_t* sup, const int* starts, int8_t* vol,
                       float* scale, int NP, int Tp, int Hp, int Wp, int cluster, int hold,
                       void* stream) {
  if (!ct::k4_tiling_ok(NP, Tp, Hp, Wp, cluster, hold)) return cudaErrorInvalidValue;
  return hold ? ct::launch_k4<true, ct::K4Mode::kRaw>(fm, sup, starts, nullptr, vol, scale, NP, Tp,
                                                      Hp, Wp, cluster, stream)
              : ct::launch_k4<false, ct::K4Mode::kRaw>(fm, sup, starts, nullptr, vol, scale, NP,
                                                       Tp, Hp, Wp, cluster, stream);
}

// K4f: vol (NP, Tp, 64, 49) in the operands' dtype (bf16 = 1: bfloat16, else
// float32) on k4f_plan's tiling: tasks of `group` frames of a point,
// `blocks` persistent blocks (at most one a task).
int ct_corr_volume_float(const void* fm, const void* sup, const int* starts, void* vol, int bf16,
                         int NP, int Tp, int Hp, int Wp, int group, int blocks, void* stream) {
  const long long tasks = static_cast<long long>((Tp + group - 1) / (group < 1 ? 1 : group)) * NP;
  if (NP < 1 || Tp < 1 || Hp < 8 || Wp < 8 || group < 1 || blocks < 1 || blocks > tasks ||
      tasks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return bf16 ? ct::launch_k4f<__nv_bfloat16>(fm, sup, starts, vol, NP, Tp, Hp, Wp, group, blocks,
                                              stream)
              : ct::launch_k4f<float>(fm, sup, starts, vol, NP, Tp, Hp, Wp, group, blocks, stream);
}

// K4f's shared-memory bytes a block (k4f_plan checks its arithmetic).
int ct_k4f_smem(int bf16) {
  return bf16 ? ct::K4fLayout<__nv_bfloat16>::kSmem : ct::K4fLayout<float>::kSmem;
}

}  // extern "C"
