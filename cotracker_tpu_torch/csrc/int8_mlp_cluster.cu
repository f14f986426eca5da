// K12 on Hopper: x + fc2(gelu(fc1(LN(x)))), W8A8, as a thread-block cluster
// of 8 blocks a 64-row tile, with resident weights and one fc1 pass (sm_90a).
//
// Replaces, on the H100, the Pallas body
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_mlp_kernel (K12)
// (wrapper fused_ln_mlp_int8 in ops/kernels/mlp_int8_cuda.py, its tiling
// k12_plan) for float32 and bfloat16 tokens, one launch a call.
//
// Contract (ln_mlp_plain): LN (affine-free, or the bf16_ln variant; do_ln 0
// quantizes x as it is) + row quant, fc1 dequant + b1, tanh-GELU, the GELU
// codes' row scale from the absmax of the whole 1,536-wide row (gelu_fold:
// from its pre-GELU max), fc2 dequant, and x + (y * (su * s2) + b2) in that
// order, _rn intrinsics throughout. The device code of every step is the
// first body's (int8_fused.cu::ln_mlp_kernel), the s8 products are exact in
// any split and a max is order-free, so the two are bit-identical.
//
// What bounds it: int8 operations. At the micro-benchmark's 604,800 rows
// it is 1.43 T int8 operations (0.72 ms at 1,979 TOP/s) against 0.93 GB of
// tokens (0.28 ms). The first body spent its time elsewhere: every 64-row
// tile staged 2 x 590 KB of w1 (fc1 twice: the GELU codes' scale needs the
// whole row's max before the first code) and 590 KB of w2 by plain loads,
// with a block barrier every 32 bytes of K: ~16.7 GB from L2 a call. Here:
//   * a cluster of K12_CLUSTER = 8 blocks takes a 64-row tile. Block j owns
//     fc1 columns [192j, 192j + 192) and output columns [48j, 48j + 48). It
//     loads its 192 rows of w1 and 48 rows of w2 (padded for ldmatrix) and
//     their scales and biases once, by bulk copies under an mbarrier, and
//     keeps them in shared memory (151 KB) for the whole kernel. Clusters
//     are persistent and walk the tiles cluster_id, cluster_id + clusters...
//   * LN + row quant once for the cluster: warp w of block j quantizes row
//     8j + w (its x row copied in by cp.async a tile ahead) and writes the
//     codes and the scale into every block's A through distributed shared
//     memory (DSMEM);
//   * fc1 once: the block's 64 x 192 products on mma.sync from ldmatrix
//     fragments (warp tiles 32 x 48), dequant + b1 and tanh-GELU in f32, the
//     values kept in registers. Each row's partial max goes to shared
//     memory; after a cluster barrier each block takes the max of the 8
//     partials through DSMEM and quantizes its 64 x 192 GELU values;
//   * fc2 by gathering the codes: each block computes its 48 output columns
//     over all 1,536 codes of the tile's rows, its own 192 first, then each
//     peer's, copied 16 bytes a thread from the peer's shared memory (loaded
//     two chunks ahead) into a double buffer while the previous chunk's
//     products run. Warp tiles 32 x
//     24 over one half of each chunk's K (fewer fragment loads a product than
//     16 x 24 over all of it); the two halves' s32 sums meet in shared memory
//     at the end. The other exact split, over K with the 64 x 384 s32
//     partials reduce-scattered, moves the same ~86 KB a block a tile over
//     DSMEM, but as remote s32 adds; gathering keeps every DSMEM access a
//     plain 16-byte load and the fc2 accumulator in registers;
//   * the epilogue reads x for its 48 columns from device memory (issued
//     before the peers' chunks, so the loads overlap their products).
// Two cluster barriers a tile: the partial maxima are complete (after it no
// block reads the tile's A again, so the next tile's LN rows go out right
// after the codes), and the GELU codes and the next tile's A are complete
// (arrived on after both are written, waited for after the block's own
// chunk of fc2).
// Shared memory a block: K12_SMEM (below).

#include "int8_tile.cuh"

namespace ct {

constexpr int K12_CLUSTER = 8;
constexpr int K12_BM = 64;
constexpr int K12_THREADS = 256;
constexpr int K12_HB = KH / K12_CLUSTER;
constexpr int K12_NB = KC / K12_CLUSTER;
constexpr int K12_LDW1 = KC + 16;
constexpr int K12_LDW2 = KH + 16;
constexpr int K12_LDU = K12_HB + 16;
constexpr int K12_W1 = K12_HB * K12_LDW1;
constexpr int K12_W2 = K12_NB * K12_LDW2;
constexpr int K12_A = K12_BM * LDA_C;
constexpr int K12_U = K12_BM * K12_LDU;
constexpr int K12_XS = K12_THREADS / 32 * KC * 4;
constexpr int K12_VEC = (2 * K12_HB + 2 * K12_NB + 4 * K12_BM) * 4;
constexpr int K12_SMEM = K12_W1 + K12_W2 + K12_A + 3 * K12_U + K12_XS + K12_VEC + 16;
constexpr int K12_WBYTES = K12_HB * KC + K12_NB * KH + (2 * K12_HB + 2 * K12_NB) * 4;
static_assert(K12_SMEM <= 232448, "K12's block fits the shared memory of an SM");
static_assert(K12_BM == K12_CLUSTER * (K12_THREADS / 32), "one LayerNorm row a warp of the cluster");
static_assert(K12_BM * K12_HB / 16 == 3 * K12_THREADS, "a peer's codes: three 16-byte pieces a thread");

// two neighbouring elements of a token row: one 4-byte (bf16) or 8-byte
// (f32) access
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename T, bool kBf16Ln, bool kGeluFold>
__global__ void __launch_bounds__(K12_THREADS, 1)
k12_cluster_kernel(const T* __restrict__ x, int rows, int do_ln, const int8_t* __restrict__ w1,
                   const float* __restrict__ s1, const float* __restrict__ b1,
                   const int8_t* __restrict__ w2, const float* __restrict__ s2,
                   const float* __restrict__ b2, float eps, T* __restrict__ out) {
  constexpr int NWARP = K12_THREADS / 32, CH = K12_HB / 16, XCH = KC * int(sizeof(T)) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* W1 = reinterpret_cast<int8_t*>(smem);  // 192 rows of w1, stride K12_LDW1
  int8_t* W2 = W1 + K12_W1;                      // 48 rows of w2, stride K12_LDW2
  int8_t* A = W2 + K12_W2;                       // the tile's 64 rows of LN codes
  int8_t* U = A + K12_A;                         // this block's 64 x 192 GELU codes
  int8_t* stage = U + K12_U;                     // two buffers of a peer's codes
  T* xs = reinterpret_cast<T*>(stage + 2 * K12_U);  // each warp's next x row
  float* s1s = reinterpret_cast<float*>(stage + 2 * K12_U + K12_XS);
  float* b1s = s1s + K12_HB;
  float* s2s = b1s + K12_HB;
  float* b2s = s2s + K12_NB;
  float* sh = b2s + K12_NB;    // the rows' LN-code scales
  float* su = sh + K12_BM;     // their GELU-code scales
  float* iu = su + K12_BM;     // and the reciprocals
  float* amax = iu + K12_BM;   // this block's partial row maxima (>= +0: ordered as bits)
  uint64_t* wbar = reinterpret_cast<uint64_t*>(amax + K12_BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = cluster_rank();
  const int cid = blockIdx.x / K12_CLUSTER, ncl = gridDim.x / K12_CLUSTER;
  const int tiles = (rows + K12_BM - 1) / K12_BM;
  const int lr = NWARP * rank + warp;  // the tile row this warp quantizes

  // this block's weight slices, once
  if (tid == 0) {
    mbar_init(wbar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(wbar, K12_WBYTES);
    __syncwarp();
    for (int r = lane; r < K12_HB; r += 32)
      bulk_g2s(W1 + r * K12_LDW1, w1 + static_cast<size_t>(K12_HB * rank + r) * KC, KC, wbar);
    for (int r = lane; r < K12_NB; r += 32)
      bulk_g2s(W2 + r * K12_LDW2, w2 + static_cast<size_t>(K12_NB * rank + r) * KH, KH, wbar);
    if (lane == 0) {
      bulk_g2s(s1s, s1 + K12_HB * rank, K12_HB * 4, wbar);
      bulk_g2s(b1s, b1 + K12_HB * rank, K12_HB * 4, wbar);
      bulk_g2s(s2s, s2 + K12_NB * rank, K12_NB * 4, wbar);
      bulk_g2s(b2s, b2 + K12_NB * rank, K12_NB * 4, wbar);
    }
  }
  // this warp's x row of tile i into its buffer (a cp.async group)
  auto fetch_x = [&](int i) {
    const int row = i * K12_BM + lr;
    if (i < tiles && row < rows) {
      const char* src = reinterpret_cast<const char*>(x + static_cast<size_t>(row) * KC);
      char* dst = reinterpret_cast<char*>(xs + warp * KC);
      for (int c = lane; c < XCH; c += 32) cp_async16(dst + 16 * c, src + 16 * c, true);
    }
    cp_async_commit();
  };
  // (1) LN + row quant of row lr of tile t into every block's A and sh
  auto ln_rows = [&](int t) {
    const int nt = min(K12_BM, rows - t * K12_BM);
    int8_t* ar = A + lr * LDA_C;
    float sc = 0.f;
    cp_async_wait<0>();
    __syncwarp();
    if (lr < nt)
      sc = ln_quant_row<T, KC / 32, kBf16Ln>(xs + warp * KC, lane, nullptr, nullptr, eps, do_ln,
                                             ar);
    else
      for (int i = lane; i < KC; i += 32) ar[i] = 0;
    __syncwarp();
    fetch_x(t + ncl);
    if (lane < KC / 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(ar + 16 * lane);
      for (int k = 1; k < K12_CLUSTER; ++k)
        cluster_st16(ar + 16 * lane, (rank + k) % K12_CLUSTER, v);
    } else if (lane == KC / 16) {
      for (int k = 0; k < K12_CLUSTER; ++k) cluster_st(sh + lr, k, sc);
    }
    __syncwarp();
  };
  fetch_x(cid);
  if (tid < K12_BM) amax[tid] = 0.f;
  mbar_wait(wbar, 0);
  ln_rows(cid);
  cluster_arrive();
  cluster_wait();

  // fc1's warps as 2 (rows) x 4 (columns); fc2's as 2 (rows) x 2 (columns)
  // x 2 (halves of each 192-byte chunk of K), summed at the end
  const int wm = warp >> 2, wn = warp & 3, kh = warp >> 2, wm2 = (warp >> 1) & 1, wn2 = warp & 1;
  const int8_t* a1 = A + (wm * 32 + (lane & 15)) * LDA_C + (lane >> 4) * 16;
  const int b1_pair = (wn * 48 + (lane >> 4) * 8 + (lane & 7)) * K12_LDW1 + ((lane >> 3) & 1) * 16;
  const int a2 = (wm2 * 32 + (lane & 15)) * K12_LDU + (lane >> 4) * 16 + K12_HB / 2 * kh;
  const int b2_pair = (wn2 * 24 + (lane >> 4) * 8 + (lane & 7)) * K12_LDW2 + ((lane >> 3) & 1) * 16 +
                      K12_HB / 2 * kh;
  const int b2_last = (wn2 * 24 + 16 + (lane & 7)) * K12_LDW2 + ((lane >> 3) & 1) * 16 +
                      K12_HB / 2 * kh;
  int* red = reinterpret_cast<int*>(stage);  // the upper K half's sums, at the end of a tile

  for (int tile = cid; tile < tiles; tile += ncl) {
    const int m0 = tile * K12_BM, n = min(K12_BM, rows - m0);

    // (2) fc1 on the block's 192 columns, GELU in registers, the rows' partial max
    float gv[2][6][4];
    {
      int acc[2][6][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
      warp_mma<2, 6, KC, K12_LDW1>(acc, a1, LDA_C, W1, b1_pair, 0);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + (lane >> 2) + h * 8;
          const float shr = sh[r];
          float m = 0.f;
#pragma unroll
          for (int ni = 0; ni < 6; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = wn * 48 + ni * 8 + (lane & 3) * 2 + e;
              const float pre = __fadd_rn(dequant(acc[mi][ni][2 * h + e], shr, s1s[c]), b1s[c]);
              const float gl = gelu_tanh(pre);
              gv[mi][ni][2 * h + e] = gl;
              m = kGeluFold ? fmaxf(m, pre) : fmaxf(m, fabsf(gl));
            }
          m = __fadd_rn(quad_max(m), 0.f);
          if ((lane & 3) == 0) atomicMax(reinterpret_cast<unsigned*>(amax) + r, __float_as_uint(m));
        }
    }
    // every block's partial maxima; past this barrier no block reads this
    // tile's A or sh again
    __syncwarp();
    cluster_arrive();
    cluster_wait();

    // (3) the rows' GELU-code scales from the 8 blocks' partial maxima
    if (tid < K12_BM) {
      float m = 0.f;
      for (int k = 0; k < K12_CLUSTER; ++k) m = fmaxf(m, cluster_ld(amax + tid, k));
      const float s = kGeluFold ? gelu_fold_scale(m) : __fmul_rn(fmaxf(m, 1e-20f), 1.0f / 127.0f);
      su[tid] = s;
      iu[tid] = 1.0f / s;
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mi * 16 + (lane >> 2) + h * 8;
        const float inv = iu[r];
#pragma unroll
        for (int ni = 0; ni < 6; ++ni)
          *reinterpret_cast<char2*>(U + r * K12_LDU + wn * 48 + ni * 8 + (lane & 3) * 2) =
              make_char2(quant8(gv[mi][ni][2 * h], inv), quant8(gv[mi][ni][2 * h + 1], inv));
      }
    // the next tile's rows into every block's A and sh
    if (tile + ncl < tiles) ln_rows(tile + ncl);
    __syncthreads();
    cluster_arrive();  // this block's codes and its rows of the next tile are ready

    // (4) fc2 on the block's 48 output columns: its own codes, then each peer's
    int acc2[2][3][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) acc2[i][j][0] = acc2[i][j][1] = acc2[i][j][2] = acc2[i][j][3] = 0;
    warp_mma<2, 3, K12_HB / 2, K12_LDW2>(acc2, U + a2, K12_LDU, W2 + K12_HB * rank, b2_pair,
                                         b2_last);
    float2 xv[2][2][3];
    if (kh == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ni = 0; ni < 3; ++ni) {
            const int r = wm2 * 32 + mi * 16 + (lane >> 2) + 8 * h;
            const size_t o = static_cast<size_t>(m0 + r) * KC + K12_NB * rank + wn2 * 24 +
                             ni * 8 + (lane & 3) * 2;
            xv[mi][h][ni] = r < n ? load2(x + o) : make_float2(0.f, 0.f);
          }
    }
    cluster_wait();  // every block's codes (and the peers have read this block's maxima)
    if (tid < K12_BM) amax[tid] = 0.f;  // ordered before the next tile's atomics by the barriers below
    // the peers' chunks k = 1..7 (peer rank + k), each loaded two chunks
    // ahead into one of two register sets, stored into buffer k & 1
    uint4 v[2][3];
    auto fetch_codes = [&](int k, uint4(&d)[3]) {
      const int p = (rank + k) % K12_CLUSTER;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = tid + K12_THREADS * j, r = i / CH, c = i - r * CH;
        d[j] = cluster_ld16(U + r * K12_LDU + 16 * c, p);
      }
    };
    fetch_codes(1, v[1]);
    fetch_codes(2, v[0]);
#pragma unroll
    for (int k = 1; k < K12_CLUSTER; ++k) {
      int8_t* buf = stage + (k & 1) * K12_U;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int i = tid + K12_THREADS * j, r = i / CH, c = i - r * CH;
        *reinterpret_cast<uint4*>(buf + r * K12_LDU + 16 * c) = v[k & 1][j];
      }
      __syncthreads();  // also: every warp is past its products on this buffer two chunks ago
      if (k + 2 < K12_CLUSTER) fetch_codes(k + 2, v[k & 1]);
      warp_mma<2, 3, K12_HB / 2, K12_LDW2>(acc2, buf + a2, K12_LDU,
                                           W2 + K12_HB * ((rank + k) % K12_CLUSTER), b2_pair,
                                           b2_last);
    }
    // the upper K half's sums into the first buffer (free since the last
    // chunk's barrier), then the lower half's warps finish the tile
    const int ti = tid & (K12_THREADS / 2 - 1);
    if (kh == 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 3; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((mi * 3 + ni) * 4 + e) * (K12_THREADS / 2) + ti] = acc2[mi][ni][e];
    }
    __syncthreads();
    if (kh == 1) continue;

    // (5) out = x + (y * (su * s2) + b2) on the block's columns
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm2 * 32 + mi * 16 + (lane >> 2) + 8 * h;
        if (r >= n) continue;
        const float sr = su[r];
#pragma unroll
        for (int ni = 0; ni < 3; ++ni) {
          const int cl = wn2 * 24 + ni * 8 + (lane & 3) * 2;
          const size_t o = static_cast<size_t>(m0 + r) * KC + K12_NB * rank + cl;
          const int y0i = acc2[mi][ni][2 * h] + red[((mi * 3 + ni) * 4 + 2 * h) * (K12_THREADS / 2) + ti];
          const int y1i =
              acc2[mi][ni][2 * h + 1] + red[((mi * 3 + ni) * 4 + 2 * h + 1) * (K12_THREADS / 2) + ti];
          const float y0 = __fadd_rn(dequant(y0i, sr, s2s[cl]), b2s[cl]);
          const float y1 = __fadd_rn(dequant(y1i, sr, s2s[cl + 1]), b2s[cl + 1]);
          store2(out + o, __fadd_rn(xv[mi][h][ni].x, y0), __fadd_rn(xv[mi][h][ni].y, y1));
        }
      }
  }
  cp_async_wait<0>();
  // no block leaves while a peer may still read its shared memory
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

template <typename T>
struct TypeTag {
  using type = T;
};

template <typename T, bool kBf16Ln, bool kGeluFold>
cudaError_t launch_k12(const void* x, int rows, int do_ln, const int8_t* w1, const float* s1,
                       const float* b1, const int8_t* w2, const float* s2, const float* b2,
                       float eps, int clusters, void* out, cudaStream_t s) {
  auto kern = k12_cluster_kernel<T, kBf16Ln, kGeluFold>;
  cudaError_t e = set_smem(kern, K12_SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K12_CLUSTER * clusters);
  cfg.blockDim = dim3(K12_THREADS);
  cfg.dynamicSmemBytes = K12_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K12_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), rows, do_ln, w1, s1, b1, w2, s2, b2,
                         eps, static_cast<T*>(out));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace ct

using namespace ct;

extern "C" {

// K12's shared-memory bytes a block (mlp_int8_cuda.k12_plan mirrors them).
int ct_k12_smem() { return K12_SMEM; }

// How many 8-block clusters of K12 the card seats at once (one block an SM;
// a cluster lies within one GPC), or minus a cudaError_t code.
int ct_k12_max_clusters() {
  auto kern = k12_cluster_kernel<__nv_bfloat16, false, false>;
  cudaError_t e = set_smem(kern, K12_SMEM);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K12_CLUSTER);
  cfg.blockDim = dim3(K12_THREADS);
  cfg.dynamicSmemBytes = K12_SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K12_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// K12 (mlp_int8_pallas.py::_mlp_kernel): x (rows, 384) f32 or bf16 (bf16 =
// 1), 16-byte aligned as are the weights, scales and biases -> out (rows,
// 384), on `clusters` persistent 8-block clusters (k12_plan's count, at most
// one per 64-row tile); one launch.
int ct_k12_cluster(const void* x, int bf16, int rows, int C, int H, int do_ln, const int8_t* w1,
                   const float* s1, const float* b1, const int8_t* w2, const float* s2,
                   const float* b2, float eps, int bf16_ln, int gelu_fold, int clusters,
                   void* out, void* stream) {
  if (rows < 1 || C != KC || H != KH || clusters < 1 || clusters > (rows + K12_BM - 1) / K12_BM)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto ln, auto fold) {
    return launch_k12<typename decltype(t)::type, decltype(ln)::value, decltype(fold)::value>(
        x, rows, do_ln, w1, s1, b1, w2, s2, b2, eps, clusters, out, s);
  };
  using T_ = std::true_type;
  using F_ = std::false_type;
  auto modes = [&](auto t) {
    if (bf16_ln) return gelu_fold ? go(t, T_{}, T_{}) : go(t, T_{}, F_{});
    return gelu_fold ? go(t, F_{}, T_{}) : go(t, F_{}, F_{});
  };
  return bf16 ? modes(TypeTag<__nv_bfloat16>{}) : modes(TypeTag<float>{});
}

}  // extern "C"
