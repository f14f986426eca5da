// K1 on Hopper: the whole W8A8 time block in two launches, K9 and K2 on
// K1's tail, and K8 and K10 on the tail's weight stream (sm_90a).
//
// Replaces, on the H100, the Pallas bodies
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_time_block_kernel  (K1)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_out_mlp_kernel     (K9)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_space_block_kernel (K2)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_qkv_kernel         (K8)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_space_block_allt_kernel (K11)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_dense_kernel       (K10)
// (wrappers fused_time_block_int8, fused_attnout_res_mlp_int8,
// fused_space_block_int8, fused_ln_qkv_int8, fused_space_block_allt_int8,
// fused_ln_dense_int8)
// for bfloat16 tokens, driven
// from ops/kernels/mlp_int8_cuda.py (the plans: k1_plan, k2_plan, k8_plan,
// k10_plan; K9's body: k9_route). float32 tokens keep the launch chains and
// the K8 / K9 bodies of int8_blocks.cu and K10's of int8_fused.cu (K2 also
// past the 64 virtual tokens its front stages). K8's and K10's design and
// what bounds them: the note above their kernel.
//
// K2 (ct_k2_space_block) is a front of its own (k2_front_kernel, below)
// and then K1's tail unchanged, since the block's second half is K1's
// operation for operation: a quantized from f32 by its row absmax, r = (x +
// to_out(a)) + bo, LN + quant, fc1 + GELU + quant, (r + y) + b2. The front
// hands the tail a's int8 codes and row scales, 388 bytes a row, as K1's
// front does. Contract of the front (space_block_plain): LN (affine-free,
// eps 1e-6, or the bf16_ln variant) + row quant, q = dequant + bias
// rounded to bf16, the frame's V <= 64 keys and values, softmax of the f32
// logits normalized before its rounding to bf16 (K6's), P.V in f32. What
// bounds K2: int8 operations, 1.81 T at 10,240 tracks x 60 frames (0.92 ms
// at 1,979 TOP/s; with the attention's 0.06 T of bf16, 0.98 ms); the launch
// chain it replaced (nine launches, kept for f32) moved q, a, r and the
// 1,536-wide u through device memory, ~13-15 GB, and its products waited
// on each K step's plain weight loads. Here only
// a's codes cross between the two launches; the tail's weight stream and
// products are K1's. Shared memory is the front's constraint: a frame's
// keys and values (96 KB), a 64-row tile's x rows (48 KB, by bulk copies a
// tile ahead), codes (25 KB), a head pair's q (12 KB) and the q ring (30
// KB) leave no room for a in f32 (99 KB), so each warp keeps its four
// (16 rows, head) outputs in registers (96 floats) until the rows' absmax.
// How far it got (scripts/torch_cores.py, one NVIDIA H100 80GB HBM3 at 700
// W): 10.13-10.16 ms at 10,240 x 60 (the chain 14.45-14.46 in the same
// call; the front 1.92-1.94, the tail 8.24-8.30) and 2.82-2.84 at x 16
// (3.97-3.98); the tail, as K1's, is what bounds it now.
//
// K11 (ct_k11_space_block) is K2's function (space_block_plain): the JAX
// body tiles 64 tracks x all T frames only to give the TPU's matrix unit
// BLK * T rows, and keeps q in the kv dtype, a in f32 and the MLP row by
// row. So it runs K2's two launches, its front under a name of its own
// (k11_front_kernel, the same body) for the profiler's records: the
// frame-major walk stages one frame's keys and values once for a run of
// tiles, where a track-major walk would stage them for every tile. Its
// last residual is K2's (r + y) + b2, the JAX body's order.
//
// K9 (ct_k9_tail) is K1's tail with another front door: its prologue reads
// the attention output a in bf16 and quantizes each row in the tile (K1's
// reads the front's codes), and its last residual is r + (y + b2) (K1's
// (r + y) + b2), the order of each JAX body; one template flag (kK9) on one
// body (tail_body), two kernel names (k1_tail_kernel, k9_tail_kernel). So
// K9 streams its weights as K1's tail does, one GELU a row, fc2 per fc1
// tile in registers: 6.96 ms at 2,048 tracks x 250 frames (19.56 for the
// first body, whose products waited on every K step's plain weight loads
// and whose 1,536-wide GELU codes were staged in full; bound 0.69 ms by
// int8 operations), 13.6 ns a row as K1's tail.
//
//   ct_k1_time_block  (a) k1_front_kernel, per block whole tracks: LN + row
//                     quant of x into shared memory; per head (pair) the
//                     q|k|v columns through the int8 tensor cores, rounded
//                     to bf16 into shared memory in the time core's layout;
//                     the bf16 time core (attention_cores.cuh, time_task);
//                     the attention output a in f32, then its row codes and
//                     scale to device memory (388 bytes a row);
//                     (b) k1_tail_kernel, per 64-row tile: to_out + residual
//                     (r in f32 in shared memory), LN + quant, fc1 + GELU +
//                     quant, fc2 + residual.
//
// Contract (time_block_plain; JAX's body fixes the order): two-pass f32
// LayerNorm (or the bf16_ln variant), per-row codes rint(v * (1/scale)),
// q|kv rounded to bf16, the softmax normalized before its rounding to bf16,
// a quantized from f32, r = (x + to_out(a)) + bo in f32, the GELU codes'
// scale from the absmax of the whole 1,536-wide row (or the gelu_fold
// variant's pre-GELU max), the last residual (r + y) + b2, _rn intrinsics
// throughout. The s8 products are exact in any tiling, so only the
// attention stage's f32 summation order differs from the launch chain.
//
// What bounds it: int8 operations. At 10,240 tracks x 60 frames (614,400
// rows) the block is ~2.2 T int8 operations (~1.1 ms at 1,979 TOP/s)
// against ~0.15 ms of token bytes. The launch chain it replaces (nine
// launches, kept for f32 tokens) moved ~12-15 GB of intermediates through
// device memory (q|kv in bf16, a, r and the 1,536-wide u in f32) and ran a
// GEMM that waited for each K step's plain loads. Here:
//   * no f32 a, r or u leaves the chip: (a) -> (b) passes a's int8 codes
//     and scales (388 bytes a row, ~0.24 GB at the bench shape);
//   * the front's products stream their weights from L2 through RingGemm, a
//     3-4 stage cp.async ring of 64 bytes of K a stage (the next head
//     group's first stages issued before the current one's epilogue and
//     attention); the tail's through one stream (Stream): a producer warp
//     walks every weight stage of the tile's products ahead of the 16
//     consumer warps, slot by slot under mbarriers, so the stream does not
//     stop at the products' epilogues. Fragments by ldmatrix from rows
//     padded to a 16-byte bank shift, mma.sync m16n8k32 s8 x s8 -> s32;
//   * fc1 runs twice, which is exact: the GELU codes' scale needs the whole
//     row's absmax before the first code. Pass 1 takes each row's max of
//     the pre-GELU values and one GELU of it (exact where that GELU exceeds
//     kGeluNegBound, below); pass 2 quantizes each 128-wide fc1 tile and
//     feeds it straight to fc2, whose 64 x 384 s32 accumulator stays in
//     registers, so the 1,536-wide codes never exist in full.
//     Accumulating fc2 per fc1 tile in ONE pass is not exact under this
//     contract: the codes of the first tile need the scale of the whole
//     row. The other exact option, the fc1 row held on chip across a
//     4-block cluster (each block 64 x 384 f32, the row maxima exchanged
//     and the fc2 s32 partials summed through distributed shared memory),
//     is not built here. K12 (int8_mlp_cluster.cu) runs that split over an
//     8-block cluster with its weights resident; what it showed about this
//     tail: PERF.md section 7.
//   * mma.sync, not wgmma: a wgmma version of both kernels (m64nNk32, both
//     operands K-major in shared memory without swizzle, one wait a ring
//     stage) was built, matched the plain version, and was slower than the
//     mma.sync one on the same card, so it is not kept.
// What bounds the tail now (one NVIDIA H100 80GB HBM3 at 700 W): 8.11 ms
// at the bench shape; copies of it built with one part of its work taken
// out (probes, not kept) took 6.13 ms with no weight traffic, 5.41 without
// the products, 7.60 without pass 2's GELUs: the products, the weight
// stream and the epilogues cost 2-3 ms each, one block an SM. How far it got (chip_smoke, same card): 11.72 ms at 10,240 x 60
// (the chain 24.22, the bound 1.16) and 3.17 ms at 10,240 x 16 (5.77,
// 0.30); the 8 / 2 ms targets are missed.
// Tiles: a front block holds 64 // T whole tracks (T <= 64: 64 rows, one
// 64-key chunk, two heads a step, a in f32 in shared memory, 231,168 bytes)
// or one track of T <= 256 frames (rows padded to 64s, one head a step;
// a's row max is taken in a first pass over the heads and the codes in a
// second, the q|k|v products recomputed, since T x 384 f32 does not fit).
// The tail tile is 64 rows (228,704 bytes). Times: PERF.md.

#include "int8_tile.cuh"

namespace ct {

constexpr int K1_HEADS = KC / kDimHead;  // 8
constexpr int K1_AST = KC + 4;           // row stride (floats) of the f32 attention output
constexpr int K1_MAX_ROWS = 256;         // frames of one track the front takes
// The products, all 64 bytes of K a stage, with rings as deep as the
// shared memory left beside each kernel's activations allows (what bounds
// the weight stream is the bytes in flight from L2 per SM): the front's
// tile route 64 rows x (two heads' q|k|v = 288 columns), 3 stages; its
// track route 64-row chunks x one head's 144 columns, 4 stages; the tail's
// 64 rows x 384 (to_out, fc2), 3 stages, and 64 rows x one 128-wide fc1
// tile, 9 stages (the whole tile in flight).
using FrontTileGemm = RingGemm<2, 4, 2, 9, 64, 3>;
using FrontTrackGemm = RingGemm<4, 2, 1, 9, 64, 4>;
constexpr int K1_ULD = 128 + 16;  // row stride of one fc1 tile's codes
// row stride (floats) of the tail's f32 residual: the 8 rows of a warp's
// 8-byte stores fall in 4 bank windows, not 1
constexpr int K1_RST = KC + 8;
// |gelu_tanh(x)| < kGeluNegBound for every f32 x < 0: its largest value
// there is 0.17004079 (every negative f32 evaluated on an H100; the
// gelu_fold variant's 0.1700001 is not a bound for this evaluation)
constexpr float kGeluNegBound = 0.1701f;

// Shared-memory bytes of the two kernels (mlp_int8_cuda.k1_plan mirrors them).
inline size_t k1_front_smem(bool tile, int rows_pad) {
  const size_t rp = static_cast<size_t>(rows_pad);
  const int hp = tile ? 2 : 1;
  size_t b = rp * LDA_C + rp * 4 * (tile ? 1 : 3) + 3 * hp * rp * kDimHead * sizeof(bf16);
  b += tile ? FrontTileGemm::kRingBytes + rp * K1_AST * 4 : FrontTrackGemm::kRingBytes;
  return b;
}
// The tail's weight stream (see below): K1T_SLOTS equal slots, 16 consumer
// warps and one producer warp.
constexpr int K1T_CONSUMERS = 512, K1T_THREADS = K1T_CONSUMERS + 32;
constexpr int K1T_SLOT = 384 * (32 + 16), K1T_SLOTS = 5;
static_assert(128 * (128 + 16) == K1T_SLOT, "to_out / fc2 and fc1 stages fill equal slots");
constexpr int K1_TAIL_SMEM = 64 * K1_RST * 4 + 64 * LDA_C + 64 * K1_ULD + K1T_SLOTS * K1T_SLOT +
                             5 * 64 * 4 + 2 * K1T_SLOTS * 8 + 16;

// ------------------------------------------------------------ (a) front
// Block: `tracks` whole tracks of Tn frames (rows = tracks * Tn <= rows_pad;
// rows past them hold zero codes). kTile: rows_pad = 64, two heads a step,
// one 64-key chunk (NC = 1), a kept in f32 and quantized at the end; else
// one track, one head a step, rows_pad / 64 key chunks (NC = 2 in
// registers or 0: two passes), and two passes over the heads: a's row
// absmax, then its codes (the q|k|v products and the attention recomputed
// exactly).
template <bool kBf16Ln, int NC, bool kTile>
__global__ void __launch_bounds__(256, 1)
k1_front_kernel(const bf16* __restrict__ x, int M, int Tn, int tracks, int rows_pad,
                const int8_t* __restrict__ wqkv, const float* __restrict__ sqkv,
                const float* __restrict__ bqkv, float eps, float scale,
                int8_t* __restrict__ acode, float* __restrict__ ascale) {
  using G = typename std::conditional<kTile, FrontTileGemm, FrontTrackGemm>::type;
  constexpr int D = kDimHead, HP = kTile ? 2 : 1, GR = 64;
  static_assert(G::BN == 3 * D * HP, "q|k|v columns of HP heads");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);
  float* sr = reinterpret_cast<float*>(A + rows_pad * LDA_C);
  unsigned* amax = reinterpret_cast<unsigned*>(sr + rows_pad);  // track route only
  float* inv = sr + 2 * rows_pad;                               // track route only
  bf16* qkv = reinterpret_cast<bf16*>(sr + rows_pad * (kTile ? 1 : 3));
  const int hsz = rows_pad * D;
  int8_t* ring = reinterpret_cast<int8_t*>(qkv + 3 * HP * hsz);
  float* as = reinterpret_cast<float*>(ring + G::kRingBytes);  // tile route only

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * tracks, rows = min(tracks, M - m0) * Tn;
  const size_t row0 = static_cast<size_t>(m0) * Tn;
  const int nchunks = rows_pad / GR, passes = kTile ? 1 : 2;
  const int steps = passes * (K1_HEADS / HP) * nchunks;
  // step s: pass s / (heads * chunks), head group (s / chunks) % heads, row chunk s % chunks
  auto wrow_of = [&](int s) {
    const int hp = (s / nchunks) % (K1_HEADS / HP);
    return [=](int n) {
      const int which = n / (D * HP), within = n - which * D * HP;
      return wqkv + static_cast<size_t>(which * KC + hp * HP * D + within) * KC;
    };
  };
  G::prefetch(wrow_of(0), KC, ring);

  for (int r = warp; r < rows_pad; r += 8) {
    float sc = 0.f;
    if (r < rows)
      sc = ln_quant_row<bf16, KC / 32, kBf16Ln>(x + (row0 + r) * KC, lane, nullptr, nullptr, eps,
                                                1, A + r * LDA_C);
    else
      for (int i = lane; i < KC; i += 32) A[r * LDA_C + i] = 0;
    if (lane == 0) sr[r] = sc;
  }
  if (!kTile)
    for (int r = tid; r < rows_pad; r += 256) amax[r] = 0u;

  // one q|k|v value pair of column n (n even) of head group hp, row r
  auto store_qkv = [&](int hp, int r, int n, int a0, int a1) {
    const int which = n / (D * HP), within = n - which * D * HP;
    const int hh = within / D, d = within - hh * D;
    const int wr = which * KC + hp * HP * D + within;
    const float v0 = __fadd_rn(dequant(a0, sr[r], sqkv[wr]), bqkv[wr]);
    const float v1 = __fadd_rn(dequant(a1, sr[r], sqkv[wr + 1]), bqkv[wr + 1]);
    *reinterpret_cast<uint32_t*>(qkv + (which * HP + hh) * hsz + ilv(r, d >> 3) + (d & 7)) =
        pack_bf16(v0, v1);
  };

  const int qtiles = (rows + 15) / 16;
  for (int s = 0; s < steps; ++s) {
    const int pass = s / ((K1_HEADS / HP) * nchunks), hp = (s / nchunks) % (K1_HEADS / HP);
    const int rc = (s % nchunks) * GR;
    // q|k|v of this head group, rounded to bf16, into the time core's layout
    int acc[G::kMI][G::kNI][4];
    G::template run<true>(A + rc * LDA_C, LDA_C, KC, wrow_of(s), ring, acc);
    if (s + 1 < steps) G::prefetch(wrow_of(s + 1), KC, ring);
#pragma unroll
    for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::kNI; ++ni)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          store_qkv(hp, rc + G::row(mi, 2 * h2), G::col(ni, 2 * h2), acc[mi][ni][2 * h2],
                    acc[mi][ni][2 * h2 + 1]);
    if (rc + GR < rows_pad) continue;  // the head group's remaining row chunks first
    __syncthreads();
    for (int task = warp; task < qtiles * HP; task += 8) {
      const int hh = task % HP, r0 = (task / HP) * 16, h = hp * HP + hh;
      uint32_t qa[3][4];
      load_q_ilv(qa, qkv + hh * hsz, r0);
      int lo[2], hi[2];
      task_ranges(r0, Tn, lo, hi);
      float o[6][4];
      time_task<NC>(o, qa, qkv + (HP + hh) * hsz, qkv + (2 * HP + hh) * hsz,
                          rows_pad / kKeyTile, lo, hi, scale);
      const int ra = r0 + g, rb = ra + 8;
      if constexpr (kTile) {
#pragma unroll
        for (int mm = 0; mm < 6; ++mm) {
          const int c = h * D + 8 * mm + 2 * t;
          *reinterpret_cast<float2*>(as + ra * K1_AST + c) = make_float2(o[mm][0], o[mm][1]);
          *reinterpret_cast<float2*>(as + rb * K1_AST + c) = make_float2(o[mm][2], o[mm][3]);
        }
      } else if (pass == 0) {
        float m[2] = {0.f, 0.f};
#pragma unroll
        for (int mm = 0; mm < 6; ++mm) {
          m[0] = fmaxf(m[0], fmaxf(fabsf(o[mm][0]), fabsf(o[mm][1])));
          m[1] = fmaxf(m[1], fmaxf(fabsf(o[mm][2]), fabsf(o[mm][3])));
        }
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
        if (t == 0) {
          atomicMax(amax + ra, __float_as_uint(m[0]));
          atomicMax(amax + rb, __float_as_uint(m[1]));
        }
      } else {
#pragma unroll
        for (int mm = 0; mm < 6; ++mm) {
          const int c = h * D + 8 * mm + 2 * t;
          if (ra < rows)
            *reinterpret_cast<char2*>(acode + (row0 + ra) * KC + c) =
                make_char2(quant8(o[mm][0], inv[ra]), quant8(o[mm][1], inv[ra]));
          if (rb < rows)
            *reinterpret_cast<char2*>(acode + (row0 + rb) * KC + c) =
                make_char2(quant8(o[mm][2], inv[rb]), quant8(o[mm][3], inv[rb]));
        }
      }
    }
    __syncthreads();
    if (!kTile && pass == 0 && hp == K1_HEADS / HP - 1) {
      for (int r = tid; r < rows_pad; r += 256) {
        const float sc = __fmul_rn(fmaxf(__uint_as_float(amax[r]), 1e-20f), 1.0f / 127.0f);
        inv[r] = 1.0f / sc;
        if (r < rows) ascale[row0 + r] = sc;
      }
      __syncthreads();
    }
  }
  if constexpr (kTile) {
    for (int r = warp; r < rows; r += 8) {
      const float sc = ln_quant_row<float, KC / 32>(as + r * K1_AST, lane, nullptr, nullptr, 0.f,
                                                    0, acode + (row0 + r) * KC);
      if (lane == 0) ascale[row0 + r] = sc;
    }
  }
}

// ------------------------------------------------------------ K2's front
// K2 (ct_k2_space_block) is this front, then K1's tail (k1_tail_kernel,
// unchanged). The front takes 64-track tiles of one frame t: rows (n, t),
// 768-byte bf16 rows at a stride of T x 384 in x. A block walks a run of the
// flat (frame-major) list of tiles, one block an SM, and stages a frame's
// projected keys and values (V <= 64 tokens, 96 KB, K6's interleaved layout)
// whenever its run enters that frame. Per tile: the x rows arrive by bulk
// copies (the next tile's issued while this one computes), LN + row quant
// into shared memory, then per head pair the q columns through the int8
// tensor cores (K2QGemm, the weights streamed through a cp.async ring),
// dequant + bias rounded to bf16, and the points<-virtual core on mma.sync
// for the pair: warp w takes rows 16 (w % 4).. of head 2p + w / 4, the
// softmax normalized before its rounding to bf16 (K6's p2v_tc_kernel at one
// 64-key chunk). Each warp keeps its four (16 rows, head) outputs in f32
// registers, so after the last pair the rows' absmax over all 384 channels
// crosses the two warps of a row group through shared memory, and the codes
// and scales go to device memory: 388 bytes a row, the hand-off K1's front
// makes to the tail.
constexpr int K2_TILE = 64;   // tracks (rows) a tile
constexpr int K2_MAX_V = 64;  // virtual tokens the front stages: one key chunk
using K2QGemm = RingGemm<2, 4, 2, 3, 64, 4>;  // 64 rows x two heads' q columns (96)
constexpr int K2_KV = 2 * K1_HEADS * K2_MAX_V * kDimHead * 2;  // keys + values, bytes
constexpr int K2_QPAIR = 2 * K2_TILE * kDimHead * 2;           // q of a head pair, bytes
constexpr int K2_FRONT_SMEM = K2_KV + K2_TILE * KC * 2 + K2_TILE * LDA_C + K2_QPAIR +
                              K2QGemm::kRingBytes + 3 * K2_TILE * 4 + 16;
static_assert(K2_FRONT_SMEM <= 232448, "K2's front fits one block an SM");

#define CT_K2_FRONT_PARAMS                                                                      \
  const bf16 *__restrict__ x, const bf16 *__restrict__ kv, int N, int Tn, int V,                 \
      const int8_t *__restrict__ wq, const float *__restrict__ sq, const float *__restrict__ bq, \
      float eps, float scale, int8_t *__restrict__ acode, float *__restrict__ ascale
template <bool kBf16Ln>
__device__ __forceinline__ void k2_front_body(CT_K2_FRONT_PARAMS) {
  using G = K2QGemm;
  constexpr int D = kDimHead, HSZ = K2_TILE * D, PAIRS = K1_HEADS / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);            // [head][64 keys x 48] (ilv)
  bf16* vs = ks + K1_HEADS * K2_MAX_V * D;             // the same for the values
  bf16* xs = vs + K1_HEADS * K2_MAX_V * D;             // the tile's x rows (64 x 384)
  int8_t* A = reinterpret_cast<int8_t*>(xs + K2_TILE * KC);  // LN codes, then a's codes
  bf16* qs = reinterpret_cast<bf16*>(A + K2_TILE * LDA_C);   // [2][64 rows x 48] (ilv)
  int8_t* ring = reinterpret_cast<int8_t*>(qs + 2 * HSZ);
  float* sr = reinterpret_cast<float*>(ring + G::kRingBytes);
  unsigned* amax = reinterpret_cast<unsigned*>(sr + K2_TILE);
  float* inv = sr + 2 * K2_TILE;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(inv + K2_TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int tpf = (N + K2_TILE - 1) / K2_TILE;  // tiles a frame
  const long long total = static_cast<long long>(tpf) * Tn;
  const long long begin = total * blockIdx.x / gridDim.x, end = total * (blockIdx.x + 1) / gridDim.x;
  const int C2 = 2 * KC;
  auto wrow_of = [&](int p) {  // q column n of head pair p is weight row 96p + n
    return [=](int n) { return wq + static_cast<size_t>(p * 2 * D + n) * KC; };
  };
  // the x rows of tile i by bulk copies (warp 0), completing xbar's phase
  auto load_x = [&](long long i) {
    const int t = static_cast<int>(i / tpf), n0 = static_cast<int>(i % tpf) * K2_TILE;
    const int rows = min(K2_TILE, N - n0);
    if (lane == 0) mbar_expect_tx(xbar, rows * KC * 2);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      bulk_g2s(xs + r * KC, x + (static_cast<size_t>(n0 + r) * Tn + t) * KC, KC * 2, xbar);
  };
  if (tid == 0) {
    mbar_init(xbar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0) load_x(begin);
  G::prefetch(wrow_of(0), KC, ring);

  int frame = -1;
  unsigned phase = 0;
  for (long long i = begin; i < end; ++i) {
    const int t = static_cast<int>(i / tpf), n0 = static_cast<int>(i % tpf) * K2_TILE;
    const int rows = min(K2_TILE, N - n0);
    if (t != frame) {  // the frame's keys and values, zero past V
      const bf16* kvt = kv + static_cast<size_t>(t) * V * C2;
      for (int c = tid; c < K1_HEADS * K2_MAX_V * 6; c += 256) {
        const int ch = c % 6, key = (c / 6) % K2_MAX_V, h = c / (6 * K2_MAX_V);
        const bool ok = key < V;
        const bf16* src = kvt + static_cast<size_t>(ok ? key : 0) * C2 + h * D + 8 * ch;
        cp_async16(ks + h * K2_MAX_V * D + ilv(key, ch), src, ok);
        cp_async16(vs + h * K2_MAX_V * D + ilv(key, ch), src + KC, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();  // also lands the ring's prefetched stages: run() counts none
      __syncthreads();
      frame = t;
    }
    mbar_wait(xbar, phase);
    phase ^= 1u;
    for (int r = warp; r < K2_TILE; r += 8) {
      float sc = 0.f;
      if (r < rows)
        sc = ln_quant_row<bf16, KC / 32, kBf16Ln>(xs + r * KC, lane, nullptr, nullptr, eps, 1,
                                                  A + r * LDA_C);
      else
        for (int c = lane; c < KC; c += 32) A[r * LDA_C + c] = 0;
      if (lane == 0) sr[r] = sc;
    }
    if (tid < K2_TILE) amax[tid] = 0u;
    __syncthreads();
    if (warp == 0 && i + 1 < end) {
      fence_async_smem();
      load_x(i + 1);
    }

    // per head pair: q rounded to bf16 into qs, then the pair's attention
    float o[PAIRS][6][4];
    const int rg = warp & 3, hh = warp >> 2;
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      int acc[G::kMI][G::kNI][4];
      G::template run<true>(A, LDA_C, KC, wrow_of(p), ring, acc);
      if (p + 1 < PAIRS || i + 1 < end) G::prefetch(wrow_of((p + 1) % PAIRS), KC, ring);
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::kNI; ++ni)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = G::row(mi, 2 * h2), n = G::col(ni, 2 * h2);
            const int wr = p * 2 * D + n, d = n % D;
            const float v0 = __fadd_rn(dequant(acc[mi][ni][2 * h2], sr[r], sq[wr]), bq[wr]);
            const float v1 = __fadd_rn(dequant(acc[mi][ni][2 * h2 + 1], sr[r], sq[wr + 1]), bq[wr + 1]);
            *reinterpret_cast<uint32_t*>(qs + (n / D) * HSZ + ilv(r, d >> 3) + (d & 7)) =
                pack_bf16(v0, v1);
          }
      __syncthreads();
      const int h = 2 * p + hh;
      uint32_t qa[3][4];
      load_q_ilv(qa, qs + hh * HSZ, rg * 16);
      float S[8][4];
      chunk_scores_ilv(S, qa, ks + h * K2_MAX_V * D);
      if (V == K2_MAX_V) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) S[j][e] = __fmul_rn(S[j][e], scale);
      } else {
        scale_mask(S, scale, V);
      }
      softmax_chunk(S);
#pragma unroll
      for (int mm = 0; mm < 6; ++mm) o[p][mm][0] = o[p][mm][1] = o[p][mm][2] = o[p][mm][3] = 0.f;
      chunk_pv_ilv(o[p], S, vs + h * K2_MAX_V * D);
    }

    // a's row absmax over the 384 channels, then its codes and scales
    const int ra = rg * 16 + g, rb = ra + 8;
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
#pragma unroll
      for (int mm = 0; mm < 6; ++mm) {
        m[0] = fmaxf(m[0], fmaxf(fabsf(o[p][mm][0]), fabsf(o[p][mm][1])));
        m[1] = fmaxf(m[1], fmaxf(fabsf(o[p][mm][2]), fabsf(o[p][mm][3])));
      }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    if (t4 == 0) {
      atomicMax(amax + ra, __float_as_uint(m[0]));
      atomicMax(amax + rb, __float_as_uint(m[1]));
    }
    __syncthreads();
    if (tid < K2_TILE) {
      const float sc = __fmul_rn(fmaxf(__uint_as_float(amax[tid]), 1e-20f), 1.0f / 127.0f);
      inv[tid] = 1.0f / sc;
      if (tid < rows) ascale[static_cast<size_t>(n0 + tid) * Tn + t] = sc;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
#pragma unroll
      for (int mm = 0; mm < 6; ++mm) {
        const int c = (2 * p + hh) * D + 8 * mm + 2 * t4;
        *reinterpret_cast<char2*>(A + ra * LDA_C + c) =
            make_char2(quant8(o[p][mm][0], inv[ra]), quant8(o[p][mm][1], inv[ra]));
        *reinterpret_cast<char2*>(A + rb * LDA_C + c) =
            make_char2(quant8(o[p][mm][2], inv[rb]), quant8(o[p][mm][3], inv[rb]));
      }
    __syncthreads();
    for (int c = tid; c < rows * (KC / 16); c += 256) {
      const int r = c / (KC / 16), ch = c % (KC / 16);
      *reinterpret_cast<uint4*>(acode + (static_cast<size_t>(n0 + r) * Tn + t) * KC + 16 * ch) =
          *reinterpret_cast<const uint4*>(A + r * LDA_C + 16 * ch);
    }
    __syncthreads();  // A and the scales are the next tile's
  }
  cp_async_wait<0>();
}

// K2's front and K11's (the same body: K11 is K2's function), two kernel
// names for the profiler's records.
template <bool kBf16Ln>
__global__ void __launch_bounds__(256, 1) k2_front_kernel(CT_K2_FRONT_PARAMS) {
  k2_front_body<kBf16Ln>(x, kv, N, Tn, V, wq, sq, bq, eps, scale, acode, ascale);
}
template <bool kBf16Ln>
__global__ void __launch_bounds__(256, 1) k11_front_kernel(CT_K2_FRONT_PARAMS) {
  k2_front_body<kBf16Ln>(x, kv, N, Tn, V, wq, sq, bq, eps, scale, acode, ascale);
}
#undef CT_K2_FRONT_PARAMS

// ------------------------------------------------------------- (b) tail
// The weight stream. One producer warp walks the tail's whole sequence of
// weight stages (to_out; fc1 pass 1; pass 1b where a row needs it; then per
// fc1 tile its fc1 stages and its fc2 stages) through a ring of K1T_SLOTS
// equal slots, cp.async 16 bytes a lane, and each lane's
// cp.async.mbarrier.arrive marks the slot `full` when its copies land; the
// 16 consumer warps wait on `full`, take the slot's products and arrive on
// its `empty`. So the weights stream on across the products and their
// epilogues, not product by product. Every stage fills one slot: to_out
// and fc2 stream 384 columns x 32 bytes of K (rows padded to 48 bytes), fc1
// 128 columns x 128 bytes (rows padded to 144): ldmatrix's 8 rows always
// hit 8 different 16-byte bank groups.

// a barrier of the 16 consumer warps alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(K1T_CONSUMERS) : "memory");
}

// Each side's position in a ring of SLOTS slots: slot and the parity of its
// current use. K1's tail (and K9, K2) stream through K1T_SLOTS slots, K8
// through K8_SLOTS; every slot holds K1T_SLOT bytes.
template <int SLOTS>
struct Stream {
  int8_t* ring;
  uint64_t* full;   // SLOTS, count 32 (the producer's lanes)
  uint64_t* empty;  // SLOTS, count: the consumer warps
  int slot;
  unsigned parity;
  __device__ void advance() {
    if (++slot == SLOTS) {
      slot = 0;
      parity ^= 1u;
    }
  }
  // producer: rows n < BN of w (row stride ldw bytes), bytes k0 .. k0 + BK
  template <int BN, int BK>
  __device__ void produce(const int8_t* w, size_t ldw, int k0) {
    constexpr int CH = BK / 16, LDB = BK + 16;
    static_assert(BN * LDB == K1T_SLOT, "one stage fills one slot");
    mbar_wait(empty + slot, parity ^ 1u);  // the first use of a slot passes
    int8_t* dst = ring + slot * K1T_SLOT;
    for (int i = threadIdx.x & 31; i < BN * CH; i += 32) {
      const int n = i / CH, c = i - n * CH;
      cp_async16(dst + n * LDB + 16 * c, w + n * ldw + k0 + 16 * c, true);
    }
    cp_async_mbar_arrive(full + slot);
    advance();
  }
  // consumer: acc (+)= A[rows, 0:K) . the next K / BK stages^T, the
  // consumer warps as rows x NW, warp tiles (16 * MI) x (8 * NI)
  template <int MI, int NI, int BK, int NW = 8>
  __device__ void gemm(const int8_t* A, int lda, int K, bool zero, int (&acc)[MI][NI][4]) {
    constexpr int LDB = BK + 16;
    static_assert(NI % 2 == 0, "column tiles in pairs");  // warp_mma's b_last unused
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp / NW, wn = warp % NW;
    if (zero) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
    }
    const int8_t* a_base = A + (wm * 16 * MI + (lane & 15)) * lda + (lane >> 4) * 16;
    const int b_off = (wn * 8 * NI + (lane >> 4) * 8 + (lane & 7)) * LDB + ((lane >> 3) & 1) * 16;
    for (int kt = 0; kt < K / BK; ++kt) {
      mbar_wait(full + slot, parity);
      warp_mma<MI, NI, BK, LDB>(acc, a_base + kt * BK, lda, ring + slot * K1T_SLOT, b_off, 0);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      advance();
    }
  }
};

// Position of accumulator (mi, ni, k) of Stream::gemm in its 64-row tile.
template <int MI, int NI>
struct StreamTile {
  __device__ static int row(int mi, int k) {
    return ((threadIdx.x >> 5) / 8) * 16 * MI + mi * 16 + ((threadIdx.x & 31) >> 2) + (k >> 1) * 8;
  }
  __device__ static int col(int ni, int k) {
    return ((threadIdx.x >> 5) % 8) * 8 * NI + ni * 8 + (threadIdx.x & 3) * 2 + (k & 1);
  }
};

// Block: 64 rows of the (M * T) rows. The prologue fills A with a's codes
// and sa with their row scales: K1 (kK9 false) reads the front's codes and
// scales by cp.async; K9 (kK9 true) reads a in bf16 and quantizes each row
// in the tile (rint(v * (1/scale)), scale = max(absmax, 1e-20) / 127, as
// _quant_rows). Then
//   r = (x + a . wo^T * (sa * so)) + bo           (f32, shared memory)
//   h = codes of LN(r)                             (shared memory)
//   pass 1: the rows' max of fc1(h) (one GELU a row; pass 1b: |gelu| max)
//   pass 2: per 128-wide fc1 tile, its GELU codes -> fc2 accumulated in s32
//   out = (r + fc2 * (su * s2)) + b2              (K1's _time_block_kernel)
//   out = r + (fc2 * (su * s2) + b2)              (K9's _out_mlp_kernel)
// Warps 0-15 consume (warp tiles 32 x 48 of the 384-wide products, 32 x 16
// of an fc1 tile); warp 16 produces the weight stream.
template <bool kBf16Ln, bool kGeluFold, bool kK9>
__device__ __forceinline__ void
tail_body(const int8_t* __restrict__ acode, const float* __restrict__ ascale,
          const bf16* __restrict__ a, const bf16* __restrict__ x, int nrows,
          const int8_t* __restrict__ wo, const float* __restrict__ so,
          const float* __restrict__ bo, const int8_t* __restrict__ w1,
          const float* __restrict__ s1, const float* __restrict__ b1,
          const int8_t* __restrict__ w2, const float* __restrict__ s2,
          const float* __restrict__ b2, float eps, bf16* __restrict__ out) {
  using WT = StreamTile<2, 6>;  // 64 x 384: to_out, fc2
  using FTl = StreamTile<2, 2>;  // 64 x 128: an fc1 tile
  constexpr int BM = 64, FT = KH / 128, NT = K1T_CONSUMERS, NWARP = NT / 32;  // FT fc1 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  float* R = reinterpret_cast<float*>(smem);  // row stride K1_RST
  int8_t* A = reinterpret_cast<int8_t*>(R + BM * K1_RST);
  int8_t* U = A + BM * LDA_C;
  int8_t* ring = U + BM * K1_ULD;
  float* sa = reinterpret_cast<float*>(ring + K1T_SLOTS * K1T_SLOT);
  float* sh = sa + BM;
  float* su = sh + BM;
  float* iu = su + BM;
  unsigned* amax = reinterpret_cast<unsigned*>(iu + BM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(amax + BM);
  int* full_rows = reinterpret_cast<int*>(bars + 2 * K1T_SLOTS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int m0 = blockIdx.x * BM, n = min(BM, nrows - m0);
  if (tid == 0) {
    for (int i = 0; i < K1T_SLOTS; ++i) {
      mbar_init(bars + i, 32);
      mbar_init(bars + K1T_SLOTS + i, K1T_CONSUMERS / 32);
    }
    *full_rows = 0;
  }
  __syncthreads();
  Stream<K1T_SLOTS> st{ring, bars, bars + K1T_SLOTS, 0, 0u};

  if (warp == NWARP) {  // the producer
    for (int kt = 0; kt < KC / 32; ++kt) st.produce<384, 32>(wo, KC, 32 * kt);
    auto fc1_stages = [&](int j) {
      for (int kt = 0; kt < KC / 128; ++kt)
        st.produce<128, 128>(w1 + static_cast<size_t>(128 * j) * KC, KC, 128 * kt);
    };
    for (int j = 0; j < FT; ++j) fc1_stages(j);
    __syncthreads();  // the consumers' pass-1b decision
    if (*full_rows)
      for (int j = 0; j < FT; ++j) fc1_stages(j);
    for (int j = 0; j < FT; ++j) {
      fc1_stages(j);
      for (int kt = 0; kt < 128 / 32; ++kt) st.produce<384, 32>(w2 + 128 * j, KH, 32 * kt);
    }
    return;
  }

  if constexpr (kK9) {
    for (int r = warp; r < BM; r += NWARP) {
      float sc = 0.f;
      if (r < n)
        sc = ln_quant_row<bf16, KC / 32>(a + static_cast<size_t>(m0 + r) * KC, lane, nullptr,
                                         nullptr, 0.f, 0, A + r * LDA_C);
      else
        for (int i = lane; i < KC; i += 32) A[r * LDA_C + i] = 0;
      if (lane == 0) sa[r] = sc;
    }
    if (tid < BM) amax[tid] = 0u;
  } else {
    for (int i = tid; i < BM * (KC / 16); i += NT) {
      const int r = i / (KC / 16), c = i - r * (KC / 16);
      const bool ok = r < n;
      cp_async16(A + r * LDA_C + 16 * c,
                 acode + static_cast<size_t>(m0 + (ok ? r : 0)) * KC + 16 * c, ok);
    }
    cp_async_commit();
    if (tid < BM) {
      sa[tid] = tid < n ? ascale[m0 + tid] : 0.f;
      amax[tid] = 0u;
    }
    cp_async_wait<0>();
  }
  consumer_sync();

  // to_out + residual
  {
    int acc[2][6][4];
    st.gemm<2, 6, 32>(A, LDA_C, KC, true, acc);
    // pairs of neighbouring columns: one 4-byte load of x, one 8-byte store of r
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = WT::row(mi, 2 * h);
        const float sr = sa[r];
#pragma unroll
        for (int ni = 0; ni < 6; ++ni) {
          const int c = WT::col(ni, 0);
          float2 xv = make_float2(0.f, 0.f);
          if (r < n)
            xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                x + static_cast<size_t>(m0 + r) * KC + c));
          *reinterpret_cast<float2*>(R + r * K1_RST + c) = make_float2(
              __fadd_rn(__fadd_rn(xv.x, dequant(acc[mi][ni][2 * h], sr, so[c])), bo[c]),
              __fadd_rn(__fadd_rn(xv.y, dequant(acc[mi][ni][2 * h + 1], sr, so[c + 1])), bo[c + 1]));
        }
      }
  }
  consumer_sync();
  for (int r = warp; r < BM; r += NWARP) {
    const float sc = ln_quant_row<float, KC / 32, kBf16Ln>(R + r * K1_RST, lane, nullptr, nullptr,
                                                           eps, 1, A + r * LDA_C);
    if (lane == 0) sh[r] = sc;
  }
  consumer_sync();

  // fc1, pass 1: each row's max of the pre-GELU values (and 0). For
  // gelu_fold that is the scale's input. Otherwise the scale needs the max
  // of |gelu|: gelu_tanh as evaluated here is non-decreasing on x >= 0 and
  // below kGeluNegBound in magnitude on x < 0 (both checked over every f32
  // on the card: gelu_scale_check_kernel), so where gelu(max) exceeds that
  // bound it IS the max of
  // |gelu|, one GELU a row instead of one an element; rows where it does
  // not (every pre-GELU value below ~0.3) take pass 1b, the full max.
  auto row_max = [&](int j, const int (&acc)[2][2][4], bool abs_gelu, bool only_marked) {
    float s1c[2][2], b1c[2][2];  // this thread's four columns of tile j
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s1c[ni][e] = s1[128 * j + FTl::col(ni, e)];
        b1c[ni][e] = b1[128 * j + FTl::col(ni, e)];
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = FTl::row(mi, 2 * half);
        const float shr = sh[r];
        float m = 0.f;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pre =
                __fadd_rn(dequant(acc[mi][ni][2 * half + e], shr, s1c[ni][e]), b1c[ni][e]);
            m = fmaxf(m, abs_gelu ? fabsf(gelu_tanh(pre)) : pre);
          }
        // m >= 0 (+0 after the add): ordered as unsigned bits
        m = __fadd_rn(quad_max(m), 0.f);
        if (t == 0 && (!only_marked || su[r] < 0.f)) atomicMax(amax + r, __float_as_uint(m));
      }
  };
  for (int j = 0; j < FT; ++j) {
    int acc[2][2][4];
    st.gemm<2, 2, 128>(A, LDA_C, KC, true, acc);
    row_max(j, acc, false, false);
  }
  consumer_sync();
  if (tid < BM) {
    const float m = __uint_as_float(amax[tid]);
    if (kGeluFold) {
      su[tid] = gelu_fold_scale(m);
    } else {
      const float gm = gelu_tanh(m);
      su[tid] = __fmul_rn(fmaxf(gm, 1e-20f), 1.0f / 127.0f);
      if (!(gm > kGeluNegBound)) {
        amax[tid] = 0u;
        su[tid] = -1.f;  // pass 1b
        *full_rows = 1;
      }
    }
  }
  __syncthreads();  // with the producer: it streams pass 1b's stages or not
  if (*full_rows) {  // pass 1b: max |gelu| of the rows marked
    for (int j = 0; j < FT; ++j) {
      int acc[2][2][4];
      st.gemm<2, 2, 128>(A, LDA_C, KC, true, acc);
      row_max(j, acc, true, true);
    }
    consumer_sync();
    if (tid < BM && su[tid] < 0.f)
      su[tid] = __fmul_rn(fmaxf(__uint_as_float(amax[tid]), 1e-20f), 1.0f / 127.0f);
    consumer_sync();
  }
  if (tid < BM) iu[tid] = 1.0f / su[tid];
  consumer_sync();

  // fc1, pass 2: each tile's GELU codes, straight into fc2
  // this thread's rows' scales, read once (the byte stores to U may alias them)
  float shr[2][2], iur[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      shr[mi][h] = sh[FTl::row(mi, 2 * h)];
      iur[mi][h] = iu[FTl::row(mi, 2 * h)];
    }
  int acc2[2][6][4];
  for (int j = 0; j < FT; ++j) {
    {
      int acc[2][2][4];
      st.gemm<2, 2, 128>(A, LDA_C, KC, true, acc);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int cl = FTl::col(ni, 0), c = 128 * j + cl;
        const float s1a = s1[c], s1b = s1[c + 1], b1a = b1[c], b1b = b1[c + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = __fadd_rn(dequant(acc[mi][ni][2 * h], shr[mi][h], s1a), b1a);
            const float p1 = __fadd_rn(dequant(acc[mi][ni][2 * h + 1], shr[mi][h], s1b), b1b);
            *reinterpret_cast<char2*>(U + FTl::row(mi, 2 * h) * K1_ULD + cl) =
                make_char2(quant8(gelu_tanh(p0), iur[mi][h]), quant8(gelu_tanh(p1), iur[mi][h]));
          }
      }
    }
    consumer_sync();
    st.gemm<2, 6, 32>(U, K1_ULD, 128, j == 0, acc2);
    consumer_sync();  // U read by every warp before the next tile's codes
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = WT::row(mi, 2 * h);
      if (r >= n) continue;
      const float sr = su[r];
#pragma unroll
      for (int ni = 0; ni < 6; ++ni) {
        const int c = WT::col(ni, 0);
        const float2 rr = *reinterpret_cast<const float2*>(R + r * K1_RST + c);
        const float y0 = dequant(acc2[mi][ni][2 * h], sr, s2[c]);
        const float y1 = dequant(acc2[mi][ni][2 * h + 1], sr, s2[c + 1]);
        const float o0 = kK9 ? __fadd_rn(rr.x, __fadd_rn(y0, b2[c]))
                             : __fadd_rn(__fadd_rn(rr.x, y0), b2[c]);
        const float o1 = kK9 ? __fadd_rn(rr.y, __fadd_rn(y1, b2[c + 1]))
                             : __fadd_rn(__fadd_rn(rr.y, y1), b2[c + 1]);
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m0 + r) * KC + c) = pack_bf16(o0, o1);
      }
    }
}

#define CT_TAIL_PARAMS                                                                         \
  const int8_t *__restrict__ acode, const float *__restrict__ ascale, const bf16 *__restrict__ a, \
      const bf16 *__restrict__ x, int nrows, const int8_t *__restrict__ wo,                      \
      const float *__restrict__ so, const float *__restrict__ bo, const int8_t *__restrict__ w1,  \
      const float *__restrict__ s1, const float *__restrict__ b1, const int8_t *__restrict__ w2, \
      const float *__restrict__ s2, const float *__restrict__ b2, float eps, bf16 *__restrict__ out
// K1's tail and K9: the same body, two names for the profiler's records.
template <bool kBf16Ln, bool kGeluFold>
__global__ void __launch_bounds__(K1T_THREADS, 1) k1_tail_kernel(CT_TAIL_PARAMS) {
  tail_body<kBf16Ln, kGeluFold, false>(acode, ascale, a, x, nrows, wo, so, bo, w1, s1, b1, w2, s2,
                                       b2, eps, out);
}
template <bool kBf16Ln, bool kGeluFold>
__global__ void __launch_bounds__(K1T_THREADS, 1) k9_tail_kernel(CT_TAIL_PARAMS) {
  tail_body<kBf16Ln, kGeluFold, true>(acode, ascale, a, x, nrows, wo, so, bo, w1, s1, b1, w2, s2,
                                      b2, eps, out);
}
#undef CT_TAIL_PARAMS

// ------------------------------------------------------------- K8, K10
// K8 and K10 in bfloat16 (ct_k8_stream, ct_k10_stream): one body for the
// LN + W8A8 dense products of
//   K8  (_qkv_kernel)    h = LN(x); [q | kv] = hq . w^T * (sr * sw) + bias,
//                        w = [to_q; to_kv] (1152, 384);
//   K10 (_dense_kernel)  [x +] (LN(x) [* gamma + beta]) . w^T * (sr * sw) + b,
//                        w (N, 384), N a multiple of 128 (N = 384 with x);
// hq, sr the rows' int8 codes and scales. Persistent blocks, one an SM, each
// walking a contiguous run of 128-row tiles (k8_plan / k10_plan), with
// three kinds of warp:
//   * 8 LayerNorm warps quantize the NEXT tile's rows (the first bodies'
//     device code, ln_quant_row, with its do_ln and affine, on rows in
//     shared memory: each warp keeps three rows in flight by cp.async, 16
//     bytes a lane, and the tile after is prefetched into L2 by one bulk
//     prefetch) into the other of two code buffers, while
//   * 16 product warps (4 x 4, warp tiles 32 x 32) run this tile's N / 128
//     column tiles, and
//   * one producer warp streams every weight stage of every tile of the run
//     (N / 128 column tiles x 3 stages of 128 bytes of K) through K8_SLOTS
//     slots (the tail's Stream), so the weights flow on across column
//     tiles, epilogues and row tiles.
// The code buffers pass between the two groups on mbarriers (full: every
// LayerNorm lane has written; empty: every product warp has read). The
// epilogue is the first bodies', dequant, then __fadd_rn of the bias, then
// (K10's residual) __fadd_rn of x, rounded to bf16 (the s8 products are
// exact: bit-identical to them); a quad of lanes trades its fragments (three
// shuffles) so that each lane stores 16 bytes, 8 whole bf16 columns, and
// each quad 64 contiguous bytes of a row, as streaming (evict-first)
// stores. The residual's x is read as the same 16 bytes a lane and traded
// back into fragment order the same way (the quad transpose is its own
// inverse); the rows were just read by the LayerNorm warps, so they come
// from L2. Where a column tile's output goes is a DenseOut: K8 sends tiles
// 0-2 to q and 3-8 to kv, K10 all to out.
// What bounds it (one NVIDIA H100 80GB HBM3 at 700 W; scripts/torch_k8_parts.py
// builds copies with one part taken out): K8 1.18 ms at 2,048 tracks x 250
// frames (the PR 4 body 3.58, the byte bound 0.47), 0.78 with no products,
// 1.05 with no LayerNorm, 1.10 with no stores. The products are what is
// left: 453 G s8 operations on mma.sync m16n8k32 from ldmatrix fragments,
// ~390 T a second over the whole call; plain stores instead of streaming
// ones cost 0.26 ms more.
constexpr int K8_BM = 128, K8_SLOTS = 4, K8_XBUF = 3;  // K8_XBUF: x rows in flight a LN warp
constexpr int K8_MMA = 512, K8_LN = 256, K8_THREADS = K8_MMA + K8_LN + 32;
constexpr int K8_STAGED_N = 3 * KC;  // up to this N the weight scales and biases sit in shared memory
constexpr int K8_SMEM = 2 * K8_BM * LDA_C + K8_SLOTS * K1T_SLOT + (K8_LN / 32) * K8_XBUF * KC * 2 +
                        2 * K8_BM * 4 + 2 * K8_STAGED_N * 4 + 2 * KC * 4 + (2 * K8_SLOTS + 4) * 8;
static_assert(K8_SMEM <= 232448, "K8 fits one block an SM");

// v[i] of a 4-element register array at a lane-varying index (no local memory)
__device__ __forceinline__ uint32_t sel4(const uint32_t (&v)[4], int i) {
  return (i & 2) ? ((i & 1) ? v[3] : v[2]) : ((i & 1) ? v[1] : v[0]);
}

// The lanes of a quad each hold P[j] = columns 8j + 2t, 8j + 2t + 1 (t the
// lane's place in the quad) of one row, packed bf16 pairs; returns this
// lane's columns 8t .. 8t + 7.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&P)[4]) {
  const int t = threadIdx.x & 3;
  uint32_t R[4];  // R[r]: columns 8t + 2(t ^ r), +1, from lane t ^ r
  R[0] = sel4(P, t);
#pragma unroll
  for (int r = 1; r < 4; ++r) R[r] = __shfl_xor_sync(0xffffffffu, sel4(P, t ^ r), r);
  return make_uint4(sel4(R, t), sel4(R, t ^ 1), sel4(R, t ^ 2), sel4(R, t ^ 3));
}

// `bytes` (a multiple of 16) of device memory at src into L2, asynchronously
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// Where column tile j of the streamed body goes: out0 (row stride ld0) at
// column 128 j while j < split, else out1 (row stride ld1) at 128 (j - split).
struct DenseOut {
  bf16* out0;
  bf16* out1;
  int split, ld0, ld1;
};

// kK8: K8's epilogue, its flags fixed at compile time (N = 1,152 as q | kv,
// the LayerNorm, no affine, no residual); else K10's, from the arguments.
template <bool kBf16Ln, bool kK8>
__global__ void __launch_bounds__(K8_THREADS, 1)
ln_dense_stream_kernel(const bf16* __restrict__ x, int rows, int N, const int8_t* __restrict__ w,
                       const float* __restrict__ sw, const float* __restrict__ bias,
                       const float* __restrict__ gamma, const float* __restrict__ beta, float eps,
                       int do_ln, int residual, DenseOut o) {
  constexpr int NW = 4, VPL = KC / 32;
  if constexpr (kK8) {
    N = 3 * KC;
    gamma = beta = nullptr;
    do_ln = 1;
    residual = 0;
    o.split = KC / 128;
    o.ld0 = KC;
    o.ld1 = 2 * KC;
  }
  constexpr int MMA_WARPS = K8_MMA / 32, LN_WARPS = K8_LN / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem);  // two code buffers
  int8_t* ring = A + 2 * K8_BM * LDA_C;
  bf16* xs = reinterpret_cast<bf16*>(ring + K8_SLOTS * K1T_SLOT);  // the LN warps' x rows
  float* sr = reinterpret_cast<float*>(xs + (K8_LN / 32) * K8_XBUF * KC);  // two row-scale buffers
  float* sws = sr + 2 * K8_BM;                                      // sw, then bias
  float* gb = sws + 2 * K8_STAGED_N;                                // gamma, then beta
  uint64_t* bars = reinterpret_cast<uint64_t*>(gb + 2 * KC);
  uint64_t* afull = bars + 2 * K8_SLOTS;  // [2]: a buffer's codes written
  uint64_t* aempty = afull + 2;           // [2]: a buffer's codes read
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (rows + K8_BM - 1) / K8_BM, CT = N / 128;
  const int begin = static_cast<int>(1ll * tiles * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(1ll * tiles * (blockIdx.x + 1) / gridDim.x);
  if (N <= K8_STAGED_N)
    for (int c = tid; c < N; c += K8_THREADS) {
      sws[c] = sw[c];
      sws[K8_STAGED_N + c] = bias[c];
    }
  if (gamma != nullptr)
    for (int c = tid; c < KC; c += K8_THREADS) {
      gb[c] = gamma[c];
      gb[KC + c] = beta[c];
    }
  if (tid == 0) {
    for (int i = 0; i < K8_SLOTS; ++i) {
      mbar_init(bars + i, 32);
      mbar_init(bars + K8_SLOTS + i, MMA_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(afull + b, K8_LN);
      mbar_init(aempty + b, MMA_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == MMA_WARPS + LN_WARPS) {  // the producer
    Stream<K8_SLOTS> st{ring, bars, bars + K8_SLOTS, 0, 0u};
    for (int i = begin; i < end; ++i)
      for (int j = 0; j < CT; ++j)
        for (int kt = 0; kt < KC / 128; ++kt)
          st.produce<128, 128>(w + static_cast<size_t>(128 * j) * KC, KC, 128 * kt);
    return;
  }

  if (warp >= MMA_WARPS) {  // the LayerNorm warps: tile k into buffer k % 2
    const int lw = warp - MMA_WARPS;
    const float* gs = gamma != nullptr ? gb : nullptr;
    const float* bs = gamma != nullptr ? gb + KC : nullptr;
    bf16* xw = xs + lw * K8_XBUF * KC;  // this warp's rows in flight
    // row r of the tile into slot (r / LN_WARPS) % K8_XBUF, 16 bytes a lane;
    // one cp.async group a row, empty past the tile's rows
    auto fetch = [&](int r0, int n, int r) {
      if (r < n) {
        const bf16* src = x + static_cast<size_t>(r0 + r) * KC;
        bf16* dst = xw + ((r / LN_WARPS) % K8_XBUF) * KC;
        for (int c = lane; c < KC / 8; c += 32) cp_async16(dst + 8 * c, src + 8 * c, true);
      }
      cp_async_commit();
    };
    for (int i = begin; i < end; ++i) {
      const int k = i - begin, b = k & 1, r0 = i * K8_BM, n = min(K8_BM, rows - r0);
      if (lw == 0 && lane == 0 && i + 1 < end) {
        const int r1 = r0 + K8_BM;
        bulk_prefetch_l2(x + static_cast<size_t>(r1) * KC, min(K8_BM, rows - r1) * KC * 2);
      }
      int8_t* Ab = A + b * K8_BM * LDA_C;
      float* srb = sr + b * K8_BM;
#pragma unroll
      for (int p = 0; p < K8_XBUF - 1; ++p) fetch(r0, n, lw + p * LN_WARPS);
      mbar_wait(aempty + b, ((k >> 1) & 1) ^ 1u);  // the first use of a buffer passes
      for (int r = lw; r < K8_BM; r += LN_WARPS) {
        fetch(r0, n, r + (K8_XBUF - 1) * LN_WARPS);
        cp_async_wait<K8_XBUF - 1>();
        __syncwarp();
        float sc = 0.f;
        if (r < n)
          sc = ln_quant_row<bf16, VPL, kBf16Ln>(xw + ((r / LN_WARPS) % K8_XBUF) * KC, lane, gs, bs,
                                                eps, do_ln, Ab + r * LDA_C);
        else
          for (int c = lane; c < KC; c += 32) Ab[r * LDA_C + c] = 0;
        if (lane == 0) srb[r] = sc;
        __syncwarp();  // every lane has read the row's slot before it is filled again
      }
      cp_async_wait<0>();
      mbar_arrive(afull + b);
    }
    return;
  }

  // the product warps; the scales and biases from shared memory up to
  // K8_STAGED_N columns (K8, K10 at N <= 1,152), else from device memory
  Stream<K8_SLOTS> st{ring, bars, bars + K8_SLOTS, 0, 0u};
  auto products = [&](const float* scol, const float* bcol) {
    const int wm = warp / NW, wn = warp % NW, g = lane >> 2, t = lane & 3;
    for (int i = begin; i < end; ++i) {
      const int k = i - begin, b = k & 1, r0 = i * K8_BM, n = min(K8_BM, rows - r0);
      const int8_t* Ab = A + b * K8_BM * LDA_C;
      const float* srb = sr + b * K8_BM;
      mbar_wait(afull + b, (k >> 1) & 1);
      for (int j = 0; j < CT; ++j) {
        int acc[2][4][4];
        st.gemm<2, 4, 128, NW>(Ab, LDA_C, KC, true, acc);
        // 128-column tiles never straddle the two outputs
        bf16* dst = j < o.split ? o.out0 : o.out1;
        const int ld = j < o.split ? o.ld0 : o.ld1, c0 = 128 * (j < o.split ? j : j - o.split);
        const int cb = 128 * j + wn * 32 + 2 * t;  // this lane's columns cb + 8 ni + {0, 1}
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
            const float s = srb[r];
            float y[4][2];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const int c = cb + 8 * ni;
              y[ni][0] = __fadd_rn(dequant(acc[mi][ni][2 * h], s, scol[c]), bcol[c]);
              y[ni][1] = __fadd_rn(dequant(acc[mi][ni][2 * h + 1], s, scol[c + 1]), bcol[c + 1]);
            }
            if (residual) {  // x's 16 bytes at this lane's store, back in fragment order
              uint4 xv = make_uint4(0u, 0u, 0u, 0u);
              if (r < n)
                xv = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r0 + r) * KC + c0 +
                                                     wn * 32 + 8 * t);
              const uint32_t xq[4] = {xv.x, xv.y, xv.z, xv.w};
              const uint4 xf = quad_transpose(xq);
              const uint32_t xp[4] = {xf.x, xf.y, xf.z, xf.w};
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                const float2 xx =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xp[ni]));
                y[ni][0] = __fadd_rn(y[ni][0], xx.x);
                y[ni][1] = __fadd_rn(y[ni][1], xx.y);
              }
            }
            uint32_t P[4];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) P[ni] = pack_bf16(y[ni][0], y[ni][1]);
            const uint4 val = quad_transpose(P);
            // streaming stores (evict first): the rows are the next kernel's, not this one's
            if (r < n)
              __stcs(reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * ld + c0 + wn * 32 +
                                              8 * t),
                     val);
          }
      }
      __syncwarp();  // every lane's reads of the buffer's codes and scales are done
      if (lane == 0) mbar_arrive(aempty + b);
    }
  };
  if (N <= K8_STAGED_N)
    products(sws, sws + K8_STAGED_N);
  else
    products(sw, bias);
}

// The two properties the tail's one-GELU-a-row scale rests on, over every
// f32: gelu_tanh non-decreasing on x >= 0 (`bad` counts the steps where it
// falls) and the largest |gelu_tanh(x)| on x < 0 (`negmax`, as bits), which
// must stay under kGeluNegBound. tests/test_torch_cuda.py runs it.
__global__ void gelu_scale_check_kernel(unsigned long long* bad, unsigned* negmax) {
  constexpr unsigned long long kInf = 0x7f800000ull;  // the bits of +inf
  unsigned long long nb = 0;
  float nm = 0.f;
  const unsigned long long stride = 1ull * gridDim.x * blockDim.x;
  for (unsigned long long i = 1ull * blockIdx.x * blockDim.x + threadIdx.x; i < kInf; i += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    if (i + 1 < kInf && gelu_tanh(__uint_as_float(static_cast<unsigned>(i + 1))) < gelu_tanh(x)) ++nb;
    nm = fmaxf(nm, fabsf(gelu_tanh(-x)));
  }
  atomicAdd(bad, nb);
  atomicMax(negmax, __float_as_uint(nm));
}

template <bool kBf16Ln, bool kGeluFold, bool kK9>
cudaError_t launch_tail(const int8_t* acode, const float* ascale, const bf16* a, const bf16* x,
                        int nrows, const int8_t* wo, const float* so, const float* bo,
                        const int8_t* w1, const float* s1, const float* b1, const int8_t* w2,
                        const float* s2, const float* b2, float eps, bf16* out, cudaStream_t s) {
  auto tail = kK9 ? k9_tail_kernel<kBf16Ln, kGeluFold> : k1_tail_kernel<kBf16Ln, kGeluFold>;
  const cudaError_t e = set_smem(tail, K1_TAIL_SMEM);
  if (e != cudaSuccess) return e;
  tail<<<(nrows + 63) / 64, K1T_THREADS, K1_TAIL_SMEM, s>>>(acode, ascale, a, x, nrows, wo, so, bo,
                                                           w1, s1, b1, w2, s2, b2, eps, out);
  return cudaGetLastError();
}

template <bool kBf16Ln, bool kK8>
cudaError_t launch_stream(const bf16* x, int rows, int N, int blocks, const int8_t* w,
                          const float* sw, const float* bias, const float* gamma,
                          const float* beta, float eps, int do_ln, int residual, DenseOut o,
                          cudaStream_t s) {
  auto kern = ln_dense_stream_kernel<kBf16Ln, kK8>;
  const cudaError_t e = set_smem(kern, K8_SMEM);
  if (e != cudaSuccess) return e;
  kern<<<blocks, K8_THREADS, K8_SMEM, s>>>(x, rows, N, w, sw, bias, gamma, beta, eps, do_ln,
                                           residual, o);
  return cudaGetLastError();
}

template <bool kBf16Ln, bool kGeluFold>
cudaError_t launch_k1(const bf16* x, int M, int Tn, int nc, int tracks, int rows_pad,
                      const int8_t* wqkv, const float* sqkv, const float* bqkv, const int8_t* wo,
                      const float* so, const float* bo, const int8_t* w1, const float* s1,
                      const float* b1, const int8_t* w2, const float* s2, const float* b2,
                      float eps, float scale, int8_t* acode, float* ascale, bf16* out,
                      cudaStream_t s) {
  const bool tile = nc == 1;
  const size_t fsmem = k1_front_smem(tile, rows_pad);
  auto front = tile ? k1_front_kernel<kBf16Ln, 1, true>
                    : (nc == 2 ? k1_front_kernel<kBf16Ln, 2, false>
                               : k1_front_kernel<kBf16Ln, 0, false>);
  cudaError_t e = set_smem(front, fsmem);
  if (e != cudaSuccess) return e;
  front<<<(M + tracks - 1) / tracks, 256, fsmem, s>>>(x, M, Tn, tracks, rows_pad, wqkv, sqkv,
                                                      bqkv, eps, scale, acode, ascale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_tail<kBf16Ln, kGeluFold, false>(acode, ascale, nullptr, x, M * Tn, wo, so, bo, w1,
                                                s1, b1, w2, s2, b2, eps, out, s);
}

// K2 (or K11, kK11: the same body under K11's front name): the front on
// `blocks` blocks, then K1's tail over the N * T rows.
template <bool kBf16Ln, bool kGeluFold, bool kK11>
cudaError_t launch_k2(const bf16* x, const bf16* kv, int N, int Tn, int V, int blocks,
                      const int8_t* wq, const float* sq, const float* bq, const int8_t* wo,
                      const float* so, const float* bo, const int8_t* w1, const float* s1,
                      const float* b1, const int8_t* w2, const float* s2, const float* b2,
                      float eps, float scale, int8_t* acode, float* ascale, bf16* out,
                      cudaStream_t s) {
  auto front = kK11 ? k11_front_kernel<kBf16Ln> : k2_front_kernel<kBf16Ln>;
  cudaError_t e = set_smem(front, K2_FRONT_SMEM);
  if (e != cudaSuccess) return e;
  front<<<blocks, 256, K2_FRONT_SMEM, s>>>(x, kv, N, Tn, V, wq, sq, bq, eps, scale, acode, ascale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_tail<kBf16Ln, kGeluFold, false>(acode, ascale, nullptr, x, N * Tn, wo, so, bo, w1,
                                                s1, b1, w2, s2, b2, eps, out, s);
}

// K2's and K11's entries: the plan's checks, then the two launches
template <bool kK11>
int space_block(const void* x, const void* kv, int N, int T, int V, int C, int H, int D,
                int blocks, const int8_t* wq, const float* sq, const float* bq, const int8_t* wo,
                const float* so, const float* bo, const int8_t* w1, const float* s1,
                const float* b1, const int8_t* w2, const float* s2, const float* b2, float eps,
                float scale, int bf16_ln, int gelu_fold, int8_t* acode, float* ascale, void* out,
                void* stream) {
  const long long tiles = static_cast<long long>((N + K2_TILE - 1) / K2_TILE) * T;
  if (N < 1 || T < 1 || V < 1 || V > K2_MAX_V || C != KC || H != K1_HEADS || D != kDimHead ||
      blocks < 1 || blocks > tiles || static_cast<long long>(N) * T > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* kp = static_cast<const bf16*>(kv);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto ln, auto fold) {
    return launch_k2<decltype(ln)::value, decltype(fold)::value, kK11>(
        xp, kp, N, T, V, blocks, wq, sq, bq, wo, so, bo, w1, s1, b1, w2, s2, b2, eps, scale,
        acode, ascale, op, s);
  };
  using T_ = std::true_type;
  using F_ = std::false_type;
  if (bf16_ln) return gelu_fold ? go(T_{}, T_{}) : go(T_{}, F_{});
  return gelu_fold ? go(F_{}, T_{}) : go(F_{}, F_{});
}

}  // namespace ct

using namespace ct;

extern "C" {

// The front's and the tail's shared-memory bytes for a plan (the wrapper's
// k1_plan checks its own arithmetic against them).
int ct_k1_smem(int nc, int rows_pad, int tail) {
  return tail ? K1_TAIL_SMEM : static_cast<int>(k1_front_smem(nc == 1, rows_pad));
}

// x (M, T, 384) bf16 -> out (M, T, 384) bf16. The plan (k1_plan): nc 1 =
// the tile route (tracks = 64 // T whole tracks, rows_pad 64), 2 or 0 = the
// track route (one track, rows_pad = T rounded up to 64, the time core's
// chunks in registers or in two passes). acode (M*T, 384) int8 and ascale
// (M*T,) f32: the scratch between the two launches, from the caller.
int ct_k1_time_block(const void* x, int M, int T, int C, int H, int D, int nc, int tracks,
                     int rows_pad, const int8_t* wqkv, const float* sqkv, const float* bqkv,
                     const int8_t* wo, const float* so, const float* bo, const int8_t* w1,
                     const float* s1, const float* b1, const int8_t* w2, const float* s2,
                     const float* b2, float eps, float scale, int bf16_ln, int gelu_fold,
                     int8_t* acode, float* ascale, void* out, void* stream) {
  const bool plan_ok =
      nc == 1 ? (rows_pad == 64 && tracks >= 1 && tracks * T <= 64)
              : ((nc == 0 || nc == 2) && tracks == 1 && T > 64 && rows_pad % 64 == 0 &&
                 rows_pad >= T && rows_pad <= K1_MAX_ROWS && (nc == 0 || rows_pad == 128));
  if (M < 1 || T < 1 || C != KC || H != K1_HEADS || D != kDimHead || !plan_ok ||
      k1_front_smem(nc == 1, rows_pad) > 232448)
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto ln, auto fold) {
    return launch_k1<decltype(ln)::value, decltype(fold)::value>(
        xp, M, T, nc, tracks, rows_pad, wqkv, sqkv, bqkv, wo, so, bo, w1, s1, b1, w2, s2, b2,
        eps, scale, acode, ascale, op, s);
  };
  using T_ = std::true_type;
  using F_ = std::false_type;
  if (bf16_ln) return gelu_fold ? go(T_{}, T_{}) : go(T_{}, F_{});
  return gelu_fold ? go(F_{}, T_{}) : go(F_{}, F_{});
}

// K2's front's and the tail's shared-memory bytes (mlp_int8_cuda.k2_plan
// checks its arithmetic against them).
int ct_k2_smem(int tail) { return tail ? K1_TAIL_SMEM : K2_FRONT_SMEM; }

// K2 in bfloat16 (mlp_int8_pallas.py::_space_block_kernel): x (N, T, 384)
// point tokens, kv (T, V <= 64, 768) the frames' projected virtual
// keys|values -> out (N, T, 384), two launches (the front on `blocks`
// blocks, k2_plan's count, at most one per 64-track tile, then K1's tail).
// acode (N*T, 384) int8 and ascale (N*T,) f32: the scratch between them.
int ct_k2_space_block(const void* x, const void* kv, int N, int T, int V, int C, int H, int D,
                      int blocks, const int8_t* wq, const float* sq, const float* bq,
                      const int8_t* wo, const float* so, const float* bo, const int8_t* w1,
                      const float* s1, const float* b1, const int8_t* w2, const float* s2,
                      const float* b2, float eps, float scale, int bf16_ln, int gelu_fold,
                      int8_t* acode, float* ascale, void* out, void* stream) {
  return space_block<false>(x, kv, N, T, V, C, H, D, blocks, wq, sq, bq, wo, so, bo, w1, s1, b1,
                            w2, s2, b2, eps, scale, bf16_ln, gelu_fold, acode, ascale, out, stream);
}

// K11 in bfloat16 (mlp_int8_pallas.py::_space_block_allt_kernel): K2's
// function, so K2's two launches with the same arguments; the front runs
// under its own name (k11_front_kernel).
int ct_k11_space_block(const void* x, const void* kv, int N, int T, int V, int C, int H, int D,
                       int blocks, const int8_t* wq, const float* sq, const float* bq,
                       const int8_t* wo, const float* so, const float* bo, const int8_t* w1,
                       const float* s1, const float* b1, const int8_t* w2, const float* s2,
                       const float* b2, float eps, float scale, int bf16_ln, int gelu_fold,
                       int8_t* acode, float* ascale, void* out, void* stream) {
  return space_block<true>(x, kv, N, T, V, C, H, D, blocks, wq, sq, bq, wo, so, bo, w1, s1, b1,
                           w2, s2, b2, eps, scale, bf16_ln, gelu_fold, acode, ascale, out, stream);
}

// K9 in bfloat16 (mlp_int8_pallas.py::_out_mlp_kernel): a, x (rows, 384)
// bf16 -> out (rows, 384) bf16 through the tail with K9's prologue and last
// residual; one launch.
int ct_k9_tail(const void* a, const void* x, int rows, int C, int H, const int8_t* wo,
               const float* so, const float* bo, const int8_t* w1, const float* s1,
               const float* b1, const int8_t* w2, const float* s2, const float* b2, float eps,
               int bf16_ln, int gelu_fold, void* out, void* stream) {
  if (rows < 1 || C != KC || H != KH) return cudaErrorInvalidValue;
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto ln, auto fold) {
    return launch_tail<decltype(ln)::value, decltype(fold)::value, true>(
        nullptr, nullptr, ap, xp, rows, wo, so, bo, w1, s1, b1, w2, s2, b2, eps, op, s);
  };
  using T_ = std::true_type;
  using F_ = std::false_type;
  if (bf16_ln) return gelu_fold ? go(T_{}, T_{}) : go(T_{}, F_{});
  return gelu_fold ? go(F_{}, T_{}) : go(F_{}, F_{});
}

// K8 in bfloat16 (mlp_int8_pallas.py::_qkv_kernel): x (rows, 384) ->
// q (rows, 384), kv (rows, 768), on `blocks` persistent blocks (k8_plan's
// count, at most one per 128-row tile).
int ct_k8_stream(const void* x, int rows, int C, const int8_t* w, const float* sw,
                 const float* bias, float eps, int bf16_ln, int blocks, void* q, void* kv,
                 void* stream) {
  if (rows < 1 || C != KC || blocks < 1 || blocks > (rows + K8_BM - 1) / K8_BM)
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const DenseOut o{static_cast<bf16*>(q), static_cast<bf16*>(kv), KC / 128, KC, 2 * KC};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_ln ? launch_stream<true, true>(xp, rows, 3 * KC, blocks, w, sw, bias, nullptr,
                                             nullptr, eps, 1, 0, o, s)
                 : launch_stream<false, true>(xp, rows, 3 * KC, blocks, w, sw, bias, nullptr,
                                              nullptr, eps, 1, 0, o, s);
}

// K10 in bfloat16 (mlp_int8_pallas.py::_dense_kernel): x (rows, 384) ->
// out (rows, N), N a multiple of 128 (N = 384 with the residual); gamma and
// beta both given or both null; on `blocks` persistent blocks (k10_plan's).
int ct_k10_stream(const void* x, int rows, int C, int N, const int8_t* w, const float* sw,
                  const float* bias, const float* gamma, const float* beta, float eps, int do_ln,
                  int residual, int bf16_ln, int blocks, void* out, void* stream) {
  if (rows < 1 || C != KC || N < 128 || N % 128 != 0 || (residual && N != KC) ||
      (gamma == nullptr) != (beta == nullptr) || blocks < 1 ||
      blocks > (rows + K8_BM - 1) / K8_BM)
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const DenseOut o{static_cast<bf16*>(out), nullptr, N / 128, N, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_ln ? launch_stream<true, false>(xp, rows, N, blocks, w, sw, bias, gamma, beta, eps,
                                              do_ln, residual, o, s)
                 : launch_stream<false, false>(xp, rows, N, blocks, w, sw, bias, gamma, beta, eps,
                                               do_ln, residual, o, s);
}

// The streamed body's shared-memory bytes a block (k8_plan and k10_plan
// check their arithmetic against it).
int ct_k8_smem() { return K8_SMEM; }

// bad (1,) u64 and negmax (1,) u32, zeroed by the caller.
int ct_k1_gelu_check(unsigned long long* bad, unsigned* negmax, void* stream) {
  gelu_scale_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(bad, negmax);
  return cudaGetLastError();
}

}  // extern "C"
