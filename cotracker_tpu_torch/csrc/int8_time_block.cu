// K1 on Hopper: the whole W8A8 time block in two launches, and K9 and K2
// on K1's tail (sm_90a).
//
// Replaces, on the H100, the Pallas bodies
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_time_block_kernel  (K1)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_out_mlp_kernel     (K9)
//   cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_space_block_kernel (K2)
// (wrappers fused_time_block_int8, fused_attnout_res_mlp_int8,
// fused_space_block_int8) for bfloat16 tokens, driven from
// ops/kernels/mlp_int8_cuda.py (the plans: k1_plan, k2_plan; K9's body:
// k9_route). float32 tokens keep the launch chains and the 64-row K9 body
// of int8_blocks.cu (K2 also past the 64 virtual tokens its front stages).
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
//     is not built.
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

template <bool kBf16Ln>
__global__ void __launch_bounds__(256, 1)
k2_front_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kv, int N, int Tn, int V,
                const int8_t* __restrict__ wq, const float* __restrict__ sq,
                const float* __restrict__ bq, float eps, float scale,
                int8_t* __restrict__ acode, float* __restrict__ ascale) {
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

// Each side's position in the ring: slot and the parity of its current use.
struct Stream {
  int8_t* ring;
  uint64_t* full;   // K1T_SLOTS, count 32 (the producer's lanes)
  uint64_t* empty;  // K1T_SLOTS, count 16 (the consumer warps)
  int slot;
  unsigned parity;
  __device__ void advance() {
    if (++slot == K1T_SLOTS) {
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
  // consumer: acc (+)= A[64 rows, 0:K) . the next K / BK stages^T, the 16
  // warps as 2 x 8, warp tiles (16 * MI) x (8 * NI)
  template <int MI, int NI, int BK>
  __device__ void gemm(const int8_t* A, int lda, int K, bool zero, int (&acc)[MI][NI][4]) {
    constexpr int NW = 8, LDB = BK + 16;
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
  Stream st{ring, bars, bars + K1T_SLOTS, 0, 0u};

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

// K2: the front on `blocks` blocks, then K1's tail over the N * T rows.
template <bool kBf16Ln, bool kGeluFold>
cudaError_t launch_k2(const bf16* x, const bf16* kv, int N, int Tn, int V, int blocks,
                      const int8_t* wq, const float* sq, const float* bq, const int8_t* wo,
                      const float* so, const float* bo, const int8_t* w1, const float* s1,
                      const float* b1, const int8_t* w2, const float* s2, const float* b2,
                      float eps, float scale, int8_t* acode, float* ascale, bf16* out,
                      cudaStream_t s) {
  auto front = k2_front_kernel<kBf16Ln>;
  cudaError_t e = set_smem(front, K2_FRONT_SMEM);
  if (e != cudaSuccess) return e;
  front<<<blocks, 256, K2_FRONT_SMEM, s>>>(x, kv, N, Tn, V, wq, sq, bq, eps, scale, acode, ascale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_tail<kBf16Ln, kGeluFold, false>(acode, ascale, nullptr, x, N * Tn, wo, so, bo, w1,
                                                s1, b1, w2, s2, b2, eps, out, s);
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
  const long long tiles = static_cast<long long>((N + K2_TILE - 1) / K2_TILE) * T;
  if (N < 1 || T < 1 || V < 1 || V > K2_MAX_V || C != KC || H != K1_HEADS || D != kDimHead ||
      blocks < 1 || blocks > tiles || static_cast<long long>(N) * T > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* kp = static_cast<const bf16*>(kv);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto ln, auto fold) {
    return launch_k2<decltype(ln)::value, decltype(fold)::value>(
        xp, kp, N, T, V, blocks, wq, sq, bq, wo, so, bo, w1, s1, b1, w2, s2, b2, eps, scale,
        acode, ascale, op, s);
  };
  using T_ = std::true_type;
  using F_ = std::false_type;
  if (bf16_ln) return gelu_fold ? go(T_{}, T_{}) : go(T_{}, F_{});
  return gelu_fold ? go(F_{}, T_{}) : go(F_{}, F_{});
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

// bad (1,) u64 and negmax (1,) u32, zeroed by the caller.
int ct_k1_gelu_check(unsigned long long* bad, unsigned* negmax, void* stream) {
  gelu_scale_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(bad, negmax);
  return cudaGetLastError();
}

}  // extern "C"
