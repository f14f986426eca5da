// Shared device helpers of the port's kernels (sm_90a, plain C interface).
//
// The int8 products use the warp-level tensor-core instruction
// mma.sync.m16n8k32 (s8 x s8 -> s32). Fragment layouts (PTX ISA, "Matrix
// fragments for mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
//   A (16 x 32, row-major): a0 = A[g][4t..4t+3],    a1 = A[g+8][4t..4t+3],
//                           a2 = A[g][16+4t..],     a3 = A[g+8][16+4t..]
//   B (32 x 8, column j = g): b0 = B[4t..4t+3][g],  b1 = B[16+4t..][g]
//   C (16 x 8):             c0,c1 = C[g][2t, 2t+1], c2,c3 = C[g+8][2t, 2t+1]
// so with both operands stored K-contiguous in shared memory every fragment
// register is one aligned 32-bit load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ct {

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Symmetric int8 code of v under reciprocal scale inv: round half to even
// after multiplying by the reciprocal, as the JAX kernels do (no contraction).
__device__ __forceinline__ int8_t quant8(float v, float inv) {
  return static_cast<int8_t>(rintf(__fmul_rn(v, inv)));
}

// 16 bytes global -> shared without registers (zeros when !ok; src must
// still be a valid address), in commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix (non-transposed) of four / two 8x8 b16 matrices (16-byte rows:
// also the s8 fragments of mma.m16n8k32).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// One warp's products over BK bytes of K: acc[MI][NI] += the warp's A rows
// (a: this K slice of its first row's ldmatrix address, row stride lda) x
// the stage's B rows (b: the stage's base; b_pair / b_last the lane's
// ldmatrix offsets of the column-tile pairs and of an odd last tile).
template <int MI, int NI, int BK, int LDB>
__device__ __forceinline__ void warp_mma(int (&acc)[MI][NI][4], const int8_t* a, int lda,
                                         const int8_t* b, int b_pair, int b_last) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) ldsm_x4(af[mi], a + mi * 16 * lda + kk);
#pragma unroll
    for (int ni = 0; ni + 1 < NI; ni += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + b_pair + ni * 8 * LDB + kk);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_s8_16832(acc[mi][ni], af[mi], bf);
        mma_s8_16832(acc[mi][ni + 1], af[mi], bf + 2);
      }
    }
    if constexpr (NI % 2 == 1) {
      uint32_t bf[2];
      ldsm_x2(bf, b + b_last + kk);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma_s8_16832(acc[mi][NI - 1], af[mi], bf);
    }
  }
}

// ------------------------------------------------ thread-block clusters
// (K4's and K4m's volume kernel, corr_window.cu; K12, int8_mlp_cluster.cu)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// this block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// the shared::cluster address of the same shared-memory address as p in
// block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  return ra;
}
// the float at the same shared-memory address as p in block `rank`
__device__ __forceinline__ float cluster_ld(const float* p, int rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}
// 16 bytes (p 16-byte aligned) at the same address in block `rank`
__device__ __forceinline__ uint4 cluster_ld16(const void* p, int rank) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}
__device__ __forceinline__ void cluster_st16(void* p, int rank, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(cluster_addr(p, rank)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void cluster_st(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(cluster_addr(p, rank)), "f"(v)
               : "memory");
}

}  // namespace ct
