// Device helpers shared by K6's forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): mma.sync m16n8k16 in bf16 with its
// fragments loaded by ldmatrix, the hi/lo split of a float pair into
// two bf16 pairs, and 16-byte cp.async copies that fill zeros past the
// end; the warp reductions and conversions come from the attention
// kernels' common header.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace fa {

using attn::to_f;
using attn::warp_max;
using attn::warp_sum;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x, y) as one bf16 pair, x in the low half, as the fragments want it.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16 of what hi
// leaves over: hi + lo keeps (x, y) to about 2^-17.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += a b for one m16n8k16 tile: a row-major 16x16, b column-major
// 16x8, both bf16; c float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8.  trans: each thread gets the
// transposed element pairs.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major
// bf16 tile with row stride ld (elements).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld, int r0,
                                       int c0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(a, s + (r0 + (lane & 7) + (mi & 1) * 8) * ld + c0 + (mi >> 1) * 8);
}
// B fragments (b0, b1 of two 8-column n-tiles: b[0..1] for n0, b[2..3]
// for n0 + 8) at depth k0..k0+15 from a tile stored [n][k] (k
// contiguous): B[k][n] = s[n][k].
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* s, int ld,
                                          int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(b, s + (n0 + (lane & 7) + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8);
}
// The same from a tile stored [k][n] (n contiguous): B[k][n] = s[k][n].
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* s, int ld,
                                          int n0, int k0, int lane) {
  const int mi = lane >> 3;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8);
}

// 16 bytes global -> shared, asynchronous; zeros when !in.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(in ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fa
