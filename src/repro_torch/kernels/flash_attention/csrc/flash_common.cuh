// Device helpers shared by K6's forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): mma.sync m16n8k16 in bf16 with its
// fragments loaded by ldmatrix, and the pairing of two floats into one
// bf16 pair; the hi/lo split, the cp.async copies and the log constants
// come from the Hopper header (kernels/csrc), the warp reductions and
// conversions from the attention kernels' common header.  Last, what the
// backward's two sources (flash_attention_bwd.cu and
// flash_attention_bwd_wgmma.cu) share: their arguments' shape and the
// delta kernel.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace fa {

using attn::to_f;
using attn::warp_max;
using attn::warp_sum;
using hopper::cp16;
using hopper::cp_commit;
using hopper::cp_wait;
using hopper::kLn2;
using hopper::kLog2e;
using hopper::smem_u32;
using hopper::split2;

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x, y) as one bf16 pair, x in the low half, as the fragments want it.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
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

// ------------------------------------------------------------- backward

struct BwdShape {
  // strides of (b, h, s), in elements, of q, k, v, o, do, dq, dk, dv
  int64_t q[3], k[3], v[3], o[3], dO[3], dq[3], dk[3], dv[3];
  int B, H, KH, S, causal;
  float scale;
};

// delta = rowsum(do * o) in float32 [B, H, S], one warp a row: the
// first of the backward's three kernels on every route.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
             float* __restrict__ delta, BwdShape sh) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)sh.B * sh.H * sh.S) return;
  const int s = row % sh.S, bh = row / sh.S, b = bh / sh.H, h = bh % sh.H;
  const T* orow = o + b * sh.o[0] + h * sh.o[1] + s * sh.o[2];
  const T* drow = dO + b * sh.dO[0] + h * sh.dO[1] + s * sh.dO[2];
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

}  // namespace fa
