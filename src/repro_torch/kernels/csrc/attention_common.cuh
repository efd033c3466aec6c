// Device helpers shared by the port's paged-attention kernels (K1 and
// K2 in paged_attention/csrc, K3 in verify_attention/csrc):
// conversions between the storage type and float, 16-byte loads, warp
// reductions, and the staging of one [psz, hd] page of one kv head
// into shared memory (K1, K3).  The SSD scan (K4, ssd_scan/csrc) uses
// the conversions and the warp sum.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T to floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage one [psz, hd] page of kv head kh (page stride psz * KH * hd,
// row stride KH * hd; src points at the page's first element of head
// kh) into shared memory as float with row stride ld, using all
// nthreads threads of the block.  vec: 16-byte loads (hd * sizeof(T)
// and the page base 16-byte aligned).
template <typename T>
__device__ __forceinline__ void stage_page(const T* __restrict__ src,
                                           float* dst, int ld, int psz,
                                           int KH, int hd, bool vec,
                                           int nthreads) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    for (int i = threadIdx.x; i < psz * hd / VE; i += nthreads) {
      const int j = i * VE / hd, d = i * VE % hd;
      float f[VE];
      load16(src + (size_t)j * KH * hd + d, f);
#pragma unroll
      for (int e = 0; e < VE; ++e) dst[j * ld + d + e] = f[e];
    }
  } else {
    for (int i = threadIdx.x; i < psz * hd; i += nthreads) {
      const int j = i / hd, d = i % hd;
      dst[j * ld + d] = to_f(src[(size_t)j * KH * hd + d]);
    }
  }
}

// 16-byte page loads need 16-byte aligned rows and page bases.
template <typename T>
inline bool vec_ok(const void* kp, const void* vp, int hd) {
  return (hd * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(vp) % 16 == 0;
}

}  // namespace attn
