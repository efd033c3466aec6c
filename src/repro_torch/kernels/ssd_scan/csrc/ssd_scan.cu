// Mamba-2 SSD scan (K4) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssd_scan/kernel.py::ssd_scan (pallas_call at kernel.py:93,
// body _kernel at kernel.py:24).
//
// What it computes, for each sequence b and head h, from the carried
// float32 state h [P, N] (read and written in place):
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T      x_t [P], B_t [N]
//   y_t = h_t C_t + D x_t                            y_t [P]
// for t = 0 .. S-1: the recurrence the TPU kernel evaluates chunk by
// chunk in its dual (attention-like) form, and the same function as
// ssd_scan_ref in ref.py.  B and C are one group shared by all heads.
// The TPU kernel starts from a zero state; serving carries h, so this
// one starts from whatever h holds (the wrapper zeroes it when the
// caller has none).  dt_t = 0 leaves h unchanged bit for bit: the
// decay is exp(0) = 1 and the update 0, which is how the serving path
// keeps the ragged tail of a chunk inert.
//
// Bound on an H100: bytes.  Each token costs about 5 P N flops on a
// state of P N floats that must be read and written once per call
// (16.8 MB at B 8, H 32, P 64, N 128), plus x, y, B, C and dt.
//
// Design (not the Pallas grid carried over block by block):
// * one block of 8 warps per (sequence, head); the state stays in
//   registers for the whole call: warp w owns rows p = w + 8 i, lane l
//   owns columns n = l + 32 k, so each row of h is read and written as
//   coalesced 128-byte lines, once.  Splitting a head's rows over four
//   blocks, two rows a warp, measured slower at both T = 1 and 64;
// * per token every lane reads the B and C values of its columns and
//   the x values of its warp's rows straight from device memory (the
//   eight warps read the same lines, which L1 serves), and the next
//   token's values are loaded before this token's arithmetic, so the
//   loads of step t + 1 overlap the FMAs of step t.  No shared memory,
//   no block barrier;
// * y_t[p] is a warp sum of the lanes' partial dot products over n.
//
// The chunked dual form on tensor cores is the wgmma route
// (ssd_scan_wgmma.cu), which ops.py::scan_route picks for bf16 at P 64
// from SCAN_WGMMA_MIN_S tokens on, and the decode step at those widths
// (T = 1) is ssd_step.cu; this kernel keeps T = 2, float32 and the
// other widths, and T = 1 in bf16 by an explicit route.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::from_f;
using attn::to_f;
using attn::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;  // rows per warp: P <= kWarps * kRows = 64

// One token's inputs for this thread: dt, the x of its warp's rows, the
// B and C of its columns (zero outside P and N).
template <typename T, int NK>
__device__ __forceinline__ void load_token(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm, size_t bt, int hh,
    int H, int P, int N, int row0, int lane, float& dtv, float* xv,
    float* bv, float* cv) {
  dtv = dt[bt * H + hh];
  const T* xr = x + (bt * H + hh) * P;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = row0 + kWarps * i;
    xv[i] = p < P ? to_f(xr[p]) : 0.f;
  }
  const T* br = Bm + bt * N;
  const T* cr = Cm + bt * N;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int n = lane + 32 * k;
    bv[k] = n < N ? to_f(br[n]) : 0.f;
    cv[k] = n < N ? to_f(cr[n]) : 0.f;
  }
}

// NK: columns per lane (N <= 32 * NK).
template <typename T, int NK>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                float* __restrict__ h, T* __restrict__ y, int S, int H,
                int P, int N) {
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row0 = threadIdx.x / 32;  // this warp's rows: row0 + kWarps i
  const float a_h = A[hh];
  const float d_h = D[hh];
  float* hs = h + ((size_t)b * H + hh) * P * N;

  float st[kRows][NK];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = row0 + kWarps * i;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int n = lane + 32 * k;
      st[i][k] = (p < P && n < N) ? hs[(size_t)p * N + n] : 0.f;
    }
  }

  float dtv, xv[kRows], bv[NK], cv[NK];
  float dtn = 0.f, xn[kRows], bn[NK], cn[NK];
  load_token<T, NK>(x, dt, Bm, Cm, (size_t)b * S, hh, H, P, N, row0, lane,
                    dtv, xv, bv, cv);
  for (int t = 0; t < S; ++t) {
    if (t + 1 < S)
      load_token<T, NK>(x, dt, Bm, Cm, (size_t)b * S + t + 1, hh, H, P, N,
                        row0, lane, dtn, xn, bn, cn);
    const float decay = expf(dtv * a_h);
    T* yr = y + (((size_t)b * S + t) * H + hh) * P;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int p = row0 + kWarps * i;  // the same for the whole warp
      if (p >= P) continue;
      const float u = dtv * xv[i];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        st[i][k] = st[i][k] * decay + u * bv[k];
        acc += st[i][k] * cv[k];
      }
      acc = warp_sum(acc);
      if (lane == 0) yr[p] = from_f<T>(acc + d_h * xv[i]);
    }
    dtv = dtn;
#pragma unroll
    for (int i = 0; i < kRows; ++i) xv[i] = xn[i];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      bv[k] = bn[k];
      cv[k] = cn[k];
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = row0 + kWarps * i;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int n = lane + 32 * k;
      if (p < P && n < N) hs[(size_t)p * N + n] = st[i][k];
    }
  }
}

template <typename T, int NK>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, float* h,
                   void* y, int B, int S, int H, int P, int N,
                   cudaStream_t stream) {
  dim3 grid(H, B);
  ssd_scan_kernel<T, NK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, h, static_cast<T*>(y), S, H, P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D,
                     float* h, void* y, int B, int S, int H, int P, int N,
                     cudaStream_t s) {
  if (N <= 32)
    return launch<T, 1>(x, dt, A, Bm, Cm, D, h, y, B, S, H, P, N, s);
  if (N <= 64)
    return launch<T, 2>(x, dt, A, Bm, Cm, D, h, y, B, S, H, P, N, s);
  return launch<T, 4>(x, dt, A, Bm, Cm, D, h, y, B, S, H, P, N, s);
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16.  x, y: [B, S, H,
// P]; dt: float32 [B, S, H]; A, D: float32 [H]; Bm, Cm: [B, S, N]; h:
// float32 [B, H, P, N], read and written in place.  All contiguous,
// P <= 64, N <= 128.  Returns cudaGetLastError() after the launch.
int ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, float* h, void* y, int dtype,
             int B, int S, int H, int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kWarps * kRows || N > 128 || B <= 0 || S <= 0 || H <= 0 ||
      P <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(x, dt, A, Bm, Cm, D, h, y, B, S, H, P, N, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h, y, B, S, H,
                                        P, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
