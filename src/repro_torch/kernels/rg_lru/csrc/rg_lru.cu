// RG-LRU linear recurrence (K5) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/rg_lru/kernel.py::rg_lru (pallas_call at kernel.py:67, body
// _kernel at kernel.py:26).
//
// What it computes: h_t = a_t * h_{t-1} + b_t for t = 0 .. S-1, per
// sequence and channel, from the carried float32 state h [B, d]; it
// writes every h_t to hs [B, S, d] and the last one back into h.  The
// same function as rg_lru_ref in ref.py.  Any S >= 1 and any d: the
// TPU kernel's shape check (kernel.py:58) lets S % 128 != 0 through
// when d <= 256 and then leaves the tail rows unwritten; this kernel
// has no chunking, so it has no tail.  The product and the sum are
// rounded separately (__fmul_rn, __fadd_rn, no FMA contraction), as
// the plain version's two tensor ops are, so the two agree bit for
// bit; a = 1, b = 0 leaves h unchanged, which is how the serving path
// keeps the ragged tail of a chunk inert.
//
// Bound on an H100: bytes.  Two float operations per element against
// 12 bytes moved (a and b read, h written): the least time is
// (a + b + hs + the state read and written) / 3.35 TB/s.
//
// Design: one thread per (sequence, channel), neighbouring threads on
// neighbouring channels, so every load and store of a token's row is
// coalesced.  The loop over t is sequential in the thread; it loads
// the a and b of kUnroll tokens before it applies them, so that many
// loads are in flight where one dependent load per token would leave
// the memory system idle.  The TPU kernel's log2(Q) doubling scan
// exists to use vector lanes along t; here the channels fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ h, float* __restrict__ hs, int B, int S,
              int d) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)B * d) return;
  const int64_t bb = i / d;
  const int64_t c = i % d;
  const size_t base = (size_t)bb * S * d + c;
  float hv = h[i];
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        av[u] = a[base + (size_t)t * d];
        bv[u] = b[base + (size_t)t * d];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
        hs[base + (size_t)t * d] = hv;
      }
    }
  }
  h[i] = hv;
}

}  // namespace

extern "C" {

// a, b, hs: float32 [B, S, d]; h: float32 [B, d], read and written in
// place.  All contiguous.  Returns cudaGetLastError() after the launch.
int rg_lru(const float* a, const float* b, float* h, float* hs, int B,
           int S, int d, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * d;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  rg_lru_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, hs, B, S, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
