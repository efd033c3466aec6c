// RG-LRU linear recurrence (K5), the tma route, for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/rg_lru/kernel.py::rg_lru (pallas_call at kernel.py:67, body
// _kernel at kernel.py:26), for d a multiple of 4 at S >=
// ops.LRU_TMA_MIN_S tokens; a decode step (T = 1) and what this route
// does not take run rg_lru.cu (ops.py::lru_route states the dispatch).
//
// What it computes: the function of rg_lru.cu and rg_lru_ref in ref.py,
// h_t = a_t * h_{t-1} + b_t for t = 0 .. S-1 per sequence and channel,
// from the carried float32 state h [B, d]; every h_t goes to hs
// [B, S, d] and the last one back into h.  The product and the sum are
// rounded separately (__fmul_rn, __fadd_rn, no FMA contraction) in
// token order, as the plain version's two tensor ops are, so the two
// agree bit for bit, and a = 1, b = 0 leaves h unchanged.  The TPU
// kernel's doubling scan would round differently; the card does not
// need it (below).
//
// Bound on an H100: bytes.  Two float operations per element against
// 12 bytes moved: (a + b + hs + the state read and written) / 3.35
// TB/s.
//
// Design: every byte of a block in flight at once, the arithmetic
// unchanged.  rg_lru.cu's thread per (sequence, channel) keeps only a
// few tokens' loads in flight, and at the serving shape (B 8, d 2560)
// its 80 blocks leave 52 of the 132 SMs idle, so it waits on latency.
// Here one block of kTile threads owns (sequence b, kTile channels):
// 320 blocks at B 8, d 2560, two to three resident on each SM.  Thread
// 0 brings the [kChunk tokens, kTile channels] boxes of a and b into a
// ring of kStages stages by TMA (a 4-d map over (d, S, B, 1): rows past
// S and channels past d come back zero), completion on one mbarrier a
// stage; with kStages x kChunk = 64 tokens, a prefill chunk of 64 is
// asked for in one go, 32 KB a block.  Longer S (the tests' 200) walks
// the ring: a stage is refilled once every thread has read it.  Each
// thread runs its channel's recurrence out of shared memory in token
// order (conflict-free: neighbouring threads, neighbouring words) and
// stores h_t straight to hs, a warp's 128 bytes a token, coalesced;
// the state is read once and written once.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;     // channels a block (and threads)
constexpr int kChunk = 8;     // tokens a stage
constexpr int kStages = 8;    // stages in the ring
constexpr int kBoxBytes = kChunk * kTile * 4;   // a, or b, of a stage
constexpr int kStageBytes = 2 * kBoxBytes;
constexpr int kSmem = kStages * kStageBytes + 8 * kStages + 1024;

__global__ void __launch_bounds__(kTile)
rg_lru_tma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  float* __restrict__ h, float* __restrict__ hs, int S,
                  int d) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* sbuf = reinterpret_cast<const float*>(smem_raw + (base - raw));
  const uint32_t full = base + kStages * kStageBytes;
  const int c0 = blockIdx.x * kTile, b = blockIdx.y;
  const int c = c0 + threadIdx.x;
  const int nch = (S + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int ch = 0; ch < min(nch, kStages); ++ch) {
      const uint32_t dst = base + ch * kStageBytes;
      mbar_expect_tx(full + 8 * ch, kStageBytes);
      tma_load(dst, &ta, full + 8 * ch, c0, ch * kChunk, b, 0);
      tma_load(dst + kBoxBytes, &tb, full + 8 * ch, c0, ch * kChunk, b, 0);
    }
  }
  __syncthreads();

  const bool in = c < d;
  const size_t row = (size_t)b * S * d + c;   // hs of (b, t = 0, c)
  float hv = in ? h[(size_t)b * d + c] : 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch % kStages;
    mbar_wait(full + 8 * st, (ch / kStages) & 1);
    const float* sa = sbuf + st * (kStageBytes / 4) + threadIdx.x;
    const float* sb = sa + kBoxBytes / 4;
    const int t0 = ch * kChunk, n = min(kChunk, S - t0);
    if (in) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (u < n) {
          hv = __fadd_rn(__fmul_rn(sa[u * kTile], hv), sb[u * kTile]);
          hs[row + (size_t)(t0 + u) * d] = hv;
        }
      }
    }
    if (ch + kStages < nch) {
      __syncthreads();                  // every thread has read stage st
      if (threadIdx.x == 0) {
        const int nx = ch + kStages;
        const uint32_t dst = base + st * kStageBytes;
        mbar_expect_tx(full + 8 * st, kStageBytes);
        tma_load(dst, &ta, full + 8 * st, c0, nx * kChunk, b, 0);
        tma_load(dst + kBoxBytes, &tb, full + 8 * st, c0, nx * kChunk, b, 0);
      }
    }
  }
  if (in) h[(size_t)b * d + c] = hv;
}

// A 4-d map over (d, S, B, 1) of a contiguous float32 [B, S, d], boxes
// of kTile channels x kChunk tokens, no swizzle, zeros past the end.
bool lru_map(CUtensorMap* map, const float* ptr, int B, int S, int d) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)B,
                              1};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 4, (cuuint64_t)S * d * 4,
                                 (cuuint64_t)B * S * d * 4};
  const cuuint32_t box[4] = {kTile, kChunk, 1, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr),
            dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// a, b, hs: float32 [B, S, d]; h: float32 [B, d], read and written in
// place.  All contiguous, a and b 16-byte aligned, d a multiple of 4
// (the tensor map's row stride).  Returns cudaGetLastError() after the
// launch.
int rg_lru_tma(const float* a, const float* b, float* h, float* hs, int B,
               int S, int d, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || d <= 0 || d % 4)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!lru_map(&ta, a, B, S, d) || !lru_map(&tb, b, B, S, d))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rg_lru_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + kTile - 1) / kTile, B);
  rg_lru_tma_kernel<<<grid, kTile, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(ta, tb, h, hs, S,
                                                           d);
  return (int)cudaGetLastError();
}

}  // extern "C"
