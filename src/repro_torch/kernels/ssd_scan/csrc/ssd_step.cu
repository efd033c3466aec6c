// Mamba-2 SSD scan (K4) at one token, the decode step, for Hopper,
// sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssd_scan/kernel.py::ssd_scan (pallas_call at kernel.py:93) at
// S = 1, for bf16 x, B and C at P 64 and N 64 or 128 (mamba2-370m's
// decode steps).  ops.py::scan_route states the dispatch; T >= 3 takes
// ssd_scan_wgmma.cu, T = 2, float32 and the other widths ssd_scan.cu.
//
// What it computes: the function of ssd_scan.cu at S = 1, for each
// sequence b and head h, in place on the float32 state h [P, N]:
//   h = exp(dt A) h + dt x B^T        x [P], B [N]
//   y = h C + D x                     y [P]
// The update is st * decay + u * b as in ssd_scan.cu, so dt = 0 leaves
// h unchanged bit for bit (the serving path's inert lanes).
//
// Bound on an H100: bytes.  The state is read and written once, 16.8 MB
// at B 8, H 32, P 64, N 128, against about 5 P N flops a (b, h); x, y,
// B, C and dt add a few KB.  ssd_scan.cu, written for a token loop,
// runs one block of 8 warps per (sequence, head), loads its state as
// scalar floats and stores none of it before the whole block's
// arithmetic is done.
//
// Design (one token, no loop):
// * each (sequence, head) is cut into kSlices = 4 blocks of 16 rows,
//   four warps a block: 1,024 blocks at B 8, H 32 (1, 2, 4 and 8
//   blocks a head measured within 2% of each other on an H100 at
//   mamba2-370m's decode shape; PERF.md);
// * a lane owns four consecutive columns of a row, so one 16-byte load
//   or store covers four state floats: at N 128 a warp moves a 512-byte
//   row an instruction, at N 64 two rows;
// * a thread issues all its state loads (L2 only: the state is read
//   once, and it is written here, so no .nc loads), its B and C (8
//   bytes each), x and dt before any arithmetic;
// * each row is written back as soon as its update is done, with
//   evict-first stores (48 layers x 8.4 MB do not stay in L2), and its
//   y is a sum over the row's lanes by shuffles, the rows' sums
//   interleaved.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;        // rows of a head's state
constexpr int kSlices = 4;    // blocks a (sequence, head)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// four bf16 values (8 bytes) to floats
__device__ __forceinline__ float4 bf4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_step_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ dt, const float* __restrict__ A,
                const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm,
                const float* __restrict__ D, float* __restrict__ h,
                __nv_bfloat16* __restrict__ y, int H) {
  constexpr int kLanesRow = N / 4;              // lanes a row
  constexpr int kRowsWarp = 32 / kLanesRow;     // rows a warp instruction
  constexpr int kRows = kP / kSlices;           // rows a block
  constexpr int kRPT = kRows / (kWarps * kRowsWarp);  // rows a thread
  static_assert(kRPT >= 1 && kRPT * kWarps * kRowsWarp == kRows,
                "rows must tile the block");
  const int hh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = 4 * (lane % kLanesRow);
  const size_t bh = (size_t)b * H + hh;
  // row of this thread's i-th instruction
  const int row0 = blockIdx.x * kRows + warp * kRowsWarp + lane / kLanesRow;
  float4* hs = reinterpret_cast<float4*>(h + bh * kP * N);

  float4 st[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
    st[i] = __ldcg(hs + ((row0 + i * kWarps * kRowsWarp) * N + col) / 4);
  const float4 bv = bf4(Bm + (size_t)b * N + col);
  const float4 cv = bf4(Cm + (size_t)b * N + col);
  float xv[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i)
    xv[i] = __bfloat162float(x[bh * kP + row0 + i * kWarps * kRowsWarp]);
  const float dtv = __ldg(dt + bh);
  const float decay = expf(dtv * __ldg(A + hh));
  const float d_h = __ldg(D + hh);

  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const float u = dtv * xv[i];
    float4 s = st[i];
    s.x = s.x * decay + u * bv.x;
    s.y = s.y * decay + u * bv.y;
    s.z = s.z * decay + u * bv.z;
    s.w = s.w * decay + u * bv.w;
    __stcs(hs + ((row0 + i * kWarps * kRowsWarp) * N + col) / 4, s);
    acc[i] = s.x * cv.x + s.y * cv.y + s.z * cv.z + s.w * cv.w;
  }
  // each row's lanes sum their partials (xor offsets below kLanesRow
  // stay inside the row's lanes)
#pragma unroll
  for (int o = 1; o < kLanesRow; o <<= 1)
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (lane % kLanesRow == 0) {
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
      y[bh * kP + row0 + i * kWarps * kRowsWarp] =
          __float2bfloat16(acc[i] + d_h * xv[i]);
  }
}

template <int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, float* h,
                   void* y, int B, int H, cudaStream_t stream) {
  ssd_step_kernel<N><<<dim3(kSlices, H, B), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), D, h,
      static_cast<__nv_bfloat16*>(y), H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 x, B, C and y only.  x, y: [B, 1, H, P]; dt: float32 [B, 1,
// H]; A, D: float32 [H]; Bm, Cm: [B, 1, N]; h: float32 [B, H, P, N],
// read and written in place.  All contiguous, P 64, N 64 or 128, h
// 16-byte and B, C 8-byte aligned.  Returns cudaGetLastError() after
// the launch.
int ssd_step(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, float* h, void* y, int B, int H,
             int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P != kP || B <= 0 || B > 65535 || H <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 64)
    return (int)launch<64>(x, dt, A, Bm, Cm, D, h, y, B, H, s);
  if (N == 128)
    return (int)launch<128>(x, dt, A, Bm, Cm, D, h, y, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
