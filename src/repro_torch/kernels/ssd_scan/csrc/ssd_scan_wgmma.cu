// Mamba-2 SSD scan (K4), the wgmma route: the chunked dual form on the
// tensor cores, for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssd_scan/kernel.py::ssd_scan (pallas_call at kernel.py:93,
// body _kernel at kernel.py:24), for bf16 x, B and C with P = 64 and
// N = 64 or 128 (mamba2-370m) at S >= ops.SCAN_WGMMA_MIN_S tokens.
// Float32, T = 1 and the smoke widths take ssd_scan.cu;
// ops.py::scan_route states the dispatch.
//
// What it computes: the function of ssd_scan.cu, for each sequence b
// and head h from the carried float32 state h [P, N] (read and written
// in place):
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t + D x_t
// evaluated chunk by chunk as the TPU kernel does.  Per chunk of Q = 64
// tokens (the last one masked: its rows past S are zeros and dt = 0):
//   cum   = inclusive prefix sum of dt_t A                  (a warp scan)
//   S1    = C B^T                                   [Q, Q]  (wgmma)
//   W     = S1 o L o dt_j,  L_ij = exp(cum_i - cum_j) for i >= j, else 0
//   Y     = (C h^T) o exp(cum_i) + W X + D x        [Q, P]  (wgmma)
//   h    <- exp(a_total) h + X^T B_w,  B_w = B o exp(a_total - cum) dt
// L is masked BEFORE the exponent: above the diagonal cum_i - cum_j > 0
// can overflow to inf, and inf * 0 is NaN.  dt = 0 throughout keeps h
// bit for bit: exp(0) = 1 and the update adds exact zeros.
//
// Precision.  C, B and X are bf16 inputs and enter the tensor cores as
// they are.  The float32 operands W, h and B_w enter as three bf16
// terms each, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid) (split3), three products each: the terms keep v to about 2^-24,
// float32's own precision.  Two terms (hi + lo, about 2^-17) leave y
// errors above 1e-5, which is all one bf16 ulp of the plain version's
// output allows on values near zero; three keep y within it
// (ref.py::ssd_scan_chunked_ref emulates the terms on the CPU;
// tests/test_torch_ssd_scan.py::
// test_three_bf16_terms_keep_one_ulp_of_the_sequential_form), for a
// third more products, which the tensor cores do not notice (the bound
// is bytes).
//
// Bound on an H100: bytes.  The state read and written once (16.8 MB
// at B 8, H 32) plus x, y, B, C and dt; the dual form's products are
// about 2.3 Gflop at T = 64 on bf16 tensor cores (ops.dual_flops).
//
// Design.  One block of one warpgroup (128 threads) per (head,
// sequence), about 90 KB of shared memory, two blocks an SM: 256 blocks
// are one wave on 132 SMs.
// * Thread 0 loads a chunk's x [Q, P], B [Q, N] and C [Q, N] by TMA
//   (rows past S come back zero), 128-byte swizzled; B and C are one
//   group shared by all heads and are read per head from L2.
// * The state lives in the warpgroup's m64nN accumulator for the whole
//   call (64 registers a thread at N = 128): loaded from h at the start,
//   scaled by exp(a_total) and accumulated onto by X^T B_w (wgmma with
//   both operands read MN-major from shared memory) each chunk, and
//   written once at the end.
// * Per chunk the state's three terms go to shared memory as the
//   K-major B operand of C h^T; once that product has run, the same
//   buffer takes B_w's three terms, computed while W X runs.  W enters
//   its product as the register A operand.
// Not done yet: one chunk's loads do not overlap the last chunk's
// products (the serving path runs one chunk a call).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kQ = 64;           // tokens a chunk; also P
constexpr int kThreads = 128;    // one warpgroup
constexpr int kTerms = 3;        // bf16 terms of a float32 operand
constexpr int kAtom = 64 * 128;  // 64 rows x 128 bytes

template <int N>
struct Layout {
  static constexpr int kAtoms = N / 64;
  static constexpr int kCB = kAtoms * kAtom;       // C or B: [Q][N]
  static constexpr int kC = 0;
  static constexpr int kB = kC + kCB;
  static constexpr int kX = kB + kCB;              // [Q][P]
  static constexpr int kT = kX + kAtom;            // kTerms x [64][N]
  static constexpr int kCum = kT + kTerms * kCB;   // float [Q]
  static constexpr int kDt = kCum + 4 * kQ;        // float [Q]
  static constexpr int kBar = kDt + 4 * kQ;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kSmem = kBar + 16 + 1024;
};

struct Args {
  const float* dt;        // [B, S, H]
  const float* A;         // [H]
  const float* D;         // [H]
  float* h;               // [B, H, P, N]
  __nv_bfloat16* y;       // [B, S, H, P]
  int S, H;
};

// (x, y) as three bf16 pairs whose sum keeps (x, y) to about 2^-24.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  uint32_t r;
  split2(x, y, hi, r);
  const float2 h = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&hi));
  split2(x - h.x, y - h.y, mid, lo);
}

// d += A B for m64nNk16, A and B read MN-major from shared memory
// (A = X^T from the [t][p] tile, B = B_w from the [t][n] tiles).
__device__ __forceinline__ void wgmma_tt(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Byte offset of element (r, c) of a [64][N] bf16 tile stored as
// 128-byte-swizzled atoms of 64 columns.
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (uint32_t)((c / 64) * kAtom + sw128_chunk(r, (c % 64) / 8) +
                    (c % 8) * 2);
}

// Accumulator layout of m64nN (per warp the m16n8 layout, repeated over
// N / 8): register i of lane (g = lane / 4, t = lane % 4) of warp w
// holds row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
k4_wgmma(const __grid_constant__ CUtensorMap tx,
         const __grid_constant__ CUtensorMap tb,
         const __grid_constant__ CUtensorMap tc, Args a) {
  using L = Layout<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base_ptr = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) -
                                        smem_u32(smem_raw));
  const uint32_t sbase = smem_u32(base_ptr);
  const uint32_t sC = sbase + L::kC, sB = sbase + L::kB, sX = sbase + L::kX,
                 sT = sbase + L::kT, bar = sbase + L::kBar;
  unsigned char* tp = base_ptr + L::kT;      // generic views of the tiles
  const unsigned char* bp = base_ptr + L::kB;
  const unsigned char* xp = base_ptr + L::kX;
  float* cum = reinterpret_cast<float*>(base_ptr + L::kCum);
  float* dts = reinterpret_cast<float*>(base_ptr + L::kDt);
  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;           // the thread's rows r0, r0 + 8
  const float a_h = a.A[hh], d_h = a.D[hh];
  float* hs = a.h + ((size_t)b * a.H + hh) * kQ * N;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the state, rows p = r0 (+ 8), columns n = 8 j + 2 t4 (+ 1)
  float st[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(
          hs + (size_t)(r0 + 8 * r) * N + 8 * j + 2 * t4);
      st[4 * j + 2 * r] = v.x;
      st[4 * j + 2 * r + 1] = v.y;
    }
  __syncthreads();

  const int n_chunks = (a.S + kQ - 1) / kQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * kQ;
    if (tid == 0) {
      mbar_expect_tx(bar, (2 * L::kAtoms + 1) * kAtom);
      tma_load(sX, &tx, bar, 0, s0, hh, b);
#pragma unroll
      for (int at = 0; at < L::kAtoms; ++at) {
        tma_load(sB + at * kAtom, &tb, bar, 64 * at, s0, b, 0);
        tma_load(sC + at * kAtom, &tc, bar, 64 * at, s0, b, 0);
      }
    }
    // dt and the prefix sum of dt A: warps 0 and 1 scan their 32 tokens
    if (tid < kQ) {
      const float dv = s0 + tid < a.S
          ? a.dt[((size_t)b * a.S + s0 + tid) * a.H + hh] : 0.f;
      float v = dv * a_h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      dts[tid] = dv;
      cum[tid] = v;
    }
    // the state's terms: the K-major B operand of C h^T, [p][n]
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t t3[kTerms];
        split3(st[4 * j + 2 * r], st[4 * j + 2 * r + 1], t3[0], t3[1], t3[2]);
        const uint32_t off = tile_off(r0 + 8 * r, 8 * j + 2 * t4);
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          *reinterpret_cast<uint32_t*>(tp + k * L::kCB + off) = t3[k];
      }
    __syncthreads();
    if (tid >= 32 && tid < kQ) cum[tid] += cum[31];
    fence_proxy_async();
    __syncthreads();
    mbar_wait(bar, c & 1);

    // S1 = C B^T and Y = C h^T, K = N in steps of 16 (32 bytes within a
    // 128-byte atom, the next atom after four)
    float s1[32], yacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(s1, sw128_desc(sC + off, 16, 1024),
                   sw128_desc(sB + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int k = 0; k < kTerms; ++k)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
        wgmma_ss_n64(yacc, sw128_desc(sC + off, 16, 1024),
                     sw128_desc(sT + k * L::kCB + off, 16, 1024),
                     k > 0 || kk > 0);
      }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s1);
    reg_fence(yacc);
    __syncthreads();   // every warp is past C h^T: sT may be rewritten

    // W = S1 o L o dt_j, masked before the exponent; its terms as the A
    // fragments of four k-steps of 16 tokens
    const float cr[2] = {cum[r0], cum[r0 + 8]};
    uint32_t wf[kTerms][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q, r = q & 1;
        const int row = r0 + 8 * r, col = 8 * (i / 4) + 2 * t4;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col + e;
          const float lij = row >= j ? expf(cr[r] - cum[j]) : 0.f;
          w[e] = s1[i + e] * lij * dts[j];
        }
        split3(w[0], w[1], wf[0][kk][q], wf[1][kk][q], wf[2][kk][q]);
      }
    const float ec[2] = {expf(cr[0]), expf(cr[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= ec[(i >> 1) & 1];
    // Y += W X: X MN-major, 16 tokens a step (2,048 bytes)
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTerms; ++k)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64(yacc, wf[k][kk], sw128_desc(sX + kk * 2048, kAtom, 1024));
    wgmma_commit();

    // meanwhile B_w = B o (exp(a_total - cum) dt) as three terms, in B's
    // own layout: the MN-major B operand of X^T B_w
    const float a_tot = cum[kQ - 1];
    for (int q = tid; q < kQ * N / 8; q += kThreads) {
      const int row = q / (N / 8), cc = q % (N / 8);
      const uint32_t off = (cc / 8) * kAtom + sw128_chunk(row, cc % 8);
      const float sc = expf(a_tot - cum[row]) * dts[row];
      const uint4 braw = *reinterpret_cast<const uint4*>(bp + off);
      const uint32_t bw[4] = {braw.x, braw.y, braw.z, braw.w};
      uint32_t o[kTerms][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bw[e]));
        split3(f.x * sc, f.y * sc, o[0][e], o[1][e], o[2][e]);
      }
#pragma unroll
      for (int k = 0; k < kTerms; ++k)
        *reinterpret_cast<uint4*>(tp + k * L::kCB + off) =
            make_uint4(o[k][0], o[k][1], o[k][2], o[k][3]);
    }
    fence_proxy_async();
    wgmma_wait0();
    reg_fence(yacc);
    reg_fence(wf[0]);
    reg_fence(wf[1]);
    reg_fence(wf[2]);
    __syncthreads();

    // h <- exp(a_total) h + X^T B_w
    const float ea = expf(a_tot);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) st[i] *= ea;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTerms; ++k)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tt(st, sw128_desc(sX + kk * 2048, kAtom, 1024),
                 sw128_desc(sT + k * L::kCB + kk * 2048, kAtom, 1024));
    wgmma_commit();

    // meanwhile y = Y + D x for the chunk's rows inside S
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1, row = r0 + 8 * r;
      const int col = 8 * (i / 4) + 2 * t4;
      if (s0 + row >= a.S) continue;
      const float2 xf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xp + tile_off(row, col)));
      *reinterpret_cast<__nv_bfloat162*>(
          a.y + (((size_t)b * a.S + s0 + row) * a.H + hh) * kQ + col) =
          __floats2bfloat162_rn(yacc[i] + d_h * xf.x,
                                yacc[i + 1] + d_h * xf.y);
    }
    wgmma_wait0();
    reg_fence(st);
    __syncthreads();   // x, B, C and the terms are free for the next chunk
  }

#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(hs + (size_t)(r0 + 8 * r) * N + 8 * j +
                                 2 * t4) =
          make_float2(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
}

template <int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, float* h, void* y, int B, int S,
           int H, cudaStream_t stream) {
  // x [B, S, H, P] as (p, s, head, batch); B and C [B, S, N] as (n, s,
  // batch, 1): boxes of 64 columns x 64 rows, zeros past S
  CUtensorMap tx, tb, tc;
  const int64_t sx[3] = {(int64_t)S * H * kQ, kQ, (int64_t)H * kQ};
  const int64_t sbc[3] = {(int64_t)B * S * N, (int64_t)S * N, N};
  if (!tensor_map(&tx, x, kQ, S, H, B, sx) ||
      !tensor_map(&tb, Bm, N, S, B, 1, sbc) ||
      !tensor_map(&tc, Cm, N, S, B, 1, sbc))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dt = dt;
  a.A = A;
  a.D = D;
  a.h = h;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.S = S;
  a.H = H;
  const int smem = Layout<N>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      k4_wgmma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k4_wgmma<N><<<dim3(H, B), kThreads, smem, stream>>>(tx, tb, tc, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 x, B, C and y; P = 64, N = 64 or 128.  x, y: [B, S, H, P];
// dt: float32 [B, S, H]; A, D: float32 [H]; Bm, Cm: [B, S, N]; h:
// float32 [B, H, P, N], read and written in place.  All contiguous and
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
int ssd_scan_wgmma(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, float* h,
                   void* y, int B, int S, int H, int P, int N, void* stream) {
  if (P != kQ || B <= 0 || B > 65535 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64: return launch<64>(x, dt, A, Bm, Cm, D, h, y, B, S, H, s);
    case 128: return launch<128>(x, dt, A, Bm, Cm, D, h, y, B, S, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
