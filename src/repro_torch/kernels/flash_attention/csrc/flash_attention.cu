// Causal (or bidirectional) flash attention, forward (K6), for Hopper,
// sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention/kernel.py::flash_attention (pallas_call at
// kernel.py:80, body _kernel at kernel.py:23).
//
// What it computes: for q [B, H, S, hd] and k, v [B, KH, S, hd] (query
// head h reads kv head h / (H / KH)), o = softmax(q k^T / sqrt(hd)) v
// with the scores and the softmax in float32, keys above the diagonal
// masked in causal mode (-1e30, as the TPU kernel masks them), o
// divided by max(l, 1e-20) and written in the inputs' type, and the
// float32 log-sum-exp lse [B, H, S] of each row's scaled scores (the
// backward pass rebuilds P from it).  The same function as
// flash_attention_fwd_ref in ref.py.  Beyond the TPU kernel: any S (the
// ragged last tile is masked; the TPU kernel asserts that its 256-row
// block divides S), GQA without expanding K and V, and strided inputs
// (the last dim contiguous), so the [B, S, H, hd] tensors of the
// training step are read through transposed views without a copy.
//
// Bound on an H100 at the training shape (olmo-1b: B 4, H 16, S 2048,
// hd 128, causal, bf16): operations.  QK^T and PV are 4 B H hd
// S(S+1)/2 = 68.75 Gflop, 0.0695 ms at 989 TFLOP/s; the bytes (q, k, v
// and o, 33.5 MB each, and lse) take 0.040 ms at 3.35 TB/s.  Only
// wgmma reaches the tensor cores' full rate, and only TMA feeds it
// without spending the consumers' registers and instructions on loads.
//
// Three kernels, chosen by dtype and hd (ops.py states the dispatch):
//
// fa_fwd_wgmma (bf16, hd 64 and 128), the training path's kernel.  A
// block of 288 threads owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each and one producer warp.  The
// producer loads the Q tile once and keeps a ring of kStages K/V
// stages (64 keys each, 16 KB of K and of V at hd 128) full with TMA
// (4-d tensor maps over (hd, s, head, batch) that carry the inputs'
// strides; 128-byte swizzle; rows past S arrive as zeros); each stage
// has a full mbarrier (TMA completion, by bytes) and an empty one (one
// arrival from each consumer warp).  A consumer warpgroup runs S = Q
// K^T as wgmma m64n64k16 with both operands in shared memory (both
// K-major), keeps the online softmax in registers (exp2 of scores
// pre-scaled by log2 e), and runs O += P V as wgmma m64n{hd}k16 with P
// as the register A operand and V read MN-major (the transpose flag),
// so V is stored as it lies in memory.  P is split into bf16 hi and lo
// and PV runs on both (see the mma.sync kernel below for why): measured
// on an H100, without the split about a tenth of the outputs at
// olmo-1b's and llama3.2-1b's shapes fall outside one bf16 ulp of the
// plain version, and the split makes the kernel a fifth slower
// (tools/k6_split_probe.py).  The warpgroup whose rows all lie above a
// causal tile skips it; tiles that cross the diagonal or S are masked.
// The heaviest causal tiles launch first.  Not done yet: no overlap of
// a warpgroup's softmax with its next QK^T, no setmaxnreg, no
// persistent grid.
//
// fa_fwd_mma (bf16, hd 16, the shapes the wgmma kernel does not take):
// one block of four warps per (batch, head, 64-row query tile); K
// staged row-major and V transposed in shared memory by plain loads;
// each warp owns 16 query rows and runs mma.sync m16n8k16.  P is split
// into two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), and PV
// runs on both, so the product keeps P to about 2^-17: without the
// split, P rounded to bf16 moves outputs near zero by more than one
// bf16 ulp of the float32 plain version.
//
// fa_fwd_f32 (float32: the smoke configs, the tests): plain float32
// FMAs, no TF32, one warp per row at a time with the lanes over the
// keys for QK^T and over hd for PV.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace fa;

constexpr int kBQ = 64;       // query rows a block (mma.sync, f32)
constexpr int kBK = 64;       // keys a K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Shape {
  int64_t q[3], k[3], v[3], o[3];   // strides of (b, h, s), in elements
  int B, H, KH, S, causal;
  float scale;
};

__device__ __forceinline__ int n_kv_tiles(const Shape& sh, int q0) {
  const int all = (sh.S + kBK - 1) / kBK;
  return sh.causal ? min(all, (q0 + kBQ - 1) / kBK + 1) : all;
}

__device__ __forceinline__ bool visible(const Shape& sh, int row, int col) {
  return col < sh.S && (!sh.causal || col <= row);
}

// ------------------------------------------------------- bf16, wgmma/TMA

constexpr int kRows = 128;            // query rows a block: 2 warpgroups
constexpr int kStages = 3;            // K/V stages in the ring
constexpr int kWgThreads = 288;       // 2 consumer warpgroups + 1 producer warp

template <int HD>
struct Layout {
  // Q: [HD / 64 column atoms][128 rows][64] bf16, each atom 128-byte
  // swizzled (rows of 128 bytes, 8-row groups of 1024 bytes); a stage:
  // K then V, each [HD / 64][64 keys][64].
  static constexpr int kAtoms = HD / 64;
  static constexpr int kQAtom = kRows * 128;            // bytes
  static constexpr int kTileAtom = kBK * 128;
  static constexpr int kQBytes = kAtoms * kQAtom;
  static constexpr int kTileBytes = kAtoms * kTileAtom; // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBars = kQBytes + kStages * kStageBytes;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kSmem = kBars + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// One box of the 4-d tensor map (64 columns x 64 rows of one head of
// one batch) into shared memory, completion counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), and
// the swizzle mode (1 = 128 B) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers that an asynchronous wgmma writes or reads: the compiler
// must neither read them before the wait nor reuse them before it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= A B for m64n64k16: A and B K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for m64n64k16: A in registers (the m16n8k16 A fragment of
// each warp's 16 rows), B MN-major in shared memory (transposed read)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += A B for m64n128k16: A in registers (the m16n8k16 A fragment of
// each warp's 16 rows), B MN-major in shared memory (transposed read)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// Accumulator layout of m64nN (per warp the m16n8 layout, repeated over
// N / 8): register i of lane (g = lane / 4, t = lane % 4) of warp w
// holds row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
             Shape sh) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sKV = base + L::kQBytes;
  const uint32_t full = base + L::kBars, empty = full + 8 * kStages,
                 qbar = full + 16 * kStages;

  const int nq = (sh.S + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;
  const int b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KH);
  const int all = (sh.S + kBK - 1) / kBK;
  const int nk = sh.causal ? min(all, (q0 + kRows - 1) / kBK + 1) : all;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);      // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: Q once, then K/V tiles into the ring
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load(sQ + a * L::kQAtom + w * (kBQ * 128), &tq, qbar, a * 64,
                   q0 + w * kBQ, h, b);
      for (int t = 0; t < nk; ++t) {
        const int st = t % kStages, ph = (t / kStages) & 1;
        mbar_wait(empty + 8 * st, ph ^ 1);
        mbar_expect_tx(full + 8 * st, L::kStageBytes);
        const uint32_t sK = sKV + st * L::kStageBytes,
                       sV = sK + L::kTileBytes;
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(sK + a * L::kTileAtom, &tk, full + 8 * st, a * 64,
                   t * kBK, kh, b);
          tma_load(sV + a * L::kTileAtom, &tv, full + 8 * st, a * 64,
                   t * kBK, kh, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int wg = warp / 4, wq0 = q0 + wg * kBQ;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = wq0 + (warp % 4) * 16 + g, row1 = row0 + 8;
  const float sl2 = sh.scale * kLog2e;
  // tiles this warpgroup's rows can see; the rest it only releases
  const int mine = sh.causal ? min(nk, (wq0 + kBQ - 1) / kBK + 1) : nk;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < nk; ++t) {
    const int st = t % kStages, ph = (t / kStages) & 1;
    mbar_wait(full + 8 * st, ph);
    if (t < mine) {
      const uint32_t sK = sKV + st * L::kStageBytes, sV = sK + L::kTileBytes;
      // S = Q K^T over hd in steps of 16 (32 bytes within a 128-byte
      // atom; the next atom after four)
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4), in = (kk % 4) * 32;
        wgmma_ss_n64(
            s, sw128_desc(sQ + off * L::kQAtom + wg * (kBQ * 128) + in, 16, 1024),
            sw128_desc(sK + off * L::kTileAtom + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      const int k0 = t * kBK;
      const bool edge = k0 + kBK > sh.S || (sh.causal && k0 + kBK - 1 > wq0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float x = s[i] * sl2;
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (!visible(sh, r ? row1 : row0, col)) x = kNegInf;
        }
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
      // P as the A fragments of four k-steps of 16 keys, hi and lo
      uint32_t ph_[4][4], pl_[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph_[kk][j],
                 pl_[kk][j]);
      // O += P V: V MN-major, 16 keys a step (2,048 bytes), the second
      // 64-column atom LBO = one atom's bytes away, 8-key groups 1 KB
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(sV + kk * 2048, L::kTileAtom, 1024);
        wgmma_pv<HD>(acc, ph_[kk], dv);
        wgmma_pv<HD>(acc, pl_[kk], dv);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
      reg_fence(ph_);
      reg_fence(pl_);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-20f);
  }
  __nv_bfloat16* ob = o + b * sh.o[0] + h * sh.o[1];
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = (i >> 1) & 1, row = r ? row1 : row0;
    const int d = 8 * (i >> 2) + 2 * t4;
    if (row < sh.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * sh.o[2] + d) =
          __floats2bfloat162_rn(acc[i] / den[r], acc[i + 1] / den[r]);
  }
  if (t4 == 0) {
    float* lb = lse + ((int64_t)b * sh.H + h) * sh.S;
    if (row0 < sh.S) lb[row0] = m[0] * kLn2 + logf(den[0]);
    if (row1 < sh.S) lb[row1] = m[1] * kLn2 + logf(den[1]);
  }
}

// -------------------------------------------------------- bf16, mma.sync

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_mma(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
            float* __restrict__ lse, Shape sh) {
  // row strides padded by 16 bytes: the fragment loads of a warp hit
  // 32 distinct banks
  constexpr int LQ = HD + 8, LK = HD + 8, LV = kBK + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // [kBQ][LQ]
  __nv_bfloat16* sK = sQ + kBQ * LQ;                             // [kBK][LK]
  __nv_bfloat16* sVt = sK + kBK * LK;                            // [HD][LV]
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const int nq = (sh.S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KH);
  const __nv_bfloat16* qb = q + b * sh.q[0] + h * sh.q[1];
  const __nv_bfloat16* kb = k + b * sh.k[0] + kh * sh.k[1];
  const __nv_bfloat16* vb = v + b * sh.v[0] + kh * sh.v[1];

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    sQ[r * LQ + d] = s < sh.S ? qb[s * sh.q[2] + d] : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = sQ + (warp * 16 + g) * LQ + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LQ);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LQ + 8);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int nk = n_kv_tiles(sh, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // every warp is done with the last tile
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, s = k0 + j;
      const bool in = s < sh.S;
      sK[j * LK + d] = in ? kb[s * sh.k[2] + d] : zero;
      sVt[d * LV + j] = in ? vb[s * sh.v[2] + d] : zero;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* p = sK + (nt * 8 + g) * LK + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }
    // scale and mask; the row max over the tile, then over the 4 lanes
    // that hold the row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + nt * 8 + 2 * t + e;
        sc[nt][e] = visible(sh, row0, col) ? sc[nt][e] * sh.scale : kNegInf;
        sc[nt][2 + e] =
            visible(sh, row1, col) ? sc[nt][2 + e] * sh.scale : kNegInf;
        mx[0] = fmaxf(mx[0], sc[nt][e]);
        mx[1] = fmaxf(mx[1], sc[nt][2 + e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = expf(sc[nt][e] - m[0]);
        sc[nt][2 + e] = expf(sc[nt][2 + e] - m[1]);
        l[0] += sc[nt][e];
        l[1] += sc[nt][2 + e];
      }
    }
    // O += P V: the score accumulators are the A fragments of P
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split2(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
      split2(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
      split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
      split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        const __nv_bfloat16* p = sVt + (nd * 8 + g) * LV + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
        mma_bf16(acc[nd], ah, b0, b1);
        mma_bf16(acc[nd], al, b0, b1);
      }
    }
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-20f);
  }
  __nv_bfloat16* ob = o + b * sh.o[0] + h * sh.o[1];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    const int d = nd * 8 + 2 * t;
    if (row0 < sh.S) {
      ob[row0 * sh.o[2] + d] = __float2bfloat16(acc[nd][0] / den[0]);
      ob[row0 * sh.o[2] + d + 1] = __float2bfloat16(acc[nd][1] / den[0]);
    }
    if (row1 < sh.S) {
      ob[row1 * sh.o[2] + d] = __float2bfloat16(acc[nd][2] / den[1]);
      ob[row1 * sh.o[2] + d + 1] = __float2bfloat16(acc[nd][3] / den[1]);
    }
  }
  if (t == 0) {
    float* lb = lse + ((int64_t)b * sh.H + h) * sh.S;
    if (row0 < sh.S) lb[row0] = m[0] + logf(den[0]);
    if (row1 < sh.S) lb[row1] = m[1] + logf(den[1]);
  }
}

// --------------------------------------------------------------- float32

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  constexpr int LD = HD + 1;                 // K rows: lanes on 32 banks
  constexpr int NPER = (HD + 31) / 32;       // output columns a lane
  constexpr int RPW = kBQ / kWarps;          // query rows a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [kBQ][LD]
  float* sK = sQ + kBQ * LD;                    // [kBK][LD]
  float* sV = sK + kBK * LD;                    // [kBK][HD]

  const int nq = (sh.S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KH);
  const float* qb = q + b * sh.q[0] + h * sh.q[1];
  const float* kb = k + b * sh.k[0] + kh * sh.k[1];
  const float* vb = v + b * sh.v[0] + kh * sh.v[1];

  for (int i = threadIdx.x; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    sQ[r * LD + d] = s < sh.S ? qb[s * sh.q[2] + d] : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[RPW][NPER], m[RPW], l[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;                              // this lane's share of the sum
#pragma unroll
    for (int i = 0; i < NPER; ++i) acc[rr][i] = 0.f;
  }

  const int nk = n_kv_tiles(sh, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, s = k0 + j;
      const bool in = s < sh.S;
      sK[j * LD + d] = in ? kb[s * sh.k[2] + d] : 0.f;
      sV[j * HD + d] = in ? vb[s * sh.v[2] + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, row = q0 + r;
      const float* qr = sQ + r * LD;
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        const float* kr = sK + j * LD;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s[e] = visible(sh, row, k0 + j) ? dot * sh.scale : kNegInf;
      }
      const float mx = fmaxf(m[rr], warp_max(fmaxf(s[0], s[1])));
      const float corr = expf(m[rr] - mx);
      m[rr] = mx;
      const float p0 = expf(s[0] - mx), p1 = expf(s[1] - mx);
      l[rr] = l[rr] * corr + p0 + p1;
#pragma unroll
      for (int i = 0; i < NPER; ++i) acc[rr][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
#pragma unroll
        for (int i = 0; i < NPER; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) acc[rr][i] = fmaf(pj, sV[j * HD + d], acc[rr][i]);
        }
      }
    }
  }

  float* ob = o + b * sh.o[0] + h * sh.o[1];
  float* lb = lse + ((int64_t)b * sh.H + h) * sh.S;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
    const float den = fmaxf(warp_sum(l[rr]), 1e-20f);
    if (row >= sh.S) continue;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) ob[row * sh.o[2] + d] = acc[rr][i] / den;
    }
    if (lane == 0) lb[row] = m[rr] + logf(den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Shape& sh, cudaStream_t stream) {
  const bool bf = sizeof(T) == 2;
  const size_t smem =
      bf ? (size_t)(kBQ * (HD + 8) + kBK * (HD + 8) + HD * (kBK + 8)) * 2
         : (size_t)(kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD) * 4;
  const dim3 grid((sh.S + kBQ - 1) / kBQ, sh.B * sh.H);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(fa_fwd_mma<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fa_fwd_mma<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, sh);
  } else {
    err = cudaFuncSetAttribute(fa_fwd_f32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fa_fwd_f32<HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sh);
  }
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int hd, const Shape& sh, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<float, 16>(q, k, v, o, lse, sh, stream);
    case 64: return launch<float, 64>(q, k, v, o, lse, sh, stream);
    case 128: return launch<float, 128>(q, k, v, o, lse, sh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled from the CUDA driver, found at run time so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over (hd, s, head, batch) of a bf16 tensor with element
// strides st = (b, h, s), boxes of 64 columns x 64 rows, 128-byte
// swizzle, zeros past the end.
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads,
                int B, const int64_t* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kBK, 1, 1};
  const cuuint32_t es[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, const Shape& sh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, sh.S, sh.H, sh.B, sh.q) ||
      !tensor_map(&tk, k, HD, sh.S, sh.KH, sh.B, sh.k) ||
      !tensor_map(&tv, v, HD, sh.S, sh.KH, sh.B, sh.v))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sh.S + kRows - 1) / kRows, sh.B * sh.H);
  fa_fwd_wgmma<HD><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sh);
  return (int)cudaGetLastError();
}

bool make_shape(Shape& sh, const int64_t* strides, int B, int H, int KH,
                int S, int hd, int causal) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || S <= 0 ||
      (int64_t)B * H > 65535)
    return false;
  for (int i = 0; i < 3; ++i) {
    sh.q[i] = strides[i];
    sh.k[i] = strides[3 + i];
    sh.v[i] = strides[6 + i];
    sh.o[i] = strides[9 + i];
  }
  sh.B = B;
  sh.H = H;
  sh.KH = KH;
  sh.S = S;
  sh.causal = causal;
  sh.scale = 1.0f / sqrtf((float)hd);
  return true;
}

}  // namespace

extern "C" {

// q [B, H, S, hd], k and v [B, KH, S, hd], o like q: any strides with
// the last dim contiguous; strides holds (b, h, s) of q, k, v, o in
// elements.  lse: float32 [B, H, S], contiguous.  Both entry points
// return cudaGetLastError() after the launch.
//
// The wgmma/TMA kernel: bfloat16, hd 64 or 128; q, k, v 16-byte
// aligned with strides of a multiple of 8 elements (the tensor maps').
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              void* o, float* lse, const int64_t* strides,
                              int B, int H, int KH, int S, int hd, int causal,
                              void* stream) {
  Shape sh;
  if (!make_shape(sh, strides, B, H, KH, S, hd, causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, o, lse, sh, st);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The mma.sync kernel (dtype 1, bfloat16, hd 16) or the float32 one
// (dtype 0, hd in {16, 64, 128}).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int64_t* strides, int dtype, int B,
                        int H, int KH, int S, int hd, int causal,
                        void* stream) {
  Shape sh;
  if (dtype < 0 || dtype > 1 || (dtype == 1 && hd != 16) ||
      !make_shape(sh, strides, B, H, KH, S, hd, causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<__nv_bfloat16, 16>(q, k, v, o, lse, sh, st)
             : launch_f32(q, k, v, o, lse, hd, sh, st);
}

}  // extern "C"
