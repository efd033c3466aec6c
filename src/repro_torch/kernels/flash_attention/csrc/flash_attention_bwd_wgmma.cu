// Causal (or bidirectional) flash attention, backward (K6), the wgmma
// route: both halves of the backward on Hopper's tensor-core machinery,
// for sm_90a.
//
// Replaces: the JAX package has no backward kernel; it differentiates
// the jnp models/attention.py::blockwise_attention (attention.py:53)
// with jax.grad.  This route takes bf16 at hd 64, 96 and 128 (olmo-1b,
// llama3.2-1b, whisper-tiny; phi-3-vision-4.2b at hd 96); hd 16 keeps
// the mma.sync kernels and float32 the FMA kernels of
// flash_attention_bwd.cu (ops.py::backward_route states the dispatch).
// The function is theirs and flash_attention_bwd_ref's in ref.py: from
// (q, k, v, o, lse, do), with P = exp(scale q k^T - lse),
//   delta = rowsum(do * o),   dv = P^T do,   dP = do v^T,
//   dS = P * (dP - delta),    dq = scale dS k,   dk = scale dS^T q,
// float32 inside, dq, dk, dv written in bf16; dk and dv sum over the G
// query heads of each kv head.  Causal mode drops the keys above the
// diagonal; any S; strided inputs with the last dim contiguous and rows
// on 16-byte boundaries (the tensor maps').
//
// Bound on an H100 at the training shape (olmo-1b: B 4, H 16, S 2048,
// hd 128, causal): operations.  The function's five products, 10 B H
// hd S(S+1)/2 = 171.9 Gflop, take 0.174 ms at 989 TFLOP/s; the bytes
// 0.080 ms.  This design recomputes QK^T and dO V^T in the dQ pass, 7
// products where the bound counts 5, so its own floor is 1.4 x 0.174 =
// 0.243 ms.  At phi-3-vision-4.2b's (B 4, H 32, S 2048, hd 96,
// causal): operations, 257.8 Gflop, 0.261 ms (the bytes 0.121 ms); the
// three products whose N is hd run at the padded 128 columns, so this
// design's own floor there is (4 x 96 + 3 x 128) / (5 x 96) = 1.6 x
// 0.261 = 0.417 ms.  Only wgmma reaches the tensor cores' full rate,
// and only TMA feeds it without spending the consumers' registers on
// loads.
//
// Design: flash_attention_bwd.cu's split (no atomics, so two calls agree
// bit for bit), each half with a producer that keeps a ring of tiles
// full by TMA and consumer warpgroups that run every product on wgmma.
// Three kernels a call:
//
// fa_bwd_delta (flash_common.cuh, the mma.sync route's too): delta =
// rowsum(do * o) in float32 [B, H, S], one warp a row.
//
// fa_bwd_dkdv_wgmma: one block of three warpgroups per (batch, kv head,
// 128-key tile), the heaviest causal tiles first.  K_j and V_j are
// loaded once; warpgroup 0 is the producer: its first warp keeps a ring
// of kStages (Q_i, dO_i) stages of 64 query rows full by TMA (the 4-d
// tensor maps over (hd, s, head, batch) of the forward, 128-byte
// swizzle, rows past S zero) and writes each stage's lse * log2 e and
// delta beside it (+inf and 0 past S, so P = 0 there); a stage's full
// mbarrier completes on the TMA bytes and one arrival from each of the
// warp's lanes.  Warpgroups 1 and 2 own 64 keys each and, per stage,
//   S^T = K_j Q_i^T and dP^T = V_j dO_i^T    wgmma, both operands K-major
//                                            in shared memory;
//   P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - delta)
//                                            in registers;
//   dV += P^T dO_i and dK += dS^T Q_i        wgmma, A in registers (the
//                                            accumulator fragment packed
//                                            to bf16), B MN-major.
// dK and dV (64 + 64 floats a thread at hd 128) stay in the accumulator
// across the G query heads of the kv head, taken in head order, and
// the query tiles at or below the diagonal.  With S^T and dP^T that is
// about 200 live registers, so the producer warpgroup gives its
// registers up (setmaxnreg 24) and the consumers take 240.
//
// fa_bwd_dq_wgmma: the forward's shape: one block of 288 threads per
// (batch, head, 128 query rows), the heaviest first.  A producer warp
// loads Q_i and dO_i once and keeps a ring of (K_j, V_j) stages of 64
// keys full by TMA; each consumer warpgroup owns 64 rows and runs
//   S = Q_i K_j^T and dP = dO_i V_j^T        wgmma, operands in shared
//                                            memory;
//   dS = P (dP - delta)                      in registers;
//   dQ += dS K_j                             wgmma, A in registers, K
//                                            MN-major.
//
// hd 96 (phi-3-vision) runs over tiles padded to two 64-column atoms,
// as the forward's wgmma kernel does (flash_attention.cu): the tensor
// maps are built on the true hd, so the box at column 64 lands 32 real
// columns and 32 zeros (no HBM bytes past the row; the mbarriers count
// the full box).  The products that contract over hd (S^T, dP^T, S, dP)
// run the true hd's 6 k-steps; those whose N is hd (dV, dK, dQ) run
// m64n128k16 over the padded B operand, whose zero columns give zero
// accumulators that are not stored: the epilogues write d < 96 only.
// The scale stays 1 / sqrt(96).  Shared memory, the dK/dV accumulators
// (64 + 64 floats a thread) and the register budget are then hd 128's.
//
// Within a tile a warpgroup commits its products in groups and waits
// for one at a time: P is formed while dP runs, dS while dV runs; the
// two consumer warpgroups of a block fill each other's gaps on the
// tensor cores.  P and dS enter their products rounded to bf16, as in
// the mma.sync kernels; everything else is float32.  Not done: issuing
// the next tile's S and dP before the current tile's last products
// finish (tried on an H100 at the training shape, in both kernels and
// in dQ alone, with and without setmaxnreg in dQ: slower each time),
// and one pass that accumulates dQ in a fixed order instead of
// recomputing S and dP.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"    // with kernels/csrc/hopper_common.cuh

namespace {

using namespace fa;
using namespace hopper;

constexpr int kBQ = 64;      // query rows: a dK/dV stage, a dQ warpgroup
constexpr int kBK = 64;      // keys: a dK/dV warpgroup, a dQ stage
constexpr int kRows = 128;   // rows a block owns: two consumer warpgroups
constexpr int kStages = 3;   // stages in a ring
constexpr int kKvThreads = 384;   // dK/dV: producer + 2 consumer warpgroups
constexpr int kQThreads = 288;    // dQ: 2 consumer warpgroups + 1 warp

using Shape = BwdShape;     // flash_common.cuh, with fa_bwd_delta

// A warpgroup's register budget (sm_90a): every warp of the warpgroup
// executes it.
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Wait until at most one committed wgmma group is still running.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// ----------------------------------------------------------------- dK/dV

template <int HD>
struct KvLayout {
  // K, V: [kAtoms column atoms][128 keys][64] bf16, each atom 128-byte
  // swizzled; a stage: Q then dO, each [kAtoms][64 rows][64]; then the
  // stages' lse * log2 e and delta, [kStages][2][64] float32.  hd is
  // padded to whole atoms (kPad): at hd 96 the second atom holds
  // columns 64-95 and the zeros TMA writes past the tensor's last
  // column (HD / 64 atoms at 64 and 128).
  static constexpr int kAtoms = (HD + 63) / 64;
  static constexpr int kPad = kAtoms * 64;
  static constexpr int kKAtom = kRows * 128;              // bytes
  static constexpr int kKBytes = kAtoms * kKAtom;         // K or V
  static constexpr int kQAtom = kBQ * 128;
  static constexpr int kQBytes = kAtoms * kQAtom;         // Q or dO
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kLd = 2 * kKBytes + kStages * kStageBytes;
  static constexpr int kBars = kLd + kStages * 2 * kBQ * 4;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kSmem = kBars + 8 * (2 * kStages + 1) + 1024;
};

// Accumulator layout of m64nN (per warp the m16n8 layout, repeated over
// N / 8): register i of lane (g = lane / 4, t = lane % 4) of warp w of
// the warpgroup holds row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4)
// + 2 t + i % 2.  Its four registers 8 kk .. 8 kk + 7, packed in pairs,
// are the A fragment of k-step kk of a product that takes it as A.
template <int HD>
__global__ void __launch_bounds__(kKvThreads, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, Shape sh) {
  using L = KvLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + L::kKBytes,
                 sQ0 = base + 2 * L::kKBytes;
  float* sLd = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kLd);
  const uint32_t full = base + L::kBars, empty = full + 8 * kStages,
                 kvbar = full + 16 * kStages;

  const int k0 = blockIdx.x * kRows;
  const int b = blockIdx.y / sh.KH, kh = blockIdx.y % sh.KH;
  const int G = sh.H / sh.KH;
  const int nq = (sh.S + kBQ - 1) / kBQ;
  const int i0 = sh.causal ? k0 / kBQ : 0;       // first query tile
  const int per = nq - i0, n_it = G * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);      // the producer warp's lanes
      mbar_init(empty + 8 * s, 8);      // one arrival a consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // the producer warpgroup: its first warp loads, the others idle
    reg_dealloc<24>();
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::kKBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(sK + a * L::kKAtom + w * (kBK * 128), &tk, kvbar, a * 64,
                   k0 + w * kBK, kh, b);
          tma_load(sV + a * L::kKAtom + w * (kBK * 128), &tv, kvbar, a * 64,
                   k0 + w * kBK, kh, b);
        }
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages, ph = (it / kStages) & 1;
      const int h = kh * G + it / per, qt0 = (i0 + it % per) * kBQ;
      mbar_wait(empty + 8 * st, ph ^ 1);
      float* ld = sLd + st * 2 * kBQ;
      const int64_t at = ((int64_t)b * sh.H + h) * sh.S;
      for (int r = lane; r < kBQ; r += 32) {
        const int s = qt0 + r;
        ld[r] = s < sh.S ? lse[at + s] * kLog2e : INFINITY;
        ld[kBQ + r] = s < sh.S ? delta[at + s] : 0.f;
      }
      if (lane == 0) {
        // arrive.expect_tx: lane 0's arrival, and the stage's bytes
        mbar_expect_tx(full + 8 * st, L::kStageBytes);
        const uint32_t sQ = sQ0 + st * L::kStageBytes,
                       sdO = sQ + L::kQBytes;
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(sQ + a * L::kQAtom, &tq, full + 8 * st, a * 64, qt0, h, b);
          tma_load(sdO + a * L::kQAtom, &tdo, full + 8 * st, a * 64, qt0, h,
                   b);
        }
      } else {
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 keys
  reg_alloc<240>();
  const int wg = warp / 4 - 1, kw0 = k0 + wg * kBK;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = kw0 + (warp % 4) * 16 + g, key1 = key0 + 8;
  const float sl2 = sh.scale * kLog2e;

  // dK, dV over the padded width; columns past HD stay zero
  float adk[L::kPad / 2], adv[L::kPad / 2];
#pragma unroll
  for (int i = 0; i < L::kPad / 2; ++i) adk[i] = adv[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, ph = (it / kStages) & 1;
    const int qt0 = (i0 + it % per) * kBQ;
    mbar_wait(full + 8 * st, ph);
    // skipped: keys past S, and a causal tile whose queries all lie
    // before this warpgroup's keys
    if (kw0 < sh.S && (!sh.causal || qt0 + kBQ - 1 >= kw0)) {
      const uint32_t sQ = sQ0 + st * L::kStageBytes, sdO = sQ + L::kQBytes;
      const float* ld = sLd + st * 2 * kBQ;
      // S^T = K Q^T and dP^T = V dO^T over hd in steps of 16 (32 bytes
      // within a 128-byte atom; the next atom after four), two groups:
      // P^T is formed while dP^T runs
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = kk / 4, in = (kk % 4) * 32;
        wgmma_ss_n64(
            s, sw128_desc(sK + off * L::kKAtom + wg * (kBK * 128) + in, 16,
                          1024),
            sw128_desc(sQ + off * L::kQAtom + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = kk / 4, in = (kk % 4) * 32;
        wgmma_ss_n64(
            dp, sw128_desc(sV + off * L::kKAtom + wg * (kBK * 128) + in, 16,
                           1024),
            sw128_desc(sdO + off * L::kQAtom + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait1();
      reg_fence(s);

      // P^T: rows key0, key1 (i / 2 odd); columns the tile's queries.
      // Rows past S have lse = +inf: P = 0.
      const bool edge = sh.causal && qt0 < kw0 + kBK - 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const float p = exp2f(s[i] * sl2 - ld[c]);
        s[i] = edge && ((i >> 1) & 1 ? key1 : key0) > qt0 + c ? 0.f : p;
      }
      uint32_t ap[4][4], as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ap[kk][j] = pack2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      // dV += P^T dO over the padded width: 16 queries a step, dO read
      // MN-major (the second 64-column atom one atom's bytes away); dS^T
      // is formed while it runs
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<L::kPad>(adv, ap[kk],
                          sw128_desc(sdO + kk * 2048, L::kQAtom, 1024));
      wgmma_commit();
      wgmma_wait1();                    // dP^T is done; dV may run on
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = s[i] * (dp[i] - ld[kBQ + 8 * (i >> 2) + 2 * t4 + (i & 1)]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          as[kk][j] = pack2(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      // dK += dS^T Q, Q read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<L::kPad>(adk, as[kk],
                          sw128_desc(sQ + kk * 2048, L::kQAtom, 1024));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(adv);
      reg_fence(adk);
      reg_fence(ap);
      reg_fence(as);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  __nv_bfloat16* dkb = dk + b * sh.dk[0] + kh * sh.dk[1];
  __nv_bfloat16* dvb = dv + b * sh.dv[0] + kh * sh.dv[1];
  // registers i < HD / 2 hold the columns d < HD
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int key = (i >> 1) & 1 ? key1 : key0;
    const int d = 8 * (i >> 2) + 2 * t4;
    if (key < sh.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * sh.dk[2] + d) =
          __floats2bfloat162_rn(adk[i] * sh.scale, adk[i + 1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * sh.dv[2] + d) =
          __floats2bfloat162_rn(adv[i], adv[i + 1]);
    }
  }
}

// -------------------------------------------------------------------- dQ

template <int HD>
struct QLayout {
  // Q, dO: [kAtoms][128 rows][64] bf16; a stage: K then V, each
  // [kAtoms][64 keys][64]; padded as KvLayout's
  static constexpr int kAtoms = (HD + 63) / 64;
  static constexpr int kPad = kAtoms * 64;
  static constexpr int kQAtom = kRows * 128;
  static constexpr int kQBytes = kAtoms * kQAtom;         // Q or dO
  static constexpr int kTileAtom = kBK * 128;
  static constexpr int kTileBytes = kAtoms * kTileAtom;   // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBars = 2 * kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kQThreads, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, Shape sh) {
  using L = QLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + L::kQBytes,
                 sKV = base + 2 * L::kQBytes;
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
    // the producer: Q and dO once, then K/V tiles into the ring
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * L::kQBytes);
      for (int w = 0; w < 2; ++w)
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(sQ + a * L::kQAtom + w * (kBQ * 128), &tq, qbar, a * 64,
                   q0 + w * kBQ, h, b);
          tma_load(sdO + a * L::kQAtom + w * (kBQ * 128), &tdo, qbar, a * 64,
                   q0 + w * kBQ, h, b);
        }
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
  const int64_t at = ((int64_t)b * sh.H + h) * sh.S;
  // rows past S: P = 0 (lse +inf), delta 0
  const float l2[2] = {row0 < sh.S ? lse[at + row0] * kLog2e : INFINITY,
                       row1 < sh.S ? lse[at + row1] * kLog2e : INFINITY};
  const float dl[2] = {row0 < sh.S ? delta[at + row0] : 0.f,
                       row1 < sh.S ? delta[at + row1] : 0.f};

  // dQ over the padded width; columns past HD stay zero
  float acc[L::kPad / 2];
#pragma unroll
  for (int i = 0; i < L::kPad / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int t = 0; t < nk; ++t) {
    const int st = t % kStages, ph = (t / kStages) & 1;
    mbar_wait(full + 8 * st, ph);
    if (t < mine && wq0 < sh.S) {
      const uint32_t sK = sKV + st * L::kStageBytes, sV = sK + L::kTileBytes;
      // S = Q K^T and dP = dO V^T
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = kk / 4, in = (kk % 4) * 32;
        wgmma_ss_n64(
            s, sw128_desc(sQ + off * L::kQAtom + wg * (kBQ * 128) + in, 16,
                          1024),
            sw128_desc(sK + off * L::kTileAtom + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = kk / 4, in = (kk % 4) * 32;
        wgmma_ss_n64(
            dp, sw128_desc(sdO + off * L::kQAtom + wg * (kBQ * 128) + in, 16,
                           1024),
            sw128_desc(sV + off * L::kTileAtom + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait1();                    // P is formed while dP runs
      reg_fence(s);

      const int k0 = t * kBK;
      const bool edge = k0 + kBK > sh.S || (sh.causal && k0 + kBK - 1 > wq0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(s[i] * sl2 - l2[r]);
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (col >= sh.S || (sh.causal && col > (r ? row1 : row0))) p = 0.f;
        }
        s[i] = p;
      }
      wgmma_wait0();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
      uint32_t as[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          as[kk][j] = pack2(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      // dQ += dS K over the padded width: K read MN-major, 16 keys a
      // step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<L::kPad>(acc, as[kk],
                          sw128_desc(sK + kk * 2048, L::kTileAtom, 1024));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
      reg_fence(as);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  __nv_bfloat16* dqb = dq + b * sh.dq[0] + h * sh.dq[1];
  // registers i < HD / 2 hold the columns d < HD
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i >> 1) & 1 ? row1 : row0;
    const int d = 8 * (i >> 2) + 2 * t4;
    if (row < sh.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * sh.dq[2] + d) =
          __floats2bfloat162_rn(acc[i] * sh.scale, acc[i + 1] * sh.scale);
  }
}

// ---------------------------------------------------------------- launch

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  using B16 = __nv_bfloat16;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, HD, sh.S, sh.H, sh.B, sh.q) ||
      !tensor_map(&tk, k, HD, sh.S, sh.KH, sh.B, sh.k) ||
      !tensor_map(&tv, v, HD, sh.S, sh.KH, sh.B, sh.v) ||
      !tensor_map(&tdo, dO, HD, sh.S, sh.H, sh.B, sh.dO))
    return (int)cudaErrorInvalidValue;
  const int s_kv = KvLayout<HD>::kSmem, s_q = QLayout<HD>::kSmem;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           fa_bwd_dkdv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           s_kv)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           fa_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
           s_q)) != cudaSuccess)
    return (int)err;
  const int64_t rows = (int64_t)sh.B * sh.H * sh.S;
  fa_bwd_delta<B16, HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const B16*>(o), static_cast<const B16*>(dO), delta, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = (sh.S + kRows - 1) / kRows;
  fa_bwd_dkdv_wgmma<HD><<<dim3(n, sh.B * sh.KH), kKvThreads, s_kv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<B16*>(dk),
      static_cast<B16*>(dv), sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dq_wgmma<HD><<<dim3(n, sh.B * sh.H), kQThreads, s_q, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<B16*>(dq), sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16, hd 64, 96 or 128.  q, o, do, dq [B, H, S, hd]; k, v, dk, dv
// [B, KH, S, hd]: any strides with the last dim contiguous, q, k, v and
// do 16-byte aligned with strides of a multiple of 8 elements (the
// tensor maps'); strides holds (b, h, s) of q, k, v, o, do, dq, dk, dv
// in elements.  lse: float32 [B, H, S] from the forward; delta: a
// float32 [B, H, S] workspace, both contiguous.  Launches the three
// kernels on the stream and returns cudaGetLastError() after them.
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                              const void* o, const void* dO,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, const int64_t* strides,
                              int B, int H, int KH, int S, int hd,
                              int causal, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || S <= 0 ||
      (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  int64_t* dst[8] = {sh.q, sh.k, sh.v, sh.o, sh.dO, sh.dq, sh.dk, sh.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  sh.B = B;
  sh.H = H;
  sh.KH = KH;
  sh.S = S;
  sh.causal = causal;
  sh.scale = 1.0f / sqrtf((float)hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
    case 96: return launch<96>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
    case 128: return launch<128>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
