// Causal (or bidirectional) flash attention, backward (K6), for Hopper,
// sm_90a.
//
// Replaces: the JAX package has no backward kernel; it differentiates
// the jnp kernels/../models/attention.py::blockwise_attention
// (attention.py:53) with jax.grad.  This is the gradient of the forward
// in flash_attention.cu, the same function as flash_attention_bwd_ref
// in ref.py: from (q, k, v, o, lse, do), with P = exp(scale q k^T - lse)
// rebuilt from the forward's float32 log-sum-exp,
//   delta = rowsum(do * o),   dv = P^T do,   dP = do v^T,
//   dS = P * (dP - delta),    dq = scale dS k,   dk = scale dS^T q,
// float32 inside, dq, dk, dv written in the inputs' type; dk and dv sum
// over the G query heads of each kv head.  Causal mode drops the keys
// above the diagonal; any S; strided inputs with the last dim
// contiguous (the training step's transposed [B, S, H, hd] views).
//
// Bound on an H100 at the training shape (olmo-1b: B 4, H 16, S 2048,
// hd 128, causal, bf16): operations.  Five products of 2 hd flop per
// visible (query, key) pair and head (QK^T, dP, dV, dK, dQ), 10 B H hd
// S(S+1)/2 = 171.9 Gflop, 0.174 ms at 989 TFLOP/s; the bytes (q, k, v,
// o, do read, dq, dk, dv written, 33.5 MB each, and lse) take 0.080 ms.
//
// Design (FlashAttention-2's, simple first), three kernels a call, no
// atomics, so the gradient is the same bit for bit from run to run:
//
// fa_bwd_delta (flash_common.cuh): delta = rowsum(do * o) in float32
// [B, H, S], one warp a row.
//
// fa_bwd_dkdv: one block of four warps per (batch, kv head, 64-key
// tile), the heaviest causal tiles first.  K_j and V_j stay in shared
// memory; the block walks the G query heads of its kv head and the
// 64-row query tiles that can see the tile, Q_i and dO_i (and their
// lse, delta) double-buffered by cp.async.  Each warp owns 16 keys and
// accumulates dV and dK for them in registers: it rebuilds P^T = exp2(
// K Q^T scale log2 e - lse log2 e), adds P^T dO to dV, forms dP^T = V
// dO^T and dS^T = P^T (dP^T - delta), and adds dS^T Q to dK.
//
// fa_bwd_dq: one block of four warps per (batch, head, 64-row query
// tile), the heaviest first; Q_i and dO_i in shared memory, K_j and V_j
// double-buffered over the tiles the rows can see.  Each warp owns 16
// rows, rebuilds P and dS as above (the recomputation is the design's
// cost, not part of the bound) and accumulates dQ = dS K.
//
// bf16 (hd 16, 64, 128): the products on mma.sync m16n8k16 (bf16 in,
// float32 out), fragments by ldmatrix (.trans where the tile lies
// [k][n]), P and dS rounded to bf16 as the A operand of their products.
// No bf16 instance at hd 96: bf16 hd 96 takes the wgmma route, and no
// dispatch would reach one.
// float32 (hd 16, 64, 96, 128: the smoke configs, the tests, the
// float32 checks of full-width models): the same two-kernel walk with
// plain float32 FMAs, no TF32: a warp takes one row (key or query) at
// a time, its lanes over the 32 rows of the other side for the scores
// and over hd for the accumulation.  Not done yet: wgmma, TMA, and the
// overlap of one tile's loads with another's products beyond the
// double buffer.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace fa;

constexpr int kT = 64;           // rows of a query or key tile (bf16)
constexpr int kThreads = 128;

using Shape = BwdShape;     // flash_common.cuh, with fa_bwd_delta

// ------------------------------------------------------------ bf16 tiles

// Rows r0..r0+63 of one head of x (row stride rs, in elements) into a
// [64][ld] bf16 tile by 16-byte cp.async, zeros past S.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int r0, int S) {
  constexpr int LD = HD + 8, PER = HD / 8;       // 16-byte pieces a row
  for (int i = threadIdx.x; i < kT * PER; i += kThreads) {
    const int r = i / PER, c = (i % PER) * 8, s = r0 + r;
    const bool in = s < S;
    cp16(dst + r * LD + c, in ? src + s * rs + c : src, in);
  }
}

// dV, dK for 16 keys a warp over the query tiles of every head of the
// group.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, Shape sh) {
  constexpr int LD = HD + 8, TILE = kT * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + TILE;
  __nv_bfloat16* sQ = sV + TILE;                 // [2][TILE]
  __nv_bfloat16* sdO = sQ + 2 * TILE;            // [2][TILE]
  float* sL = reinterpret_cast<float*>(sdO + 2 * TILE);   // [2][kT]
  float* sD = sL + 2 * kT;                                 // [2][kT]

  const int k0 = blockIdx.x * kT;
  const int b = blockIdx.y / sh.KH, kh = blockIdx.y % sh.KH;
  const int G = sh.H / sh.KH;
  const int nq = (sh.S + kT - 1) / kT;
  const int i0 = sh.causal ? blockIdx.x : 0;     // first query tile
  const int per = nq - i0, n_it = G * per;
  const float sl2 = sh.scale * kLog2e;

  load_tile<HD>(sK, k + b * sh.k[0] + kh * sh.k[1], sh.k[2], k0, sh.S);
  load_tile<HD>(sV, v + b * sh.v[0] + kh * sh.v[1], sh.v[2], k0, sh.S);
  auto load_q = [&](int it, int buf) {
    const int h = kh * G + it / per, qt0 = (i0 + it % per) * kT;
    load_tile<HD>(sQ + buf * TILE, q + b * sh.q[0] + h * sh.q[1], sh.q[2],
                  qt0, sh.S);
    load_tile<HD>(sdO + buf * TILE, dO + b * sh.dO[0] + h * sh.dO[1],
                  sh.dO[2], qt0, sh.S);
    if (threadIdx.x < kT) {
      const int s = qt0 + threadIdx.x;
      const int64_t at = ((int64_t)b * sh.H + h) * sh.S + s;
      // rows past S: P = 0 (lse +inf), delta 0
      sL[buf * kT + threadIdx.x] = s < sh.S ? lse[at] * kLog2e : INFINITY;
      sD[buf * kT + threadIdx.x] = s < sh.S ? delta[at] : 0.f;
    }
  };
  load_q(0, 0);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = 16 * warp;                      // the warp's keys in the tile
  const int key0 = k0 + kw + g, key1 = key0 + 8;
  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) load_q(it + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Q = sQ + buf * TILE;
    const __nv_bfloat16* D = sdO + buf * TILE;
    const float* L2 = sL + buf * kT;
    const float* Dl = sD + buf * kT;
    const int qt0 = (i0 + it % per) * kT;

    // S^T = K Q^T (16 keys x 64 queries) and dP^T = V dO^T
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, sK, LD, kw, 16 * kk, lane);
      frag_a(av, sV, LD, kw, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4], bd[4];
        frag_b_nk(bq, Q, LD, 16 * np, 16 * kk, lane);
        frag_b_nk(bd, D, LD, 16 * np, 16 * kk, lane);
        mma_bf16(st[2 * np], ak, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[2 * np], av, bd[0], bd[1]);
        mma_bf16(dpt[2 * np + 1], av, bd[2], bd[3]);
      }
    }
    // P^T and dS^T: key rows key0, key1; query columns
    const bool edge = qt0 + kT > sh.S || k0 + kT > sh.S ||
                      (sh.causal && k0 + kT - 1 > qt0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t4 + (e & 1), key = e < 2 ? key0 : key1;
        float p = exp2f(st[n][e] * sl2 - L2[c]);
        if (edge && (key >= sh.S || qt0 + c >= sh.S ||
                     (sh.causal && key > qt0 + c)))
          p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - Dl[c]);
      }
    // dV += P^T dO, dK += dS^T Q: k-steps of 16 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ap[4] = {pack2(st[2 * kk][0], st[2 * kk][1]),
                              pack2(st[2 * kk][2], st[2 * kk][3]),
                              pack2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack2(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t as[4] = {pack2(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack2(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bd[4], bq[4];
        frag_b_kn(bd, D, LD, 16 * np, 16 * kk, lane);
        frag_b_kn(bq, Q, LD, 16 * np, 16 * kk, lane);
        mma_bf16(adv[2 * np], ap, bd[0], bd[1]);
        mma_bf16(adv[2 * np + 1], ap, bd[2], bd[3]);
        mma_bf16(adk[2 * np], as, bq[0], bq[1]);
        mma_bf16(adk[2 * np + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();                 // every warp is done with this buffer
  }

  __nv_bfloat16* dkb = dk + b * sh.dk[0] + kh * sh.dk[1];
  __nv_bfloat16* dvb = dv + b * sh.dv[0] + kh * sh.dv[1];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int d = 8 * n + 2 * t4;
    if (key0 < sh.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * sh.dk[2] + d) =
          __floats2bfloat162_rn(adk[n][0] * sh.scale, adk[n][1] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * sh.dv[2] + d) =
          __floats2bfloat162_rn(adv[n][0], adv[n][1]);
    }
    if (key1 < sh.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * sh.dk[2] + d) =
          __floats2bfloat162_rn(adk[n][2] * sh.scale, adk[n][3] * sh.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * sh.dv[2] + d) =
          __floats2bfloat162_rn(adv[n][2], adv[n][3]);
    }
  }
}

// dQ for 16 query rows a warp over the key tiles the rows can see.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dO,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, Shape sh) {
  constexpr int LD = HD + 8, TILE = kT * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + TILE;
  __nv_bfloat16* sK = sdO + TILE;                // [2][TILE]
  __nv_bfloat16* sV = sK + 2 * TILE;             // [2][TILE]

  const int nq = (sh.S + kT - 1) / kT;
  const int qt = nq - 1 - (int)blockIdx.x, q0 = qt * kT;
  const int b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KH);
  const int n_it = sh.causal ? qt + 1 : nq;
  const float sl2 = sh.scale * kLog2e;
  const __nv_bfloat16* kb = k + b * sh.k[0] + kh * sh.k[1];
  const __nv_bfloat16* vb = v + b * sh.v[0] + kh * sh.v[1];

  load_tile<HD>(sQ, q + b * sh.q[0] + h * sh.q[1], sh.q[2], q0, sh.S);
  load_tile<HD>(sdO, dO + b * sh.dO[0] + h * sh.dO[1], sh.dO[2], q0, sh.S);
  load_tile<HD>(sK, kb, sh.k[2], 0, sh.S);
  load_tile<HD>(sV, vb, sh.v[2], 0, sh.S);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw = 16 * warp;
  const int row0 = q0 + qw + g, row1 = row0 + 8;
  const int64_t at = ((int64_t)b * sh.H + h) * sh.S;
  const float l2[2] = {row0 < sh.S ? lse[at + row0] * kLog2e : INFINITY,
                       row1 < sh.S ? lse[at + row1] * kLog2e : INFINITY};
  const float dl[2] = {row0 < sh.S ? delta[at + row0] : 0.f,
                       row1 < sh.S ? delta[at + row1] : 0.f};
  float adq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1, kt0 = it * kT;
    if (it + 1 < n_it) {
      load_tile<HD>(sK + (buf ^ 1) * TILE, kb, sh.k[2], kt0 + kT, sh.S);
      load_tile<HD>(sV + (buf ^ 1) * TILE, vb, sh.v[2], kt0 + kT, sh.S);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* K = sK + buf * TILE;
    const __nv_bfloat16* V = sV + buf * TILE;

    // S = Q K^T and dP = dO V^T (16 rows x 64 keys)
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a(aq, sQ, LD, qw, 16 * kk, lane);
      frag_a(ad, sdO, LD, qw, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        frag_b_nk(bk, K, LD, 16 * np, 16 * kk, lane);
        frag_b_nk(bv, V, LD, 16 * np, 16 * kk, lane);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    const bool edge = kt0 + kT > sh.S || (sh.causal && kt0 + kT - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = kt0 + 8 * n + 2 * t4 + (e & 1);
        float p = exp2f(s[n][e] * sl2 - l2[r]);
        if (edge && (col >= sh.S || (sh.causal && col > (r ? row1 : row0))))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - dl[r]);
      }
    // dQ += dS K: k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t as[4] = {pack2(dp[2 * kk][0], dp[2 * kk][1]),
                              pack2(dp[2 * kk][2], dp[2 * kk][3]),
                              pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bk[4];
        frag_b_kn(bk, K, LD, 16 * np, 16 * kk, lane);
        mma_bf16(adq[2 * np], as, bk[0], bk[1]);
        mma_bf16(adq[2 * np + 1], as, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dqb = dq + b * sh.dq[0] + h * sh.dq[1];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int d = 8 * n + 2 * t4;
    if (row0 < sh.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * sh.dq[2] + d) =
          __floats2bfloat162_rn(adq[n][0] * sh.scale, adq[n][1] * sh.scale);
    if (row1 < sh.S)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * sh.dq[2] + d) =
          __floats2bfloat162_rn(adq[n][2] * sh.scale, adq[n][3] * sh.scale);
  }
}

// --------------------------------------------------------------- float32

constexpr int kFK = 16;          // keys (dk/dv) or query rows (dq) a block
constexpr int kFT = 32;          // rows a staged tile of the other side
constexpr int kRPW = kFK / 4;    // rows a warp

// Stage rows r0..r0+n-1 of one head (row stride rs) into a [n][ld]
// float tile, zeros past S.
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          int64_t rs, int r0, int n, int S) {
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = r0 + r;
    dst[r * ld + d] = s < S ? src[s * rs + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, Shape sh) {
  constexpr int LD = HD + 1, NPER = (HD + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);   // [kFK][HD]
  float* sV = sK + kFK * HD;                    // [kFK][HD]
  float* sQ = sV + kFK * HD;                    // [kFT][LD]
  float* sdO = sQ + kFT * LD;                   // [kFT][LD]
  float* sL = sdO + kFT * LD;                   // [kFT]
  float* sD = sL + kFT;                         // [kFT]

  const int k0 = blockIdx.x * kFK;
  const int b = blockIdx.y / sh.KH, kh = blockIdx.y % sh.KH;
  const int G = sh.H / sh.KH;
  const int nq = (sh.S + kFT - 1) / kFT;
  const int i0 = sh.causal ? k0 / kFT : 0;
  stage_f32<HD>(sK, HD, k + b * sh.k[0] + kh * sh.k[1], sh.k[2], k0, kFK,
                sh.S);
  stage_f32<HD>(sV, HD, v + b * sh.v[0] + kh * sh.v[1], sh.v[2], k0, kFK,
                sh.S);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float adk[kRPW][NPER], adv[kRPW][NPER];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr)
#pragma unroll
    for (int i = 0; i < NPER; ++i) adk[rr][i] = adv[rr][i] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    const int64_t at = ((int64_t)b * sh.H + h) * sh.S;
    for (int it = i0; it < nq; ++it) {
      const int qt0 = it * kFT;
      __syncthreads();
      stage_f32<HD>(sQ, LD, q + b * sh.q[0] + h * sh.q[1], sh.q[2], qt0, kFT,
                    sh.S);
      stage_f32<HD>(sdO, LD, dO + b * sh.dO[0] + h * sh.dO[1], sh.dO[2], qt0,
                    kFT, sh.S);
      if (threadIdx.x < kFT) {
        const int s = qt0 + threadIdx.x;
        sL[threadIdx.x] = s < sh.S ? lse[at + s] : 0.f;
        sD[threadIdx.x] = s < sh.S ? delta[at + s] : 0.f;
      }
      __syncthreads();
      const int qi = qt0 + lane;               // the lane's query
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const int j = warp * kRPW + rr, key = k0 + j;
        const float* qr = sQ + lane * LD;
        const float* dr = sdO + lane * LD;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qr[d], sK[j * HD + d], s);
          dp = fmaf(dr[d], sV[j * HD + d], dp);
        }
        const bool vis = qi < sh.S && key < sh.S && (!sh.causal || key <= qi);
        const float p = vis ? expf(s * sh.scale - sL[lane]) : 0.f;
        const float ds = p * (dp - sD[lane]);
#pragma unroll 8
        for (int c = 0; c < kFT; ++c) {
          const float pc = __shfl_sync(0xffffffffu, p, c);
          const float dc = __shfl_sync(0xffffffffu, ds, c);
#pragma unroll
          for (int i = 0; i < NPER; ++i) {
            const int d = lane + 32 * i;
            if (d < HD) {
              adv[rr][i] = fmaf(pc, sdO[c * LD + d], adv[rr][i]);
              adk[rr][i] = fmaf(dc, sQ[c * LD + d], adk[rr][i]);
            }
          }
        }
      }
    }
  }
  float* dkb = dk + b * sh.dk[0] + kh * sh.dk[1];
  float* dvb = dv + b * sh.dv[0] + kh * sh.dv[1];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int key = k0 + warp * kRPW + rr;
    if (key >= sh.S) continue;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        dkb[key * sh.dk[2] + d] = adk[rr][i] * sh.scale;
        dvb[key * sh.dv[2] + d] = adv[rr][i];
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Shape sh) {
  constexpr int LD = HD + 1, NPER = (HD + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [kFK][HD]
  float* sdO = sQ + kFK * HD;                   // [kFK][HD]
  float* sK = sdO + kFK * HD;                   // [kFT][LD]
  float* sV = sK + kFT * LD;                    // [kFT][LD]

  const int nb = (sh.S + kFK - 1) / kFK;
  const int q0 = (nb - 1 - (int)blockIdx.x) * kFK;
  const int b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KH);
  const int nk = (sh.S + kFT - 1) / kFT;
  const int n_it = sh.causal ? min(nk, (q0 + kFK - 1) / kFT + 1) : nk;
  stage_f32<HD>(sQ, HD, q + b * sh.q[0] + h * sh.q[1], sh.q[2], q0, kFK,
                sh.S);
  stage_f32<HD>(sdO, HD, dO + b * sh.dO[0] + h * sh.dO[1], sh.dO[2], q0, kFK,
                sh.S);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t at = ((int64_t)b * sh.H + h) * sh.S;
  float adq[kRPW][NPER];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr)
#pragma unroll
    for (int i = 0; i < NPER; ++i) adq[rr][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int kt0 = it * kFT;
    __syncthreads();
    stage_f32<HD>(sK, LD, k + b * sh.k[0] + kh * sh.k[1], sh.k[2], kt0, kFT,
                  sh.S);
    stage_f32<HD>(sV, LD, v + b * sh.v[0] + kh * sh.v[1], sh.v[2], kt0, kFT,
                  sh.S);
    __syncthreads();
    const int key = kt0 + lane;                 // the lane's key
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int r = warp * kRPW + rr, row = q0 + r;
      const float* kr = sK + lane * LD;
      const float* vr = sV + lane * LD;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        s = fmaf(sQ[r * HD + d], kr[d], s);
        dp = fmaf(sdO[r * HD + d], vr[d], dp);
      }
      const bool vis = row < sh.S && key < sh.S && (!sh.causal || key <= row);
      const float ds = vis ? expf(s * sh.scale - lse[at + row]) *
                                 (dp - delta[at + row])
                           : 0.f;
#pragma unroll 8
      for (int c = 0; c < kFT; ++c) {
        const float dc = __shfl_sync(0xffffffffu, ds, c);
#pragma unroll
        for (int i = 0; i < NPER; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) adq[rr][i] = fmaf(dc, sK[c * LD + d], adq[rr][i]);
        }
      }
    }
  }
  float* dqb = dq + b * sh.dq[0] + h * sh.dq[1];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int row = q0 + warp * kRPW + rr;
    if (row >= sh.S) continue;
#pragma unroll
    for (int i = 0; i < NPER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dqb[row * sh.dq[2] + d] = adq[rr][i] * sh.scale;
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, float* lse, float* delta, void* dq, void* dk,
           void* dv, const Shape& sh, cudaStream_t stream) {
  const int64_t rows = (int64_t)sh.B * sh.H * sh.S;
  fa_bwd_delta<T, HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (sizeof(T) == 2) {
    using B16 = __nv_bfloat16;
    constexpr size_t tile = (size_t)kT * (HD + 8) * 2;
    const size_t s_kv = 6 * tile + 4 * kT * 4, s_q = 6 * tile;
    const int n = (sh.S + kT - 1) / kT;
    if ((err = smem_attr(fa_bwd_dkdv_bf16<HD>, s_kv)) != cudaSuccess ||
        (err = smem_attr(fa_bwd_dq_bf16<HD>, s_q)) != cudaSuccess)
      return (int)err;
    fa_bwd_dkdv_bf16<HD><<<dim3(n, sh.B * sh.KH), kThreads, s_kv, stream>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k),
        static_cast<const B16*>(v), static_cast<const B16*>(dO), lse, delta,
        static_cast<B16*>(dk), static_cast<B16*>(dv), sh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fa_bwd_dq_bf16<HD><<<dim3(n, sh.B * sh.H), kThreads, s_q, stream>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k),
        static_cast<const B16*>(v), static_cast<const B16*>(dO), lse, delta,
        static_cast<B16*>(dq), sh);
  } else {
    const size_t s_kv = (2 * kFK * HD + 2 * kFT * (HD + 1) + 2 * kFT) * 4;
    const size_t s_q = (2 * kFK * HD + 2 * kFT * (HD + 1)) * 4;
    const int n = (sh.S + kFK - 1) / kFK;
    if ((err = smem_attr(fa_bwd_dkdv_f32<HD>, s_kv)) != cudaSuccess ||
        (err = smem_attr(fa_bwd_dq_f32<HD>, s_q)) != cudaSuccess)
      return (int)err;
    fa_bwd_dkdv_f32<HD><<<dim3(n, sh.B * sh.KH), kThreads, s_kv, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), sh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fa_bwd_dq_f32<HD><<<dim3(n, sh.B * sh.H), kThreads, s_q, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dO), lse,
        delta, static_cast<float*>(dq), sh);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dO, float* lse, float* delta,
              void* dq, void* dk, void* dv, const Shape& sh,
              cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
    case 64: return launch<T, 64>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
    case 96:    // float32 only (phi-3-vision's float32 checks)
      if constexpr (sizeof(T) == 4)
        return launch<T, 96>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
      return (int)cudaErrorInvalidValue;
    case 128: return launch<T, 128>(q, k, v, o, dO, lse, delta, dq, dk, dv, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, do, dq [B, H, S, hd]; k, v, dk, dv [B, KH, S, hd]: any strides
// with the last dim contiguous (bf16 rows 16-byte aligned); strides
// holds (b, h, s) of q, k, v, o, do, dq, dk, dv in elements.  lse:
// float32 [B, H, S] from the forward; delta: a float32 [B, H, S]
// workspace, both contiguous.  dtype 0 float32 (hd in {16, 64, 96,
// 128}), 1 bfloat16 (hd in {16, 64, 128}).  Launches the three kernels
// on the stream and returns cudaGetLastError() after them.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, float* lse,
                        float* delta, void* dq, void* dk, void* dv,
                        const int64_t* strides, int dtype, int B, int H,
                        int KH, int S, int hd, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || S <= 0 || dtype < 0 ||
      dtype > 1 || (int64_t)B * H > 65535)
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
  return dtype == 1
             ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, dO, lse, delta, dq,
                                        dk, dv, sh, st)
             : launch_hd<float>(hd, q, k, v, o, dO, lse, delta, dq, dk, dv,
                                sh, st);
}

}  // extern "C"
