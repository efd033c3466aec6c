// Paged chunk attention (K1), the wgmma/TMA route, for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_attention/kernel.py::paged_attention_chunk
// (pallas_call at kernel.py:171), for bf16 at hd 64, 96 and 128 with
// pages of 64 tokens (olmo-1b, llama3.2-1b, gemma3-27b, phi-3-vision).
// The float32, hd 16 and page-8 shapes take paged_attention.cu;
// ops.py::chunk_route states the dispatch.
//
// What it computes: the function of paged_attention.cu.  For each
// sequence b, T new query tokens; query t sits at position base[b] + t
// and attends to every kv position <= base[b] + t on a resident page
// (table[b, i] >= 0).  GQA packs the G = H / KH query heads of one kv
// head as rows r = t * G + g.  float32 scores and softmax, output in
// bf16; a row that sees no valid key writes zeros.
//
// Bound on an H100: bytes (the live K/V pages once, q and out; a few
// flops a byte).  The present kernel spends roughly 8 bytes of
// shared-memory reads on each scalar float FMA and overlaps no load
// with compute; this one keeps the bytes moving and the products on the
// tensor cores.
//
// Design.  A block of 288 threads per (pair of 64-row tiles, kv head,
// sequence): two consumer warpgroups and one producer warp.
// * The producer reads the sequence's table row, skips dead pages
//   (table < 0, the same for the whole block) and keeps a ring of
//   kStages K/V page stages full by TMA: one box of the 4-d map over
//   the pool (hd, slot, kv head, page) is one page of one kv head, 64
//   keys x 64 columns, 128-byte swizzled; full mbarriers count the
//   bytes, empty ones one arrival from each consumer warp.
// * Each consumer warpgroup gathers its 64 query rows once with 16-byte
//   cp.async into a 128-byte-swizzled tile (rows of one tile come from
//   T tokens of G heads, not one box), runs S = Q K^T as wgmma
//   m64n64k16 with both operands in shared memory, masks the pages that
//   reach past base + t (pi * 64 + j <= base + t), keeps the online
//   softmax in registers with exp2, and runs O += P V as wgmma
//   m64n{hd, padded}k16 with P as the register operand split into bf16
//   hi and lo (one-ulp parity with the float32 plain version, as in K6)
//   and V read MN-major, as it lies in the pool.
// * hd 96 (phi-3-vision): tiles padded to two 64-column atoms, as in
//   K6's forward.  The page maps are built on the true hd, so the box at
//   column 64 lands 32 real columns and 32 zeros (no HBM bytes past the
//   row); the gather writes zeros to the rest of Q's second atom; QK^T
//   runs the 6 k-steps of the true hd, PV m64n128k16 over the padded V,
//   whose zero columns give outputs that are never stored; the scale
//   stays 1 / sqrt(96).
// * Evening out the lanes: with one row tile (T * G <= 64, e.g. olmo-1b
//   at T = 64) the two warpgroups own the same rows and split the
//   lane's live pages, even and odd, and merge through shared memory at
//   the end in a fixed order (no atomics: two calls are bit-equal);
//   with more tiles each warpgroup owns its own and reads every page.
//   A warpgroup skips a page its rows cannot see but still releases it.
// Not done yet: no overlap of a warpgroup's softmax with its next QK^T.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;       // query rows of a warpgroup; keys of a page
constexpr int kStages = 4;      // K/V page stages in the ring
constexpr int kThreads = 288;   // 2 consumer warpgroups + 1 producer warp

template <int HD>
struct Layout {
  // Q: a tile per warpgroup, [kAtoms][64 rows][64]; a stage: K then V,
  // each [kAtoms][64 keys][64]; every atom 8 KB, 128-byte swizzled.  hd
  // is padded to whole atoms (kPad; HD / 64 atoms at 64 and 128).  After
  // the page loop the ring holds the merge.
  static constexpr int kAtoms = (HD + 63) / 64;
  static constexpr int kPad = kAtoms * 64;
  static constexpr int kAtom = kTile * 128;
  static constexpr int kQBytes = kAtoms * kAtom;
  static constexpr int kTileBytes = kAtoms * kAtom;     // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static_assert((kPad / 2 + 4) * 128 * 4 <= kStages * kStageBytes,
                "the merge fits in the ring");
};

struct Args {
  const __nv_bfloat16* q;     // [B, T, H, hd]
  __nv_bfloat16* out;         // like q
  const int* table;           // [B, maxp]
  const int* base;            // [B]
  int T, H, KH, G, maxp, n_tiles;
  float sl2;                  // 1 / sqrt(hd) * log2(e)
};

// The 64 rows r0 .. r0 + 63 of (b, kh) -- row r is token r / G of head
// kh * G + r % G -- into the swizzled tile at sQ, by the 128 threads of
// one warpgroup (tid 0..127): two threads a row, 32 bytes apart.  The
// chunks past hd (the padding of the last atom) are written as zeros.
template <int HD>
__device__ __forceinline__ void gather_q(uint32_t sQ, const Args& a, int b,
                                         int kh, int r0, int tid) {
  const int rl = tid >> 1, r = r0 + rl;
  const bool in = r < a.T * a.G;
  const __nv_bfloat16* src =
      in ? a.q + (((size_t)b * a.T + r / a.G) * a.H + kh * a.G + r % a.G) * HD
         : a.q;
#pragma unroll
  for (int k = 0; k < Layout<HD>::kPad / 16; ++k) {
    const int c = 2 * k + (tid & 1);          // 16-byte chunk of the row
    const bool real = in && c < HD / 8;
    cp16(sQ + (c / 8) * Layout<HD>::kAtom + sw128_chunk(rl, c % 8),
         real ? src + 8 * c : src, real);
  }
  cp_commit();
}

// Accumulator layout of m64nN (per warp the m16n8 layout, repeated over
// N / 8): register i of lane (g = lane / 4, t = lane % 4) of warp w
// holds row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
k1_wgmma(const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, Args a) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sbase + L::kRing;
  const uint32_t full = sbase + L::kBars, empty = full + 8 * kStages;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // one row tile: the warpgroups split the pages; else the tiles
  const bool split = a.n_tiles == 1;
  const int base = a.base[b];
  const int n_live = min(a.maxp, (base + a.T + kTile - 1) / kTile);
  const int* trow = a.table + (size_t)b * a.maxp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: the live pages of the lane, in table order
    if (lane == 0) {
      int i = 0;
      for (int pi = 0; pi < n_live; ++pi) {
        const int page = trow[pi];
        if (page < 0) continue;
        const int st = i % kStages, ph = (i / kStages) & 1;
        mbar_wait(empty + 8 * st, ph ^ 1);
        mbar_expect_tx(full + 8 * st, L::kStageBytes);
        const uint32_t sK = ring + st * L::kStageBytes,
                       sV = sK + L::kTileBytes;
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sK + at * L::kAtom, &tk, full + 8 * st, at * 64, 0, kh,
                   page);
          tma_load(sV + at * L::kAtom, &tv, full + 8 * st, at * 64, 0, kh,
                   page);
        }
        ++i;
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int tile = split ? 0 : 2 * blockIdx.x + wg;
  const bool rows_live = tile < a.n_tiles;
  const int r0 = tile * kTile, R = a.T * a.G;
  const uint32_t sQ = sbase + wg * L::kQBytes;
  if (rows_live) gather_q<HD>(sQ, a, b, kh, r0, tid);
  cp_wait<0>();
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  const int g = lane >> 2, t4 = lane & 3;
  const int lr0 = (warp % 4) * 16 + g;          // tile rows lr0, lr0 + 8
  // the last kv position each of the thread's two rows may see
  const int lim[2] = {base + (r0 + lr0) / a.G, base + (r0 + lr0 + 8) / a.G};
  const int t_lo = r0 / a.G, t_hi = min(a.T - 1, (r0 + kTile - 1) / a.G);

  // O over the padded width; columns past HD stay zero and are not
  // merged or stored
  float acc[L::kPad / 2];
#pragma unroll
  for (int i = 0; i < L::kPad / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int i = 0;
  for (int pi = 0; pi < n_live; ++pi) {
    if (trow[pi] < 0) continue;
    const int st = i % kStages, ph = (i / kStages) & 1;
    const bool mine = rows_live && (!split || (i & 1) == wg) &&
                      pi * kTile <= base + t_hi;
    mbar_wait(full + 8 * st, ph);
    if (mine) {
      const uint32_t sK = ring + st * L::kStageBytes, sV = sK + L::kTileBytes;
      // S = Q K^T over the true hd in steps of 16 (32 bytes within a
      // 128-byte atom; the next atom after four)
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4), in = (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(sQ + off * L::kAtom + in, 16, 1024),
                     sw128_desc(sK + off * L::kAtom + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      // the causal mask, on the pages that reach past base + t_lo
      const int k0 = pi * kTile;
      const bool edge = k0 + kTile - 1 > base + t_lo;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        float x = s[j] * a.sl2;
        if (edge && k0 + 8 * (j >> 2) + 2 * t4 + (j & 1) > lim[r])
          x = -INFINITY;
        s[j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no valid key yet keeps p = 0 (exp2(-inf - 0))
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        corr[r] = exp2f(m[r] - ms[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < L::kPad / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = exp2f(s[j] - ms[(j >> 1) & 1]);
        l[(j >> 1) & 1] += s[j];
      }
      // P as the A fragments of four k-steps of 16 keys, hi and lo
      uint32_t ph_[4][4], pl_[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph_[kk][j],
                 pl_[kk][j]);
      // O += P V over the padded width: V MN-major, 16 keys a step
      // (2,048 bytes), the second 64-column atom LBO = one atom's bytes
      // away, 8-key groups 1 KB
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(sV + kk * 2048, L::kAtom, 1024);
        wgmma_pv<L::kPad>(acc, ph_[kk], dv);
        wgmma_pv<L::kPad>(acc, pl_[kk], dv);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
      reg_fence(ph_);
      reg_fence(pl_);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    ++i;
  }

  if (split) {
    // warpgroup 1 hands its (m, l, acc) to warpgroup 0 through the ring
    // (every stage has landed and been read once both pass the barrier);
    // thread tid of both holds the same rows and columns
    float* mg = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
    bar_sync(3, 256);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) mg[j * 128 + tid] = acc[j];
      mg[(HD / 2) * 128 + tid] = m[0];
      mg[(HD / 2 + 1) * 128 + tid] = m[1];
      mg[(HD / 2 + 2) * 128 + tid] = l[0];
      mg[(HD / 2 + 3) * 128 + tid] = l[1];
    }
    bar_sync(3, 256);
    if (wg == 1) return;
    float w0[2], w1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = mg[(HD / 2 + r) * 128 + tid];
      const float mx = fmaxf(m[r], m1);
      const float ms = mx == -INFINITY ? 0.f : mx;
      w0[r] = exp2f(m[r] - ms);
      w1[r] = exp2f(m1 - ms);
      l[r] = l[r] * w0[r] + mg[(HD / 2 + 2 + r) * 128 + tid] * w1[r];
    }
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) {
      const int r = (j >> 1) & 1;
      acc[j] = acc[j] * w0[r] + mg[j * 128 + tid] * w1[r];
    }
  }
  if (!rows_live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int r = (j >> 1) & 1, row = r0 + lr0 + 8 * r;
    if (row >= R) continue;
    // a row that saw no valid key: l = 0, zeros
    const float x = l[r] > 0.f ? acc[j] / l[r] : 0.f;
    const float y = l[r] > 0.f ? acc[j + 1] / l[r] : 0.f;
    __nv_bfloat16* dst =
        a.out + (((size_t)b * a.T + row / a.G) * a.H + kh * a.G + row % a.G) *
                    HD +
        8 * (j >> 2) + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
}

template <int HD>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* base, void* out, int B, int T, int H, int KH, int maxp,
           int P, cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!page_map(&tk, kp, P, KH, HD) || !page_map(&tv, vp, P, KH, HD))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.table = table;
  a.base = base;
  a.T = T;
  a.H = H;
  a.KH = KH;
  a.G = H / KH;
  a.maxp = maxp;
  a.n_tiles = (T * a.G + kTile - 1) / kTile;
  a.sl2 = kLog2e / sqrtf((float)HD);
  const int smem = Layout<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      k1_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_tiles == 1 ? 1 : (a.n_tiles + 1) / 2, KH, B);
  k1_wgmma<HD><<<grid, kThreads, smem, stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 only.  q/out: [B, T, H, hd]; k/v pages: [P, psz, KH, hd] with
// psz 64 and hd 64, 96 or 128; table: int32 [B, maxp]; base: int32 [B].  All
// contiguous, q and the pools 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
int paged_attention_chunk_wgmma(const void* q, const void* k_pages,
                                const void* v_pages, const int* table,
                                const int* base_lens, void* out, int B, int T,
                                int H, int KH, int hd, int psz, int maxp,
                                int P, void* stream) {
  if (psz != kTile || KH <= 0 || H % KH != 0 || B <= 0 || B > 65535 ||
      KH > 65535 || T <= 0 || P <= 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k_pages, v_pages, table, base_lens, out, B,
                               T, H, KH, maxp, P, s);
    case 96: return launch<96>(q, k_pages, v_pages, table, base_lens, out, B,
                               T, H, KH, maxp, P, s);
    case 128: return launch<128>(q, k_pages, v_pages, table, base_lens, out,
                                 B, T, H, KH, maxp, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
