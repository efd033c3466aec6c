// Page-grouped verify attention (K3), the wgmma/TMA route, for Hopper,
// sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/verify_attention/kernel.py::verify_attention (pallas_call at
// kernel.py:173), for bf16 at hd 64 and 128 with pages of 64 tokens.
// The float32, hd 16 and page-8 shapes take verify_attention.cu;
// ops.py::verify_route states the dispatch.
//
// What it computes: the function of K1 (paged_attention.cu).  For each
// lane b, T query tokens; query t sits at position base[b] + t and
// attends to every kv position <= base[b] + t on a resident page.  GQA
// packs the G = H / KH query heads of one kv head as rows r = t * G + g.
// float32 scores and softmax, output in bf16; a row that sees no valid
// key writes zeros.
//
// What it keeps of K3: the work items (page, lane, slot) sorted by
// physical page (schedule.py), so the lanes that map a hot prefix page
// are neighbours and the page is read from device memory once per kv
// head for all of them (its later tiles find it in L2), and the two
// passes: per-page partial states (m, l, acc) in a float32 workspace,
// then a merge of each row's partials in fixed slot order, no atomics.
//
// Bound on an H100: bytes (q, out and each DISTINCT live page once).
// The present kernel puts every row of a run on one block, so at T = 64
// the 512 rows of a page that 8 lanes share queue on one block's 8
// warps as scalar FMAs.
//
// Design.  A work unit is (run of equal pages, tile of up to 64 of the
// run's rows); the rows of a run are its lanes' (t, g) rows stacked lane
// after lane.  The unit list is built on the device (schedule.py::
// build_verify_units: (first item, items, tile) per unit, a dead tail
// marked first = -1), so a hot page's 512 rows at T = 64 are 8 units
// that run on 8 warpgroups, and 8 lanes at T = 5 (40 rows) are one.
// A block of 160 threads per kv head -- one consumer warpgroup and one
// producer warp -- strides over the units of a fixed grid and stops at
// the dead tail:
// * the producer loads each unit's K and V page of the block's kv head
//   by TMA (the 4-d map over (hd, slot, kv head, page), one box a page,
//   128-byte swizzle) into a ring of two stages with full/empty
//   mbarriers;
// * the consumer gathers the unit's Q rows (they come from several
//   lanes, so no one box) with 16-byte cp.async into a 128-byte-swizzled
//   tile, runs S = Q K^T as wgmma m64n64k16 from shared memory, masks
//   each row to its lane's causal window (slot * 64 + j <= base + t),
//   takes the page's softmax in registers with exp2, runs O = P V as
//   wgmma m64n{hd}k16 with P split into bf16 hi and lo (one-ulp parity,
//   as in K6) and V read MN-major, and writes each row's partial (m in
//   natural-log units, l, acc) where kernel A of verify_attention.cu
//   writes it.
// Two blocks fit on an SM, so one block's loads and partial writes
// overlap the other's products.
//
// The merge (k3_merge): one warp per (lane, kv head, row), each thread
// hd / 32 consecutive columns; the max of m over the lane's live slots
// 32 slots at a time, then the slots in ascending order four at a time,
// their loads issued before their sums, so that every row's partials
// are in flight at once (the present kernel's merge, a warp walking
// rows and slots one load at a time, read the workspace at a fifth of
// the memory's rate at T = 64).  The same operations per output
// element, in the same order, as verify_attention.cu's merge.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;       // rows of a unit; keys of a page
constexpr int kStages = 2;      // K/V page stages in the ring
constexpr int kThreads = 160;   // 1 consumer warpgroup + 1 producer warp

template <int HD>
struct Layout {
  // Q: [HD / 64 atoms][64 rows][64]; a stage: K then V, each
  // [HD / 64 atoms][64 keys][64]; every atom 8 KB, 128-byte swizzled.
  static constexpr int kAtoms = HD / 64;
  static constexpr int kAtom = kTile * 128;
  static constexpr int kQBytes = kAtoms * kAtom;
  static constexpr int kTileBytes = kAtoms * kAtom;     // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRing = kQBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
};

struct Args {
  const __nv_bfloat16* q;     // [B, T, H, hd]
  const int* base;            // [B]
  const int* pages;           // the schedule: [B * maxp] each
  const int* lanes;
  const int* slots;
  const int* units;           // [n_units, 3]: first item, items, tile
  float* part_acc;            // [B, maxp, KH, T * G, hd]
  float* part_ml;             // [B, maxp, KH, T * G, 2]
  int n_units, T, H, KH, G, maxp;
  float sl2;                  // 1 / sqrt(hd) * log2(e)
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
k3_wgmma(const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, Args a) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = sbase, ring = sbase + L::kRing;
  const uint32_t full = sbase + L::kBars, empty = full + 8 * kStages;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int TG = a.T * a.G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: each unit's page, in the block's unit order
    if (lane == 0) {
      int k = 0;
      for (int u = blockIdx.x; u < a.n_units; u += gridDim.x, ++k) {
        const int first = a.units[3 * u];
        if (first < 0) break;                      // the dead tail
        const int page = a.pages[first];
        const int st = k % kStages, ph = (k / kStages) & 1;
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
      }
    }
    return;
  }

  // the consumer warpgroup
  const int tid = threadIdx.x;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr0 = warp * 16 + g;                // tile rows lr0, lr0 + 8
  int k = 0;
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x, ++k) {
    const int first = a.units[3 * u];
    if (first < 0) break;
    const int n_rows = a.units[3 * u + 1] * TG;
    const int rho0 = a.units[3 * u + 2] * kTile;  // the tile's first row

    // gather the tile's Q rows: run row rho is row rho % TG of item
    // first + rho / TG; two threads a row, 32 bytes apart
    bar_sync(1, 128);             // the last unit's QK^T is done with sQ
    {
      const int rl = tid >> 1, rho = rho0 + rl;
      const bool in = rho < n_rows;
      const __nv_bfloat16* src = a.q;
      if (in) {
        const int r = rho % TG, b = a.lanes[first + rho / TG];
        src += (((size_t)b * a.T + r / a.G) * a.H + kh * a.G + r % a.G) * HD;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = 2 * kk + (tid & 1);
        cp16(sQ + (c / 8) * L::kAtom + sw128_chunk(rl, c % 8),
             in ? src + 8 * c : src, in);
      }
      cp_commit();
    }
    // each of the thread's two rows: its lane's window on this page and
    // where its partial goes (-1: a row past the run)
    int lim[2];
    int64_t prow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rho = rho0 + lr0 + 8 * r;
      lim[r] = -1;
      prow[r] = -1;
      if (rho < n_rows) {
        const int item = first + rho / TG, rr = rho % TG;
        const int b = a.lanes[item], s = a.slots[item];
        lim[r] = a.base[b] + rr / a.G - s * kTile;
        prow[r] = (((int64_t)b * a.maxp + s) * a.KH + kh) * TG + rr;
      }
    }
    cp_wait<0>();
    fence_proxy_async();
    bar_sync(1, 128);

    const int st = k % kStages, ph = (k / kStages) & 1;
    mbar_wait(full + 8 * st, ph);
    const uint32_t sK = ring + st * L::kStageBytes, sV = sK + L::kTileBytes;
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

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      const float x = 8 * (j >> 2) + 2 * t4 + (j & 1) <= lim[r]
                          ? s[j] * a.sl2 : -INFINITY;
      s[j] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float ms[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that sees no key of this page: p = 0, l = 0, m = -inf
      ms[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = exp2f(s[j] - ms[(j >> 1) & 1]);
      l[(j >> 1) & 1] += s[j];
    }
    uint32_t ph_[4][4], pl_[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], ph_[kk][j],
               pl_[kk][j]);
    float acc[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(sV + kk * 2048, L::kAtom, 1024);
      wgmma_pv<HD>(acc, ph_[kk], dv);
      wgmma_pv<HD>(acc, pl_[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc);
    reg_fence(ph_);
    reg_fence(pl_);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);

    // the partials, as kernel A of verify_attention.cu writes them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (prow[r] >= 0 && t4 == 0) {
        a.part_ml[2 * prow[r]] = mx[r] * kLn2;
        a.part_ml[2 * prow[r] + 1] = l[r];
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 2; j += 2) {
      const int r = (j >> 1) & 1;
      if (prow[r] < 0) continue;
      *reinterpret_cast<float2*>(a.part_acc + prow[r] * HD + 8 * (j >> 2) +
                                 2 * t4) = make_float2(acc[j], acc[j + 1]);
    }
  }
}

// Rows (lane b, kv head kh, row r) of the merge, one warp each: the
// lane's partials in ascending slot order with the log-sum-exp rule; a
// row with no valid key writes zeros.
template <int HD>
__global__ void __launch_bounds__(256)
k3_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
         const int* __restrict__ table, const int* __restrict__ base,
         __nv_bfloat16* __restrict__ out, int B, int T, int H, int KH,
         int maxp) {
  constexpr int V = HD / 32;              // columns a thread
  constexpr int U = 4;                    // slots in flight a warp
  const int TG = T * (H / KH);
  const int lane = threadIdx.x % 32;
  const int64_t id = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (id >= (int64_t)B * KH * TG) return;
  const int r = id % TG, kh = (id / TG) % KH, b = id / ((int64_t)TG * KH);
  const int n_live = min(maxp, (base[b] + T + kTile - 1) / kTile);
  const int* trow = table + (size_t)b * maxp;
  // partial row of slot s: row0 + s * stride
  const int64_t stride = (int64_t)KH * TG;
  const int64_t row0 = (int64_t)b * maxp * stride + (int64_t)kh * TG + r;

  float mx = -INFINITY;
  for (int s = lane; s < n_live; s += 32)
    if (trow[s] >= 0) mx = fmaxf(mx, part_ml[2 * (row0 + s * stride)]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float o[V], lsum = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) o[e] = 0.f;
  if (mx != -INFINITY) {
    for (int s0 = 0; s0 < n_live; s0 += U) {
      float ml[U][2], acc[U][V];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = s0 + u;
        live[u] = s < n_live && trow[s] >= 0;
        if (!live[u]) continue;
        const int64_t row = row0 + s * stride;
        const float2 m_l = *reinterpret_cast<const float2*>(part_ml + 2 * row);
        ml[u][0] = m_l.x;
        ml[u][1] = m_l.y;
        const float* src = part_acc + row * HD + V * lane;
        if constexpr (V == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          acc[u][0] = x.x; acc[u][1] = x.y; acc[u][2] = x.z; acc[u][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          acc[u][0] = x.x; acc[u][1] = x.y;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
        const float w = expf(ml[u][0] - mx);   // 0 for m = -inf
        lsum += w * ml[u][1];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] += w * acc[u][e];
      }
    }
  }
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  const int t = r / (H / KH), h = kh * (H / KH) + r % (H / KH);
  __nv_bfloat16* dst = out + (((size_t)b * T + t) * H + h) * HD + V * lane;
#pragma unroll
  for (int e = 0; e < V; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(dst + e) =
        __floats2bfloat162_rn(o[e] * inv, o[e + 1] * inv);
}

int n_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int HD>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* base, const int* pages, const int* lanes,
           const int* slots, const int* units, int n_units, float* work,
           void* out, int B, int T, int H, int KH, int maxp, int P,
           cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!page_map(&tk, kp, P, KH, HD) || !page_map(&tv, vp, P, KH, HD))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.base = base;
  a.pages = pages;
  a.lanes = lanes;
  a.slots = slots;
  a.units = units;
  a.n_units = n_units;
  a.T = T;
  a.H = H;
  a.KH = KH;
  a.G = H / KH;
  a.maxp = maxp;
  a.sl2 = kLog2e / sqrtf((float)HD);
  const size_t part_rows = (size_t)B * maxp * KH * T * a.G;
  a.part_acc = work;
  a.part_ml = work + part_rows * HD;
  const int smem = Layout<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      k3_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // a fixed grid: about two blocks an SM over the kv heads
  int per_head = (2 * n_sms() + KH - 1) / KH;
  if (per_head > n_units) per_head = n_units;
  k3_wgmma<HD><<<dim3(per_head, KH), kThreads, smem, stream>>>(tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the merge: a warp a (lane, kv head, row), 8 a block
  const int64_t rows = (int64_t)B * KH * T * a.G;
  k3_merge<HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      a.part_acc, a.part_ml, table, base, static_cast<__nv_bfloat16*>(out),
      B, T, H, KH, maxp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16 only.  q/out: [B, T, H, hd]; k/v pages: [P, psz, KH, hd] with
// psz 64 and hd 64 or 128; table: int32 [B, maxp]; base: int32 [B];
// pages/lanes/slots: int32 [B * maxp], the schedule of schedule.py built
// from this table, base, T and psz; units: int32 [n_units, 3], the unit
// list schedule.py builds from that schedule, T and G; work: float32, at
// least B * maxp * KH * T * (H / KH) * (hd + 2) elements.  All
// contiguous, q and the pools 16-byte aligned.  Launches the partials
// kernel then the merge on the stream; returns cudaGetLastError() after
// the launches.
int verify_attention_wgmma(const void* q, const void* k_pages,
                           const void* v_pages, const int* table,
                           const int* base_lens, const int* pages,
                           const int* lanes, const int* slots,
                           const int* units, float* work, void* out,
                           int n_units, int B, int T, int H, int KH, int hd,
                           int psz, int maxp, int P, void* stream) {
  if (psz != kTile || KH <= 0 || H % KH != 0 || B <= 0 || B > 65535 ||
      KH > 65535 || T <= 0 || P <= 0 || maxp <= 0 || n_units <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k_pages, v_pages, table, base_lens, pages,
                               lanes, slots, units, n_units, work, out, B, T,
                               H, KH, maxp, P, s);
    case 128: return launch<128>(q, k_pages, v_pages, table, base_lens,
                                 pages, lanes, slots, units, n_units, work,
                                 out, B, T, H, KH, maxp, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
