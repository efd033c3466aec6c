// Single-token paged decode attention (K2), the TMA route: a split-page
// kernel fed by TMA and a merge, for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_attention/kernel.py::paged_attention (pallas_call at
// kernel.py:227), for bf16 at hd 64, 96 and 128 with pages of 64 tokens
// and G = H / KH of 1, 2, 3, 4, 5 or 8 (olmo-1b, llama3.2-1b, gemma3-27b,
// phi-3-vision, phi4-mini-3.8b at G 3, llama4-maverick at G 5).  The
// float32, hd 16 and page-8 shapes take paged_decode.cu;
// ops.py::decode_route states the dispatch.
//
// What it computes: the function of paged_decode.cu.  For each sequence
// b, one query token of H heads attends to every kv position p <
// seq_lens[b] whose page is resident (table[b, p / 64] >= 0); query
// head h reads kv head h / G.  Float32 scores, online softmax and
// accumulators, output in bf16.  A row with no valid key returns the
// uniform mean of the V rows it gathers over all maxp pages (dead
// entries gather page 0), or zeros when zero_empty is set.
//
// Bound on an H100: bytes (the live K/V pages once, q and out; a few
// flops a byte).  paged_decode.cu runs one block per (kv head, lane),
// 128 blocks at olmo-1b's B 8 for 132 SMs, each walking its lane's
// whole context with synchronous loads: the longest lane sets the time
// and few bytes are in flight.  This route spreads each lane over many
// blocks and keeps whole pages in flight.
//
// Design.
// * A lane's pages -- its live ones, ceil(seq / 64), or all maxp of a
//   lane without a valid key that takes the uniform mean -- are cut
//   into splits of pages_per_split pages.  The grid is (KH, B,
//   ceil(maxp / pages_per_split)), fixed by maxp: no host sync.  A
//   block past its lane's last split exits at once (lane_schedule, the
//   same in both kernels and in ops.decode_splits).
// * A block of one producer warp and four consumer warps.  The
//   producer walks the split's pages in table order, skips dead ones,
//   and keeps a ring of K/V page stages (64 KB) full by TMA: one box of
//   the 4-d map over the pool (hd, slot, kv head, page) is one page of
//   one kv head, 128-byte swizzled; full mbarriers count the bytes,
//   empty ones one arrival from each consumer warp.
// * The consumers score and accumulate from shared memory on CUDA
//   cores: a G-row query does not fill a 64-row wgmma tile.  hd / 8
//   lanes share a key, each a 16-byte chunk of its row (no bank
//   conflict under the swizzle), and sum their partial dot products by
//   shuffles; each warp takes a quarter of every page's keys and keeps
//   its own online softmax (exp2, scores prescaled by log2 e / sqrt hd),
//   and the G query rows share each page read.
// * The warps merge through shared memory.  A lane with one split
//   writes its output; otherwise each split writes its partial (m, l,
//   acc[hd]) to a float32 workspace and a second kernel merges a lane's
//   splits in split order.  No atomics: two calls are bit-equal.
// * hd 96 (phi-3-vision) runs over tiles padded to two 64-column
//   swizzle atoms, as K1 and K6 do: the map is built on the true hd, so
//   the box at column 64 brings 32 real columns and 32 zeros (TMA's
//   fill past the row; the mbarrier counts the whole box).  The padded
//   width kHDP sets everything that tiles (atoms, stages, hd / 8 lanes
//   a key); the true width sets everything that indexes memory (q and
//   out rows, the workspace, the merge).  Lanes 12-15 of a key hold
//   zero q and read zero K and V columns, so their partial dot products
//   and accumulators stay zero; they read no q and write nothing.  The
//   scale stays 1 / sqrt(96).  At hd 64 and 128 kHDP == HD.
// * The tensor maps are encoded per call (ops.py says what that costs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kPage = 64;                        // tokens a page
constexpr int kConsumers = 4;                    // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp

// HD the true head dim (memory), kHDP the padded one (tiles)
template <int HD, int G>
struct Layout {
  static constexpr int kHDP = ((HD + 63) / 64) * 64;
  static constexpr int kAtoms = kHDP / 64;
  static constexpr int kTile = kAtoms * kPage * 128;   // K or V of a page
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStages = kAtoms == 2 ? 2 : 4;  // a 64 KB ring
  static constexpr int kMerge = kStages * kStage;      // the warps' states
  static constexpr int kML = HD + 2;                   // acc, m, l
  static constexpr int kBars = kMerge + 4 * kConsumers * G * kML;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static constexpr int kCH = kHDP / 8;                 // lanes a key
  static constexpr int kReal = HD / 8;                 // chunks with data
  static constexpr int kKPW = 32 / kCH;                // keys a warp a pass
  static constexpr int kPasses = kPage / (kConsumers * kKPW);
};

struct Args {
  const __nv_bfloat16* q;   // [B, H, hd]
  __nv_bfloat16* out;       // [B, H, hd]
  const int* table;         // [B, maxp]
  const int* lens;          // [B]
  float* part_acc;          // [B, H, nsplit, hd]
  float* part_ml;           // [B, H, nsplit, 2]: m (log2 units), l
  int H, KH, maxp, pps, nsplit, zero_empty;
  float sl2;                // log2(e) / sqrt(hd)
};

// The pages lane b walks and its number of splits, by all the block's
// threads: its live pages, ceil(seq / 64) of them; or, when none of
// them is resident (no valid key), none with zero_empty and all maxp
// for the uniform mean otherwise.
struct Lane {
  int seq, n_pages, splits;
  bool empty;
};
__device__ __forceinline__ Lane lane_schedule(const Args& a, int b) {
  Lane ln;
  ln.seq = max(a.lens[b], 0);
  const int n_live = min(a.maxp, (ln.seq + kPage - 1) / kPage);
  const int* trow = a.table + (size_t)b * a.maxp;
  int found = 0;
  for (int i = threadIdx.x; i < n_live; i += blockDim.x) found |= trow[i] >= 0;
  ln.empty = !__syncthreads_or(found);
  ln.n_pages = ln.empty ? (a.zero_empty ? 0 : a.maxp) : n_live;
  ln.splits = (ln.n_pages + a.pps - 1) / a.pps;
  return ln;
}

// The page of table entry pi this lane reads, or -1 to skip it: dead
// pages are skipped, except by the uniform mean, which gathers page 0.
__device__ __forceinline__ int page_of(const int* trow, int pi, bool empty) {
  const int page = trow[pi];
  return page >= 0 ? page : (empty ? 0 : -1);
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
k2_split(const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, Args a) {
  using L = Layout<HD, G>;
  constexpr int CH = L::kCH, KPW = L::kKPW, NP = L::kPasses;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base_ptr = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) -
                                        smem_u32(smem_raw));
  const uint32_t ring = smem_u32(base_ptr);
  const uint32_t full = ring + L::kBars, empty_bar = full + 8 * L::kStages;
  const int kh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane ln = lane_schedule(a, b);
  const size_t row0 = (size_t)b * a.H + (size_t)kh * G;   // first head row

  if (ln.n_pages == 0) {                  // no valid key and zero_empty
    if (z == 0)
      for (int i = threadIdx.x; i < G * HD; i += kThreads)
        a.out[row0 * HD + i] = __float2bfloat16(0.f);
    return;
  }
  if (z >= ln.splits) return;
  const int p0 = z * a.pps, p1 = min(p0 + a.pps, ln.n_pages);
  const int* trow = a.table + (size_t)b * a.maxp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // the producer: the split's pages in table order
    if (lane == 0) {
      int i = 0;
      for (int pi = p0; pi < p1; ++pi) {
        const int page = page_of(trow, pi, ln.empty);
        if (page < 0) continue;
        const int st = i % L::kStages, ph = (i / L::kStages) & 1;
        mbar_wait(empty_bar + 8 * st, ph ^ 1);
        mbar_expect_tx(full + 8 * st, L::kStage);
        const uint32_t sK = ring + st * L::kStage, sV = sK + L::kTile;
        for (int at = 0; at < L::kAtoms; ++at) {
          tma_load(sK + at * kPage * 128, &tk, full + 8 * st, at * 64, 0, kh,
                   page);
          tma_load(sV + at * kPage * 128, &tv, full + 8 * st, at * 64, 0, kh,
                   page);
        }
        ++i;
      }
    }
    return;
  }

  // a consumer lane: chunk c (dims 8 c .. 8 c + 7) of keys kg + 8 ip
  // (hd 96 and 128: two keys a warp a pass) or kg + 16 ip (hd 64: four);
  // chunks past the true hd hold zero q
  const int c = lane % CH;
  const int kg = warp * KPW + lane / CH;
  const uint32_t coff = (c / 8) * kPage * 128;
  const bool real = L::kReal == CH || c < L::kReal;
  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = real ? *reinterpret_cast<const uint4*>(
        a.q + (row0 + g) * HD + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      qv[g][2 * e] = f.x;
      qv[g][2 * e + 1] = f.y;
    }
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  int i = 0;
  for (int pi = p0; pi < p1; ++pi) {
    if (page_of(trow, pi, ln.empty) < 0) continue;
    const int st = i % L::kStages, ph = (i / L::kStages) & 1;
    mbar_wait(full + 8 * st, ph);
    const unsigned char* sK = base_ptr + st * L::kStage;
    const unsigned char* sV = sK + L::kTile;
    float s[G][NP];
#pragma unroll
    for (int ip = 0; ip < NP; ++ip) {
      const int j = kg + kConsumers * KPW * ip;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          sK + coff + sw128_chunk(j, c % 8));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float k8[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        k8[2 * e] = f.x;
        k8[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d += qv[g][e] * k8[e];
        s[g][ip] = d;
      }
    }
    // the CH lanes of a key sum their chunks
#pragma unroll
    for (int o = 1; o < CH; o <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int ip = 0; ip < NP; ++ip)
          s[g][ip] += __shfl_xor_sync(0xffffffffu, s[g][ip], o);
    // mask (the uniform mean scores every key 0) and the online softmax
    float ms[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int ip = 0; ip < NP; ++ip) {
        const int pos = pi * kPage + kg + kConsumers * KPW * ip;
        s[g][ip] = ln.empty ? 0.f
                            : (pos < ln.seq ? s[g][ip] * a.sl2 : -INFINITY);
        mx = fmaxf(mx, s[g][ip]);
      }
#pragma unroll
      for (int o = CH; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[g], mx);
      // no valid key yet: keep p = 0 (exp2(-inf - 0))
      ms[g] = mn == -INFINITY ? 0.f : mn;
      const float corr = exp2f(m[g] - ms[g]);
      m[g] = mn;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int ip = 0; ip < NP; ++ip) {
        s[g][ip] = exp2f(s[g][ip] - ms[g]);
        l[g] += s[g][ip];
      }
    }
    // p V: each lane its chunk of its keys' V rows
#pragma unroll
    for (int ip = 0; ip < NP; ++ip) {
      const int j = kg + kConsumers * KPW * ip;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          sV + coff + sw128_chunk(j, c % 8));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g][2 * e] += s[g][ip] * f.x;
          acc[g][2 * e + 1] += s[g][ip] * f.y;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    ++i;
  }

  // the warp's key groups share m: sum their l and acc
#pragma unroll
  for (int o = CH; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  float* mg = reinterpret_cast<float*>(base_ptr + L::kMerge);
  if (lane < L::kReal) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* dst = mg + (warp * G + g) * L::kML;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[8 * c + e] = acc[g][e];
      if (c == 0) {
        dst[HD] = m[g];
        dst[HD + 1] = l[g];
      }
    }
  }
  bar_sync(1, 32 * kConsumers);
  // the warps merged in warp order; a lane of one split writes its rows
  for (int idx = threadIdx.x; idx < G * HD; idx += 32 * kConsumers) {
    const int g = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      mx = fmaxf(mx, mg[(w * G + g) * L::kML + HD]);
    const float mref = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float* src = mg + (w * G + g) * L::kML;
      const float wt = exp2f(src[HD] - mref);
      lsum += wt * src[HD + 1];
      o += wt * src[d];
    }
    if (ln.splits == 1) {
      a.out[(row0 + g) * HD + d] = __float2bfloat16(o / lsum);
    } else {
      const size_t slot = (row0 + g) * a.nsplit + z;
      a.part_acc[slot * HD + d] = o;
      if (d == 0) {
        a.part_ml[2 * slot] = mx;
        a.part_ml[2 * slot + 1] = lsum;
      }
    }
  }
}

// A lane's splits merged in split order, one block of hd threads per
// (head, lane); lanes of one split (or none) were written already.
template <int HD>
__global__ void __launch_bounds__(HD) k2_merge(Args a) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const Lane ln = lane_schedule(a, b);
  if (ln.splits <= 1) return;
  const size_t row = (size_t)b * a.H + head;
  const float* ml = a.part_ml + 2 * row * a.nsplit;
  const float* pa = a.part_acc + row * a.nsplit * HD;
  float mx = -INFINITY;
  for (int s = 0; s < ln.splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  const float mref = mx == -INFINITY ? 0.f : mx;
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < ln.splits; ++s) {
    const float wt = exp2f(ml[2 * s] - mref);
    lsum += wt * ml[2 * s + 1];
    o += wt * pa[(size_t)s * HD + d];
  }
  a.out[row * HD + d] = __float2bfloat16(o / lsum);
}

template <int HD, int G>
int launch(const void* kp, const void* vp, Args a, int B, int P,
           cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!page_map(&tk, kp, P, a.KH, HD) || !page_map(&tv, vp, P, a.KH, HD))
    return (int)cudaErrorInvalidValue;
  a.sl2 = kLog2e / sqrtf((float)HD);
  const int smem = Layout<HD, G>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      k2_split<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k2_split<HD, G><<<dim3(a.KH, B, a.nsplit), kThreads, smem, stream>>>(tk, tv,
                                                                      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_merge<HD><<<dim3(a.H, B), HD, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int by_g(const void* kp, const void* vp, const Args& a, int B, int P,
         cudaStream_t s) {
  switch (a.H / a.KH) {
    case 1: return launch<HD, 1>(kp, vp, a, B, P, s);
    case 2: return launch<HD, 2>(kp, vp, a, B, P, s);
    case 3: return launch<HD, 3>(kp, vp, a, B, P, s);
    case 4: return launch<HD, 4>(kp, vp, a, B, P, s);
    case 5: return launch<HD, 5>(kp, vp, a, B, P, s);
    case 8: return launch<HD, 8>(kp, vp, a, B, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bfloat16 only.  q/out: [B, H, hd]; k/v pages: [P, psz, KH, hd] with
// psz 64 and hd 64, 96 or 128, H / KH in {1, 2, 3, 4, 5, 8}; table:
// int32 [B, maxp]; seq_lens: int32 [B]; workspace: float32, B H nsplit
// (hd + 2) values, nsplit = ceil(maxp / pages_per_split).  All contiguous, q and
// the pools 16-byte aligned.  Launches the split kernel, then the merge;
// returns cudaGetLastError() after them.
int paged_decode_tma(const void* q, const void* k_pages, const void* v_pages,
                     const int* table, const int* seq_lens, void* out,
                     float* workspace, int B, int H, int KH, int hd, int psz,
                     int maxp, int P, int pages_per_split, int zero_empty,
                     void* stream) {
  if (psz != kPage || KH <= 0 || H % KH != 0 || B <= 0 || B > 65535 ||
      KH > 65535 || maxp <= 0 || P <= 0 || pages_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.table = table;
  a.lens = seq_lens;
  a.H = H;
  a.KH = KH;
  a.maxp = maxp;
  a.pps = pages_per_split;
  a.nsplit = (maxp + pages_per_split - 1) / pages_per_split;
  a.zero_empty = zero_empty != 0;
  a.part_acc = workspace;
  a.part_ml = workspace + (size_t)B * H * a.nsplit * hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return by_g<64>(k_pages, v_pages, a, B, P, s);
    case 96: return by_g<96>(k_pages, v_pages, a, B, P, s);
    case 128: return by_g<128>(k_pages, v_pages, a, B, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
