// Single-token paged decode attention (K2) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_attention/kernel.py::paged_attention (pallas_call at
// kernel.py:227, body _kernel at kernel.py:31).
//
// What it computes: for each sequence b, one query token of H heads
// attends to every kv position p < seq_lens[b] whose page is resident
// (table[b, p / psz] >= 0).  GQA: query head h reads kv head
// h / (H / KH).  Float32 scores, online softmax and accumulators,
// output in the input type.  A row with no valid key returns the
// uniform mean of the V rows it gathers over all maxp pages (dead
// entries gather page 0), as the TPU kernel and its oracle do, or
// zeros when zero_empty is set (K1's convention, the serving path's).
//
// Bound on an H100: bytes.  Each key costs two dot products of length
// hd per query head, a few FLOPs per byte of K/V read; the least time
// is (bytes of the live K/V pages + q + out) / 3.35 TB/s.
//
// Design (not the Pallas grid carried over block by block, which
// walks all maxp pages of every row, dead ones as page 0):
// * one thread block of 8 warps per (kv head, sequence, group of up to
//   8 query heads); the block reads its own table row and only the
//   pages that hold valid keys, ceil(seq_len / psz) of them, dead ones
//   skipped;
// * the live pages are cut into units of up to 32 keys, and the warps
//   take the units round robin, each warp an independent online
//   softmax: no block-wide barrier inside the key loop;
// * in a unit, lane j scores key j against the block's query heads
//   (kept as float in shared memory, read as broadcasts), reading its
//   K row with 16-byte loads; the probabilities stay in registers and
//   go to the warp by shuffle while every lane adds p * V[j, d] for its
//   own dims, reading each V row once, coalesced;
// * each warp keeps, per query head, its running max m, sum l and its
//   dims of the accumulator in float registers; the warps merge through
//   shared memory at the end.
//
// The split of a lane's pages over several blocks, fed by TMA, is the
// tma route (paged_decode_tma.cu), which ops.py::decode_route picks for
// bf16 at hd 64, 96 and 128 (DECODE_TMA_HEAD_DIMS) with pages of 64;
// this kernel keeps float32, hd 16, pages of 8 and the other shapes,
// and takes bf16 hd 96 only when asked for by route="fma".

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnit = 32;  // keys per unit: one per lane

// N contiguous elements of T to floats; p aligned to N * sizeof(T)
// when that is at most 16 bytes, to 16 bytes otherwise.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    constexpr int VE = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < N / VE; ++k) load16(p + k * VE, out + k * VE);
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f(h[k]);
  } else if constexpr (BYTES == 4) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f(h[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f(p[k]);
  }
}

// This lane's DPL dims of one [hd] row: contiguous (lane * DPL + e) when
// hd == 32 * DPL and the rows are aligned, else strided (lane + 32 * e).
template <typename T, int DPL>
__device__ __forceinline__ void load_dims(const T* row, int hd, bool contig,
                                          int lane, float* out) {
  if (contig) {
    load_n<T, DPL>(row + lane * DPL, out);
  } else {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      out[e] = d < hd ? to_f(row[d]) : 0.f;
    }
  }
}

__device__ __forceinline__ int dim_of(bool contig, int lane, int e,
                                      int DPL) {
  return contig ? lane * DPL + e : lane + 32 * e;
}

// GC: query heads per block (a group of the G = H / KH heads of one kv
// head); DPL: head dims per lane (hd <= 32 * DPL).
template <typename T, int GC, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int KH, int hd, int psz, int maxp, float scale,
                    bool vec, bool contig, bool zero_empty) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int g0 = blockIdx.z * GC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* Qs = smem;                       // [GC][hd]
  float* Ms = Qs + GC * hd;               // [kWarps][GC]
  float* Ls = Ms + kWarps * GC;           // [kWarps][GC]
  float* As = Ls + kWarps * GC;           // [kWarps][GC][hd]

  const int seq = seq_lens[b];
  const int* trow = table + (size_t)b * maxp;
  int n_live = seq > 0 ? (seq + psz - 1) / psz : 0;
  if (n_live > maxp) n_live = maxp;
  const size_t row_stride = (size_t)KH * hd;        // elements per key
  const size_t page_elems = (size_t)psz * row_stride;
  const int upp = (psz + kUnit - 1) / kUnit;         // units per page

  // does the row see any valid key?  (a live page below n_live always
  // holds its first position, which is < seq)
  int found = 0;
  for (int i = threadIdx.x; i < n_live; i += kThreads)
    found |= trow[i] >= 0;
  const bool empty = !__syncthreads_or(found);

  T* orow = out + ((size_t)b * H + kh * G + g0) * hd;
  if (empty && zero_empty) {
    for (int i = threadIdx.x; i < GC * hd; i += kThreads)
      if (g0 + i / hd < G) orow[i] = from_f<T>(0.f);
    return;
  }

  float acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;

  if (empty) {
    // uniform mean over every gathered position of all maxp pages
    for (int u = warp; u < maxp * upp; u += kWarps) {
      const int page = max(trow[u / upp], 0);
      const int j0 = (u % upp) * kUnit;
      const int nk = min(kUnit, psz - j0);
      const T* vb = v_pages + (size_t)page * page_elems +
                    (size_t)j0 * row_stride + (size_t)kh * hd;
      for (int jj = 0; jj < nk; ++jj) {
        float v[DPL];
        load_dims<T, DPL>(vb + jj * row_stride, hd, contig, lane, v);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[0][e] += v[e];
      }
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = dim_of(contig, lane, e, DPL);
      if (d < hd) As[warp * GC * hd + d] = acc[0][e];
    }
    __syncthreads();
    const float inv = 1.f / ((float)maxp * (float)psz);
    for (int i = threadIdx.x; i < GC * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      if (g0 + g >= G) continue;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += As[w * GC * hd + d];
      orow[i] = from_f<T>(s * inv);
    }
    return;
  }

  // the block's query heads, as float, zero past G
  const T* qrow = q + ((size_t)b * H + kh * G + g0) * hd;
  for (int i = threadIdx.x; i < GC * hd; i += kThreads)
    Qs[i] = g0 + i / hd < G ? to_f(qrow[i]) : 0.f;
  __syncthreads();

  float m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  for (int u = warp; u < n_live * upp; u += kWarps) {
    const int pi = u / upp;
    const int page = trow[pi];
    if (page < 0) continue;               // dead page: warp-uniform skip
    const int j0 = (u % upp) * kUnit;
    const int nk = min(min(kUnit, psz - j0), seq - (pi * psz + j0));
    if (nk <= 0) continue;                // past seq_len: warp-uniform
    const size_t ubase = (size_t)page * page_elems +
                         (size_t)j0 * row_stride + (size_t)kh * hd;

    // scores: lane j owns key j0 + j
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    if (lane < nk) {
      const T* kr = k_pages + ubase + (size_t)lane * row_stride;
      if (vec) {
        constexpr int VE = 16 / sizeof(T);
#pragma unroll 4
        for (int d = 0; d < hd; d += VE) {
          float f[VE];
          load16(kr + d, f);
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int e = 0; e < VE; ++e) s[g] += f[e] * Qs[g * hd + d + e];
        }
      } else {
        for (int d = 0; d < hd; ++d) {
          const float f = to_f(kr[d]);
#pragma unroll
          for (int g = 0; g < GC; ++g) s[g] += f * Qs[g * hd + d];
        }
      }
    }
    float p[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float sg = lane < nk ? s[g] * scale : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sg));   // finite: nk >= 1
      const float corr = expf(m[g] - m_new);
      p[g] = expf(sg - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
    }

    // p @ V: every lane adds p_j * V[j, d] for its dims
    const T* vb = v_pages + ubase;
#pragma unroll 4
    for (int jj = 0; jj < nk; ++jj) {
      float v[DPL];
      load_dims<T, DPL>(vb + jj * row_stride, hd, contig, lane, v);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float pj = __shfl_sync(0xffffffffu, p[g], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] += pj * v[e];
      }
    }
  }

  // merge the warps' partial softmax states
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      Ms[warp * GC + g] = m[g];
      Ls[warp * GC + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = dim_of(contig, lane, e, DPL);
      if (d < hd) As[(warp * GC + g) * hd + d] = acc[g][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < GC * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    if (g0 + g >= G) continue;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Ms[w * GC + g]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(Ms[w * GC + g] - mx);   // 0 for an idle warp
      lsum += c * Ls[w * GC + g];
      o += c * As[(w * GC + g) * hd + d];
    }
    orow[i] = from_f<T>(o / lsum);
  }
}

size_t smem_bytes(int gc, int hd) {
  return sizeof(float) *
         ((size_t)gc * hd + 2 * (size_t)kWarps * gc +
          (size_t)kWarps * gc * hd);
}

template <typename T, int GC, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lens, void* out, int B,
                   int H, int KH, int hd, int psz, int maxp, bool vec,
                   bool zero_empty, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, GC, DPL>;
  const size_t smem = smem_bytes(GC, hd);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so a later launch does not report it
    return err;
  }
  const int G = H / KH;
  const bool contig = vec && hd == 32 * DPL;
  dim3 grid(KH, B, (G + GC - 1) / GC);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, static_cast<T*>(out), H, KH,
      hd, psz, maxp, 1.f / sqrtf((float)hd), vec, contig, zero_empty);
  return cudaGetLastError();
}

template <typename T, int GC>
cudaError_t by_hd(const void* q, const void* kp, const void* vp,
                  const int* table, const int* lens, void* out, int B, int H,
                  int KH, int hd, int psz, int maxp, bool zero_empty,
                  cudaStream_t s) {
  const bool vec = vec_ok<T>(kp, vp, hd);
  if (hd <= 32)
    return launch<T, GC, 1>(q, kp, vp, table, lens, out, B, H, KH, hd, psz,
                            maxp, vec, zero_empty, s);
  if (hd <= 64)
    return launch<T, GC, 2>(q, kp, vp, table, lens, out, B, H, KH, hd, psz,
                            maxp, vec, zero_empty, s);
  if (hd <= 128)
    return launch<T, GC, 4>(q, kp, vp, table, lens, out, B, H, KH, hd, psz,
                            maxp, vec, zero_empty, s);
  return launch<T, GC, 8>(q, kp, vp, table, lens, out, B, H, KH, hd, psz,
                          maxp, vec, zero_empty, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* table, const int* lens, void* out, int B,
                     int H, int KH, int hd, int psz, int maxp,
                     bool zero_empty, cudaStream_t s) {
  const int G = H / KH;
  if (G <= 1)
    return by_hd<T, 1>(q, kp, vp, table, lens, out, B, H, KH, hd, psz, maxp,
                       zero_empty, s);
  if (G <= 2)
    return by_hd<T, 2>(q, kp, vp, table, lens, out, B, H, KH, hd, psz, maxp,
                       zero_empty, s);
  if (G <= 4)
    return by_hd<T, 4>(q, kp, vp, table, lens, out, B, H, KH, hd, psz, maxp,
                       zero_empty, s);
  return by_hd<T, 8>(q, kp, vp, table, lens, out, B, H, KH, hd, psz, maxp,
                     zero_empty, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: [B, H, hd]; k/v pages:
// [P, psz, KH, hd]; table: int32 [B, maxp]; seq_lens: int32 [B].  All
// contiguous.  Returns cudaGetLastError() after the launch.
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const int* table, const int* seq_lens, void* out, int dtype,
                 int B, int H, int KH, int hd, int psz, int maxp,
                 int zero_empty, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 256 || H % KH != 0 || B <= 0 || maxp <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(q, k_pages, v_pages, table, seq_lens, out, B,
                                H, KH, hd, psz, maxp, zero_empty != 0, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k_pages, v_pages, table,
                                        seq_lens, out, B, H, KH, hd, psz,
                                        maxp, zero_empty != 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
