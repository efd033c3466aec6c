// Paged chunk attention (K1) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/paged_attention/kernel.py::paged_attention_chunk
// (pallas_call at kernel.py:171, body _chunk_kernel at kernel.py:80).
//
// What it computes: for each sequence b, T new query tokens; query t
// sits at position base_lens[b] + t and attends to every kv position
// <= base_lens[b] + t on a resident page (table[b, i] >= 0).  GQA packs
// the G = H / KH query heads of one kv head as rows r = t * G + g.
// Online softmax across pages, float32 scores and accumulators, output
// in the input type; a row that sees no valid key writes zeros.
//
// Bound on an H100: bytes.  The work per (row, key) is two dot products
// of length hd, so at serving shapes the kernel does a few FLOPs per
// byte of K/V it reads; the least time is (bytes of the live K/V pages
// + q + out) / 3.35 TB/s.
//
// Design (not the Pallas grid carried over block by block):
// * one thread block of 8 warps per (kv head, sequence); the block
//   reads its own table row and loops over the live pages only, up to
//   ceil((base + T) / psz), skipping dead pages (table < 0) instead of
//   loading page 0 as the TPU kernel does;
// * each [psz, hd] K and V page of the block's kv head is staged in
//   shared memory as float, with 16-byte loads where the layout allows
//   (K rows padded by one word, so lanes that read different keys hit
//   different banks);
// * the block's query rows (a tile of up to 64) are staged once in
//   shared memory.  They are split into row groups of up to 8 rows, and
//   the warps left over split each page's keys: a decode step (T = 1)
//   runs one row group on 8 key splits, a 64-token prefill chunk 8 row
//   groups on one split.  Each warp keeps its rows' running max m, sum
//   l and accumulator acc[hd] in float registers (lane owns dims
//   lane + 32 * e); the key splits merge through shared memory at the
//   end of the tile;
// * per page and row: each lane scores the keys lane, lane + 32, ... of
//   its split, a warp reduction gives their max, the probabilities go
//   through a per-warp shared buffer, and each lane adds p_j * V[j, d]
//   for its dims.
//
// A simple kernel that is right; wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T to floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage one [psz, hd] page of kv head kh (page stride psz * KH * hd,
// row stride KH * hd) into shared memory as float with row stride ld.
template <typename T>
__device__ __forceinline__ void stage_page(const T* __restrict__ src,
                                           float* dst, int ld, int psz,
                                           int KH, int hd, bool vec) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    for (int i = threadIdx.x; i < psz * hd / VE; i += kThreads) {
      const int j = i * VE / hd, d = i * VE % hd;
      float f[VE];
      load16(src + (size_t)j * KH * hd + d, f);
#pragma unroll
      for (int e = 0; e < VE; ++e) dst[j * ld + d + e] = f[e];
    }
  } else {
    for (int i = threadIdx.x; i < psz * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      dst[j * ld + d] = to_f(src[(size_t)j * KH * hd + d]);
    }
  }
}

// DPL: head dims per lane (hd <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_chunk_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int* __restrict__ table,
                             const int* __restrict__ base_lens,
                             T* __restrict__ out, int Tq, int H, int KH,
                             int hd, int psz, int maxp, float scale,
                             bool vec) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int R = Tq * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                       // [kTileRows][hd]
  float* Ps = Qs + kTileRows * hd;        // [kWarps][psz]
  float* Ks = Ps + kWarps * psz;          // [psz][hd + 1]
  float* Vs = Ks + psz * kstride;         // [psz][hd]
  // after the page loop the K/V area holds each warp's partial state:
  float* Ms = Ks;                         // [kWarps][kRowsPerWarp]
  float* Ls = Ms + kWarps * kRowsPerWarp;
  float* As = Ls + kWarps * kRowsPerWarp; // [kWarps][kRowsPerWarp][hd]

  const int base = base_lens[b];
  int n_live = (base + Tq + psz - 1) / psz;
  if (n_live > maxp) n_live = maxp;
  const int* trow = table + (size_t)b * maxp;
  const size_t page_elems = (size_t)psz * KH * hd;

  for (int tile = 0; tile < R; tile += kTileRows) {
    __syncthreads();  // the previous tile is done with shared memory
    const int rows = min(kTileRows, R - tile);
    for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
      const int rl = i / hd, d = i % hd;
      const int r = tile + rl;
      const int t = r / G, h = kh * G + r % G;
      Qs[rl * hd + d] = to_f(q[(((size_t)b * Tq + t) * H + h) * hd + d]);
    }
    // row groups of kRowsPerWarp rows; the spare warps split the keys
    const int groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
    const int splits = kWarps / groups;
    const int group = warp / splits, split = warp % splits;
    const bool busy = group < groups;
    const int keys = (psz + splits - 1) / splits;
    const int j0 = split * keys, j1 = min(psz, j0 + keys);

    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
    }

    for (int pi = 0; pi < n_live; ++pi) {
      const int page = trow[pi];
      if (page < 0) continue;  // dead page: block-uniform skip
      __syncthreads();         // previous page (and Qs fill) complete
      const size_t off = (size_t)page * page_elems + (size_t)kh * hd;
      stage_page(k_pages + off, Ks, kstride, psz, KH, hd, vec);
      stage_page(v_pages + off, Vs, hd, psz, KH, hd, vec);
      __syncthreads();
      if (!busy) continue;     // warp-uniform

      float* pw = Ps + warp * psz;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int rl = group * kRowsPerWarp + i;
        if (rl >= rows) continue;  // warp-uniform
        const int qpos = base + (tile + rl) / G;
        const float* qr = Qs + rl * hd;
        float pmax = -INFINITY;
        for (int j = j0 + lane; j < j1; j += 32) {
          const float* kr = Ks + j * kstride;
          float s = 0.f;
          for (int d = 0; d < hd; ++d) s += qr[d] * kr[d];
          s = (pi * psz + j <= qpos) ? s * scale : -INFINITY;
          pw[j] = s;
          pmax = fmaxf(pmax, s);
        }
        pmax = warp_max(pmax);
        if (pmax == -INFINITY) {  // no valid key of this row here
          __syncwarp();
          continue;
        }
        const float m_new = fmaxf(m[i], pmax);
        const float corr = expf(m[i] - m_new);
        float psum = 0.f;
        for (int j = j0 + lane; j < j1; j += 32) {
          const float p = expf(pw[j] - m_new);
          pw[j] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        __syncwarp();  // the probabilities are visible to the warp
        l[i] = l[i] * corr + psum;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
        for (int j = j0; j < j1; ++j) {
          const float p = pw[j];
          const float* vr = Vs + j * hd;
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < hd) acc[i][e] += p * vr[d];
          }
        }
        __syncwarp();  // pw is reused by the next row
      }
    }

    // merge the key splits of each row group, then write the rows
    __syncthreads();  // the K/V area is free
    if (busy) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int slot = warp * kRowsPerWarp + i;
        if (lane == 0) {
          Ms[slot] = m[i];
          Ls[slot] = l[i];
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) As[slot * hd + d] = acc[i][e];
        }
      }
    }
    __syncthreads();
    if (!busy || split != 0) continue;
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rl = group * kRowsPerWarp + i;
      if (rl >= rows) continue;
      float mx = -INFINITY;
      for (int s = 0; s < splits; ++s)
        mx = fmaxf(mx, Ms[(warp + s) * kRowsPerWarp + i]);
      float lsum = 0.f, o[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[e] = 0.f;
      if (mx != -INFINITY) {
        for (int s = 0; s < splits; ++s) {
          const int slot = (warp + s) * kRowsPerWarp + i;
          const float w = expf(Ms[slot] - mx);  // 0 for an empty split
          lsum += w * Ls[slot];
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < hd) o[e] += w * As[slot * hd + d];
          }
        }
      }
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
      const int r = tile + rl;
      const int t = r / G, h = kh * G + r % G;
      T* dst = out + (((size_t)b * Tq + t) * H + h) * hd;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) dst[d] = from_f<T>(o[e] * inv);
      }
    }
  }
}

size_t smem_bytes(int hd, int psz) {
  const size_t kv = (size_t)psz * (2 * hd + 1);
  const size_t merge = (size_t)kWarps * kRowsPerWarp * (hd + 2);
  return sizeof(float) * ((size_t)kTileRows * hd + (size_t)kWarps * psz +
                          (kv > merge ? kv : merge));
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* base, void* out, int B,
                   int Tq, int H, int KH, int hd, int psz, int maxp,
                   bool vec, cudaStream_t stream) {
  auto kern = paged_attention_chunk_kernel<T, DPL>;
  const size_t smem = smem_bytes(hd, psz);
  // fails when hd and psz need more shared memory than a block may have
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so a later launch does not report it
    return err;
  }
  dim3 grid(KH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, base, static_cast<T*>(out), Tq, H,
      KH, hd, psz, maxp, 1.f / sqrtf((float)hd), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* table, const int* base, void* out, int B,
                     int Tq, int H, int KH, int hd, int psz, int maxp,
                     cudaStream_t s) {
  // 16-byte page loads need 16-byte aligned rows
  const bool vec = (hd * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  if (hd <= 32)
    return launch<T, 1>(q, kp, vp, table, base, out, B, Tq, H, KH, hd, psz,
                        maxp, vec, s);
  if (hd <= 64)
    return launch<T, 2>(q, kp, vp, table, base, out, B, Tq, H, KH, hd, psz,
                        maxp, vec, s);
  if (hd <= 128)
    return launch<T, 4>(q, kp, vp, table, base, out, B, Tq, H, KH, hd, psz,
                        maxp, vec, s);
  return launch<T, 8>(q, kp, vp, table, base, out, B, Tq, H, KH, hd, psz,
                      maxp, vec, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: [B, T, H, hd]; k/v pages:
// [P, psz, KH, hd]; table: int32 [B, maxp]; base: int32 [B].  All
// contiguous.  Returns cudaGetLastError() after the launch.
int paged_attention_chunk(const void* q, const void* k_pages,
                          const void* v_pages, const int* table,
                          const int* base_lens, void* out, int dtype, int B,
                          int T, int H, int KH, int hd, int psz, int maxp,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 256 || H % KH != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(q, k_pages, v_pages, table, base_lens, out,
                                B, T, H, KH, hd, psz, maxp, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k_pages, v_pages, table,
                                        base_lens, out, B, T, H, KH, hd, psz,
                                        maxp, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
