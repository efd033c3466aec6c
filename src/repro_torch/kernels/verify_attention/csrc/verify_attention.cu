// Page-grouped verify attention (K3) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/verify_attention/kernel.py::verify_attention (pallas_call at
// kernel.py:173, body _verify_kernel at kernel.py:72).
//
// What it computes: the function of K1 (paged_attention.cu).  For each
// lane b, T query tokens; query t sits at position base_lens[b] + t and
// attends to every kv position <= base_lens[b] + t on a resident page.
// GQA packs the G = H / KH query heads of one kv head as rows
// r = t * G + g.  float32 scores and softmax, output in the input type;
// a row that sees no valid key writes zeros.
//
// What it is for: the work items (page, lane, slot) arrive sorted by
// physical page id (schedule.py), so lanes whose tables share a hot
// prefix page are neighbours, and each such page is read from device
// memory once per kv head for all the lanes that map it, where K1 reads
// it once per lane.
//
// Bound on an H100: bytes.  The least time is (q + out + the K and V of
// each DISTINCT live page) / 3.35 TB/s (ops.py::bound_bytes).
//
// Design.  The TPU kernel keeps all B * T * G accumulator rows resident
// in VMEM across a sequential grid over the items.  At B 8, T 64, hd 128
// that is 256 KiB of float accumulators per kv head, more than a block's
// 227 KiB of shared memory, and blocks do not run in order anyway.  So
// the online softmax is split in two passes:
// * kernel A (partials): a block per (run of equal pages, kv head)
//   stages that page's K and V tile in shared memory once, then each
//   warp takes (item, row) pairs of the run and writes the row's
//   partial state over this page -- max m, sum l and the unnormalised
//   accumulator acc[hd] -- to a float32 buffer indexed by (lane, slot,
//   kv head, row).  A row whose window misses the page writes
//   m = -inf, l = 0.  Blocks stride over the items; a block skips an
//   item that does not start a run, and stops at the first dead item
//   (dead items sit at the tail of the schedule);
// * kernel B (merge): a block per (lane, kv head) combines that lane's
//   partials in ascending slot order with the log-sum-exp rule, without
//   atomics, so the output does not depend on the order in which blocks
//   ran.  It visits exactly the items the schedule marks live: resident
//   slots s < ceil((base + T) / psz).
//
// The route of the float32, hd 16 and page-8 shapes (the smoke
// configs); bf16 at hd 64 and 128 with pages of 64 takes
// verify_attention_wgmma.cu (ops.py states the dispatch).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// blocks of kernel A along the item axis (each strides over the items)
constexpr int kItemBlocks = 64;

// DPL: head dims per lane (hd <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
verify_partials_kernel(const T* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ base_lens,
                       const int* __restrict__ pages,
                       const int* __restrict__ lanes,
                       const int* __restrict__ slots, int n_items,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int Tq, int H, int KH,
                       int hd, int psz, int maxp, float scale, bool vec) {
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int TG = Tq * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* Ks = smem;                   // [psz][hd + 1]
  float* Vs = Ks + psz * kstride;     // [psz][hd]
  float* qw = Vs + psz * hd + warp * hd;                   // [hd]
  float* pw = Vs + psz * hd + kWarps * hd + warp * psz;    // [psz]
  const size_t page_elems = (size_t)psz * KH * hd;

  for (int i0 = blockIdx.x; i0 < n_items; i0 += gridDim.x) {
    const int page = pages[i0];
    if (page < 0) break;                             // the dead tail
    if (i0 > 0 && pages[i0 - 1] == page) continue;   // not a run start
    int n = 1;
    while (i0 + n < n_items && pages[i0 + n] == page) ++n;

    __syncthreads();  // the previous run is done with the tiles
    const size_t off = (size_t)page * page_elems + (size_t)kh * hd;
    stage_page(k_pages + off, Ks, kstride, psz, KH, hd, vec, kThreads);
    stage_page(v_pages + off, Vs, hd, psz, KH, hd, vec, kThreads);
    __syncthreads();

    for (int w = warp; w < n * TG; w += kWarps) {
      const int item = i0 + w / TG;
      const int r = w % TG;
      const int b = lanes[item], s = slots[item];
      const int t = r / G, h = kh * G + r % G;
      const T* qr = q + (((size_t)b * Tq + t) * H + h) * hd;
      for (int d = lane; d < hd; d += 32) qw[d] = to_f(qr[d]);
      // keys j of this page with kv position s * psz + j <= base + t
      const int n_valid =
          max(0, min(psz, base_lens[b] + t - s * psz + 1));
      __syncwarp();  // the query row is visible to the warp

      float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
      if (n_valid > 0) {  // warp-uniform
        float pmax = -INFINITY;
        for (int j = lane; j < n_valid; j += 32) {
          const float* kr = Ks + j * kstride;
          float sc = 0.f;
          for (int d = 0; d < hd; ++d) sc += qw[d] * kr[d];
          sc *= scale;
          pw[j] = sc;
          pmax = fmaxf(pmax, sc);
        }
        m = warp_max(pmax);
        float psum = 0.f;
        for (int j = lane; j < n_valid; j += 32) {
          const float p = expf(pw[j] - m);
          pw[j] = p;
          psum += p;
        }
        l = warp_sum(psum);
        __syncwarp();  // the probabilities are visible to the warp
        for (int j = 0; j < n_valid; ++j) {
          const float p = pw[j];
          const float* vr = Vs + j * hd;
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < hd) acc[e] += p * vr[d];
          }
        }
      }
      const size_t row = (((size_t)b * maxp + s) * KH + kh) * TG + r;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) part_acc[row * hd + d] = acc[e];
      }
      if (lane == 0) {
        part_ml[2 * row] = m;
        part_ml[2 * row + 1] = l;
      }
      __syncwarp();  // qw and pw are reused by the warp's next row
    }
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
verify_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ table,
                    const int* __restrict__ base_lens, T* __restrict__ out,
                    int Tq, int H, int KH, int hd, int psz, int maxp) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int TG = Tq * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the live slots of the lane, as schedule.py marks them
  const int n_live = min(maxp, (base_lens[b] + Tq + psz - 1) / psz);
  const int* trow = table + (size_t)b * maxp;

  for (int r = warp; r < TG; r += kWarps) {
    float mx = -INFINITY;
    for (int s = 0; s < n_live; ++s) {
      if (trow[s] < 0) continue;
      const size_t row = (((size_t)b * maxp + s) * KH + kh) * TG + r;
      mx = fmaxf(mx, part_ml[2 * row]);
    }
    float lsum = 0.f, o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < n_live; ++s) {
        if (trow[s] < 0) continue;
        const size_t row = (((size_t)b * maxp + s) * KH + kh) * TG + r;
        const float w = expf(part_ml[2 * row] - mx);  // 0 for m = -inf
        lsum += w * part_ml[2 * row + 1];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) o[e] += w * part_acc[row * hd + d];
        }
      }
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    const int t = r / G, h = kh * G + r % G;
    T* dst = out + (((size_t)b * Tq + t) * H + h) * hd;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) dst[d] = from_f<T>(o[e] * inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* base, const int* pages,
                   const int* lanes, const int* slots, float* work,
                   void* out, int B, int Tq, int H, int KH, int hd, int psz,
                   int maxp, cudaStream_t stream) {
  const int n_items = B * maxp;
  const size_t rows = (size_t)n_items * KH * Tq * (H / KH);
  float* part_acc = work;
  float* part_ml = work + rows * hd;
  auto kern_a = verify_partials_kernel<T, DPL>;
  const size_t smem = sizeof(float) * ((size_t)psz * (2 * hd + 1) +
                                       (size_t)kWarps * (hd + psz));
  // fails when hd and psz need more shared memory than a block may have
  cudaError_t err = cudaFuncSetAttribute(
      kern_a, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so a later launch does not report it
    return err;
  }
  const bool vec = vec_ok<T>(kp, vp, hd);
  dim3 grid_a(n_items < kItemBlocks ? n_items : kItemBlocks, KH);
  kern_a<<<grid_a, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), base, pages, lanes, slots, n_items,
      part_acc, part_ml, Tq, H, KH, hd, psz, maxp, 1.f / sqrtf((float)hd),
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_b(KH, B);
  verify_merge_kernel<T, DPL><<<grid_b, kThreads, 0, stream>>>(
      part_acc, part_ml, table, base, static_cast<T*>(out), Tq, H, KH, hd,
      psz, maxp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kp, const void* vp,
                     const int* table, const int* base, const int* pages,
                     const int* lanes, const int* slots, float* work,
                     void* out, int B, int Tq, int H, int KH, int hd,
                     int psz, int maxp, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 1>(q, kp, vp, table, base, pages, lanes, slots, work,
                        out, B, Tq, H, KH, hd, psz, maxp, s);
  if (hd <= 64)
    return launch<T, 2>(q, kp, vp, table, base, pages, lanes, slots, work,
                        out, B, Tq, H, KH, hd, psz, maxp, s);
  if (hd <= 128)
    return launch<T, 4>(q, kp, vp, table, base, pages, lanes, slots, work,
                        out, B, Tq, H, KH, hd, psz, maxp, s);
  return launch<T, 8>(q, kp, vp, table, base, pages, lanes, slots, work,
                      out, B, Tq, H, KH, hd, psz, maxp, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/out: [B, T, H, hd]; k/v pages:
// [P, psz, KH, hd]; table: int32 [B, maxp]; base: int32 [B];
// pages/lanes/slots: int32 [B * maxp], the schedule of schedule.py built
// from this table, base, T and psz; work: float32, at least
// B * maxp * KH * T * (H / KH) * (hd + 2) elements.  All contiguous.
// Launches kernel A then kernel B on the stream; returns
// cudaGetLastError() after the launches.
int verify_attention(const void* q, const void* k_pages, const void* v_pages,
                     const int* table, const int* base_lens,
                     const int* pages, const int* lanes, const int* slots,
                     float* work, void* out, int dtype, int B, int T, int H,
                     int KH, int hd, int psz, int maxp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd > 256 || H % KH != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(q, k_pages, v_pages, table, base_lens, pages,
                                lanes, slots, work, out, B, T, H, KH, hd, psz,
                                maxp, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k_pages, v_pages, table,
                                        base_lens, pages, lanes, slots, work,
                                        out, B, T, H, KH, hd, psz, maxp, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
