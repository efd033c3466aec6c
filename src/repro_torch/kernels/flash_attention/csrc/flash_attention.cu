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
// and o, 33.5 MB each, and lse) take 0.040 ms at 3.35 TB/s.
//
// Design (simple first): one block of four warps per (batch, head,
// 64-row query tile), the heaviest causal tiles launched first.  The
// Q tile is staged in shared memory once and kept in registers as
// mma fragments; a loop walks the 64-key K/V tiles up to the diagonal
// (the TPU grid's sequential kv axis), staging K row-major and V
// transposed in shared memory.  bf16: each warp owns 16 query rows and
// runs mma.sync m16n8k16 (bf16 in, float32 out) for QK^T; the row max
// and sum stay in registers (online softmax, reduced over the four
// lanes that share a row).  P is split into two bf16 halves, hi =
// bf16(p) and lo = bf16(p - hi), and PV runs on both, so the product
// keeps P to about 2^-17: without the split, P rounded to bf16 moves
// outputs near zero by more than one bf16 ulp of the float32 plain
// version.  float32 (the smoke configs, the tests): plain float32 FMAs,
// no TF32, one warp per row at a time with the lanes over the keys for
// QK^T and over hd for PV.  What the simple design gives up: no
// wgmma, no TMA, no pipelining of the next tile's loads behind this
// tile's products, and the second PV product of the split; it runs
// several times slower than the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows a block
constexpr int kBK = 64;       // keys a K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

struct Shape {
  int64_t q[3], k[3], v[3], o[3];   // strides of (b, h, s), in elements
  int B, H, KH, S, causal;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for one m16n8k16 tile: a row-major 16x16, b column-major
// 16x8, both bf16; c float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 pairs, hi = bf16(x, y) and lo = bf16 of what hi
// leaves over; x in the low half, as the fragment layout wants it.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ int n_kv_tiles(const Shape& sh, int q0) {
  const int all = (sh.S + kBK - 1) / kBK;
  return sh.causal ? min(all, (q0 + kBQ - 1) / kBK + 1) : all;
}

__device__ __forceinline__ bool visible(const Shape& sh, int row, int col) {
  return col < sh.S && (!sh.causal || col <= row);
}

// ------------------------------------------------------------------ bf16

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q,
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
    err = cudaFuncSetAttribute(fa_fwd_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fa_fwd_bf16<HD><<<grid, kThreads, smem, stream>>>(
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

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int hd, const Shape& sh, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, sh, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, sh, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, sh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, S, hd], k and v [B, KH, S, hd], o like q: any strides with
// the last dim contiguous; strides holds (b, h, s) of q, k, v, o in
// elements.  lse: float32 [B, H, S], contiguous.  dtype 0 float32, 1
// bfloat16.  hd in {16, 64, 128}.  Returns cudaGetLastError() after
// the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int64_t* strides, int dtype, int B,
                        int H, int KH, int S, int hd, int causal,
                        void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || S <= 0 || dtype < 0 ||
      dtype > 1 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Shape sh;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_hd<__nv_bfloat16>(q, k, v, o, lse, hd, sh, st)
                    : launch_hd<float>(q, k, v, o, lse, hd, sh, st);
}

}  // extern "C"
