// Backward of the flash attention of flash_attention.cu, for Hopper
// (sm_90a): dQ, dK and dV of causal / sliding-window GQA softmax attention.
//
// Replaces: no Pallas kernel. The reference trains by differentiating its
// chunked online softmax, src/repro/models/attention.py::flash_attention
// (jax.grad with the kv step rematerialised); its Pallas forward
// (src/repro/kernels/flash_attention.py::flash_attention_pallas) has no
// backward. The port's forward is a hand-written kernel launched through
// ctypes, which autograd cannot see, so training needs this one
// (kernels/flash_attention.py::FlashAttentionFn).
//
// Semantics (flash_attention_plain's, and its backward,
// flash_attention_backward_plain): q, o, dO [B, S, Hq, dh], k, v
// [B, T, Hkv, dh] (f32 or bf16, one type, contiguous) -> dq, dk, dv in that
// type. Query head h reads KV head h / (Hq / Hkv). Key j is kept for query
// row i (left-aligned) iff j < T, j <= i when causal, and j > i - window
// when window > 0. S_ij = (q_i · k_j) · scale, P_ij = exp(S_ij - lse_i) on
// kept entries and 0 elsewhere, D_i = dO_i · O_i, dS = P ∘ (dO·Vᵀ - D),
// dQ = scale · dS·K, dK = scale · dSᵀ·Q (summed over the g = Hq / Hkv query
// heads of the KV head), dV = Pᵀ·dO. A row that keeps no key has output 0
// whatever its inputs: every entry of it is masked, so it gets dq = 0 and
// adds nothing to dk and dv.
//
// Two launches on the caller's stream, no atomics (deterministic):
//  1. bwd_dq_kernel, one block per (query tile of 64, query head, batch,
//     column slice): a first sweep over the KV tiles of the tile's band
//     recomputes each row's max and sum (the forward's m and l, as
//     lse = m + log l), D from dO and O; slice 0 writes lse and D; a second
//     sweep recomputes P, dP = dO·Vᵀ and dS, and sums dQ over the keys.
//  2. bwd_dkdv_kernel, one block per (key tile of 64, KV head, batch, column
//     slice): K and V of the tile stay in shared memory while the block walks
//     the g query heads of its group and, for each, the query tiles that keep
//     any of its keys, in that fixed order, reading lse and D.
// Both recompute S and dP, so the serving forward stays untouched.
//
// Two designs of that pair. bf16 up to dh 128 (dh a multiple of 8, 16-byte
// aligned operands; every head of the repo's configs) runs
// bwd_dq_mma_kernel / bwd_dkdv_mma_kernel: the products on the tensor cores
// as mma.sync (its section below). f32, and bf16 otherwise, runs
// bwd_dq_kernel / bwd_dkdv_kernel in f32 on CUDA cores: each thread owns a
// 4 x 8 tile of a 64 x 64 product (4 rows, 8 columns) and 4 rows of the
// output columns, reading operands from shared memory as float4, as the
// forward's f32 kernel does. Operands are staged transposed ([DH][64 + pad])
// for the S- and dP-type products, row-major for the dQ/dK/dV products;
// every staging zero-fills rows past S or T and columns past dh, so DH is
// the width compiled (32, 64, 128, 256) and dh anything up to it. Each
// output slice is DV = min(DH, 128) columns (dk and dv: 2 x 4 x DV / 8
// floats a thread); at DH 256 a block owns one of two slices and recomputes
// S and dP over all 256 columns.
//
// What bounds it on the H100: 10·dh operations per kept (query, key) pair
// and query head (five products: S, dP, dV, dQ, dK), against q, k, v, o,
// dO read once and dq, dk, dv written once. At minicpm's shapes ([2, 2048,
// 36/36, dh 64], causal) that is 96.7 GFLOP against 151 MB: about 640
// operations a byte, above the card's bf16 balance point (~295), so the
// bf16 tensor cores' 989 TFLOP/s set the bound (0.098 ms). These kernels do
// 16·dh per pair (S three times, the statistics sweep's included, and dP
// twice), with
// synchronous staging and no overlap of loads and products: wgmma tiles fed
// by TMA, and the forward writing lse, are the levers (ROADMAP.md §2,
// kernel 6).
//
// Plain C interface for ctypes: pointers and the stream are void*; the
// entry returns the first CUDA error of its launches (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kB = 64;         // rows of a query tile, keys of a KV tile
constexpr int kStride = kB + 4;  // row stride of the transposed tiles (floats)
constexpr float kNegInf = -3.0e38f;  // models/attention.py NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Shape {
  int B, S, T, Hq, Hkv, dh, causal, window;
  float scale;
};

__host__ __device__ constexpr int slice_cols(int DH) { return DH < 128 ? DH : 128; }

// Shared memory of either kernel at width DH: three [DH][kStride] tiles and
// one [kB][kStride] tile of P or dS, plus 2 x kB floats (lse and D, dK/dV).
__host__ __device__ constexpr size_t bwd_smem_bytes(int DH) {
  return ((size_t)3 * DH * kStride + (size_t)kB * kStride + 2 * kB) * sizeof(float);
}

// Column of the thread's j-th entry in a 4 x 8 tile of a 64-column product.
__device__ __forceinline__ int tile_col(int tx, int j) { return j < 4 ? tx * 4 + j : 32 + tx * 4 + (j - 4); }

// dst[d][r] = src row (r0 + r), column d, for r < kB, d < DH; 0 past `rows`
// or dh. `ld` is the elements between consecutive rows of src.
template <typename T, int DH>
__device__ __forceinline__ void stage_t(float* dst, const T* src, size_t ld, int r0, int rows, int dh) {
  for (int e = threadIdx.x; e < kB * DH; e += kThreads) {
    const int r = e / DH, d = e - (e / DH) * DH;
    const int s = r0 + r;
    dst[d * kStride + r] = (s < rows && d < dh) ? to_f32(src[(size_t)s * ld + d]) : 0.f;
  }
}

// dst[r][c] = src row (r0 + r), column (c0 + c), for c < DV; 0 past `rows`
// or dh.
template <typename T, int DV>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, size_t ld, int r0, int rows, int c0,
                                           int dh) {
  for (int e = threadIdx.x; e < kB * DV; e += kThreads) {
    const int r = e / DV, c = e - (e / DV) * DV;
    const int s = r0 + r, d = c0 + c;
    dst[r * DV + c] = (s < rows && d < dh) ? to_f32(src[(size_t)s * ld + d]) : 0.f;
  }
}

// s[i][j] += Σ_d a[d][ty·4 + i] · b[d][tile_col(tx, j)] over N staged
// columns: float4 reads, 32 FMAs per three.
template <int N>
__device__ __forceinline__ void product(float (&s)[4][8], const float* a, const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < N; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * kStride + ty * 4);
    const float4 y0 = *reinterpret_cast<const float4*>(b + d * kStride + tx * 4);
    const float4 y1 = *reinterpret_cast<const float4*>(b + d * kStride + 32 + tx * 4);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// acc[i][u·4 + c] += Σ_j w[j][ty·4 + i] · rows[j][u·32 + tx·4 + c] over the
// tile's kB values of j: w is [kB][kStride], rows [kB][DV].
template <int DV>
__device__ __forceinline__ void accumulate(float (&acc)[4][DV / 8], const float* w, const float* rows, int ty,
                                           int tx) {
#pragma unroll 2
  for (int j = 0; j < kB; ++j) {
    const float4 wa = *reinterpret_cast<const float4*>(w + j * kStride + ty * 4);
    const float wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
    for (int u = 0; u < DV / 32; ++u) {
      const float4 r = *reinterpret_cast<const float4*>(rows + j * DV + u * 32 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][u * 4 + 0] = fmaf(wv[i], r.x, acc[i][u * 4 + 0]);
        acc[i][u * 4 + 1] = fmaf(wv[i], r.y, acc[i][u * 4 + 1]);
        acc[i][u * 4 + 2] = fmaf(wv[i], r.z, acc[i][u * 4 + 2]);
        acc[i][u * 4 + 3] = fmaf(wv[i], r.w, acc[i][u * 4 + 3]);
      }
    }
  }
}

__device__ __forceinline__ bool kept(int qpos, int kpos, const Shape& sh) {
  bool ok = qpos < sh.S && kpos < sh.T;
  if (sh.causal) ok = ok && kpos <= qpos;
  if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
  return ok;
}

// Sum over the 8 lanes of a row group (lanes 8g..8g+7 of one warp).
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                  float* __restrict__ lse_out, float* __restrict__ delta_out, Shape sh) {
  constexpr int DV = slice_cols(DH);
  constexpr int kSlices = DH / DV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [DH][kStride] q
  float* dot = qt + DH * kStride;                  // [DH][kStride] dO
  float* buf = dot + DH * kStride;                 // Kt, Vt [DH][kStride] or K rows [kB][DV]
  float* dst = buf + DH * kStride;                  // [kB keys][kStride] dS

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heavy (late causal) tiles first
  const int h = blockIdx.y / kSlices;
  const int c0 = (blockIdx.y - h * kSlices) * DV;
  const int b = blockIdx.z;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t q_off = ((size_t)b * sh.S) * q_row + (size_t)h * dh;
  const T* kb = k + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;
  const T* vb = v + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;

  stage_t<T, DH>(qt, q + q_off, q_row, q0, sh.S, dh);
  stage_t<T, DH>(dot, dout + q_off, q_row, q0, sh.S, dh);
  __syncthreads();

  // D_i = dO_i · O_i (f32), a row group's 8 lanes splitting the columns
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = q0 + r;
    float acc = 0.f;
    if (s < sh.S)
      for (int d = tx; d < dh; d += 8) acc = fmaf(dot[d * kStride + r], to_f32(o[q_off + (size_t)s * q_row + d]), acc);
    delta[i] = group_sum(acc);
  }

  const int q_last = min(q0 + kB, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int t_first = (kv_lo / kB) * kB;

  // sweep 1: the forward's row statistics
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int t0 = t_first; t0 < kv_hi; t0 += kB) {
    __syncthreads();
    stage_t<T, DH>(buf, kb, kv_row, t0, sh.T, dh);
    __syncthreads();
    float s[4][8] = {};
    product<DH>(s, qt, buf, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = kept(qpos, t0 + tile_col(tx, j), sh) ? s[i][j] * sh.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + group_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;  // no kept key: every P of the row is 0
    const int s = q0 + ty * 4 + i;
    if (c0 == 0 && tx == 0 && s < sh.S) {
      const size_t at = ((size_t)b * sh.Hq + h) * sh.S + s;
      lse_out[at] = lse[i];
      delta_out[at] = delta[i];
    }
  }

  // sweep 2: P, dS, and dQ over the keys
  float acc[4][DV / 8] = {};
  for (int t0 = t_first; t0 < kv_hi; t0 += kB) {
    __syncthreads();  // the previous tile's K rows and dS are consumed
    stage_t<T, DH>(buf, kb, kv_row, t0, sh.T, dh);
    __syncthreads();
    float p[4][8] = {};
    product<DH>(p, qt, buf, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[i][j] = kept(q0 + ty * 4 + i, t0 + tile_col(tx, j), sh) ? expf(p[i][j] * sh.scale - lse[i]) : 0.f;
    __syncthreads();  // Kt is consumed
    stage_t<T, DH>(buf, vb, kv_row, t0, sh.T, dh);
    __syncthreads();
    float dp[4][8] = {};
    product<DH>(dp, dot, buf, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[tile_col(tx, j) * kStride + ty * 4 + i] = p[i][j] * (dp[i][j] - delta[i]);
    __syncthreads();  // Vt is consumed, dS is visible
    stage_rows<T, DV>(buf, kb, kv_row, t0, sh.T, c0, dh);
    __syncthreads();
    accumulate<DV>(acc, dst, buf, ty, tx);
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= sh.S) continue;
#pragma unroll
    for (int u = 0; u < DV / 32; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = c0 + u * 32 + tx * 4 + c;
        if (d < dh) store(dqb + (size_t)s * q_row + d, acc[i][u * 4 + c] * sh.scale);
      }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse_in,
                    const float* __restrict__ delta_in, T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int DV = slice_cols(DH);
  constexpr int kSlices = DH / DV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kt = reinterpret_cast<float*>(smem_raw);  // [DH][kStride] K of the tile
  float* vt = kt + DH * kStride;                   // [DH][kStride] V of the tile
  float* buf = vt + DH * kStride;                  // Qt, dOt [DH][kStride] or dO, Q rows [kB][DV]
  float* wt = buf + DH * kStride;                  // [kB queries][kStride] P, then dS
  float* lse_s = wt + kB * kStride;                // [kB]
  float* delta_s = lse_s + kB;                     // [kB]

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y / kSlices;
  const int c0 = (blockIdx.y - hk * kSlices) * DV;
  const int b = blockIdx.z;
  const int g = sh.Hq / sh.Hkv;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;  // keys ty·4 + i, queries tile_col(tx, j)
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t kv_off = ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;

  stage_t<T, DH>(kt, k + kv_off, kv_row, k0, sh.T, dh);
  stage_t<T, DH>(vt, v + kv_off, kv_row, k0, sh.T, dh);

  // the query rows that keep any key of the tile: [q_lo, q_hi)
  const int k_last = min(k0 + kB, sh.T) - 1;
  const int q_lo = sh.causal ? k0 : 0;
  const int q_hi = sh.window > 0 ? min(sh.S, k_last + sh.window) : sh.S;

  float dk_acc[4][DV / 8] = {}, dv_acc[4][DV / 8] = {};
  for (int h = hk * g; h < hk * g + g; ++h) {
    const size_t q_off = ((size_t)b * sh.S) * q_row + (size_t)h * dh;
    const float* lse_h = lse_in + ((size_t)b * sh.Hq + h) * sh.S;
    const float* delta_h = delta_in + ((size_t)b * sh.Hq + h) * sh.S;
    for (int q0 = (q_lo / kB) * kB; q0 < q_hi; q0 += kB) {
      __syncthreads();  // the previous tile's products are done with buf and wt
      stage_t<T, DH>(buf, q + q_off, q_row, q0, sh.S, dh);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        const bool in = q0 + r < sh.S;
        lse_s[r] = in ? lse_h[q0 + r] : 0.f;
        delta_s[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();
      // Sᵀ[key][query] and P, written to wt[query][key] (each thread reads
      // back only what it wrote until the next barrier)
      {
        float s[4][8] = {};
        product<DH>(s, kt, buf, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = tile_col(tx, j);
            wt[col * kStride + ty * 4 + i] =
                kept(q0 + col, k0 + ty * 4 + i, sh) ? expf(s[i][j] * sh.scale - lse_s[col]) : 0.f;
          }
      }
      __syncthreads();  // Qt is consumed
      stage_t<T, DH>(buf, dout + q_off, q_row, q0, sh.S, dh);
      __syncthreads();
      float ds[4][8] = {};
      product<DH>(ds, vt, buf, ty, tx);  // dPᵀ[key][query]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tile_col(tx, j);
          ds[i][j] = wt[col * kStride + ty * 4 + i] * (ds[i][j] - delta_s[col]);
        }
      __syncthreads();  // dOt is consumed, P is visible
      stage_rows<T, DV>(buf, dout + q_off, q_row, q0, sh.S, c0, dh);
      __syncthreads();
      accumulate<DV>(dv_acc, wt, buf, ty, tx);  // dV += Pᵀ·dO
      __syncthreads();  // P and the dO rows are consumed
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) wt[tile_col(tx, j) * kStride + ty * 4 + i] = ds[i][j];
      stage_rows<T, DV>(buf, q + q_off, q_row, q0, sh.S, c0, dh);
      __syncthreads();
      accumulate<DV>(dk_acc, wt, buf, ty, tx);  // dK += dSᵀ·Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= sh.T) continue;
#pragma unroll
    for (int u = 0; u < DV / 32; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = c0 + u * 32 + tx * 4 + c;
        if (d < dh) {
          const size_t at = kv_off + (size_t)t * kv_row + d;
          store(dk + at, dk_acc[i][u * 4 + c] * sh.scale);
          store(dv + at, dv_acc[i][u * 4 + c]);
        }
      }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                   void* dk, void* dv, float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  constexpr int kSlices = DH / slice_cols(DH);
  const size_t smem = bwd_smem_bytes(DH);
  cudaError_t err = hqi::prepare(bwd_dq_kernel<T, DH>, smem);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dkdv_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  bwd_dq_kernel<T, DH><<<dim3((sh.S + kB - 1) / kB, sh.Hq * kSlices, sh.B), kThreads, smem, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, static_cast<T*>(dq), lse, delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, DH><<<dim3((sh.T + kB - 1) / kB, sh.Hkv * kSlices, sh.B), kThreads, smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                      void* dk, void* dv, float* lse, float* delta, const Shape& sh, cudaStream_t st) {
  if (sh.dh <= 32) return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, sh, st);
  if (sh.dh <= 64) return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, sh, st);
  if (sh.dh <= 128) return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, sh, st);
  return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, sh, st);
}


// ---------------------------------------------- bf16: mma.sync tensor cores
//
// The same two kernels for bf16 inputs up to dh 128 (dh a multiple of 8, the
// operands 16-byte aligned), with the five products on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 sums). Four warps a block; warp w owns
// rows 16w..16w+15 of the block's 64 (queries in bwd_dq_mma_kernel, keys in
// bwd_dkdv_mma_kernel) and keeps its sums in registers in the accumulator
// layout: thread (g = lane / 4, t = lane % 4) holds rows g and g + 8,
// columns 2t and 2t + 1 of every 8-column tile. Tiles stay bf16 in shared
// memory, rows padded by 8 elements so that a fragment's 32-bit loads fall
// in distinct banks; the operands a product needs with the other index
// contiguous (Kᵀ for dQ, Qᵀ and dOᵀ for dK and dV) are staged a second time
// transposed. P and dS enter their products from registers (the f32
// accumulator layout of two adjacent 8-column tiles is the A-fragment layout
// of one 16-deep step), rounded to bf16; dS itself is formed in f32.

constexpr int kMmaThreads = 128;  // four warps
constexpr int kTStride = kB + 8;    // row stride of a transposed [DH][kB] tile (bf16)

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[n] += X · Yᵀ: X the warp's 16 rows of a [.][ldx] tile (depth KD), Y a
// [N8·8][ldy] tile whose rows are the product's columns.
template <int KD, int N8>
__device__ __forceinline__ void mma_tiles(float (&acc)[N8][4], const __nv_bfloat16* x, int ldx,
                                          const __nv_bfloat16* y, int ldy, int g, int t) {
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    const uint32_t a0 = ld32(x + g * ldx + k0 + 2 * t), a1 = ld32(x + (g + 8) * ldx + k0 + 2 * t);
    const uint32_t a2 = ld32(x + g * ldx + k0 + 2 * t + 8), a3 = ld32(x + (g + 8) * ldx + k0 + 2 * t + 8);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const __nv_bfloat16* yr = y + (n * 8 + g) * ldy + k0 + 2 * t;
      mma(acc[n], a0, a1, a2, a3, ld32(yr), ld32(yr + 8));
    }
  }
}

// acc[n] += W · Yᵀ with W the warp's [16][kB] weights (P or dS) held in the
// accumulator layout, rounded to bf16 here.
template <int N8>
__device__ __forceinline__ void mma_weights(float (&acc)[N8][4], const float (&w)[kB / 8][4], const __nv_bfloat16* y,
                                            int ldy, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    const uint32_t a0 = pack(w[2 * kk][0], w[2 * kk][1]), a1 = pack(w[2 * kk][2], w[2 * kk][3]);
    const uint32_t a2 = pack(w[2 * kk + 1][0], w[2 * kk + 1][1]), a3 = pack(w[2 * kk + 1][2], w[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const __nv_bfloat16* yr = y + (n * 8 + g) * ldy + kk * 16 + 2 * t;
      mma(acc[n], a0, a1, a2, a3, ld32(yr), ld32(yr + 8));
    }
  }
}

// Rows r0..r0+63 of a bf16 [., ld] array, 8 columns (16 bytes) at a time, into
// rows [kB][DH + 8] and, when `tr` is given, transposed [DH][kTStride]; 0 past
// `rows` or dh (dh is a multiple of 8 here).
template <int DH>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* rows_out, __nv_bfloat16* tr, const __nv_bfloat16* src,
                                           size_t ld, int r0, int rows, int dh) {
  for (int e = threadIdx.x; e < kB * (DH / 8); e += kMmaThreads) {
    const int r = e / (DH / 8), d = (e - r * (DH / 8)) * 8;
    const int s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < rows && d < dh) val = *reinterpret_cast<const uint4*>(src + (size_t)s * ld + d);
    if (rows_out) *reinterpret_cast<uint4*>(rows_out + r * (DH + 8) + d) = val;
    if (tr) {
      const uint32_t words[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tr[(d + 2 * i) * kTStride + r] = __ushort_as_bfloat16((unsigned short)(words[i] & 0xffffu));
        tr[(d + 2 * i + 1) * kTStride + r] = __ushort_as_bfloat16((unsigned short)(words[i] >> 16));
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
struct MmaSmem {
  static constexpr int kRow = kB * (DH + 8);  // a [kB][DH + 8] tile
  static constexpr int kTr = DH * kTStride;   // a [DH][kB + 8] tile
  // dq: Q, dO, K, V rows and Kᵀ; dkdv: K, V, Q, dO rows, Qᵀ, dOᵀ and lse, D
  static constexpr size_t dq_bytes = (4 * kRow + kTr) * 2;
  static constexpr size_t dkdv_bytes = (4 * kRow + 2 * kTr) * 2 + 2 * kB * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                      float* __restrict__ lse_out, float* __restrict__ delta_out, Shape sh) {
  using S = MmaSmem<DH>;
  constexpr int ld = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + S::kRow;
  __nv_bfloat16* ks = dos + S::kRow;
  __nv_bfloat16* vs = ks + S::kRow;
  __nv_bfloat16* kts = vs + S::kRow;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // heavy (late causal) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t q_off = ((size_t)b * sh.S) * q_row + (size_t)h * dh;
  const __nv_bfloat16* kb = k + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;
  const __nv_bfloat16* vb = v + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;

  stage_bf16<DH>(qs, nullptr, q + q_off, q_row, q0, sh.S, dh);
  stage_bf16<DH>(dos, nullptr, dout + q_off, q_row, q0, sh.S, dh);
  __syncthreads();

  const int r0 = 16 * w;  // the warp's rows; the thread's are r0 + g and r0 + g + 8
  float delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i, s = q0 + r;
    float acc = 0.f;
    if (s < sh.S)
      for (int d = t; d < dh; d += 4)
        acc = fmaf(__bfloat162float(dos[r * ld + d]), __bfloat162float(o[q_off + (size_t)s * q_row + d]), acc);
    delta[i] = quad_sum(acc);
  }

  const int q_last = min(q0 + kB, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int t_first = (kv_lo / kB) * kB;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int t0 = t_first; t0 < kv_hi; t0 += kB) {  // sweep 1: the forward's row statistics
    __syncthreads();
    stage_bf16<DH>(ks, nullptr, kb, kv_row, t0, sh.T, dh);
    __syncthreads();
    float s[kB / 8][4] = {};
    mma_tiles<DH, kB / 8>(s, qs + r0 * ld, ld, ks, ld, g, t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + g + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kB / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * i + c];
          x = kept(qpos, t0 + n * 8 + 2 * t + c, sh) ? x * sh.scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[i], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kB / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) sum += s[n][2 * i + c] > kNegInf ? expf(s[n][2 * i + c] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + quad_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;  // no kept key: every P of the row is 0
    const int s = q0 + r0 + g + 8 * i;
    if (t == 0 && s < sh.S) {
      const size_t at = ((size_t)b * sh.Hq + h) * sh.S + s;
      lse_out[at] = lse[i];
      delta_out[at] = delta[i];
    }
  }

  float acc[DH / 8][4] = {};
  for (int t0 = t_first; t0 < kv_hi; t0 += kB) {  // sweep 2: P, dS, and dQ over the keys
    __syncthreads();
    stage_bf16<DH>(ks, kts, kb, kv_row, t0, sh.T, dh);
    stage_bf16<DH>(vs, nullptr, vb, kv_row, t0, sh.T, dh);
    __syncthreads();
    float p[kB / 8][4] = {}, ds[kB / 8][4] = {};
    mma_tiles<DH, kB / 8>(p, qs + r0 * ld, ld, ks, ld, g, t);
    mma_tiles<DH, kB / 8>(ds, dos + r0 * ld, ld, vs, ld, g, t);  // dP
#pragma unroll
    for (int n = 0; n < kB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pe = kept(q0 + r0 + g + 8 * i, t0 + n * 8 + 2 * t + (e & 1), sh)
                             ? expf(p[n][e] * sh.scale - lse[i]) : 0.f;
        ds[n][e] = pe * (ds[n][e] - delta[i]);
      }
    mma_weights<DH / 8>(acc, ds, kts, kTStride, g, t);
  }

  __nv_bfloat16* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r0 + g + 8 * i;
    if (s >= sh.S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < dh) {  // dh is a multiple of 8: both columns or neither
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)s * q_row + d) =
            __floats2bfloat162_rn(acc[n][2 * i] * sh.scale, acc[n][2 * i + 1] * sh.scale);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  using S = MmaSmem<DH>;
  constexpr int ld = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + S::kRow;
  __nv_bfloat16* qs = vs + S::kRow;
  __nv_bfloat16* dos = qs + S::kRow;
  __nv_bfloat16* qts = dos + S::kRow;
  __nv_bfloat16* dots = qts + S::kTr;
  float* lse_s = reinterpret_cast<float*>(dots + S::kTr);
  float* delta_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int grp = sh.Hq / sh.Hkv;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w;  // the warp's keys; the thread's are r0 + g and r0 + g + 8
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t kv_off = ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;

  stage_bf16<DH>(ks, nullptr, k + kv_off, kv_row, k0, sh.T, dh);
  stage_bf16<DH>(vs, nullptr, v + kv_off, kv_row, k0, sh.T, dh);

  const int k_last = min(k0 + kB, sh.T) - 1;
  const int q_lo = sh.causal ? k0 : 0;
  const int q_hi = sh.window > 0 ? min(sh.S, k_last + sh.window) : sh.S;

  float dk_acc[DH / 8][4] = {}, dv_acc[DH / 8][4] = {};
  for (int h = hk * grp; h < hk * grp + grp; ++h) {
    const size_t q_off = ((size_t)b * sh.S) * q_row + (size_t)h * dh;
    const float* lse_h = lse_in + ((size_t)b * sh.Hq + h) * sh.S;
    const float* delta_h = delta_in + ((size_t)b * sh.Hq + h) * sh.S;
    for (int q0 = (q_lo / kB) * kB; q0 < q_hi; q0 += kB) {
      __syncthreads();  // the previous tile's products are done with the staged tiles
      stage_bf16<DH>(qs, qts, q + q_off, q_row, q0, sh.S, dh);
      stage_bf16<DH>(dos, dots, dout + q_off, q_row, q0, sh.S, dh);
      for (int r = threadIdx.x; r < kB; r += kMmaThreads) {
        const bool in = q0 + r < sh.S;
        lse_s[r] = in ? lse_h[q0 + r] : 0.f;
        delta_s[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();
      float p[kB / 8][4] = {}, ds[kB / 8][4] = {};
      mma_tiles<DH, kB / 8>(p, ks + r0 * ld, ld, qs, ld, g, t);    // Sᵀ[key][query]
      mma_tiles<DH, kB / 8>(ds, vs + r0 * ld, ld, dos, ld, g, t);  // dPᵀ
#pragma unroll
      for (int n = 0; n < kB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const float pe = kept(q0 + col, k0 + r0 + g + 8 * (e >> 1), sh)
                               ? expf(p[n][e] * sh.scale - lse_s[col]) : 0.f;
          p[n][e] = pe;
          ds[n][e] = pe * (ds[n][e] - delta_s[col]);
        }
      mma_weights<DH / 8>(dv_acc, p, dots, kTStride, g, t);   // dV += Pᵀ·dO
      mma_weights<DH / 8>(dk_acc, ds, qts, kTStride, g, t);   // dK += dSᵀ·Q
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tk = k0 + r0 + g + 8 * i;
    if (tk >= sh.T) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < dh) {
        const size_t at = kv_off + (size_t)tk * kv_row + d;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dk_acc[n][2 * i] * sh.scale, dk_acc[n][2 * i + 1] * sh.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                       void* dk, void* dv, float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  cudaError_t err = hqi::prepare(bwd_dq_mma_kernel<DH>, MmaSmem<DH>::dq_bytes);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dkdv_mma_kernel<DH>, MmaSmem<DH>::dkdv_bytes);
  if (err != cudaSuccess) return err;
  const Bf* qp = static_cast<const Bf*>(q);
  const Bf* kp = static_cast<const Bf*>(k);
  const Bf* vp = static_cast<const Bf*>(v);
  const Bf* dop = static_cast<const Bf*>(dout);
  bwd_dq_mma_kernel<DH><<<dim3((sh.S + kB - 1) / kB, sh.Hq, sh.B), kMmaThreads, MmaSmem<DH>::dq_bytes, stream>>>(
      qp, kp, vp, static_cast<const Bf*>(o), dop, static_cast<Bf*>(dq), lse, delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_mma_kernel<DH><<<dim3((sh.T + kB - 1) / kB, sh.Hkv, sh.B), kMmaThreads, MmaSmem<DH>::dkdv_bytes,
                            stream>>>(qp, kp, vp, dop, lse, delta, static_cast<Bf*>(dk), static_cast<Bf*>(dv), sh);
  return cudaGetLastError();
}

// bf16 up to dh 128 with dh a multiple of 8 and 16-byte aligned operands
// (16-byte staging loads): the tensor-core kernels; otherwise the CUDA-core ones.
bool takes_mma(const void* const* ptrs, int n, const Shape& sh) {
  if (sh.dh > 128 || sh.dh % 8 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

// dq, dk, dv (the inputs' type) of flash_attention; lse and delta are f32
// [B, Hq, S] scratch the wrapper allocates (the rows' log-sum-exp and
// dO · O, written by the first kernel, read by the second).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, void* lse, void* delta, int B, int S, int T,
                               int Hq, int Hkv, int dh, int causal, int window, float scale, int bf16,
                               void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256 ||
      2 * Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, Hq, Hkv, dh, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  cudaError_t err;
  if (bf16 && takes_mma(ptrs, 8, sh)) {
    err = sh.dh <= 32   ? launch_mma<32>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
          : sh.dh <= 64 ? launch_mma<64>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
                        : launch_mma<128>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st);
  } else {
    err = bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
               : launch_dh<float>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st);
  }
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(flash_attention_bwd_error_string)
