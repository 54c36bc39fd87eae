// Forward attention with an online softmax, for Hopper (sm_90a): causal and
// sliding-window masks, grouped-query heads.
//
// Replaces (TPU, Pallas): src/repro/kernels/flash_attention.py —
// flash_attention_pallas (_flash_kernel), whose grid (batch, q head, q
// block, kv block) carries the running (m, l, acc) in VMEM across the
// sequential kv axis. Here one block owns (batch, q head, 64-query tile)
// and a loop inside the block walks the KV tiles, so the running state
// lives in registers and nothing carries over between blocks.
//
// Semantics (those of _flash_kernel): q [B, S, Hq, dh], k/v [B, T, Hkv, dh]
// (f32 or bf16, contiguous) -> o [B, S, Hq, dh] in q's type. Query head h
// reads KV head h / (Hq / Hkv). Logits are (q · scale) · k in f32, with
// scale passed in by the wrapper (dh ** -0.5, as Python computes it). Query
// positions are left-aligned (q_pos = row). Key kpos is kept for query qpos
// iff kpos < T, and kpos <= qpos when causal, and kpos > qpos - window when
// window > 0. m starts at the finite NEG_INF (-3.0e38) of the reference;
// a masked entry contributes p = 0 (not exp(0) as in a Pallas tile where
// the whole row is masked, which the reference heals later with alpha = 0),
// so a row with no kept key so far keeps l = 0 and acc = 0, and the
// output of a row is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it on the H100: at the serving shapes (gemma3: Hq 32, Hkv 16,
// dh 128, S = T up to 4096 with a 1024 window on five of six layers) the
// work is 4·dh operations per kept (query, key) pair: 60 GFLOP for a
// windowed 4096-token layer against 100 MB of q, k, v and o in bf16, about
// 600 operations a byte, twice the card's bf16 balance point (~295), so
// operations bound it even at the tensor-core peak. This first version
// computes in f32 on CUDA cores for both input types (no tensor cores, no
// TF32), so its ceiling is the 67 TFLOP/s f32 peak, ~15x below the bf16
// tensor-core bound chip_smoke.py states.
//
// What the design does about it: KV tiles wholly outside the block's band
// (kv_lo, kv_hi] are never loaded, which is the work the masks save (a
// windowed layer touches ~window/T of the tiles); each thread keeps a
// 4 x 8 tile of logits and a 4 x (DH / 8) tile of the output in registers,
// reading q, k, p and v from shared memory as float4 (q and k transposed, so
// a thread's four query rows and four keys are one load each); K and V
// share one shared-memory buffer so two blocks fit on an SM at dh 128. The
// head width is padded with zeros to a compiled width DH in {32, 64, 128,
// 256}; dh > 256 does not fit (see flash_smem_bytes) and the wrapper raises
// before launch. Tensor-core products (mma.sync or wgmma on bf16), TMA
// loads and a pipelined ring of KV tiles are later work.
//
// Plain C interface for ctypes: pointers and the stream are void*; the entry
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column lanes
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kPad = 4;         // row padding of the transposed tiles (floats)
constexpr int kStrideQ = kBQ + kPad;
constexpr int kStrideK = kBK + kPad;
constexpr float kNegInf = -3.0e38f;  // models/attention.py NEG_INF, not the scan kernels'

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Shape {
  int B, S, T, Hq, Hkv, dh, causal, window;
  float scale;
};

// Shared memory of one block at padded width DH: Qt [DH][kStrideQ], a KV
// buffer holding Kt [DH][kStrideK] or V [kBK][DH], and Pt [kBK][kStrideQ].
__host__ __device__ constexpr size_t flash_smem_bytes(int DH) {
  return ((size_t)DH * kStrideQ + (size_t)DH * kStrideK + (size_t)kBK * kStrideQ) * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, Shape sh) {
  static_assert(DH % 32 == 0, "DH is a multiple of 32");
  constexpr int kCols = DH / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [DH][kStrideQ], q * scale
  float* kv = qt + DH * kStrideQ;                  // Kt [DH][kStrideK] or V [kBK][DH]
  float* pt = kv + DH * kStrideK;                  // [kBK][kStrideQ]

  // Heavy tiles (late rows under a causal mask) are scheduled first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 7;   // logit columns tx*4+j and 32+tx*4+j; output columns tx*4+32u+j
  const int dh = sh.dh;

  const size_t q_row = (size_t)sh.Hq * dh;   // elements between consecutive positions
  const size_t kv_row = (size_t)sh.Hkv * dh;
  const T* qb = q + ((size_t)b * sh.S) * q_row + (size_t)h * dh;
  const T* kb = k + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;
  const T* vb = v + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e - (e / DH) * DH;
    const int s = q0 + r;
    const float x = (s < sh.S && d < dh) ? to_f32(qb[(size_t)s * q_row + d]) * sh.scale : 0.f;
    qt[d * kStrideQ + r] = x;
  }

  // The keys any row of this tile may keep: (kv_lo - 1, kv_hi).
  const int q_last = min(q0 + kBQ, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (kv_lo / kBK) * kBK; t0 < kv_hi; t0 += kBK) {
    __syncthreads();  // the previous tile's V and P are consumed (and Qt is staged)
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int j = e / DH, d = e - (e / DH) * DH;
      const int t = t0 + j;
      kv[d * kStrideK + j] = (t < sh.T && d < dh) ? to_f32(kb[(size_t)t * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kStrideQ + ty * 4);
      const float4 k0 = *reinterpret_cast<const float4*>(kv + d * kStrideK + tx * 4);
      const float4 k1 = *reinterpret_cast<const float4*>(kv + d * kStrideK + 32 + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
    }

    // Mask, then the online-softmax update of each of the thread's rows; the
    // 8 lanes sharing a row group are lanes 8g..8g+7 of one warp.
    bool keep[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = t0 + (j < 4 ? tx * 4 + j : 32 + tx * 4 + (j - 4));
        bool ok = kpos < sh.T;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        keep[i][j] = ok;
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = keep[i][j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j < 4 ? tx * 4 + j : 32 + tx * 4 + (j - 4);
        pt[col * kStrideQ + ty * 4 + i] = s[i][j];
      }
    }
    __syncthreads();  // Kt is consumed, P is visible

    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int j = e / DH, d = e - (e / DH) * DH;
      const int t = t0 + j;
      kv[j * DH + d] = (t < sh.T && d < dh) ? to_f32(vb[(size_t)t * kv_row + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + j * kStrideQ + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int u = 0; u < DH / 32; ++u) {
        const float4 va = *reinterpret_cast<const float4*>(kv + j * DH + u * 32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][u * 4 + 0] = fmaf(pv[i], va.x, acc[i][u * 4 + 0]);
          acc[i][u * 4 + 1] = fmaf(pv[i], va.y, acc[i][u * 4 + 1]);
          acc[i][u * 4 + 2] = fmaf(pv[i], va.z, acc[i][u * 4 + 2]);
          acc[i][u * 4 + 3] = fmaf(pv[i], va.w, acc[i][u * 4 + 3]);
        }
      }
    }
  }

  T* ob = o + ((size_t)b * sh.S) * q_row + (size_t)h * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= sh.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < DH / 32; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = u * 32 + tx * 4 + j;
        if (d < dh) store(ob + (size_t)s * q_row + d, acc[i][u * 4 + j] * inv);
      }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(DH);
  cudaError_t err = hqi::prepare(flash_fwd_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.S + kBQ - 1) / kBQ, sh.Hq, sh.B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                      cudaStream_t stream) {
  if (sh.dh <= 32) return launch<T, 32>(q, k, v, o, sh, stream);
  if (sh.dh <= 64) return launch<T, 64>(q, k, v, o, sh, stream);
  if (sh.dh <= 128) return launch<T, 128>(q, k, v, o, sh, stream);
  return launch<T, 256>(q, k, v, o, sh, stream);
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                           int T, int Hq, int Hkv, int dh, int causal, int window, float scale,
                           int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256 ||
      Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, Hq, Hkv, dh, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, sh, st)
                               : launch_dh<float>(q, k, v, o, sh, st);
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(flash_attention_error_string)
