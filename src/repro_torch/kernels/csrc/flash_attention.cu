// Forward attention with an online softmax, for Hopper (sm_90a): causal and
// sliding-window masks, grouped-query heads.
//
// Replaces (TPU, Pallas): src/repro/kernels/flash_attention.py —
// flash_attention_pallas (_flash_kernel), whose grid (batch, q head, q
// block, kv block) carries the running (m, l, acc) in VMEM across the
// sequential kv axis. Here one block owns (batch, q head, query tile)
// and a loop inside the block walks the KV tiles, so the running state
// lives in registers and nothing carries over between blocks.
//
// Semantics (those of _flash_kernel): q [B, S, Hq, dh], k/v [B, T, Hkv, dh]
// (f32 or bf16, contiguous) -> o [B, S, Hq, dh] in q's type. Query head h
// reads KV head h / (Hq / Hkv). Logits are (q · scale) · k in f32 (bf16:
// (q · k) · scale, the products summed in f32), with scale passed in by the
// wrapper (dh ** -0.5, as Python computes it). Query
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
// 600 operations a byte, twice the card's bf16 balance point (~295), so the
// bf16 tensor cores (989 TFLOP/s) bound it.
//
// Two kernels, chosen by the input type:
//
// bf16 (flash_fwd_wgmma_kernel): both products on the tensor cores. A block
// of 384 threads owns (batch, q head, 128 queries): two consumer warpgroups
// of 64 query rows each and one producer warpgroup, of which one thread
// issues TMA loads and the rest exit (setmaxnreg moves their registers to
// the consumers). Q is loaded once; K and V tiles of BN keys arrive through
// a ring of STAGES stages, each with full barriers for K and V (TMA byte
// counts) and an empty barrier the eight consumer warps arrive on when the
// stage is consumed. S = Q·K^T is wgmma m64nBNk16 with both operands
// K-major in shared memory; the f32 logits are scaled by scale·log2(e)
// after the product and exponentiated with ex2.approx. P goes to O += P·V
// as wgmma A fragments in registers (the accumulator's layout is the
// A-fragment layout), with V as an MN-major B (transpose bit). P is rounded
// to bf16; on tiles where a row still has few effective keys (kExactKeys)
// its bf16 remainder goes through a second product, because one rounding of
// a few large weights can move an output that cancels to near 0 by more
// than ATTN_TOL's atol. Each consumer issues S for tile j before O += P·V
// for tile j - 1, so its softmax of tile j runs while the tensor cores
// finish tile j - 1. Tiles are 128B-swizzled boxes of 64 columns: the
// tensor maps run over (dh, heads, positions, batch) and TMA zero-fills
// columns past dh and rows past T or S. Only the causal diagonal, the
// window's lower edge and the ragged last tile compute the mask; interior
// tiles skip it. TMA needs 16-byte strides, so dh is a multiple of 8 here
// (the wrapper pads other widths with zeros on the card); it is padded to a
// compiled width DH in {64, 128, 256}, with BN and STAGES chosen per width
// (see Tile).
//
// f32 (flash_fwd_kernel): the CUDA-core kernel of the first port, kept
// for f32 inputs because TF32's 10-bit mantissa cannot meet f32's 1e-4
// agreement. Each thread keeps a 4 x 8 tile of logits and a 4 x (DH / 8)
// tile of the output in registers, reading q, k, p and v from shared memory
// as float4; K and V share one buffer so two blocks fit on an SM at dh 128;
// dh is zero-padded to DH in {32, 64, 128, 256}.
//
// Both kernels skip KV tiles wholly outside the block's band (kv_lo,
// kv_hi], schedule the heavy (late causal) query tiles first, and take the
// window as a runtime int, so one build serves every layer. dh > 256 does
// not fit their shared memory and the wrapper raises before launch.
//
// Plain C interface for ctypes: pointers and the stream are void*; the entry
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

cudaError_t launch_f32_dh(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                          cudaStream_t stream) {
  if (sh.dh <= 32) return launch<float, 32>(q, k, v, o, sh, stream);
  if (sh.dh <= 64) return launch<float, 64>(q, k, v, o, sh, stream);
  if (sh.dh <= 128) return launch<float, 128>(q, k, v, o, sh, stream);
  return launch<float, 256>(q, k, v, o, sh, stream);
}

// ------------------------------------------------- bf16: wgmma + TMA ring

// exp2 on the MUFU unit (ex2.approx, flush-to-zero: exp2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kBM = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int kWgThreads = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64;          // bf16 columns per 128-byte swizzled box
constexpr int kRowBytes = kBox * 2;
// P is split into bf16 hi + lo parts (P·V exact to ~2^-17 of each p) on the
// tiles where some row of the warpgroup has fewer than this many effective
// keys, (sum p)^2 / sum p^2; past it, one bf16 rounding of P moves no
// output by more than ATTN_TOL allows (tests/test_torch_attention.py).
constexpr float kExactKeys = 64.f;

// Per padded width: keys per KV tile, ring stages, and the N of each O += P·V
// wgmma (O is DH / NPV accumulators of 64 x NPV). Registers per consumer
// thread: S BN/2, O DH/2, P hi and lo BN/4 each (under the 240 setmaxnreg
// gives).
template <int DH>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BN = 128, STAGES = 4, NPV = 64;
};
template <>
struct Tile<128> {
  static constexpr int BN = 128, STAGES = 3, NPV = 128;
};
template <>
struct Tile<256> {
  static constexpr int BN = 64, STAGES = 2, NPV = 128;
};

template <int DH>
struct Smem {
  static constexpr uint32_t Q = kBM * DH * 2;         // Q tile, DH / 64 boxes of [kBM][64]
  static constexpr uint32_t KV = Tile<DH>::BN * DH * 2;  // one K or V tile, boxes of [BN][64]
  static constexpr size_t bytes =
      1024 /* alignment slack */ + Q + 2 * (size_t)Tile<DH>::STAGES * KV + (1 + 3 * Tile<DH>::STAGES) * 8;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// One consumer warpgroup (wg 0 or 1): query rows q0 + 64·wg .. + 63.
template <int DH>
__device__ __forceinline__ void consume(unsigned char* sq, unsigned char* sk, unsigned char* sv,
                                        uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
                                        uint64_t* empty, __nv_bfloat16* __restrict__ o,
                                        const Shape& sh, int wg, int q0, int h, int b, int tile_lo,
                                        int n_tiles) {
  constexpr int BN = Tile<DH>::BN, STAGES = Tile<DH>::STAGES, NPV = Tile<DH>::NPV;
  constexpr int NCH = DH / NPV;
  sm90::reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int wq0 = q0 + wg * 64;
  const int row0 = warp * 16 + lane / 4;  // this thread's rows: row0 and row0 + 8
  // This warpgroup's own band; tiles of the block's band outside it are
  // waited for and released without compute.
  const int wq_last = min(wq0 + 64, sh.S) - 1;
  const int w_lo = sh.window > 0 ? max(0, wq0 - sh.window + 1) : 0;
  const int w_hi = wq0 < sh.S ? (sh.causal ? min(sh.T, wq_last + 1) : sh.T) : 0;
  const float c_log2 = sh.scale * 1.4426950408889634f;  // logits -> log2 units

  float sacc[BN / 2];
  float oacc[NCH][NPV / 2];
  uint32_t phi[BN / 16][4], plo[BN / 16][4];  // P = hi + lo as wgmma A fragments
  float ms[2] = {kNegInf, kNegInf};  // running max in log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums
  float l2[2] = {0.f, 0.f};          // ... and of the sums of p^2
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < NPV / 2; ++e) oacc[c][e] = 0.f;

  const uint32_t q_base = sm90::smem_u32(sq) + wg * 64 * kRowBytes;
  const uint32_t k_base = sm90::smem_u32(sk);
  const uint32_t v_base = sm90::smem_u32(sv);

  // One arrival per consumer warp frees a ring slot for the producer.
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  // O += P · V of stage s: P's hi part, and its lo part where `split`. Each
  // chain of wgmmas is straight-line code: a branch between two of them
  // makes ptxas fence each one (C7519).
  auto v_desc = [&](int s, int kk, int c) {
    const uint32_t addr = v_base + s * Smem<DH>::KV + (c * NPV / kBox) * BN * kRowBytes + kk * 16 * kRowBytes;
    return sm90::desc_sw128(addr, BN * kRowBytes, 1024);
  };
  auto issue_pv = [&](int s, bool split) {
    if (split) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          sm90::wgmma_rs_tb(oacc[c], phi[kk], v_desc(s, kk, c));
          sm90::wgmma_rs_tb(oacc[c], plo[kk], v_desc(s, kk, c));
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NCH; ++c) sm90::wgmma_rs_tb(oacc[c], phi[kk], v_desc(s, kk, c));
    }
    sm90::wgmma_commit();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm90::fence_regs(oacc[c]);
  };

  sm90::mbar_wait(q_full, 0);
  int pending = -1;  // stage whose P · V is still to be issued
  uint32_t pending_phase = 0;
  bool pending_split = false;
  // The pending P · V, issued alone (the loop's edges).
  auto flush = [&]() {
    sm90::mbar_wait(&v_full[pending], pending_phase);
    fence_o();
    sm90::wgmma_fence();
    issue_pv(pending, pending_split);
    sm90::wgmma_wait<0>();
    fence_o();
    release(&empty[pending]);
    pending = -1;
  };
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int t0 = (tile_lo + it) * BN;
    if (t0 >= w_hi || t0 + BN <= w_lo) {
      // Outside this warpgroup's band: finish any pending product first, so
      // stages are released in ring order.
      if (pending >= 0) flush();
      sm90::mbar_wait(&k_full[s], phase);
      sm90::mbar_wait(&v_full[s], phase);
      release(&empty[s]);
      continue;
    }

    // S = Q · K^T for this tile, then O += P · V for the previous one.
    sm90::mbar_wait(&k_full[s], phase);
    fence_o();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes along a swizzled row
      const uint32_t qa = q_base + (kk / 4) * kBM * kRowBytes + off;
      const uint32_t ka = k_base + s * Smem<DH>::KV + (kk / 4) * BN * kRowBytes + off;
      sm90::wgmma_ss(sacc, sm90::desc_sw128(qa, 16, 1024), sm90::desc_sw128(ka, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    if (pending >= 0) {
      sm90::mbar_wait(&v_full[pending], pending_phase);
      issue_pv(pending, pending_split);
      sm90::wgmma_wait<1>();
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(sacc);

    // Mask only the tiles that cross the diagonal, the window's lower edge
    // or T; masked logits become -inf, so p = exp2(-inf) = 0.
    const bool need_mask = t0 + BN > sh.T || (sh.causal && t0 + BN - 1 > wq0) ||
                           (sh.window > 0 && t0 <= wq0 + 63 - sh.window);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int qpos = wq0 + row0 + ((e >> 1) & 1) * 8;
        const int kpos = t0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        bool keep = kpos < sh.T;
        if (sh.causal) keep = keep && kpos <= qpos;
        if (sh.window > 0) keep = keep && kpos > qpos - sh.window;
        if (!keep) sacc[e] = -INFINITY;
      }
    }

    // Online softmax of this thread's two rows; the four lanes of a quad share a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(ms[i], mx[i] * c_log2);
      alpha[i] = ex2(ms[i] - m_new);
      ms[i] = m_new;
    }
    float rs[2] = {0.f, 0.f}, rq[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int i = (e >> 1) & 1;
      sacc[e] = ex2(fmaf(sacc[e], c_log2, -ms[i]));
      rs[i] += sacc[e];
      rq[i] = fmaf(sacc[e], sacc[e], rq[i]);
    }
    bool few = false;  // a row of this thread with fewer than kExactKeys effective keys
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + rs[i];
      l2[i] = l2[i] * (alpha[i] * alpha[i]) + rq[i];
      float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      float qt = l2[i] + __shfl_xor_sync(0xffffffffu, l2[i], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      qt += __shfl_xor_sync(0xffffffffu, qt, 2);
      few = few || lt * lt < kExactKeys * qt;
    }
    const bool split = __shfl_sync(0xffffffffu, (int)sm90::wg_any(few, 1 + wg), 0) != 0;

    if (pending >= 0) {
      sm90::wgmma_wait<0>();
      fence_o();
      release(&empty[pending]);
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < NPV / 2; ++e) oacc[c][e] *= alpha[(e >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) phi[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
    // P's remainder is formed on every tile, used or not: writing wgmma
    // operands under a branch makes ptxas serialise every wgmma (C7520).
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 hi = unpack_bf16(phi[kk][r]);
        plo[kk][r] = pack_bf16(sacc[8 * kk + 2 * r] - hi.x, sacc[8 * kk + 2 * r + 1] - hi.y);
      }
    pending = s;
    pending_phase = phase;
    pending_split = split;
  }
  if (pending >= 0) flush();
  sm90::wgmma_wait<0>();  // nothing is in flight here; tells ptxas so
  fence_o();

  // o = acc / max(l, 1e-30), written as bf16 pairs (dh is a multiple of 8).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  const size_t q_row = (size_t)sh.Hq * sh.dh;
  __nv_bfloat16* ob = o + ((size_t)b * sh.S) * q_row + (size_t)h * sh.dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int srow = wq0 + row0 + i * 8;
    if (srow >= sh.S) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NPV / 8; ++n) {
        const int d = c * NPV + n * 8 + (lane & 3) * 2;
        if (d < sh.dh)
          *reinterpret_cast<uint32_t*>(ob + (size_t)srow * q_row + d) =
              pack_bf16(oacc[c][4 * n + 2 * i] * l[i], oacc[c][4 * n + 2 * i + 1] * l[i]);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                           Shape sh) {
  constexpr int BN = Tile<DH>::BN, STAGES = Tile<DH>::STAGES, NBOX = DH / kBox;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // Swizzled tiles need 1024-byte aligned bases.
  unsigned char* sq = wg_smem + ((1024 - (sm90::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sk = sq + Smem<DH>::Q;
  unsigned char* sv = sk + STAGES * Smem<DH>::KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * Smem<DH>::KV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // Heavy tiles first: every (batch, head)'s last query tile, then the one before.
  const int hb_n = sh.Hq * sh.B;
  const int n_qt = (sh.S + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / hb_n)) * kBM;
  const int h = (int)(blockIdx.x % hb_n) % sh.Hq;
  const int b = (int)(blockIdx.x % hb_n) / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);

  // The block's band of keys (kv_lo - 1, kv_hi) and its KV tiles.
  const int q_last = min(q0 + kBM, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int tile_lo = kv_lo / BN;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN - tile_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // Broadcast from lane 0 so that ptxas sees a warp-uniform value: branches
  // on it around wgmma then keep the products asynchronous (ptxas otherwise
  // serialises every wgmma, C7520).
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    // Producer: one thread keeps the ring full; the others only give back registers.
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_expect_tx(q_full, Smem<DH>::Q);
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
        sm90::tma_load_4d(sq + c * kBM * kRowBytes, &tq, q_full, c * kBox, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int t0 = (tile_lo + it) * BN;
        unsigned char* ks = sk + s * Smem<DH>::KV;
        unsigned char* vs = sv + s * Smem<DH>::KV;
        sm90::mbar_expect_tx(&k_full[s], Smem<DH>::KV);
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
          sm90::tma_load_4d(ks + c * BN * kRowBytes, &tk, &k_full[s], c * kBox, hk, t0, b);
        sm90::mbar_expect_tx(&v_full[s], Smem<DH>::KV);
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
          sm90::tma_load_4d(vs + c * BN * kRowBytes, &tv, &v_full[s], c * kBox, hk, t0, b);
      }
    }
  } else {
    consume<DH>(sq, sk, sv, q_full, k_full, v_full, empty, o, sh, wg, q0, h, b, tile_lo, n_tiles);
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map_bf16_4d(&tq, q, sh.dh, sh.Hq, sh.S, sh.B, kBox, kBM);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&tk, k, sh.dh, sh.Hkv, sh.T, sh.B, kBox, Tile<DH>::BN);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&tv, v, sh.dh, sh.Hkv, sh.T, sh.B, kBox, Tile<DH>::BN);
  if (err != cudaSuccess) return err;
  const size_t smem = Smem<DH>::bytes;
  err = hqi::prepare(flash_fwd_wgmma_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sh.S + kBM - 1) / kBM) * sh.Hq * sh.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_wgmma_kernel<DH><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sh);
  return cudaGetLastError();
}

cudaError_t launch_bf16_dh(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                           cudaStream_t stream) {
  if (sh.dh % 8 != 0) return cudaErrorInvalidValue;  // TMA strides: the wrapper pads dh to 8
  if (sh.dh <= 64) return launch_bf16<64>(q, k, v, o, sh, stream);
  if (sh.dh <= 128) return launch_bf16<128>(q, k, v, o, sh, stream);
  return launch_bf16<256>(q, k, v, o, sh, stream);
}

// ------------------------------------------------- dh > 256: a warp per query row
//
// flash_wide_kernel: the widths the tiled kernels above do not take (their
// tiles at dh 512 exceed a block's shared memory). A simple kernel, right
// first. A warp per (batch, query head, query row), kWideWarps consecutive
// rows of one head a block, so they share the K and V tiles of their KV
// head, staged in shared memory TK keys at a time (TK <= 32, from
// wide_tile_keys). Lane l holds columns l, l + 32, … of the row's scaled q
// (NPL a lane) and of its f32 output accumulator. A key's logit is a
// warp-reduced dot product (the lane's fmaf chain, then a butterfly of
// shuffles); lane j keeps key j's logit of the tile, so the tile's softmax
// update is one warp max, one warp sum and one rescale of the accumulator,
// then O += p_j · V_j for every kept key. Masks and query alignment are the
// tiled kernels' (a row that keeps no key gives 0). Past dh 2048 (QREG
// false) the accumulator covers 2048 columns a launch slice (grid.y holds
// heads × slices) and q is read through L1 for the logits. What bounds it:
// 4·dh operations a kept (query, key) pair on CUDA cores, and K/V read once
// a block of kWideWarps rows (through L2 across a head's blocks).

constexpr int kWideWarps = 8;               // query rows a block
constexpr int kWideKvBytes = 64 * 1024;     // the K and V tiles together
constexpr int kWideSlice = 2048;            // output columns a slice past dh 2048

__host__ __device__ inline int wide_tile_keys(int dh, int esize) {
  const int t = kWideKvBytes / (2 * dh * esize);
  return t < 1 ? 1 : (t > 32 ? 32 : t);
}

__host__ __device__ inline size_t wide_smem_bytes(int dh, int esize) {
  return (size_t)2 * wide_tile_keys(dh, esize) * dh * esize;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int NPL, bool QREG>
__global__ void __launch_bounds__(kWideWarps * 32)
    flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, Shape sh, int slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh = sh.dh;
  const int TK = wide_tile_keys(dh, (int)sizeof(T));
  T* ks = reinterpret_cast<T*>(smem_raw);  // [TK][dh]
  T* vs = ks + (size_t)TK * dh;            // [TK][dh]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kWideWarps;  // late (heavy) rows first
  const int h = blockIdx.y / slices, c0 = (blockIdx.y - h * slices) * (32 * NPL);
  const int b = blockIdx.z;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int row = r0 + warp;
  const bool live = row < sh.S;  // warp-uniform
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const T* qr = q + ((size_t)b * sh.S + (live ? row : 0)) * q_row + (size_t)h * dh;
  const T* kb = k + (size_t)b * sh.T * kv_row + (size_t)hk * dh;
  const T* vb = v + (size_t)b * sh.T * kv_row + (size_t)hk * dh;

  float qv[QREG ? NPL : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int u = 0; u < NPL; ++u) {
      const int c = lane + 32 * u;
      qv[u] = c < dh ? load_f32(qr + c) * sh.scale : 0.f;
    }
  }
  float acc[NPL];
#pragma unroll
  for (int u = 0; u < NPL; ++u) acc[u] = 0.f;
  float m = kNegInf, l = 0.f;

  // The keys any row of this block may keep: [kv_lo, kv_hi).
  const int r_last = min(r0 + kWideWarps, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, r0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, r_last + 1) : sh.T;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += TK) {
    const int nt = min(TK, kv_hi - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < nt * dh; e += blockDim.x) {
      const int j = e / dh, c = e - j * dh;
      ks[e] = kb[(size_t)(t0 + j) * kv_row + c];
      vs[e] = vb[(size_t)(t0 + j) * kv_row + c];
    }
    __syncthreads();
    if (!live) continue;
    float mine = kNegInf;  // lane j: key t0 + j's logit, kNegInf where masked
    for (int j = 0; j < nt; ++j) {
      const T* kr = ks + (size_t)j * dh;
      float part = 0.f;
      if constexpr (QREG) {
#pragma unroll
        for (int u = 0; u < NPL; ++u) {
          const int c = lane + 32 * u;
          if (c < dh) part = fmaf(qv[u], load_f32(kr + c), part);
        }
      } else {
        for (int c = lane; c < dh; c += 32) part = fmaf(load_f32(qr + c) * sh.scale, load_f32(kr + c), part);
      }
      const float logit = warp_sum(part);
      if (lane == j) mine = logit;
    }
    const int kpos = t0 + lane;
    bool keep = lane < nt;
    if (sh.causal) keep = keep && kpos <= row;
    if (sh.window > 0) keep = keep && kpos > row - sh.window;
    mine = keep ? mine : kNegInf;
    const float m_new = fmaxf(m, warp_max(mine));
    const float alpha = expf(m - m_new);
    const float p = keep ? expf(mine - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int u = 0; u < NPL; ++u) acc[u] *= alpha;
    for (int j = 0; j < nt; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      if (pj == 0.f) continue;  // warp-uniform: a masked key adds nothing
      const T* vr = vs + (size_t)j * dh + c0;
#pragma unroll
      for (int u = 0; u < NPL; ++u) {
        const int c = lane + 32 * u;
        if (c0 + c < dh) acc[u] = fmaf(pj, load_f32(vr + c), acc[u]);
      }
    }
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + ((size_t)b * sh.S + row) * q_row + (size_t)h * dh + c0;
#pragma unroll
  for (int u = 0; u < NPL; ++u) {
    const int c = lane + 32 * u;
    if (c0 + c < dh) store_out(orow + c, acc[u] * inv);
  }
}

template <typename T, int NPL, bool QREG>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                        cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(sh.dh, (int)sizeof(T));
  cudaError_t err = hqi::prepare(flash_wide_kernel<T, NPL, QREG>, smem);
  if (err != cudaSuccess) return err;
  const int slices = (sh.dh + 32 * NPL - 1) / (32 * NPL);
  const dim3 grid((sh.S + kWideWarps - 1) / kWideWarps, sh.Hq * slices, sh.B);
  flash_wide_kernel<T, NPL, QREG><<<grid, kWideWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      sh, slices);
  return cudaGetLastError();
}

// Columns a lane holds (NPL): the narrowest build that covers dh, and
// kWideSlice / 32 in slices past kWideSlice.
__host__ inline int wide_cols_per_lane(int dh) {
  return dh <= 512 ? 16 : (dh <= 1024 ? 32 : kWideSlice / 32);
}

template <typename T>
cudaError_t launch_wide_dh(const void* q, const void* k, const void* v, void* o, const Shape& sh,
                           cudaStream_t stream) {
  switch (wide_cols_per_lane(sh.dh)) {
    case 16:
      return launch_wide<T, 16, true>(q, k, v, o, sh, stream);
    case 32:
      return launch_wide<T, 32, true>(q, k, v, o, sh, stream);
    default:
      return sh.dh <= kWideSlice ? launch_wide<T, kWideSlice / 32, true>(q, k, v, o, sh, stream)
                                 : launch_wide<T, kWideSlice / 32, false>(q, k, v, o, sh, stream);
  }
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
  const cudaError_t err = bf16 ? launch_bf16_dh(q, k, v, o, sh, st) : launch_f32_dh(q, k, v, o, sh, st);
  return (int)err;
}

// The wide kernel's launch for these operands: grid x, y, z, threads, dynamic
// shared bytes and keys a K/V tile (kernels/flash_attention.py::wide_launch_shape).
int flash_attention_wide_shape(int B, int S, int Hq, int dh, int bf16, int* out) {
  if (B < 1 || S < 1 || Hq < 1 || dh < 1) return (int)cudaErrorInvalidValue;
  const int esize = bf16 ? 2 : 4, cols = 32 * wide_cols_per_lane(dh);
  out[0] = (S + kWideWarps - 1) / kWideWarps;
  out[1] = Hq * ((dh + cols - 1) / cols);
  out[2] = B;
  out[3] = kWideWarps * 32;
  out[4] = (int)wide_smem_bytes(dh, esize);
  out[5] = wide_tile_keys(dh, esize);
  return 0;
}

// The same contract at any dh (the wrapper takes it past 256): a warp per
// query row (flash_wide_kernel). Shared memory: 2 · TK · dh elements.
int flash_attention_wide_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                                int T, int Hq, int Hkv, int dh, int causal, int window, float scale,
                                int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || B > 65535 ||
      (long long)Hq * ((dh + kWideSlice - 1) / kWideSlice) > 65535 ||
      wide_smem_bytes(dh, bf16 ? 2 : 4) > 232448)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, Hq, Hkv, dh, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_wide_dh<__nv_bfloat16>(q, k, v, o, sh, st)
                               : launch_wide_dh<float>(q, k, v, o, sh, st);
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(flash_attention_error_string)
