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
// [B, T, Hkv, dh] (f32 or bf16, one type, contiguous), and lse f32
// [B, Hq, S], each row's log-sum-exp of its kept logits as the training
// forward writes it -> dq, dk, dv in the inputs' type. Query head h reads KV
// head h / (Hq / Hkv). Key j is kept for query row i (left-aligned) iff
// j < T, j <= i when causal, and j > i - window when window > 0.
// S_ij = (q_i · k_j) · scale, P_ij = exp(S_ij - lse_i) on kept entries and 0
// elsewhere, D_i = dO_i · O_i, dS = P ∘ (dO·Vᵀ - D), dQ = scale · dS·K,
// dK = scale · dSᵀ·Q (summed over the g = Hq / Hkv query heads of the KV
// head), dV = Pᵀ·dO. A row that keeps no key has output 0 whatever its
// inputs: every entry of it is masked, so it gets dq = 0 and adds nothing to
// dk and dv, whatever its lse.
//
// Two launches on the caller's stream, no atomics (deterministic):
//  1. a dQ kernel, one block per query tile (and head, batch, column slice):
//     D from dO and O (written for the second launch), then over the KV
//     tiles of the tile's band P from the forward's lse, dP = dO·Vᵀ, dS, and
//     dQ summed over the keys;
//  2. a dK/dV kernel, one block per key tile (and KV head, batch, column
//     slice): K and V of the tile stay put while the block walks the g query
//     heads of its group and, for each, the query tiles that keep any of its
//     keys, in that fixed order, reading lse and D.
// Four designs of that pair, by type and width (bwd_route; the wrapper's
// backward_plan mirrors flash_attention_bwd_plan):
//  * bf16 up to dh 128 (every head of the repo's configs; the wrapper pads
//    dh to a multiple of 8 and 16-byte aligns the operands):
//    bwd_dq_wgmma_kernel / bwd_dkdv_wgmma_kernel, wgmma fed by a TMA ring
//    (their section below). S and dP once in each kernel: 14·dh operations
//    a kept pair against the 10·dh of five products;
//  * bf16 from 129 to 512: bwd_dq_wgmma_split_kernel /
//    bwd_dkdv_wgmma_split_kernel at DH 256, 384, 512, the same ring with
//    the two consumer warpgroups splitting the products (their section):
//    14·dh a kept pair at DH 256, 18·dh at 384 and 512;
//  * f32 up to dh 256: bwd_dq_tf32x3_kernel / bwd_dkdv_tf32x3_kernel at DH
//    32, 64, 128, 256, every product on the tensor cores as three TF32
//    mma.sync (hi/lo split, f32 sums), K/V or Q/dO tiles through a cp.async
//    ring, S and dP once a tile for all DH columns (their section);
//  * f32 past dh 256 and bf16 past 512: bwd_dq_wide_kernel /
//    bwd_dkdv_wide_kernel on CUDA cores, 32 stationary rows a block staged
//    once, the other operand streamed by cp.async, S and dP once a tile for
//    every output column of the block (up to 512: 14·dh a kept pair up to dh
//    512) (their section).
//
// What bounds it on the H100: 10·dh operations per kept (query, key) pair
// and query head (five products: S, dP, dV, dQ, dK), against q, k, v, o,
// dO read once and dq, dk, dv written once. At minicpm's shapes ([2, 2048,
// 36/36, dh 64], causal) that is 96.7 GFLOP against 151 MB: about 640
// operations a byte, above the card's bf16 balance point (~295), so the
// bf16 tensor cores' 989 TFLOP/s set the bound (0.098 ms). In f32 the
// bound is the lesser of the fp32 CUDA-core peak (67 TFLOP/s) and three
// TF32 passes at the TF32 tensor-core peak (495 / 3 = 165 TFLOP/s of f32
// work): 0.586 ms at minicpm's heads.
//
// Plain C interface for ctypes: pointers and the stream are void*; the
// entry returns the first CUDA error of its launches (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"
#include "topk.cuh"

namespace {

using namespace tf32x3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Shape {
  int B, S, T, Hq, Hkv, dh, causal, window;
  float scale;
};

__device__ __forceinline__ bool kept(int qpos, int kpos, const Shape& sh) {
  bool ok = qpos < sh.S && kpos < sh.T;
  if (sh.causal) ok = ok && kpos <= qpos;
  if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
  return ok;
}

// --------------------------- f32 past dh 256, bf16 past 512: the wide pair
//
// bwd_dq_wide_kernel / bwd_dkdv_wide_kernel on CUDA cores, 256 threads. A
// block owns kWR = 32 stationary rows (query rows of one head for dQ; keys
// of one KV head for dK/dV) and one slice of at most kWMaxCols output
// columns (one slice up to dh 512; past it ceil(dh / 512) slices). It walks
// tiles of kWM = 64 moving rows (the KV tiles of its band; for dK/dV the
// query tiles of each of the g heads of the group) and per tile:
//  1. sums S and dP once over all of dh, kWC columns a chunk:
//     S[r][m] = stat1_r · mov1_m and dP[r][m] = stat2_r · mov2_m (dK/dV:
//     K, V against Q, dO, so S and dP come transposed; dQ: Q, dO against K,
//     V), a thread owning stationary rows t, t + 16 and moving rows
//     u + 16i (t = tid % 16, u = tid / 16; conflict-free float4 reads);
//  2. forms P = exp(S·scale - lse) where kept (0 elsewhere) and
//     dS = P ∘ (dP - D) in f32 and writes them to shared memory;
//  3. accumulates over the tile's moving rows, kWQ at a time: dK += dSᵀ·Q
//     and dV += Pᵀ·dO (dQ += dS·K), a thread owning 4 stationary rows and
//     4·NU columns (NU = 3 or 4: a slice of 257..512 columns; dK and dV at
//     512 columns are 128 registers a thread).
// So a kept pair costs 14·dh operations over both kernels up to dh 512 (S
// and dP once in each, dQ, dK and dV once); past 512 each slice computes
// its S and dP again.
// The stationary rows are staged once for the block, over all of dh (in
// the input type), when they fit beside the rest (the dK/dV kernel: f32 to
// dh 608, bf16 to 1408); wider, their kWC-column chunks ride along with
// the moving ones. The moving rows stream through a ring of kWStages
// stages by cp.async (16 bytes a copy, zero-filled past S, T, dh or the
// slice): chunks [kWM][kWC] of both moving operands for step 1,
// [kWQ][128·NU] of the block's columns for step 3. Every operand row is 16-byte aligned in global memory
// (the wrapper pads dh to a multiple of 8 and copies misaligned bases).
// One __syncthreads a chunk; no scalar transposed stores on the hot loop.

constexpr int kWideThreads = 256;
constexpr int kWR = 32;          // stationary rows a block
constexpr int kWM = 64;          // moving rows a tile
constexpr int kWC = 32;          // columns of a step-1 chunk
constexpr int kWQ = 4;           // moving rows of a step-3 chunk
constexpr int kWStages = 3;      // cp.async ring
constexpr int kWMaxCols = 512;   // output columns a slice, at most
constexpr int kWW = kWR + 4;     // row stride (floats) of the [kWM][kWW] P and dS tiles
constexpr size_t kSmemMax = 232448;

// The launch plan of one side (dq or dk/dv) at padded width dh, in
// elements of the input type (esize bytes); flash_attention.py's
// backward_plan mirrors it.
struct WidePlan {
  int slices, cols, nu, dhc, stationary;
  int ld_stat, ld_chunk, ld_rows;  // row strides in shared memory (elements)
  size_t stat_bytes, stage_bytes, w_bytes, smem;
};

__host__ __device__ inline WidePlan wide_plan(int dh, int esize, int dkdv) {
  WidePlan p;
  const int pad = 16 / esize;  // one 16-byte pad: rows stay 16-byte aligned, float4 reads conflict-free
  p.slices = (dh + kWMaxCols - 1) / kWMaxCols;
  p.cols = ((dh + p.slices - 1) / p.slices + 7) / 8 * 8;
  p.nu = (p.cols + 127) / 128;
  p.dhc = (dh + kWC - 1) / kWC * kWC;
  p.ld_stat = p.dhc + pad;
  p.ld_chunk = kWC + pad;
  p.ld_rows = 128 * p.nu + pad;
  const int nops = dkdv ? 2 : 1;
  p.w_bytes = (size_t)nops * kWM * kWW * 4 + (dkdv ? 0 : kWR * 4);  // dQ: also D of the block's rows
  p.stat_bytes = (size_t)2 * kWR * p.ld_stat * esize;
  const size_t p2 = (size_t)nops * kWQ * p.ld_rows;
  for (int stationary = 1; stationary >= 0; --stationary) {
    const size_t p1 = (size_t)2 * kWM * p.ld_chunk + (stationary ? 0 : (size_t)2 * kWR * p.ld_chunk);
    p.stage_bytes = ((p1 > p2 ? p1 : p2) * esize + 15) / 16 * 16;
    p.smem = (stationary ? p.stat_bytes : 0) + kWStages * p.stage_bytes + p.w_bytes;
    p.stationary = stationary;
    if (p.smem <= kSmemMax) break;
  }
  return p;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u), __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows [r0, r0 + rows) x columns [c0, c0 + cols) of src (row stride ld_src
// elements) into dst (row stride ld_dst) by cp.async, 16 bytes a copy;
// zeros past row_end or col_end. cols, c0 and col_end are multiples of 16
// bytes' worth of elements.
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, int ld_dst, const T* src, size_t ld_src, int r0, int rows,
                                            int row_end, int c0, int cols, int col_end) {
  constexpr int kE = 16 / sizeof(T);
  const int units = cols / kE;
  for (int e = threadIdx.x; e < rows * units; e += kWideThreads) {
    const int r = e / units, x = e - r * units;
    const int row = r0 + r, col = c0 + x * kE;
    const bool ok = row < row_end && col < col_end;
    sm90::cp_async16_zfill(dst + r * ld_dst + x * kE, ok ? src + (size_t)row * ld_src + col : src, ok);
  }
}

// One side of the wide pair: dQ (DKDV false: out1 = dq) or dK/dV (out1 =
// dk, out2 = dv).
template <typename T, int NU, bool DKDV>
__device__ __forceinline__ void wide_side(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                          const T* __restrict__ o, const T* __restrict__ dout,
                                          const float* __restrict__ lse_in, float* __restrict__ delta,
                                          T* __restrict__ out1, T* __restrict__ out2, const Shape& sh) {
  constexpr int kCols = 128 * NU;
  const WidePlan pl = wide_plan(sh.dh, sizeof(T), DKDV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stat = reinterpret_cast<T*>(smem_raw);  // [2][kWR][ld_stat] when stationary
  unsigned char* after_stat = smem_raw + (pl.stationary ? pl.stat_bytes : 0);
  T* stages = reinterpret_cast<T*>(after_stat);
  float* w = reinterpret_cast<float*>(after_stat + kWStages * pl.stage_bytes);  // [DKDV ? 2 : 1][kWM][kWW]: dS, P
  const int stage_elems = (int)(pl.stage_bytes / sizeof(T));

  // block -> (rank of its 32 stationary rows, slice, head, batch), heavy first
  // for every head: dK/dV's early keys, dQ's late queries
  const int H = DKDV ? sh.Hkv : sh.Hq;
  const int st_end = DKDV ? sh.T : sh.S, mv_end = DKDV ? sh.S : sh.T;
  const int n_rt = (st_end + kWR - 1) / kWR;
  const int per = pl.slices * H * sh.B;
  const int rank = (int)(blockIdx.x / per), rest = (int)(blockIdx.x % per);
  const int slice = rest % pl.slices, hh = (rest / pl.slices) % H, b = rest / pl.slices / H;
  const int r0 = (DKDV ? rank : n_rt - 1 - rank) * kWR;
  const int c0 = slice * pl.cols, c_end = min(sh.dh, c0 + pl.cols);
  const int g = sh.Hq / sh.Hkv, dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t st_ld = DKDV ? kv_row : q_row, mv_ld = DKDV ? q_row : kv_row;
  const size_t st_off = DKDV ? (size_t)b * sh.T * kv_row + (size_t)hh * dh : (size_t)b * sh.S * q_row + (size_t)hh * dh;
  const T* st1 = (DKDV ? k : q) + st_off;  // pairs with mov1 in S
  const T* st2 = (DKDV ? v : dout) + st_off;  // pairs with mov2 in dP
  const int tid = threadIdx.x;
  const int t = tid & 15, u = tid >> 4;    // step 1: stationary rows t, t + 16; moving rows u + 16i
  const int wr = tid >> 5, ln = tid & 31;  // step 3: stationary rows 4·wr + i; columns 4·ln + 128·x + c

  // The moving tiles: dK/dV the query tiles keeping any of the block's keys,
  // for each head of the group; dQ the KV tiles of the rows' band.
  int mt_lo, n_mt;
  if (DKDV) {
    const int k_last = min(r0 + kWR, sh.T) - 1;
    const int lo = sh.causal ? r0 : 0;
    const int hi = sh.window > 0 ? min(sh.S, k_last + sh.window) : sh.S;
    mt_lo = lo / kWM;
    n_mt = hi > lo ? (hi + kWM - 1) / kWM - mt_lo : 0;
  } else {
    const int q_last = min(r0 + kWR, sh.S) - 1;
    const int lo = sh.window > 0 ? max(0, r0 - sh.window + 1) : 0;
    const int hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
    mt_lo = lo / kWM;
    n_mt = hi > lo ? (hi + kWM - 1) / kWM - mt_lo : 0;
  }
  const int n_tiles = DKDV ? g * n_mt : n_mt;
  const int n1 = pl.dhc / kWC, per_tile = n1 + kWM / kWQ;
  const int n_chunks = n_tiles * per_tile;
  // tile ti: its query head (dK/dV), first moving row and the moving operands
  auto tile = [&](int ti, int& hq, int& m0) {
    hq = DKDV ? hh * g + ti / n_mt : hh;
    m0 = (mt_lo + (DKDV ? ti % n_mt : ti)) * kWM;
  };
  auto mov = [&](int hq, const T*& m1, const T*& m2) {
    const size_t off = DKDV ? (size_t)b * sh.S * q_row + (size_t)hq * dh
                            : (size_t)b * sh.T * kv_row + (size_t)(hh / g) * dh;
    m1 = (DKDV ? q : k) + off;
    m2 = (DKDV ? dout : v) + off;
  };

  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int ti = c / per_tile, j = c - ti * per_tile;
      T* buf = stages + (c % kWStages) * stage_elems;
      int hq, m0;
      tile(ti, hq, m0);
      const T *m1, *m2;
      mov(hq, m1, m2);
      if (j < n1) {
        const int d0 = j * kWC;
        stage_async(buf, pl.ld_chunk, m1, mv_ld, m0, kWM, mv_end, d0, kWC, dh);
        stage_async(buf + kWM * pl.ld_chunk, pl.ld_chunk, m2, mv_ld, m0, kWM, mv_end, d0, kWC, dh);
        if (!pl.stationary) {
          T* sb = buf + 2 * kWM * pl.ld_chunk;
          stage_async(sb, pl.ld_chunk, st1, st_ld, r0, kWR, st_end, d0, kWC, dh);
          stage_async(sb + kWR * pl.ld_chunk, pl.ld_chunk, st2, st_ld, r0, kWR, st_end, d0, kWC, dh);
        }
      } else {
        const int mr = m0 + (j - n1) * kWQ;
        stage_async(buf, pl.ld_rows, m1, mv_ld, mr, kWQ, mv_end, c0, kCols, c_end);
        if (DKDV) stage_async(buf + kWQ * pl.ld_rows, pl.ld_rows, m2, mv_ld, mr, kWQ, mv_end, c0, kCols, c_end);
      }
    }
    sm90::cp_async_commit();  // empty groups too: the wait below counts groups
  };

  if (pl.stationary) {
    stage_async(stat, pl.ld_stat, st1, st_ld, r0, kWR, st_end, 0, pl.dhc, dh);
    stage_async(stat + kWR * pl.ld_stat, pl.ld_stat, st2, st_ld, r0, kWR, st_end, 0, pl.dhc, dh);
  }
  sm90::cp_async_commit();
  for (int c = 0; c < kWStages - 1; ++c) issue(c);

  // dQ: D = dO · O of the block's rows (a warp a row; written for the dK/dV
  // launch by slice 0) and their lse, for rows t and t + 16.
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if (!DKDV) {
    float* d_s = w + kWM * kWW;
    const size_t at0 = ((size_t)b * sh.Hq + hh) * sh.S;
    for (int rr = wr; rr < kWR; rr += kWideThreads / 32) {
      const int row = r0 + rr;
      float a = 0.f;
      if (row < sh.S)
        for (int d = ln; d < dh; d += 32) {
          const size_t at = st_off + (size_t)row * q_row + d;
          a = fmaf(to_f32(dout[at]), to_f32(o[at]), a);
        }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) a += __shfl_xor_sync(0xffffffffu, a, x);
      if (ln == 0) {
        d_s[rr] = a;
        if (slice == 0 && row < sh.S) delta[at0 + row] = a;
      }
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int row = r0 + t + 16 * jj;
      d_r[jj] = d_s[t + 16 * jj];
      lse_r[jj] = row < sh.S ? lse_in[at0 + row] : 0.f;
    }
  }

  float acc0[4][4 * NU], acc1[DKDV ? 4 : 1][DKDV ? 4 * NU : 1];  // dK or dQ; dV
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int x = 0; x < 4 * NU; ++x) {
      acc0[i][x] = 0.f;
      if constexpr (DKDV) acc1[i][x] = 0.f;
    }

  // Chunk c: wait for it, make it visible, and reuse the stage read at c - 1.
  auto step = [&](int c) {
    sm90::cp_async_wait<kWStages - 2>();
    __syncthreads();
    issue(c + kWStages - 1);
  };
  int c = 0;
  for (int ti = 0; ti < n_tiles; ++ti) {
    int hq, m0;
    tile(ti, hq, m0);
    float s[2][4], dp[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jj][i] = dp[jj][i] = 0.f;
    for (int j = 0; j < n1; ++j, ++c) {  // S and dP over dh
      step(c);
      const T* buf = stages + (c % kWStages) * stage_elems;
      const T* a1 = pl.stationary ? stat + j * kWC : buf + 2 * kWM * pl.ld_chunk;
      const int lda = pl.stationary ? pl.ld_stat : pl.ld_chunk;
      const T* a2 = a1 + kWR * lda;
      const T* x1 = buf;
      const T* x2 = buf + kWM * pl.ld_chunk;
#pragma unroll 1
      for (int d = 0; d < kWC; d += 4) {
        const float4 a[2] = {ld4(a1 + t * lda + d), ld4(a1 + (t + 16) * lda + d)};
        const float4 bb[2] = {ld4(a2 + t * lda + d), ld4(a2 + (t + 16) * lda + d)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = ld4(x1 + (u + 16 * i) * pl.ld_chunk + d);
          const float4 y = ld4(x2 + (u + 16 * i) * pl.ld_chunk + d);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            s[jj][i] = dot4(a[jj], x, s[jj][i]);
            dp[jj][i] = dot4(bb[jj], y, dp[jj][i]);
          }
        }
      }
    }
    // P and dS of the tile, read after the next chunk's barrier (the
    // previous tile's last reads of w were before this chunk's).
    float lse_m[4], d_m[4];  // dK/dV: the tile's query rows u + 16i
    if constexpr (DKDV) {
      const size_t at0 = ((size_t)b * sh.Hq + hq) * sh.S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = m0 + u + 16 * i;
        lse_m[i] = qr < sh.S ? lse_in[at0 + qr] : 0.f;
        d_m[i] = qr < sh.S ? delta[at0 + qr] : 0.f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sr = r0 + t + 16 * jj, mr = m0 + u + 16 * i;
        float l, dd;
        bool keep;
        if constexpr (DKDV) {
          keep = kept(mr, sr, sh);
          l = lse_m[i], dd = d_m[i];
        } else {
          keep = kept(sr, mr, sh);
          l = lse_r[jj], dd = d_r[jj];
        }
        const float p = keep ? expf(s[jj][i] * sh.scale - l) : 0.f;
        const int at = (u + 16 * i) * kWW + t + 16 * jj;
        w[at] = p * (dp[jj][i] - dd);
        if constexpr (DKDV) w[kWM * kWW + at] = p;
      }
    for (int j = 0; j < kWM / kWQ; ++j, ++c) {  // dK += dSᵀ·Q, dV += Pᵀ·dO (dQ += dS·K)
      step(c);
      const T* buf = stages + (c % kWStages) * stage_elems;
#pragma unroll 1
      for (int r = 0; r < kWQ; ++r) {
        const float4 w0 = *reinterpret_cast<const float4*>(w + (j * kWQ + r) * kWW + 4 * wr);
        const float wv0[4] = {w0.x, w0.y, w0.z, w0.w};
#pragma unroll
        for (int x = 0; x < NU; ++x) {
          const float4 b0 = ld4(buf + r * pl.ld_rows + 4 * ln + 128 * x);
          const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc0[i][4 * x + cc] = fmaf(wv0[i], bv0[cc], acc0[i][4 * x + cc]);
        }
        if constexpr (DKDV) {
          const float4 w1 = *reinterpret_cast<const float4*>(w + kWM * kWW + (j * kWQ + r) * kWW + 4 * wr);
          const float wv1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int x = 0; x < NU; ++x) {
            const float4 b1 = ld4(buf + kWQ * pl.ld_rows + r * pl.ld_rows + 4 * ln + 128 * x);
            const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) acc1[i][4 * x + cc] = fmaf(wv1[i], bv1[cc], acc1[i][4 * x + cc]);
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  // dK (and dQ) take the scale; dV does not.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * wr + i;
    if (row >= st_end) continue;
#pragma unroll
    for (int x = 0; x < NU; ++x)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = c0 + 4 * ln + 128 * x + cc;
        if (col < c_end) {
          const size_t at = st_off + (size_t)row * st_ld + col;
          store(out1 + at, acc0[i][4 * x + cc] * sh.scale);
          if constexpr (DKDV) store(out2 + at, acc1[i][4 * x + cc]);
        }
      }
  }
}

template <typename T, int NU>
__global__ void __launch_bounds__(kWideThreads, 1)
    bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse_in,
                       T* __restrict__ dq, float* __restrict__ delta_out, Shape sh) {
  wide_side<T, NU, false>(q, k, v, o, dout, lse_in, delta_out, dq, nullptr, sh);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kWideThreads, 1)
    bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse_in,
                         float* __restrict__ delta_in, T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  wide_side<T, NU, true>(q, k, v, nullptr, dout, lse_in, delta_in, dk, dv, sh);
}

template <typename T, int NU>
cudaError_t launch_wide_nu(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                           void* dk, void* dv, const float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  const WidePlan pq = wide_plan(sh.dh, sizeof(T), 0), pk = wide_plan(sh.dh, sizeof(T), 1);
  cudaError_t err = hqi::prepare(bwd_dq_wide_kernel<T, NU>, pq.smem);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dkdv_wide_kernel<T, NU>, pk.smem);
  if (err != cudaSuccess) return err;
  const long long dq_blocks = (long long)((sh.S + kWR - 1) / kWR) * pq.slices * sh.Hq * sh.B;
  const long long kv_blocks = (long long)((sh.T + kWR - 1) / kWR) * pk.slices * sh.Hkv * sh.B;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  bwd_dq_wide_kernel<T, NU><<<(unsigned)dq_blocks, kWideThreads, pq.smem, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, lse, static_cast<T*>(dq), delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_wide_kernel<T, NU><<<(unsigned)kv_blocks, kWideThreads, pk.smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return cudaGetLastError();
}

// dh a multiple of 8, operands 16-byte aligned (the wrapper pads and copies);
// a slice is 257..512 columns wide, so NU is 3 or 4.
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                        void* dk, void* dv, const float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  const int nu = wide_plan(sh.dh, sizeof(T), 0).nu;
  if (nu == 3) return launch_wide_nu<T, 3>(q, k, v, o, dout, dq, dk, dv, lse, delta, sh, stream);
  if (nu == 4) return launch_wide_nu<T, 4>(q, k, v, o, dout, dq, dk, dv, lse, delta, sh, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- bf16: wgmma + TMA ring
//
// bf16 up to dh 128 (dh a multiple of 8, operands 16-byte aligned, as TMA
// wants), every product on the tensor cores as wgmma with f32 sums, in the
// shape of the forward's flash_fwd_wgmma_kernel: 384 threads a block, two
// consumer warpgroups of 64 stationary rows each and a producer warpgroup
// whose first warp feeds a ring of STAGES shared-memory stages through TMA
// and mbarriers (full: the bytes landed; empty: the eight consumer warps
// are done with the stage), setmaxnreg moving registers to the consumers.
// Tiles are 128B-swizzled boxes of 64 columns (sm90.cuh); TMA zero-fills
// columns past dh and rows past S or T.
//
//  * bwd_dq_wgmma_kernel: a block owns 128 query rows of one head. Q and dO
//    are loaded once; K and V tiles of BN keys stream through the ring. Per
//    tile a consumer runs S = Q·Kᵀ and dP = dO·Vᵀ (both operands K-major in
//    shared memory), P = exp2(S·scale·log2 e - lse·log2 e) and
//    dS = P ∘ (dP - D) in registers, and dQ += dS·K with dS as register A
//    fragments (the f32 accumulator layout of two 8-column tiles is one
//    A fragment) and K as an MN-major B (transpose bit). D = dO · O is
//    computed first, from device memory, and written for the dK/dV launch.
//  * bwd_dkdv_wgmma_kernel: a block owns 128 keys of one KV head; K and V
//    are loaded once. The ring streams Q and dO tiles of BQ queries, with
//    their rows' lse (in log2 units) and D, over the g heads of the group
//    and, per head, the query tiles that keep any key of the block. Per tile
//    the key rows are wgmma's M: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS), Pᵀ and
//    dSᵀ in registers, dV += Pᵀ·dO and dK += dSᵀ·Q (register A, MN-major B).
//    No operand is staged transposed by hand: the transpose bit reads Q and
//    dO as they land.
//
// Each consumer issues the next tile's S and dP before the previous tile's
// accumulating products, and runs its softmax arithmetic while those finish
// (as the forward does); only the tiles crossing the causal diagonal, the
// window's lower edge or the ragged end compute the mask. P and dS enter
// their products rounded to bf16.

constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumerWarps = 8;
constexpr int kRows = 128;       // stationary rows a block: 64 a consumer warpgroup
constexpr int kBox = 64;         // bf16 columns of a 128-byte swizzled box
constexpr int kRowBytes = kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;

// Per padded width: BN keys a dQ tile and its stages, BQ queries a dK/dV
// tile and its stages. Registers a consumer thread: dQ 64·DH/128 + S and dP
// BN/2 each + dS BN/4; dK and dV DH/2 each + Sᵀ and dPᵀ BQ/2 each + P and
// dS BQ/4 each (176 at DH 128, under the 240 setmaxnreg gives).
template <int DH>
struct WgTile;
template <>
struct WgTile<64> {
  static constexpr int BN = 64, DQ_STAGES = 4, BQ = 64, KV_STAGES = 4;
};
template <>
struct WgTile<128> {
  static constexpr int BN = 64, DQ_STAGES = 3, BQ = 32, KV_STAGES = 4;
};

template <int DH>
struct DqSmem {
  static constexpr int STAGES = WgTile<DH>::DQ_STAGES;
  static constexpr uint32_t Q = kRows * DH * 2;                 // the Q tile, and the dO tile
  static constexpr uint32_t KV = WgTile<DH>::BN * DH * 2;      // a K tile, and a V tile
  static constexpr size_t bytes = 1024 /* alignment slack */ + 2 * Q + (size_t)STAGES * 2 * KV + (1 + 2 * STAGES) * 8;
};

template <int DH>
struct DkvSmem {
  static constexpr int STAGES = WgTile<DH>::KV_STAGES, BQ = WgTile<DH>::BQ;
  static constexpr uint32_t KV = kRows * DH * 2;                // the K tile, and the V tile
  static constexpr uint32_t Q = BQ * DH * 2;                    // a Q tile, and a dO tile
  static constexpr size_t bytes =
      1024 + 2 * KV + (size_t)STAGES * (2 * Q + 2 * BQ * sizeof(float)) + (1 + 2 * STAGES) * 8;
};

// exp2 on the MUFU unit (ex2.approx, flush-to-zero: exp2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Σ of the eight products of two 16-byte words of bf16 pairs, into acc.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// wgmma descriptors of a [rows][DH] bf16 tile in 64-column boxes at shared
// address `base`. K-major (DH is the product's depth): the 16 columns of
// k-step kk. MN-major (the tile's rows are the depth, its columns the N
// dimension): rows 16·kk .. 16·kk + 15, the boxes `rows` x 128 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
  return sm90::desc_sw128(base + (kk / 4) * rows * kRowBytes + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kk) {
  return sm90::desc_sw128(base + kk * 16 * kRowBytes, rows * kRowBytes, 1024);
}

template <int DH>
__device__ __forceinline__ void dq_consume(unsigned char* sq, unsigned char* sdo, unsigned char* sk,
                                           unsigned char* sv, uint64_t* q_full, uint64_t* full, uint64_t* empty,
                                           const __nv_bfloat16* __restrict__ o,
                                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                                           float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                                           const Shape& sh, int wg, int q0, int h, int b, int tile_lo,
                                           int n_tiles) {
  constexpr int BN = WgTile<DH>::BN, STAGES = DqSmem<DH>::STAGES;
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
  const float c_log2 = sh.scale * kLog2e;  // logits -> log2 units
  const size_t q_row = (size_t)sh.Hq * sh.dh;
  const size_t q_off = (size_t)b * sh.S * q_row + (size_t)h * sh.dh;
  const size_t at0 = ((size_t)b * sh.Hq + h) * sh.S;

  // Each row's lse (log2 units) and D = dO · O, the four lanes of a quad
  // splitting the columns 8 at a time; 0 past S.
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wq0 + row0 + 8 * i;
    float acc = 0.f;
    if (r < sh.S)
      for (int d = (lane & 3) * 8; d < sh.dh; d += 32) {
        const size_t at = q_off + (size_t)r * q_row + d;
        acc = dot8(*reinterpret_cast<const uint4*>(o + at), *reinterpret_cast<const uint4*>(dout + at), acc);
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[i] = acc;
    lse2[i] = r < sh.S ? lse[at0 + r] * kLog2e : 0.f;
    if ((lane & 3) == 0 && r < sh.S) delta[at0 + r] = acc;
  }

  float sacc[BN / 2], dpacc[BN / 2], dqacc[DH / 2];
  uint32_t dsf[BN / 16][4];  // dS as wgmma A fragments
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) dqacc[e] = 0.f;
  const uint32_t q_base = sm90::smem_u32(sq) + wg * 64 * kRowBytes;
  const uint32_t do_base = sm90::smem_u32(sdo) + wg * 64 * kRowBytes;
  const uint32_t k_base = sm90::smem_u32(sk), v_base = sm90::smem_u32(sv);

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  auto issue_dq = [&](int s) {  // dQ += dS · K of stage s
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      sm90::wgmma_rs_tb(dqacc, dsf[kk], mnmajor(k_base + s * DqSmem<DH>::KV, BN, kk));
    sm90::wgmma_commit();
  };
  int pending = -1;  // stage whose dQ product is still to be issued
  auto flush = [&]() {
    sm90::fence_regs(dqacc);
    sm90::wgmma_fence();
    issue_dq(pending);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dqacc);
    release(&empty[pending]);
    pending = -1;
  };

  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int t0 = (tile_lo + it) * BN;
    if (t0 >= w_hi || t0 + BN <= w_lo) {
      if (pending >= 0) flush();  // stages are released in ring order
      sm90::mbar_wait(&full[s], phase);
      release(&empty[s]);
      continue;
    }
    // S and dP for this tile, then dQ += dS · K for the previous one.
    sm90::mbar_wait(&full[s], phase);
    sm90::fence_regs(dqacc);
    sm90::wgmma_fence();
    const uint32_t ks = k_base + s * DqSmem<DH>::KV, vs = v_base + s * DqSmem<DH>::KV;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) sm90::wgmma_ss(sacc, kmajor(q_base, kRows, kk), kmajor(ks, BN, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) sm90::wgmma_ss(dpacc, kmajor(do_base, kRows, kk), kmajor(vs, BN, kk), kk > 0);
    sm90::wgmma_commit();
    if (pending >= 0) {
      issue_dq(pending);
      sm90::wgmma_wait<1>();
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(sacc);
    sm90::fence_regs(dpacc);

    // P and dS; the mask only on tiles that cross the diagonal, the window's
    // lower edge or T (dS is written on every tile: wgmma operands written
    // under a branch make ptxas serialise the products).
    const bool need_mask = t0 + BN > sh.T || (sh.causal && t0 + BN - 1 > wq0) ||
                           (sh.window > 0 && t0 <= wq0 + 63 - sh.window);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int i = (e >> 1) & 1;
      float p = ex2(fmaf(sacc[e], c_log2, -lse2[i]));
      if (need_mask) {
        const int qpos = wq0 + row0 + i * 8;
        const int kpos = t0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        bool keep = kpos < sh.T;
        if (sh.causal) keep = keep && kpos <= qpos;
        if (sh.window > 0) keep = keep && kpos > qpos - sh.window;
        if (!keep) p = 0.f;
      }
      dpacc[e] = p * (dpacc[e] - dlt[i]);
    }
    if (pending >= 0) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqacc);
      release(&empty[pending]);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) dsf[kk][r] = pack_bf16(dpacc[8 * kk + 2 * r], dpacc[8 * kk + 2 * r + 1]);
    pending = s;
  }
  if (pending >= 0) flush();
  sm90::wgmma_wait<0>();  // nothing is in flight here; tells ptxas so
  sm90::fence_regs(dqacc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int srow = wq0 + row0 + i * 8;
    if (srow >= sh.S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < sh.dh)
        *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)srow * q_row + d) =
            pack_bf16(dqacc[4 * n + 2 * i] * sh.scale, dqacc[4 * n + 2 * i + 1] * sh.scale);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                        Shape sh) {
  using M = DqSmem<DH>;
  constexpr int BN = WgTile<DH>::BN, STAGES = M::STAGES, NBOX = DH / kBox;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sq = wg_smem + ((1024 - (sm90::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sdo = sq + M::Q;
  unsigned char* sk = sdo + M::Q;
  unsigned char* sv = sk + STAGES * M::KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * M::KV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // Heavy tiles first: every (batch, head)'s last query tile, then the one before.
  const int hb_n = sh.Hq * sh.B;
  const int n_qt = (sh.S + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / hb_n)) * kRows;
  const int h = (int)(blockIdx.x % hb_n) % sh.Hq, b = (int)(blockIdx.x % hb_n) / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);

  const int q_last = min(q0 + kRows, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int tile_lo = kv_lo / BN;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN - tile_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);  // warp-uniform for ptxas
  if (wg == 2) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tdo);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_expect_tx(q_full, 2 * M::Q);
#pragma unroll
      for (int c = 0; c < NBOX; ++c) {
        sm90::tma_load_4d(sq + c * kRows * kRowBytes, &tq, q_full, c * kBox, h, q0, b);
        sm90::tma_load_4d(sdo + c * kRows * kRowBytes, &tdo, q_full, c * kBox, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int t0 = (tile_lo + it) * BN;
        sm90::mbar_expect_tx(&full[s], 2 * M::KV);
#pragma unroll
        for (int c = 0; c < NBOX; ++c) {
          sm90::tma_load_4d(sk + s * M::KV + c * BN * kRowBytes, &tk, &full[s], c * kBox, hk, t0, b);
          sm90::tma_load_4d(sv + s * M::KV + c * BN * kRowBytes, &tv, &full[s], c * kBox, hk, t0, b);
        }
      }
    }
  } else {
    dq_consume<DH>(sq, sdo, sk, sv, q_full, full, empty, o, dout, lse, delta, dq, sh, wg, q0, h, b, tile_lo,
                   n_tiles);
  }
}

template <int DH>
__device__ __forceinline__ void dkdv_consume(unsigned char* sk, unsigned char* sv, unsigned char* sq,
                                             unsigned char* sdo, const float* lse_s, const float* d_s,
                                             uint64_t* kv_full, uint64_t* full, uint64_t* empty,
                                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                             const Shape& sh, int wg, int k0, int hk, int b, int qt_lo, int n_qt,
                                             int n_tiles) {
  using M = DkvSmem<DH>;
  constexpr int BQ = M::BQ, STAGES = M::STAGES;
  sm90::reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int wk0 = k0 + wg * 64;
  const int row0 = warp * 16 + lane / 4;  // this thread's keys: wk0 + row0 and + 8
  // The queries that keep any key of this warpgroup: [wq_lo, wq_hi).
  const int wk_last = min(wk0 + 64, sh.T) - 1;
  const int wq_lo = sh.causal ? wk0 : 0;
  const int wq_hi = wk0 < sh.T ? (sh.window > 0 ? min(sh.S, wk_last + sh.window) : sh.S) : 0;
  const float c_log2 = sh.scale * kLog2e;

  float sacc[BQ / 2], dpacc[BQ / 2], dkacc[DH / 2], dvacc[DH / 2];
  uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];  // Pᵀ and dSᵀ as wgmma A fragments
#pragma unroll
  for (int e = 0; e < DH / 2; ++e) {
    dkacc[e] = 0.f;
    dvacc[e] = 0.f;
  }
  const uint32_t k_base = sm90::smem_u32(sk) + wg * 64 * kRowBytes;
  const uint32_t v_base = sm90::smem_u32(sv) + wg * 64 * kRowBytes;
  const uint32_t q_base = sm90::smem_u32(sq), do_base = sm90::smem_u32(sdo);

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  auto fence_kv = [&]() {
    sm90::fence_regs(dkacc);
    sm90::fence_regs(dvacc);
  };
  auto issue_kv = [&](int s) {  // dV += Pᵀ · dO and dK += dSᵀ · Q of stage s
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      sm90::wgmma_rs_tb(dvacc, pf[kk], mnmajor(do_base + s * M::Q, BQ, kk));
      sm90::wgmma_rs_tb(dkacc, dsf[kk], mnmajor(q_base + s * M::Q, BQ, kk));
    }
    sm90::wgmma_commit();
  };
  int pending = -1;
  auto flush = [&]() {
    fence_kv();
    sm90::wgmma_fence();
    issue_kv(pending);
    sm90::wgmma_wait<0>();
    fence_kv();
    release(&empty[pending]);
    pending = -1;
  };

  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    if (q0 >= wq_hi || q0 + BQ <= wq_lo) {
      if (pending >= 0) flush();
      sm90::mbar_wait(&full[s], phase);
      release(&empty[s]);
      continue;
    }
    sm90::mbar_wait(&full[s], phase);
    fence_kv();
    sm90::wgmma_fence();
    const uint32_t qs = q_base + s * M::Q, dos = do_base + s * M::Q;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) sm90::wgmma_ss(sacc, kmajor(k_base, kRows, kk), kmajor(qs, BQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) sm90::wgmma_ss(dpacc, kmajor(v_base, kRows, kk), kmajor(dos, BQ, kk), kk > 0);
    sm90::wgmma_commit();
    if (pending >= 0) {
      issue_kv(pending);
      sm90::wgmma_wait<1>();
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_regs(sacc);
    sm90::fence_regs(dpacc);

    // Pᵀ and dSᵀ: column (query) e's lse and D from the stage; the mask only
    // where the tile crosses the diagonal, the window's edge or S.
    const float* ls = lse_s + s * BQ;
    const float* dl = d_s + s * BQ;
    const bool need_mask = q0 + BQ > sh.S || (sh.causal && wk0 + 63 > q0) ||
                           (sh.window > 0 && wk0 <= q0 + BQ - 1 - sh.window);
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int col = (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
      float p = ex2(fmaf(sacc[e], c_log2, -ls[col]));
      if (need_mask) {
        const int qpos = q0 + col;
        const int kpos = wk0 + row0 + ((e >> 1) & 1) * 8;
        bool keep = qpos < sh.S;
        if (sh.causal) keep = keep && kpos <= qpos;
        if (sh.window > 0) keep = keep && kpos > qpos - sh.window;
        if (!keep) p = 0.f;
      }
      sacc[e] = p;
      dpacc[e] = p * (dpacc[e] - dl[col]);
    }
    if (pending >= 0) {
      sm90::wgmma_wait<0>();
      fence_kv();
      release(&empty[pending]);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
        dsf[kk][r] = pack_bf16(dpacc[8 * kk + 2 * r], dpacc[8 * kk + 2 * r + 1]);
      }
    pending = s;
  }
  if (pending >= 0) flush();
  sm90::wgmma_wait<0>();
  fence_kv();

  const size_t kv_row = (size_t)sh.Hkv * sh.dh;
  const size_t kv_off = (size_t)b * sh.T * kv_row + (size_t)hk * sh.dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tk = wk0 + row0 + i * 8;
    if (tk >= sh.T) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < sh.dh) {
        const size_t at = kv_off + (size_t)tk * kv_row + d;
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(dkacc[4 * n + 2 * i] * sh.scale, dkacc[4 * n + 2 * i + 1] * sh.scale);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dvacc[4 * n + 2 * i], dvacc[4 * n + 2 * i + 1]);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  using M = DkvSmem<DH>;
  constexpr int BQ = M::BQ, STAGES = M::STAGES, NBOX = DH / kBox;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sk = wg_smem + ((1024 - (sm90::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sv = sk + M::KV;
  unsigned char* sq = sv + M::KV;
  unsigned char* sdo = sq + STAGES * M::Q;
  float* lse_s = reinterpret_cast<float*>(sdo + STAGES * M::Q);  // [STAGES][BQ], log2 units
  float* d_s = lse_s + STAGES * BQ;                               // [STAGES][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(d_s + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  // Heavy tiles first: under a causal mask the first key tiles are kept by the most queries.
  const int hb_n = sh.Hkv * sh.B;
  const int k0 = (int)(blockIdx.x / hb_n) * kRows;
  const int hk = (int)(blockIdx.x % hb_n) % sh.Hkv, b = (int)(blockIdx.x % hb_n) / sh.Hkv;
  const int g = sh.Hq / sh.Hkv;

  // The query tiles that keep any key of the block, walked for each of the g heads.
  const int k_last = min(k0 + kRows, sh.T) - 1;
  const int q_lo = sh.causal ? k0 : 0;
  const int q_hi = sh.window > 0 ? min(sh.S, k_last + sh.window) : sh.S;
  const int qt_lo = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt_lo : 0;
  const int n_tiles = g * n_qt;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the TMA bytes' arrival and the 32 lanes that wrote lse and D
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x < 256 + 32) {  // the producer's first warp
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        sm90::tma_prefetch(&tq);
        sm90::tma_prefetch(&tdo);
        sm90::tma_prefetch(&tk);
        sm90::tma_prefetch(&tv);
        sm90::mbar_expect_tx(kv_full, 2 * M::KV);
#pragma unroll
        for (int c = 0; c < NBOX; ++c) {
          sm90::tma_load_4d(sk + c * kRows * kRowBytes, &tk, kv_full, c * kBox, hk, k0, b);
          sm90::tma_load_4d(sv + c * kRows * kRowBytes, &tv, kv_full, c * kBox, hk, k0, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int h = hk * g + it / n_qt;
        const int q0 = (qt_lo + it % n_qt) * BQ;
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], 2 * M::Q);
#pragma unroll
          for (int c = 0; c < NBOX; ++c) {
            sm90::tma_load_4d(sq + s * M::Q + c * BQ * kRowBytes, &tq, &full[s], c * kBox, h, q0, b);
            sm90::tma_load_4d(sdo + s * M::Q + c * BQ * kRowBytes, &tdo, &full[s], c * kBox, h, q0, b);
          }
        }
        const size_t at0 = ((size_t)b * sh.Hq + h) * sh.S;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < sh.S;
          lse_s[s * BQ + r] = in ? lse[at0 + q0 + r] * kLog2e : 0.f;
          d_s[s * BQ + r] = in ? delta[at0 + q0 + r] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else {
    dkdv_consume<DH>(sk, sv, sq, sdo, lse_s, d_s, kv_full, full, empty, dk, dv, sh, wg, k0, hk, b, qt_lo, n_qt,
                     n_tiles);
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                         void* dk, void* dv, const float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  // Q and dO boxes of 128 rows (dQ) or BQ rows (dK/dV); K and V boxes of BN rows (dQ) or 128 rows (dK/dV)
  CUtensorMap q_dq, do_dq, k_dq, v_dq, q_kv, do_kv, k_kv, v_kv;
  const int BN = WgTile<DH>::BN, BQ = WgTile<DH>::BQ;
  cudaError_t err = sm90::make_map_bf16_4d(&q_dq, q, sh.dh, sh.Hq, sh.S, sh.B, kBox, kRows);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&do_dq, dout, sh.dh, sh.Hq, sh.S, sh.B, kBox, kRows);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&k_dq, k, sh.dh, sh.Hkv, sh.T, sh.B, kBox, BN);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&v_dq, v, sh.dh, sh.Hkv, sh.T, sh.B, kBox, BN);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&q_kv, q, sh.dh, sh.Hq, sh.S, sh.B, kBox, BQ);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&do_kv, dout, sh.dh, sh.Hq, sh.S, sh.B, kBox, BQ);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&k_kv, k, sh.dh, sh.Hkv, sh.T, sh.B, kBox, kRows);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&v_kv, v, sh.dh, sh.Hkv, sh.T, sh.B, kBox, kRows);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dq_wgmma_kernel<DH>, DqSmem<DH>::bytes);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dkdv_wgmma_kernel<DH>, DkvSmem<DH>::bytes);
  if (err != cudaSuccess) return err;
  const long long dq_blocks = (long long)((sh.S + kRows - 1) / kRows) * sh.Hq * sh.B;
  const long long kv_blocks = (long long)((sh.T + kRows - 1) / kRows) * sh.Hkv * sh.B;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bwd_dq_wgmma_kernel<DH><<<(unsigned)dq_blocks, kWgThreads, DqSmem<DH>::bytes, stream>>>(
      q_dq, do_dq, k_dq, v_dq, static_cast<const Bf*>(o), static_cast<const Bf*>(dout), lse, delta,
      static_cast<Bf*>(dq), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma_kernel<DH><<<(unsigned)kv_blocks, kWgThreads, DkvSmem<DH>::bytes, stream>>>(
      q_kv, do_kv, k_kv, v_kv, lse, delta, static_cast<Bf*>(dk), static_cast<Bf*>(dv), sh);
  return cudaGetLastError();
}


// ------------------------------------- bf16 dh 129..512: the split wgmma pair
//
// Past dh 128 a warpgroup can no longer hold dK and dV of 64 keys (64 x dh
// each, dh registers a thread) nor Q and dO of 128 rows beside a ring
// (128 KiB each at dh 512). So the two consumer warpgroups of a block share
// its 64 stationary rows and split the products between them, handing P
// across in shared memory (f32, in the accumulator's fragment order, behind
// mbarriers: full when all 128 threads of the writer wrote, empty when all
// 128 of the reader read). Padded widths DH 256, 384 and 512 (TMA fills
// columns past dh with zeros); tiles and rings as SplitTile says.
//
//  * bwd_dq_wgmma_split_kernel: a block owns 64 query rows of one head; Q
//    and dO stay put, K and V tiles of BN keys stream through the ring.
//    Warpgroup 0 runs S = Q·Kᵀ and P, warpgroup 1 dP = dO·Vᵀ, D, and
//    dS = P ∘ (dP - D), which it hands back as bf16 A fragments; then each
//    accumulates half of dQ's columns, dQ[:, half] += dS·K[:, half]
//    (register A, K MN-major). S, dP and dQ once a kept pair: 6·dh.
//  * bwd_dkdv_wgmma_split_kernel: a block owns 64 keys of one KV head and
//    one slice of DV output columns (DV = DH up to 256; DH / 2 at 384 and
//    512, a block each); K and V stay put, Q and dO tiles of BQ queries
//    (with lse and D) stream through the ring over the g heads of the group.
//    Warpgroup 0 runs Sᵀ = K·Qᵀ, Pᵀ and dV += Pᵀ·dO[:, slice]; warpgroup 1
//    dPᵀ = V·dOᵀ, dSᵀ and dK += dSᵀ·Q[:, slice]. 8·dh a kept pair at one
//    slice, 12·dh at two.
// So a kept pair costs 14·dh at DH 256 and 18·dh at DH 384 and 512 (the
// tiled designs: 14·dh). Registers a consumer thread: dQ's half DH/4 + S or
// dP BN/2 + dS BN/4; dV or dK DV/2 + Sᵀ or dPᵀ BQ/2 + its fragments BQ/4
// (176 at DH 256, 120 at 384, 140 at 512; setmaxnreg gives 240). P and dS
// enter their products rounded to bf16, as at dh <= 128.

template <int DH>
struct SplitTile;
template <>
struct SplitTile<256> {
  static constexpr int BN = 64, DQ_STAGES = 2, BQ = 64, KV_STAGES = 2, DV = 256;
};
template <>
struct SplitTile<384> {
  static constexpr int BN = 32, DQ_STAGES = 2, BQ = 32, KV_STAGES = 2, DV = 192;
};
template <>
struct SplitTile<512> {
  static constexpr int BN = 16, DQ_STAGES = 2, BQ = 16, KV_STAGES = 2, DV = 256;
};

// The N of each accumulating wgmma over `cols` output columns.
__host__ __device__ constexpr int split_npv(int cols) { return cols % 128 == 0 ? 128 : 64; }

template <int DH>
struct DqSplitSmem {
  static constexpr int BN = SplitTile<DH>::BN, STAGES = SplitTile<DH>::DQ_STAGES;
  static constexpr uint32_t Q = 64 * DH * 2;                 // the Q tile, and the dO tile
  static constexpr uint32_t KV = BN * DH * 2;                // a K tile, and a V tile
  static constexpr uint32_t XP = BN / 2 * 128 * 4;           // P, warpgroup 0 -> 1
  static constexpr uint32_t XDS = BN / 16 * 4 * 128 * 4;     // dS fragments, warpgroup 1 -> 0
  static constexpr size_t bytes = 1024 + 2 * Q + (size_t)STAGES * 2 * KV + XP + XDS + (5 + 2 * STAGES) * 8;
};

template <int DH>
struct DkvSplitSmem {
  static constexpr int BQ = SplitTile<DH>::BQ, STAGES = SplitTile<DH>::KV_STAGES;
  static constexpr uint32_t KV = 64 * DH * 2;                // the K tile, and the V tile
  static constexpr uint32_t Q = BQ * DH * 2;                 // a Q tile, and a dO tile
  static constexpr uint32_t XP = BQ / 2 * 128 * 4;           // Pᵀ, warpgroup 0 -> 1
  static constexpr size_t bytes =
      1024 + 2 * KV + (size_t)STAGES * (2 * Q + 2 * BQ * sizeof(float)) + XP + (3 + 2 * STAGES) * 8;
};

// One consumer warpgroup of the dQ kernel: ROLE 0 computes S and P and
// owns dQ's columns [0, DH/2); ROLE 1 computes dP, D and dS and owns
// [DH/2, DH). x_bar: P full, P empty, dS full, dS empty.
template <int DH, int ROLE>
__device__ __forceinline__ void dq_split_consume(unsigned char* sq, unsigned char* sdo, unsigned char* sk,
                                                 unsigned char* sv, float* xp, uint32_t* xds, uint64_t* q_full,
                                                 uint64_t* full, uint64_t* empty, uint64_t* x_bar,
                                                 const __nv_bfloat16* __restrict__ o,
                                                 const __nv_bfloat16* __restrict__ dout,
                                                 const float* __restrict__ lse, float* __restrict__ delta,
                                                 __nv_bfloat16* __restrict__ dq, const Shape& sh, int q0, int h,
                                                 int b, int tile_lo, int n_tiles) {
  using M = DqSplitSmem<DH>;
  constexpr int BN = M::BN, STAGES = M::STAGES, HALF = DH / 2, NPV = split_npv(HALF), NCH = HALF / NPV;
  sm90::reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;  // this thread's rows: q0 + row0 and + 8
  const float c_log2 = sh.scale * kLog2e;
  const size_t q_row = (size_t)sh.Hq * sh.dh;
  const size_t q_off = (size_t)b * sh.S * q_row + (size_t)h * sh.dh;
  const size_t at0 = ((size_t)b * sh.Hq + h) * sh.S;
  uint64_t *p_full = x_bar, *p_empty = x_bar + 1, *ds_full = x_bar + 2, *ds_empty = x_bar + 3;

  // ROLE 0: each row's lse (log2 units); ROLE 1: D = dO · O, the four lanes
  // of a quad splitting the columns, written for the dK/dV launch. 0 past S.
  float rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + 8 * i;
    if constexpr (ROLE == 0) {
      rs[i] = r < sh.S ? lse[at0 + r] * kLog2e : 0.f;
    } else {
      float acc = 0.f;
      if (r < sh.S)
        for (int d = (lane & 3) * 8; d < sh.dh; d += 32) {
          const size_t at = q_off + (size_t)r * q_row + d;
          acc = dot8(*reinterpret_cast<const uint4*>(o + at), *reinterpret_cast<const uint4*>(dout + at), acc);
        }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      rs[i] = acc;
      if ((lane & 3) == 0 && r < sh.S) delta[at0 + r] = acc;
    }
  }

  float acc[BN / 2], dqacc[NCH][NPV / 2];
  uint32_t dsf[BN / 16][4];  // dS as wgmma A fragments
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < NPV / 2; ++e) dqacc[c][e] = 0.f;
  const uint32_t a_base = sm90::smem_u32(ROLE == 0 ? sq : sdo);
  const uint32_t b_base = sm90::smem_u32(ROLE == 0 ? sk : sv);
  const uint32_t k_base = sm90::smem_u32(sk);
  constexpr int col0 = ROLE * HALF;  // this warpgroup's dQ columns

  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1, xph = it & 1;
    const int t0 = (tile_lo + it) * BN;
    sm90::mbar_wait(&full[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::wgmma_ss(acc, kmajor(a_base, 64, kk), kmajor(b_base + s * M::KV, BN, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if constexpr (ROLE == 0) {
      // P; the mask only on tiles that cross the diagonal, the window's
      // lower edge or T.
      const bool need_mask = t0 + BN > sh.T || (sh.causal && t0 + BN - 1 > q0) ||
                             (sh.window > 0 && t0 <= q0 + 63 - sh.window);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i = (e >> 1) & 1;
        float p = ex2(fmaf(acc[e], c_log2, -rs[i]));
        if (need_mask) {
          const int qpos = q0 + row0 + i * 8;
          const int kpos = t0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
          bool keep = kpos < sh.T;
          if (sh.causal) keep = keep && kpos <= qpos;
          if (sh.window > 0) keep = keep && kpos > qpos - sh.window;
          if (!keep) p = 0.f;
        }
        acc[e] = p;
      }
      sm90::mbar_wait(p_empty, xph ^ 1);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) xp[e * 128 + tid] = acc[e];
      sm90::mbar_arrive(p_full);
      sm90::mbar_wait(ds_full, xph);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsf[kk][r] = xds[(kk * 4 + r) * 128 + tid];
      sm90::mbar_arrive(ds_empty);
    } else {
      sm90::mbar_wait(p_full, xph);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = xp[e * 128 + tid] * (acc[e] - rs[(e >> 1) & 1]);
      sm90::mbar_arrive(p_empty);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsf[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
      sm90::mbar_wait(ds_empty, xph ^ 1);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) xds[(kk * 4 + r) * 128 + tid] = dsf[kk][r];
      sm90::mbar_arrive(ds_full);
    }
    // dQ[:, col0 ..) += dS · K of stage s
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm90::fence_regs(dqacc[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::wgmma_rs_tb(dqacc[c], dsf[kk],
                          mnmajor(k_base + s * M::KV + (col0 + c * NPV) / kBox * BN * kRowBytes, BN, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm90::fence_regs(dqacc[c]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int srow = q0 + row0 + i * 8;
    if (srow >= sh.S) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NPV / 8; ++n) {
        const int d = col0 + c * NPV + n * 8 + (lane & 3) * 2;
        if (d < sh.dh)
          *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)srow * q_row + d) =
              pack_bf16(dqacc[c][4 * n + 2 * i] * sh.scale, dqacc[c][4 * n + 2 * i + 1] * sh.scale);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dq_wgmma_split_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                              const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, Shape sh) {
  using M = DqSplitSmem<DH>;
  constexpr int BN = M::BN, STAGES = M::STAGES, NBOX = DH / kBox;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sq = wg_smem + ((1024 - (sm90::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sdo = sq + M::Q;
  unsigned char* sk = sdo + M::Q;
  unsigned char* sv = sk + STAGES * M::KV;
  float* xp = reinterpret_cast<float*>(sv + STAGES * M::KV);
  uint32_t* xds = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(xp) + M::XP);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(xds) + M::XDS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* x_bar = empty + STAGES;  // P full, P empty, dS full, dS empty

  // Heavy tiles first: every (batch, head)'s last 64 query rows, then the ones before.
  const int hb_n = sh.Hq * sh.B;
  const int n_qt = (sh.S + 63) / 64;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / hb_n)) * 64;
  const int h = (int)(blockIdx.x % hb_n) % sh.Hq, b = (int)(blockIdx.x % hb_n) / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);

  // The KV tiles that some row of the block keeps (each tile of the band has a kept key).
  const int q_last = min(q0 + 64, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int tile_lo = kv_lo / BN;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN - tile_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    for (int x = 0; x < 4; ++x) sm90::mbar_init(&x_bar[x], 128);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);  // warp-uniform for ptxas
  if (wg == 2) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tdo);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_expect_tx(q_full, 2 * M::Q);
#pragma unroll
      for (int c = 0; c < NBOX; ++c) {
        sm90::tma_load_4d(sq + c * 64 * kRowBytes, &tq, q_full, c * kBox, h, q0, b);
        sm90::tma_load_4d(sdo + c * 64 * kRowBytes, &tdo, q_full, c * kBox, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int t0 = (tile_lo + it) * BN;
        sm90::mbar_expect_tx(&full[s], 2 * M::KV);
#pragma unroll
        for (int c = 0; c < NBOX; ++c) {
          sm90::tma_load_4d(sk + s * M::KV + c * BN * kRowBytes, &tk, &full[s], c * kBox, hk, t0, b);
          sm90::tma_load_4d(sv + s * M::KV + c * BN * kRowBytes, &tv, &full[s], c * kBox, hk, t0, b);
        }
      }
    }
  } else if (wg == 0) {
    dq_split_consume<DH, 0>(sq, sdo, sk, sv, xp, xds, q_full, full, empty, x_bar, o, dout, lse, delta, dq, sh, q0,
                            h, b, tile_lo, n_tiles);
  } else {
    dq_split_consume<DH, 1>(sq, sdo, sk, sv, xp, xds, q_full, full, empty, x_bar, o, dout, lse, delta, dq, sh, q0,
                            h, b, tile_lo, n_tiles);
  }
}

// One consumer warpgroup of the dK/dV kernel: ROLE 0 computes Sᵀ and Pᵀ
// and owns dV[:, c0 .. c0 + DV); ROLE 1 computes dPᵀ and dSᵀ and owns
// dK[:, c0 ..). x_bar: Pᵀ full, Pᵀ empty.
template <int DH, int ROLE>
__device__ __forceinline__ void dkdv_split_consume(unsigned char* sk, unsigned char* sv, unsigned char* sq,
                                                   unsigned char* sdo, const float* lse_s, const float* d_s,
                                                   float* xp, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
                                                   uint64_t* x_bar, __nv_bfloat16* __restrict__ dk,
                                                   __nv_bfloat16* __restrict__ dv, const Shape& sh, int k0, int c0,
                                                   int hk, int b, int qt_lo, int n_qt, int n_tiles) {
  using M = DkvSplitSmem<DH>;
  constexpr int BQ = M::BQ, STAGES = M::STAGES, DV = SplitTile<DH>::DV, NPV = split_npv(DV), NCH = DV / NPV;
  sm90::reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;  // this thread's keys: k0 + row0 and + 8
  const float c_log2 = sh.scale * kLog2e;
  uint64_t *p_full = x_bar, *p_empty = x_bar + 1;

  float acc[BQ / 2], oacc[NCH][NPV / 2];
  uint32_t frag[BQ / 16][4];  // Pᵀ or dSᵀ as wgmma A fragments
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < NPV / 2; ++e) oacc[c][e] = 0.f;
  const uint32_t a_base = sm90::smem_u32(ROLE == 0 ? sk : sv);
  const uint32_t b_base = sm90::smem_u32(ROLE == 0 ? sq : sdo);   // Sᵀ reads Q, dPᵀ reads dO
  const uint32_t o_base = sm90::smem_u32(ROLE == 0 ? sdo : sq);   // dV reads dO, dK reads Q

  sm90::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1, xph = it & 1;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    sm90::mbar_wait(&full[s], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::wgmma_ss(acc, kmajor(a_base, 64, kk), kmajor(b_base + s * M::Q, BQ, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if constexpr (ROLE == 0) {
      // Pᵀ: column (query) e's lse from the stage; the mask only where the
      // tile crosses the diagonal, the window's edge or S.
      const float* ls = lse_s + s * BQ;
      const bool need_mask = q0 + BQ > sh.S || (sh.causal && k0 + 63 > q0) ||
                             (sh.window > 0 && k0 <= q0 + BQ - 1 - sh.window);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        float p = ex2(fmaf(acc[e], c_log2, -ls[col]));
        if (need_mask) {
          const int qpos = q0 + col;
          const int kpos = k0 + row0 + ((e >> 1) & 1) * 8;
          bool keep = qpos < sh.S;
          if (sh.causal) keep = keep && kpos <= qpos;
          if (sh.window > 0) keep = keep && kpos > qpos - sh.window;
          if (!keep) p = 0.f;
        }
        acc[e] = p;
      }
      sm90::mbar_wait(p_empty, xph ^ 1);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) xp[e * 128 + tid] = acc[e];
      sm90::mbar_arrive(p_full);
    } else {
      const float* dl = d_s + s * BQ;
      sm90::mbar_wait(p_full, xph);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        acc[e] = xp[e * 128 + tid] * (acc[e] - dl[col]);
      }
      sm90::mbar_arrive(p_empty);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) frag[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
    // dV += Pᵀ · dO[:, slice] (ROLE 0), dK += dSᵀ · Q[:, slice] (ROLE 1)
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm90::fence_regs(oacc[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        sm90::wgmma_rs_tb(oacc[c], frag[kk],
                          mnmajor(o_base + s * M::Q + (c0 + c * NPV) / kBox * BQ * kRowBytes, BQ, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) sm90::fence_regs(oacc[c]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  const size_t kv_row = (size_t)sh.Hkv * sh.dh;
  const size_t kv_off = (size_t)b * sh.T * kv_row + (size_t)hk * sh.dh;
  __nv_bfloat16* out = ROLE == 0 ? dv : dk;
  const float scale = ROLE == 0 ? 1.f : sh.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tk = k0 + row0 + i * 8;
    if (tk >= sh.T) continue;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NPV / 8; ++n) {
        const int d = c0 + c * NPV + n * 8 + (lane & 3) * 2;
        if (d < sh.dh)
          *reinterpret_cast<uint32_t*>(out + kv_off + (size_t)tk * kv_row + d) =
              pack_bf16(oacc[c][4 * n + 2 * i] * scale, oacc[c][4 * n + 2 * i + 1] * scale);
      }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkdv_wgmma_split_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  using M = DkvSplitSmem<DH>;
  constexpr int BQ = M::BQ, STAGES = M::STAGES, NBOX = DH / kBox, DV = SplitTile<DH>::DV, NSL = DH / DV;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sk = wg_smem + ((1024 - (sm90::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sv = sk + M::KV;
  unsigned char* sq = sv + M::KV;
  unsigned char* sdo = sq + STAGES * M::Q;
  float* lse_s = reinterpret_cast<float*>(sdo + STAGES * M::Q);  // [STAGES][BQ], log2 units
  float* d_s = lse_s + STAGES * BQ;                               // [STAGES][BQ]
  float* xp = d_s + STAGES * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(xp) + M::XP);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* x_bar = empty + STAGES;  // Pᵀ full, Pᵀ empty

  // Heavy tiles first: under a causal mask the first key tiles are kept by the most queries.
  const int per = NSL * sh.Hkv * sh.B;
  const int k0 = (int)(blockIdx.x / per) * 64;
  const int rest = (int)(blockIdx.x % per);
  const int c0 = (rest % NSL) * DV, hk = (rest / NSL) % sh.Hkv, b = rest / NSL / sh.Hkv;
  const int g = sh.Hq / sh.Hkv;

  // The query tiles that keep any key of the block, walked for each of the g heads.
  const int k_last = min(k0 + 64, sh.T) - 1;
  const int q_lo = sh.causal ? k0 : 0;
  const int q_hi = sh.window > 0 ? min(sh.S, k_last + sh.window) : sh.S;
  const int qt_lo = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt_lo : 0;
  const int n_tiles = g * n_qt;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the TMA bytes' arrival and the 32 lanes that wrote lse and D
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_init(&x_bar[0], 128);
    sm90::mbar_init(&x_bar[1], 128);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x < 256 + 32) {  // the producer's first warp
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        sm90::tma_prefetch(&tq);
        sm90::tma_prefetch(&tdo);
        sm90::tma_prefetch(&tk);
        sm90::tma_prefetch(&tv);
        sm90::mbar_expect_tx(kv_full, 2 * M::KV);
#pragma unroll
        for (int c = 0; c < NBOX; ++c) {
          sm90::tma_load_4d(sk + c * 64 * kRowBytes, &tk, kv_full, c * kBox, hk, k0, b);
          sm90::tma_load_4d(sv + c * 64 * kRowBytes, &tv, kv_full, c * kBox, hk, k0, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int h = hk * g + it / n_qt;
        const int q0 = (qt_lo + it % n_qt) * BQ;
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], 2 * M::Q);
#pragma unroll
          for (int c = 0; c < NBOX; ++c) {
            sm90::tma_load_4d(sq + s * M::Q + c * BQ * kRowBytes, &tq, &full[s], c * kBox, h, q0, b);
            sm90::tma_load_4d(sdo + s * M::Q + c * BQ * kRowBytes, &tdo, &full[s], c * kBox, h, q0, b);
          }
        }
        const size_t at0 = ((size_t)b * sh.Hq + h) * sh.S;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < sh.S;
          lse_s[s * BQ + r] = in ? lse[at0 + q0 + r] * kLog2e : 0.f;
          d_s[s * BQ + r] = in ? delta[at0 + q0 + r] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else if (wg == 0) {
    dkdv_split_consume<DH, 0>(sk, sv, sq, sdo, lse_s, d_s, xp, kv_full, full, empty, x_bar, dk, dv, sh, k0, c0, hk,
                              b, qt_lo, n_qt, n_tiles);
  } else {
    dkdv_split_consume<DH, 1>(sk, sv, sq, sdo, lse_s, d_s, xp, kv_full, full, empty, x_bar, dk, dv, sh, k0, c0, hk,
                              b, qt_lo, n_qt, n_tiles);
  }
}

template <int DH>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                         void* dk, void* dv, const float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  constexpr int NSL = DH / SplitTile<DH>::DV;
  // Q and dO boxes of 64 rows (dQ) or BQ rows (dK/dV); K and V boxes of BN rows (dQ) or 64 rows (dK/dV)
  CUtensorMap q_dq, do_dq, k_dq, v_dq, q_kv, do_kv, k_kv, v_kv;
  const int BN = SplitTile<DH>::BN, BQ = SplitTile<DH>::BQ;
  cudaError_t err = sm90::make_map_bf16_4d(&q_dq, q, sh.dh, sh.Hq, sh.S, sh.B, kBox, 64);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&do_dq, dout, sh.dh, sh.Hq, sh.S, sh.B, kBox, 64);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&k_dq, k, sh.dh, sh.Hkv, sh.T, sh.B, kBox, BN);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&v_dq, v, sh.dh, sh.Hkv, sh.T, sh.B, kBox, BN);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&q_kv, q, sh.dh, sh.Hq, sh.S, sh.B, kBox, BQ);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&do_kv, dout, sh.dh, sh.Hq, sh.S, sh.B, kBox, BQ);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&k_kv, k, sh.dh, sh.Hkv, sh.T, sh.B, kBox, 64);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&v_kv, v, sh.dh, sh.Hkv, sh.T, sh.B, kBox, 64);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dq_wgmma_split_kernel<DH>, DqSplitSmem<DH>::bytes);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dkdv_wgmma_split_kernel<DH>, DkvSplitSmem<DH>::bytes);
  if (err != cudaSuccess) return err;
  const long long dq_blocks = (long long)((sh.S + 63) / 64) * sh.Hq * sh.B;
  const long long kv_blocks = (long long)((sh.T + 63) / 64) * NSL * sh.Hkv * sh.B;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bwd_dq_wgmma_split_kernel<DH><<<(unsigned)dq_blocks, kWgThreads, DqSplitSmem<DH>::bytes, stream>>>(
      q_dq, do_dq, k_dq, v_dq, static_cast<const Bf*>(o), static_cast<const Bf*>(dout), lse, delta,
      static_cast<Bf*>(dq), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma_split_kernel<DH><<<(unsigned)kv_blocks, kWgThreads, DkvSplitSmem<DH>::bytes, stream>>>(
      q_kv, do_kv, k_kv, v_kv, lse, delta, static_cast<Bf*>(dk), static_cast<Bf*>(dv), sh);
  return cudaGetLastError();
}

// ------------------------------------- f32 up to dh 256: 3xTF32 on mma.sync
//
// bwd_dq_tf32x3_kernel / bwd_dkdv_tf32x3_kernel replace an earlier CUDA-core
// pair (bwd_dq_kernel / bwd_dkdv_kernel), which the 67 TFLOP/s fp32 peak
// capped, which staged every tile element by element with nothing in
// flight, and which read each moving operand twice a tile (once
// transposed). Every product now runs on the tensor cores in TF32, split
// three ways so that the route keeps f32 accuracy (BWD_TOL 1e-4; one TF32
// pass keeps 11 bits, ~2^-11 a product): each f32 operand x becomes hi =
// tf32(x) (tf32_rna: cvt.rna.tf32.f32's rounding, to nearest, ties away)
// and lo = x - hi, whose f32 bits the tensor core reads as TF32 (its top 19
// bits: lo truncated), and a k8 step of a product is lo·hi + hi·lo +
// hi·hi, three mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 with f32 sums
// (lo·lo, ~2^-22 of a product, is dropped). Both kernels: 256 threads (8 warps),
// dh padded to a multiple of 8 by the wrapper and zero-filled to DH (32,
// 64, 128, 256) in shared memory. The split, the products, the staging and
// the stores are in tf32x3.cuh, shared with the f32 forward
// (flash_attention.cu's flash_fwd_tf32x3_kernel).
//
// Why mma.sync and not wgmma: wgmma takes TF32 from shared memory K-major
// only (its transpose bits are for 16-bit types), so dQ = dS·K, dK = dSᵀ·Q
// and dV = Pᵀ·dO would want Kᵀ, Qᵀ and dOᵀ tiles that TMA cannot make from
// row-major f32, and the lo halves would need tiles of their own. With
// mma.sync each thread loads its own fragments from one row-major staged
// tile, splits them in registers, and the same tile serves as the "row"
// operand (S-type products, contracting over d) and as the "transposed"
// one (the accumulating products, contracting over the tile's rows): every
// moving operand crosses from device memory once a tile.
//
// Fragments without a round trip: an m16n8 accumulator holds columns 2t and
// 2t + 1 of its n8 block (t = lane % 4) and a TF32 A fragment wants
// k-columns t and t + 4. The accumulating products contract over keys (dQ)
// or queries (dK, dV) in the permuted order k' = t -> 2t, t + 4 -> 2t + 1
// inside each 8-block, so S/dP accumulators become A fragments in place
// (P and dS never leave registers in the dQ kernel); B reads its rows in
// the same order (rows 2t and 2t + 1) and two n8 blocks' columns as one
// 8-byte load (columns 2g, 2g + 1 of a 16-column pair, g = lane / 4), so
// the output lands as float4s. Rows are DH + 4 floats apart: the S-type
// fragment reads (rows g, columns t) and the permuted 8-byte reads (rows 2t,
// columns 2g) are both free of bank conflicts.
//
// Sums over the band: the accumulating products run over every key (query)
// of the band, hundreds of k8 steps. Chained in the tensor core's
// accumulator, whose additions do not round to nearest, their error grew
// linearly with T and passed 1e-4 of dK's norm by T 16384; so each tile's
// products for a column pair are summed from zero (3 products a k8 step, a
// tile's few steps) and added to the running sums by f32 adds.
//
//  * bwd_dq_tf32x3_kernel: a block owns 64·MT query rows of one head (the
//    late, heavy causal tiles first); Q and dO are staged once, K and V
//    tiles of BN keys stream through a cp.async ring of DQ_STAGES stages
//    (16-byte copies, the next tiles in flight while this one computes, one
//    __syncthreads a tile). Warp w owns rows 16·MT·(w % 4) and the keys
//    BN/2 · (w / 4) of each tile: S and dP for them (once), P = exp2(S·scale
//    ·log2 e - lse·log2 e) where kept, dS = P ∘ (dP - D), and dQ += dS·K
//    over all DH columns; the two key halves' dQ are summed in shared
//    memory in a fixed order at the end. D = dO · O is computed first and
//    written for the second launch.
//  * bwd_dkdv_tf32x3_kernel: a block owns 64·MT keys of one KV head
//    (early, heavy keys first); K and V are staged once, Q and dO tiles of
//    BQ queries (with their lse and D) stream through the ring over the g
//    heads of the group and, per head, the query tiles that keep any key of
//    the block. dK and dV of 16 keys x DH do not both fit in a warp's
//    registers at DH 256 (2 x 128 a thread), so the block's 8 warps are 4
//    key groups of 2 roles: role 0 computes Sᵀ = K·Qᵀ, P, hands P to its
//    partner through shared memory (a named barrier of the pair) and
//    accumulates dV += Pᵀ·dO; role 1 computes dPᵀ = V·dOᵀ, dS = P ∘ (dPᵀ -
//    D) and dK += dSᵀ·Q. S and dP once a tile, each accumulator in one warp.
// One block of 8 warps an SM at DH 64, 128 and 256 (shared memory, and
// registers at 64). A kept pair costs 14·dh operations over both kernels
// at three passes each (S and dP in both): chip_smoke.py prices the bound
// at the lesser of the fp32 peak and three TF32 passes at the TF32 peak.
// Tiles that cross the causal diagonal, the window's edge or S / T compute
// the mask; warps whose rows (keys) a tile cannot keep skip it. No
// atomics: the result does not depend on the schedule.

// Per compiled width: MT m16 tiles a warp (16·MT stationary rows, 64·MT a
// block), BN keys a dQ tile and its ring stages, BQ queries a dK/dV tile
// and its stages. At DH 256 with few KV heads the dK/dV launch has about
// one block an SM, and the first (causal) key block, walking every query
// tile, takes twice the average (PERF.md §7). Two m16 tiles a warp share
// each loaded and split B fragment (half the B loads and splits a
// product): on the H100 that was faster at DH 64 and slower at DH 32, and
// at DH 128 and 256 32 rows' dK or dV alone would take 128 or 256
// registers a thread.
template <int DH>
struct TfTile;
template <>
struct TfTile<32> {
  static constexpr int MT = 1, BN = 64, DQ_STAGES = 3, BQ = 64, KV_STAGES = 3;
};
template <>
struct TfTile<64> {
  static constexpr int MT = 2, BN = 64, DQ_STAGES = 2, BQ = 32, KV_STAGES = 3;
};
template <>
struct TfTile<128> {
  static constexpr int MT = 1, BN = 64, DQ_STAGES = 2, BQ = 64, KV_STAGES = 2;
};
template <>
struct TfTile<256> {
  static constexpr int MT = 1, BN = 16, DQ_STAGES = 2, BQ = 16, KV_STAGES = 2;
};

// Shared memory (bytes): the two stationary tiles, the ring, and (dK/dV)
// the P hand-over, a float4 a lane for each m16 x n8 block of each of the
// four warp pairs.
template <int DH>
struct TfSmem {
  static constexpr int LD = DH + 4;  // row stride (floats)
  static constexpr int MT = TfTile<DH>::MT, BN = TfTile<DH>::BN, BQ = TfTile<DH>::BQ;
  static constexpr int ROWS = 64 * MT;                   // query rows a dQ block, keys a dK/dV block
  static constexpr int DQ_STAGE = 2 * BN * LD;           // floats: a K and a V tile
  static constexpr int KV_STAGE = 2 * BQ * LD + 2 * BQ;  // floats: a Q and a dO tile, lse, D
  static constexpr size_t p_bytes = (size_t)4 * MT * (BQ / 8) * 32 * 16;
  static constexpr size_t dq = (size_t)2 * ROWS * LD * 4 + (size_t)TfTile<DH>::DQ_STAGES * DQ_STAGE * 4;
  static constexpr size_t dkdv =
      (size_t)2 * ROWS * LD * 4 + (size_t)TfTile<DH>::KV_STAGES * KV_STAGE * 4 + p_bytes;
};

// 4 bytes by cp.async, or a zero when `valid` is false (src not read).
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void pair_arrive(int id) { asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void pair_sync(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory"); }

template <int DH>
__global__ void __launch_bounds__(kTfThreads, 1)
    bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta, Shape sh) {
  using M = TfSmem<DH>;
  constexpr int LD = DH + 4, MT = M::MT, ROWS = M::ROWS, BN = M::BN, STAGES = TfTile<DH>::DQ_STAGES;
  constexpr int NK = BN / kTfKeySplit, NB = NK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD] Q
  float* sdo = sq + ROWS * LD;                     // [ROWS][LD] dO
  float* ring = sdo + ROWS * LD;                   // STAGES x ([BN][LD] K, [BN][LD] V)

  // Heavy tiles first: every (batch, head)'s last query tile, then the one before.
  const int hb_n = sh.Hq * sh.B;
  const int n_qt = (sh.S + ROWS - 1) / ROWS;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / hb_n)) * ROWS;
  const int h = (int)(blockIdx.x % hb_n) % sh.Hq, b = (int)(blockIdx.x % hb_n) / sh.Hq;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t q_off = (size_t)b * sh.S * q_row + (size_t)h * dh;
  const float* kb = k + (size_t)b * sh.T * kv_row + (size_t)hk * dh;
  const float* vb = v + (size_t)b * sh.T * kv_row + (size_t)hk * dh;

  const int q_last = min(q0 + ROWS, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int tile_lo = kv_lo / BN;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN - tile_lo : 0;

  stage_tf<DH>(sq, q + q_off, q_row, q0, ROWS, sh.S, dh);
  stage_tf<DH>(sdo, dout + q_off, q_row, q0, ROWS, sh.S, dh);
  sm90::cp_async_commit();
  auto issue = [&](int it) {
    if (it < n_tiles) {
      float* st = ring + (it % STAGES) * M::DQ_STAGE;
      const int t0 = (tile_lo + it) * BN;
      stage_tf<DH>(st, kb, kv_row, t0, BN, sh.T, dh);
      stage_tf<DH>(st + BN * LD, vb, kv_row, t0, BN, sh.T, dh);
    }
    sm90::cp_async_commit();  // empty groups too: the waits count groups
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, ks = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * MT * rg;  // the warp's first row

  // D = dO · O and lse (log2 units) of rows r0 + 16m + g + 8i, the four
  // lanes of a quad splitting the columns 4 at a time; 0 past S.
  sm90::cp_async_wait<STAGES - 1>();  // Q and dO landed
  __syncthreads();
  const size_t at0 = ((size_t)b * sh.Hq + h) * sh.S;
  float dlt[MT][2], lse2[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = 16 * (MT * rg + m) + g + 8 * i, row = q0 + rr;
      float acc = 0.f;
      if (row < sh.S)
        for (int c = 4 * t; c < dh; c += 16)
          acc = dot4(ld4(sdo + rr * LD + c), ld4(o + q_off + (size_t)row * q_row + c), acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dlt[m][i] = acc;
      lse2[m][i] = row < sh.S ? lse[at0 + row] * kLog2e : 0.f;
      if (ks == 0 && t == 0 && row < sh.S) delta[at0 + row] = acc;
    }

  const float c_log2 = sh.scale * kLog2e;
  const int r_last = min(r0 + 16 * MT - 1, sh.S - 1);
  float dqa[MT][DH / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[m][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it visible; every warp is done with the stage refilled next
    issue(it + STAGES - 1);
    const float* sk = ring + (it % STAGES) * M::DQ_STAGE;
    const float* sv = sk + BN * LD;
    const int kw = (tile_lo + it) * BN + ks * NK;  // the warp's first key
    if (r0 >= sh.S || kw >= sh.T || (sh.causal && kw > r_last) ||
        (sh.window > 0 && kw + NK - 1 <= r0 - sh.window))
      continue;  // no (row, key) pair of the warp is kept
    float s[2][MT][NB][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[p][m][j][e] = 0.f;
    const int ar = 16 * MT * rg + g;
    const float* const pa[2] = {sq + ar * LD + t, sdo + ar * LD + t};
    const float* const pb[2] = {sk + (ks * NK + g) * LD + t, sv + (ks * NK + g) * LD + t};
    s_products<DH, MT, NB, 2>(s, pa, pb);  // S = Q·Kᵀ, dP = dO·Vᵀ
    const bool mask = !(kw + NK <= sh.T && r0 + 16 * MT <= sh.S && (!sh.causal || kw + NK - 1 <= r0) &&
                        (sh.window <= 0 || kw > r0 + 16 * MT - 1 - sh.window));
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = ex2(fmaf(s[0][m][j][e], c_log2, -lse2[m][i]));
          if (mask && !kept(r0 + 16 * m + g + 8 * i, kw + 8 * j + 2 * t + (e & 1), sh)) p = 0.f;
          s[1][m][j][e] = p * (s[1][m][j][e] - dlt[m][i]);  // dS
        }
    acc_product<DH, MT, NB>(dqa, s[1], sk + ks * NK * LD, g, t);  // dQ += dS·K
  }
  sm90::cp_async_wait<0>();

  // The key halves' dQ summed in a fixed order (half 1 through shared
  // memory into half 0), scaled, written.
  __syncthreads();  // every warp is done with Q and dO
  float* red = sq + rg * (MT * DH / 2) * 32 + lane;
  if (ks == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((m * DH / 8 + n) * 4 + e) * 32] = dqa[m][n][e];
  }
  __syncthreads();
  if (ks != 0) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[m][n][e] += red[((m * DH / 8 + n) * 4 + e) * 32];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * m + g + 8 * i;
      if (row < sh.S) store_rows<DH>(dq + q_off + (size_t)row * q_row, dqa[m], i, t, dh, sh.scale);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kTfThreads, 1)
    bwd_dkdv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                           Shape sh) {
  using M = TfSmem<DH>;
  constexpr int LD = DH + 4, MT = M::MT, ROWS = M::ROWS, BQ = M::BQ;
  constexpr int STAGES = TfTile<DH>::KV_STAGES, NB = BQ / 8, STAGE = M::KV_STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD] K
  float* sv = sk + ROWS * LD;                      // [ROWS][LD] V
  float* ring = sv + ROWS * LD;                    // STAGES x ([BQ][LD] Q, [BQ][LD] dO, lse [BQ], D [BQ])
  float4* ps = reinterpret_cast<float4*>(ring + STAGES * STAGE);  // [4 warp pairs][MT][NB][32 lanes] P

  // Heavy first: early keys (the most causal queries) of every (batch, KV head).
  const int hb_n = sh.Hkv * sh.B;
  const int k0 = (int)(blockIdx.x / hb_n) * ROWS;
  const int hk = (int)(blockIdx.x % hb_n) % sh.Hkv, b = (int)(blockIdx.x % hb_n) / sh.Hkv;
  const int grp = sh.Hq / sh.Hkv;
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const size_t kv_off = (size_t)b * sh.T * kv_row + (size_t)hk * dh;

  // The query rows that keep any key of the block: [q_lo, q_hi), in tiles
  // for each head of the group.
  const int k_last = min(k0 + ROWS, sh.T) - 1;
  const int q_lo = sh.causal ? k0 : 0;
  const int q_hi = sh.window > 0 ? min(sh.S, k_last + sh.window) : sh.S;
  const int qt_lo = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - qt_lo : 0;
  const int n_tiles = grp * n_qt;

  stage_tf<DH>(sk, k + kv_off, kv_row, k0, ROWS, sh.T, dh);
  stage_tf<DH>(sv, v + kv_off, kv_row, k0, ROWS, sh.T, dh);
  sm90::cp_async_commit();
  auto issue = [&](int it) {
    if (it < n_tiles) {
      float* st = ring + (it % STAGES) * STAGE;
      const int hq = hk * grp + it / n_qt, q0 = (qt_lo + it % n_qt) * BQ;
      const size_t q_off = (size_t)b * sh.S * q_row + (size_t)hq * dh;
      const size_t at0 = ((size_t)b * sh.Hq + hq) * sh.S;
      stage_tf<DH>(st, q + q_off, q_row, q0, BQ, sh.S, dh);
      stage_tf<DH>(st + BQ * LD, dout + q_off, q_row, q0, BQ, sh.S, dh);
      for (int r = threadIdx.x; r < 2 * BQ; r += kTfThreads) {
        const int row = q0 + r % BQ;
        const bool ok = row < sh.S;
        cp_async4_zfill(st + 2 * BQ * LD + r, (r < BQ ? lse : delta) + (ok ? at0 + row : 0), ok);
      }
    }
    sm90::cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) issue(it);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kg = warp % 4, role = warp / 4;  // role 0: S, P, dV; 1: dP, dS, dK
  const int g = lane / 4, t = lane % 4;
  const int kr0 = k0 + 16 * MT * kg;  // the warp's first key
  const float c_log2 = sh.scale * kLog2e;
  float acc[MT][DH / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it visible; every warp is done with the stage refilled next and with P
    issue(it + STAGES - 1);
    const float* sqt = ring + (it % STAGES) * STAGE;
    const float* sdot = sqt + BQ * LD;
    const float* lse_s = sqt + 2 * BQ * LD;
    const float* d_s = lse_s + BQ;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const int q_end = min(q0 + BQ, sh.S) - 1;
    const int kr_end = kr0 + 16 * MT - 1;
    if (kr0 >= sh.T || q0 >= sh.S || (sh.causal && kr0 > q_end) || (sh.window > 0 && q0 >= kr_end + sh.window))
      continue;  // no (key, query) pair of the warp pair is kept
    const bool mask = !(kr_end < sh.T && q0 + BQ <= sh.S && (!sh.causal || kr_end <= q0) &&
                        (sh.window <= 0 || kr0 > q0 + BQ - 1 - sh.window));
    float s[1][MT][NB][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][m][j][e] = 0.f;
    float4* pk = ps + kg * MT * NB * 32 + lane;
    const int ar = 16 * MT * kg + g;
    if (role == 0) {
      const float* const pa[1] = {sk + ar * LD + t};
      const float* const pb[1] = {sqt + g * LD + t};
      s_products<DH, MT, NB, 1>(s, pa, pb);  // Sᵀ = K·Qᵀ
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * t + (e & 1);
            float p = ex2(fmaf(s[0][m][j][e], c_log2, -lse_s[qi] * kLog2e));
            if (mask && !kept(q0 + qi, kr0 + 16 * m + g + 8 * (e >> 1), sh)) p = 0.f;
            s[0][m][j][e] = p;
          }
          pk[(m * NB + j) * 32] = make_float4(s[0][m][j][0], s[0][m][j][1], s[0][m][j][2], s[0][m][j][3]);
        }
      pair_arrive(1 + kg);
      acc_product<DH, MT, NB>(acc, s[0], sdot, g, t);  // dV += Pᵀ·dO
    } else {
      const float* const pa[1] = {sv + ar * LD + t};
      const float* const pb[1] = {sdot + g * LD + t};
      s_products<DH, MT, NB, 1>(s, pa, pb);  // dPᵀ = V·dOᵀ
      pair_sync(1 + kg);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 p4 = pk[(m * NB + j) * 32];
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][m][j][e] = pv[e] * (s[0][m][j][e] - d_s[8 * j + 2 * t + (e & 1)]);  // dSᵀ
        }
      acc_product<DH, MT, NB>(acc, s[0], sqt, g, t);  // dK += dSᵀ·Q
    }
  }
  sm90::cp_async_wait<0>();

  // dK takes the scale; dV does not.
  float* out = role == 0 ? dv : dk;
  const float sc = role == 0 ? 1.f : sh.scale;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = kr0 + 16 * m + g + 8 * i;
      if (row < sh.T) store_rows<DH>(out + kv_off + (size_t)row * kv_row, acc[m], i, t, dh, sc);
    }
}

template <int DH>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
                          void* dk, void* dv, const float* lse, float* delta, const Shape& sh, cudaStream_t stream) {
  using M = TfSmem<DH>;
  cudaError_t err = hqi::prepare(bwd_dq_tf32x3_kernel<DH>, M::dq);
  if (err == cudaSuccess) err = hqi::prepare(bwd_dkdv_tf32x3_kernel<DH>, M::dkdv);
  if (err != cudaSuccess) return err;
  const long long dq_blocks = (long long)((sh.S + M::ROWS - 1) / M::ROWS) * sh.Hq * sh.B;
  const long long kv_blocks = (long long)((sh.T + M::ROWS - 1) / M::ROWS) * sh.Hkv * sh.B;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  bwd_dq_tf32x3_kernel<DH><<<(unsigned)dq_blocks, kTfThreads, M::dq, stream>>>(
      qp, kp, vp, static_cast<const float*>(o), dop, lse, static_cast<float*>(dq), delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_tf32x3_kernel<DH><<<(unsigned)kv_blocks, kTfThreads, M::dkdv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), sh);
  return cudaGetLastError();
}

// The design at (padded) width dh: 0 the wgmma pair (bf16 to 128), 1 the
// split wgmma pair (bf16 129..512), 2 the 3xTF32 pair (f32 to 256), 3 the
// wide pair (f32 past 256, bf16 past 512).
int bwd_route(int dh, int bf16) { return bf16 ? (dh <= 128 ? 0 : dh <= 512 ? 1 : 3) : (dh <= 256 ? 2 : 3); }

int tf32_width(int dh) { return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }
int split_width(int dh) { return dh <= 256 ? 256 : dh <= 384 ? 384 : 512; }

}  // namespace

extern "C" {

// The launch plan at (padded) width dh, for flash_attention.py's
// backward_plan to be held against: out[9] = route, width compiled (the
// wide pair: dh rounded up to its chunk), column slices of the dQ and of
// the dK/dV kernel, their dynamic shared bytes, threads a block, and
// whether the wide pair's dQ and dK/dV kernels stage their stationary rows
// once (1) or stream them (0). Returns 0.
int flash_attention_bwd_plan(int dh, int bf16, int* out) {
  const int route = bwd_route(dh, bf16);
  int w = 0, sq = 1, skv = 1, thr = kWgThreads, st_q = 0, st_kv = 0;
  size_t mq = 0, mkv = 0;
  if (route == 0) {
    w = dh <= 64 ? 64 : 128;
    mq = w == 64 ? DqSmem<64>::bytes : DqSmem<128>::bytes;
    mkv = w == 64 ? DkvSmem<64>::bytes : DkvSmem<128>::bytes;
  } else if (route == 1) {
    w = split_width(dh);
    mq = w == 256 ? DqSplitSmem<256>::bytes : w == 384 ? DqSplitSmem<384>::bytes : DqSplitSmem<512>::bytes;
    mkv = w == 256 ? DkvSplitSmem<256>::bytes : w == 384 ? DkvSplitSmem<384>::bytes : DkvSplitSmem<512>::bytes;
    skv = w / (w == 256 ? SplitTile<256>::DV : w == 384 ? SplitTile<384>::DV : SplitTile<512>::DV);
  } else if (route == 2) {
    w = tf32_width(dh);
    mq = w == 32 ? TfSmem<32>::dq : w == 64 ? TfSmem<64>::dq : w == 128 ? TfSmem<128>::dq : TfSmem<256>::dq;
    mkv = w == 32    ? TfSmem<32>::dkdv
          : w == 64  ? TfSmem<64>::dkdv
          : w == 128 ? TfSmem<128>::dkdv
                     : TfSmem<256>::dkdv;
    thr = kTfThreads;
  } else {
    const int es = bf16 ? 2 : 4;
    const WidePlan pq = wide_plan(dh, es, 0), pk = wide_plan(dh, es, 1);
    w = pq.dhc;
    sq = pq.slices, skv = pk.slices;
    mq = pq.smem, mkv = pk.smem;
    thr = kWideThreads;
    st_q = pq.stationary, st_kv = pk.stationary;
  }
  const int vals[9] = {route, w, sq, skv, (int)mq, (int)mkv, thr, st_q, st_kv};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// dq, dk, dv (the inputs' type) of flash_attention, from the training
// forward's lse (f32 [B, Hq, S]); delta is f32 [B, Hq, S] scratch the
// wrapper allocates (dO · O, written by the first kernel, read by the
// second). Every route wants dh a multiple of 8 and 16-byte aligned
// operands (the wrapper pads and copies).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, const void* lse, void* delta, int B, int S, int T,
                               int Hq, int Hkv, int dh, int causal, int window, float scale, int bf16,
                               void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || B > 65535 ||
      (long long)Hq * 2 > 65535)
    return (int)cudaErrorInvalidValue;
  const int route = bwd_route(dh, bf16);
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (dh % 8 != 0) return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, Hq, Hkv, dh, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaError_t err;
  if (route == 0) {
    err = dh <= 64 ? launch_wgmma<64>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
                   : launch_wgmma<128>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st);
  } else if (route == 1) {
    const int w = split_width(dh);
    err = w == 256   ? launch_split<256>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
          : w == 384 ? launch_split<384>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
                     : launch_split<512>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st);
  } else if (route == 2) {
    const int w = tf32_width(dh);
    err = w == 32    ? launch_tf32x3<32>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
          : w == 64  ? launch_tf32x3<64>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
          : w == 128 ? launch_tf32x3<128>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
                     : launch_tf32x3<256>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st);
  } else {
    err = bf16 ? launch_wide<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st)
               : launch_wide<float>(q, k, v, o, dout, dq, dk, dv, l, d, sh, st);
  }
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(flash_attention_bwd_error_string)
