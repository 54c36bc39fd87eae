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
// f32 (flash_fwd_tf32x3_kernel, its own section below): both products on
// the tensor cores too, as three TF32 mma.sync products a k8 step on hi/lo
// splits of each operand (tf32x3.cuh), which keep f32's 1e-4 agreement
// where one TF32 pass (a 10-bit mantissa) would not. Q is scaled and split
// once a block; K and V tiles come through a cp.async ring; P enters P·V as
// A fragments in registers. dh is a multiple of 8 here too (the wrapper
// pads it) and is zero-filled to DH in {32, 64, 128, 256}.
//
// Both kernels skip KV tiles wholly outside the block's band (kv_lo,
// kv_hi], schedule the heavy (late causal) query tiles first, and take the
// window as a runtime int, so one build serves every layer. Past dh 256
// (flash_attention_wide, its own section below) the bf16 kernel runs at DH
// 384 and 512 with O in column slices, and past that, and for f32, a
// sliced CUDA-core kernel takes any width.
//
// Training: every kernel also takes an optional lse pointer, f32 [B, Hq,
// S]: when it is not null the kernel writes each row's log-sum-exp of its
// kept logits, lse = m + ln l in the natural log of (q·k)·scale (the bf16
// kernel keeps m and l in log2 units and converts them back), NEG_INF for a
// row that keeps no key; the backward (flash_attention_bwd.cu) reads it
// instead of recomputing the statistics. A null pointer is serving: the
// outputs and the launches are those of a kernel without the argument.
//
// Plain C interface for ctypes: pointers and the stream are void*; the entry
// returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"
#include "topk.cuh"

namespace {

using namespace tf32x3;

constexpr int kBQ = 64;         // query rows per block (flash_sliced_kernel)
constexpr int kBK = 64;         // keys per KV tile (flash_sliced_kernel)
constexpr int kPad = 4;         // row padding of the transposed tiles (floats)
constexpr int kStrideQ = kBQ + kPad;
constexpr int kStrideK = kBK + kPad;
constexpr float kNegInf = -3.0e38f;  // models/attention.py NEG_INF, not the scan kernels'
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int B, S, T, Hq, Hkv, dh, causal, window;
  float scale;
};

// acc += P · V over the tile's kBK keys: V rows of `stride` floats, the
// thread's output columns u·32 + tx·4 + j.
template <int kCols>
__device__ __forceinline__ void pv_tile(float (&acc)[4][kCols], const float* pt, const float* vt, int stride,
                                        int ty, int tx) {
#pragma unroll 2
  for (int j = 0; j < kBK; ++j) {
    const float4 pa = *reinterpret_cast<const float4*>(pt + j * kStrideQ + ty * 4);
    const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
    for (int u = 0; u < kCols / 4; ++u) {
      const float4 va = *reinterpret_cast<const float4*>(vt + j * stride + u * 32 + tx * 4);
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

// Per padded width: keys per KV tile, ring stages, the N of each O += P·V
// wgmma, and the output columns a block owns, DV (O is DV / NPV accumulators
// of 64 x NPV). Registers per consumer thread: S BN/2, O DV/2, P hi and lo
// BN/4 each (under the 240 setmaxnreg gives). Up to 256 a block owns every
// column (DV = DH). Past it (flash_attention_wide) O comes in column slices
// of DV, each its own block, because a warpgroup's O at 64 x 512 would be
// 256 registers a thread; each block sums the logits over all DH columns
// (DH / 16 k-steps of one S accumulator), so S is computed once a slice
// (1.5x the products at dh 512). Shared memory at DH 512: Q 128 KiB, two
// stages of K (32 keys x 512, 32 KiB) and V (32 keys x 256, 16 KiB): 224
// KiB; at DH 384: Q 96 KiB and three stages of 24 + 12 KiB.
template <int DH>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BN = 128, STAGES = 4, NPV = 64, DV = 64;
};
template <>
struct Tile<128> {
  static constexpr int BN = 128, STAGES = 3, NPV = 128, DV = 128;
};
template <>
struct Tile<256> {
  static constexpr int BN = 64, STAGES = 2, NPV = 128, DV = 256;
};
template <>
struct Tile<384> {
  static constexpr int BN = 32, STAGES = 3, NPV = 64, DV = 192;
};
template <>
struct Tile<512> {
  static constexpr int BN = 32, STAGES = 2, NPV = 128, DV = 256;
};

template <int DH>
struct Smem {
  static constexpr uint32_t Q = kBM * DH * 2;                  // Q tile, DH / 64 boxes of [kBM][64]
  static constexpr uint32_t K = Tile<DH>::BN * DH * 2;         // one K tile, boxes of [BN][64]
  static constexpr uint32_t V = Tile<DH>::BN * Tile<DH>::DV * 2;  // one V tile of the block's columns
  static constexpr size_t bytes =
      1024 /* alignment slack */ + Q + (size_t)Tile<DH>::STAGES * (K + V) + (1 + 3 * Tile<DH>::STAGES) * 8;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// One consumer warpgroup (wg 0 or 1): query rows q0 + 64·wg .. + 63, output
// columns c0 .. c0 + DV - 1.
template <int DH>
__device__ __forceinline__ void consume(unsigned char* sq, unsigned char* sk, unsigned char* sv,
                                        uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
                                        uint64_t* empty, __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, const Shape& sh, int wg, int q0, int h,
                                        int b, int c0, int tile_lo, int n_tiles) {
  constexpr int BN = Tile<DH>::BN, STAGES = Tile<DH>::STAGES, NPV = Tile<DH>::NPV;
  constexpr int NCH = Tile<DH>::DV / NPV;
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
    const uint32_t addr = v_base + s * Smem<DH>::V + (c * NPV / kBox) * BN * kRowBytes + kk * 16 * kRowBytes;
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
      const uint32_t ka = k_base + s * Smem<DH>::K + (kk / 4) * BN * kRowBytes + off;
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

  // o = acc / max(l, 1e-30), written as bf16 pairs (dh is a multiple of 8);
  // lse (training) back in the natural log: (ms + log2 l) · ln 2.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int srow = wq0 + row0 + i * 8;
    if (lse != nullptr && c0 == 0 && (lane & 3) == 0 && srow < sh.S)
      lse[((size_t)b * sh.Hq + h) * sh.S + srow] = l[i] > 0.f ? (ms[i] + log2f(l[i])) * 0.6931471805599453f : kNegInf;
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
        const int d = c0 + c * NPV + n * 8 + (lane & 3) * 2;
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
                           float* __restrict__ lse, Shape sh, int slices) {
  constexpr int BN = Tile<DH>::BN, STAGES = Tile<DH>::STAGES, NBOX = DH / kBox;
  constexpr int VBOX = Tile<DH>::DV / kBox;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // Swizzled tiles need 1024-byte aligned bases.
  unsigned char* sq = wg_smem + ((1024 - (sm90::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sk = sq + Smem<DH>::Q;
  unsigned char* sv = sk + STAGES * Smem<DH>::K;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * Smem<DH>::V);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // Heavy tiles first: every (batch, head, column slice)'s last query tile,
  // then the one before.
  const int hb_n = sh.Hq * sh.B * slices;
  const int n_qt = (sh.S + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / hb_n)) * kBM;
  const int hbs = (int)(blockIdx.x % hb_n);
  const int c0 = (hbs % slices) * Tile<DH>::DV;
  const int h = (hbs / slices) % sh.Hq;
  const int b = (hbs / slices) / sh.Hq;
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
        unsigned char* ks = sk + s * Smem<DH>::K;
        unsigned char* vs = sv + s * Smem<DH>::V;
        sm90::mbar_expect_tx(&k_full[s], Smem<DH>::K);
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
          sm90::tma_load_4d(ks + c * BN * kRowBytes, &tk, &k_full[s], c * kBox, hk, t0, b);
        sm90::mbar_expect_tx(&v_full[s], Smem<DH>::V);
#pragma unroll
        for (int c = 0; c < VBOX; ++c)
          sm90::tma_load_4d(vs + c * BN * kRowBytes, &tv, &v_full[s], c0 + c * kBox, hk, t0, b);
      }
    }
  } else {
    consume<DH>(sq, sk, sv, q_full, k_full, v_full, empty, o, lse, sh, wg, q0, h, b, c0, tile_lo, n_tiles);
  }
}

__host__ inline long long wgmma_blocks(const Shape& sh, int slices) {
  return (long long)((sh.S + kBM - 1) / kBM) * sh.Hq * sh.B * slices;
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map_bf16_4d(&tq, q, sh.dh, sh.Hq, sh.S, sh.B, kBox, kBM);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&tk, k, sh.dh, sh.Hkv, sh.T, sh.B, kBox, Tile<DH>::BN);
  if (err == cudaSuccess) err = sm90::make_map_bf16_4d(&tv, v, sh.dh, sh.Hkv, sh.T, sh.B, kBox, Tile<DH>::BN);
  if (err != cudaSuccess) return err;
  const size_t smem = Smem<DH>::bytes;
  err = hqi::prepare(flash_fwd_wgmma_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int slices = (sh.dh + Tile<DH>::DV - 1) / Tile<DH>::DV;
  const long long blocks = wgmma_blocks(sh, slices);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_wgmma_kernel<DH><<<(unsigned)blocks, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sh, slices);
  return cudaGetLastError();
}

cudaError_t launch_bf16_dh(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
                           cudaStream_t stream) {
  if (sh.dh % 8 != 0) return cudaErrorInvalidValue;  // TMA strides: the wrapper pads dh to 8
  if (sh.dh <= 64) return launch_bf16<64>(q, k, v, o, lse, sh, stream);
  if (sh.dh <= 128) return launch_bf16<128>(q, k, v, o, lse, sh, stream);
  return launch_bf16<256>(q, k, v, o, lse, sh, stream);
}

// ------------------------------------- f32 up to dh 256: 3xTF32 on mma.sync
//
// flash_fwd_tf32x3_kernel replaces an earlier CUDA-core kernel
// (flash_fwd_kernel), which the 67 TFLOP/s fp32 peak capped, which staged
// Q, K and V element by element (K transposed, K and V in one buffer: four
// __syncthreads a tile, nothing in flight during the products) and which
// passed P through shared memory. Both products run on the tensor cores as
// 3xTF32 (tf32x3.cuh: hi rounded on the bits, lo = x - hi handed over as it
// stands, so a NaN operand stays NaN; three mma.sync.m16n8k8 a k8 step; f32
// sums), which keeps f32's 1e-4 where one TF32 pass would not. The design is the backward's dQ kernel
// (bwd_dq_tf32x3_kernel) without dO and dP, with an online softmax in place
// of the stored lse and O += P·V in place of dQ += dS·K:
//  * a block of 256 threads (8 warps) owns 64·MT query rows of one head (the
//    late, heavy causal tiles first). Q lands once by 16-byte cp.async in the
//    ring, is scaled (q·scale in f32, as the plain version) and split into
//    TF32 hi/lo A fragments once for the block, stored in fragment order
//    (one float4 of hi and one of lo a lane a k8 step: two conflict-free
//    16-byte reads where splitting the staged tile would take four reads and
//    twelve integer and float operations, every tile);
//  * K and V tiles of BN keys stream through a cp.async ring of STAGES
//    stages, the next tiles in flight while this one computes, one
//    __syncthreads a tile. Both are row-major with rows DH + 4 floats apart:
//    K as the B operand of S = (q·scale)·Kᵀ is read at row g, column t (bank
//    4g + t), V as the B operand of P·V at rows 2t, 2t + 1, columns 2g, 2g + 1
//    (one 8-byte read, banks 8t + 2g a half-warp at a time): both
//    conflict-free, so one stride serves both tiles;
//  * warp w owns rows 16·MT·(w % 4) and the keys BN/2·(w / 4) of each tile
//    (kTfKeySplit): S for them (B fragments split once for the MT m16 tiles),
//    the mask where the tile crosses the causal diagonal, the window's lower
//    edge or T, and its own online softmax (m in log2 units, p =
//    ex2(S·log2 e - m), l a thread's share); P stays in registers and enters
//    O += P·V as A fragments in the permuted key order (acc_product), V's
//    rows read in the same order. Each tile's P·V is summed from zero and
//    added to the running O in f32 as O = fmaf(O, alpha, tile) (O is not
//    chained through the accumulator across tiles: such sums drift with T);
//  * at the end the two key halves of a row group merge in a fixed order
//    through shared memory (m, l and O of half 1 rescaled into half 0's),
//    and half 0 writes o = O / max(l, 1e-30) and, for training, lse = (m +
//    log2 l)·ln 2 (NEG_INF for a row that keeps no key).
// What bounds it: 4·dh operations a kept pair and head, three TF32 passes at
// 495 TFLOP/s (chip_smoke.py prices the bound at the lesser of that and the
// fp32 peak). No atomics: the output does not depend on the schedule, and it
// is the same with and without the lse pointer.

// Per compiled width: MT m16 tiles a warp (64·MT query rows a block), BN keys
// a K/V tile, STAGES ring stages, BLOCKS blocks an SM the registers are
// capped for, SACC accumulators of S (qk_products). Two m16 tiles a warp at
// DH 64 share each split K and V fragment: faster on the H100 than one tile
// at two blocks an SM (128 registers), and than 32- or 48-key tiles, though
// it takes 255 registers and spills 24 bytes. At DH 256 Q's hi and lo
// fragments take 128 KiB, so the ring holds two stages of 16 keys (the
// backward's dQ tile), one block fits an SM, and a warp's S (one n8 block of
// 8 keys) is summed in four chains of k8 steps.
template <int DH>
struct FwdTile;
template <>
struct FwdTile<32> {
  static constexpr int MT = 1, BN = 64, STAGES = 3, BLOCKS = 2, SACC = 1;
};
template <>
struct FwdTile<64> {
  static constexpr int MT = 2, BN = 64, STAGES = 2, BLOCKS = 1, SACC = 1;
};
template <>
struct FwdTile<128> {
  static constexpr int MT = 1, BN = 64, STAGES = 2, BLOCKS = 1, SACC = 1;
};
template <>
struct FwdTile<256> {
  static constexpr int MT = 1, BN = 16, STAGES = 2, BLOCKS = 1, SACC = 4;
};

// Shared memory: Q's hi and lo fragments [64·MT / 16][DH / 8][32 lanes]
// float4 each, and the ring of K and V tiles [BN][DH + 4]. Q lands in the
// ring (rows DH + 4 apart) before it is split, and the end's merge reuses
// the fragments' space.
template <int DH>
struct FwdSmem {
  static constexpr int LD = DH + 4;
  static constexpr int MT = FwdTile<DH>::MT, BN = FwdTile<DH>::BN, ROWS = 64 * MT;
  static constexpr int QF = ROWS * DH;         // floats: Q's hi (and again its lo) fragments
  static constexpr int STAGE = 2 * BN * LD;     // floats: a K and a V tile
  static constexpr size_t bytes = (size_t)2 * QF * 4 + (size_t)FwdTile<DH>::STAGES * STAGE * 4;
  static_assert(FwdTile<DH>::STAGES * STAGE >= ROWS * LD, "Q lands in the ring before it is split");
  static_assert(bytes <= 232448, "a block's shared memory");
};

// s[m][j] = (q·scale)[16 rows of m16 tile m][DH] · K[8 keys of n8 block j][DH]ᵀ
// in three TF32 products a k8 step: A from Q's split fragments (qf: the
// warp's first m16 tile's hi at this lane; lo QF / 4 float4 further), B read
// at element (g, t) of the warp's first key row (kb) and split once for the
// MT tiles. The k8 steps go round-robin to SACC accumulators of each block,
// summed at the end: a warp with few blocks (MT·NB) would otherwise wait on
// one chain of 3·DH/8 dependent mma.sync.
template <int DH, int MT, int NB, int SACC>
__device__ __forceinline__ void qk_products(float (&s)[MT][NB][4], const float4* qf, const float* kb) {
  constexpr int LD = DH + 4, KD = DH / 8, QF4 = FwdSmem<DH>::QF / 4;
  static_assert(KD % SACC == 0, "the k8 steps split evenly over the accumulators");
  float part[SACC][MT][NB][4];
#pragma unroll
  for (int c = 0; c < SACC; ++c)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c][m][j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < KD; k0 += SACC) {
#pragma unroll
    for (int c = 0; c < SACC; ++c) {
      const int kk = k0 + c;
      TfA fa[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 hi = qf[(m * KD + kk) * 32], lo = qf[(m * KD + kk) * 32 + QF4];
        fa[m].hi[0] = __float_as_uint(hi.x), fa[m].hi[1] = __float_as_uint(hi.y);
        fa[m].hi[2] = __float_as_uint(hi.z), fa[m].hi[3] = __float_as_uint(hi.w);
        fa[m].lo[0] = __float_as_uint(lo.x), fa[m].lo[1] = __float_as_uint(lo.y);
        fa[m].lo[2] = __float_as_uint(lo.z), fa[m].lo[3] = __float_as_uint(lo.w);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* bp = kb + j * 8 * LD + 8 * kk;
        const TfB fb = split_b(bp[0], bp[4]);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(part[c][m][j], fa[m], fb);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = part[0][m][j][e];
#pragma unroll
        for (int c = 1; c < SACC; ++c) x += part[c][m][j][e];
        s[m][j][e] = x;
      }
}

// The running O rescaled and a tile's P·V added in one rounding:
// acc_product's add for row g + 8·(e / 2) of m16 tile m.
template <int MT>
struct RescaleAdd {
  float alpha[MT][2];
  __device__ __forceinline__ float operator()(int m, int e, float acc, float d) const {
    return fmaf(acc, alpha[m][e >> 1], d);
  }
};

template <int DH>
__global__ void __launch_bounds__(kTfThreads, FwdTile<DH>::BLOCKS)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse, Shape sh) {
  using M = FwdSmem<DH>;
  constexpr int LD = M::LD, MT = M::MT, ROWS = M::ROWS, BN = M::BN, STAGES = FwdTile<DH>::STAGES;
  constexpr int NK = BN / kTfKeySplit, NB = NK / 8, KD = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* qf = reinterpret_cast<float4*>(smem_raw);                   // [ROWS / 16][KD][32] hi, then lo
  float* ring = reinterpret_cast<float*>(smem_raw) + 2 * M::QF;        // STAGES x ([BN][LD] K, [BN][LD] V)

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

  // The keys any row of the block may keep, (kv_lo - 1, kv_hi), and their tiles.
  const int q_last = min(q0 + ROWS, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int tile_lo = kv_lo / BN;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN - tile_lo : 0;

  // Q through the ring: scaled in f32 and split into fragments once.
  stage_tf<DH>(ring, q + q_off, q_row, q0, ROWS, sh.S, dh);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < M::QF / 4; e += kTfThreads) {
    // fragment e: lane e % 32 (g, t), k8 step (e / 32) % KD, m16 tile e / (32·KD)
    const int fl = e % 32, kk = (e / 32) % KD, r16 = e / (32 * KD);
    const float* x = ring + (16 * r16 + fl / 4) * LD + 8 * kk + fl % 4;
    const TfA f = split_a(x[0] * sh.scale, x[8 * LD] * sh.scale, x[4] * sh.scale, x[8 * LD + 4] * sh.scale);
    qf[e] = make_float4(__uint_as_float(f.hi[0]), __uint_as_float(f.hi[1]), __uint_as_float(f.hi[2]),
                        __uint_as_float(f.hi[3]));
    qf[e + M::QF / 4] = make_float4(__uint_as_float(f.lo[0]), __uint_as_float(f.lo[1]), __uint_as_float(f.lo[2]),
                                    __uint_as_float(f.lo[3]));
  }
  __syncthreads();  // the ring is free for K and V
  auto issue = [&](int it) {
    if (it < n_tiles) {
      float* st = ring + (it % STAGES) * M::STAGE;
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
  const int r_end = r0 + 16 * MT - 1;
  const float4* qw = qf + MT * rg * KD * 32 + lane;

  float oacc[MT][KD][4];
  float ms[MT][2], l[MT][2];  // running max (log2 units) and this thread's share of the row sums
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < 2; ++i) ms[m][i] = kNegInf, l[m][i] = 0.f;
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[m][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it visible; every warp is done with the stage refilled next
    issue(it + STAGES - 1);
    const float* sk = ring + (it % STAGES) * M::STAGE;
    const float* sv = sk + BN * LD;
    const int kw = (tile_lo + it) * BN + ks * NK;  // the warp's first key
    if (r0 >= sh.S || kw >= sh.T || (sh.causal && kw > min(r_end, sh.S - 1)) ||
        (sh.window > 0 && kw + NK - 1 <= r0 - sh.window))
      continue;  // no (row, key) pair of the warp is kept
    float s[MT][NB][4];
    qk_products<DH, MT, NB, FwdTile<DH>::SACC>(s, qw, sk + (ks * NK + g) * LD + t);  // S = (q·scale)·Kᵀ

    // Mask only the tiles that cross the diagonal, the window's lower edge
    // or T; masked logits become -inf, so p = ex2(-inf) = 0.
    if (kw + NK > sh.T || (sh.causal && kw + NK - 1 > r0) || (sh.window > 0 && kw <= r_end - sh.window)) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = r0 + 16 * m + g + 8 * (e >> 1), kpos = kw + 8 * j + 2 * t + (e & 1);
            bool keep = kpos < sh.T;
            if (sh.causal) keep = keep && kpos <= qpos;
            if (sh.window > 0) keep = keep && kpos > qpos - sh.window;
            if (!keep) s[m][j][e] = -INFINITY;
          }
    }

    // Online softmax of this thread's rows; the four lanes of a quad share a row.
    RescaleAdd<MT> rescale;  // each row's alpha
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NB; ++j) mx = fmaxf(mx, fmaxf(s[m][j][2 * i], s[m][j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(ms[m][i], mx * kLog2e);
        rescale.alpha[m][i] = ex2(ms[m][i] - m_new);
        ms[m][i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(fmaf(s[m][j][2 * i + c], kLog2e, -m_new));
            s[m][j][2 * i + c] = p;
            rs += p;
          }
        l[m][i] = fmaf(l[m][i], rescale.alpha[m][i], rs);
      }
    // O = O·alpha + P·V over the warp's keys (P as A fragments in the permuted key order)
    acc_product<DH, MT, NB>(oacc, s, sv + ks * NK * LD, g, t, rescale);
  }
  sm90::cp_async_wait<0>();

  // The key halves merged in a fixed order (half 1 through shared memory
  // into half 0), then o and lse written.
  __syncthreads();  // every warp is done with Q's fragments
  float* red = reinterpret_cast<float*>(smem_raw) + rg * (MT * (KD * 4 + 4)) * 32 + lane;
  if (ks == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < KD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((m * KD + n) * 4 + e) * 32] = oacc[m][n][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        red[(MT * KD * 4 + 4 * m + i) * 32] = ms[m][i];
        red[(MT * KD * 4 + 4 * m + 2 + i) * 32] = l[m][i];
      }
    }
  }
  __syncthreads();
  if (ks != 0) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = red[(MT * KD * 4 + 4 * m + i) * 32], l1 = red[(MT * KD * 4 + 4 * m + 2 + i) * 32];
      const float mm = fmaxf(ms[m][i], m1);
      a0[i] = ex2(ms[m][i] - mm), a1[i] = ex2(m1 - mm);
      ms[m][i] = mm;
      l[m][i] = l[m][i] * a0[i] + l1 * a1[i];
      l[m][i] += __shfl_xor_sync(0xffffffffu, l[m][i], 1);
      l[m][i] += __shfl_xor_sync(0xffffffffu, l[m][i], 2);
    }
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[m][n][e] = oacc[m][n][e] * a0[e >> 1] + red[((m * KD + n) * 4 + e) * 32] * a1[e >> 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 16 * m + g + 8 * i;
      if (row >= sh.S) continue;
      if (lse != nullptr && t == 0)
        lse[((size_t)b * sh.Hq + h) * sh.S + row] =
            l[m][i] > 0.f ? (ms[m][i] + log2f(l[m][i])) * 0.6931471805599453f : kNegInf;
      store_rows<DH>(o + q_off + (size_t)row * q_row, oacc[m], i, t, dh, 1.f / fmaxf(l[m][i], 1e-30f));
    }
  }
}

template <int DH>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
                          cudaStream_t stream) {
  using M = FwdSmem<DH>;
  cudaError_t err = hqi::prepare(flash_fwd_tf32x3_kernel<DH>, M::bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((sh.S + M::ROWS - 1) / M::ROWS) * sh.Hq * sh.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_tf32x3_kernel<DH><<<(unsigned)blocks, kTfThreads, M::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, sh);
  return cudaGetLastError();
}

cudaError_t launch_tf32x3_dh(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
                             cudaStream_t stream) {
  // 16-byte cp.async rows and float4 stores: the wrapper pads dh to a multiple of 8 and aligns the bases
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  if (sh.dh % 8 != 0) return cudaErrorInvalidValue;
  if (sh.dh <= 32) return launch_tf32x3<32>(q, k, v, o, lse, sh, stream);
  if (sh.dh <= 64) return launch_tf32x3<64>(q, k, v, o, lse, sh, stream);
  if (sh.dh <= 128) return launch_tf32x3<128>(q, k, v, o, lse, sh, stream);
  return launch_tf32x3<256>(q, k, v, o, lse, sh, stream);
}

// ------------------------------------------------- dh > 256
//
// flash_attention_wide takes the widths the tiled kernels above do not (at
// dh 512 their tiles exceed a block's shared memory and a warpgroup's O its
// registers). Two kernels, both computing O in column slices of at most 256
// with the logits summed over dh in slices:
//   * bf16 up to dh 512: flash_fwd_wgmma_kernel at DH 384 or 512 (Tile),
//     each block owning DV output columns (two slices) and summing S over
//     all DH columns as DH / 16 k-steps of one accumulator; dh padded to
//     DH by TMA's zero fill.
//   * f32 past 256 and bf16 past 512: flash_sliced_kernel, a register-
//     tiled CUDA-core design (float4 reads of shared memory) in a block of 256 threads owning 64 query rows and up to 512
//     output columns in two halves of DV = 160..256 (dh split into the
//     fewest such blocks). Q and K are staged kSliceDC columns at a time and
//     the 64 x 64 logits summed chunk by chunk (f32: each chunk read into
//     registers one chunk ahead), once for both halves (2 x 8 a thread);
//     its softmax leaves P and each row's rescale in shared
//     memory, and each half adds P·V for its columns (4 x DV/8 a thread).
//     Shared memory: Qt and Kt chunks [32][68], P [64][68] and V [64][2·DV]
//     in f32, 163 KiB at DV 256 (one block an SM); registers: 4·DV/8 + 16
//     accumulators a thread. Its f32 products stay on CUDA cores: the
//     3xTF32 design of flash_fwd_tf32x3_kernel (which keeps 1e-4) is not
//     carried past dh 256 yet.
//     bf16 past 512 comes here because a wgmma block's Q tile (128 rows)
//     would outgrow shared memory.
// Past 512 columns each block recomputes S for its columns: the products
// are (blocks + 1) / 2 times the least (1x up to dh 512); the wgmma
// kernel's two slices compute S twice (1.5x at dh 512). What bounds both:
// 4·dh operations a kept (query, key) pair, on the tensor cores in bf16 up
// to 512 and on CUDA cores otherwise.

constexpr int kSliceDC = 32;        // Q and K columns staged at once
constexpr int kSlicedThreads = 256;  // two halves of 128, each owning DV output columns

// Shared memory of a sliced block: Qt and Kt chunks [kSliceDC][kStrideQ|K],
// P [kBK][kStrideQ], V [kBK][2·DV] (both halves' columns), and a row's
// rescale factor and sum [kBQ] each.
__host__ __device__ constexpr size_t sliced_smem_bytes(int DV) {
  return ((size_t)kSliceDC * kStrideQ + (size_t)kSliceDC * kStrideK + (size_t)kBK * kStrideQ +
          (size_t)kBK * 2 * DV + 2 * kBQ) * sizeof(float);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows r0 .. r0 + kBQ - 1 (those below `limit`), columns d0 .. d0 + kSliceDC
// - 1 (those below dh) of x (rows `row` elements apart), times `mul`, into
// dst [kSliceDC][stride] transposed; zeros elsewhere.
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, int stride, const T* x, size_t row, int r0, int limit,
                                            int d0, int dh, float mul) {
  for (int e = threadIdx.x; e < kBQ * kSliceDC; e += kSlicedThreads) {
    const int r = e / kSliceDC, d = e % kSliceDC, c = d0 + d;
    dst[d * stride + r] = (r0 + r < limit && c < dh) ? load_f32(x + (size_t)(r0 + r) * row + c) * mul : 0.f;
  }
}

// f32 rows on a 16-byte grid: a chunk goes through registers, kVecPer
// 16-byte words a thread (word e = threadIdx.x + i·kSlicedThreads: row
// e / 8, columns d0 + 4·(e % 8) ..), fetched one chunk ahead of its use.
constexpr int kVecPer = kBQ * kSliceDC / 4 / kSlicedThreads;

__device__ __forceinline__ void fetch_chunk(float4 (&f)[kVecPer], const float* x, size_t row, int r0, int limit,
                                            int d0, int dh) {
#pragma unroll
  for (int i = 0; i < kVecPer; ++i) {
    const int e = threadIdx.x + i * kSlicedThreads, r = e / (kSliceDC / 4), c = d0 + 4 * (e % (kSliceDC / 4));
    f[i] = (r0 + r < limit && c < dh) ? *reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * row + c)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void put_chunk(float* dst, int stride, const float4 (&f)[kVecPer], float mul) {
#pragma unroll
  for (int i = 0; i < kVecPer; ++i) {
    const int e = threadIdx.x + i * kSlicedThreads, r = e / (kSliceDC / 4), d = 4 * (e % (kSliceDC / 4));
    dst[(d + 0) * stride + r] = f[i].x * mul;
    dst[(d + 1) * stride + r] = f[i].y * mul;
    dst[(d + 2) * stride + r] = f[i].z * mul;
    dst[(d + 3) * stride + r] = f[i].w * mul;
  }
}

// flash_sliced_kernel: a block per (64 query rows, head, 2·DV output
// columns), 256 threads. The logits tile (64 x 64) is computed once for
// both halves: thread (sy, sx) of half h holds rows 32h + 2sy, + 1 and keys
// sx·4 + j, 32 + sx·4 + j, summing Q·Kᵀ over dh a kSliceDC chunk at a time;
// its softmax writes P and each row's rescale to shared memory. Then each
// half multiplies P by its DV columns of V: thread (ty, tx) holds rows
// ty·4 + i and columns u·32 + tx·4 + j of the half (pv_tile).
template <typename T, int DV>
__global__ void __launch_bounds__(kSlicedThreads)
    flash_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ o, float* __restrict__ lse, Shape sh, int slices) {
  static_assert(DV % 32 == 0, "DV is a multiple of 32");
  constexpr int kCols = DV / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [kSliceDC][kStrideQ], q * scale
  float* kt = qt + kSliceDC * kStrideQ;            // [kSliceDC][kStrideK]
  float* pt = kt + kSliceDC * kStrideK;            // [kBK][kStrideQ]
  float* vs = pt + kBK * kStrideQ;                 // [kBK][2 * DV]
  float* alpha_s = vs + kBK * 2 * DV;              // [kBQ]
  float* l_s = alpha_s + kBQ;                      // [kBQ]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavy tiles first
  const int h = blockIdx.y / slices, c0 = (blockIdx.y - h * slices) * 2 * DV;
  const int b = blockIdx.z;
  const int hk = h / (sh.Hq / sh.Hkv);
  const int half = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int sy = t >> 3, sx = t & 7;  // logits: rows 32·half + 2·sy + i, keys sx·4 + j and 32 + sx·4 + j
  const int ty = t >> 3, tx = t & 7;  // P·V: rows ty·4 + i, columns c0 + DV·half + u·32 + tx·4 + j
  const int dh = sh.dh;
  const size_t q_row = (size_t)sh.Hq * dh, kv_row = (size_t)sh.Hkv * dh;
  const T* qb = q + ((size_t)b * sh.S) * q_row + (size_t)h * dh;
  const T* kb = k + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;
  const T* vb = v + ((size_t)b * sh.T) * kv_row + (size_t)hk * dh;
  const bool vec = dh % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;  // f32 rows on a 16-byte grid

  const int q_last = min(q0 + kBQ, sh.S) - 1;
  const int kv_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int kv_hi = sh.causal ? min(sh.T, q_last + 1) : sh.T;
  const int srow = 32 * half + 2 * sy;  // this thread's first logit row

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  float4 fq[kVecPer], fk[kVecPer];  // the next chunk of Q and K (f32 on a 16-byte grid)
  if constexpr (sizeof(T) == 4) {
    if (vec && kv_lo < kv_hi) {
      fetch_chunk(fq, qb, q_row, q0, sh.S, 0, dh);
      fetch_chunk(fk, kb, kv_row, (kv_lo / kBK) * kBK, sh.T, 0, dh);
    }
  }

  for (int t0 = (kv_lo / kBK) * kBK; t0 < kv_hi; t0 += kBK) {
    float s[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kSliceDC) {
      __syncthreads();  // the previous chunk, and the previous tile's P, V and rescales, are consumed
      if constexpr (sizeof(T) == 4) {
        if (vec) {
          put_chunk(qt, kStrideQ, fq, sh.scale);
          put_chunk(kt, kStrideK, fk, 1.f);
          // the next chunk: this tile's, or the first of the next tile
          const int nd = d0 + kSliceDC < dh ? d0 + kSliceDC : 0, nt = nd ? t0 : t0 + kBK;
          if (nt < kv_hi) {
            fetch_chunk(fq, qb, q_row, q0, sh.S, nd, dh);
            fetch_chunk(fk, kb, kv_row, nt, sh.T, nd, dh);
          }
        }
      }
      if (sizeof(T) != 4 || !vec) {
        stage_chunk<T>(qt, kStrideQ, qb, q_row, q0, sh.S, d0, dh, sh.scale);
        stage_chunk<T>(kt, kStrideK, kb, kv_row, t0, sh.T, d0, dh, 1.f);
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kSliceDC; ++d) {
        const float2 qa = *reinterpret_cast<const float2*>(qt + d * kStrideQ + srow);
        const float4 k0 = *reinterpret_cast<const float4*>(kt + d * kStrideK + sx * 4);
        const float4 k1 = *reinterpret_cast<const float4*>(kt + d * kStrideK + 32 + sx * 4);
        const float qv[2] = {qa.x, qa.y};
        const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
      }
    }

    // Mask and the online-softmax update of this thread's two rows; P and
    // each row's rescale go to shared memory for both halves' P·V.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + srow + i;
      bool keep[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = t0 + (j < 4 ? sx * 4 + j : 32 + sx * 4 + (j - 4));
        bool ok = kpos < sh.T;
        if (sh.causal) ok = ok && kpos <= qpos;
        if (sh.window > 0) ok = ok && kpos > qpos - sh.window;
        keep[j] = ok;
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
        s[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (sx == 0) alpha_s[srow + i] = alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j < 4 ? sx * 4 + j : 32 + sx * 4 + (j - 4);
        pt[col * kStrideQ + srow + i] = s[i][j];
      }
    }
    if constexpr (sizeof(T) == 4) {
      if (vec) {
        for (int e = threadIdx.x; e < kBK * 2 * DV / 4; e += kSlicedThreads) {
          const int j = e / (2 * DV / 4), d = 4 * (e % (2 * DV / 4)), tk = t0 + j;
          float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
          if (tk < sh.T && c0 + d < dh) f = *reinterpret_cast<const float4*>(vb + (size_t)tk * kv_row + c0 + d);
          *reinterpret_cast<float4*>(vs + 4 * e) = f;
        }
      }
    }
    if (sizeof(T) != 4 || !vec) {
      for (int e = threadIdx.x; e < kBK * 2 * DV; e += kSlicedThreads) {
        const int j = e / (2 * DV), d = e % (2 * DV), tk = t0 + j;
        vs[e] = (tk < sh.T && c0 + d < dh) ? load_f32(vb + (size_t)tk * kv_row + c0 + d) : 0.f;
      }
    }
    __syncthreads();  // P, V and the rescales are visible
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    pv_tile<kCols>(acc, pt, vs + half * DV, 2 * DV, ty, tx);
  }

  if (sx == 0) {
    l_s[srow] = l[0];
    l_s[srow + 1] = l[1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (lse != nullptr && c0 == 0 && q0 + srow + i < sh.S)
        lse[((size_t)b * sh.Hq + h) * sh.S + q0 + srow + i] = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
  }
  __syncthreads();
  T* ob = o + ((size_t)b * sh.S) * q_row + (size_t)h * dh + c0 + half * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sh.S) continue;
    const float inv = 1.f / fmaxf(l_s[ty * 4 + i], 1e-30f);
#pragma unroll
    for (int u = 0; u < DV / 32; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = u * 32 + tx * 4 + j;
        if (c0 + half * DV + d < dh) store_out(ob + (size_t)row * q_row + d, acc[i][u * 4 + j] * inv);
      }
  }
}

// Output columns a sliced block's half owns: dh in the fewest blocks of at
// most 512 columns, each split in two halves rounded up to a multiple of 32
// (160, 192, 224 or 256 past dh 256).
__host__ inline int sliced_cols(int dh) {
  const int n = (dh + 511) / 512;
  return ((dh + 2 * n - 1) / (2 * n) + 31) / 32 * 32;
}

// The bf16 wgmma kernel's padded width up to 512, else 0 (the sliced kernel).
__host__ inline int wide_wgmma_width(int dh, int bf16) {
  return !bf16 || dh > 512 ? 0 : (dh <= 384 ? 384 : 512);
}

template <typename T, int DV>
cudaError_t launch_sliced(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
                          cudaStream_t stream) {
  const size_t smem = sliced_smem_bytes(DV);
  cudaError_t err = hqi::prepare(flash_sliced_kernel<T, DV>, smem);
  if (err != cudaSuccess) return err;
  const int slices = (sh.dh + 2 * DV - 1) / (2 * DV);
  const dim3 grid((sh.S + kBQ - 1) / kBQ, sh.Hq * slices, sh.B);
  flash_sliced_kernel<T, DV><<<grid, kSlicedThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      lse, sh, slices);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sliced_dh(const void* q, const void* k, const void* v, void* o, float* lse, const Shape& sh,
                             cudaStream_t stream) {
  switch (sliced_cols(sh.dh)) {
    case 160:
      return launch_sliced<T, 160>(q, k, v, o, lse, sh, stream);
    case 192:
      return launch_sliced<T, 192>(q, k, v, o, lse, sh, stream);
    case 224:
      return launch_sliced<T, 224>(q, k, v, o, lse, sh, stream);
    default:
      return launch_sliced<T, 256>(q, k, v, o, lse, sh, stream);
  }
}
}  // namespace

extern "C" {

// lse: f32 [B, Hq, S] written when not null (training), else nothing.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                           int T, int Hq, int Hkv, int dh, int causal, int window, float scale,
                           int bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || dh < 1 || dh > 256 ||
      Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, Hq, Hkv, dh, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err = bf16 ? launch_bf16_dh(q, k, v, o, l, sh, st) : launch_tf32x3_dh(q, k, v, o, l, sh, st);
  return (int)err;
}

// flash_attention_wide's launch for these operands (kernels/flash_attention.py::
// wide_launch_shape): grid x, y, z, threads, dynamic shared bytes, keys a K/V
// tile and output columns a block. bf16 up to dh 512: flash_fwd_wgmma_kernel
// at DH 384 or 512 (dh a multiple of 8); otherwise flash_sliced_kernel.
int flash_attention_wide_shape(int B, int S, int Hq, int dh, int bf16, int* out) {
  if (B < 1 || S < 1 || Hq < 1 || dh < 1) return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, 1, Hq, 1, dh, 0, 0, 1.f};
  const int width = wide_wgmma_width(dh, bf16);
  if (width) {
    const int DV = width == 384 ? Tile<384>::DV : Tile<512>::DV;
    const long long blocks = wgmma_blocks(sh, (dh + DV - 1) / DV);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    out[0] = (int)blocks;
    out[1] = out[2] = 1;
    out[3] = kWgThreads;
    out[4] = (int)(width == 384 ? Smem<384>::bytes : Smem<512>::bytes);
    out[5] = width == 384 ? Tile<384>::BN : Tile<512>::BN;
    out[6] = DV;
    return 0;
  }
  const int DV = sliced_cols(dh);
  out[0] = (S + kBQ - 1) / kBQ;
  out[1] = Hq * ((dh + 2 * DV - 1) / (2 * DV));
  out[2] = B;
  out[3] = kSlicedThreads;
  out[4] = (int)sliced_smem_bytes(DV);
  out[5] = kBK;
  out[6] = DV;
  return 0;
}

// The same contract past dh 256 (the wrapper takes it there): O in column
// slices of at most 256, the logits summed over dh in slices (see the head
// of this section).
int flash_attention_wide_launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                                int T, int Hq, int Hkv, int dh, int causal, int window, float scale,
                                int bf16, void* stream) {
  int shape[7];
  if (T < 1 || Hkv < 1 || Hq % Hkv != 0 || B > 65535 || flash_attention_wide_shape(B, S, Hq, dh, bf16, shape) != 0 ||
      shape[1] > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, Hq, Hkv, dh, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (wide_wgmma_width(dh, bf16)) {
    case 384:
      err = dh % 8 ? cudaErrorInvalidValue : launch_bf16<384>(q, k, v, o, l, sh, st);
      break;
    case 512:
      err = dh % 8 ? cudaErrorInvalidValue : launch_bf16<512>(q, k, v, o, l, sh, st);
      break;
    default:
      err = bf16 ? launch_sliced_dh<__nv_bfloat16>(q, k, v, o, l, sh, st)
                 : launch_sliced_dh<float>(q, k, v, o, l, sh, st);
  }
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(flash_attention_error_string)
