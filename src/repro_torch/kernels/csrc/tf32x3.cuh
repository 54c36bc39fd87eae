// 3xTF32 products on the tensor cores for Hopper (sm_90a): f32 operands split
// into TF32 halves, three mma.sync.m16n8k8 products a k8 step, f32 sums.
// Shared by the f32 attention kernels of flash_attention.cu
// (flash_fwd_tf32x3_kernel) and flash_attention_bwd.cu (bwd_dq_tf32x3_kernel,
// bwd_dkdv_tf32x3_kernel); the design notes are in the backward's 3xTF32
// section.
//
// One TF32 pass keeps 11 bits (~2^-11 a product), short of f32's 1e-4
// agreement; each f32 operand x becomes hi = tf32(x) and lo = x - hi, and a
// k8 step is lo·hi + hi·lo + hi·hi (lo·lo, ~2^-22 of a product, dropped).
//
// Fragments (m16n8k8, TF32; g = lane / 4, t = lane % 4): A holds rows g,
// g + 8 at k-columns t, t + 4; B k-rows t, t + 4 at column g; the m16n8
// accumulator rows g, g + 8 at columns 2t, 2t + 1. S-type products
// (s_products) contract over the staged tiles' columns. Accumulating
// products (acc_product) contract over the rows of a tile in the permuted
// order k' = t -> 2t, t + 4 -> 2t + 1 inside each 8-block, so an S
// accumulator is an A fragment as it stands and B reads rows 2t, 2t + 1 and
// two n8 blocks' columns as one 8-byte load. Staged tiles are row-major with
// rows DH + 4 floats apart (DH a multiple of 32): the S-type reads (row g,
// column t: bank 4g + t) and the permuted 8-byte reads (rows 2t, columns
// 2g: banks 8t + 2g, a half-warp at a time) are both free of bank conflicts.
//
// Sums over a long band: mma.sync's accumulator does not round to nearest,
// so a sum chained through hundreds of k8 steps drifts with its length.
// acc_product sums a tile's steps from zero and adds the result to the
// running sum by f32 arithmetic.

#pragma once

#include <stdint.h>

#include "sm90.cuh"

namespace tf32x3 {

constexpr int kTfThreads = 256;  // 8 warps a block, 4 row groups of 2
constexpr int kTfKeySplit = 2;   // the two warps of a row group split each key tile (dQ, forward)

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// rounding written on the bits (half of the dropped 13 bits' weight added to
// the magnitude, then the 13 bits cleared; a carry reaches the exponent, inf
// stays inf), for finite x and ±inf. A NaN's bits may carry into the sign
// or lose its mantissa (0x7fffffff, the GPU's canonical NaN, gives -0), so
// a split keeps NaN in lo: x - hi is the canonical NaN whatever hi is, and
// the tensor core reads its top 19 bits as a TF32 NaN. On the H100 this
// pair of integer operations for hi, with lo left to the tensor core's
// truncation, was faster than cvt.rna.tf32.f32 (which ptxas expands with
// NaN tests) and than the bit rounding with a NaN select (PERF.md §6).
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// acc_product's default: a tile's products added to the running sum.
struct AddF32 {
  __device__ __forceinline__ float operator()(int, int, float acc, float d) const { return acc + d; }
};

// An A fragment (four values) or a B fragment (two) split into TF32 hi and
// lo (see tf32_rna: a NaN operand makes each of its products NaN).
struct TfA {
  uint32_t hi[4], lo[4];
};
struct TfB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ TfA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  TfA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_rna(a[i]);
    f.lo[i] = __float_as_uint(a[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

__device__ __forceinline__ TfB split_b(float b0, float b1) {
  TfB f;
  f.hi[0] = tf32_rna(b0), f.hi[1] = tf32_rna(b1);
  f.lo[0] = __float_as_uint(b0 - __uint_as_float(f.hi[0])), f.lo[1] = __float_as_uint(b1 - __uint_as_float(f.hi[1]));
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A·B over one k8 step in three TF32 products: the small terms
// (lo·hi, hi·lo) first, then hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const TfA& a, const TfB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc[p][m][j] += A_p[16·MT][DH] · B_p[8·NB][DH]ᵀ for NP products at once
// (S and dP). a[p] points at element (g, t) of the warp's first row of a
// [.][LD] tile (m16 tile m 16·m rows below), b[p] at element (g, t) of the
// first row of the n8 blocks. Each B fragment is split once for the MT
// tiles.
template <int DH, int MT, int NB, int NP>
__device__ __forceinline__ void s_products(float (&acc)[NP][MT][NB][4], const float* const (&a)[NP],
                                           const float* const (&b)[NP]) {
  constexpr int LD = DH + 4;
#pragma unroll 2
  for (int kk = 0; kk < DH / 8; ++kk) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      TfA fa[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* ap = a[p] + 16 * m * LD + 8 * kk;
        fa[m] = split_a(ap[0], ap[8 * LD], ap[4], ap[8 * LD + 4]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* bp = b[p] + j * 8 * LD + 8 * kk;
        const TfB fb = split_b(bp[0], bp[4]);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(acc[p][m][j], fa[m], fb);
      }
    }
  }
}

// acc[m] += W[m] · B over the 8·KS rows of b: W[m] [16][8·KS] is KS n8
// accumulator blocks of an S-type product (rows g, g + 8; columns 2t,
// 2t + 1), taken as A fragments in the permuted order (k' t -> 2t,
// t + 4 -> 2t + 1); b points at the tile's first row of those 8·KS,
// row-major [.][DH + 4]. acc blocks 2p and 2p + 1 hold columns 16p + 2n and
// 16p + 2n + 1 for n8 column n, so a thread's row holds columns 16p + 4t ..
// 16p + 4t + 3. Each B fragment is split once for the MT tiles. A tile's
// products for each column pair go to a zeroed fragment (3·KS products)
// that is added to acc by f32 adds (see "Sums over a long band" at the
// top of this file): acc = add(m, e, acc, d), a plain f32 add unless the caller
// rescales acc in the same step (the forward's fmaf(acc, alpha, d)).
template <int DH, int MT, int KS, typename Add = AddF32>
__device__ __forceinline__ void acc_product(float (&acc)[MT][DH / 8][4], const float (&w)[MT][KS][4], const float* b,
                                            int g, int t, Add add = Add()) {
  constexpr int LD = DH + 4;
  TfA fa[MT][KS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int s = 0; s < KS; ++s) fa[m][s] = split_a(w[m][s][0], w[m][s][2], w[m][s][1], w[m][s][3]);
  const float* r0 = b + 2 * t * LD + 2 * g;
#pragma unroll
  for (int p = 0; p < DH / 16; ++p) {
    float d[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[m][0][e] = d[m][1][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float2 x = *reinterpret_cast<const float2*>(r0 + 8 * s * LD + 16 * p);
      const float2 y = *reinterpret_cast<const float2*>(r0 + (8 * s + 1) * LD + 16 * p);
      const TfB b0 = split_b(x.x, y.x), b1 = split_b(x.y, y.y);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma3(d[m][0], fa[m][s], b0);
        mma3(d[m][1], fa[m][s], b1);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[m][2 * p][e] = add(m, e, acc[m][2 * p][e], d[m][0][e]);
        acc[m][2 * p + 1][e] = add(m, e, acc[m][2 * p + 1][e], d[m][1][e]);
      }
  }
}

// Row g + 8i of an accumulator in the layout above, as float4s at columns
// 16p + 4t, scaled; columns past dh (a multiple of 8) are not written.
template <int DH>
__device__ __forceinline__ void store_rows(float* row_ptr, const float (&acc)[DH / 8][4], int i, int t, int dh,
                                           float scale) {
#pragma unroll
  for (int p = 0; p < DH / 16; ++p) {
    const int c = 16 * p + 4 * t;
    if (c < dh)
      *reinterpret_cast<float4*>(row_ptr + c) =
          make_float4(acc[2 * p][2 * i] * scale, acc[2 * p + 1][2 * i] * scale, acc[2 * p][2 * i + 1] * scale,
                      acc[2 * p + 1][2 * i + 1] * scale);
  }
}

// Rows [r0, r0 + rows) x DH columns of src (row stride ld floats) into dst
// [rows][DH + 4] by 16-byte cp.async; zeros past row_end or dh.
template <int DH>
__device__ __forceinline__ void stage_tf(float* dst, const float* src, size_t ld, int r0, int rows, int row_end,
                                         int dh) {
  constexpr int U = DH / 4;
  for (int e = threadIdx.x; e < rows * U; e += kTfThreads) {
    const int r = e / U, col = 4 * (e % U);
    const int row = r0 + r;
    const bool ok = row < row_end && col < dh;
    sm90::cp_async16_zfill(dst + r * (DH + 4) + col, ok ? src + (size_t)row * ld + col : src, ok);
  }
}

}  // namespace tf32x3
