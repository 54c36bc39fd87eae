// Fused masked similarity + top-k over a batch of work units, for Hopper
// (sm_90a). Two grids over the same per-block scan:
//
//   fused_knn_launch               — query-stationary: one block per (unit,
//                                    query chunk) sweeps all of the unit's rows.
//   fused_knn_db_stationary_launch — split-V: blocks (unit, query chunk, row
//                                    chunk) each score one chunk of rows, write
//                                    a partial top-k to scratch, and a second
//                                    kernel merges the partials per query.
//
// Replaces (TPU, Pallas): src/repro/kernels/fused_knn.py — fused_knn
// (_fused_knn_kernel + _merge_topk) and fused_knn_db_stationary
// (_fused_knn_db_stationary_kernel), vmapped over the W work units of a
// shape bucket by repro/kernels/ops.py.
//
// Semantics (those of repro.kernels.ref.masked_topk_ref, per unit):
//   score = q·v (ip) or (2·q·v − ‖q‖²) − ‖v‖² (l2), in fp32 on CUDA cores
//   (bf16 inputs widen to fp32 when staged); rows with valid == 0 are never
//   candidates; ranks follow the total order (score desc, row index asc), so
//   the result does not depend on which thread saw which row, and ties go to
//   the smallest index as with lax.top_k. A slot no valid row fills is
//   (NEG_INF, -1); an index is -1 wherever its score is <= NEG_INF / 2.
//   Indices are local to the unit's TV rows.
//
// What bounds it on the H100: the function's least cost is the bytes of the
// valid rows and the real queries at engine shapes (TQ = 64, D = 64, TV
// 32..4096, about a third of the rows valid, units padded with empty query
// slots) and fp32 operations on dense tiles (2·D per real query and valid
// row). This kernel stages every row of a unit whatever its mask, so it
// moves more bytes than that. The TPU kernel spends its time in the K-pass
// selection over every [TQ, K+TV] tile; here the per-candidate top-k costs
// one compare against the K-th entry of a sorted register list, with an
// O(K) insertion only when the candidate enters it, so selection is cheap,
// and what should bound this version is the dot products read from shared
// memory: two 4-byte shared loads per FMA (the query element and the row
// element) — an estimate from the instruction mix, not a profiler reading.
// chip_smoke.py reports each kernel's time over its bound
// (``ms_over_bound``); PERF.md keeps the readings.
//
// What the design does about it: selection is kept off the critical path
// (threshold test first, sorted insertion rare once the list has filled);
// queries and a tile of rows are staged in shared memory with an odd row
// stride (conflict-free column reads; a warp reads one row by broadcast);
// each query is served by several row lanes whose lists are merged in
// shared memory at the end; the split-V grid spreads long units across many
// blocks so small W still fills 132 SMs. Holding each query in registers and
// scoring several rows per pass, or tensor-core 3xTF32 scoring, is the next
// step and later work.
//
// The register top-K list, the partial merge and the error-string entry
// are shared with pq_scan.cu through topk.cuh. Plain C interface for
// ctypes: pointers and the stream are void*, each entry returns
// cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using hqi::TopK;
using hqi::prepare;
using hqi::write_final;

constexpr int kThreads = 256;   // threads per scan block
constexpr int kTileRows = 64;   // rows of V staged in shared memory per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct ScanShape {
  int TQ, TV, D, k, l2;
  int qb;          // queries per block (power of two, <= 64)
  int chunk_rows;  // rows per block along TV
};

__host__ __device__ inline int row_stride(int D) { return D | 1; }  // odd stride

__host__ inline size_t scan_smem_bytes(const ScanShape& sh, int K) {
  const size_t stride = row_stride(sh.D);
  const size_t tile = (sh.qb + kTileRows) * stride * sizeof(float)  // queries + rows
                      + kTileRows * sizeof(float)                   // row norms
                      + kTileRows;                                  // valid bytes
  const size_t lists = (size_t)kThreads * K * (sizeof(float) + sizeof(int));
  return tile > lists ? tile : lists;
}

// One block: queries [q0, q0 + qb) of unit w against rows [row0, row1).
// Thread t serves query t % qb on row lane t / qb; on return, threads of row
// lane 0 hold their query's top-K over the whole row range.
template <typename T, int K>
__device__ __forceinline__ void scan_block(const T* __restrict__ q, const T* __restrict__ v,
                                           const uint8_t* __restrict__ valid, const ScanShape& sh,
                                           int w, int q0, int row0, int row1, TopK<K>& top) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int D = sh.D;
  const int stride = row_stride(D);
  const int qb = sh.qb;
  const int lanes = kThreads / qb;
  const int tq = threadIdx.x % qb;
  const int lane = threadIdx.x / qb;
  const bool live = q0 + tq < sh.TQ;

  float* qs = smem;                                   // [qb][stride]
  float* vs = qs + qb * stride;                       // [kTileRows][stride]
  float* vn = vs + kTileRows * stride;                // [kTileRows]
  uint8_t* ok = reinterpret_cast<uint8_t*>(vn + kTileRows);  // [kTileRows]

  const T* qw = q + (size_t)w * sh.TQ * D;
  const T* vw = v + (size_t)w * sh.TV * D;
  const uint8_t* okw = valid + (size_t)w * sh.TV;

  for (int e = threadIdx.x; e < qb * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    qs[r * stride + c] = (q0 + r < sh.TQ) ? to_f32(qw[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  __syncthreads();
  const float* qr = qs + tq * stride;
  float qn = 0.f;
  if (sh.l2) {
    for (int c = 0; c < D; ++c) qn = fmaf(qr[c], qr[c], qn);
  }

  top.init();
  for (int t0 = row0; t0 < row1; t0 += kTileRows) {
    const int nrows = min(kTileRows, row1 - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nrows * D; e += kThreads) {
      const int r = e / D, c = e - (e / D) * D;
      vs[r * stride + c] = to_f32(vw[(size_t)(t0 + r) * D + c]);
    }
    for (int r = threadIdx.x; r < nrows; r += kThreads) ok[r] = okw[t0 + r];
    __syncthreads();
    if (sh.l2) {
      for (int r = threadIdx.x; r < nrows; r += kThreads) {
        const float* vr = vs + r * stride;
        float n2 = 0.f;
        for (int c = 0; c < D; ++c) n2 = fmaf(vr[c], vr[c], n2);
        vn[r] = n2;
      }
      __syncthreads();
    }
    if (live) {
      for (int r = lane; r < nrows; r += lanes) {
        if (!ok[r]) continue;
        const float* vr = vs + r * stride;
        float ip = 0.f;
        for (int c = 0; c < D; ++c) ip = fmaf(qr[c], vr[c], ip);
        const float sc = sh.l2 ? (2.f * ip - qn) - vn[r] : ip;
        top.push(sc, t0 + r);
      }
    }
  }

  if (lanes == 1) return;
  // Fold the row lanes' lists into lane 0's (the tile area is reused).
  __syncthreads();
  float* ls = smem;                                           // [kThreads][K]
  int* li = reinterpret_cast<int*>(ls + (size_t)kThreads * K);  // [kThreads][K]
  top.store(ls + threadIdx.x * K, li + threadIdx.x * K, K);
  __syncthreads();
  if (lane == 0 && live) {
    for (int l = 1; l < lanes; ++l) {
      const int src = (l * qb + tq) * K;
      top.push_sorted(ls + src, li + src, K);
    }
  }
}

// Kernel 1 (query-stationary): grid (W, query chunks).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    fused_knn_kernel(const T* __restrict__ q, const T* __restrict__ v,
                     const uint8_t* __restrict__ valid, float* __restrict__ out_s,
                     int* __restrict__ out_i, ScanShape sh) {
  const int w = blockIdx.x;
  const int q0 = blockIdx.y * sh.qb;
  TopK<K> top;
  scan_block<T, K>(q, v, valid, sh, w, q0, 0, sh.TV, top);
  const int qi = q0 + threadIdx.x % sh.qb;
  if (threadIdx.x / sh.qb == 0 && qi < sh.TQ) {
    const size_t base = ((size_t)w * sh.TQ + qi) * sh.k;
    write_final<K>(top, sh.k, out_s + base, out_i + base);
  }
}

// Kernel 2a (split-V): grid (W, query chunks, S row chunks); raw partial
// lists to scratch [W, S, TQ, k].
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    split_scan_kernel(const T* __restrict__ q, const T* __restrict__ v,
                      const uint8_t* __restrict__ valid, float* __restrict__ part_s,
                      int* __restrict__ part_i, ScanShape sh) {
  const int w = blockIdx.x;
  const int q0 = blockIdx.y * sh.qb;
  const int split = blockIdx.z;
  const int row0 = split * sh.chunk_rows;
  const int row1 = min(sh.TV, row0 + sh.chunk_rows);
  TopK<K> top;
  scan_block<T, K>(q, v, valid, sh, w, q0, row0, row1, top);
  const int qi = q0 + threadIdx.x % sh.qb;
  if (threadIdx.x / sh.qb == 0 && qi < sh.TQ) {
    const size_t base = (((size_t)w * gridDim.z + split) * sh.TQ + qi) * sh.k;
    top.store(part_s + base, part_i + base, sh.k);
  }
}

int pick_qb(int TQ) {
  int qb = 1;
  while (qb < TQ && qb < 64) qb <<= 1;
  return qb;
}

template <typename T, int K>
cudaError_t launch_knn(const void* q, const void* v, const void* valid, void* out_s, void* out_i,
                       const ScanShape& sh, int W, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(sh, K);
  cudaError_t err = prepare(fused_knn_kernel<T, K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W, (sh.TQ + sh.qb - 1) / sh.qb, 1);
  fused_knn_kernel<T, K><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out_s), static_cast<int*>(out_i), sh);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_split(const void* q, const void* v, const void* valid, void* part_s,
                         void* part_i, void* out_s, void* out_i, const ScanShape& sh, int W,
                         int S, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(sh, K);
  cudaError_t err = prepare(split_scan_kernel<T, K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W, (sh.TQ + sh.qb - 1) / sh.qb, S);
  split_scan_kernel<T, K><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(part_s), static_cast<int*>(part_i), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return hqi::launch_merge_partials<K>(part_s, part_i, out_s, out_i, W, S, sh.TQ, sh.k, stream);
}

}  // namespace

extern "C" {

int fused_knn_launch(const void* q, const void* v, const void* valid, void* out_s, void* out_i,
                     int W, int TQ, int TV, int D, int k, int l2, int bf16, void* stream) {
  if (k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const ScanShape sh{TQ, TV, D, k, l2, pick_qb(TQ), TV};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    HQI_DISPATCH_K(k, err = (launch_knn<__nv_bfloat16, KB>(q, v, valid, out_s, out_i, sh, W, st)))
  } else {
    HQI_DISPATCH_K(k, err = (launch_knn<float, KB>(q, v, valid, out_s, out_i, sh, W, st)))
  }
  return (int)err;
}

int fused_knn_db_stationary_launch(const void* q, const void* v, const void* valid, void* part_s,
                                   void* part_i, void* out_s, void* out_i, int W, int TQ, int TV,
                                   int D, int k, int l2, int bf16, int chunk_rows, void* stream) {
  if (k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || D < 1 || chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int S = (TV + chunk_rows - 1) / chunk_rows;
  const ScanShape sh{TQ, TV, D, k, l2, pick_qb(TQ), chunk_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    HQI_DISPATCH_K(k, err = (launch_split<__nv_bfloat16, KB>(q, v, valid, part_s, part_i, out_s, out_i,
                                                         sh, W, S, st)))
  } else {
    HQI_DISPATCH_K(k, err = (launch_split<float, KB>(q, v, valid, part_s, part_i, out_s, out_i, sh, W,
                                                 S, st)))
  }
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(fused_knn_error_string)
