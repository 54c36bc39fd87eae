// ADC (asymmetric distance computation) scan + top-k over uint8 PQ codes,
// for Hopper (sm_90a). One device body serves three wrappers
// (kernels/pq_scan.py), which differ only in where a query's LUT row lives:
//
//   workunit_pq_scan_streamed — row lut_idx[w, t] of the resident table
//                               [U, M, 256]; the table is never expanded.
//   workunit_pq_scan          — row (w, t) of expanded LUTs [W, TQ, M, 256].
//   pq_scan                   — one query's LUT [M, 256] (W = TQ = 1), its
//                               NV code rows split over many blocks.
//
// Replaces (TPU, Pallas): src/repro/kernels/pq_scan.py —
// workunit_pq_scan_streamed (_workunit_pq_streamed_kernel, scalar prefetch +
// per-row DMA of the LUT rows), workunit_pq_scan (_workunit_pq_kernel) and
// pq_scan (_pq_scan_kernel).
//
// Semantics (those of repro.kernels.ref.adc_topk_ref, per unit):
//   score[q, v] = Σ_m lut[q, m, code[v, m]], summed in fp32 in the order
//   m = 0 … M-1 (as repro_torch.kernels.ref.adc_scores_ref, so the two agree
//   bit for bit); rows with valid == 0 are never candidates; ranks follow
//   (score desc, row index asc); a slot no valid row fills is (NEG_INF, -1).
//   Row indices are local to the unit (to the code array for pq_scan).
//   Padding query slots (lut_idx pointing at row 0) are scored like real
//   ones, as on the TPU; the engine drops them.
//
// What bounds it on the H100: per (real query, valid row) the function does
// M lookups and M fp32 adds, and must read the valid rows' codes (M bytes
// each) and each distinct LUT row once (M KiB at 8-bit codes). At engine
// shapes (TQ = 64, M = 8, lists of 32–4096 rows) that is bytes-bound, and
// the bytes that dominate are LUT rows, not codes: every (unit, query slot)
// needs its query's 8 KiB row, and the resident table (up to 80 MiB at
// 10,000 queries) does not fit the 50 MB L2, so the rows are re-read from
// HBM once per unit that scans them. That re-read, not the codes, is what
// this version pays for (chip_smoke.py reports both counts).
//
// The TPU kernels contract one-hot [TV, M·256] tiles with the LUT block on
// the MXU; here the ADC is a gather. A block takes a chunk of qb queries of
// one unit (qb·M·1 KiB of LUT in shared memory: qb = 64 / M, so 64 KiB),
// stages the chunk's LUT rows with 16-byte loads, eight in flight a thread
// (a row stride of M·256 + 4 floats spreads queries over banks), streams
// the unit's code rows through a 256-row shared tile with 16-byte loads, and
// each thread keeps a sorted top-K list in registers for its (query, row
// lane); lanes fold by a tree of list merges in shared memory, each as long
// as the lists are full. Long units split their rows over blocks (grid z)
// whose partial lists topk.cuh's merge_partials_kernel merges.
//
// Plain C interface for ctypes: pointers and the stream are void*, the entry
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using hqi::TopK;
using hqi::prepare;
using hqi::write_final;

constexpr int kThreads = 256;  // threads per scan block
constexpr int kCodeRows = 256;  // code rows staged in shared memory per step
constexpr int kLutPad = 4;      // floats between two queries' LUT rows (bank spread)
constexpr int kStageBatch = 8;  // LUT loads a thread keeps in flight while staging

struct AdcShape {
  int TQ, TV, M, U, k;
  int qb;          // queries per block (power of two, <= kThreads)
  int chunk_rows;  // rows per block along TV
};

__host__ __device__ inline int lut_stride(int M) { return M * 256 + kLutPad; }

// Mirrored by kernels/pq_scan.py::adc_smem_bytes.
__host__ inline size_t adc_smem_bytes(int M, int qb, int K) {
  const size_t tile = (size_t)qb * lut_stride(M) * sizeof(float)  // the chunk's LUT rows
                      + (size_t)kCodeRows * M + kCodeRows;        // code + valid tile
  const size_t fold = (size_t)kThreads * (K * (sizeof(float) + sizeof(int)) + sizeof(int));
  return tile > fold ? tile : fold;
}

// One block: queries [q0, q0 + qb) of unit w against rows [row0, row1).
// Thread t serves query t % qb on row lane t / qb; on return, threads of row
// lane 0 hold their query's top-K over the whole row range. lut_idx == null
// reads the expanded layout (row w·TQ + t of lut).
template <int K>
__device__ __forceinline__ void adc_block(const float* __restrict__ lut,
                                          const int* __restrict__ lut_idx,
                                          const uint8_t* __restrict__ codes,
                                          const uint8_t* __restrict__ valid, const AdcShape& sh,
                                          int w, int q0, int row0, int row1, TopK<K>& top) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = sh.M;
  const int qb = sh.qb;
  const int stride = lut_stride(M);
  const int lanes = kThreads / qb;
  const int tq = threadIdx.x % qb;
  const int lane = threadIdx.x / qb;
  const bool live = q0 + tq < sh.TQ;

  float* luts = reinterpret_cast<float*>(smem_raw);                       // [qb][stride]
  uint8_t* ctile = smem_raw + (size_t)qb * stride * sizeof(float);        // [kCodeRows][M]
  uint8_t* vtile = ctile + kCodeRows * M;                                 // [kCodeRows]

  // the chunk's LUT rows, 16 bytes a thread, kStageBatch loads in flight
  // before their stores (one block per SM holds too few warps to hide the
  // latency of one load at a time); a row is M·256 floats
  const int n4 = M * 64;
  const int total = qb * n4;
  for (int e0 = 0; e0 < total; e0 += kThreads * kStageBatch) {
    float4 val[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int e = e0 + b * kThreads + threadIdx.x;
      const int r = e / n4, c = e - r * n4;
      val[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < total && q0 + r < sh.TQ) {
        const size_t slot = (size_t)w * sh.TQ + q0 + r;
        // an index outside the table is clamped to it: never a read past it
        const size_t row = lut_idx ? (size_t)min(max(lut_idx[slot], 0), sh.U - 1) : slot;
        val[b] = reinterpret_cast<const float4*>(lut + row * (size_t)M * 256)[c];
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int e = e0 + b * kThreads + threadIdx.x;
      const int r = e / n4, c = e - r * n4;
      if (e < total) reinterpret_cast<float4*>(luts + (size_t)r * stride)[c] = val[b];
    }
  }

  const uint8_t* cw = codes + (size_t)w * sh.TV * M;
  const uint8_t* okw = valid + (size_t)w * sh.TV;
  const float* ql = luts + (size_t)tq * stride;
  top.init();
  for (int t0 = row0; t0 < row1; t0 += kCodeRows) {
    const int nrows = min(kCodeRows, row1 - t0);
    __syncthreads();  // the previous tile is consumed (first pass: the LUT rows are staged)
    const uint8_t* src = cw + (size_t)t0 * M;
    const int nbytes = nrows * M;
    int e0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n16 = nbytes >> 4;
      for (int e = threadIdx.x; e < n16; e += kThreads)
        reinterpret_cast<uint4*>(ctile)[e] = reinterpret_cast<const uint4*>(src)[e];
      e0 = n16 << 4;
    }
    for (int e = e0 + threadIdx.x; e < nbytes; e += kThreads) ctile[e] = src[e];
    for (int r = threadIdx.x; r < nrows; r += kThreads) vtile[r] = okw[t0 + r];
    __syncthreads();
    if (live) {
      for (int r = lane; r < nrows; r += lanes) {
        if (!vtile[r]) continue;
        const uint8_t* cr = ctile + r * M;
        float acc = 0.f;
        for (int j = 0; j < M; ++j) acc += ql[j * 256 + cr[j]];  // m = 0 … M-1, in order
        top.push(acc, t0 + r);
      }
    }
  }

  // Fold the row lanes' lists into lane 0's by a tree: each round every
  // remaining lane stores the filled part of its list and the lower half
  // merges in the upper half's (one step per entry taken; pushing entry by
  // entry would cost K steps each on the few lanes still working).
  float* ls = reinterpret_cast<float*>(smem_raw);                 // [kThreads][K]
  int* li = reinterpret_cast<int*>(ls + (size_t)kThreads * K);    // [kThreads][K]
  int* cnt = li + (size_t)kThreads * K;                            // [kThreads]
  for (int half = lanes / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (lane < 2 * half) {
      const int slot = lane * qb + tq;
      top.store_filled(ls + (size_t)slot * K, li + (size_t)slot * K);
      cnt[slot] = top.n;
    }
    __syncthreads();
    if (lane < half && live) {
      const int mine = lane * qb + tq, other = (lane + half) * qb + tq;
      top.merge_from(ls + (size_t)mine * K, li + (size_t)mine * K, cnt[mine],
                     ls + (size_t)other * K, li + (size_t)other * K, cnt[other]);
    }
  }
}

// Grid (W, query chunks, S row chunks). With S == 1 each block writes its
// final lists to dst [W, TQ, k]; otherwise raw partial lists to dst
// [W, S, TQ, k] for merge_partials_kernel.
template <int K>
__global__ void __launch_bounds__(kThreads)
    adc_scan_kernel(const float* __restrict__ lut, const int* __restrict__ lut_idx,
                    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ valid,
                    float* __restrict__ dst_s, int* __restrict__ dst_i, AdcShape sh) {
  const int w = blockIdx.x;
  const int q0 = blockIdx.y * sh.qb;
  const int split = blockIdx.z;
  const int row0 = split * sh.chunk_rows;
  const int row1 = min(sh.TV, row0 + sh.chunk_rows);
  TopK<K> top;
  adc_block<K>(lut, lut_idx, codes, valid, sh, w, q0, row0, row1, top);
  const int qi = q0 + threadIdx.x % sh.qb;
  if (threadIdx.x / sh.qb == 0 && qi < sh.TQ) {
    if (gridDim.z == 1) {
      const size_t base = ((size_t)w * sh.TQ + qi) * sh.k;
      write_final<K>(top, sh.k, dst_s + base, dst_i + base);
    } else {
      const size_t base = (((size_t)w * gridDim.z + split) * sh.TQ + qi) * sh.k;
      top.store(dst_s + base, dst_i + base, sh.k);
    }
  }
}

template <int K>
cudaError_t launch_adc(const void* lut, const void* lut_idx, const void* codes, const void* valid,
                       void* part_s, void* part_i, void* out_s, void* out_i, const AdcShape& sh,
                       int W, int S, cudaStream_t stream) {
  const size_t smem = adc_smem_bytes(sh.M, sh.qb, K);
  cudaError_t err = prepare(adc_scan_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W, (sh.TQ + sh.qb - 1) / sh.qb, S);
  adc_scan_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const int*>(lut_idx),
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(valid),
      static_cast<float*>(S == 1 ? out_s : part_s), static_cast<int*>(S == 1 ? out_i : part_i), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return hqi::launch_merge_partials<K>(part_s, part_i, out_s, out_i, W, S, sh.TQ, sh.k, stream);
}

}  // namespace

extern "C" {

// lut: table [U, M, 256] with lut_idx [W, TQ] (int32), or expanded LUTs
// [W, TQ, M, 256] with lut_idx == null. codes uint8 [W, TV, M], valid
// uint8 [W, TV]; out [W, TQ, k]; part [W, S, TQ, k] scratch when
// S = ceil(TV / chunk_rows) > 1. qb: queries per block, a power of two.
int adc_scan_launch(const void* lut, const void* lut_idx, const void* codes, const void* valid,
                    void* part_s, void* part_i, void* out_s, void* out_i, int W, int TQ, int TV,
                    int M, int U, int k, int qb, int chunk_rows, void* stream) {
  if (k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || M < 1 || U < 1 || chunk_rows < 1 ||
      qb < 1 || qb > kThreads || (qb & (qb - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int S = (TV + chunk_rows - 1) / chunk_rows;
  const AdcShape sh{TQ, TV, M, U, k, qb, chunk_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  HQI_DISPATCH_K(k, err = (launch_adc<KB>(lut, lut_idx, codes, valid, part_s, part_i, out_s,
                                          out_i, sh, W, S, st)))
  return (int)err;
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(pq_scan_error_string)
