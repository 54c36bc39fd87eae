// ADC (asymmetric distance computation) scan + top-k over uint8 PQ codes,
// for Hopper (sm_90a). Two designs serve the three wrappers
// (kernels/pq_scan.py):
//
//   workunit_pq_scan_streamed — LUT-stationary: lut_stationary_units_kernel
//                               over slots grouped by their row of the
//                               resident table [U, M, 256].
//   pq_scan                   — LUT-stationary: lut_stationary_rows_kernel,
//                               one query's LUT [M, 256] against NV rows in
//                               one launch.
//   workunit_pq_scan          — adc_scan_kernel over expanded LUTs
//                               [W, TQ, M, 256] (qb query slots a block).
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
//   Row indices are local to the unit (to the code array for pq_scan). A
//   resident slot whose row index is -1 holds no query: it is written
//   (NEG_INF, -1) and never scored; any other index outside the table is
//   clamped into it.
//
// What bounds it on the H100: per (real query, valid row) the function does
// M lookups and M fp32 adds, and must read the valid rows' codes (M bytes
// each), each distinct LUT row once (M KiB at 8-bit codes) and write every
// slot's top-k. At engine shapes (TQ = 64, M = 8, lists of 32–4096 rows)
// that is bytes-bound: the output of the padded bucket and the LUT rows.
//
// The LUT-stationary design. The TPU kernels contract one-hot [TV, M·256]
// tiles with the LUT block on the MXU; here the ADC is a gather from one
// query's LUT row staged in shared memory. A block stages a row once and
// streams code rows past it:
//   * units: the wrapper sorts the W·TQ slots by table row (stable); a block
//     takes P consecutive slots of that order, stages the LUT row of each
//     run of equal rows once (cp.async, all threads) and its warps take the
//     run's slots in turn, a warp a slot; a long unit's chunks are split
//     over all eight warps instead, whose lists then fold into one (else a
//     run of one slot would leave seven warps waiting at the next row).
//     LUT traffic is one row per (block, run), not one per slot; a hot row
//     spreads over many blocks. Slots of row -1 (padding) are written
//     (NEG_INF, -1) without being scored.
//   * rows: about one block per SM stages the query's row; each warp takes a
//     contiguous range of 32-row chunks; the block's lists fold into one,
//     and the last block to finish (a counter the wrapper zeroes) merges
//     every block's list in the same launch.
// Each warp streams its items (a unit's 32-row chunk: M·32 code bytes and
// 32 mask bytes) through a ring of kStages shared-memory stages, kStages - 1
// items ahead, by cp.async 16-byte copies (bytes off the 16-byte grid by
// plain loads; 1-D TMA bulk copies on mbarriers measured no faster). Each
// lane scores one row of a chunk against the staged LUT, and the warp keeps
// the slot's top-k in topk.cuh's WarpSelect: candidates filtered against
// the k-th entry, buffered, and merged 32 at a time by bitonic networks of
// shuffles; a piece of at most 64 rows is sorted at once instead. A unit of
// any length is one launch: its chunks loop inside a warp, or eight.
//
// adc_scan_kernel (expanded LUTs): a block takes qb queries of one unit
// (qb·M·1 KiB of LUT in shared memory: qb = 64 / M, so 64 KiB), stages
// their LUT rows with 16-byte loads, eight in flight a thread, streams the
// unit's code rows through a 256-row shared tile, and each thread keeps a
// sorted top-K list in registers for its (query, row lane); lanes fold by a
// tree of list merges in shared memory. Long units split their rows over
// blocks (grid z) whose partial lists topk.cuh's merge_partials_kernel
// merges.
//
// Plain C interface for ctypes: pointers and the stream are void*, each entry
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace {

using hqi::TopK;
using hqi::WarpSelect;
using hqi::kFullMask;
using hqi::kNegInf;
using hqi::kNoIdx;
using hqi::kSelectBuf;
using hqi::prepare;
using hqi::write_final;

// ============================================================ adc_scan_kernel

constexpr int kThreads = 256;  // threads per scan block
constexpr int kCodeRows = 256;  // code rows staged in shared memory per step
constexpr int kLutPad = 4;      // floats between two queries' LUT rows (bank spread)
constexpr int kStageBatch = 8;  // LUT loads a thread keeps in flight while staging

struct AdcShape {
  int TQ, TV, M, k;
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
// lane 0 hold their query's top-K over the whole row range. The LUT of
// slot (w, t) is row w·TQ + t of lut.
template <int K>
__device__ __forceinline__ void adc_block(const float* __restrict__ lut,
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
        const size_t row = (size_t)w * sh.TQ + q0 + r;
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
    adc_scan_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                    const uint8_t* __restrict__ valid, float* __restrict__ dst_s,
                    int* __restrict__ dst_i, AdcShape sh) {
  const int w = blockIdx.x;
  const int q0 = blockIdx.y * sh.qb;
  const int split = blockIdx.z;
  const int row0 = split * sh.chunk_rows;
  const int row1 = min(sh.TV, row0 + sh.chunk_rows);
  TopK<K> top;
  adc_block<K>(lut, codes, valid, sh, w, q0, row0, row1, top);
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
cudaError_t launch_adc(const void* lut, const void* codes, const void* valid, void* part_s,
                       void* part_i, void* out_s, void* out_i, const AdcShape& sh, int W, int S,
                       cudaStream_t stream) {
  const size_t smem = adc_smem_bytes(sh.M, sh.qb, K);
  cudaError_t err = prepare(adc_scan_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W, (sh.TQ + sh.qb - 1) / sh.qb, S);
  adc_scan_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(valid),
      static_cast<float*>(S == 1 ? out_s : part_s), static_cast<int*>(S == 1 ? out_i : part_i), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return hqi::launch_merge_partials<K>(part_s, part_i, out_s, out_i, W, S, sh.TQ, sh.k, stream);
}


// ====================================================== LUT-stationary scan

namespace lutst {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;       // ring stages a warp: kStages - 1 items in flight
constexpr int kChunk = 32;       // rows an item holds, one a lane
constexpr int kMaxRange = 128;   // slots a block of the units kernel takes, most

__host__ __device__ inline int stage_code_bytes(int M) { return (kChunk * M + 15) & ~15; }
__host__ __device__ inline int stage_bytes(int M) { return stage_code_bytes(M) + kChunk; }

// Mirrored by kernels/pq_scan.py::lut_stationary_smem_bytes.
__host__ inline size_t smem_bytes(int M) {
  return (size_t)M * 256 * sizeof(float)                      // one query's LUT row
         + (size_t)kWarps * kStages * stage_bytes(M)           // the warps' rings
         + (size_t)kWarps * kSelectBuf * 8                     // the warps' candidate buffers
         + (size_t)kMaxRange * 3 * sizeof(int)                 // the range's rows, slots, units
         + (size_t)(kMaxRange + 1) * sizeof(int)               // its runs' bounds
         + 16;                                                 // run count, last-block flag
}

struct Smem {
  float* lut;
  uint8_t* ring;
  float* bs;
  int* bi;
  int* rows;
  int* slots;
  int* units;
  int* bounds;
  int* misc;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int M) {
  Smem m;
  size_t off = (size_t)M * 256 * sizeof(float);
  m.lut = reinterpret_cast<float*>(raw);
  m.ring = raw + off;
  off += (size_t)kWarps * kStages * stage_bytes(M);
  m.bs = reinterpret_cast<float*>(raw + off);
  off += (size_t)kWarps * kSelectBuf * sizeof(float);
  m.bi = reinterpret_cast<int*>(raw + off);
  off += (size_t)kWarps * kSelectBuf * sizeof(int);
  m.rows = reinterpret_cast<int*>(raw + off);
  off += (size_t)kMaxRange * sizeof(int);
  m.slots = reinterpret_cast<int*>(raw + off);
  off += (size_t)kMaxRange * sizeof(int);
  m.units = reinterpret_cast<int*>(raw + off);
  off += (size_t)kMaxRange * sizeof(int);
  m.bounds = reinterpret_cast<int*>(raw + off);
  off += (size_t)(kMaxRange + 1) * sizeof(int);
  m.misc = reinterpret_cast<int*>(raw + off);
  return m;
}

// One warp's ring of kStages item buffers (an item's codes, then its mask).
// Item t lives in stage t % kStages. Every member is warp-collective.
struct Ring {
  uint8_t* base;
  int sbytes, cbytes, M;

  __device__ __forceinline__ uint8_t* codes(int t) const { return base + (size_t)(t % kStages) * sbytes; }
  __device__ __forceinline__ const uint8_t* valid(int t) const { return codes(t) + cbytes; }

  // Start item t: n rows (n·M code bytes at csrc, n mask bytes at vsrc).
  // Whole 16-byte blocks of an aligned source go by cp.async, the rest by
  // plain loads; each item is one cp.async group.
  __device__ __forceinline__ void issue(int t, const uint8_t* csrc, const uint8_t* vsrc, int n,
                                        int lane) const {
    uint8_t* cd = codes(t);
    uint8_t* vd = cd + cbytes;
    const int nc = n * M;
    const int bc = (reinterpret_cast<uintptr_t>(csrc) & 15) ? 0 : (nc & ~15);
    const int bv = (reinterpret_cast<uintptr_t>(vsrc) & 15) ? 0 : (n & ~15);
    for (int b = bc + lane; b < nc; b += 32) cd[b] = csrc[b];
    for (int b = bv + lane; b < n; b += 32) vd[b] = vsrc[b];
    for (int g = lane; g < (bc >> 4); g += 32) sm90::cp_async16(cd + 16 * g, csrc + 16 * g);
    for (int g = lane; g < (bv >> 4); g += 32) sm90::cp_async16(vd + 16 * g, vsrc + 16 * g);
    sm90::cp_async_commit();
  }

  // No item to start: an empty group keeps the count in step.
  __device__ __forceinline__ void skip() const { sm90::cp_async_commit(); }

  // Item t has landed and the whole warp sees it.
  __device__ __forceinline__ void wait() const {
    sm90::cp_async_wait<kStages - 1>();
    __syncwarp();
  }
};

// Σ_m lut[m][code[m]] for one staged code row, in the order m = 0 … M-1.
__device__ __forceinline__ float adc_row(const float* __restrict__ lut, const uint8_t* cr, int M) {
  float acc = 0.f;
  if ((M & 7) == 0) {
    for (int j = 0; j < M; j += 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(cr + j);
#pragma unroll
      for (int b = 0; b < 4; ++b) acc += lut[(j + b) * 256 + ((w.x >> (8 * b)) & 255u)];
#pragma unroll
      for (int b = 0; b < 4; ++b) acc += lut[(j + 4 + b) * 256 + ((w.y >> (8 * b)) & 255u)];
    }
  } else {
    for (int j = 0; j < M; ++j) acc += lut[j * 256 + cr[j]];
  }
  return acc;
}

// Lane l's row of item t (ok: it exists, l < n, and is valid) scored
// against the staged LUT; -inf where not ok.
__device__ __forceinline__ float score_row(const Ring& ring, int t, const float* lut, int n, int lane,
                                           bool& ok) {
  ok = lane < n && ring.valid(t)[lane] != 0;
  return ok ? adc_row(lut, ring.codes(t) + lane * ring.M, ring.M) : -INFINITY;
}

template <int KL>
__device__ __forceinline__ WarpSelect<KL> make_select(const Smem& sm, int warp, int k) {
  WarpSelect<KL> sel;
  sel.bs = sm.bs + warp * kSelectBuf;
  sel.bi = sm.bi + warp * kSelectBuf;
  sel.k = k;
  sel.reset();
  return sel;
}

// Fold the block's warp lists into warp 0's: the other warps store theirs in
// their buffers and warp 0 offers them.
template <int KL>
__device__ __forceinline__ void fold_block(WarpSelect<KL>& sel, const Smem& sm, int warp, int lane) {
  if (warp != 0) sel.top.store(sel.bs, sel.bi, sel.k, lane);
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w)
      sel.offer_list(sm.bs + w * kSelectBuf, sm.bi + w * kSelectBuf, sel.k, false, lane);
    sel.flush(lane);
  }
  __syncthreads();  // the buffers are free again
}

// One query's LUT row (M·256 floats, 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage_lut(float* dst, const float* src, int M) {
  for (int g = threadIdx.x; g < M * 64; g += kThreads) sm90::cp_async16(dst + 4 * g, src + 4 * g);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
}

// workunit_pq_scan_streamed. keys/order: the W·TQ slots sorted by table row
// (stable); block b takes positions [b·P, b·P + P). With g = 1 the warps
// take a run's slots in turn, a warp a slot; with g = 8 the block takes
// them one at a time, each warp scanning its piece of the slot's row chunks
// (a contiguous eighth) and the pieces' lists folding into warp 0's. The
// slot's first warp writes out [W, TQ, k].
template <int KL>
__global__ void __launch_bounds__(kThreads, 4)
    lut_stationary_units_kernel(const float* __restrict__ table, const int* __restrict__ keys,
                                const int64_t* __restrict__ order, const uint8_t* __restrict__ codes,
                                const uint8_t* __restrict__ valid, float* __restrict__ out_s,
                                int* __restrict__ out_i, int N, int TQ, int TV, int M, int U, int k,
                                int P, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, M);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * P;
  const int n = min(P, N - p0);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int key = keys[p0 + p];
    const int slot = (int)order[p0 + p];
    sm.rows[p] = key == -1 ? -1 : min(max(key, 0), U - 1);  // other indices are clamped into the table
    sm.slots[p] = slot;
    sm.units[p] = slot / TQ;
  }
  __syncthreads();
  if (warp == 0) {  // runs of one row: positions [bounds[j], bounds[j + 1])
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const int p = base + lane;
      const bool first = p < n && (p == 0 || sm.rows[p] != sm.rows[p - 1]);
      const unsigned mask = __ballot_sync(kFullMask, first);
      if (first) sm.bounds[cnt + __popc(mask & ((1u << lane) - 1u))] = p;
      cnt += __popc(mask);
    }
    if (lane == 0) {
      sm.bounds[cnt] = n;
      sm.misc[0] = cnt;
    }
  }
  __syncthreads();
  const int nruns = sm.misc[0];
  const int nch = (TV + kChunk - 1) / kChunk;
  const int groups = kWarps / g, grp = warp / g, mem = warp - grp * g;
  const int c0 = nch * mem / g, c1 = nch * (mem + 1) / g;  // this warp's piece of a slot
  const bool direct = c1 - c0 <= 2;  // a piece of <= 64 rows is sorted at once, not buffered
  const Ring ring{sm.ring + (size_t)warp * kStages * stage_bytes(M), stage_bytes(M),
                  stage_code_bytes(M), M};

  // The producer's cursor over this warp's items, kStages - 1 ahead of the
  // consumer: for each run of a real row, the run's slots grp, grp + groups,
  // …, each over the chunks of this warp's piece; it runs on across runs.
  int prun = 0, ppos = nruns > 0 ? sm.bounds[0] + grp : 0, pch = c0, issued = 0;
  auto settle = [&]() {
    while (prun < nruns && (sm.rows[sm.bounds[prun]] < 0 || ppos >= sm.bounds[prun + 1])) {
      ++prun;
      if (prun < nruns) ppos = sm.bounds[prun] + grp;
    }
  };
  auto issue_next = [&]() {
    if (prun >= nruns) {
      ring.skip();
      return;
    }
    const size_t row = (size_t)sm.units[ppos] * TV + (size_t)pch * kChunk;
    ring.issue(issued++, codes + row * M, valid + row, min(kChunk, TV - pch * kChunk), lane);
    if (++pch == c1) {
      pch = c0;
      ppos += groups;
      settle();
    }
  };
  if (c0 == c1) prun = nruns;  // an empty piece (nch < g): no items
  settle();
  for (int j = 0; j < kStages - 1; ++j) issue_next();

  WarpSelect<KL> sel = make_select<KL>(sm, warp, k);
  int t = 0;  // items consumed
  for (int run = 0; run < nruns; ++run) {
    const int a = sm.bounds[run], b = sm.bounds[run + 1], row = sm.rows[a];
    if (row < 0) {  // slots that hold no query: written, never scored
      for (int pos = a + warp; pos < b; pos += kWarps) {
        const size_t o = (size_t)sm.slots[pos] * k;
        for (int e = lane; e < k; e += 32) {
          out_s[o + e] = kNegInf;
          out_i[o + e] = -1;
        }
      }
      continue;
    }
    __syncthreads();  // every warp is done with the previous row
    stage_lut(sm.lut, table + (size_t)row * M * 256, M);
    __syncthreads();
    for (int pos = a + grp; pos < b; pos += groups) {
      sel.reset();
      float d0 = -INFINITY, d1 = -INFINITY;  // a direct piece's candidates, two a lane
      int i0 = kNoIdx, i1 = kNoIdx;
      for (int ch = c0; ch < c1; ++ch, ++t) {
        issue_next();
        ring.wait();
        const int r0 = ch * kChunk;
        bool ok;
        const float acc = score_row(ring, t, sm.lut, min(kChunk, TV - r0), lane, ok);
        if (direct) {
          if (ok && ch == c0) {
            d0 = acc;
            i0 = r0 + lane;
          } else if (ok) {
            d1 = acc;
            i1 = r0 + lane;
          }
        } else {
          sel.offer(acc, r0 + lane, ok, lane);
        }
        __syncwarp();  // the stage is read before the ring refills it
      }
      if (direct)
        sel.top.sort_from(d0, i0, d1, i1, c1 - c0 == 2, k, lane);
      else
        sel.flush(lane);
      if (g > 1) fold_block<KL>(sel, sm, warp, lane);  // the pieces fold into warp 0's list
      if (mem == 0) {
        const size_t o = (size_t)sm.slots[pos] * k;
        sel.top.write_final(k, out_s + o, out_i + o, lane);
      }
    }
  }
}

// pq_scan. Each warp scans a contiguous range of 32-row chunks; the block's
// lists fold into one raw partial list part[blockIdx.x]; the last block to
// count itself in `counter` (zeroed by the wrapper) merges all gridDim.x of
// them into out [k].
template <int KL>
__global__ void __launch_bounds__(kThreads)
    lut_stationary_rows_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                               const uint8_t* __restrict__ valid, float* __restrict__ part_s,
                               int* __restrict__ part_i, unsigned* __restrict__ counter,
                               float* __restrict__ out_s, int* __restrict__ out_i, int NV, int M,
                               int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, M);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_lut(sm.lut, lut, M);
  __syncthreads();

  const long nch = (NV + kChunk - 1) / kChunk;
  const long nw = (long)gridDim.x * kWarps, gw = (long)blockIdx.x * kWarps + warp;
  const int c0 = (int)(nch * gw / nw), c1 = (int)(nch * (gw + 1) / nw);
  const Ring ring{sm.ring + (size_t)warp * kStages * stage_bytes(M), stage_bytes(M),
                  stage_code_bytes(M), M};
  int next = c0, issued = 0;
  auto issue_next = [&]() {
    if (next >= c1) {
      ring.skip();
      return;
    }
    const size_t r0 = (size_t)next * kChunk;
    ring.issue(issued++, codes + r0 * M, valid + r0, min(kChunk, NV - (int)r0), lane);
    ++next;
  };
  for (int j = 0; j < kStages - 1; ++j) issue_next();
  WarpSelect<KL> sel = make_select<KL>(sm, warp, k);
  for (int c = c0, t = 0; c < c1; ++c, ++t) {
    issue_next();
    ring.wait();
    bool ok;
    const float acc = score_row(ring, t, sm.lut, min(kChunk, NV - c * kChunk), lane, ok);
    sel.offer(acc, c * kChunk + lane, ok, lane);
    __syncwarp();
  }
  sel.flush(lane);
  fold_block<KL>(sel, sm, warp, lane);
  if (warp == 0) {
    sel.top.store(part_s + (size_t)blockIdx.x * k, part_i + (size_t)blockIdx.x * k, k, lane);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) sm.misc[1] = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sm.misc[1]) return;
  __threadfence();  // every block's list is visible to the last one
  sel.reset();
  for (int b = warp; b < (int)gridDim.x; b += kWarps)
    sel.offer_list(part_s + (size_t)b * k, part_i + (size_t)b * k, k, true, lane);
  sel.flush(lane);
  fold_block<KL>(sel, sm, warp, lane);
  if (warp == 0) sel.top.write_final(k, out_s, out_i, lane);
}

template <int KL>
cudaError_t launch_units(const void* table, const void* keys, const void* order, const void* codes,
                         const void* valid, void* out_s, void* out_i, int N, int TQ, int TV, int M,
                         int U, int k, int P, int g, cudaStream_t stream) {
  const size_t smem = smem_bytes(M);
  cudaError_t err = prepare(lut_stationary_units_kernel<KL>, smem);
  if (err != cudaSuccess) return err;
  lut_stationary_units_kernel<KL><<<(N + P - 1) / P, kThreads, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(keys),
      static_cast<const int64_t*>(order), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out_s), static_cast<int*>(out_i), N,
      TQ, TV, M, U, k, P, g);
  return cudaGetLastError();
}

template <int KL>
cudaError_t launch_rows(const void* lut, const void* codes, const void* valid, void* part_s,
                        void* part_i, void* counter, void* out_s, void* out_i, int NV, int M, int k,
                        int G, cudaStream_t stream) {
  const size_t smem = smem_bytes(M);
  cudaError_t err = prepare(lut_stationary_rows_kernel<KL>, smem);
  if (err != cudaSuccess) return err;
  lut_stationary_rows_kernel<KL><<<G, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(valid), static_cast<float*>(part_s), static_cast<int*>(part_i),
      static_cast<unsigned*>(counter), static_cast<float*>(out_s), static_cast<int*>(out_i), NV, M,
      k);
  return cudaGetLastError();
}

}  // namespace lutst

}  // namespace

extern "C" {

// Expanded LUTs [W, TQ, M, 256]; codes uint8 [W, TV, M], valid uint8
// [W, TV]; out [W, TQ, k]; part [W, S, TQ, k] scratch when
// S = ceil(TV / chunk_rows) > 1. qb: queries per block, a power of two.
int adc_scan_launch(const void* lut, const void* codes, const void* valid, void* part_s,
                    void* part_i, void* out_s, void* out_i, int W, int TQ, int TV, int M, int k,
                    int qb, int chunk_rows, void* stream) {
  if (k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || M < 1 || chunk_rows < 1 || qb < 1 ||
      qb > kThreads || (qb & (qb - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int S = (TV + chunk_rows - 1) / chunk_rows;
  const AdcShape sh{TQ, TV, M, k, qb, chunk_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  HQI_DISPATCH_K(k, err = (launch_adc<KB>(lut, codes, valid, part_s, part_i, out_s, out_i, sh, W,
                                          S, st)))
  return (int)err;
}

// Resident table [U, M, 256]; keys int32 [W·TQ] (the slots' table rows,
// sorted, stable) with order int64 [W·TQ] (their slot indices w·TQ + t);
// codes uint8 [W, TV, M], valid uint8 [W, TV]; out [W, TQ, k]. P slots a
// block (<= 128), g warps a slot (1 or 8).
int lut_stationary_units_launch(const void* table, const void* keys, const void* order,
                                const void* codes, const void* valid, void* out_s, void* out_i,
                                int W, int TQ, int TV, int M, int U, int k, int P, int g,
                                void* stream) {
  if (k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || M < 1 || U < 1 || P < 1 ||
      P > lutst::kMaxRange || (g != 1 && g != lutst::kWarps) ||
      (long)W * TQ > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = W * TQ;
  if (k <= 32)
    return (int)lutst::launch_units<32>(table, keys, order, codes, valid, out_s, out_i, N, TQ, TV,
                                        M, U, k, P, g, st);
  return (int)lutst::launch_units<64>(table, keys, order, codes, valid, out_s, out_i, N, TQ, TV, M,
                                      U, k, P, g, st);
}

// One query's LUT [M, 256] against codes uint8 [NV, M], valid uint8 [NV];
// out [k]. G blocks; part [G, k] scratch; counter: one uint32, zeroed here
// on the stream before the kernel.
int lut_stationary_rows_launch(const void* lut, const void* codes, const void* valid, void* part_s,
                               void* part_i, void* counter, void* out_s, void* out_i, int NV, int M,
                               int k, int G, void* stream) {
  if (k < 1 || k > 64 || k > NV || M < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  if (k <= 32)
    return (int)lutst::launch_rows<32>(lut, codes, valid, part_s, part_i, counter, out_s, out_i, NV,
                                       M, k, G, st);
  return (int)lutst::launch_rows<64>(lut, codes, valid, part_s, part_i, counter, out_s, out_i, NV, M,
                                     k, G, st);
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(pq_scan_error_string)
