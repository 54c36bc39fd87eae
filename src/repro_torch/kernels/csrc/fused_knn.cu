// Fused masked similarity + top-k over a batch of work units, for Hopper
// (sm_90a). One scan kernel, two entry points:
//
//   fused_knn_launch               — query-stationary: one block per (unit,
//                                    chunk of 64 query slots) scans all of
//                                    the unit's rows (S = 1).
//   fused_knn_db_stationary_launch — split rows: S blocks per (unit, query
//                                    chunk), S chosen at launch so the grid
//                                    fills the card, each scanning a range
//                                    of rows; the last block of each (unit,
//                                    chunk) to finish merges the S partial
//                                    lists in the same launch.
//
// Units of one query slot (TQ = 1, the PQ path's exact re-rank) take a warp
// each, four units a block, through both entries.
//
// Replaces (TPU, Pallas): src/repro/kernels/fused_knn.py — fused_knn
// (_fused_knn_kernel + _merge_topk) and fused_knn_db_stationary
// (_fused_knn_db_stationary_kernel), vmapped over the W work units of a
// shape bucket by repro/kernels/ops.py.
//
// Semantics (those of repro.kernels.ref.masked_topk_ref, per unit):
//   score = q·v (ip) or (2·q·v − ‖q‖²) − ‖v‖² (l2), in fp32 on CUDA cores,
//   one fmaf chain per (query, row) over c = 0 … D-1 in order (bf16 inputs
//   widen to fp32 as they are read); rows with valid == 0 are never
//   candidates; ranks follow the total order (score desc, row index asc),
//   so the result does not depend on which thread or block saw which row,
//   and ties go to the smallest index as with lax.top_k. A slot no valid row
//   fills is (NEG_INF, -1); an index is -1 wherever its score is
//   <= NEG_INF / 2. Indices are local to the unit's TV rows. Optional
//   n_live [W]: slot s of unit w holds a query iff s < n_live[w]; the other
//   slots read nothing and are (NEG_INF, -1). Optional floor_s/floor_i
//   [W, TQ] (k' > 64, kernels/fused_knn.py::floor_passes): a later pass of
//   at most 64 entries, admitting only candidates that rank strictly after
//   the slot's floor, the last entry of the pass before; a floor index of
//   -1 (a slot that pass left short) admits nothing.
//
// What bounds it on the H100: at the engine's shapes (TQ = 64, D = 64, TV
// 32..4096) the least cost is the bytes of the real query slots and of the
// valid rows (17-48% of rows valid, about 40% of query slots real); their
// fp32 products fit under that byte time on CUDA cores at every main-path
// bucket, so tensor cores (3xTF32) would not lower the bound, and they would
// change the order of the sums. The units are small (about 25 live slots
// and 25 valid rows at the heaviest bucket), so what the card spends is the
// per-unit chain of dependent steps and the selection, not bytes.
//
// What this design does about it:
//   * only real work is staged: a block stages its live query slots only
//     (real slots are contiguous from slot 0 in every unit); each pass over
//     up to kPass rows compacts the valid rows' indices by warp ballots and
//     __popc prefixes, and only those rows are copied, 16 bytes a thread by
//     cp.async, into a two-stage ring, so tile t+1 lands while tile t is
//     scored; a unit with no live slot or no valid row writes its
//     sentinels without scoring anything;
//   * register-tiled scoring: each thread owns a 4 x 4 block of (live
//     slot, compacted row) pairs, strided so a quarter-warp reads 8
//     consecutive rows (conflict-free at the 16-byte-padded stride) while
//     its query words broadcast; 16-byte shared loads along D give 64 FMAs
//     per 8 loads instead of 2 loads per FMA; only the 4 x 4 blocks that
//     hold live pairs are scheduled;
//   * any width: D is consumed in chunks of kDC elements with the
//     accumulators held in registers across chunks, so shared memory does
//     not grow with D;
//   * selection: each (score, index) becomes one 64-bit key whose unsigned
//     order is the rank order. A tile's keys are tested against their
//     slot's k-th entry as they are written; those that pass are ranked by
//     counting the keys above them among the tile and the slot's list in
//     shared memory, and every key whose count is below k moves to that
//     place. Short tiles (32 rows) keep that count cheap. Sorted lists in
//     registers (a per-thread list folded across lanes, or a warp-wide
//     bitonic list per slot) measured slower on the card at these sizes
//     (PERF.md §6);
//   * one launch: at S > 1 the blocks write their lists as keys, and the
//     last block of a (unit, chunk) — a counter zeroed by cudaMemsetAsync in
//     the entry, a __threadfence, reads through L2 — ranks them into the
//     final list.
//
// Plain C interface for ctypes: pointers and the stream are void*, each
// entry returns cudaGetLastError() (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace {

using hqi::after_floor;
using hqi::better;
using hqi::kFullMask;
using hqi::kNegInf;
using hqi::kNoIdx;
using hqi::prepare;
using hqi::WarpTopK;

constexpr int kThreads = 128;    // threads per scan block
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;          // query slots a block takes (one query chunk)
constexpr int kTR = 32;          // compacted rows a tile
constexpr int kDC = 64;          // elements of D a chunk
constexpr int kPass = 256;       // rows whose indices one compaction pass holds
constexpr int kMinRangeTiles = 8;       // tiles a split range holds at least
constexpr int kSplitTarget = 4 * 132;   // blocks the split grid aims for (132 SMs)
constexpr int kWarpRows = 256;   // rows a warp compacts at once (TQ = 1 units)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Four consecutive elements as fp32 (16-byte aligned for float, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// (score, index) as one 64-bit key whose unsigned order is the rank order
// (score desc, index asc): the score's bits made monotone above, the
// index's complement below. Key 0 ranks below every candidate.
__device__ __forceinline__ unsigned long long key_of(float s, int i) {
  const unsigned b = s == 0.f ? 0u : __float_as_uint(s);  // -0 ties with +0, as the floats do
  const unsigned hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)hi << 32) | (unsigned)~i;
}
__device__ __forceinline__ float score_of(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}
__device__ __forceinline__ int index_of(unsigned long long key) { return ~(int)(unsigned)key; }

// A later pass admits a key iff it ranks strictly after the slot's floor (a
// smaller key); a floor index of -1 admits nothing.
__device__ __forceinline__ bool admits(unsigned long long key, const float* floor_s, const int* floor_i,
                                       size_t slot) {
  if (!floor_s) return true;
  const int fi = floor_i[slot];
  return fi >= 0 && key < key_of(floor_s[slot], fi);
}

struct Shape {
  int W, TQ, TV, D, k, l2;
  int vec;         // 16-byte copies: both bases 16-byte aligned and D·sizeof(T) % 16 == 0
  int S;           // row ranges (blocks) per (unit, query chunk)
  int chunk_rows;  // rows a range holds
  int nch;         // chunks of kDC elements along D
};

// Row ranges per (unit, query chunk) of the split grid; mirrored by
// kernels/fused_knn.py::split_count. Enough ranges that W · chunks · S
// reaches kSplitTarget blocks, each at least kMinRangeTiles whole tiles (so
// the last block's merge of the S lists stays short); 1 for units of one
// query slot (a warp per unit).
__host__ inline void split_of(int W, int TQ, int TV, int* S, int* chunk_rows) {
  *S = 1;
  *chunk_rows = TV;
  if (TQ == 1) return;
  const long base = (long)W * ((TQ + kQB - 1) / kQB);
  const int tiles = (TV + kTR - 1) / kTR;
  long s = (kSplitTarget + base - 1) / base;
  if (s > tiles / kMinRangeTiles) s = tiles / kMinRangeTiles;
  if (s <= 1) return;
  *chunk_rows = (int)((tiles + s - 1) / s) * kTR;
  *S = (TV + *chunk_rows - 1) / *chunk_rows;
}

// Staged row (or query) stride: one chunk plus 16 bytes, so 8 consecutive
// rows start on 8 different 4-bank groups.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return kDC * (int)sizeof(T) + 16;
}

// Dynamic shared memory of a scan block; mirrored by
// kernels/fused_knn.py::scan_smem_bytes.
template <typename T>
__host__ inline size_t scan_smem_bytes(int nch, int k) {
  return (size_t)(nch > 1 ? 2 : 1) * kQB * row_bytes<T>()  // live queries (a copy per stage if D > kDC)
         + (size_t)2 * kTR * row_bytes<T>()                // the row ring
         + (size_t)kQB * (kTR + 1) * 8                     // a tile's candidate keys
         + (size_t)2 * kQB * k * 8                         // the slots' lists, two copies
         + (size_t)kPass * 4                               // a pass's valid row indices
         + (size_t)(kQB + kTR) * 4                         // ‖q‖², ‖v‖²
         + (size_t)(2 * kQB + 16) * 4;                     // list counts, passes; warp counts, flag
}

// Shared memory of a scan block; paired buffers are a base and a stride.
template <typename T>
struct Smem {
  unsigned char* q;         // [1 or 2][kQB][row_bytes]
  unsigned char* v;         // [2][kTR][row_bytes]
  unsigned long long* sc;   // [kQB][kTR + 1] a tile's keys (0: did not pass)
  unsigned long long* ls;   // [2][kQB][k] slot s's list: [s·k, s·k + cnt[s]), best first
  int* ridx;
  float* qn;
  float* vn;
  int* cnt;
  int* npass;  // [kQB] a tile's keys that passed
  int* misc;
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, int nch, int k) {
  Smem<T> m;
  m.q = raw;
  m.v = m.q + (size_t)(nch > 1 ? 2 : 1) * kQB * row_bytes<T>();
  m.sc = reinterpret_cast<unsigned long long*>(m.v + (size_t)2 * kTR * row_bytes<T>());
  m.ls = m.sc + kQB * (kTR + 1);
  m.ridx = reinterpret_cast<int*>(m.ls + 2 * kQB * k);
  m.qn = reinterpret_cast<float*>(m.ridx + kPass);
  m.vn = m.qn + kQB;
  m.cnt = reinterpret_cast<int*>(m.vn + kTR);
  m.npass = m.cnt + kQB;
  m.misc = m.npass + kQB;
  return m;
}

// Block-wide: columns [c0, c0 + cw) of n rows into dst (stride row_bytes).
// Row r is src row rows[r], or row r when rows is null. 16-byte cp.async
// when `vec` (then cw·sizeof(T) is a multiple of 16); otherwise plain
// element copies, zero-padded to a multiple of 4 columns.
template <typename T>
__device__ __forceinline__ void stage(unsigned char* dst, const T* __restrict__ src, const int* rows,
                                      int n, int D, int c0, int cw, bool vec) {
  constexpr int RB = row_bytes<T>();
  if (vec) {
    constexpr int ppr = kDC * (int)sizeof(T) / 16;  // 16-byte pieces a full chunk row
    const int cwp = cw * (int)sizeof(T) / 16;
    for (int e = threadIdx.x; e < n * ppr; e += kThreads) {
      const int r = e / ppr, g = e % ppr;
      if (g < cwp) {
        const int row = rows ? rows[r] : r;
        sm90::cp_async16(dst + r * RB + g * 16,
                         reinterpret_cast<const unsigned char*>(src + (size_t)row * D + c0) + g * 16);
      }
    }
  } else {
    const int cw4 = (cw + 3) & ~3;
    for (int e = threadIdx.x; e < n * kDC; e += kThreads) {
      const int r = e / kDC, c = e % kDC;
      if (c < cw4) {
        const int row = rows ? rows[r] : r;
        const float x = c < cw ? to_f32(src[(size_t)row * D + c0 + c]) : 0.f;
        reinterpret_cast<T*>(dst + r * RB)[c] = from_f32<T>(x);
      }
    }
  }
}

// Block-wide: the indices of the valid rows in [p0, p1) (p1 - p0 <= kPass)
// into ridx, ascending, by warp ballots and a prefix over the warps'
// counts. Returns their count.
__device__ __forceinline__ int compact(const uint8_t* __restrict__ okw, int p0, int p1, int* ridx,
                                       int* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int r0 = p0; r0 < p1; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const bool ok = r < p1 && okw[r] != 0;
    const unsigned m = __ballot_sync(kFullMask, ok);
    if (lane == 0) wcnt[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int c = wcnt[j];
      before += j < warp ? c : 0;
      total += c;
    }
    if (ok) ridx[base + before + __popc(m & ((1u << lane) - 1u))] = r;
    base += total;
    __syncthreads();  // wcnt is rewritten next round; ridx is complete
  }
  return base;
}

// A candidate enters slot q's list iff it ranks above the k-th entry, or
// the list holds fewer than k.
__device__ __forceinline__ unsigned long long passing(unsigned long long key,
                                                      const unsigned long long* ls, const int* cnt,
                                                      int q, int k) {
  return (cnt[q] < k || key > ls[q * k + k - 1]) ? key : 0ull;
}

// Block-wide: each live slot q < n takes the passing keys of its row of `sc`
// (positions [0, nr); 0 where a candidate did not pass) into its list. A
// warp packs each row's passing keys to its front; then every key counts
// the keys that rank above it among them and the slot's list (a strict
// order: distinct indices), which is its new place, and places below k are
// written to the other copy of the lists, which becomes current. The counts
// are read again only after a barrier.
__device__ __forceinline__ void rank_merge(unsigned long long* sc, int n, int nr, int k,
                                           unsigned long long* ls, int* cnt, int* npass, int& cur) {
  static_assert(kTR == 32, "a warp packs a tile's row");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < n; q += kWarps) {
    unsigned long long* row = sc + q * (kTR + 1);
    const unsigned long long key = lane < nr ? row[lane] : 0ull;
    const unsigned m = __ballot_sync(kFullMask, key != 0);
    __syncwarp();
    if (key) row[__popc(m & ((1u << lane) - 1u))] = key;
    if (lane == 0) npass[q] = __popc(m);
  }
  __syncthreads();
  const unsigned long long* cl = ls + cur * kQB * k;
  unsigned long long* nl = ls + (cur ^ 1) * kQB * k;
  for (int e = threadIdx.x; e < n * nr; e += kThreads) {  // the passing keys
    const int q = e / nr, r = e - q * nr;
    const int np = npass[q];
    if (r >= np) continue;
    const unsigned long long* row = sc + q * (kTR + 1);
    const unsigned long long key = row[r];
    int rank = 0;
#pragma unroll 8
    for (int r2 = 0; r2 < np; ++r2) rank += row[r2] > key;
    const unsigned long long* l = cl + q * k;
    for (int p = 0, c = cnt[q]; p < c && rank < k && l[p] > key; ++p) ++rank;
    if (rank < k) nl[q * k + rank] = key;
  }
  for (int e = threadIdx.x; e < n * k; e += kThreads) {  // the list's entries
    const int q = e / k, p = e - q * k;
    if (p >= cnt[q]) continue;
    const unsigned long long key = cl[e];
    const unsigned long long* row = sc + q * (kTR + 1);
    int rank = p;
#pragma unroll 8
    for (int r2 = 0, np = npass[q]; r2 < np; ++r2) rank += row[r2] > key;
    if (rank < k) nl[q * k + rank] = key;
  }
  __syncthreads();
  if (threadIdx.x < n) cnt[threadIdx.x] = min(k, cnt[threadIdx.x] + npass[threadIdx.x]);
  cur ^= 1;
}

// Slot q's list, entries [0, k), to out in the public encoding.
__device__ __forceinline__ void write_lists(const unsigned long long* l, const int* cnt, int n, int k,
                                            float* out_s, int* out_i) {
  for (int e = threadIdx.x; e < n * k; e += kThreads) {
    const int q = e / k, p = e - q * k;
    float s = kNegInf;
    int i = -1;
    if (p < cnt[q]) {
      s = score_of(l[e]);
      i = s <= kNegInf * 0.5f ? -1 : index_of(l[e]);
    }
    out_s[e] = s;
    out_i[e] = i;
  }
}

// Grid (W, query chunks, S). A block scans rows [split·chunk_rows,
// +chunk_rows) of unit w for its live slots; at S = 1 it writes the final
// lists, at S > 1 a raw partial list per live slot (empty entries: key 0),
// and the last block of the (unit, chunk) to finish merges them. Slots past
// n_live are written by range 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
    fused_knn_scan_kernel(const T* __restrict__ q, const T* __restrict__ v,
                          const uint8_t* __restrict__ valid, const int* __restrict__ n_live,
                          const float* __restrict__ floor_s, const int* __restrict__ floor_i,
                          unsigned long long* __restrict__ part, unsigned* __restrict__ counters,
                          float* __restrict__ out_s, int* __restrict__ out_i, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = blockIdx.x, qc = blockIdx.y, split = blockIdx.z;
  const int q0 = qc * kQB;
  const int slots = min(kQB, sh.TQ - q0);
  const int live = n_live ? min(max(n_live[w], 0), sh.TQ) : sh.TQ;
  const int n = min(max(live - q0, 0), slots);
  const int k = sh.k, D = sh.D;
  const size_t out0 = ((size_t)w * sh.TQ + q0) * k;
  if (split == 0) {  // slots holding no query: final at once
    for (int e = n * k + threadIdx.x; e < slots * k; e += kThreads) {
      out_s[out0 + e] = kNegInf;
      out_i[out0 + e] = -1;
    }
  }
  if (n == 0) return;

  const Smem<T> sm = carve<T>(smem_raw, sh.nch, k);
  constexpr int RB = row_bytes<T>();
  const T* qw = q + ((size_t)w * sh.TQ + q0) * D;
  const T* vw = v + (size_t)w * sh.TV * D;
  const uint8_t* okw = valid + (size_t)w * sh.TV;
  const int row0 = split * sh.chunk_rows, row1 = min(sh.TV, row0 + sh.chunk_rows);
  if (threadIdx.x < kQB) sm.cnt[threadIdx.x] = 0;
  int cur = 0;  // which copy of the lists is current

  // scoring: thread (mq, mr) owns slots mq + nmq·i and rows mr + nmr·j
  const int nmq = (n + 3) >> 2;
  float acc[4][4];
  float vn = 0.f, qn = 0.f;
  bool first_tile = true, q_staged = false;

  for (int p0 = row0; p0 < row1; p0 += kPass) {
    const int nv = compact(okw, p0, min(row1, p0 + kPass), sm.ridx, sm.misc);
    if (nv == 0) continue;
    const int items = ((nv + kTR - 1) / kTR) * sh.nch;  // (tile, D chunk), chunk fastest
    auto issue = [&](int it) {
      const int t = it / sh.nch, c0 = (it - t * sh.nch) * kDC;
      const int cw = min(kDC, D - c0);
      stage<T>(sm.v + (it & 1) * kTR * RB, vw, sm.ridx + t * kTR, min(kTR, nv - t * kTR), D, c0, cw,
               sh.vec);
      if (sh.nch > 1) {
        stage<T>(sm.q + (it & 1) * kQB * RB, qw, nullptr, n, D, c0, cw, sh.vec);
      } else if (!q_staged) {
        stage<T>(sm.q, qw, nullptr, n, D, 0, D, sh.vec);
        q_staged = true;
      }
      sm90::cp_async_commit();
    };
    issue(0);
    for (int it = 0; it < items; ++it) {
      sm90::cp_async_wait<0>();
      __syncthreads();  // item it is in place; the stage item it+1 takes is free
      if (it + 1 < items) issue(it + 1);
      const int t = it / sh.nch, c = it - t * sh.nch;
      const int nr = min(kTR, nv - t * kTR);
      const int cw = min(kDC, D - c * kDC);
      const unsigned char* qb = sm.q + (sh.nch > 1 ? (it & 1) * kQB * RB : 0);
      const unsigned char* vb = sm.v + (it & 1) * kTR * RB;
      const int nmr = (nr + 3) >> 2;
      const int mq = threadIdx.x / nmr, mr = threadIdx.x - mq * nmr;
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      if (mq < nmq) {
        const T* qr[4];
        const T* vr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qr[i] = reinterpret_cast<const T*>(qb + (mq + nmq * i) * RB);
#pragma unroll
        for (int j = 0; j < 4; ++j) vr[j] = reinterpret_cast<const T*>(vb + (mr + nmr * j) * RB);
        const int n4 = (cw + 3) >> 2;
#pragma unroll 2
        for (int c4 = 0; c4 < n4; ++c4) {
          float4 a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = load4(qr[i] + 4 * c4);
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = load4(vr[j] + 4 * c4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float x = acc[i][j];
              x = fmaf(a[i].x, b[j].x, x);
              x = fmaf(a[i].y, b[j].y, x);
              x = fmaf(a[i].z, b[j].z, x);
              x = fmaf(a[i].w, b[j].w, x);
              acc[i][j] = x;
            }
        }
      }
      if (sh.l2) {  // the norms' chains, in the same column order
        if (threadIdx.x < nr) {
          const T* row = reinterpret_cast<const T*>(vb + threadIdx.x * RB);
          if (c == 0) vn = 0.f;
          for (int cc = 0; cc < cw; ++cc) {
            const float x = to_f32(row[cc]);
            vn = fmaf(x, x, vn);
          }
        } else if (first_tile && threadIdx.x >= kTR && threadIdx.x - kTR < n) {
          const T* row = reinterpret_cast<const T*>(qb + (threadIdx.x - kTR) * RB);
          for (int cc = 0; cc < cw; ++cc) {
            const float x = to_f32(row[cc]);
            qn = fmaf(x, x, qn);
          }
        }
      }
      if (c != sh.nch - 1) continue;

      // the tile's keys that pass their slot's k-th entry, 0 for the rest
      if (sh.l2) {
        if (threadIdx.x < nr) sm.vn[threadIdx.x] = vn;
        else if (first_tile && threadIdx.x >= kTR && threadIdx.x - kTR < n) sm.qn[threadIdx.x - kTR] = qn;
        __syncthreads();
      }
      if (mq < nmq) {
        const int* rid = sm.ridx + t * kTR;
        const unsigned long long* cl = sm.ls + cur * kQB * k;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qq = mq + nmq * i, rr = mr + nmr * j;
            if (qq < n && rr < nr) {
              float s = acc[i][j];
              if (sh.l2) s = (2.f * s - sm.qn[qq]) - sm.vn[rr];
              const unsigned long long key = key_of(s, rid[rr]);
              sm.sc[qq * (kTR + 1) + rr] =
                  admits(key, floor_s, floor_i, (size_t)w * sh.TQ + q0 + qq) ? passing(key, cl, sm.cnt, qq, k)
                                                                              : 0ull;
            }
          }
      }
      __syncthreads();
      rank_merge(sm.sc, n, nr, k, sm.ls, sm.cnt, sm.npass, cur);
      first_tile = false;
    }
  }

  __syncthreads();  // the last merge's counts
  if (sh.S == 1) {
    write_lists(sm.ls + cur * kQB * k, sm.cnt, n, k, out_s + out0, out_i + out0);
    return;
  }
  // a raw partial list per live slot; empty entries 0
  const size_t po = (((size_t)w * sh.S + split) * sh.TQ + q0) * k;
  const unsigned long long* cl = sm.ls + cur * kQB * k;
  for (int e = threadIdx.x; e < n * k; e += kThreads)
    part[po + e] = e - (e / k) * k < sm.cnt[e / k] ? cl[e] : 0ull;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm.misc[kWarps] = atomicAdd(counters + (size_t)w * gridDim.y + qc, 1u) == (unsigned)(sh.S - 1);
  __syncthreads();
  if (!sm.misc[kWarps]) return;
  __threadfence();  // every range's lists are visible to the last block

  // The last block: the S·k partial keys of each slot, kTR at a time,
  // through the same merge.
  if (threadIdx.x < n) sm.cnt[threadIdx.x] = 0;
  __syncthreads();
  const int total = sh.S * k;
  for (int f0 = 0; f0 < total; f0 += kTR) {
    const int nr = min(kTR, total - f0);
    const unsigned long long* cl2 = sm.ls + cur * kQB * k;
    for (int e = threadIdx.x; e < n * nr; e += kThreads) {
      const int qq = e / nr, f = f0 + e - qq * nr, sp = f / k;
      const unsigned long long key =
          __ldcg(part + (((size_t)w * sh.S + sp) * sh.TQ + q0 + qq) * k + (f - sp * k));
      sm.sc[qq * (kTR + 1) + (f - f0)] = key ? passing(key, cl2, sm.cnt, qq, k) : 0ull;
    }
    __syncthreads();
    rank_merge(sm.sc, n, nr, k, sm.ls, sm.cnt, sm.npass, cur);
    __syncthreads();  // the counts, before the next keys are tested
  }
  write_lists(sm.ls + cur * kQB * k, sm.cnt, n, k, out_s + out0, out_i + out0);
}

// Offer up to 32 candidates (one a lane; ok false: none) to a warp's list:
// those that rank above its k-th entry are merged in (a bitonic sort of the
// 32 and a merge, WarpTopK::merge32); a chunk none passes costs a compare
// and a vote.
template <int KL>
__device__ __forceinline__ void offer32(WarpTopK<KL>& top, float cs, int ci, bool ok, int k,
                                        int lane) {
  const bool pass = ok && better(cs, ci, top.ks, top.ki);
  if (__ballot_sync(kFullMask, pass)) top.merge32(pass ? cs : -INFINITY, pass ? ci : kNoIdx, k, lane);
}

// Units of one query slot: a warp per unit, kWarps units a block. The warp
// compacts up to kWarpRows valid row indices at a time by ballots; lane l
// scores compacted rows l, l + 32, ... reading the row from global memory
// and the query through L1, and each 32 scores are offered to the warp's
// sorted list (offer32), past the unit's floor in a later pass.
template <typename T, int KL>
__global__ void __launch_bounds__(kThreads)
    fused_knn_unit_warps_kernel(const T* __restrict__ q, const T* __restrict__ v,
                                const uint8_t* __restrict__ valid, const int* __restrict__ n_live,
                                const float* __restrict__ floor_s, const int* __restrict__ floor_i,
                                float* __restrict__ out_s, int* __restrict__ out_i, Shape sh) {
  __shared__ int ridx[kWarps][kWarpRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= sh.W) return;
  float* os = out_s + (size_t)w * sh.k;
  int* oi = out_i + (size_t)w * sh.k;
  const bool has_floor = floor_s != nullptr;
  const float fs = has_floor ? floor_s[w] : 0.f;
  const int fi = has_floor ? floor_i[w] : 0;
  if ((n_live && n_live[w] <= 0) || (has_floor && fi < 0)) {
    for (int p = lane; p < sh.k; p += 32) {
      os[p] = kNegInf;
      oi[p] = -1;
    }
    return;
  }
  const int D = sh.D;
  const T* qw = q + (size_t)w * D;
  const T* vw = v + (size_t)w * sh.TV * D;
  const uint8_t* okw = valid + (size_t)w * sh.TV;
  float qn = 0.f;
  if (sh.l2) {
    for (int c = 0; c < D; ++c) {
      const float x = to_f32(qw[c]);
      qn = fmaf(x, x, qn);
    }
  }
  WarpTopK<KL> top;
  top.init();
  int* rl = ridx[warp];
  for (int p0 = 0; p0 < sh.TV; p0 += kWarpRows) {
    const int p1 = min(sh.TV, p0 + kWarpRows);
    int cnt = 0;
    for (int r0 = p0; r0 < p1; r0 += 32) {
      const int r = r0 + lane;
      const bool ok = r < p1 && okw[r] != 0;
      const unsigned m = __ballot_sync(kFullMask, ok);
      if (ok) rl[cnt + __popc(m & ((1u << lane) - 1u))] = r;
      cnt += __popc(m);
    }
    __syncwarp();
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      const int j = j0 + lane;
      float sc = -INFINITY;
      int r = kNoIdx;
      if (j < cnt) {
        r = rl[j];
        const T* vr = vw + (size_t)r * D;
        float ip = 0.f, vn = 0.f;
        if (sh.vec) {
          for (int c = 0; c < D; c += 4) {
            const float4 a = load4(qw + c), b = load4(vr + c);
            ip = fmaf(a.x, b.x, ip);
            ip = fmaf(a.y, b.y, ip);
            ip = fmaf(a.z, b.z, ip);
            ip = fmaf(a.w, b.w, ip);
            vn = fmaf(b.x, b.x, vn);
            vn = fmaf(b.y, b.y, vn);
            vn = fmaf(b.z, b.z, vn);
            vn = fmaf(b.w, b.w, vn);
          }
        } else {
          for (int c = 0; c < D; ++c) {
            const float a = to_f32(qw[c]), b = to_f32(vr[c]);
            ip = fmaf(a, b, ip);
            vn = fmaf(b, b, vn);
          }
        }
        sc = sh.l2 ? (2.f * ip - qn) - vn : ip;
      }
      offer32(top, sc, r, j < cnt && (!has_floor || after_floor(fs, fi, sc, r)), sh.k, lane);
    }
    __syncwarp();  // rl is rewritten by the next pass
  }
  top.write_final(sh.k, os, oi, lane);
}

template <typename T, int KL>
cudaError_t launch(const void* q, const void* v, const void* valid, const void* n_live,
                   const void* floor_s, const void* floor_i, void* part, void* counters, void* out_s,
                   void* out_i, const Shape& sh, cudaStream_t stream) {
  const float* fs = static_cast<const float*>(floor_s);
  const int* fi = static_cast<const int*>(floor_i);
  if (sh.TQ == 1) {
    fused_knn_unit_warps_kernel<T, KL><<<(sh.W + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(n_live), fs, fi, static_cast<float*>(out_s), static_cast<int*>(out_i),
        sh);
    return cudaGetLastError();
  }
  const size_t smem = scan_smem_bytes<T>(sh.nch, sh.k);
  cudaError_t err = prepare(fused_knn_scan_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(sh.W, (sh.TQ + kQB - 1) / kQB, sh.S);
  fused_knn_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(n_live), fs, fi, static_cast<unsigned long long*>(part),
      static_cast<unsigned*>(counters), static_cast<float*>(out_s), static_cast<int*>(out_i), sh);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* v, const void* valid, const void* n_live, const void* floor_s,
             const void* floor_i, void* part, void* counters, void* out_s, void* out_i, int W, int TQ,
             int TV, int D, int k, int l2, int bf16, int S, int chunk_rows, void* stream) {
  const int esz = bf16 ? 2 : 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const Shape sh{W, TQ, TV, D, k, l2, aligned && (D * esz) % 16 == 0, S, chunk_rows,
                 (D + kDC - 1) / kDC};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const auto go = [&](auto kern) {
    return kern(q, v, valid, n_live, floor_s, floor_i, part, counters, out_s, out_i, sh, st);
  };
  if (bf16) {
    err = k <= 32 ? go(launch<__nv_bfloat16, 32>) : go(launch<__nv_bfloat16, 64>);
  } else {
    err = k <= 32 ? go(launch<float, 32>) : go(launch<float, 64>);
  }
  return (int)err;
}

bool bad_shape(int W, int TQ, int TV, int D, int k) {
  return k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || D < 1 || W > 0x7fffffff / kWarps;
}

}  // namespace

extern "C" {

// q, v [W, TQ|TV, D] (f32 or bf16), valid uint8 [W, TV], n_live int32 [W]
// or null (every slot live); floor_s f32 / floor_i int32 [W, TQ] or both
// null (the first pass); out [W, TQ, k], k <= 64.
int fused_knn_launch(const void* q, const void* v, const void* valid, const void* n_live,
                     const void* floor_s, const void* floor_i, void* out_s, void* out_i, int W, int TQ,
                     int TV, int D, int k, int l2, int bf16, void* stream) {
  if (bad_shape(W, TQ, TV, D, k) || (!floor_s) != (!floor_i)) return (int)cudaErrorInvalidValue;
  return dispatch(q, v, valid, n_live, floor_s, floor_i, nullptr, nullptr, out_s, out_i, W, TQ, TV, D,
                  k, l2, bf16, 1, TV, stream);
}

// The split grid's S for a shape (fused_knn_db_stationary_launch takes no
// other): the wrapper sizes its scratch by it.
int fused_knn_split_count(int W, int TQ, int TV) {
  int S, chunk_rows;
  split_of(W, TQ, TV, &S, &chunk_rows);
  return S;
}

// As fused_knn_launch, with rows split over S = fused_knn_split_count(W, TQ,
// TV) blocks per (unit, query chunk); when S > 1, part uint64 [W, S, TQ, k]
// scratch and counters uint32 [W · ceil(TQ / 64)], zeroed here on the stream.
int fused_knn_db_stationary_launch(const void* q, const void* v, const void* valid,
                                   const void* n_live, const void* floor_s, const void* floor_i,
                                   void* part, void* counters, void* out_s, void* out_i, int W, int TQ,
                                   int TV, int D, int k, int l2, int bf16, int S, void* stream) {
  if (bad_shape(W, TQ, TV, D, k) || (!floor_s) != (!floor_i)) return (int)cudaErrorInvalidValue;
  int want, chunk_rows;
  split_of(W, TQ, TV, &want, &chunk_rows);
  if (S != want) return (int)cudaErrorInvalidValue;
  if (S > 1) {
    const size_t bytes = (size_t)W * ((TQ + kQB - 1) / kQB) * sizeof(unsigned);
    const cudaError_t err = cudaMemsetAsync(counters, 0, bytes, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return dispatch(q, v, valid, n_live, floor_s, floor_i, part, counters, out_s, out_i, W, TQ, TV, D, k,
                  l2, bf16, S, chunk_rows, stream);
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(fused_knn_error_string)
