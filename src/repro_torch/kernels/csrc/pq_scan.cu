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
//   workunit_pq_scan          — adc_slot_warps_kernel over expanded LUTs
//                               [W, TQ, M, 256]: a warp per live slot, one
//                               launch.
//   all three past M 190      — adc_wide_m_kernel: a block owns one LUT row
//                               and a tile of code rows; the row passes
//                               through shared memory in slices, each staged
//                               once for the tile (end of file).
//
// Lists of more than 64 (k' > 64) are taken in passes of at most 64, each a
// launch that admits only what ranks after the slot's floor, the last entry
// of the pass before (topk.cuh, WarpSelect::set_floor).
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
//   clamped into it. With n_live [W] (expanded LUTs), slot s of unit w holds
//   a query iff s < n_live[w]: the others are written (NEG_INF, -1) and their
//   LUTs are never read.
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
//   * M past 109: the row does not fit beside the rings, so it passes
//     through shared memory in slices of Ms subspaces (the widest multiple
//     of 8 that fits, lut_slice: 104 at M 110, 88 at 128, 24 at 190), block-
//     wide for every chunk; each lane carries its row's sum in a register
//     from one slice to the next, m = 0 … M-1, so the scores stay those of
//     the whole row. The warps step together (a slot or none a round, the
//     same count of chunk steps) because each slice is a barrier.
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
// adc_slot_warps_kernel (expanded LUTs, the dense layout). Every slot has its
// own LUT row, so nothing is shared between slots but the unit's code rows,
// and the bound is the live slots' LUT rows (M KiB each) and the output.
// The engine's units hold their real query slots first (n_live), about one
// slot in six at the heaviest bucket. A block takes the live slots of one
// unit G at a time (a group), a warp (or g warps, G·g <= 8) a slot:
//   * only live slots are read: each warp stages its slot's LUT row by
//     16-byte cp.async; dead slots are written (NEG_INF, -1) by the unit's
//     first block and a unit with no live slot reads nothing;
//   * the block streams its rows once per group through a ring of kStages
//     tiles (T >= kTileChunks 32-row chunks of codes and their mask),
//     kStages - 1 tiles ahead by cp.async, so later tiles and the LUT rows
//     land while a tile is scored; each lane scores one row of a chunk, a
//     slot's g warps taking every g-th chunk;
//   * each warp keeps its slot's top-k in topk.cuh's WarpSelect (as the
//     LUT-stationary kernels); a warp with at most 64 rows sorts them at
//     once; the g warps of a slot fold their lists into the first's;
//   * G = 64 / M (at most 8, at most TQ): 64 KiB of LUT rows and three
//     blocks an SM at M 8; past M 64 one slot a block, its warps and then
//     its tiles halved until the block fits (M <= 190 at one warp);
//   * parallel and one launch at any length: where the grid of one block a
//     unit would not reach kGridTarget, a unit's slot groups go to Y blocks
//     and then, past kMinRangeChunks·32 rows, its rows to S blocks; each
//     stores its raw lists and the last block of a (unit, slot group) — a
//     counter zeroed by cudaMemsetAsync in the entry, __threadfence, reads
//     through L2 — merges the S lists in the same launch.
//
// Plain C interface for ctypes: pointers and the stream are void*, each entry
// returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "topk.cuh"

namespace {

using hqi::WarpSelect;
using hqi::kFullMask;
using hqi::kNegInf;
using hqi::kNoIdx;
using hqi::kSelectBuf;
using hqi::prepare;

// acc + Σ_j lut[j][code[j]] over j = 0 … n-1 of one staged code row, added
// in that order. vec: cr is 8-byte aligned and n a multiple of 8 (codes read
// 8 at a time).
__device__ __forceinline__ float adc_add(float acc, const float* __restrict__ lut, const uint8_t* cr,
                                         int n, bool vec) {
  if (vec) {
    for (int j = 0; j < n; j += 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(cr + j);
#pragma unroll
      for (int b = 0; b < 4; ++b) acc += lut[(j + b) * 256 + ((w.x >> (8 * b)) & 255u)];
#pragma unroll
      for (int b = 0; b < 4; ++b) acc += lut[(j + 4 + b) * 256 + ((w.y >> (8 * b)) & 255u)];
    }
  } else {
    for (int j = 0; j < n; ++j) acc += lut[j * 256 + cr[j]];
  }
  return acc;
}

// Σ_m lut[m][code[m]] for one staged code row, in the order m = 0 … M-1.
__device__ __forceinline__ float adc_row(const float* __restrict__ lut, const uint8_t* cr, int M) {
  return adc_add(0.f, lut, cr, M, (M & 7) == 0);
}

// ====================================================== adc_slot_warps_kernel

namespace adc {

constexpr int kWarps = 8;             // most warps a block
constexpr int kStages = 6;            // ring tiles: kStages - 1 in flight ahead
constexpr int kChunk = 32;            // rows a warp scores at once, one a lane
constexpr int kTileChunks = 4;        // chunks a tile holds at least
constexpr int kLutKiB = 64;           // LUT rows a block stages at most when it takes > 1 slot
constexpr int kGridTarget = 2 * 3 * 132;  // blocks a split grid aims for (2 waves at M 8)
constexpr int kMinRangeChunks = 8;         // chunks a split range holds at least
constexpr size_t kSmemOptin = 232448;  // sm_90: most dynamic shared memory a block may take

// A tile of T chunks: their 32-row code blocks, then their mask bytes.
__host__ __device__ inline int stage_bytes(int M, int T) { return kChunk * T * (M + 1); }

// Mirrored by kernels/pq_scan.py::adc_smem_bytes.
__host__ inline size_t smem_bytes(int M, int G, int g, int T) {
  return (size_t)G * M * 256 * sizeof(float)        // the group's LUT rows
         + (size_t)kStages * stage_bytes(M, T)      // the ring
         + (size_t)G * g * kSelectBuf * 8           // the warps' candidate buffers
         + 16;                                      // last-block flag
}

// G slots a block, g warps a slot (halved until the block fits with tiles
// of g chunks), T chunks a tile (a multiple of g, each of a slot's warps
// taking every g-th chunk: kTileChunks where that fits, else g). The CPU
// tests mirror this and split_of in tests/torch_adc_shape.py.
__host__ inline void slot_warps(int M, int TQ, int& G, int& g, int& T) {
  G = 1;
  while (2 * G <= kWarps && 2 * G * M <= kLutKiB && G < TQ) G *= 2;
  g = kWarps / G;
  while (g > 1 && smem_bytes(M, G, g, g) > kSmemOptin) g /= 2;
  T = g > kTileChunks ? g : kTileChunks;
  if (smem_bytes(M, G, g, T) > kSmemOptin) T = g;
}

// Blocks per unit, Y over its slot groups (G slots each; block y takes
// groups y, y + Y, ...) and then S over its rows (ranges of whole 32-row
// chunks, at least kMinRangeChunks), until the grid reaches kGridTarget.
// Groups come first: a group's LUT rows are staged once whichever block
// takes it, a range's once per range.
__host__ inline void split_of(int W, int TQ, int TV, int G, int& Y, int& S) {
  const int groups = (TQ + G - 1) / G, nch = (TV + kChunk - 1) / kChunk;
  Y = kGridTarget / W;
  if (Y > groups) Y = groups;
  if (Y < 1) Y = 1;
  int s = kGridTarget / (W * Y);
  if (s > nch / kMinRangeChunks) s = nch / kMinRangeChunks;
  S = 1;
  if (s > 1) {
    const int per = (nch + s - 1) / s;
    S = (nch + per - 1) / per;
  }
}

struct Shape {
  int TQ, TV, M, k;
  int G, g, T;  // slots a block takes at a time; warps a slot; chunks a tile
  int Y, S;     // blocks per unit over its slot groups, and over its rows
  int per;   // 32-row chunks a range
};

// nbytes from src into shared dst (16-byte aligned), block-wide: whole
// 16-byte blocks of an aligned source by cp.async (the caller commits), the
// rest by plain loads.
__device__ __forceinline__ void block_copy(uint8_t* dst, const uint8_t* src, int nbytes) {
  const int b16 = (reinterpret_cast<uintptr_t>(src) & 15) ? 0 : (nbytes & ~15);
  for (int b = b16 + threadIdx.x; b < nbytes; b += blockDim.x) dst[b] = src[b];
  for (int q = threadIdx.x; q < (b16 >> 4); q += blockDim.x) sm90::cp_async16(dst + 16 * q, src + 16 * q);
}

// Grid (W, Y, S): block (w, y, z) scans rows [z·per·32, (z+1)·per·32) of
// unit w for the unit's slot groups y, y + Y, ... (G live slots each). Warp
// j serves slot group·G + j / g and takes the range's chunks c with
// c % g == j % g, tile by tile. Block (w, 0, 0) writes the slots past
// n_live. With S == 1 the slot's first warp writes its final list;
// otherwise each block stores its raw lists in part [W, TQ, S, k] and the
// last block of a (unit, group) — counters [W, ceil(TQ / G)], zeroed by the
// entry — merges the S lists.
template <int KL>
__global__ void __launch_bounds__(kWarps * 32, 3)
    adc_slot_warps_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                          const uint8_t* __restrict__ valid, const int* __restrict__ n_live,
                          const float* __restrict__ floor_s, const int* __restrict__ floor_i,
                          float* __restrict__ part_s, int* __restrict__ part_i,
                          unsigned* __restrict__ counters, float* __restrict__ out_s,
                          int* __restrict__ out_i, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = blockIdx.x, y = blockIdx.y, z = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int TQ = sh.TQ, M = sh.M, k = sh.k, G = sh.G, g = sh.g, tch = sh.T;
  const int mine = warp / g, sub = warp - mine * g;  // slot of the group, first chunk of a tile
  const int n = n_live ? min(max(n_live[w], 0), TQ) : TQ;

  if (y == 0 && z == 0) {  // slots that hold no query: written, never read
    for (size_t o = ((size_t)w * TQ + n) * k + threadIdx.x; o < (size_t)(w + 1) * TQ * k;
         o += blockDim.x) {
      out_s[o] = kNegInf;
      out_i[o] = -1;
    }
  }
  const int groups = (n + G - 1) / G;
  if (y >= groups) return;

  float* luts = reinterpret_cast<float*>(smem_raw);  // [G][M·256]
  uint8_t* ring = smem_raw + (size_t)G * M * 256 * sizeof(float);
  const int sbytes = stage_bytes(M, tch), cbytes = kChunk * tch * M;
  float* bs = reinterpret_cast<float*>(ring + (size_t)kStages * sbytes);
  int* bi = reinterpret_cast<int*>(bs + G * g * kSelectBuf);
  int* flag = bi + G * g * kSelectBuf;
  const float* ql = luts + (size_t)mine * M * 256;

  const int row0 = z * sh.per * kChunk, row1 = min(sh.TV, (z + 1) * sh.per * kChunk);
  const int trows = kChunk * tch;
  const int ntiles = (row1 - row0 + trows - 1) / trows;
  const int nch = (row1 - row0 + kChunk - 1) / kChunk;
  const bool direct = nch <= 2 * g;  // a warp's chunks, at most two, are sorted at once
  const uint8_t* cw = codes + (size_t)w * sh.TV * M;
  const uint8_t* vw = valid + (size_t)w * sh.TV;
  auto issue = [&](int t) {  // tile t into stage t % kStages; one cp.async group
    if (t < ntiles) {
      const int r0 = row0 + t * trows, nr = min(trows, row1 - r0);
      uint8_t* st = ring + (size_t)(t % kStages) * sbytes;
      block_copy(st, cw + (size_t)r0 * M, nr * M);
      block_copy(st + cbytes, vw + r0, nr);
    }
    sm90::cp_async_commit();
  };

  WarpSelect<KL> sel;
  sel.bs = bs + warp * kSelectBuf;
  sel.bi = bi + warp * kSelectBuf;
  sel.k = k;
  for (int grp = y; grp < groups; grp += sh.Y) {
    const int slot = grp * G + mine;
    const bool active = slot < n;  // warp-uniform
    __syncthreads();  // the previous group is done with the LUT rows, the ring and the buffers
    if (active) {  // the slot's LUT row, its g warps sharing the copy; joins tile 0's group
      const float* src = lut + ((size_t)w * TQ + slot) * M * 256;
      float* dst = luts + (size_t)mine * M * 256;
      for (int p = sub * 32 + lane; p < M * 64; p += 32 * g) sm90::cp_async16(dst + 4 * p, src + 4 * p);
    }
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    sel.reset();
    if (active) sel.set_floor(floor_s, floor_i, (size_t)w * TQ + slot);
    float d0 = -INFINITY, d1 = -INFINITY;  // a direct warp's candidates, two a lane
    int i0 = kNoIdx, i1 = kNoIdx;
    for (int t = 0; t < ntiles; ++t) {
      sm90::cp_async_wait<kStages - 2>();  // tile t (and the LUT rows) landed
      __syncthreads();  // for every thread; and tile t - 1 is consumed
      issue(t + kStages - 1);  // into tile t - 1's stage
      if (!active) continue;
      const uint8_t* st = ring + (size_t)(t % kStages) * sbytes;
      for (int c = sub; c < tch && t * tch + c < nch; c += g) {  // this warp's chunks of the tile
        const int lr = c * kChunk + lane, r = row0 + t * trows + lr;
        bool ok = r < row1 && st[cbytes + lr] != 0;
        float acc = ok ? adc_row(ql, st + (size_t)lr * M, M) : -INFINITY;
        if (!sel.admits(acc, r)) {  // a later pass: ranks at or before the floor
          ok = false;
          acc = -INFINITY;
        }
        if (!direct) {
          sel.offer(acc, r, ok, lane);
        } else if (t * tch + c < g) {  // the warp's first chunk
          d0 = acc;
          i0 = ok ? r : kNoIdx;
        } else {
          d1 = acc;
          i1 = ok ? r : kNoIdx;
        }
      }
    }
    if (active) {
      if (direct)
        sel.top.sort_from(d0, i0, d1, i1, nch > g, k, lane);
      else
        sel.flush(lane);
    }
    if (g > 1) {  // the slot's pieces fold into its first warp's list
      if (active && sub != 0) sel.top.store(sel.bs, sel.bi, k, lane);
      __syncthreads();
      if (active && sub == 0) {
        for (int m = 1; m < g; ++m)
          sel.offer_list(bs + (warp + m) * kSelectBuf, bi + (warp + m) * kSelectBuf, k, false, lane);
        sel.flush(lane);
      }
    }
    const bool lead = active && sub == 0;
    const size_t o = ((size_t)w * TQ + slot) * k;
    if (sh.S == 1) {
      if (lead) sel.top.write_final(k, out_s + o, out_i + o, lane);
      continue;
    }
    const size_t pb = ((size_t)w * TQ + slot) * sh.S * k;
    if (lead) {
      sel.top.store(part_s + pb + (size_t)z * k, part_i + pb + (size_t)z * k, k, lane);
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      *flag = atomicAdd(counters + (size_t)w * ((TQ + G - 1) / G) + grp, 1u) == (unsigned)(sh.S - 1);
    __syncthreads();
    if (*flag && lead) {  // the last range's block: every range's list is visible
      __threadfence();
      sel.reset();
      for (int r = 0; r < sh.S; ++r)
        sel.offer_list(part_s + pb + (size_t)r * k, part_i + pb + (size_t)r * k, k, true, lane);
      sel.flush(lane);
      sel.top.write_final(k, out_s + o, out_i + o, lane);
    }
  }
}

template <int KL>
cudaError_t launch(const void* lut, const void* codes, const void* valid, const void* n_live,
                   const void* floor_s, const void* floor_i, void* part_s, void* part_i,
                   void* counters, void* out_s, void* out_i, int W, const Shape& sh,
                   cudaStream_t stream) {
  // the shared-memory opt-in once per device (an attribute set on every call
  // is host time on every call)
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(adc_slot_warps_kernel<KL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemOptin);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  adc_slot_warps_kernel<KL><<<dim3(W, sh.Y, sh.S), sh.G * sh.g * 32, smem_bytes(sh.M, sh.G, sh.g, sh.T),
                              stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(n_live),
      static_cast<const float*>(floor_s), static_cast<const int*>(floor_i), static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<unsigned*>(counters), static_cast<float*>(out_s),
      static_cast<int*>(out_i), sh);
  return cudaGetLastError();
}

}  // namespace adc

// ====================================================== LUT-stationary scan

namespace lutst {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;       // ring stages a warp: kStages - 1 items in flight
constexpr int kChunk = 32;       // rows an item holds, one a lane
constexpr int kMaxRange = 128;   // slots a block of the units kernel takes, most
constexpr size_t kSmemOptin = 232448;  // sm_90: most dynamic shared memory a block may take

__host__ __device__ inline int stage_code_bytes(int M) { return (kChunk * M + 15) & ~15; }
__host__ __device__ inline int stage_bytes(int M) { return stage_code_bytes(M) + kChunk; }

// Mirrored by kernels/pq_scan.py::lut_stationary_smem_bytes. Ms: the LUT
// subspaces staged at once (M where the whole row fits).
__host__ inline size_t smem_bytes(int M, int Ms) {
  return (size_t)Ms * 256 * sizeof(float)                     // one query's LUT row, or a slice
         + (size_t)kWarps * kStages * stage_bytes(M)           // the warps' rings
         + (size_t)kWarps * kSelectBuf * 8                     // the warps' candidate buffers
         + (size_t)kMaxRange * 3 * sizeof(int)                 // the range's rows, slots, units
         + (size_t)(kMaxRange + 1) * sizeof(int)               // its runs' bounds
         + 16;                                                 // run count, last-block flag
}

// The LUT subspaces a block stages at once: all M where the row fits beside
// the rings (M <= 109), else the widest multiple of 8 that does (a row
// passes in slices, each chunk's sums carried in registers from one slice to
// the next); 0 where not even 8 fit. Mirrored by
// kernels/pq_scan.py::lut_stationary_slice.
__host__ inline int lut_slice(int M) {
  if (smem_bytes(M, M) <= kSmemOptin) return M;
  int ms = (M - 1) & ~7;
  while (ms > 0 && smem_bytes(M, ms) > kSmemOptin) ms -= 8;
  return ms;
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

__device__ __forceinline__ Smem carve(unsigned char* raw, int M, int Ms) {
  Smem m;
  size_t off = (size_t)Ms * 256 * sizeof(float);
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

// n subspaces of a LUT row (n·256 floats, 16-byte aligned) into shared
// memory by plain 16-byte loads, so the ring's cp.async groups stay in flight.
__device__ __forceinline__ void stage_slice(float* dst, const float* src, int n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int g = threadIdx.x; g < n * 64; g += kThreads) d[g] = __ldg(s + g);
}

// The sliced score of lane's row of the current item (sliced kernels only):
// acc over the row's LUT passed through shared memory Ms subspaces at a time,
// block-wide. Every warp of the block calls it, with an item or without (ok
// false), so each passes the same barriers; the sum runs m = 0 … M-1 in
// registers, as adc_row's.
__device__ __forceinline__ float sliced_row(float* slut, const float* row_lut, const uint8_t* cr, int M,
                                            int Ms, bool ok) {
  float acc = 0.f;
  for (int m0 = 0; m0 < M; m0 += Ms) {
    const int n = min(Ms, M - m0);
    __syncthreads();  // every warp is done with the previous slice
    stage_slice(slut, row_lut + (size_t)m0 * 256, n);
    __syncthreads();
    if (ok) acc = adc_add(acc, slut, cr + m0, n, (M & 7) == 0);
  }
  return ok ? acc : -INFINITY;
}

// workunit_pq_scan_streamed. keys/order: the W·TQ slots sorted by table row
// (stable); block b takes positions [b·P, b·P + P). With g = 1 the warps
// take a run's slots in turn, a warp a slot; with g = 8 the block takes
// them one at a time, each warp scanning its piece of the slot's row chunks
// (a contiguous eighth) and the pieces' lists folding into warp 0's. The
// slot's first warp writes out [W, TQ, k]. Where the row does not fit
// beside the rings (Ms < M), each chunk is scored against the row passed
// through shared memory in slices (sliced_row), the warps in step: a round
// gives each warp its next slot of the run (or none) and every warp the
// same count of chunk steps.
template <int KL>
__global__ void __launch_bounds__(kThreads, 4)
    lut_stationary_units_kernel(const float* __restrict__ table, const int* __restrict__ keys,
                                const int64_t* __restrict__ order, const uint8_t* __restrict__ codes,
                                const uint8_t* __restrict__ valid, const float* __restrict__ floor_s,
                                const int* __restrict__ floor_i, float* __restrict__ out_s,
                                int* __restrict__ out_i, int N, int TQ, int TV, int M, int U, int k,
                                int P, int g, int Ms) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, M, Ms);
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
    if (Ms < M) {  // block-uniform
      const float* row_lut = table + (size_t)row * M * 256;
      const int rounds = (b - a + groups - 1) / groups, steps = (nch + g - 1) / g;
      for (int r = 0; r < rounds; ++r) {
        const int pos = a + grp + r * groups;
        const bool active = pos < b;  // warp-uniform
        sel.reset();
        if (active) sel.set_floor(floor_s, floor_i, sm.slots[pos]);
        float d0 = -INFINITY, d1 = -INFINITY;
        int i0 = kNoIdx, i1 = kNoIdx;
        for (int i = 0; i < steps; ++i) {
          const int ch = c0 + i, r0 = ch * kChunk;
          const bool item = active && ch < c1;
          if (item) {
            issue_next();
            ring.wait();
          }
          const int nrows = item ? min(kChunk, TV - r0) : 0;
          bool ok = lane < nrows && ring.valid(t)[lane] != 0;
          float acc = sliced_row(sm.lut, row_lut, ring.codes(t) + lane * M, M, Ms, ok);
          if (!item) continue;
          if (!sel.admits(acc, r0 + lane)) {  // a later pass: ranks at or before the floor
            ok = false;
            acc = -INFINITY;
          }
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
          ++t;
        }
        if (active) {
          if (direct)
            sel.top.sort_from(d0, i0, d1, i1, c1 - c0 == 2, k, lane);
          else
            sel.flush(lane);
        }
        if (g > 1) fold_block<KL>(sel, sm, warp, lane);  // g = 8: every warp is active
        if (active && mem == 0) {
          const size_t o = (size_t)sm.slots[pos] * k;
          sel.top.write_final(k, out_s + o, out_i + o, lane);
        }
      }
      continue;
    }
    __syncthreads();  // every warp is done with the previous row
    stage_lut(sm.lut, table + (size_t)row * M * 256, M);
    __syncthreads();
    for (int pos = a + grp; pos < b; pos += groups) {
      sel.reset();
      sel.set_floor(floor_s, floor_i, sm.slots[pos]);
      float d0 = -INFINITY, d1 = -INFINITY;  // a direct piece's candidates, two a lane
      int i0 = kNoIdx, i1 = kNoIdx;
      for (int ch = c0; ch < c1; ++ch, ++t) {
        issue_next();
        ring.wait();
        const int r0 = ch * kChunk;
        bool ok;
        float acc = score_row(ring, t, sm.lut, min(kChunk, TV - r0), lane, ok);
        if (!sel.admits(acc, r0 + lane)) {  // a later pass: ranks at or before the floor
          ok = false;
          acc = -INFINITY;
        }
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
// them into out [k]. Sliced (Ms < M): every warp takes as many chunk steps
// as the block's longest range, each scored by sliced_row.
template <int KL>
__global__ void __launch_bounds__(kThreads)
    lut_stationary_rows_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                               const uint8_t* __restrict__ valid, const float* __restrict__ floor_s,
                               const int* __restrict__ floor_i, float* __restrict__ part_s,
                               int* __restrict__ part_i, unsigned* __restrict__ counter,
                               float* __restrict__ out_s, int* __restrict__ out_i, int NV, int M,
                               int k, int Ms) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, M, Ms);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (floor_i && floor_i[0] < 0) {  // the pass before came up short: nothing is left to read
    if (blockIdx.x == 0)
      for (int e = threadIdx.x; e < k; e += kThreads) {
        out_s[e] = kNegInf;
        out_i[e] = -1;
      }
    return;
  }
  if (Ms == M) {
    stage_lut(sm.lut, lut, M);
    __syncthreads();
  }

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
  sel.set_floor(floor_s, floor_i, 0);
  if (Ms == M) {
    for (int c = c0, t = 0; c < c1; ++c, ++t) {
      issue_next();
      ring.wait();
      bool ok;
      const float acc = score_row(ring, t, sm.lut, min(kChunk, NV - c * kChunk), lane, ok);
      sel.offer(acc, c * kChunk + lane, ok, lane);
      __syncwarp();
    }
  } else {
    int steps = 0;  // the block's longest range
    for (int v = 0; v < kWarps; ++v) {
      const long gv = (long)blockIdx.x * kWarps + v;
      steps = max(steps, (int)(nch * (gv + 1) / nw - nch * gv / nw));
    }
    for (int i = 0, t = 0; i < steps; ++i) {
      const int c = c0 + i;
      const bool item = c < c1;
      if (item) {
        issue_next();
        ring.wait();
      }
      const int nrows = item ? min(kChunk, NV - c * kChunk) : 0;
      const bool ok = lane < nrows && ring.valid(t)[lane] != 0;
      const float acc = sliced_row(sm.lut, lut, ring.codes(t) + lane * M, M, Ms, ok);
      if (!item) continue;
      sel.offer(acc, c * kChunk + lane, ok, lane);
      __syncwarp();
      ++t;
    }
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
                         const void* valid, const void* floor_s, const void* floor_i, void* out_s,
                         void* out_i, int N, int TQ, int TV, int M, int U, int k, int P, int g, int Ms,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(M, Ms);
  cudaError_t err = prepare(lut_stationary_units_kernel<KL>, smem);
  if (err != cudaSuccess) return err;
  lut_stationary_units_kernel<KL><<<(N + P - 1) / P, kThreads, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(keys),
      static_cast<const int64_t*>(order), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(floor_s),
      static_cast<const int*>(floor_i), static_cast<float*>(out_s), static_cast<int*>(out_i), N, TQ, TV,
      M, U, k, P, g, Ms);
  return cudaGetLastError();
}

template <int KL>
cudaError_t launch_rows(const void* lut, const void* codes, const void* valid, const void* floor_s,
                        const void* floor_i, void* part_s, void* part_i, void* counter, void* out_s,
                        void* out_i, int NV, int M, int k, int G, int Ms, cudaStream_t stream) {
  const size_t smem = smem_bytes(M, Ms);
  cudaError_t err = prepare(lut_stationary_rows_kernel<KL>, smem);
  if (err != cudaSuccess) return err;
  lut_stationary_rows_kernel<KL><<<G, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(floor_s),
      static_cast<const int*>(floor_i), static_cast<float*>(part_s), static_cast<int*>(part_i),
      static_cast<unsigned*>(counter), static_cast<float*>(out_s), static_cast<int*>(out_i), NV, M, k,
      Ms);
  return cudaGetLastError();
}

}  // namespace lutst

// ============================================================ wide M
//
// adc_wide_m_kernel: all three addressings past M = MAX_M (190), where one
// LUT row and a ring no longer fit shared memory together. LUT-slice
// stationary: a block owns one LUT row and a tile of code rows (the rows of
// its slots' units; for pq_scan a range of the code array), and the row
// passes through shared memory in slices of kMs subspaces (48 KiB), by
// cp.async into two buffers, so slice j + 1 lands while slice j is read.
// The slice loop sits outside the row loop: each lane carries the partial
// sums of kR rows of its warp in registers from one slice to the next, so a
// slice is staged once for the block's whole tile (kWarps · kR · 32 rows)
// and each row's sum still runs m = 0 … M-1 (as adc_row and the plain
// versions: the results stay bit-equal). A lane reads its row's codes for a
// slice straight from device memory as four aligned 16-byte words (one
// line a row, where 8-byte or byte reads would touch it five to 48 times)
// and takes them apart by funnel shifts, so an M that is not a multiple of
// 8 costs what a multiple does.
// After a row's last slice its sum goes to topk.cuh's WarpSelect behind the
// pass's floor.
//   * units (resident table + lut_idx): the wrapper sorts the slots by
//     table row (slot_order); an item is P consecutive slots of that
//     order, and each run of one row among them shares the row's slices: a
//     slot's TV rows go to g warps (g · 256 rows a tile, P = kWarps / g),
//     whose lists fold into the first's. Slots of row -1 are written
//     (NEG_INF, -1) unread.
//   * dense (expanded LUTs + n_live): an item is one slot, its rows over
//     all eight warps; dead slots are written (NEG_INF, -1) unread.
//   * both: two blocks an SM walk the items (blockIdx.x, + gridDim.x, …),
//     so the padding slots, sorted first, cost no block launches.
//   * rows (pq_scan): G blocks, each a contiguous range of the NV rows over
//     its eight warps; each block stores its list and the last block to
//     count itself (a counter the entry zeroes) merges them in the launch.
// Shared memory: two LUT slices (96 KiB) and the candidate buffers, two
// blocks an SM. What bounds it: bytes
// (the codes of the valid rows, the distinct LUT rows, the output) and,
// past M ~256, the lookups: M random 4-byte reads of shared memory per
// (live slot, valid row), at most one a bank a clock (PERF.md §6, the lookup
// bound). Units longer than one tile restage the row per tile.

namespace wide {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kR = 8;                    // rows a lane carries across the slices
constexpr int kWarpRows = 32 * kR;       // rows a warp takes a tile
constexpr int kMs = 48;                  // LUT subspaces a slice
constexpr int kSliceFloats = kMs * 256;  // 48 KiB
constexpr int kWords = 4;                // 16-byte words a lane reads a row and slice: kMs + 15 <= 64
constexpr int kUnits = 0, kDense = 1, kRows = 2;
constexpr int kBlocksPerSm = 2;          // what shared memory and registers let an SM hold

// Mirrored by kernels/pq_scan.py::wide_m_launch_shape: two slice buffers
// and the warps' candidate buffers.
constexpr size_t kSmemBytes = 2 * (size_t)kSliceFloats * sizeof(float) + (size_t)kWarps * kSelectBuf * 8;

// Warps a slot's rows go to in the units mode: the fewest (a power of two)
// whose tile covers TV rows, at most kWarps.
__host__ __device__ inline int warps_per_slot(int TV) {
  int g = 1;
  while (g < kWarps && g * kWarpRows < TV) g *= 2;
  return g;
}

struct Args {
  const float* lut;  // units: table [U, M, 256]; dense: [W·TQ, M, 256]; rows: [M, 256]
  const int* keys;   // units: the slots' table rows, sorted (slot_order)
  const int64_t* order;  // units: their slots w·TQ + t
  const int* n_live;     // dense: live slots per unit, or null (all)
  const uint8_t* codes;  // [W, TV, M] ([NV, M] for rows)
  const uint8_t* codes_end;
  const uint8_t* valid;  // [W, TV] ([NV])
  const float* floor_s;  // [W·TQ] or null (the first pass)
  const int* floor_i;
  float* part_s;  // rows: [G, k] lists and a counter
  int* part_i;
  unsigned* counter;
  float* out_s;  // [W·TQ, k]
  int* out_i;
  int mode, N, TQ, TV, M, U, k, P, g, items;
};

// One slice's n subspaces (n·256 floats) into shared memory by cp.async (no commit).
__device__ __forceinline__ void stage_slice_async(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n * 64; e += kThreads) sm90::cp_async16(dst + 4 * e, src + 4 * e);
}

// acc + Σ_{j<n} lut[j][cr[j]], j in order, for the n <= kMs codes at cr (any
// alignment): kWords aligned 16-byte words (none at or past `end`), whose
// 32-bit words from cr's own offset on each give 4 codes by a funnel shift.
// FULL: n == kMs (no bound on j).
template <bool FULL>
__device__ __forceinline__ float adc_slice(float acc, const float* __restrict__ lut, const uint8_t* cr, int n,
                                           const uint8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(cr);
  const uint4* base = reinterpret_cast<const uint4*>(a & ~(uintptr_t)15);
  uint32_t w[4 * kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint4 x = reinterpret_cast<const uint8_t*>(base + i) < end ? __ldg(base + i) : make_uint4(0u, 0u, 0u, 0u);
    w[4 * i] = x.x;
    w[4 * i + 1] = x.y;
    w[4 * i + 2] = x.z;
    w[4 * i + 3] = x.w;
  }
  const int o = (int)((a >> 2) & 3);  // cr's 32-bit word inside its 16-byte word
  const uint32_t sh = 8u * (uint32_t)(a & 3);
#pragma unroll
  for (int j = 0; j < kMs / 4; ++j) {
    const uint32_t lo0 = (o & 1) ? w[j + 1] : w[j], lo1 = (o & 1) ? w[j + 3] : w[j + 2];
    const uint32_t hi0 = (o & 1) ? w[j + 2] : w[j + 1], hi1 = (o & 1) ? w[j + 4] : w[j + 3];
    const uint32_t c = __funnelshift_r((o & 2) ? lo1 : lo0, (o & 2) ? hi1 : hi0, sh);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (FULL || 4 * j + b < n) acc += lut[(4 * j + b) * 256 + ((c >> (8 * b)) & 255u)];
  }
  return acc;
}

// Rows [lo, hi) of one code array (cw/vw) scored against one LUT row, block-
// wide: the rows go in tiles of g · kWarpRows, lane's rows of a tile
// r0 + (i·g + mem)·32 + lane, i < kR; for each tile the row's slices (and
// the warp's windows) pass through shared memory, double-buffered, the sums
// carried in acc. Every warp of the block calls it (inactive ones too: the
// slices are barriers); an active warp offers its rows' scores to sel
// (indices: the rows).
template <int KL>
__device__ __forceinline__ void scan_rows(const Args& a, float* slut, const float* row_lut, const uint8_t* cw,
                                          const uint8_t* vw, int lo, int hi, bool active, int mem, int g,
                                          WarpSelect<KL>& sel, int lane) {
  const int M = a.M;
  const int nsl = (M + kMs - 1) / kMs;
  const int tile_rows = g * kWarpRows;
  const int steps = (hi - lo + tile_rows - 1) / tile_rows * nsl;
  __syncthreads();  // the buffers are free: every warp is done with the previous item
  if (steps == 0) return;  // block-uniform: an empty range
  stage_slice_async(slut, row_lut, min(kMs, M));
  sm90::cp_async_commit();
  float acc[kR];
  unsigned okm = 0;
  for (int s = 0; s < steps; ++s) {
    const int tile = s / nsl, sl = s - tile * nsl;
    if (s + 1 < steps) {
      const int ns = (s + 1) % nsl;
      stage_slice_async(slut + ((s + 1) & 1) * kSliceFloats, row_lut + (size_t)ns * kSliceFloats,
                        min(kMs, M - ns * kMs));
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();  // slice s is in place for every thread
    const int r0 = lo + tile * tile_rows;
    if (sl == 0) {
      okm = 0;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        acc[i] = 0.f;
        const int row = r0 + (i * g + mem) * 32 + lane;
        if (active && row < hi && vw[row] != 0) okm |= 1u << i;
      }
    }
    const float* cur = slut + (s & 1) * kSliceFloats;
    const int m0 = sl * kMs, n = min(kMs, M - m0);
    if (n == kMs) {
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if ((okm >> i) & 1u)
          acc[i] = adc_slice<true>(acc[i], cur, cw + (size_t)(r0 + (i * g + mem) * 32 + lane) * M + m0, n,
                                   a.codes_end);
    } else {
#pragma unroll
      for (int i = 0; i < kR; ++i)
        if ((okm >> i) & 1u)
          acc[i] = adc_slice<false>(acc[i], cur, cw + (size_t)(r0 + (i * g + mem) * 32 + lane) * M + m0, n,
                                    a.codes_end);
    }
    if (active && sl == nsl - 1) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const bool ok = (okm >> i) & 1u;
        sel.offer(ok ? acc[i] : -INFINITY, r0 + (i * g + mem) * 32 + lane, ok, lane);
      }
    }
    __syncthreads();  // slice s is read before step s + 2 refills its buffer
  }
  sm90::cp_async_wait<0>();  // only empty groups are left; none outlives the item
}

// The lists of each group of g warps fold into its first warp's (block-wide).
template <int KL>
__device__ __forceinline__ void fold_groups(WarpSelect<KL>& sel, float* bs, int* bi, int warp, int g,
                                            bool active, int lane) {
  const int mem = warp % g;
  if (active && mem != 0) sel.top.store(sel.bs, sel.bi, sel.k, lane);
  __syncthreads();
  if (active && mem == 0) {
    for (int j = 1; j < g; ++j)
      sel.offer_list(bs + (warp + j) * kSelectBuf, bi + (warp + j) * kSelectBuf, sel.k, false, lane);
    sel.flush(lane);
  }
  __syncthreads();  // the buffers are free again
}

__device__ __forceinline__ void write_absent(float* os, int* oi, int k, int lane) {
  for (int e = lane; e < k; e += 32) {
    os[e] = kNegInf;
    oi[e] = -1;
  }
}

template <int KL>
__global__ void __launch_bounds__(kThreads) adc_wide_m_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slut = reinterpret_cast<float*>(smem_raw);  // [2][kMs][256]
  float* bs = slut + 2 * kSliceFloats;               // [kWarps][kSelectBuf]
  int* bi = reinterpret_cast<int*>(bs + kWarps * kSelectBuf);
  __shared__ int s_row[kWarps], s_slot[kWarps], s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpSelect<KL> sel;
  sel.bs = bs + warp * kSelectBuf;
  sel.bi = bi + warp * kSelectBuf;
  sel.k = a.k;
  sel.reset();

  if (a.mode == kRows) {
    if (a.floor_i && a.floor_i[0] < 0) {  // the pass before came up short: nothing is left
      if (blockIdx.x == 0 && warp == 0) write_absent(a.out_s, a.out_i, a.k, lane);
      return;
    }
    const int lo = (int)((long long)a.TV * blockIdx.x / gridDim.x);
    const int hi = (int)((long long)a.TV * (blockIdx.x + 1) / gridDim.x);
    sel.set_floor(a.floor_s, a.floor_i, 0);
    scan_rows<KL>(a, slut, a.lut, a.codes, a.valid, lo, hi, true, warp, kWarps, sel, lane);
    sel.flush(lane);
    fold_groups<KL>(sel, bs, bi, warp, kWarps, true, lane);
    if (warp == 0) {
      sel.top.store(a.part_s + (size_t)blockIdx.x * a.k, a.part_i + (size_t)blockIdx.x * a.k, a.k, lane);
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();  // every block's list is visible to the last one
    sel.reset();
    for (int blk = warp; blk < (int)gridDim.x; blk += kWarps)
      sel.offer_list(a.part_s + (size_t)blk * a.k, a.part_i + (size_t)blk * a.k, a.k, true, lane);
    sel.flush(lane);
    fold_groups<KL>(sel, bs, bi, warp, kWarps, true, lane);
    if (warp == 0) sel.top.write_final(a.k, a.out_s, a.out_i, lane);
    return;
  }

  const int g = a.g;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    // units / dense: this item's slots (their LUT rows; -1: no query)
    int n;
    __syncthreads();  // every thread is done with the previous item's slots
    if (a.mode == kUnits) {
      const int p0 = item * a.P;
      n = min(a.P, a.N - p0);
      if ((int)threadIdx.x < n) {
        const int key = a.keys[p0 + threadIdx.x];
        const int slot = (int)a.order[p0 + threadIdx.x];
        int row = key == -1 ? -1 : min(max(key, 0), a.U - 1);  // other indices are clamped into the table
        if (a.floor_i && a.floor_i[slot] < 0) row = -1;          // the pass before left it short
        s_row[threadIdx.x] = row;
        s_slot[threadIdx.x] = slot;
      }
    } else {
      n = 1;
      if (threadIdx.x == 0) {
        const int slot = item, w = slot / a.TQ, t = slot - w * a.TQ;
        const bool live = (!a.n_live || t < a.n_live[w]) && !(a.floor_i && a.floor_i[slot] < 0);
        s_row[0] = live ? slot : -1;
        s_slot[0] = slot;
      }
    }
    __syncthreads();
    for (int r0 = 0; r0 < n;) {  // runs of one row: block-uniform
      int r1 = r0 + 1;
      while (r1 < n && s_row[r1] == s_row[r0]) ++r1;
      const int row = s_row[r0];
      if (row < 0) {
        for (int pos = r0 + warp; pos < r1; pos += kWarps)
          write_absent(a.out_s + (size_t)s_slot[pos] * a.k, a.out_i + (size_t)s_slot[pos] * a.k, a.k, lane);
      } else {
        const int p = warp / g, mem = warp - p * g;
        const bool active = r0 + p < r1;  // warp-uniform
        const int slot = active ? s_slot[r0 + p] : 0;
        const int w = slot / a.TQ;
        sel.reset();
        if (active) sel.set_floor(a.floor_s, a.floor_i, (size_t)slot);
        scan_rows<KL>(a, slut, a.lut + (size_t)row * a.M * 256, a.codes + (size_t)w * a.TV * a.M,
                      a.valid + (size_t)w * a.TV, 0, a.TV, active, mem, g, sel, lane);
        if (active) sel.flush(lane);
        if (g > 1) fold_groups<KL>(sel, bs, bi, warp, g, active, lane);
        if (active && mem == 0)
          sel.top.write_final(a.k, a.out_s + (size_t)slot * a.k, a.out_i + (size_t)slot * a.k, lane);
      }
      r0 = r1;
    }
  }
}

template <int KL>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  cudaError_t err = prepare(adc_wide_m_kernel<KL>, kSmemBytes);
  if (err != cudaSuccess) return err;
  adc_wide_m_kernel<KL><<<blocks, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// (items, blocks, P, g) of the units and dense modes for W·TQ slots of TV
// rows on a card of `sms` SMs: an item is P slots (units) or one (dense),
// and kBlocksPerSm blocks an SM walk them.
__host__ inline bool shape_of(int mode, int W, int TQ, int TV, int sms, int& items, int& blocks, int& P,
                              int& g) {
  const long long N = (long long)W * TQ;
  g = mode == kUnits ? warps_per_slot(TV) : kWarps;
  P = mode == kUnits ? kWarps / g : 1;
  if (W < 1 || TQ < 1 || TV < 1 || sms < 1 || N > 0x7fffffffLL) return false;
  items = (int)((N + P - 1) / P);
  blocks = min(items, kBlocksPerSm * sms);
  return true;
}

}  // namespace wide

}  // namespace

extern "C" {

// The launch shape of adc_scan_launch for these operands: writes G, g, T
// (slots a block takes at a time, warps a slot, chunks a tile), Y, S (blocks
// per unit over its slot groups, and over its rows) and the int32 words of
// scratch the launch needs (0 at S == 1) to out[0..5].
int adc_launch_shape(int W, int TQ, int TV, int M, int k, int* out) {
  if (W < 1 || TQ < 1 || TV < 1 || M < 1 || k < 1) return (int)cudaErrorInvalidValue;
  adc::slot_warps(M, TQ, out[0], out[1], out[2]);
  adc::split_of(W, TQ, TV, out[0], out[3], out[4]);
  const long long groups = (TQ + out[0] - 1) / out[0];
  const long long words = out[4] > 1 ? 2LL * W * TQ * out[4] * k + W * groups : 0;
  if (words > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  out[5] = (int)words;
  return 0;
}

// Expanded LUTs [W, TQ, M, 256]; codes uint8 [W, TV, M], valid uint8
// [W, TV]; n_live int32 [W] or null (every slot live); out [W, TQ, k]. The
// entry picks the launch shape (adc_launch_shape); at S > 1, scratch holds
// the ranges' lists [W, TQ, S, k] (scores, then ids) and a counter uint32
// per (unit, slot group), zeroed here on the stream before the kernel.
int adc_scan_launch(const void* lut, const void* codes, const void* valid, const void* n_live,
                    const void* floor_s, const void* floor_i, void* scratch, void* out_s, void* out_i,
                    int W, int TQ, int TV, int M, int k, void* stream) {
  if (k > 64 || k > TV || (!floor_s) != (!floor_i)) return (int)cudaErrorInvalidValue;
  int shape[6];
  const int rc = adc_launch_shape(W, TQ, TV, M, k, shape);
  if (rc != 0) return rc;
  const int G = shape[0], g = shape[1], T = shape[2], Y = shape[3], S = shape[4];
  if (adc::smem_bytes(M, G, g, T) > adc::kSmemOptin || (S > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)W * TQ * S * k;
  float* part_s = S > 1 ? static_cast<float*>(scratch) : nullptr;
  int* part_i = S > 1 ? static_cast<int*>(scratch) + n : nullptr;
  unsigned* counters = S > 1 ? static_cast<unsigned*>(scratch) + 2 * n : nullptr;
  if (S > 1) {
    const size_t bytes = (size_t)W * ((TQ + G - 1) / G) * sizeof(unsigned);
    const cudaError_t err = cudaMemsetAsync(counters, 0, bytes, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int nch = (TV + adc::kChunk - 1) / adc::kChunk;
  const adc::Shape sh{TQ, TV, M, k, G, g, T, Y, S, (nch + S - 1) / S};
  if (k <= 32)
    return (int)adc::launch<32>(lut, codes, valid, n_live, floor_s, floor_i, part_s, part_i, counters,
                                out_s, out_i, W, sh, st);
  return (int)adc::launch<64>(lut, codes, valid, n_live, floor_s, floor_i, part_s, part_i, counters,
                              out_s, out_i, W, sh, st);
}

// Resident table [U, M, 256]; keys int32 [W·TQ] (the slots' table rows,
// sorted, stable) with order int64 [W·TQ] (their slot indices w·TQ + t);
// codes uint8 [W, TV, M], valid uint8 [W, TV]; floor_s f32 / floor_i int32
// [W, TQ] or both null (the first pass); out [W, TQ, k]. P slots a block
// (<= 128), g warps a slot (1 or 8). M up to where 8 LUT subspaces fit
// beside the rings (lutst::lut_slice).
int lut_stationary_units_launch(const void* table, const void* keys, const void* order,
                                const void* codes, const void* valid, const void* floor_s,
                                const void* floor_i, void* out_s, void* out_i, int W, int TQ, int TV,
                                int M, int U, int k, int P, int g, void* stream) {
  if ((!floor_s) != (!floor_i) || k < 1 || k > 64 || k > TV || W < 1 || TQ < 1 || M < 1 || U < 1 || P < 1 ||
      P > lutst::kMaxRange || (g != 1 && g != lutst::kWarps) ||
      (long)W * TQ > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int Ms = lutst::lut_slice(M);
  if (Ms < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = W * TQ;
  if (k <= 32)
    return (int)lutst::launch_units<32>(table, keys, order, codes, valid, floor_s, floor_i, out_s, out_i,
                                        N, TQ, TV, M, U, k, P, g, Ms, st);
  return (int)lutst::launch_units<64>(table, keys, order, codes, valid, floor_s, floor_i, out_s, out_i, N,
                                      TQ, TV, M, U, k, P, g, Ms, st);
}

// One query's LUT [M, 256] against codes uint8 [NV, M], valid uint8 [NV];
// floor_s f32 / floor_i int32 [1] or both null (the first pass); out [k]. G
// blocks; part [G, k] scratch; counter: one uint32, zeroed here on the
// stream before the kernel.
int lut_stationary_rows_launch(const void* lut, const void* codes, const void* valid,
                               const void* floor_s, const void* floor_i, void* part_s, void* part_i,
                               void* counter, void* out_s, void* out_i, int NV, int M, int k, int G,
                               void* stream) {
  if (k < 1 || k > 64 || k > NV || M < 1 || G < 1 || (!floor_s) != (!floor_i))
    return (int)cudaErrorInvalidValue;
  const int Ms = lutst::lut_slice(M);
  if (Ms < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  if (k <= 32)
    return (int)lutst::launch_rows<32>(lut, codes, valid, floor_s, floor_i, part_s, part_i, counter,
                                       out_s, out_i, NV, M, k, G, Ms, st);
  return (int)lutst::launch_rows<64>(lut, codes, valid, floor_s, floor_i, part_s, part_i, counter, out_s,
                                     out_i, NV, M, k, G, Ms, st);
}

// The launch of adc_wide_m_launch in the units (dense 0) or dense (dense 1)
// mode for W·TQ slots of TV rows on a card of `sms` SMs: blocks, threads a
// block, dynamic shared bytes, slots an item P, warps a slot g, LUT
// subspaces a slice (kernels/pq_scan.py::wide_m_launch_shape).
int adc_wide_m_shape(int W, int TQ, int TV, int dense, int sms, int* out) {
  int items, blocks, P, g;
  if (!wide::shape_of(dense ? wide::kDense : wide::kUnits, W, TQ, TV, sms, items, blocks, P, g))
    return (int)cudaErrorInvalidValue;
  out[0] = blocks;
  out[1] = wide::kThreads;
  out[2] = (int)wide::kSmemBytes;
  out[3] = P;
  out[4] = g;
  out[5] = wide::kMs;
  return 0;
}

// Any M (the three wrappers past MAX_M), k <= 64. Units: table [U, M, 256],
// keys int32 / order int64 [W·TQ] (slot_order of lut_idx: -1 no query);
// dense: expanded LUTs [W, TQ, M, 256] with n_live int32 [W] or null; both
// with codes uint8 [W, TV, M], valid uint8 [W, TV], floor_s f32 / floor_i
// int32 [W, TQ] or both null (the first pass), out [W, TQ, k], two blocks
// an SM (`sms` of them). Rows (pq_scan): lut [M, 256], codes [NV, M] (NV in TV, W = TQ
// = 1), valid [NV], floor [1] or null, G blocks, part [G, k] scratch and a
// counter the entry zeroes on the stream, out [k]. codes_end: the end of
// the code array (no 16-byte word at or past it is read).
int adc_wide_m_launch(int mode, const void* lut, const void* keys, const void* order, int U,
                      const void* n_live, const void* codes, const void* codes_end, const void* valid,
                      const void* floor_s, const void* floor_i, void* part_s, void* part_i, void* counter,
                      void* out_s, void* out_i, int W, int TQ, int TV, int M, int k, int G, int sms,
                      void* stream) {
  if (k < 1 || k > 64 || k > TV || M < 1 || (!floor_s) != (!floor_i) || mode < wide::kUnits ||
      mode > wide::kRows || (mode == wide::kUnits && (U < 1 || !keys || !order)) ||
      (mode == wide::kRows && (G < 1 || !part_s || !part_i || !counter)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int items = 0, blocks = G, P = 1, g = wide::kWarps;
  if (mode != wide::kRows && !wide::shape_of(mode, W, TQ, TV, sms, items, blocks, P, g))
    return (int)cudaErrorInvalidValue;
  if (mode == wide::kRows) {
    const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
  }
  const wide::Args a{static_cast<const float*>(lut), static_cast<const int*>(keys),
                     static_cast<const int64_t*>(order), static_cast<const int*>(n_live),
                     static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(codes_end),
                     static_cast<const uint8_t*>(valid),
                     static_cast<const float*>(floor_s), static_cast<const int*>(floor_i),
                     static_cast<float*>(part_s), static_cast<int*>(part_i),
                     static_cast<unsigned*>(counter), static_cast<float*>(out_s), static_cast<int*>(out_i),
                     mode, W * TQ, TQ, TV, M, U, k, P, g, items};
  if (k <= 32) return (int)wide::launch<32>(a, blocks, st);
  return (int)wide::launch<64>(a, blocks, st);
}

}  // extern "C"

HQI_ERROR_STRING_ENTRY(pq_scan_error_string)
