// What every scan kernel of this package shares (fused_knn.cu, pq_scan.cu):
// the (score desc, index asc) order, the warp-wide sorted list and select,
// the public encoding of a finished list, and the error-string entry point
// that kernels/_build.py binds for each library.
//
// Encoding: raw lists hold (-inf, kNoIdx) in empty slots; a finished list
// written by WarpTopK::write_final holds (kNegInf, -1) there, and -1 for every score
// <= kNegInf / 2, as repro.kernels.ref.masked_topk_ref does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hqi {

constexpr float kNegInf = -3.4e38f;
constexpr int kNoIdx = 0x7fffffff;  // internal empty-slot index

// (s, i) ranks before (s2, i2): score descending, then index ascending.
__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// ------------------------------------------------------------ warp select
//
// One warp keeps one top-k list (k <= KL; KL = 32 or 64) sorted across its
// lanes, best first: entry e lives in lane e % 32, register e / 32.
// Candidates are offered 32 at a time, one a lane. Those that rank above
// the list's k-th entry go to a per-warp buffer in shared memory (a ballot
// gives each its place); every 32 buffered entries are sorted by a bitonic
// network of shuffles and merged into the list by a half-cleaner and
// bitonic merges. Ranks are a strict order on distinct indices, so the
// list's first k entries are exactly the top-k of every candidate offered,
// ties included, in whatever order they came. A candidate that fails the
// filter ranks below k entries already held, so it can never enter the
// top-k; the list's entries past k may be stale and are never written.

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSelectBuf = 64;  // a warp's buffer: < 32 waiting entries plus one offer of 32

// Exchange with lane ^ stride: the lane whose `stride` bit is clear keeps the
// better entry when `desc`, the worse one otherwise.
__device__ __forceinline__ void warp_cmpx(float& s, int& i, int stride, bool desc, int lane) {
  const float os = __shfl_xor_sync(kFullMask, s, stride);
  const int oi = __shfl_xor_sync(kFullMask, i, stride);
  const bool keep_better = ((lane & stride) == 0) == desc;
  if (keep_better ? better(os, oi, s, i) : better(s, i, os, oi)) {
    s = os;
    i = oi;
  }
}

// Bitonic sort of one entry a lane: lane 0 holds the best when `desc`, the
// worst otherwise (15 exchanges).
__device__ __forceinline__ void warp_sort32(float& s, int& i, bool desc, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      warp_cmpx(s, i, stride, ((lane & size) == 0) == desc, lane);
  }
}

// A bitonic sequence across the warp, sorted best first (5 exchanges).
__device__ __forceinline__ void warp_merge_desc(float& s, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) warp_cmpx(s, i, stride, true, lane);
}

template <int KL>
struct WarpTopK {
  static_assert(KL == 32 || KL == 64, "one or two entries a lane");
  static constexpr int R = KL / 32;
  float s[R];
  int i[R];
  float ks;  // the k-th entry: an offered candidate must rank above it
  int ki;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = -INFINITY;
      i[r] = kNoIdx;
    }
    ks = -INFINITY;
    ki = kNoIdx;
  }

  // Become the top KL of the list and 32 candidates (one a lane, in any
  // order; (-inf, kNoIdx) where a lane has none).
  __device__ __forceinline__ void merge32(float cs, int ci, int k, int lane) {
    warp_sort32(cs, ci, false, lane);  // worst first, against the list's best first
    if constexpr (R == 1) {
      if (better(cs, ci, s[0], i[0])) {  // half-cleaner: the top 32, bitonic
        s[0] = cs;
        i[0] = ci;
      }
      warp_merge_desc(s[0], i[0], lane);
    } else {
      // the list's first 32 entries stay; the rest are the top 32 of its
      // last 32 and the candidates
      if (better(cs, ci, s[1], i[1])) {
        s[1] = cs;
        i[1] = ci;
      }
      warp_merge_desc(s[1], i[1], lane);
      const float rs = __shfl_xor_sync(kFullMask, s[1], 31);  // reversed: worst first
      const int ri = __shfl_xor_sync(kFullMask, i[1], 31);
      if (better(rs, ri, s[0], i[0])) {
        s[1] = s[0];
        i[1] = i[0];
        s[0] = rs;
        i[0] = ri;
      } else {
        s[1] = rs;
        i[1] = ri;
      }
      warp_merge_desc(s[0], i[0], lane);
      warp_merge_desc(s[1], i[1], lane);
    }
    update_kth(k);
  }

  // Become the sorted top KL of up to 64 candidates held two a lane (a: the
  // first 32, b: the next 32 when `two`), with no buffer: a bitonic sort
  // across the warp (one register sorted best first, the other worst first,
  // a half-cleaner between them, a merge of each).
  __device__ __forceinline__ void sort_from(float a, int ai, float b, int bi, bool two, int k,
                                            int lane) {
    warp_sort32(a, ai, true, lane);
    if (two) {
      warp_sort32(b, bi, false, lane);
      if (better(b, bi, a, ai)) {
        const float ts = a;
        const int ti = ai;
        a = b;
        ai = bi;
        b = ts;
        bi = ti;
      }
      warp_merge_desc(a, ai, lane);
      warp_merge_desc(b, bi, lane);
    } else {
      b = -INFINITY;
      bi = kNoIdx;
    }
    s[0] = a;
    i[0] = ai;
    if constexpr (R == 2) {
      s[1] = b;
      i[1] = bi;
    }
    update_kth(k);
  }

  __device__ __forceinline__ void update_kth(int k) {
    const int src = (k - 1) & 31;
    float a = __shfl_sync(kFullMask, s[0], src);
    int b = __shfl_sync(kFullMask, i[0], src);
    if constexpr (R == 2) {
      const float a2 = __shfl_sync(kFullMask, s[1], src);
      const int b2 = __shfl_sync(kFullMask, i[1], src);
      if (k > 32) {
        a = a2;
        b = b2;
      }
    }
    ks = a;
    ki = b;
  }

  // The first n entries, raw, to ls/li (entry e at e).
  __device__ __forceinline__ void store(float* ls, int* li, int n, int lane) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < n) {
        ls[e] = s[r];
        li[e] = i[r];
      }
    }
  }

  // The first k entries in the public encoding (see the head of this file).
  __device__ __forceinline__ void write_final(int k, float* out_s, int* out_i, int lane) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < k) {
        float v = s[r];
        int j = i[r];
        if (j == kNoIdx) {
          v = kNegInf;
          j = -1;
        } else if (v <= kNegInf * 0.5f) {
          j = -1;
        }
        out_s[e] = v;
        out_i[e] = j;
      }
    }
  }
};

// A later pass's floor (kernels/fused_knn.py::floor_passes): a list of more
// than 64 entries is taken in passes of at most 64, and a pass admits only
// candidates that rank strictly after the last entry of the pass before,
// (fs, fi). Ranks are a strict total order, so the passes' lists laid end to
// end are exactly the top-k, ties included. A floor whose index is -1 marks
// a slot that the pass before left short: it admits nothing.
__device__ __forceinline__ bool after_floor(float fs, int fi, float cs, int ci) {
  return fi >= 0 && better(fs, fi, cs, ci);
}

// A warp's list plus its candidate buffer (bs/bi: kSelectBuf entries of
// shared memory owned by the warp). Every member is warp-collective.
template <int KL>
struct WarpSelect {
  WarpTopK<KL> top;
  float* bs;
  int* bi;
  int k;
  int cnt;  // buffered entries (warp-uniform)
  bool has_floor;  // a later pass: admit only what ranks after (fs, fi)
  float fs;
  int fi;

  __device__ __forceinline__ void reset() {
    top.init();
    cnt = 0;
    has_floor = false;
  }

  // The floor of slot `slot` of a later pass (floor_s null: the first pass,
  // no floor). Call after reset().
  __device__ __forceinline__ void set_floor(const float* floor_s, const int* floor_i, size_t slot) {
    has_floor = floor_s != nullptr;
    if (has_floor) {
      fs = floor_s[slot];
      fi = floor_i[slot];
    }
  }

  // Whether a candidate may enter this pass's list at all.
  __device__ __forceinline__ bool admits(float cs, int ci) const {
    return !has_floor || after_floor(fs, fi, cs, ci);
  }

  // Offer one candidate a lane (`ok` false: the lane has none). Returns
  // whether every candidate offered passed the filter.
  __device__ __forceinline__ bool offer(float cs, int ci, bool ok, int lane) {
    const bool pass = ok && better(cs, ci, top.ks, top.ki) && admits(cs, ci);
    const unsigned mask = __ballot_sync(kFullMask, pass);
    const bool all = mask == __ballot_sync(kFullMask, ok);
    if (mask == 0) return all;
    if (pass) {
      const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
      bs[pos] = cs;
      bi[pos] = ci;
    }
    cnt += __popc(mask);
    if (cnt < 32) return all;
    __syncwarp();
    const float ms = bs[lane];
    const int mi = bi[lane];
    const bool more = lane + 32 < cnt;
    float ts = 0.f;
    int ti = 0;
    if (more) {
      ts = bs[lane + 32];
      ti = bi[lane + 32];
    }
    __syncwarp();
    if (more) {
      bs[lane] = ts;
      bi[lane] = ti;
    }
    cnt -= 32;
    top.merge32(ms, mi, k, lane);
    __syncwarp();
    return all;
  }

  // Merge whatever is still buffered.
  __device__ __forceinline__ void flush(int lane) {
    if (cnt == 0) return;
    __syncwarp();
    float ms = -INFINITY;
    int mi = kNoIdx;
    if (lane < cnt) {
      ms = bs[lane];
      mi = bi[lane];
    }
    cnt = 0;
    __syncwarp();
    top.merge32(ms, mi, k, lane);
  }

  // Offer the first n entries of a sorted list in memory, 32 at a time
  // (empty entries, index kNoIdx, are no candidates), up to the first entry
  // the filter rejects: every later entry ranks below it. `cg`: read
  // through L2 only (lists other blocks wrote in this launch).
  __device__ __forceinline__ void offer_list(const float* ls, const int* li, int n, bool cg, int lane) {
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      float cs = -INFINITY;
      int ci = kNoIdx;
      if (e < n) {
        cs = cg ? __ldcg(ls + e) : ls[e];
        ci = cg ? __ldcg(li + e) : li[e];
      }
      if (!offer(cs, ci, ci != kNoIdx, lane)) break;
    }
  }
};

// Opt a kernel into more than 48 KB of dynamic shared memory where it needs it.
template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

}  // namespace hqi

// Every library exports <name>_error_string(err): cudaGetErrorString for the
// codes its entry points return (0 = launched).
#define HQI_ERROR_STRING_ENTRY(fn) \
  extern "C" const char* fn(int err) { return cudaGetErrorString((cudaError_t)err); }
