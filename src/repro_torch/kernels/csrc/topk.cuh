// What every scan kernel of this package shares (fused_knn.cu, pq_scan.cu):
// the (score desc, index asc) order, the sorted top-K register list, the
// public encoding of a finished list, the kernel that merges per-block
// partial lists, the K dispatch, and the error-string entry point that
// kernels/_build.py binds for each library.
//
// Encoding: raw lists hold (-inf, kNoIdx) in empty slots; a finished list
// written by write_final holds (kNegInf, -1) there, and -1 for every score
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

// A sorted top-K list in registers (K is a compile-time bound >= k, so every
// index below is static after unrolling). The first k entries of the top-K
// are the top-k.
template <int K>
struct TopK {
  float s[K];
  int i[K];
  int n;  // filled entries (the rest are (-inf, kNoIdx))

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      s[p] = -INFINITY;
      i[p] = kNoIdx;
    }
    n = 0;
  }

  __device__ __forceinline__ bool admits(float cs, int ci) const {
    return better(cs, ci, s[K - 1], i[K - 1]);
  }

  // Insert by swapping down the list; the old K-th entry drops out.
  __device__ __forceinline__ void push(float cs, int ci) {
    if (!admits(cs, ci)) return;
    n += n < K;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (better(cs, ci, s[p], i[p])) {
        const float ts = s[p];
        const int ti = i[p];
        s[p] = cs;
        i[p] = ci;
        cs = ts;
        ci = ti;
      }
    }
  }

  // Push the entries of a sorted list read from memory, stopping at the
  // first one the list does not admit (every later one ranks below it).
  __device__ __forceinline__ void push_sorted(const float* ls, const int* li, int n) {
    for (int p = 0; p < n; ++p) {
      if (!admits(ls[p], li[p])) break;
      push(ls[p], li[p]);
    }
  }

  __device__ __forceinline__ void store(float* ls, int* li, int n) const {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (p < n) {
        ls[p] = s[p];
        li[p] = i[p];
      }
    }
  }

  // Store the filled entries and, when the list is not full, one empty
  // entry after them: push_sorted and merge_from stop there.
  __device__ __forceinline__ void store_filled(float* ls, int* li) const {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (p <= n) {
        ls[p] = s[p];
        li[p] = i[p];
      }
    }
  }

  // Become the top-K of two sorted lists stored by store_filled (na and nb
  // entries): a merge, one step per entry taken, so short lists cost little
  // and full ones K steps. After p steps a + b == p, so no read passes
  // entry K-1, and an exhausted list shows its empty entry, which never
  // ranks first.
  __device__ __forceinline__ void merge_from(const float* as, const int* ai, int na,
                                             const float* bs, const int* bi, int nb) {
    int a = 0, b = 0;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (a < na || b < nb) {
        const float sa = as[a], sb = bs[b];
        const int ia = ai[a], ib = bi[b];
        const bool take_a = better(sa, ia, sb, ib);
        s[p] = take_a ? sa : sb;
        i[p] = take_a ? ia : ib;
        a += take_a;
        b += !take_a;
      } else {
        s[p] = -INFINITY;
        i[p] = kNoIdx;
      }
    }
    n = min(na + nb, K);
  }
};

// Writes the first k entries of a finished list in the public encoding.
template <int K>
__device__ __forceinline__ void write_final(const TopK<K>& top, int k, float* out_s, int* out_i) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    if (p < k) {
      float s = top.s[p];
      int i = top.i[p];
      if (i == kNoIdx) {
        s = kNegInf;
        i = -1;
      } else if (s <= kNegInf * 0.5f) {
        i = -1;
      }
      out_s[p] = s;
      out_i[p] = i;
    }
  }
}

// One thread per (unit, query) merges its S sorted raw partial lists
// [W, S, TQ, k] into the final [W, TQ, k].
template <int K>
__global__ void merge_partials_kernel(const float* __restrict__ part_s,
                                      const int* __restrict__ part_i, float* __restrict__ out_s,
                                      int* __restrict__ out_i, int W, int S, int TQ, int k) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)W * TQ) return;
  const int w = (int)(t / TQ), qi = (int)(t - (long)w * TQ);
  TopK<K> top;
  top.init();
  for (int s = 0; s < S; ++s) {
    const size_t base = (((size_t)w * S + s) * TQ + qi) * k;
    top.push_sorted(part_s + base, part_i + base, k);
  }
  const size_t ob = ((size_t)w * TQ + qi) * k;
  write_final<K>(top, k, out_s + ob, out_i + ob);
}

template <int K>
cudaError_t launch_merge_partials(const void* part_s, const void* part_i, void* out_s, void* out_i,
                                  int W, int S, int TQ, int k, cudaStream_t stream) {
  const long n = (long)W * TQ;
  const int threads = 128;
  merge_partials_kernel<K><<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), W, S, TQ, k);
  return cudaGetLastError();
}

// Opt a kernel into more than 48 KB of dynamic shared memory where it needs it.
template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

}  // namespace hqi

// K bound for a runtime k: 8, 16, 32 or 64 (the wrappers reject k > 64).
#define HQI_DISPATCH_K(k, BODY)      \
  if ((k) <= 8) {                    \
    constexpr int KB = 8;            \
    BODY;                            \
  } else if ((k) <= 16) {            \
    constexpr int KB = 16;           \
    BODY;                            \
  } else if ((k) <= 32) {            \
    constexpr int KB = 32;           \
    BODY;                            \
  } else {                           \
    constexpr int KB = 64;           \
    BODY;                            \
  }

// Every library exports <name>_error_string(err): cudaGetErrorString for the
// codes its entry points return (0 = launched).
#define HQI_ERROR_STRING_ENTRY(fn) \
  extern "C" const char* fn(int err) { return cudaGetErrorString((cudaError_t)err); }
