// 64-bit selection keys, warp bitonic networks, the warp-queue select and
// the merge-path co-rank, shared by topk_select.cu (B4), fused_scan.cu (B1)
// and merge_topk.cu (B2, B3).
//
// A (d2, id) pair is one unsigned 64-bit key: the f32 distance's bits mapped
// to an order-preserving u32 in the high word, the i32 id with its sign bit
// flipped in the low word.  Unsigned comparison of two keys is then the
// lexicographic (d2, id) order of the reference's selection rounds
// (repro/kernels/refine.py:56-88) for every d2 but NaN.  The rounds find
// -0 and +0 equal and take the lower id first, so -0 maps to +0's key, and
// a zero d2 leaves as +0 (the rounds' row minimum of the two zeros may be
// either; they compare equal).
// The column, the rounds' third key, is not in the key: two entries with
// equal keys are exact (d2, id) duplicates, which give the same output
// pair whichever comes first, so any order of them gives the same bits.
// A multiset selection or merge that keeps every duplicate is enough.
//
// kNoKey, above every entry's key, stands for "no entry".  Every key whose
// d2 is +inf (or a NaN payload above it) and kNoKey leave as (inf, -1); a
// -inf d2 leaves with id -1 as well, as masked_argmin_rounds writes it.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "warp_select.cuh"

namespace {

using Key = unsigned long long;
constexpr Key kNoKey = ~0ull;
constexpr unsigned kInfBits = 0xff800000u;  // order_bits(+inf)

__device__ __forceinline__ unsigned order_bits(float d) {
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;  // -0 orders as +0
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

__device__ __forceinline__ Key make_key(float d, int id) {
  return (static_cast<Key>(order_bits(d)) << 32) |
         (static_cast<unsigned>(id) ^ 0x80000000u);
}

// A list entry's key as the merges stage it: +inf keys all equal, so a
// list padded with (inf, id) for any id is still ascending.
__device__ __forceinline__ Key run_key(float d, int id) {
  return make_key(d, isinf(d) && d > 0.f ? -1 : id);
}

// The pair a key stands for, as the output row holds it.
__device__ __forceinline__ void key_pair(Key key, float& d, int& id) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  if (hi >= kInfBits) {
    d = CUDART_INF_F;
    id = -1;
    return;
  }
  d = __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
  id = isinf(d) ? -1 : static_cast<int>(static_cast<unsigned>(key) ^
                                        0x80000000u);
}

// x's pair keeps o where o is the smaller (keep_min) or the larger key.
// Equal keys are the same value, so either choice keeps it.
__device__ __forceinline__ Key keep(Key x, Key o, bool keep_min) {
  return ((o < x) == keep_min) ? o : x;
}

// ---- Warp bitonic networks over N keys a lane, register-major: element
// e = 32 * r + lane sits in register r of lane `lane`.  A stage
// compare-exchanges every e with e ^ J, the lower index taking the smaller
// key where e's block of S ascends ((e & S) == 0).  Strides J below 32
// exchange across lanes by shuffle; strides of 32 and more swap registers
// inside a lane.  J and S are template arguments, so every index is known
// when compiled and the queue stays in registers.
template <int N, int J, int S>
__device__ __forceinline__ void cx_stage(Key (&q)[N], int lane) {
  if constexpr (J >= 32) {
    constexpr int kRj = J / 32;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if ((r & kRj) == 0) {
        const Key a = q[r], b = q[r + kRj];
        const bool asc = ((32 * r) & S) == 0;
        q[r] = keep(a, b, asc);
        q[r + kRj] = keep(b, a, !asc);
      }
    }
  } else {
    const bool lower = (lane & J) == 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const Key o = __shfl_xor_sync(0xffffffffu, q[r], J);
      bool asc;
      if constexpr (S >= 32) {
        asc = ((32 * r) & S) == 0;
      } else {
        asc = (lane & S) == 0;
      }
      q[r] = keep(q[r], o, lower == asc);
    }
  }
}

// The stages of strides J, J / 2, ..., 1.
template <int N, int J, int S>
__device__ __forceinline__ void cx_stages(Key (&q)[N], int lane) {
  cx_stage<N, J, S>(q, lane);
  if constexpr (J > 1) cx_stages<N, J / 2, S>(q, lane);
}

// Sorts the warp's 32 * N keys ascending: blocks of S = 2, 4, ..., 32 * N.
template <int N, int S = 2>
__device__ __forceinline__ void warp_sort(Key (&q)[N], int lane) {
  cx_stages<N, S / 2, S>(q, lane);
  if constexpr (S < 32 * N) warp_sort<N, 2 * S>(q, lane);
}

// q: 32 * N keys, ascending.  y: 32 keys, one a lane, ascending.  Leaves
// in q the 32 * N smallest of both, ascending.  The smallest W of two
// ascending runs of W are min(q[i], y'[W - 1 - i]) (y' is y padded with
// kNoKey, so only q's last register meets y, reversed), a bitonic run that
// the half-cleaners (strides W / 2 to 1, all ascending) then sort.
template <int N>
__device__ __forceinline__ void warp_merge32(Key (&q)[N], Key y, int lane) {
  q[N - 1] = keep(q[N - 1], __shfl_xor_sync(0xffffffffu, y, 31), true);
  cx_stages<N, 16 * N, 64 * N>(q, lane);
}

// Element e of the warp's register-major keys, broadcast to every lane.
// Masks, not selects, pick the register, so that it is not read as an
// array index (which would put the queue in local memory).
template <int N>
__device__ __forceinline__ Key warp_key_at(const Key (&q)[N], int e) {
  Key v = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    v |= q[r] & (0ull - static_cast<Key>(r == e / 32));
  }
  return __shfl_sync(0xffffffffu, v, e % 32);
}

// ---- The warp-queue select (WarpSelect; Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs", 2017, section 4) of one
// warp's row of c columns: leaves in q the 32 * N smallest keys of the
// row, ascending, register-major (kNoKey past the row's end).
// - The first 32 * N columns fill the queue, and one warp bitonic sort
//   orders them.
// - The rest of the row streams in coalesced 32-wide slabs, kSlabs slabs
//   asked for before any is used.  The queue's min(k, 32 * N)-th key is a
//   threshold held by every lane; a key enters only if it is below it.  An
//   equal key is an exact duplicate of a kept pair, so dropping it changes
//   no output.
// - Entrants wait in the warp's ring of kRing keys in shared memory, filled
//   in slab order through a ballot prefix, until 32 of them are there.  A
//   flush bitonic-sorts those 32 and merges them into the queue
//   (warp_merge32), then refreshes the threshold; the last flush follows
//   the last slab.
// key_at(j), for 0 <= j < c, is column j's key; the lanes ask for
// neighbouring columns together, so its loads coalesce.
constexpr int kSlabs = 4;
constexpr int kRing = 64;

template <int N, class KeyAt>
__device__ __forceinline__ void warp_queue_select(KeyAt&& key_at, int c,
                                                  int k, Key* ring, int lane,
                                                  Key (&q)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int j = kWarp * r + lane;
    q[r] = j < c ? key_at(j) : kNoKey;
  }
  warp_sort<N>(q, lane);
  const int kth = min(k, kWarp * N) - 1;
  Key thr = warp_key_at<N>(q, kth);

  int held = 0;  // keys in the ring
  int head = 0;  // the ring's first key
  for (int base = kWarp * N; base < c; base += kWarp * kSlabs) {
    Key x[kSlabs];
#pragma unroll
    for (int u = 0; u < kSlabs; ++u) {
      const int j = base + kWarp * u + lane;
      x[u] = j < c ? key_at(j) : kNoKey;
    }
#pragma unroll
    for (int u = 0; u < kSlabs; ++u) {
      const bool take = x[u] < thr;
      const unsigned m = __ballot_sync(kFull, take);
      if (m == 0) continue;
      if (take) {
        const int at = head + held + __popc(m & ((1u << lane) - 1u));
        ring[at & (kRing - 1)] = x[u];
      }
      held += __popc(m);
      if (held < kWarp) continue;
      __syncwarp();
      Key col[1] = {ring[(head + lane) & (kRing - 1)]};
      __syncwarp();  // read before the next slab may refill the slot
      head = (head + kWarp) & (kRing - 1);
      held -= kWarp;
      warp_sort<1>(col, lane);
      warp_merge32<N>(q, col[0], lane);
      thr = warp_key_at<N>(q, kth);
    }
  }
  if (held > 0) {  // the last flush
    __syncwarp();
    Key col[1] = {lane < held ? ring[(head + lane) & (kRing - 1)] : kNoKey};
    warp_sort<1>(col, lane);
    warp_merge32<N>(q, col[0], lane);
  }
}

// The row's k output pairs from the queue: lane L writes columns L, L + 32,
// ... (coalesced), (inf, -1) past the queue and wherever the key's d2 is
// +inf.
template <int N>
__device__ __forceinline__ void store_queue(const Key (&q)[N], int k,
                                            int lane, float* out_d,
                                            int* out_i) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int j = kWarp * r + lane;
    if (j < k) key_pair(q[r], out_d[j], out_i[j]);
  }
  for (int j = kWarp * N + lane; j < k; j += kWarp) {
    out_d[j] = CUDART_INF_F;
    out_i[j] = -1;
  }
}

// ---- Merge path over two ascending runs in shared memory.
//
// Element j (j < la + lb) of the merge of a[0, la) and b[0, lb), where a's
// entry goes first on equal keys (a holds the lower columns): the co-rank
// i, the number of a's entries among the first j, is the least i with
// b[j - i - 1] < a[i], found by binary search in log2(min(j, la) + 1)
// steps.
__device__ __forceinline__ Key merged_at(const Key* a, int la, const Key* b,
                                         int lb, int j) {
  int lo = max(0, j - lb);
  int hi = min(j, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[j - mid - 1] < a[mid]) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (lo >= la) return b[j - lo];
  if (j - lo >= lb) return a[lo];
  const Key x = a[lo], y = b[j - lo];
  return y < x ? y : x;
}

}  // namespace
