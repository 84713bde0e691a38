// Per-row top-k smallest for Hopper: (Q, C) distances + ids -> (Q, k).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_select.py::topk_select
// (pl.pallas_call at topk_select.py:49): k rounds of masked row argmin,
// ascending (d2, id), lowest id on distance ties, then the lowest column,
// (inf, -1) once only +inf is left (repro/kernels/refine.py:56-88).  The
// order is total and the output holds only (d2, id), so any exact selection
// over select_keys.cuh's 64-bit (d2, id) keys gives the same bits.
//
// Templates, picked from C and k only; the C entry point reports which one
// ran (Route):
// - queue: min(k, C) <= 256 and C <= 2048.  WarpSelect (Johnson, Douze and
//   Jegou, "Billion-scale similarity search with GPUs", 2017, section 4):
//   one warp a row, 8 rows a block, through select_keys.cuh's
//   warp_queue_select (a warp queue of the best W = 32 * N keys, W the
//   first of 32, 64, 128, 256 at or above min(k, C), fed by 32-wide slabs
//   through a threshold and a shared ring); fused_scan.cu (B1) runs the
//   same queue.
// - radix: every other shape.  One block a row, a radix select of the
//   row's keys (topk_radix_kernel): each pass histograms the next digit of
//   the keys that share the decided prefix (up to 8 bits, in a 256-bin
//   shared histogram; d2's digits first, the id's only for the entries on
//   the k-th distance) and finds the bin of rank k.  It stops once that
//   bin holds no more keys than are still needed, or the key is whole.  A
//   pass also takes the live keys' least and greatest word: where they all
//   fall in one bin, the prefix takes every bit they share, so rows of one
//   distance or of equal ids spend no pass on their shared digits.  Then
//   one more scan gathers the keys under the k-th (ids read for these
//   only), compacted by a warp ballot and one shared counter, with the k-th
//   key written as many times as ranks are left (exact duplicates give the
//   same pair); the gathered keys are sorted and stored through key_pair.
//   Where the row's d2 and the k keys fit in the opt-in shared memory (C up
//   to about 57,000 at k = 32 on an H100) the row is staged once by 1-D
//   bulk asynchronous copies (cp.async.bulk, in chunks completed on
//   mbarriers), the first pass's histogram running on each chunk as it
//   lands; past that, every pass reads d2 from global memory.
// - global: where even the k gathered keys do not fit in shared memory
//   (min(k, C) beyond about 28,000), the block rounds over global memory
//   (block_select.cuh's launch_select_wide, which B2 and B3 share).
//
// NaN rows, in closed form from how the plain version's rounds behave: a
// NaN makes the row minimum NaN, no entry ties with it, so each round
// emits (NaN, INT_MAX) and masks column 0.  A row whose only NaN is column
// 0 gives (NaN, INT_MAX), then the k - 1 smallest of columns 1 to C - 1;
// any other NaN row gives (NaN, INT_MAX) k times.  The radix select marks
// NaN entries in its first pass (one __syncthreads_or) and keeps them out
// of its keys; the queue finds them from the keys it builds anyway (a
// positive NaN's key is above +inf's, a negative NaN's below -inf's, so
// it is the queue's first).
//
// Bound on an H100: memory.  The function needs each row's d2 once
// (C * 4 bytes), the winners' ids (k * 4) and the output (k * 8); the
// queue also reads every id.  The radix passes after the first scan the
// staged row in shared memory, 4 columns a lane a load, and skip a warp's
// 128 columns where none is live: their cost is instructions (a float
// range compare a column; a match.any and one shared atomic for each
// distinct bin of a warp's live entries) and two block barriers a pass.
// The sort of the k gathered keys is one warp's register network where
// k <= 32, else a bitonic network of log2(P) (log2(P) + 1) / 2 barriered
// stages, P the power of two at or above k.  Block size: from the
// occupancy API at the launch's shared memory, the most threads resident
// on an SM, then the most rows (the smaller block); that many blocks on
// every SM, each walking rows with that stride.
#include <cstdint>

#include "block_select.cuh"
#include "select_keys.cuh"

namespace {

constexpr unsigned kNegInfBits = 0x007fffffu;  // order_bits(-inf)

template <int N>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock, N <= 2 ? 8 : 4)
topk_queue_kernel(const float* __restrict__ d2, const int* __restrict__ ids,
                  float* __restrict__ out_d, int* __restrict__ out_i, int q,
                  int c, int k) {
  __shared__ Key ring[kRowsPerBlock][kRing];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  const float* drow = d2 + static_cast<size_t>(row) * c;
  const int* irow = ids + static_cast<size_t>(row) * c;
  Key wq[N];  // the warp queue
  unsigned top = 0;  // the greatest key's high word: above +inf's, a NaN
  warp_queue_select<N>(
      [&](int j) {
        const Key key = make_key(drow[j], irow[j]);
        top = max(top, static_cast<unsigned>(key >> 32));
        return key;
      },
      c, k, ring[warp], lane, wq);
  // A positive NaN's key sorts above every other (top), a negative NaN's
  // below (the queue's first).
  const bool nan = __reduce_max_sync(kFull, top) > kInfBits ||
                   (warp_key_at<N>(wq, 0) >> 32) < kNegInfBits;
  int off = 0;  // output columns before the queue's
  if (nan) {  // in closed form (see the radix template)
    bool rest = drow[0] == drow[0];  // a NaN past column 0
    for (int j = 1 + lane; j < c; j += kWarp) rest |= drow[j] != drow[j];
    if (__any_sync(kFull, rest)) {
      off = k;  // (NaN, INT_MAX) in every round
    } else {
      // one NaN round, then columns 1 to C - 1: column 0's key is the
      // queue's first where negative (overwritten), else last if at all
      off = __float_as_uint(drow[0]) >> 31 ? 0 : 1;
    }
    for (int j = lane; j < max(off, 1); j += kWarp) {
      out_d[static_cast<size_t>(row) * k + j] = CUDART_NAN_F;
      out_i[static_cast<size_t>(row) * k + j] = INT_MAX;
    }
  }
  const size_t orow = static_cast<size_t>(row) * k + off;
  if (off < k) store_queue<N>(wq, k - off, lane, out_d + orow, out_i + orow);
  if (nan && off == 0 && lane == 0) {
    out_d[orow] = CUDART_NAN_F;
    out_i[orow] = INT_MAX;
  }
}

// ---- The radix template.

constexpr int kBins = 256;
constexpr int kMaxChunks = 16;  // mbarriers: bulk copies in flight a row
constexpr int kMinChunkCols = 1024;  // 4 KB, the smallest chunk
constexpr int kMaxThreads = 1024;

struct RadixScratch {
  unsigned long long bar[kMaxChunks];  // one mbarrier a chunk
  // this pass's histogram and the least and greatest live word, and the
  // next pass's, reset
  int hist[2][kBins];
  unsigned lo[2], hi[2];
  Key prefix;   // the k-th key's top `depth` bits, as decided
  int depth;    // 64: prefix is the whole k-th key
  int needed;   // ranks still to fill from the keys under the prefix
  int done;     // the keys under the prefix are all winners
  int count;    // keys gathered
};

// Bytes of the staged row: C floats and up to 3 more, so that the row keeps
// its global address's alignment mod 16 (the bulk copies need 16-byte
// aligned addresses on both sides).
__host__ __device__ __forceinline__ size_t staged_bytes(long long c) {
  return (static_cast<size_t>(c + 4) * sizeof(float) + 15) & ~size_t{15};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from global to shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// A row's columns in groups of 4 neighbours, one group a lane and 128
// columns a warp at a time.  STAGED: the row sits in shared memory with
// column x at src[x + shift] (src 16-byte aligned), and a group is one
// 16-byte load; else src is the row in global memory (shift 0), read by 4
// scalar loads.  Calls f(j, on, d) for the group of columns j to j + 3 (on:
// inside [lo, hi) and `keep(d)` holds), every lane together, and skips
// the warp's step where no lane has a column on.  blockDim.x is a multiple
// of 32.
template <bool STAGED, class Keep, class F>
__device__ __forceinline__ void row_groups(const float* src, int shift,
                                           int lo, int hi, Keep&& keep,
                                           F&& f) {
  const int lane = threadIdx.x % kWarp;
  const int end = (hi + shift + 3) >> 2;
  for (int w = ((lo + shift) >> 2) + static_cast<int>(threadIdx.x) - lane;
       w < end; w += blockDim.x) {
    const int v = w + lane;
    const int j = 4 * v - shift;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool on[4] = {false, false, false, false};
    bool any = false;
    if (v < end) {
      if constexpr (STAGED) {
        const float4 x = reinterpret_cast<const float4*>(src)[v];
        d[0] = x.x;
        d[1] = x.y;
        d[2] = x.z;
        d[3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = j + u >= lo && j + u < hi;
        if constexpr (!STAGED) {
          if (in) d[u] = src[j + u];
        }
        on[u] = in && keep(d[u]);
        any |= on[u];
      }
    }
    if (__any_sync(kFull, any)) f(j, on, d);
  }
}

// Counts each lane's bin where `on`, one shared atomic for each distinct bin
// of the warp (its peers by match.any).  Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(int* hist, bool on, unsigned bin) {
  const unsigned live = __ballot_sync(kFull, on);
  if (!on) return;
  const unsigned peers = __match_any_sync(live, bin);
  if (static_cast<int>(threadIdx.x % kWarp) == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], __popc(peers));
  }
}

// Folds each lane's least and greatest live word (the identities 0xffffffff
// and 0 where it has none) into *lo and *hi, one shared atomic each a warp.
// Every lane of the warp calls it, once a pass.
__device__ __forceinline__ void range_add(unsigned* lo, unsigned* hi,
                                          unsigned wlo, unsigned whi) {
  wlo = __reduce_min_sync(kFull, wlo);
  whi = __reduce_max_sync(kFull, whi);
  if (threadIdx.x % kWarp == 0) {
    atomicMin(lo, wlo);
    atomicMax(hi, whi);
  }
}

// Appends `key` where `take` at the next free slots of keys (one shared
// counter, one atomic a warp).  Every lane of the warp calls it.
__device__ __forceinline__ void gather_key(Key* keys, int* count, bool take,
                                           Key key) {
  const unsigned m = __ballot_sync(kFull, take);
  if (m == 0) return;
  const int lane = threadIdx.x % kWarp;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFull, base, 0);
  if (take) keys[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// The digit a pass histograms: up to 8 bits below the `depth` decided
// ones, never across the key's two words (d2's, the id's).
__device__ __forceinline__ int digit_bits(int depth) {
  return min(8, (depth < 32 ? 32 : 64) - depth);
}

// Warp 0, after a pass: the bin of hist holding the needed-th smallest live
// key (bins ascend with the key), its digit appended to the prefix; writes
// the new prefix, its depth, the ranks still needed under it, and whether
// its keys are all winners or the whole k-th key is known (depth 64).
// Lane L holds bins 8 L to 8 L + 7.  Where the bin holds every live key,
// the live word's least and greatest value (wlo, whi: d2's order bits below
// depth 32, the id's word above) share more top bits than the digit: the
// prefix takes them all, and no pass is spent on digits every live key
// shares.  Once the prefix leaves only +inf (or only -inf) among non-NaN
// d2, every key under it gives the same output pair, so the prefix becomes
// that key (id bits 0) at depth 64.
__device__ __forceinline__ void radix_decide(RadixScratch& s, const int* hist,
                                             unsigned wlo, unsigned whi,
                                             Key prefix, int depth,
                                             int needed) {
  const int lane = threadIdx.x;
  int h[8];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = hist[8 * lane + i];
    sum += h[i];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const int live = __shfl_sync(kFull, incl, kWarp - 1);
  const int excl = incl - sum;
  const unsigned hit = __ballot_sync(kFull, excl < needed && needed <= incl);
  if (lane != __ffs(hit) - 1) return;
  int bin = -1;
  int below = 0;
  int count = 0;
  int cum = excl;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (bin < 0 && cum + h[i] >= needed) {
      bin = 8 * lane + i;
      below = cum;
      count = h[i];
    }
    cum += h[i];
  }
  const int bits = digit_bits(depth);
  prefix |= static_cast<Key>(bin) << (64 - depth - bits);
  depth += bits;
  needed -= below;
  if (count == live) {  // every live key in the bin
    const bool high = depth <= 32;  // the live word is d2's
    const int n = __clz(wlo ^ whi);  // top bits every live word shares
    if ((high ? 0 : 32) + n > depth) {
      const unsigned w = n >= 32 ? wlo : wlo & ~(0xffffffffu >> n);
      prefix = high ? static_cast<Key>(w) << 32
                    : (prefix & 0xffffffff00000000ull) | w;
      depth = (high ? 0 : 32) + n;
    }
  }
  bool done = count == needed || depth == 64;
  if (!done && depth <= 32) {
    const unsigned lo = static_cast<unsigned>(prefix >> 32);
    const unsigned hi = lo | (depth < 32 ? 0xffffffffu >> depth : 0u);
    if (lo >= kInfBits || hi <= kNegInfBits) {
      prefix = static_cast<Key>(lo >= kInfBits ? kInfBits : kNegInfBits)
               << 32;
      depth = 64;
      done = true;
    }
  }
  s.prefix = prefix;
  s.depth = depth;
  s.needed = needed;
  s.done = done;
}

// The d2 of order bits o (o not a NaN's), as key_pair reads a key's high
// word; o of -0 (0x7fffffff, which order_bits never gives) reads as the
// negative value next to it, so that `d <= from_order(o)` keeps the zeros
// out.
__device__ __forceinline__ float from_order(unsigned o) {
  if (o == 0x7fffffffu) o = 0x7ffffffeu;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Sorts keys[0, n) ascending in shared memory: the bitonic network in its
// all-ascending form (each merge first compares i with its mirror in the
// block), over P = pow2_at_least(n) with keys[n, P) taken as kNoKey, so
// every comparator that reaches past n is skipped.  Every thread of the
// block calls it after the keys are visible; it ends on a barrier.
__device__ void block_sort_n(Key* keys, int n) {
  const int p = static_cast<int>(pow2_at_least(n));
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        // the first stage of a merge pairs lo with its mirror in the block
        const int hi = stride == size >> 1
                           ? (lo | (size - 1)) - (lo & (size - 1))
                           : lo + stride;
        if (hi < n) {
          const Key a = keys[lo];
          const Key b = keys[hi];
          if (b < a) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One row of the radix template.  src: the row's d2 (staged or global);
// keys: min(k, C) slots in shared memory.
template <bool STAGED>
__device__ __forceinline__ void radix_row(const float* __restrict__ grow,
                                          const int* __restrict__ irow,
                                          float* od, int* oi, int c, int k,
                                          unsigned& phases,
                                          unsigned char* smem,
                                          RadixScratch& s) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  Key* keys = reinterpret_cast<Key*>(smem + (STAGED ? staged_bytes(c) : 0));
  for (int b = tid; b < 2 * kBins; b += nt) s.hist[b / kBins][b % kBins] = 0;
  if (tid < 2) {
    s.lo[tid] = 0xffffffffu;
    s.hi[tid] = 0u;
  }
  if (tid == 0) s.count = 0;
  bool nan_rest = false;  // a NaN past column 0
  // the first pass: the top byte of each non-NaN entry's key
  const auto all = [](float) { return true; };
  unsigned wlo = 0xffffffffu;  // this thread's least and greatest live word
  unsigned whi = 0u;
  const auto first = [&](int j, const bool (&on)[4], const float (&d)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool nan = on[u] && d[u] != d[u];
      nan_rest |= nan && j + u > 0;
      const unsigned hi = order_bits(d[u]);
      if (on[u] && !nan) {
        wlo = min(wlo, hi);
        whi = max(whi, hi);
      }
      hist_add(s.hist[0], on[u] && !nan, hi >> 24);
    }
  };
  const float* src = grow;  // row_groups' view of the row
  int shift = 0;
  if constexpr (STAGED) {
    shift = static_cast<int>((reinterpret_cast<uintptr_t>(grow) & 15u) >> 2);
    float* sd = reinterpret_cast<float*>(smem) + shift;
    const int head = min(c, (4 - shift) & 3);  // columns before 16 B
    const int body = (c - head) & ~3;          // the bulk-copied columns
    const int per = max(kMinChunkCols,
                        ((body + kMaxChunks - 1) / kMaxChunks + 3) & ~3);
    const int chunks = (body + per - 1) / per;
    if (tid == 0) {
      // the last row's reads of sd come before these copies' writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int ch = 0; ch < chunks; ++ch) {
        const int lo = head + ch * per;
        bulk_load(sd + lo, grow + lo,
                  static_cast<unsigned>(min(per, body - ch * per)) * 4u,
                  &s.bar[ch]);
      }
    }
    __syncthreads();  // the histograms are zeroed
    for (int j = tid; j < c - body; j += nt) {  // the head and tail columns
      const int col = j < head ? j : body + j;
      const float d = grow[col];
      sd[col] = d;
      if (d != d) {
        nan_rest |= col > 0;
      } else {
        atomicAdd(&s.hist[0][order_bits(d) >> 24], 1);
        wlo = min(wlo, order_bits(d));
        whi = max(whi, order_bits(d));
      }
    }
    src = reinterpret_cast<const float*>(smem);
    for (int ch = 0; ch < chunks; ++ch) {
      bar_wait(&s.bar[ch], (phases >> ch) & 1u);
      phases ^= 1u << ch;
      const int lo = head + ch * per;
      row_groups<true>(src, shift, lo, lo + min(per, body - ch * per), all,
                       first);
    }
  } else {
    __syncthreads();  // the histograms are zeroed
    row_groups<false>(src, 0, 0, c, all, first);
  }
  range_add(&s.lo[0], &s.hi[0], wlo, whi);
  if (__syncthreads_or(nan_rest)) {  // (NaN, INT_MAX) in every round
    for (int r = tid; r < k; r += nt) {
      od[r] = CUDART_NAN_F;
      oi[r] = INT_MAX;
    }
    return;
  }
  int c0 = 0;  // the first column selected from
  int kk = k;  // the ranks selected
  if (src[shift] != src[shift]) {  // one NaN round, then columns 1 to C - 1
    if (tid == 0) {
      od[0] = CUDART_NAN_F;
      oi[0] = INT_MAX;
    }
    c0 = 1;
    kk = k - 1;
    ++od;
    ++oi;
  }
  const int n = c - c0;
  const int m = min(kk, n);  // keys gathered
  Key prefix = 0;
  int depth = 0;  // bits of the k-th key decided
  int needed = m;
  bool done = m >= n || m <= 0;  // every entry a winner, or none wanted
  // Order bits in [lo, hi] (not a NaN's) are d2 in [flo, fhi]; the filters
  // compare d2 as floats (-0 == +0, as order_bits has it).
  float flo = -CUDART_INF_F;
  float fhi = CUDART_INF_F;
  for (int p = 0; !done; ++p) {
    if (p > 0) {  // this pass's histogram over the keys under the prefix
      int* hist = s.hist[p & 1];
      for (int b = tid; b < kBins; b += nt) s.hist[(p + 1) & 1][b] = 0;
      if (tid == 0) {
        s.lo[(p + 1) & 1] = 0xffffffffu;
        s.hi[(p + 1) & 1] = 0u;
      }
      const int bits = digit_bits(depth);
      const int at = 64 - depth - bits;  // the digit's lowest bit
      const unsigned mask = (1u << bits) - 1u;
      const auto inside = [&](float d) { return flo <= d && d <= fhi; };
      wlo = 0xffffffffu;
      whi = 0u;
      row_groups<STAGED>(src, shift, c0, c, inside, [&](int j,
                                                       const bool (&on)[4],
                                                       const float (&d)[4]) {
        Key key[4];
        if (depth >= 32) {  // the ids of the entries on the k-th distance
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            key[u] = on[u] ? make_key(d[u], irow[j + u]) : 0;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bool live = on[u];
          unsigned bin;
          unsigned word;
          if (depth < 32) {  // a digit of d2
            word = order_bits(d[u]);
            bin = (word >> (at - 32)) & mask;
          } else {  // a digit of the id
            live = live &&
                   (key[u] >> (64 - depth)) == (prefix >> (64 - depth));
            word = static_cast<unsigned>(key[u]);
            bin = static_cast<unsigned>(key[u] >> at) & mask;
          }
          if (live) {
            wlo = min(wlo, word);
            whi = max(whi, word);
          }
          hist_add(hist, live, bin);
        }
      });
      range_add(&s.lo[p & 1], &s.hi[p & 1], wlo, whi);
      __syncthreads();
    }
    if (tid < kWarp) {
      radix_decide(s, s.hist[p & 1], s.lo[p & 1], s.hi[p & 1], prefix, depth,
                   needed);
    }
    __syncthreads();
    prefix = s.prefix;
    depth = s.depth;
    needed = s.needed;
    done = s.done;
    const unsigned lo = static_cast<unsigned>(prefix >> 32);
    flo = lo <= kNegInfBits ? -CUDART_INF_F : from_order(lo);
    fhi = depth >= 32 ? from_order(lo)
                      : (lo | 0xffffffffu >> depth) >= kInfBits
                            ? CUDART_INF_F
                            : from_order(lo | 0xffffffffu >> depth);
  }
  if (m > 0) {
    // the gather: every key under the prefix (depth < 64), or every key
    // below the whole k-th key and then `needed` copies of it; ids are
    // read only for the keys taken and those on the k-th distance
    const auto below = [&](float d) { return d <= fhi; };  // depth 0: +inf
    row_groups<STAGED>(src, shift, c0, c, below, [&](int j,
                                                     const bool (&on)[4],
                                                     const float (&d)[4]) {
      Key key[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        key[u] = on[u] ? make_key(d[u], irow[j + u]) : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bool take = on[u];
        if (depth > 32 && d[u] == fhi) {
          take = take && (depth < 64
                              ? (key[u] >> (64 - depth)) <=
                                    (prefix >> (64 - depth))
                              : key[u] < prefix);
        }
        gather_key(keys, &s.count, take, key[u]);
      }
    });
    if (depth == 64) {
      for (int r = tid; r < needed; r += nt) keys[m - needed + r] = prefix;
    }
    __syncthreads();
    if (m <= kWarp) {
      if (tid < kWarp) {
        Key x[1] = {tid < m ? keys[tid] : kNoKey};
        warp_sort<1>(x, tid);
        if (tid < m) keys[tid] = x[0];
      }
      __syncthreads();
    } else {
      block_sort_n(keys, m);
    }
  }
  for (int r = tid; r < kk; r += nt) {
    if (r < m) {
      key_pair(keys[r], od[r], oi[r]);
    } else {
      od[r] = CUDART_INF_F;
      oi[r] = -1;
    }
  }
}

// One block walks rows blockIdx.x, + gridDim.x, ...; the dynamic shared
// memory holds the staged row (STAGED) and then min(k, C) keys.
template <bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, 1)
topk_radix_kernel(const float* __restrict__ d2, const int* __restrict__ ids,
                  float* __restrict__ out_d, int* __restrict__ out_i, int q,
                  int c, int k) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  __shared__ RadixScratch s;
  if constexpr (STAGED) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kMaxChunks; ++i) bar_init(&s.bar[i]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  unsigned phases = 0;  // each mbarrier's phase parity
  for (int row = blockIdx.x; row < q; row += gridDim.x) {
    const size_t r = static_cast<size_t>(row);
    radix_row<STAGED>(d2 + r * c, ids + r * c, out_d + r * k, out_i + r * k,
                      c, k, phases, radix_smem, s);
    __syncthreads();  // this row's readers are done before the next row's
  }
}

struct Args {
  const float* d2;
  const int* ids;
  float* out_d;
  int* out_i;
  int q, c, k;
  cudaStream_t stream;
};

template <int N>
cudaError_t launch_queue(const Args& a) {
  const int blocks = (a.q + kRowsPerBlock - 1) / kRowsPerBlock;
  topk_queue_kernel<N><<<blocks, kWarp * kRowsPerBlock, 0, a.stream>>>(
      a.d2, a.ids, a.out_d, a.out_i, a.q, a.c, a.k);
  return cudaGetLastError();
}

cudaError_t launch_ladder(const Args& a) {
  const int m = a.k < a.c ? a.k : a.c;
  if (m <= 32) return launch_queue<1>(a);
  if (m <= 64) return launch_queue<2>(a);
  if (m <= 128) return launch_queue<4>(a);
  return launch_queue<8>(a);
}

// The card's opt-in shared memory a block, its SM count and the radix
// kernels' static shared memory, read once a device.
struct Card {
  int optin, sms;
  size_t radix_static;
};

cudaError_t card_of(int& dev, Card& card) {
  static Card cards[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cards[dev].sms == 0) {
    Card got;
    err = cudaDeviceGetAttribute(&got.optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&got.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr[2];
    err = cudaFuncGetAttributes(&attr[0], topk_radix_kernel<true>);
    if (err != cudaSuccess) return err;
    err = cudaFuncGetAttributes(&attr[1], topk_radix_kernel<false>);
    if (err != cudaSuccess) return err;
    got.radix_static = attr[0].sharedSizeBytes > attr[1].sharedSizeBytes
                           ? attr[0].sharedSizeBytes
                           : attr[1].sharedSizeBytes;
    cards[dev] = got;
  }
  card = cards[dev];
  return cudaSuccess;
}

// The radix kernel with `bytes` of dynamic shared memory: the block size
// that keeps the most threads resident on an SM (then the most rows: the
// smaller block), by the occupancy API, and that many blocks on every SM
// (at most one a row).
template <bool STAGED>
cudaError_t launch_radix(const Args& a, int dev, const Card& card,
                         size_t room, size_t bytes) {
  static bool raised[kMaxDevices] = {};
  const auto kernel = topk_radix_kernel<STAGED>;
  cudaError_t err;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(room));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  int threads = 0;
  int resident = 0;  // blocks (rows) resident on an SM
  for (int t = 4 * kWarp; t <= kMaxThreads; t <<= 1) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, t,
                                                        bytes);
    if (err != cudaSuccess) return err;
    if (blocks * t > resident * threads) {
      resident = blocks;
      threads = t;
    }
  }
  if (resident == 0) return cudaErrorInvalidConfiguration;
  const long long grid = static_cast<long long>(resident) * card.sms;
  kernel<<<static_cast<int>(grid < a.q ? grid : a.q), threads, bytes,
           a.stream>>>(a.d2, a.ids, a.out_d, a.out_i, a.q, a.c, a.k);
  return cudaGetLastError();
}

// The templates, as the entry point reports them.
enum Route { kQueue = 0, kRadix = 1, kGlobal = 2 };

// The widest row, and the largest min(k, C), the warp queue takes.
constexpr int kNarrowWidth = kWarp * 64;
constexpr int kQueueMax = kWarp * 8;

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// d2 / ids are (q, c), out (q, k); q > 0; c > 0; k > 0.  *route is set to
// the template that ran: 0 queue, 1 radix, 2 global (the block rounds).
int topk_select_f32(const void* d2, const void* ids, void* out_d, void* out_i,
                    int q, int c, int k, void* stream, int* route) {
  if (q <= 0 || c <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(d2), static_cast<const int*>(ids),
               static_cast<float*>(out_d), static_cast<int*>(out_i), q, c, k,
               static_cast<cudaStream_t>(stream)};
  const int m = k < c ? k : c;
  if (c <= kNarrowWidth && m <= kQueueMax) {
    *route = kQueue;
    return static_cast<int>(launch_ladder(a));
  }
  int dev = 0;
  Card card;
  const cudaError_t err = card_of(dev, card);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t room = static_cast<size_t>(card.optin) - card.radix_static;
  const size_t keys = sizeof(Key) * static_cast<size_t>(m);
  if (staged_bytes(c) + keys <= room) {
    *route = kRadix;
    return static_cast<int>(
        launch_radix<true>(a, dev, card, room, staged_bytes(c) + keys));
  }
  if (keys <= room) {
    *route = kRadix;
    return static_cast<int>(launch_radix<false>(a, dev, card, room, keys));
  }
  *route = kGlobal;
  return static_cast<int>(launch_select_wide(
      a.d2, a.ids, c, a.d2, a.ids, 0, a.out_d, a.out_i, q, k, a.stream));
}

}  // extern "C"
