// Block-wide selection for the wide templates of the port's Hopper kernels.
//
// The narrow templates hold a row in one warp's registers or shared memory
// and stop at fixed widths (B1 k + W <= 512, B2 / B3 a row of 512, B4
// C <= 2048).  Above those widths a kernel hands its row to one thread
// block of kBlockThreads threads, which has no width limit below int32
// indexing:
// - A row is read through a functor, entry(j, d, id) for 0 <= j < n: a
//   load from global memory (B2, B3, B4), or d2 computed from the gathered
//   window (B1).
// - Three modes (wide_plan chooses at launch, from n and k):
//   kSort stages the row in shared memory as select_keys.cuh's 64-bit
//   (d2, id) keys, padded with kNoKey to P, a power of two, and
//   block_sort_keys sorts them (a bitonic network of log2(P) (log2(P) + 1)
//   / 2 barriered stages): the first k keys are the k smallest pairs, the
//   same bits as the rounds (select_keys.cuh: the column order of exact
//   duplicates changes no output); a key cannot hold a NaN, so a row with
//   one takes the rounds.  kRounds stages the row as (d2, id) and runs
//   block_rounds over it; kGlobal, past the card's opt-in shared memory
//   (about 227 KB on an H100), re-reads or recomputes each column on every
//   pass.  The sort wins where k is large beside the row (B1 at k = 512,
//   W = 256: 0.52 ms against the rounds' 4.1 ms at Q = 8192), the rounds
//   where k is small (B4 at C = 8192, k = 32: 2.4 ms against the sort's
//   4.6 ms); NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py.
// - block_rounds runs the k rounds of masked_argmin_rounds
//   (kernels/refine.py): each round takes the row's least (d2, id, column)
//   (d2 compared as floats, so -0 == +0), emits it ((-inf, -1) for -inf),
//   and stops at the first +inf minimum, padding with (inf, -1).  A NaN
//   makes the plain version's minimum NaN: that round emits
//   (NaN, INT_MAX) and masks column 0, so one NaN in column 0 costs one
//   round and any other NaN holds every round.  The rounds select in
//   increasing (d2, id, column) order, so "emitted" is "not above the last
//   pick": no mask is stored, and each warp keeps the least entry above the
//   last pick among its own columns.  A round reduces the 8 warps' entries
//   and only the owning warp rescans its columns.
// - block_refine_radius is the bucket refinement of kernels/refine.py at
//   block level: n_valid, lo and hi (NaN propagating as jnp.min / jnp.max),
//   `iters` rounds of a 32-bin histogram in shared memory, the chosen
//   bucket's edges at fma(sel, width, lo) and + width, the rank below it
//   and its count taken against those edges, then the prune radius
//   fhi + max(fhi - flo, fma(fhi, 1e-6, 1e-30)) (+inf when fewer than k
//   entries are not +inf).
// Every multiply, add and divide is an explicit round-to-nearest intrinsic
// (the build passes --fmad=false), so the bits are the plain version's.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "select_keys.cuh"
#include "warp_select.cuh"

namespace {

constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / kWarp;
constexpr int kBlockBins = 32;

// jnp.maximum / jnp.minimum (and torch's amax / amin) propagate NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

// A block's shared scratch: reductions, the warps' least entries (two
// buffers, so one round reads while the next is written), the histogram.
struct BlockScratch {
  int ired[2][kBlockWarps];
  float fred[2][kBlockWarps];
  float wd[2][kBlockWarps];
  int wi[2][kBlockWarps];
  int wc[2][kBlockWarps];
  int hist[kBlockBins];
};

// A row staged in shared memory.
struct StagedRow {
  const float* d;
  const int* id;
  __device__ __forceinline__ void entry(int j, float& dj, int& ij) const {
    dj = d[j];
    ij = id[j];
  }
};

// Stages columns [0, n) of `row` into sd / si; ends on a block barrier.
template <class Row>
__device__ __forceinline__ StagedRow stage_row(const Row& row, int n,
                                               float* sd, int* si) {
  for (int j = threadIdx.x; j < n; j += kBlockThreads) row.entry(j, sd[j], si[j]);
  __syncthreads();
  return StagedRow{sd, si};
}

// Block sums of two ints; every thread gets both.
__device__ __forceinline__ void block_sum2(int& a, int& b, BlockScratch& s) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int warp = threadIdx.x / kWarp;
  __syncthreads();  // the previous reduction's readers are done
  if (threadIdx.x % kWarp == 0) {
    s.ired[0][warp] = a;
    s.ired[1][warp] = b;
  }
  __syncthreads();
  a = b = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    a += s.ired[0][w];
    b += s.ired[1][w];
  }
}

// Block NaN-propagating min of lo and max of hi; every thread gets both.
__device__ __forceinline__ void block_min_max(float& lo, float& hi,
                                              BlockScratch& s) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    lo = nan_min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = nan_max(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const int warp = threadIdx.x / kWarp;
  __syncthreads();
  if (threadIdx.x % kWarp == 0) {
    s.fred[0][warp] = lo;
    s.fred[1][warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    lo = nan_min(lo, s.fred[0][w]);
    hi = nan_max(hi, s.fred[1][w]);
  }
}

// The least (d, id, column) of the calling warp's columns (j / 32 equal to
// the warp's index mod kBlockWarps) that lies above the last pick (pc < 0:
// no pick yet), in every lane.  A NaN is never less and never above, so it
// never leaves here.
template <class Row>
__device__ __forceinline__ void warp_least(const Row& row, int n, float pd,
                                           int pi, int pc, float& bd,
                                           int& bi, int& bc) {
  const int lane = threadIdx.x % kWarp;
  bd = CUDART_INF_F;
  bi = INT_MAX;
  bc = INT_MAX;
  for (int j = threadIdx.x - threadIdx.x % kWarp + lane; j < n;
       j += kBlockThreads) {
    float d;
    int id;
    row.entry(j, d, id);
    const bool above = pc < 0 || lex_less(pd, pi, pc, d, id, j);
    if (above && lex_less(d, id, j, bd, bi, bc)) {
      bd = d;
      bi = id;
      bc = j;
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    const float od = __shfl_xor_sync(kFull, bd, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    const int oc = __shfl_xor_sync(kFull, bc, o);
    if (lex_less(od, oi, oc, bd, bi, bc)) {
      bd = od;
      bi = oi;
      bc = oc;
    }
  }
}

// k rounds of masked_argmin_rounds over columns [0, n) of `row` (n >= 1),
// written to out_d[0, k) / out_i[0, k).
template <class Row>
__device__ void block_rounds(const Row& row, int n, int k, float* out_d,
                             int* out_i, BlockScratch& s) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int nans = 0;
  int unused = 0;
  for (int j = threadIdx.x; j < n; j += kBlockThreads) {
    float d;
    int id;
    row.entry(j, d, id);
    nans += d != d;
  }
  block_sum2(nans, unused, s);
  int r = 0;
  if (nans > 0) {
    float d0;
    int i0;
    row.entry(0, d0, i0);
    r = (nans == 1 && d0 != d0) ? 1 : k;  // NaN rounds
    for (int j = threadIdx.x; j < r; j += kBlockThreads) {
      out_d[j] = CUDART_NAN_F;
      out_i[j] = INT_MAX;
    }
  }
  if (r < k) {
    float bd;
    int bi, bc;
    warp_least(row, n, 0.0f, 0, -1, bd, bi, bc);
    int buf = 0;
    if (lane == 0) {
      s.wd[0][warp] = bd;
      s.wi[0][warp] = bi;
      s.wc[0][warp] = bc;
    }
    __syncthreads();
    for (; r < k; ++r) {
      float md = s.wd[buf][0];
      int mi = s.wi[buf][0];
      int mc = s.wc[buf][0];
#pragma unroll
      for (int w = 1; w < kBlockWarps; ++w) {
        if (lex_less(s.wd[buf][w], s.wi[buf][w], s.wc[buf][w], md, mi, mc)) {
          md = s.wd[buf][w];
          mi = s.wi[buf][w];
          mc = s.wc[buf][w];
        }
      }
      if (md == CUDART_INF_F) break;  // only +inf left (or nothing)
      if (threadIdx.x == 0) {
        out_d[r] = md;
        out_i[r] = isinf(md) ? -1 : mi;  // -inf leaves with id -1
      }
      if (warp == (mc / kWarp) % kBlockWarps)
        warp_least(row, n, md, mi, mc, bd, bi, bc);
      if (lane == 0) {
        s.wd[buf ^ 1][warp] = bd;
        s.wi[buf ^ 1][warp] = bi;
        s.wc[buf ^ 1][warp] = bc;
      }
      buf ^= 1;
      __syncthreads();
    }
  }
  for (int j = r + threadIdx.x; j < k; j += kBlockThreads) {
    out_d[j] = CUDART_INF_F;
    out_i[j] = -1;
  }
}

// The reference's bin of an entry inside [flo, fhi).
__device__ __forceinline__ int block_bin_of(float x, float flo, float width) {
  float b = floorf(__fdiv_rn(__fsub_rn(x, flo), width));
  b = fminf(fmaxf(b, 0.0f), static_cast<float>(kBlockBins - 1));  // NaN -> 0
  return __float2int_rz(b);
}

struct RefineConsts {
  int iters;
  float hi_mul, hi_add, slop_mul, tiny;
};

// The prune radius of bucket refinement over columns [0, n) of `row`, in
// every thread (see the header).
template <class Row>
__device__ float block_refine_radius(const Row& row, int n, int k,
                                     const RefineConsts& c, BlockScratch& s) {
  const float inf = CUDART_INF_F;
  int n_valid = 0;
  int unused = 0;
  float lo = inf;
  float hi0 = -inf;
  for (int j = threadIdx.x; j < n; j += kBlockThreads) {
    float d;
    int id;
    row.entry(j, d, id);
    const bool fin = !isinf(d);
    n_valid += fin;
    lo = nan_min(lo, d);
    if (fin) hi0 = nan_max(hi0, d);
  }
  block_sum2(n_valid, unused, s);
  block_min_max(lo, hi0, s);
  float flo = lo;
  float fhi = __fmaf_rn(nan_max(hi0, lo), c.hi_mul, c.hi_add);
  int kth = k;
  for (int it = 0; it < c.iters; ++it) {
    const float width = nan_max(
        __fdiv_rn(__fsub_rn(fhi, flo), static_cast<float>(kBlockBins)),
        c.tiny);
    __syncthreads();  // the last round's readers of the histogram are done
    if (threadIdx.x < kBlockBins) s.hist[threadIdx.x] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kBlockThreads) {
      float x;
      int id;
      row.entry(j, x, id);
      if (x >= flo && x < fhi) atomicAdd(&s.hist[block_bin_of(x, flo, width)], 1);
    }
    __syncthreads();
    int sel = 0;
    int cum = 0;
    for (int b = 0; b < kBlockBins; ++b) {
      cum += s.hist[b];
      if (cum >= kth) {
        sel = b;
        break;
      }
    }
    const float new_lo = __fmaf_rn(static_cast<float>(sel), width, flo);
    const float new_hi = __fadd_rn(new_lo, width);
    // The rank below the bucket and the bucket's count, against its edges.
    int below = 0;
    int inside = 0;
    for (int j = threadIdx.x; j < n; j += kBlockThreads) {
      float x;
      int id;
      row.entry(j, x, id);
      below += x >= flo && x < new_lo;
      inside += x >= new_lo && x < new_hi;
    }
    block_sum2(below, inside, s);
    if (below < kth && below + inside >= kth) {
      flo = new_lo;
      fhi = new_hi;
      kth -= below;
    }
  }
  const float slop =
      nan_max(__fsub_rn(fhi, flo), __fmaf_rn(fhi, c.slop_mul, c.tiny));
  return n_valid < k ? inf : __fadd_rn(fhi, slop);
}

// The least power of two >= n (1 for n <= 1).
__host__ __device__ __forceinline__ long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sorts keys[0, p) ascending in shared memory (p a power of two): the
// bitonic network, every thread of the block calling it after the keys are
// written and visible (a barrier); it ends on a barrier.
__device__ void block_sort_keys(Key* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kBlockThreads) {
        const int lo = 2 * stride * (t / stride) + t % stride;
        const Key a = keys[lo];
        const Key b = keys[lo + stride];
        if ((b < a) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The first k of p sorted keys as output pairs ((inf, -1) past p).
__device__ __forceinline__ void store_sorted(const Key* keys, int p, int k,
                                             float* out_d, int* out_i) {
  for (int r = threadIdx.x; r < k; r += kBlockThreads) {
    if (r < p) {
      key_pair(keys[r], out_d[r], out_i[r]);
    } else {
      out_d[r] = CUDART_INF_F;
      out_i[r] = -1;
    }
  }
}

// ---- The wide select kernel of B2, B3 and B4: the k smallest pairs of the
// row a[0, ca) ++ b[0, cb) (cb = 0: one list), as masked_argmin_rounds.
struct TwoLists {
  const float* da;
  const int* ia;
  int ca;
  const float* db;
  const int* ib;
  __device__ __forceinline__ void entry(int j, float& d, int& id) const {
    if (j < ca) {
      d = da[j];
      id = ia[j];
    } else {
      d = db[j - ca];
      id = ib[j - ca];
    }
  }
};

enum class Wide { kSort, kRounds, kGlobal };

// kSort: the row as p = pow2_at_least(n) keys in shared memory, sorted (a
// row holding a NaN takes the rounds over global memory); kRounds: the row
// staged as (d2, id), the rounds over it; kGlobal: the rounds over global
// memory.
template <Wide MODE>
__global__ void __launch_bounds__(kBlockThreads)
select_wide_kernel(const float* __restrict__ da, const int* __restrict__ ia,
                   int ca, const float* __restrict__ db,
                   const int* __restrict__ ib, int cb,
                   float* __restrict__ out_d, int* __restrict__ out_i, int k) {
  extern __shared__ Key wide_keys[];
  __shared__ BlockScratch s;
  const size_t row = blockIdx.x;
  const TwoLists in{da + row * ca, ia + row * ca, ca, db + row * cb,
                    ib + row * cb};
  const int n = ca + cb;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  if constexpr (MODE == Wide::kRounds) {
    float* sd = reinterpret_cast<float*>(wide_keys);
    block_rounds(stage_row(in, n, sd, reinterpret_cast<int*>(sd + n)), n, k,
                 od, oi, s);
  } else if constexpr (MODE == Wide::kSort) {
    const int p = static_cast<int>(pow2_at_least(n));
    bool nan = false;
    for (int j = threadIdx.x; j < p; j += kBlockThreads) {
      Key key = kNoKey;
      if (j < n) {
        float d;
        int id;
        in.entry(j, d, id);
        nan |= d != d;
        key = make_key(d, id);
      }
      wide_keys[j] = key;
    }
    if (__syncthreads_or(nan)) {
      block_rounds(in, n, k, od, oi, s);
      return;
    }
    block_sort_keys(wide_keys, p);
    store_sorted(wide_keys, p, k, od, oi);
  } else {
    block_rounds(in, n, k, od, oi, s);
  }
}

constexpr int kMaxDevices = 64;

// A wide launch on the current device: its mode and dynamic shared memory.
struct WidePlan {
  int dev;
  size_t room;  // the opt-in dynamic shared memory a block may take
  Wide mode;
  size_t bytes;
};

// The plan for a row of n columns and k outputs.  A bitonic stage and a
// round each end on a block barrier, and at these widths the barriers set
// the time: kSort where `sort_bytes` fit and its log2(P) (log2(P) + 1) / 2
// stages are fewer than the k rounds, else kRounds where `row_bytes` fit,
// else kGlobal.  `fixed` is the kernel's static shared memory; the card's
// opt-in limit (about 227 KB on an H100) is read once a device.
inline cudaError_t wide_plan(long long n, int k, size_t sort_bytes,
                             size_t row_bytes, size_t fixed, WidePlan& w) {
  static int optin[kMaxDevices] = {};  // 0: not read yet
  cudaError_t err = cudaGetDevice(&w.dev);
  if (err != cudaSuccess) return err;
  if (w.dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (optin[w.dev] == 0) {
    err = cudaDeviceGetAttribute(
        &optin[w.dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, w.dev);
    if (err != cudaSuccess) return err;
  }
  w.room = static_cast<size_t>(optin[w.dev]) - fixed;
  long long lg = 0;
  while ((1ll << lg) < n) ++lg;
  if (sort_bytes <= w.room && lg * (lg + 1) / 2 < k) {
    w.mode = Wide::kSort;
    w.bytes = sort_bytes;
  } else if (row_bytes <= w.room) {
    w.mode = Wide::kRounds;
    w.bytes = row_bytes;
  } else {
    w.mode = Wide::kGlobal;
    w.bytes = 0;
  }
  return cudaSuccess;
}

// Launches KERNEL as `w` plans it, one block of kBlockThreads a row; the
// kernel's dynamic shared memory limit is raised to the whole room the
// first time it runs on a device.
template <auto KERNEL, class... A>
cudaError_t launch_wide(const WidePlan& w, int rows, cudaStream_t stream,
                        A... args) {
  static bool raised[kMaxDevices] = {};
  if (!raised[w.dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(KERNEL),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(w.room));
    if (err != cudaSuccess) return err;
    raised[w.dev] = true;
  }
  KERNEL<<<rows, kBlockThreads, w.bytes, stream>>>(args...);
  return cudaGetLastError();
}

// One block a row over q rows of a[0, ca) ++ b[0, cb).
inline cudaError_t launch_select_wide(const float* da, const int* ia, int ca,
                                      const float* db, const int* ib, int cb,
                                      float* out_d, int* out_i, int q, int k,
                                      cudaStream_t stream) {
  const long long n = static_cast<long long>(ca) + cb;
  WidePlan w;
  const cudaError_t err =
      wide_plan(n, k, sizeof(Key) * pow2_at_least(n),
                (sizeof(float) + sizeof(int)) * n, sizeof(BlockScratch), w);
  if (err != cudaSuccess) return err;
  switch (w.mode) {
    case Wide::kSort:
      return launch_wide<select_wide_kernel<Wide::kSort>>(
          w, q, stream, da, ia, ca, db, ib, cb, out_d, out_i, k);
    case Wide::kRounds:
      return launch_wide<select_wide_kernel<Wide::kRounds>>(
          w, q, stream, da, ia, ca, db, ib, cb, out_d, out_i, k);
    default:
      return launch_wide<select_wide_kernel<Wide::kGlobal>>(
          w, q, stream, da, ia, ca, db, ib, cb, out_d, out_i, k);
  }
}

}  // namespace
