// Fused SCAN-step merge for Hopper: distance + bucket radius + top-k.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_scan.py::fused_scan_merge
// (pl.pallas_call at fused_scan.py:126).  Per query row it computes the d2 of
// a W-wide gathered candidate window (invalid entries +inf), appends it to the
// row's current (k) list, narrows the k-th distance with `iters` rounds of a
// 32-bin histogram, prunes at fhi + max(fhi - flo, fhi*1e-6 + 1e-30) (+inf
// when fewer than k entries are not +inf), and emits the k smallest (d2, id)
// pairs ascending, lowest id on ties, (inf, -1) padded.
//
// Under precision="mixed" (the template flag MIXED; the reference's branch at
// fused_scan.py:52) a valid window entry is first kept only if its bf16
// distance, each operation rounded once (__hmul, __hadd on __nv_bfloat16
// from the bf16-rounded f32 deltas), is <= best_d[k-1] * MIXED_WIDEN; a
// dropped entry is +inf from then on, so it leaves the refinement population
// and n_valid as well.  The prefilter is conservative, so the merged lists
// equal fp32's bit for bit wherever the list is ascending.
//
// Why a plain select is enough.  The refinement counts ranks against the
// bucket edges (kernels/refine.py, bucket_refine_step), so on a row whose
// entries are all +0 or above (+inf included, no NaN) the k-th smallest
// value stays in [flo, fhi): the first interval holds every finite entry
// (hi = fma(max, 1 + 1e-6, 1e-30) > max), and a round moves it only after
// counting that the new one holds the wanted rank.  The prune radius
// fhi + slop is then >= fhi, so the prune removes only entries above the
// k-th value, and the k rounds over the pruned row return what they return
// over the whole row: its k smallest (d2, id) pairs.  With fewer than k
// entries below +inf nothing finite is pruned.  So on such rows the output
// is the exact k-selection of `list ++ window d2`, for any order of the list.
//
// Design: one warp per query row, 8 rows (one Q_TILE) per block of 256
// threads.
// - The fast path is select_keys.cuh's warp_queue_select, B4's WarpSelect,
//   fed by a key producer: lanes read the row's columns 32 at a time, the
//   list's entries keyed as they are, the window's d2 computed in registers
//   (dx, dy rounded once, __fmaf_rn(dx, dx, dy * dy)) and keyed.  A queue of
//   W = 32 * N keys, N by k (32, 64, 128, 256), keeps the best entries; lanes
//   store the output from their queue registers, coalesced.
// - Rows that break the argument above keep the refinement path: every
//   entry the producer builds is tested for a NaN or a set sign bit (a
//   negative value, -inf, or -0, which the rounds emit with its sign where
//   the queue's key would emit +0); one vote after the stream sends such a
//   row down the path below, which recomputes it from the inputs.
// - The refinement path: lane L holds columns L, L+32, ... of the (k + W)
//   row in registers (P of them, a template parameter on a ladder).
//   n_valid is a ballot count; lo / hi0 are warp reductions that propagate
//   NaN as jnp.min / jnp.max do; the 32 histogram bins are the 32 lanes (a
//   per-warp shared counter array, then an inclusive shuffle scan); the
//   prune; then k rounds of warp_select.cuh's lexicographic (d2, id, column)
//   warp argmin.  A NaN lo makes every interval, and the radius, NaN: the
//   prune then drops every entry, as the plain version's does, or, with
//   fewer than k entries below +inf, only the NaN ones.
// - k > 256 runs the refinement path on every row (the rounds template).
// - k + W > 512 (the ladder's P = 16 a lane) takes one of three wide
//   routes; the entry point reports which.
//   - The wide queue (k <= 256): the fast path above over the whole row,
//     which the warp queue streams at any width.  A row that fails the
//     vote cannot take the refinement path (its registers stop at 512
//     columns): after a block barrier, the block's 256 threads run the
//     wide template below on each such row of the block in turn, the row
//     staged in shared memory up to k + W = 4,096.
//   - The wide merge (k > 256): one block a row.  On a row with no odd
//     entry whose list is ascending (its +inf entries all equal, as
//     merge_topk.cu stages them), the k smallest of list ++ window are
//     the list merged with the window entries whose key is below the
//     list's k-th (an equal key is an exact duplicate, as in the queue's
//     threshold).  Those survivors are compacted into shared memory
//     through a ballot, bitonic-sorted (block_sort_keys over the next
//     power of two, few keys once the sweep's lists have filled), and
//     output j is merged_at(list, survivors, j).  Any other row, or one
//     whose survivors pass the shared room, takes the wide template in
//     the same block.
//   - The wide template (the rows of the two routes above that they
//     cannot take, and every row where not even k keys fit in shared
//     memory): the plain version's steps at block level (block_select.cuh):
//     d2 of the window (+inf where invalid; under MIXED the bf16 prefilter
//     first), appended to the list, the refinement, the prune, then the k
//     smallest of what the prune keeps.  Where the row and its keys fit in
//     shared memory it is staged and the kept entries' keys are sorted or
//     the rounds run over it (k + W up to about 28,000 on an H100); else
//     the row is recomputed from the inputs on every pass and the rounds
//     select.
//
// Bound on an H100: memory.  Per row the kernel reads W*13 + k*8 + 8 bytes
// and writes k*8 (about 3.6 KB + 0.26 KB at W=256, k=32); its arithmetic is
// a key build and a 64-bit compare per entry plus the queue's flushes.  The
// design reads each input once, with neighbouring lanes on neighbouring
// addresses, and keeps the distances and the queue in registers and shared
// memory, so only the window in and the lists out cross device memory.
//
// Bitwise contract: equal to the plain PyTorch version
// (repro_torch/kernels/fused_scan.py::fused_scan_merge_ref) on every input.
// Its outputs are the exact k smallest on rows of squared distances, so they
// equal the JAX reference's wherever that is right; the refinement counts
// ranks against the bucket edges, where the reference's histogram rank can
// lose the k-th entry (kernels/refine.py, bucket_refine_step).  Every site
// the reference's compiled program contracts is an explicit __fmaf_rn;
// every other multiply, add and divide is an explicit round-to-nearest
// intrinsic, and the build passes --fmad=false.
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "block_select.cuh"
#include "select_keys.cuh"

namespace {

constexpr int kBins = 32;  // one histogram bin per lane

struct Args {
  const float* qx;
  const float* qy;
  const float* cx;
  const float* cy;
  const int* cids;
  const bool* valid;
  const float* best_d;
  const int* best_i;
  float* out_d;
  int* out_i;
  int q, w, k, iters;
  float hi_mul, hi_add, slop_mul, tiny, widen;
};

// One row's inputs: column j < k is the list's entry j, column k + i the
// window's entry i.
template <bool MIXED>
struct RowIn {
  const Args& a;
  size_t brow, wrow;
  float fx, fy;
  float kth_wide;  // the mixed prefilter's widened k-th boundary

  __device__ __forceinline__ RowIn(const Args& args, int row) : a(args) {
    brow = static_cast<size_t>(row) * a.k;
    wrow = static_cast<size_t>(row) * a.w;
    fx = a.qx[row];
    fy = a.qy[row];
    kth_wide = MIXED ? __fmul_rn(a.best_d[brow + a.k - 1], a.widen)
                     : CUDART_INF_F;
  }

  __device__ __forceinline__ void entry(int j, float& d, int& id) const {
    if (j < a.k) {
      d = a.best_d[brow + j];
      id = a.best_i[brow + j];
      return;
    }
    const size_t o = wrow + (j - a.k);
    id = a.cids[o];
    d = CUDART_INF_F;
    if (a.valid[o]) {
      const float dx = __fsub_rn(a.cx[o], fx);
      const float dy = __fsub_rn(a.cy[o], fy);
      bool keep = true;
      if (MIXED) {
        const __nv_bfloat16 xb = __float2bfloat16_rn(dx);
        const __nv_bfloat16 yb = __float2bfloat16_rn(dy);
        const float d2b =
            __bfloat162float(__hadd(__hmul(xb, xb), __hmul(yb, yb)));
        keep = d2b <= kth_wide;
      }
      if (keep) d = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
    }
  }
};

// The refinement path of one row: bucket refinement, prune, k rounds.
template <int P, bool MIXED>
__device__ __forceinline__ void refine_row(const Args& a, int row, int lane,
                                           int* hist) {
  const RowIn<MIXED> in(a, row);
  const int k = a.k;
  const int n = k + a.w;
  const float inf = CUDART_INF_F;
  float d[P];
  int id[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + kWarp * p;
    if (j < n) {
      in.entry(j, d[p], id[p]);
    } else {
      d[p] = inf;  // past the row's end: never selected as a finite entry
      id[p] = INT_MAX;
    }
  }

  // ---- n_valid, lo, hi.
  int n_valid = 0;
  float lo = inf;
  float hi0 = -inf;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool fin = !isinf(d[p]);
    n_valid += __popc(__ballot_sync(kFull, fin));
    lo = nan_min(lo, d[p]);
    if (fin) hi0 = nan_max(hi0, d[p]);
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    lo = nan_min(lo, __shfl_xor_sync(kFull, lo, o));
    hi0 = nan_max(hi0, __shfl_xor_sync(kFull, hi0, o));
  }
  float flo = lo;
  float fhi = __fmaf_rn(nan_max(hi0, lo), a.hi_mul, a.hi_add);
  int kth = k;

  // ---- bucket refinement of the k-th distance.
  for (int it = 0; it < a.iters; ++it) {
    const float width = nan_max(
        __fdiv_rn(__fsub_rn(fhi, flo), static_cast<float>(kBins)), a.tiny);
    hist[lane] = 0;
    __syncwarp();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float x = d[p];
      if (x >= flo && x < fhi) {
        float b = floorf(__fdiv_rn(__fsub_rn(x, flo), width));
        b = fminf(fmaxf(b, 0.0f), static_cast<float>(kBins - 1));  // NaN -> 0
        atomicAdd(&hist[__float2int_rz(b)], 1);
      }
    }
    __syncwarp();
    int cum = hist[lane];
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int v = __shfl_up_sync(kFull, cum, o);
      if (lane >= o) cum += v;
    }
    const unsigned ge = __ballot_sync(kFull, cum >= kth);
    const int sel = ge ? __ffs(ge) - 1 : 0;
    const float new_lo = __fmaf_rn(static_cast<float>(sel), width, flo);
    const float new_hi = __fadd_rn(new_lo, width);
    // The rank below the bucket, and whether the bucket holds the wanted
    // element, are counted against its edges, not taken from the histogram
    // (a value on an edge can be binned on the other side of it).
    int below = 0;
    int inside = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float x = d[p];
      below += __popc(__ballot_sync(kFull, x >= flo && x < new_lo));
      inside += __popc(__ballot_sync(kFull, x >= new_lo && x < new_hi));
    }
    if (below < kth && below + inside >= kth) {
      flo = new_lo;
      fhi = new_hi;
      kth -= below;
    }
  }

  // ---- prune at the conservative radius (NaN drops everything).
  const float slop =
      nan_max(__fsub_rn(fhi, flo), __fmaf_rn(fhi, a.slop_mul, a.tiny));
  const float radius = n_valid < k ? inf : __fadd_rn(fhi, slop);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!(d[p] < radius)) d[p] = inf;
  }

  // ---- k rounds of lexicographic warp argmin, straight to the output.
  float* out_d = a.out_d + in.brow;
  int* out_i = a.out_i + in.brow;
  const int r = warp_select_rounds<P>(d, id, k, lane, out_d, out_i);
  for (int j = r + lane; j < k; j += kWarp) {
    out_d[j] = inf;
    out_i[j] = -1;
  }
}

// A NaN, or an entry whose sign bit is set: the row leaves the fast path.
__device__ __forceinline__ bool odd_entry(float d) {
  return d != d || (__float_as_uint(d) >> 31) != 0;
}

// Up to W = 64 the launch bounds hold the queue kernel to 40 registers, so
// 48 warps fit on an SM: the refinement path's row (2P registers) then
// spills, but only the rare rows that take it pay for that.
template <int N, int P, bool MIXED>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock, N <= 2 ? 6 : 1)
fused_scan_queue_kernel(const Args a) {
  __shared__ Key ring[kRowsPerBlock][kRing];
  __shared__ int hist[kRowsPerBlock][kBins];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= a.q) return;  // the whole warp leaves together
  const RowIn<MIXED> in(a, row);
  bool odd = false;
  Key wq[N];  // the warp queue
  warp_queue_select<N>(
      [&](int j) {
        float d;
        int id;
        in.entry(j, d, id);
        odd |= odd_entry(d);
        return make_key(d, id);
      },
      a.k + a.w, a.k, ring[warp], lane, wq);
  if (__any_sync(kFull, odd)) {  // one vote for the row
    refine_row<P, MIXED>(a, row, lane, hist[warp]);
    return;
  }
  store_queue<N>(wq, a.k, lane, a.out_d + in.brow, a.out_i + in.brow);
}

// The rounds template, for k beyond the queue ladder: every row refines.
template <int P, bool MIXED>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
fused_scan_rounds_kernel(const Args a) {
  __shared__ int hist[kRowsPerBlock][kBins];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= a.q) return;
  refine_row<P, MIXED>(a, row, lane, hist[warp]);
}

// The wide template, for k + W beyond the narrow templates' row: one block
// a row (block_select.cuh), its own kernel so that the narrow templates'
// launch bounds stay theirs.  Its modes (block_select.cuh's wide_plan):
// kSort stages the row (8 bytes a column) beside its keys (8 bytes each of
// p = pow2_at_least(k + W)), refines it there, and sorts the keys of the
// entries below the prune radius (the pruned ones, NaN among them, are
// kNoKey: (inf, -1), as the rounds give them); kRounds stages the row,
// prunes it in place and runs the rounds; kGlobal recomputes the row from
// the inputs on every pass and runs the rounds.
template <bool MIXED>
struct PrunedRow {
  RowIn<MIXED> in;
  float radius;
  __device__ __forceinline__ void entry(int j, float& d, int& id) const {
    in.entry(j, d, id);
    if (!(d < radius)) d = CUDART_INF_F;
  }
};

// One row of the wide template, by the whole block; `smem` is the dynamic
// shared memory wide_plan sizes for MODE (unused by kGlobal).
template <bool MIXED, Wide MODE>
__device__ void wide_row(const Args& a, int row, Key* smem, BlockScratch& s) {
  const RowIn<MIXED> in(a, row);
  const int n = a.k + a.w;
  const RefineConsts rc{a.iters, a.hi_mul, a.hi_add, a.slop_mul, a.tiny};
  float* out_d = a.out_d + in.brow;
  int* out_i = a.out_i + in.brow;
  if constexpr (MODE == Wide::kRounds) {
    float* sd = reinterpret_cast<float*>(smem);
    const StagedRow st =
        stage_row(in, n, sd, reinterpret_cast<int*>(sd + n));
    const float radius = block_refine_radius(st, n, a.k, rc, s);
    for (int j = threadIdx.x; j < n; j += kBlockThreads) {
      if (!(sd[j] < radius)) sd[j] = CUDART_INF_F;  // the prune
    }
    __syncthreads();
    block_rounds(st, n, a.k, out_d, out_i, s);
  } else if constexpr (MODE == Wide::kSort) {
    const int p = static_cast<int>(pow2_at_least(n));
    Key* keys = smem;
    float* sd = reinterpret_cast<float*>(keys + p);
    int* si = reinterpret_cast<int*>(sd + n);
    const StagedRow st = stage_row(in, n, sd, si);
    const float radius = block_refine_radius(st, n, a.k, rc, s);
    for (int j = threadIdx.x; j < p; j += kBlockThreads) {
      keys[j] = j < n && sd[j] < radius ? make_key(sd[j], si[j]) : kNoKey;
    }
    __syncthreads();
    block_sort_keys(keys, p);
    store_sorted(keys, p, a.k, out_d, out_i);
  } else {
    const float radius = block_refine_radius(in, n, a.k, rc, s);
    block_rounds(PrunedRow<MIXED>{in, radius}, n, a.k, out_d, out_i, s);
  }
}

template <bool MIXED, Wide MODE>
__global__ void __launch_bounds__(kBlockThreads)
fused_scan_wide_kernel(const Args a) {
  extern __shared__ Key wide_keys[];
  __shared__ BlockScratch s;
  wide_row<MIXED, MODE>(a, blockIdx.x, wide_keys, s);
}

// The wide queue: the fast path of fused_scan_queue_kernel over a row of
// any width, 8 rows a block; the block's odd rows then take the wide
// template one after another, staged in shared memory (MODE kRounds)
// where the row takes at most kStagedRowBytes, else over global memory
// (kGlobal).  Every warp reaches the barrier.
static_assert(kBlockThreads == kWarp * kRowsPerBlock, "a warp a row");

// 32 KB of staged row beside the kernel's 4.5 KB of static shared memory
// stays under the 48 KB a block takes without opting in, and 4 such
// blocks (the launch bounds' occupancy at N <= 2) fit in an SM's 227 KB.
constexpr size_t kStagedRowBytes = 32 * 1024;

template <int N, bool MIXED, Wide MODE>
__global__ void __launch_bounds__(kBlockThreads, N <= 2 ? 4 : 1)
fused_scan_wide_queue_kernel(const Args a) {
  extern __shared__ Key wide_keys[];
  __shared__ Key ring[kRowsPerBlock][kRing];
  __shared__ BlockScratch s;
  __shared__ int odd_row[kRowsPerBlock];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  bool odd = false;
  if (row < a.q) {  // the whole warp together
    const RowIn<MIXED> in(a, row);
    Key wq[N];  // the warp queue
    warp_queue_select<N>(
        [&](int j) {
          float d;
          int id;
          in.entry(j, d, id);
          odd |= odd_entry(d);
          return make_key(d, id);
        },
        a.k + a.w, a.k, ring[warp], lane, wq);
    odd = __any_sync(kFull, odd);  // one vote for the row
    if (!odd) store_queue<N>(wq, a.k, lane, a.out_d + in.brow,
                             a.out_i + in.brow);
  }
  if (lane == 0) odd_row[warp] = odd;
  __syncthreads();
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (odd_row[w]) {
      wide_row<MIXED, MODE>(a, blockIdx.x * kRowsPerBlock + w, wide_keys,
                            s);
      __syncthreads();
    }
  }
}

// The wide merge: one block a row (see the header).  `cap`, a power of
// two, is the survivors' room after the list's k keys.
template <bool MIXED, Wide MODE>
__global__ void __launch_bounds__(kBlockThreads)
fused_scan_wide_merge_kernel(const Args a, int cap) {
  extern __shared__ Key wide_keys[];
  __shared__ BlockScratch s;
  __shared__ int count;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const RowIn<MIXED> in(a, row);
  const int k = a.k;
  Key* list = wide_keys;
  Key* surv = wide_keys + k;
  if (threadIdx.x == 0) count = 0;
  bool odd = false;
  for (int j = threadIdx.x; j < k; j += kBlockThreads) {
    float d;
    int id;
    in.entry(j, d, id);
    odd |= odd_entry(d);
    list[j] = run_key(d, id);
  }
  __syncthreads();
  for (int j = threadIdx.x; j + 1 < k; j += kBlockThreads) {
    odd |= list[j + 1] < list[j];
  }
  const Key kth = list[k - 1];
  for (int base = 0; base < a.w; base += kBlockThreads) {
    const int j = base + threadIdx.x;
    Key key = kNoKey;
    if (j < a.w) {
      float d;
      int id;
      in.entry(k + j, d, id);
      odd |= odd_entry(d);
      key = run_key(d, id);
    }
    const bool take = key < kth;
    const unsigned m = __ballot_sync(kFull, take);
    if (m == 0) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(&count, __popc(m));
    at = __shfl_sync(kFull, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (take && at < cap) surv[at] = key;
  }
  if (__syncthreads_or(odd) || count > cap) {
    wide_row<MIXED, MODE>(a, row, wide_keys, s);
    return;
  }
  const int m = count;
  const int p = static_cast<int>(pow2_at_least(m));
  for (int j = m + threadIdx.x; j < p; j += kBlockThreads) surv[j] = kNoKey;
  __syncthreads();
  block_sort_keys(surv, p);
  float* out_d = a.out_d + in.brow;
  int* out_i = a.out_i + in.brow;
  for (int j = threadIdx.x; j < k; j += kBlockThreads) {
    key_pair(merged_at(list, k, surv, m, j), out_d[j], out_i[j]);
  }
}

template <bool MIXED>
cudaError_t launch_wide_as(const Args& a, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.k) + a.w;
  const size_t row_bytes = (sizeof(float) + sizeof(int)) * n;
  WidePlan w;
  const cudaError_t err =
      wide_plan(n, a.k, sizeof(Key) * pow2_at_least(n) + row_bytes,
                row_bytes, sizeof(BlockScratch), w);
  if (err != cudaSuccess) return err;
  switch (w.mode) {
    case Wide::kSort:
      return launch_wide<fused_scan_wide_kernel<MIXED, Wide::kSort>>(
          w, a.q, stream, a);
    case Wide::kRounds:
      return launch_wide<fused_scan_wide_kernel<MIXED, Wide::kRounds>>(
          w, a.q, stream, a);
    default:
      return launch_wide<fused_scan_wide_kernel<MIXED, Wide::kGlobal>>(
          w, a.q, stream, a);
  }
}

// The wide queue, N by k as the narrow ladder takes it.
template <bool MIXED, Wide MODE>
cudaError_t launch_wide_queue_as(const Args& a, size_t bytes,
                                 cudaStream_t stream) {
  const int blocks = (a.q + kRowsPerBlock - 1) / kRowsPerBlock;
  auto go = [&](auto kernel) {
    kernel<<<blocks, kBlockThreads, bytes, stream>>>(a);
    return cudaGetLastError();
  };
  if (a.k <= 32) return go(fused_scan_wide_queue_kernel<1, MIXED, MODE>);
  if (a.k <= 64) return go(fused_scan_wide_queue_kernel<2, MIXED, MODE>);
  if (a.k <= 128) return go(fused_scan_wide_queue_kernel<4, MIXED, MODE>);
  return go(fused_scan_wide_queue_kernel<8, MIXED, MODE>);
}

template <bool MIXED>
cudaError_t launch_wide_queue(const Args& a, cudaStream_t stream) {
  const size_t row_bytes =
      (sizeof(float) + sizeof(int)) * (static_cast<size_t>(a.k) + a.w);
  return row_bytes <= kStagedRowBytes
             ? launch_wide_queue_as<MIXED, Wide::kRounds>(a, row_bytes, stream)
             : launch_wide_queue_as<MIXED, Wide::kGlobal>(a, 0, stream);
}

// The wide merge, where the list's k keys and one survivor fit in the
// shared room; its shared memory is the wide template's (for the rows it
// hands over) or the list and the next power of two above W, the larger.
// Sets *taken to false, and launches nothing, where they do not fit.
template <bool MIXED>
cudaError_t launch_wide_merge(const Args& a, cudaStream_t stream,
                              bool* taken) {
  // The kernel's static shared memory (its three modes declare the same),
  // with the dynamic memory's alignment: read from the kernel itself.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, reinterpret_cast<const void*>(
                 fused_scan_wide_merge_kernel<MIXED, Wide::kGlobal>));
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(a.k) + a.w;
  const size_t row_bytes = (sizeof(float) + sizeof(int)) * n;
  WidePlan w;
  const size_t fixed = (attr.sharedSizeBytes + 15) & ~static_cast<size_t>(15);
  err = wide_plan(n, a.k, sizeof(Key) * pow2_at_least(n) + row_bytes,
                  row_bytes, fixed, w);
  if (err != cudaSuccess) return err;
  const size_t want = sizeof(Key) * (a.k + pow2_at_least(a.w));
  w.bytes = std::max(w.bytes, std::min(want, w.room));
  *taken = w.bytes >= sizeof(Key) * (a.k + 1);
  if (!*taken) return cudaSuccess;
  int cap = 1;
  while (sizeof(Key) * (a.k + 2ll * cap) <= w.bytes) cap *= 2;
  switch (w.mode) {
    case Wide::kSort:
      return launch_wide<fused_scan_wide_merge_kernel<MIXED, Wide::kSort>>(
          w, a.q, stream, a, cap);
    case Wide::kRounds:
      return launch_wide<fused_scan_wide_merge_kernel<MIXED, Wide::kRounds>>(
          w, a.q, stream, a, cap);
    default:
      return launch_wide<fused_scan_wide_merge_kernel<MIXED, Wide::kGlobal>>(
          w, a.q, stream, a, cap);
  }
}

template <int N, int P>
cudaError_t launch_queue(const Args& a, bool mixed, cudaStream_t stream) {
  const int blocks = (a.q + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = mixed ? fused_scan_queue_kernel<N, P, true>
                      : fused_scan_queue_kernel<N, P, false>;
  kernel<<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_rounds(const Args& a, bool mixed, cudaStream_t stream) {
  const int blocks = (a.q + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = mixed ? fused_scan_rounds_kernel<P, true>
                      : fused_scan_rounds_kernel<P, false>;
  kernel<<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

// The refinement path's registers a lane, P, on a ladder: the first rung
// at or above ceil((k + W) / 32).  N = 0 is the rounds template.
template <int N>
cudaError_t launch_ladder(const Args& a, bool mixed, cudaStream_t stream) {
  const int need = (a.k + a.w + kWarp - 1) / kWarp;
  auto go = [&](auto p) {
    constexpr int kP = decltype(p)::value;
    if constexpr (N == 0) {
      return launch_rounds<kP>(a, mixed, stream);
    } else {
      return launch_queue<N, kP>(a, mixed, stream);
    }
  };
  // k <= 32 N and k + W >= k + 1 set the lowest rung each N can need.
  if constexpr (N == 1) {
    if (need <= 1) return go(std::integral_constant<int, 1>());
  }
  if constexpr (N >= 1 && N <= 2) {
    if (need <= 2) return go(std::integral_constant<int, 2>());
  }
  if constexpr (N >= 1 && N <= 4) {
    if (need <= 4) return go(std::integral_constant<int, 4>());
  }
  if constexpr (N >= 1) {
    if (need <= 8) return go(std::integral_constant<int, 8>());
  }
  if (need <= 9) return go(std::integral_constant<int, 9>());
  if (need <= 12) return go(std::integral_constant<int, 12>());
  if (need <= 16) return go(std::integral_constant<int, 16>());
  return cudaErrorInvalidValue;
}

// The widest k + W row the narrow templates take (P = 16 elements a lane);
// a wider row takes a wide route.
constexpr long long kNarrowRow = kWarp * 16;

// The entry point's route codes.
enum Route : int { kNarrow = 0, kWideTemplate = 1, kWideQueue = 2,
                   kWideMerge = 3 };

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// q, w, k, iters > 0; mixed != 0 runs the bf16 prefilter with the widening
// factor `widen`.  *route is set to the route the launch took: 0 the
// narrow templates (k + W <= 512), 1 the wide template, 2 the wide queue,
// 3 the wide merge.
int fused_scan_merge_f32(const void* qx, const void* qy, const void* cx,
                         const void* cy, const void* cids, const void* valid,
                         const void* best_d, const void* best_i, void* out_d,
                         void* out_i, int q, int w, int k, int iters,
                         int mixed, float hi_mul, float hi_add, float slop_mul,
                         float tiny, float widen, void* stream,
                         int* route) {
  if (q <= 0 || w <= 0 || k <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(qx), static_cast<const float*>(qy),
               static_cast<const float*>(cx), static_cast<const float*>(cy),
               static_cast<const int*>(cids), static_cast<const bool*>(valid),
               static_cast<const float*>(best_d),
               static_cast<const int*>(best_i), static_cast<float*>(out_d),
               static_cast<int*>(out_i), q, w, k, iters, hi_mul, hi_add,
               slop_mul, tiny, widen};
  const bool mx = mixed != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  *route = kNarrow;
  if (static_cast<long long>(k) + w > kNarrowRow) {
    bool taken = k <= 256;
    if (taken) {
      *route = kWideQueue;
      err = mx ? launch_wide_queue<true>(a, s) : launch_wide_queue<false>(a, s);
    } else {
      *route = kWideMerge;
      err = mx ? launch_wide_merge<true>(a, s, &taken)
               : launch_wide_merge<false>(a, s, &taken);
    }
    if (err == cudaSuccess && !taken) {
      *route = kWideTemplate;
      err = mx ? launch_wide_as<true>(a, s) : launch_wide_as<false>(a, s);
    }
  } else if (k <= 32) {
    err = launch_ladder<1>(a, mx, s);
  } else if (k <= 64) {
    err = launch_ladder<2>(a, mx, s);
  } else if (k <= 128) {
    err = launch_ladder<4>(a, mx, s);
  } else if (k <= 256) {
    err = launch_ladder<8>(a, mx, s);
  } else {
    err = launch_ladder<0>(a, mx, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
