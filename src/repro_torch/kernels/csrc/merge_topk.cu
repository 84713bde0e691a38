// Merge of ascending (d2, id) result lists for Hopper: the object-axis reduce.
//
// Replaces two Pallas TPU kernels of repro/kernels/merge_topk.py:
//   merge_topk_multi (pl.pallas_call at :75): the R per-shard lists of a
//     query side by side in one (R*k) row -> its k smallest pairs;
//   merge_topk_lists (pl.pallas_call at :119): two lists (ka) + (kb) -> the
//     k smallest of their union.
// Both give the k smallest of the row, ascending (d2, id), lowest id on
// distance ties, then the lowest column, and (inf, -1) once only +inf is
// left (repro/kernels/refine.py:56-88).
//
// Precondition, the reference's (merge_topk.py:4, :60, :108): every input
// list is ascending under (d2, id), its +inf entries at the tail.  All
// +inf keys count as equal here (their ids become -1 when staged), so
// padding such as (inf, -1) after (inf, 7) is still ascending; -0 and +0
// are equal (select_keys.cuh), and a zero d2 leaves as +0.  The lists
// are merged, not searched: on an input that breaks the precondition the
// output is not the k smallest.  merge_topk_multi takes R = C / k lists of
// k each, so it needs C % k == 0 (the wrapper raises otherwise).
//
// Design: one warp per row, 8 rows (one Q_TILE) per block of 256 threads.
// The warp stages its row's lists in shared memory as select_keys.cuh's
// 64-bit keys, with coalesced loads (a row is at most 512 entries, 4 KB).
// Output j of the merge of two ascending lists a and b is found by a
// merge-path co-rank binary search (merged_at): about log2(k + 1)
// dependent shared-memory reads a lane, a's entry first on equal keys
// since a holds the lower columns.
// - merge_topk_lists: lane L computes outputs L, L + 32, ... of the merge
//   of a[0, min(ca, k)) and b[0, min(cb, k)) and writes them coalesced.
// - merge_topk_multi: ceil(log2 R) levels of pairwise merges in shared
//   memory, adjacent lists left before right, an odd tail list carried to
//   the next level as its last operand, every merge cut to k; the last
//   merge writes the output.  Left before right keeps the column order on
//   equal keys at every level.
// There is no float arithmetic, only comparisons, so no rounding hazard.
//
// Wide routes: a row of more than 512 entries (R * k for merge_topk_multi,
// ca + cb for merge_topk_lists, or k > 512) needs no ascending input.
// - merge_topk_lists takes the wide merge, one block of 256 threads a row:
//   the keys of a[0, min(ca, k)) and b[0, min(cb, k)) staged in shared
//   memory, and a vote over both whole lists: no NaN and both ascending.
//   Such a row is merged as the narrow kernel merges it, thread t writing
//   outputs t, t + 256, ... from merged_at.  A NaN in a[0] alone, the
//   rest ascending, is merged too: the rounds emit (NaN, INT_MAX) first
//   and mask column 0, then select from the rest.  The key orders every
//   other d2 as the rounds do, -inf and negative ones included (a -0
//   leaves as +0, as from every key path; select_keys.cuh).  Any other
//   row takes, in the same block, what select_wide_kernel gives it.
// - merge_topk_multi, and merge_topk_lists where not even the staged keys
//   fit in shared memory, take block_select.cuh's select_wide_kernel: a
//   block bitonic sort of the row's keys in shared memory where they fit,
//   else (and on a row holding a NaN) the plain version's
//   masked_argmin_rounds over the whole row.  merge_topk_multi's
//   C % k == 0 stays the wrapper's precondition on the card.
//
// Bound on an H100: memory.  Per row it reads (ca + cb) * 8 bytes and writes
// k * 8: at Q = 1,007,616, R = 4, k = 32 that is 1.29 GB, about 0.385 ms at
// 3.35 TB/s.  Each input is read once, neighbouring lanes on neighbouring
// addresses; the merges cost ceil(log2 R) * k / 32 searches a lane.
#include "block_select.cuh"
#include "select_keys.cuh"
#include "warp_select.cuh"

namespace {

// Stages n entries of a list, four slabs' loads in flight before any store.
__device__ __forceinline__ void stage(const float* __restrict__ d,
                                      const int* __restrict__ id, int n,
                                      Key* dst, int lane) {
  for (int base = 0; base < n; base += 4 * kWarp) {
    float dv[4];
    int iv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + kWarp * u + lane;
      if (j < n) {
        dv[u] = d[j];
        iv[u] = id[j];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + kWarp * u + lane;
      if (j < n) dst[j] = run_key(dv[u], iv[u]);
    }
  }
}

__device__ __forceinline__ void store_pair(Key key, float* out_d, int* out_i) {
  float d;
  int id;
  key_pair(key, d, id);
  *out_d = d;
  *out_i = id;
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
merge_lists_kernel(const float* __restrict__ da, const int* __restrict__ ia,
                   int ca, const float* __restrict__ db,
                   const int* __restrict__ ib, int cb,
                   float* __restrict__ out_d, int* __restrict__ out_i, int q,
                   int k) {
  extern __shared__ Key smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  const int la = min(ca, k);
  const int lb = min(cb, k);
  Key* a = smem + warp * 2 * k;
  Key* b = a + la;
  stage(da + static_cast<size_t>(row) * ca, ia + static_cast<size_t>(row) * ca,
        la, a, lane);
  stage(db + static_cast<size_t>(row) * cb, ib + static_cast<size_t>(row) * cb,
        lb, b, lane);
  __syncwarp();
  const size_t orow = static_cast<size_t>(row) * k;
  for (int j = lane; j < k; j += kWarp) {
    const Key key = j < la + lb ? merged_at(a, la, b, lb, j) : kNoKey;
    store_pair(key, out_d + orow + j, out_i + orow + j);
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
merge_multi_kernel(const float* __restrict__ d, const int* __restrict__ id,
                   int runs, float* __restrict__ out_d,
                   int* __restrict__ out_i, int q, int k) {
  extern __shared__ Key smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  const int c = runs * k;
  Key* src = smem + warp * (runs + (runs + 1) / 2) * k;
  Key* dst = src + c;
  stage(d + static_cast<size_t>(row) * c, id + static_cast<size_t>(row) * c,
        c, src, lane);
  int n = runs;
  while (n > 2) {  // one level: n lists of k -> ceil(n / 2)
    __syncwarp();
    const int pairs = n / 2;
    for (int t = lane; t < pairs * k; t += kWarp) {
      const int p = t / k;
      const Key* a = src + 2 * p * k;
      dst[t] = merged_at(a, k, a + k, k, t - p * k);
    }
    if (n & 1) {  // the odd tail list, carried as the last operand
      for (int j = lane; j < k; j += kWarp) dst[pairs * k + j] =
          src[(n - 1) * k + j];
    }
    n = pairs + (n & 1);
    Key* t = src;
    src = dst;
    dst = t;
  }
  __syncwarp();
  const size_t orow = static_cast<size_t>(row) * k;
  for (int j = lane; j < k; j += kWarp) {
    const Key key = n == 2 ? merged_at(src, k, src + k, k, j) : src[j];
    store_pair(key, out_d + orow + j, out_i + orow + j);
  }
}

// select_wide_kernel's work on one row, by the whole block, for the rows
// the wide merge hands over (the same modes, so the same bits).
template <Wide MODE>
__device__ void select_row(const TwoLists& in, int n, int k, float* od,
                           int* oi, Key* smem, BlockScratch& s) {
  if constexpr (MODE == Wide::kRounds) {
    float* sd = reinterpret_cast<float*>(smem);
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
      smem[j] = key;
    }
    if (__syncthreads_or(nan)) {
      block_rounds(in, n, k, od, oi, s);
      return;
    }
    block_sort_keys(smem, p);
    store_sorted(smem, p, k, od, oi);
  } else {
    block_rounds(in, n, k, od, oi, s);
  }
}

// Stages the keys of d[0, l) into dst and votes over the whole list of c:
// `bad` where an entry is NaN (but for column 0 of the lead list, which
// sets `nan0`) or the list does not ascend.
__device__ __forceinline__ void stage_vote(const float* __restrict__ d,
                                           const int* __restrict__ id, int c,
                                           int l, Key* dst, bool lead,
                                           bool& bad, bool& nan0) {
  for (int j = threadIdx.x; j < c; j += kBlockThreads) {
    const float x = d[j];
    const Key key = run_key(x, id[j]);
    if (j < l) dst[j] = key;
    if (x != x) {
      if (lead && j == 0) {
        nan0 = true;
      } else {
        bad = true;
      }
    } else if (j + 1 < c && run_key(d[j + 1], id[j + 1]) < key) {
      bad = true;
    }
  }
}

// The wide merge of merge_topk_lists (see the header); MODE is the one
// wide_plan picks for the rows handed over.
template <Wide MODE>
__global__ void __launch_bounds__(kBlockThreads)
merge_lists_wide_kernel(const float* __restrict__ da,
                        const int* __restrict__ ia, int ca,
                        const float* __restrict__ db,
                        const int* __restrict__ ib, int cb,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int k) {
  extern __shared__ Key wide_keys[];
  __shared__ BlockScratch s;
  const size_t row = blockIdx.x;
  const TwoLists in{da + row * ca, ia + row * ca, ca, db + row * cb,
                    ib + row * cb};
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  const int la = min(ca, k);
  const int lb = min(cb, k);
  Key* a = wide_keys;
  Key* b = a + la;
  bool bad = false;
  bool nan0 = false;
  stage_vote(in.da, in.ia, ca, la, a, true, bad, nan0);
  stage_vote(in.db, in.ib, cb, lb, b, false, bad, nan0);
  if (__syncthreads_or(bad)) {
    select_row<MODE>(in, ca + cb, k, od, oi, wide_keys, s);
    return;
  }
  // a[0] the only NaN: it leaves first, and the rest merge after it
  const int skip = __syncthreads_or(nan0) ? 1 : 0;
  if (skip && threadIdx.x == 0) {
    od[0] = CUDART_NAN_F;
    oi[0] = INT_MAX;
  }
  for (int j = skip + threadIdx.x; j < k; j += kBlockThreads) {
    const int t = j - skip;
    const Key key = t < la - skip + lb ? merged_at(a + skip, la - skip, b, lb, t)
                                       : kNoKey;
    store_pair(key, od + j, oi + j);
  }
}

// merge_topk_lists' wide merge, where the staged keys fit in shared memory:
// its room is select_wide_kernel's or theirs, the larger.  Sets *taken to
// false, and launches nothing, where they do not fit.
cudaError_t launch_lists_wide(const float* da, const int* ia, int ca,
                              const float* db, const int* ib, int cb,
                              float* out_d, int* out_i, int q, int k,
                              cudaStream_t stream, bool* taken) {
  const long long n = static_cast<long long>(ca) + cb;
  WidePlan w;
  const cudaError_t err =
      wide_plan(n, k, sizeof(Key) * pow2_at_least(n),
                (sizeof(float) + sizeof(int)) * n, sizeof(BlockScratch), w);
  if (err != cudaSuccess) return err;
  const size_t staged = sizeof(Key) * (static_cast<size_t>(min(ca, k)) +
                                       static_cast<size_t>(min(cb, k)));
  *taken = staged <= w.room;
  if (!*taken) return cudaSuccess;
  if (staged > w.bytes) w.bytes = staged;
  switch (w.mode) {
    case Wide::kSort:
      return launch_wide<merge_lists_wide_kernel<Wide::kSort>>(
          w, q, stream, da, ia, ca, db, ib, cb, out_d, out_i, k);
    case Wide::kRounds:
      return launch_wide<merge_lists_wide_kernel<Wide::kRounds>>(
          w, q, stream, da, ia, ca, db, ib, cb, out_d, out_i, k);
    default:
      return launch_wide<merge_lists_wide_kernel<Wide::kGlobal>>(
          w, q, stream, da, ia, ca, db, ib, cb, out_d, out_i, k);
  }
}

// Dynamic shared memory above 48 KB must be asked for first.
cudaError_t launch_with_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// The largest row (R * k, or ca + cb) and k a warp stages: 512 entries; a
// wider row takes the wide template.
constexpr int kNarrowRow = kWarp * 16;

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// d / id are (q, runs * k), out (q, k), each row runs ascending lists of k;
// q > 0; runs > 0; k > 0.  *wide is set to 1 where the row took the wide
// template, else to 0.
int merge_topk_multi_f32(const void* d, const void* id, int runs,
                         void* out_d, void* out_i, int q, int k,
                         void* stream, int* wide) {
  if (runs <= 0 || k <= 0 || static_cast<long long>(runs) * k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  *wide = runs * k > kNarrowRow;
  if (*wide) {
    const float* dd = static_cast<const float*>(d);
    const int* ii = static_cast<const int*>(id);
    return static_cast<int>(launch_select_wide(
        dd, ii, runs * k, dd, ii, 0, static_cast<float*>(out_d),
        static_cast<int*>(out_i), q, k, static_cast<cudaStream_t>(stream)));
  }
  const size_t smem =
      sizeof(Key) * kRowsPerBlock * (runs + (runs + 1) / 2) * k;
  const cudaError_t err =
      launch_with_smem(reinterpret_cast<const void*>(merge_multi_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  merge_multi_kernel<<<blocks, kWarp * kRowsPerBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const int*>(id), runs,
      static_cast<float*>(out_d), static_cast<int*>(out_i), q, k);
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// a is (q, ca), b is (q, cb), out (q, k), a and b ascending; q > 0;
// ca, cb >= 0; k > 0.  *route is set to the route the launch took: 0 the
// narrow kernel, 1 the wide template (select_wide_kernel), 3 the wide
// merge.
int merge_topk_lists_f32(const void* da, const void* ia, int ca,
                         const void* db, const void* ib, int cb, void* out_d,
                         void* out_i, int q, int k, void* stream,
                         int* route) {
  if (ca < 0 || cb < 0 || k <= 0 ||
      static_cast<long long>(ca) + cb > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  *route = 0;
  if (ca + cb > kNarrowRow || k > kNarrowRow) {
    const float* fa = static_cast<const float*>(da);
    const int* ja = static_cast<const int*>(ia);
    const float* fb = static_cast<const float*>(db);
    const int* jb = static_cast<const int*>(ib);
    float* od = static_cast<float*>(out_d);
    int* oi = static_cast<int*>(out_i);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    bool taken = false;
    const cudaError_t err = launch_lists_wide(fa, ja, ca, fb, jb, cb, od, oi,
                                              q, k, st, &taken);
    if (err != cudaSuccess || taken) {
      *route = 3;
      return static_cast<int>(err);
    }
    *route = 1;
    return static_cast<int>(
        launch_select_wide(fa, ja, ca, fb, jb, cb, od, oi, q, k, st));
  }
  const size_t smem = sizeof(Key) * kRowsPerBlock * 2 * k;
  const cudaError_t err =
      launch_with_smem(reinterpret_cast<const void*>(merge_lists_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  merge_lists_kernel<<<blocks, kWarp * kRowsPerBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(da), static_cast<const int*>(ia), ca,
      static_cast<const float*>(db), static_cast<const int*>(ib), cb,
      static_cast<float*>(out_d), static_cast<int*>(out_i), q, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
