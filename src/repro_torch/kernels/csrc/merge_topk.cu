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
// Wide template: a row of more than 512 entries (R * k for merge_topk_multi,
// ca + cb for merge_topk_lists, or k > 512) goes to block_select.cuh's
// select_wide_kernel, one block of 256 threads a row: a block bitonic sort
// of the row's keys in shared memory where they fit, else (and on a row
// holding a NaN) the plain version's masked_argmin_rounds over the whole
// row.  It needs no ascending input; merge_topk_multi's C % k == 0 stays
// the wrapper's precondition on the card.
//
// Bound on an H100: memory.  Per row it reads (ca + cb) * 8 bytes and writes
// k * 8: at Q = 1,007,616, R = 4, k = 32 that is 1.29 GB, about 0.385 ms at
// 3.35 TB/s.  Each input is read once, neighbouring lanes on neighbouring
// addresses; the merges cost ceil(log2 R) * k / 32 searches a lane.
#include "block_select.cuh"
#include "select_keys.cuh"
#include "warp_select.cuh"

namespace {

// A staged entry: +inf keys all equal, so +inf padding stays ascending.
__device__ __forceinline__ Key run_key(float d, int id) {
  return make_key(d, isinf(d) && d > 0.f ? -1 : id);
}

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
// ca, cb >= 0; k > 0.  *wide is set to 1 where the row took the wide
// template, else to 0.
int merge_topk_lists_f32(const void* da, const void* ia, int ca,
                         const void* db, const void* ib, int cb, void* out_d,
                         void* out_i, int q, int k, void* stream, int* wide) {
  if (ca < 0 || cb < 0 || k <= 0 ||
      static_cast<long long>(ca) + cb > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  *wide = ca + cb > kNarrowRow || k > kNarrowRow;
  if (*wide) {
    return static_cast<int>(launch_select_wide(
        static_cast<const float*>(da), static_cast<const int*>(ia), ca,
        static_cast<const float*>(db), static_cast<const int*>(ib), cb,
        static_cast<float*>(out_d), static_cast<int*>(out_i), q, k,
        static_cast<cudaStream_t>(stream)));
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
