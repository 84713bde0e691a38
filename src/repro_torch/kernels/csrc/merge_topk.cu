// Merge of ascending (d2, id) result lists for Hopper: the object-axis reduce.
//
// Replaces two Pallas TPU kernels of repro/kernels/merge_topk.py:
//   merge_topk_multi (pl.pallas_call at :75): the R per-shard lists of a
//     query side by side in one (R*k) row -> its k smallest pairs;
//   merge_topk_lists (pl.pallas_call at :119): two lists (ka) + (kb) -> the
//     k smallest of their union.
// Both are k rounds of masked argmin over one row, lowest id on distance
// ties, then the lowest column, and (inf, -1) once only +inf is left
// (repro/kernels/refine.py:56-88); one kernel serves both, reading column j
// of the row from a (j < ca) or from b (column j - ca).
//
// Design: one warp per row, 8 rows (one Q_TILE) per block of 256 threads.
// Lane L holds columns L, L+32, ... of the row in registers (P of them, a
// template parameter); the rounds are warp_select.cuh's lexicographic warp
// argmin, the same as the last stage of fused_scan.cu.  There is no float
// arithmetic, only comparisons, so no rounding hazard.
//
// Bound on an H100: memory.  Per row it reads (ca + cb) * 8 bytes and writes
// k * 8: at Q = 1,007,616, R = 4, k = 32 that is 1.29 GB, about 0.385 ms at
// 3.35 TB/s.  Each input is read once, neighbouring lanes on neighbouring
// addresses, and the row stays in registers through all k rounds.  The k
// rounds of a 5-step shuffle butterfly are the cost above the bound; a k-way
// merge that uses the inputs' sortedness would cut them (later work).
#include "warp_select.cuh"

namespace {

template <int P>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
merge_topk_kernel(const float* __restrict__ da, const int* __restrict__ ia,
                  int ca, const float* __restrict__ db,
                  const int* __restrict__ ib, int cb,
                  float* __restrict__ out_d, int* __restrict__ out_i, int q,
                  int k) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  float* sel_d = reinterpret_cast<float*>(smem + warp * 2 * k);
  int* sel_i = smem + warp * 2 * k + k;

  const size_t arow = static_cast<size_t>(row) * ca;
  const size_t brow = static_cast<size_t>(row) * cb;
  float d[P];
  int id[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + kWarp * p;
    if (j < ca) {
      d[p] = da[arow + j];
      id[p] = ia[arow + j];
    } else if (j < ca + cb) {
      d[p] = db[brow + (j - ca)];
      id[p] = ib[brow + (j - ca)];
    } else {
      d[p] = CUDART_INF_F;  // past the row's end: never selected as finite
      id[p] = INT_MAX;
    }
  }
  const int r = warp_select_rounds<P>(d, id, k, lane, sel_d, sel_i);
  const size_t orow = static_cast<size_t>(row) * k;
  store_selected(sel_d, sel_i, r, k, lane, out_d + orow, out_i + orow);
}

template <int P>
cudaError_t launch(const float* da, const int* ia, int ca, const float* db,
                   const int* ib, int cb, float* out_d, int* out_i, int q,
                   int k, cudaStream_t stream) {
  const int blocks = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(int) * kRowsPerBlock * 2 * k;
  merge_topk_kernel<P><<<blocks, kWarp * kRowsPerBlock, smem, stream>>>(
      da, ia, ca, db, ib, cb, out_d, out_i, q, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest row (ca + cb) one warp may hold: P = 16 elements per lane.
int merge_topk_max_row() { return kWarp * 16; }

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// a is (q, ca), b is (q, cb) (cb may be 0, b then unread), out (q, k);
// q > 0; 0 < ca + cb <= merge_topk_max_row(); 0 < k <= merge_topk_max_row()
// (the block's 8 * 2k selected pairs then fit in 32 KB of shared memory).
int merge_topk_f32(const void* da, const void* ia, int ca, const void* db,
                   const void* ib, int cb, void* out_d, void* out_i, int q,
                   int k, void* stream) {
  const int p = (ca + cb + kWarp - 1) / kWarp;
#define MT_CASE(PP)                                                          \
  case PP:                                                                   \
    return static_cast<int>(launch<PP>(                                      \
        static_cast<const float*>(da), static_cast<const int*>(ia), ca,      \
        static_cast<const float*>(db), static_cast<const int*>(ib), cb,      \
        static_cast<float*>(out_d), static_cast<int*>(out_i), q, k,          \
        static_cast<cudaStream_t>(stream)));
  switch (p) {
    MT_CASE(1) MT_CASE(2) MT_CASE(3) MT_CASE(4)
    MT_CASE(5) MT_CASE(6) MT_CASE(7) MT_CASE(8)
    MT_CASE(9) MT_CASE(10) MT_CASE(11) MT_CASE(12)
    MT_CASE(13) MT_CASE(14) MT_CASE(15) MT_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MT_CASE
}

}  // extern "C"
