// Per-row top-k smallest for Hopper: (Q, C) distances + ids -> (Q, k).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_select.py::topk_select
// (pl.pallas_call at topk_select.py:49): k rounds of masked row argmin,
// ascending (d2, id), lowest id on distance ties, then the lowest column,
// (inf, -1) once only +inf is left (repro/kernels/refine.py:56-88).
//
// Design: one warp per row, 8 rows (one Q_TILE) per block of 256 threads.
// Lane L holds columns L, L+32, ... of the row in registers (P of them, a
// template parameter taken from a ladder up to 64, so C <= 2048); the rounds
// are warp_select.cuh's lexicographic warp argmin, the same as in
// fused_scan.cu and merge_topk.cu.  Lane 0 writes each round's pair straight
// to the output row, and the lanes pad the rest with (inf, -1).  There is no
// float arithmetic, only comparisons, so no rounding hazard.
//
// Bound on an H100: memory or the rounds, by width.  Per row it reads C * 8
// bytes and writes k * 8; the rounds make at most k * C comparisons.  At
// Q = 1,000,000, C = 288, k = 32 the bytes (2.56 GB, 0.76 ms at 3.35 TB/s)
// bound it; at C = 2048 each row costs up to 32 rounds of 64 comparisons
// and a 5-step shuffle butterfly per lane.
#include "warp_select.cuh"

namespace {

template <int P>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
topk_select_kernel(const float* __restrict__ d2, const int* __restrict__ ids,
                   float* __restrict__ out_d, int* __restrict__ out_i, int q,
                   int c, int k) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  const size_t irow = static_cast<size_t>(row) * c;
  float d[P];
  int id[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + kWarp * p;
    if (j < c) {
      d[p] = d2[irow + j];
      id[p] = ids[irow + j];
    } else {
      d[p] = CUDART_INF_F;  // past the row's end: never selected as finite
      id[p] = INT_MAX;
    }
  }
  const size_t orow = static_cast<size_t>(row) * k;
  const int r =
      warp_select_rounds<P>(d, id, k, lane, out_d + orow, out_i + orow);
  for (int j = r + lane; j < k; j += kWarp) {
    out_d[orow + j] = CUDART_INF_F;
    out_i[orow + j] = -1;
  }
}

template <int P>
cudaError_t launch(const float* d2, const int* ids, float* out_d, int* out_i,
                   int q, int c, int k, cudaStream_t stream) {
  const int blocks = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  topk_select_kernel<P><<<blocks, kWarp * kRowsPerBlock, 0, stream>>>(
      d2, ids, out_d, out_i, q, c, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest row one warp may hold: P = 64 elements per lane.
int topk_select_max_width() { return kWarp * 64; }

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// d2 / ids are (q, c), out (q, k); q > 0; 0 < c <= topk_select_max_width();
// k > 0.
int topk_select_f32(const void* d2, const void* ids, void* out_d, void* out_i,
                    int q, int c, int k, void* stream) {
  const int need = (c + kWarp - 1) / kWarp;
#define TK_CASE(PP)                                                          \
  if (need <= PP)                                                            \
    return static_cast<int>(launch<PP>(                                      \
        static_cast<const float*>(d2), static_cast<const int*>(ids),         \
        static_cast<float*>(out_d), static_cast<int*>(out_i), q, c, k,       \
        static_cast<cudaStream_t>(stream)));
  if (c <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  TK_CASE(1) TK_CASE(2) TK_CASE(3) TK_CASE(4) TK_CASE(5) TK_CASE(6)
  TK_CASE(7) TK_CASE(8) TK_CASE(9) TK_CASE(10) TK_CASE(11) TK_CASE(12)
  TK_CASE(14) TK_CASE(16) TK_CASE(20) TK_CASE(24) TK_CASE(28) TK_CASE(32)
  TK_CASE(40) TK_CASE(48) TK_CASE(56) TK_CASE(64)
#undef TK_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
