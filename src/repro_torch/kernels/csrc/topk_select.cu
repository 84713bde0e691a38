// Per-row top-k smallest for Hopper: (Q, C) distances + ids -> (Q, k).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_select.py::topk_select
// (pl.pallas_call at topk_select.py:49): k rounds of masked row argmin,
// ascending (d2, id), lowest id on distance ties, then the lowest column,
// (inf, -1) once only +inf is left (repro/kernels/refine.py:56-88).  The
// order is total and the output holds only (d2, id), so any exact selection
// gives the same bits; this one is WarpSelect (Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs", 2017, section 4) over
// select_keys.cuh's 64-bit (d2, id) keys.
//
// Design: one warp per row, 8 rows (one Q_TILE) per block of 256 threads,
// through select_keys.cuh's warp_queue_select: a warp queue of the best
// W = 32 * N keys, W the ladder's first rung (32, 64, 128, 256) at or above
// min(k, C), fed by 32-wide slabs of the row through a threshold and a
// shared ring; lane L then writes output columns L, L + 32, ... from its
// queue registers (store_queue).  fused_scan.cu (B1) runs the same queue.
// Beyond the ladder (min(k, C) > 256) the launch keeps the rounds template:
// lane L holds columns L, L + 32, ... (P a lane, C <= 2048) and runs k
// rounds of warp_select.cuh's lexicographic (d2, id, column) warp argmin.
//
// Bound on an H100: memory.  Per row it reads C * 8 bytes and writes k * 8:
// at Q = 1,000,000, C = 288, k = 32 that is 2.56 GB, 0.76 ms at 3.35 TB/s.
// Each entry costs one key build and one 64-bit compare a lane; the flushes
// (15 + 1 + log2 W shuffle stages each) are few on random rows, and one a
// slab when every entry enters (rows in descending order).  The flushes'
// instructions are the cost above the bound, so a compare-exchange is one
// 64-bit compare and one select.  Registers: the queue's 2N and the U
// slabs' keys; up to W = 64 the launch bounds hold them to 32, so 64 warps
// fit on an SM.
//
// Wide template: C > 2048 goes to block_select.cuh's select_wide_kernel,
// one block of 256 threads a row: where the row's keys, padded to a power
// of two, fit in shared memory (C up to 16,384 on an H100) a block bitonic
// sort of them; beyond, or on a row holding a NaN, masked_argmin_rounds'
// rounds, reading the row from global memory on every pass.
#include "block_select.cuh"
#include "select_keys.cuh"

namespace {

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
  warp_queue_select<N>([&](int j) { return make_key(drow[j], irow[j]); }, c,
                       k, ring[warp], lane, wq);
  const size_t orow = static_cast<size_t>(row) * k;
  store_queue<N>(wq, k, lane, out_d + orow, out_i + orow);
}

// The rounds template, for min(k, C) beyond the queue ladder.
template <int P>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
topk_rounds_kernel(const float* __restrict__ d2, const int* __restrict__ ids,
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

template <int P>
cudaError_t launch_rounds(const Args& a) {
  const int blocks = (a.q + kRowsPerBlock - 1) / kRowsPerBlock;
  topk_rounds_kernel<P><<<blocks, kWarp * kRowsPerBlock, 0, a.stream>>>(
      a.d2, a.ids, a.out_d, a.out_i, a.q, a.c, a.k);
  return cudaGetLastError();
}

cudaError_t launch_ladder(const Args& a) {
  const int m = a.k < a.c ? a.k : a.c;
  if (m <= 32) return launch_queue<1>(a);
  if (m <= 64) return launch_queue<2>(a);
  if (m <= 128) return launch_queue<4>(a);
  if (m <= 256) return launch_queue<8>(a);
  const int need = (a.c + kWarp - 1) / kWarp;
#define TK_CASE(PP) \
  if (need <= PP) return launch_rounds<PP>(a);
  TK_CASE(9) TK_CASE(10) TK_CASE(11) TK_CASE(12) TK_CASE(14) TK_CASE(16)
  TK_CASE(20) TK_CASE(24) TK_CASE(28) TK_CASE(32) TK_CASE(40) TK_CASE(48)
  TK_CASE(56) TK_CASE(64)
#undef TK_CASE
  return cudaErrorInvalidValue;
}

// The widest row the narrow templates take (the rounds template's 64 keys
// a lane); a wider row takes the wide template.
constexpr int kNarrowWidth = kWarp * 64;

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// d2 / ids are (q, c), out (q, k); q > 0; c > 0; k > 0.  *wide is set to 1
// where the row took the wide template, else to 0.
int topk_select_f32(const void* d2, const void* ids, void* out_d, void* out_i,
                    int q, int c, int k, void* stream, int* wide) {
  if (c <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *wide = c > kNarrowWidth;
  if (*wide) {
    const float* dd = static_cast<const float*>(d2);
    const int* ii = static_cast<const int*>(ids);
    return static_cast<int>(launch_select_wide(
        dd, ii, c, dd, ii, 0, static_cast<float*>(out_d),
        static_cast<int*>(out_i), q, k, static_cast<cudaStream_t>(stream)));
  }
  const Args a{static_cast<const float*>(d2), static_cast<const int*>(ids),
               static_cast<float*>(out_d), static_cast<int*>(out_i), q, c, k,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_ladder(a));
}

}  // extern "C"
