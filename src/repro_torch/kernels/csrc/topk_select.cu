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
// Design: one warp per row, 8 rows (one Q_TILE) per block of 256 threads.
// - The warp queue holds the best W = 32 * N keys seen so far, ascending,
//   register-major (N keys a lane); W is the ladder's first rung (32, 64,
//   128, 256) at or above min(k, C).  The first W columns fill it, and one
//   warp bitonic sort orders them.
// - The rest of the row streams in coalesced 32-wide slabs, U slabs loaded
//   before any is used.  The queue's min(k, W)-th key is a threshold held
//   by every lane; a key enters only if it is below it.  An equal key is an
//   exact duplicate of a kept pair, so dropping it changes no output.
// - Entrants wait in a ring of 64 keys a warp in shared memory, filled in
//   slab order through a ballot prefix, until 32 of them are there.  A
//   flush bitonic-sorts those 32 and merges them into the queue
//   (warp_merge32), then refreshes the threshold; the last flush follows
//   the last slab.
// - Lane L writes output columns L, L + 32, ... from its queue registers:
//   coalesced, (inf, -1) past the queue and wherever the key's d2 is +inf.
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
#include "select_keys.cuh"
#include "warp_select.cuh"

namespace {

constexpr int kSlabs = 4;  // U: slabs loaded before any is used

template <int N>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock, N <= 2 ? 8 : 4)
topk_queue_kernel(const float* __restrict__ d2, const int* __restrict__ ids,
                  float* __restrict__ out_d, int* __restrict__ out_i, int q,
                  int c, int k) {
  __shared__ Key ring[kRowsPerBlock][64];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  const float* drow = d2 + static_cast<size_t>(row) * c;
  const int* irow = ids + static_cast<size_t>(row) * c;

  Key wq[N];  // the warp queue
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int j = kWarp * r + lane;
    wq[r] = j < c ? make_key(drow[j], irow[j]) : kNoKey;
  }
  warp_sort<N>(wq, lane);
  const int kth = min(k, kWarp * N) - 1;
  Key thr = warp_key_at<N>(wq, kth);

  int held = 0;  // keys in the ring
  int head = 0;  // the ring's first key
  for (int base = kWarp * N; base < c; base += kWarp * kSlabs) {
    Key x[kSlabs];
#pragma unroll
    for (int u = 0; u < kSlabs; ++u) {
      const int j = base + kWarp * u + lane;
      x[u] = j < c ? make_key(drow[j], irow[j]) : kNoKey;
    }
#pragma unroll
    for (int u = 0; u < kSlabs; ++u) {
      const bool take = x[u] < thr;
      const unsigned m = __ballot_sync(kFull, take);
      if (m == 0) continue;
      if (take) {
        const int at = head + held + __popc(m & ((1u << lane) - 1u));
        ring[warp][at & 63] = x[u];
      }
      held += __popc(m);
      if (held < kWarp) continue;
      __syncwarp();
      Key col[1] = {ring[warp][(head + lane) & 63]};
      __syncwarp();  // read before the next slab may refill the slot
      head = (head + kWarp) & 63;
      held -= kWarp;
      warp_sort<1>(col, lane);
      warp_merge32<N>(wq, col[0], lane);
      thr = warp_key_at<N>(wq, kth);
    }
  }
  if (held > 0) {  // the last flush
    __syncwarp();
    Key col[1] = {lane < held ? ring[warp][(head + lane) & 63] : kNoKey};
    warp_sort<1>(col, lane);
    warp_merge32<N>(wq, col[0], lane);
  }

  const size_t orow = static_cast<size_t>(row) * k;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int j = kWarp * r + lane;
    if (j < k) key_pair(wq[r], out_d[orow + j], out_i[orow + j]);
  }
  for (int j = kWarp * N + lane; j < k; j += kWarp) {
    out_d[orow + j] = CUDART_INF_F;
    out_i[orow + j] = -1;
  }
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

}  // namespace

extern "C" {

// Widest row the kernel takes (the rounds template's 64 keys a lane).
int topk_select_max_width() { return kWarp * 64; }

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// d2 / ids are (q, c), out (q, k); q > 0; 0 < c <= topk_select_max_width();
// k > 0.
int topk_select_f32(const void* d2, const void* ids, void* out_d, void* out_i,
                    int q, int c, int k, void* stream) {
  if (c <= 0 || k <= 0 || c > topk_select_max_width())
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(d2), static_cast<const int*>(ids),
               static_cast<float*>(out_d), static_cast<int*>(out_i), q, c, k,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_ladder(a));
}

}  // extern "C"
