// Fused SCAN-step merge for Hopper: distance + bucket radius + top-k rounds.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_scan.py::fused_scan_merge
// (pl.pallas_call at fused_scan.py:126).  Per query row it computes the d2 of
// a W-wide gathered candidate window (invalid entries +inf), appends it to the
// row's current ascending (k) list, narrows the k-th distance with `iters`
// rounds of a 32-bin histogram, prunes at fhi + max(fhi - flo, fhi*1e-6 +
// 1e-30) (+inf when fewer than k entries are finite), and emits the k smallest
// (d2, id) pairs ascending, lowest id on ties, (inf, -1) padded.
//
// Under precision="mixed" (the template flag MIXED; the reference's branch at
// fused_scan.py:52) a valid window entry is first kept only if its bf16
// distance, each operation rounded once (__hmul, __hadd on __nv_bfloat16
// from the bf16-rounded f32 deltas), is <= best_d[k-1] * MIXED_WIDEN; a
// dropped entry is +inf from then on, so it leaves the refinement population
// and n_valid as well.  The prefilter is conservative, so the merged lists
// equal fp32's bit for bit.
//
// Design: one warp per query row, 8 rows (one Q_TILE) per block of 256
// threads.  Lane L holds elements L, L+32, L+64, ... of the (k + W) row in
// registers (P of them, a template parameter).  n_valid is a ballot count;
// lo / hi0 are warp reductions; the 32 histogram bins are the 32 lanes (a
// per-warp shared counter array, then an inclusive shuffle scan); each of the
// k rounds is a lexicographic (d2, id, column) warp argmin after which the
// owning lane masks its entry.
//
// Bound on an H100: memory.  Per row the kernel reads W*13 + k*8 + 8 bytes
// and writes k*8 (about 3.6 KB + 0.26 KB at W=256, k=32); its arithmetic is
// a few thousand simple operations per row, far below the card's rate.  The
// design reads each input once, with neighbouring lanes on neighbouring
// addresses, and keeps the distance row, histogram and selection state in
// registers and shared memory, so only the window in and the lists out cross
// device memory.
//
// Bitwise contract: equal to the plain PyTorch version
// (repro_torch/kernels/fused_scan.py::fused_scan_merge_ref).  Its outputs are
// the exact k smallest, so they equal the JAX reference's wherever that is
// right; the refinement counts ranks against the bucket edges, where the
// reference's histogram rank can lose the k-th entry (kernels/refine.py,
// bucket_refine_step).  Every site the reference's compiled program
// contracts is an explicit __fmaf_rn; every other multiply, add and divide
// is an explicit round-to-nearest intrinsic, and the build passes
// --fmad=false.  jnp.maximum propagates NaN, so nan_max does too.
#include <cuda_bf16.h>

#include "warp_select.cuh"

namespace {

constexpr int kBins = 32;  // one histogram bin per lane

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

template <int P, bool MIXED>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
fused_scan_merge_kernel(const float* __restrict__ qx,
                        const float* __restrict__ qy,
                        const float* __restrict__ cx,
                        const float* __restrict__ cy,
                        const int* __restrict__ cids,
                        const bool* __restrict__ valid,
                        const float* __restrict__ best_d,
                        const int* __restrict__ best_i,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int q, int w, int k, int iters, float hi_mul,
                        float hi_add, float slop_mul, float tiny,
                        float widen) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together
  int* hist = smem + warp * (kBins + 2 * k);
  float* sel_d = reinterpret_cast<float*>(hist + kBins);
  int* sel_i = hist + kBins + k;

  const int n = k + w;
  const float inf = CUDART_INF_F;
  const float fx = qx[row];
  const float fy = qy[row];
  const size_t brow = static_cast<size_t>(row) * k;
  const size_t wrow = static_cast<size_t>(row) * w;
  // the mixed prefilter's widened k-th boundary (+inf keeps every entry)
  const float kth_wide = MIXED ? __fmul_rn(best_d[brow + k - 1], widen) : inf;

  // ---- the (k + W) row: current list, then the window's distances.
  float d[P];
  int id[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + kWarp * p;
    if (j < k) {
      d[p] = best_d[brow + j];
      id[p] = best_i[brow + j];
    } else if (j < n) {
      const size_t o = wrow + (j - k);
      id[p] = cids[o];
      d[p] = inf;
      if (valid[o]) {
        const float dx = __fsub_rn(cx[o], fx);
        const float dy = __fsub_rn(cy[o], fy);
        bool keep = true;
        if (MIXED) {
          const __nv_bfloat16 xb = __float2bfloat16_rn(dx);
          const __nv_bfloat16 yb = __float2bfloat16_rn(dy);
          const float d2b =
              __bfloat162float(__hadd(__hmul(xb, xb), __hmul(yb, yb)));
          keep = d2b <= kth_wide;
        }
        if (keep) d[p] = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
      }
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
    lo = fminf(lo, d[p]);
    if (fin) hi0 = fmaxf(hi0, d[p]);
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi0 = fmaxf(hi0, __shfl_xor_sync(kFull, hi0, o));
  }
  float flo = lo;
  float fhi = __fmaf_rn(nan_max(hi0, lo), hi_mul, hi_add);
  int kth = k;

  // ---- bucket refinement of the k-th distance.
  for (int it = 0; it < iters; ++it) {
    const float width =
        nan_max(__fdiv_rn(__fsub_rn(fhi, flo), static_cast<float>(kBins)), tiny);
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

  // ---- prune at the conservative radius.
  const float slop = nan_max(__fsub_rn(fhi, flo), __fmaf_rn(fhi, slop_mul, tiny));
  const float radius = n_valid < k ? inf : __fadd_rn(fhi, slop);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!(d[p] < radius)) d[p] = inf;
  }

  // ---- k rounds of lexicographic warp argmin.
  const int r = warp_select_rounds<P>(d, id, k, lane, sel_d, sel_i);
  store_selected(sel_d, sel_i, r, k, lane, out_d + brow, out_i + brow);
}

template <int P>
cudaError_t launch(const float* qx, const float* qy, const float* cx,
                   const float* cy, const int* cids, const bool* valid,
                   const float* best_d, const int* best_i, float* out_d,
                   int* out_i, int q, int w, int k, int iters, bool mixed,
                   float hi_mul, float hi_add, float slop_mul, float tiny,
                   float widen, cudaStream_t stream) {
  const int blocks = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = sizeof(int) * kRowsPerBlock * (kBins + 2 * k);
  auto kernel = mixed ? fused_scan_merge_kernel<P, true>
                      : fused_scan_merge_kernel<P, false>;
  kernel<<<blocks, kWarp * kRowsPerBlock, smem, stream>>>(
      qx, qy, cx, cy, cids, valid, best_d, best_i, out_d, out_i, q, w, k,
      iters, hi_mul, hi_add, slop_mul, tiny, widen);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k + W one row may hold: P = 16 elements per lane.
int fused_scan_merge_max_row() { return kWarp * 16; }

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// q, w, k, iters > 0; k + w <= fused_scan_merge_max_row(); mixed != 0 runs
// the bf16 prefilter with the widening factor `widen`.
int fused_scan_merge_f32(const void* qx, const void* qy, const void* cx,
                         const void* cy, const void* cids, const void* valid,
                         const void* best_d, const void* best_i, void* out_d,
                         void* out_i, int q, int w, int k, int iters,
                         int mixed, float hi_mul, float hi_add, float slop_mul,
                         float tiny, float widen, void* stream) {
  const int p = (k + w + kWarp - 1) / kWarp;
#define FSM_CASE(PP)                                                         \
  case PP:                                                                   \
    return static_cast<int>(launch<PP>(                                      \
        static_cast<const float*>(qx), static_cast<const float*>(qy),        \
        static_cast<const float*>(cx), static_cast<const float*>(cy),        \
        static_cast<const int*>(cids), static_cast<const bool*>(valid),      \
        static_cast<const float*>(best_d), static_cast<const int*>(best_i),  \
        static_cast<float*>(out_d), static_cast<int*>(out_i), q, w, k,       \
        iters, mixed != 0, hi_mul, hi_add, slop_mul, tiny, widen,            \
        static_cast<cudaStream_t>(stream)));
  switch (p) {
    FSM_CASE(1) FSM_CASE(2) FSM_CASE(3) FSM_CASE(4)
    FSM_CASE(5) FSM_CASE(6) FSM_CASE(7) FSM_CASE(8)
    FSM_CASE(9) FSM_CASE(10) FSM_CASE(11) FSM_CASE(12)
    FSM_CASE(13) FSM_CASE(14) FSM_CASE(15) FSM_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FSM_CASE
}

}  // extern "C"
