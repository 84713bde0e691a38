// Fused distance + bucket k-selection radius for Hopper (paper Sec. 4.2.1).
//
// Replaces the Pallas TPU kernel repro/kernels/bucket_kselect.py::
// bucket_kselect (pl.pallas_call at bucket_kselect.py:84).  Every query of a
// (Q,) batch against one shared (C,) candidate window: d2 =
// fma(dx, dx, dy*dy) with dx = qx - px (+inf where the candidate is
// invalid), lo = min d2, hi = fma(max(max finite d2, lo), 1+1e-6, 1e-30),
// then `iters` rounds of a 32-bin histogram that narrow [lo, hi) around the
// k-th distance; the radius is the final upper edge, or +inf when the whole
// window holds fewer than k valid candidates.
//
// The rounds follow the port's rule (kernels/refine.py::bucket_refine_step,
// the same code as in fused_scan.cu): the bucket is chosen from the
// division-binned histogram, but the rank below it, and whether it holds the
// wanted element, are counted against its edges fma(sel, width, lo) and
// + width.  The reference takes that rank from the histogram, so an entry
// on an edge that the division bins below it is counted twice and its
// radius can fall under the k-th distance; there the port's radius differs
// from the reference's and keeps the guarantee
// count(valid & d2 < r) >= min(k, n_valid).
//
// Design: a block of 8 warps stages the window's px, py and valid into
// shared memory once (9 bytes per candidate, C <= 4096: at most 36 KB) and
// counts n_valid for the whole block; then each warp takes one query row at
// a time (rows grid-stride over a grid sized to fill the card).  Lanes walk
// the window with a stride of 32 and recompute d2 from shared memory in
// every pass with the same __fmaf_rn, so the bits never change; the 32 bins
// are the 32 lanes (shared-memory counters, then an inclusive shuffle scan).
// Every multiply, add and divide is an explicit round-to-nearest intrinsic
// and the build passes --fmad=false.
//
// Bound on an H100: operations.  The inputs and the (Q,) output are a few
// megabytes, but each (query, candidate) pair costs one distance (5 flops)
// and a bin (about 3 flops) in each of the `iters` rounds: at Q = 1,000,000,
// C = 2048, iters = 4 about 3.5e10 flops, 0.52 ms at 67 TFLOP/s (f32).  The
// design keeps the window on chip and never writes a distance; the passes
// over the window (one for lo / hi, two per round) are the cost above it.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // Q_TILE: one warp per row at a time
constexpr int kBins = 32;         // one histogram bin per lane
constexpr int kMaxWindow = 4096;  // 9 bytes each: 36 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ float dist2(const float* px, const float* py,
                                       const unsigned char* v, int j, float fx,
                                       float fy) {
  if (!v[j]) return CUDART_INF_F;
  const float dx = __fsub_rn(fx, px[j]);
  const float dy = __fsub_rn(fy, py[j]);
  return __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
bucket_kselect_kernel(const float* __restrict__ qx,
                      const float* __restrict__ qy,
                      const float* __restrict__ px,
                      const float* __restrict__ py,
                      const bool* __restrict__ valid, float* __restrict__ out,
                      int q, int c, int k, int iters, float hi_mul,
                      float hi_add, float tiny) {
  extern __shared__ float smem[];
  __shared__ int hist_all[kRowsPerBlock][kBins];
  float* spx = smem;
  float* spy = smem + c;
  unsigned char* sv = reinterpret_cast<unsigned char*>(smem + 2 * c);

  // ---- stage the shared window; n_valid is one block-wide count.
  int n_valid = 0;
  for (int base = 0; base < c; base += blockDim.x) {
    const int j = base + threadIdx.x;
    bool v = false;
    if (j < c) {
      spx[j] = px[j];
      spy[j] = py[j];
      v = valid[j];
      sv[j] = v;
    }
    n_valid += __syncthreads_count(v);  // also the staging barrier
  }

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int* hist = hist_all[warp];
  const float inf = CUDART_INF_F;
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < q;
       row += gridDim.x * kRowsPerBlock) {
    const float fx = qx[row];
    const float fy = qy[row];

    // ---- lo, hi.
    float lo = inf;
    float hi0 = -inf;
    for (int j = lane; j < c; j += kWarp) {
      const float x = dist2(spx, spy, sv, j, fx, fy);
      lo = fminf(lo, x);
      if (!isinf(x)) hi0 = fmaxf(hi0, x);
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
      const float width = nan_max(
          __fdiv_rn(__fsub_rn(fhi, flo), static_cast<float>(kBins)), tiny);
      hist[lane] = 0;
      __syncwarp();
      for (int j = lane; j < c; j += kWarp) {
        const float x = dist2(spx, spy, sv, j, fx, fy);
        if (x >= flo && x < fhi) {
          float b = floorf(__fdiv_rn(__fsub_rn(x, flo), width));
          b = fminf(fmaxf(b, 0.0f), static_cast<float>(kBins - 1));  // NaN->0
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
      // element, are counted against its edges (see the header).
      int below = 0;
      int inside = 0;
      for (int j = lane; j < c; j += kWarp) {
        const float x = dist2(spx, spy, sv, j, fx, fy);
        below += (x >= flo && x < new_lo) ? 1 : 0;
        inside += (x >= new_lo && x < new_hi) ? 1 : 0;
      }
      below = warp_sum(below);
      inside = warp_sum(inside);
      if (below < kth && below + inside >= kth) {
        flo = new_lo;
        fhi = new_hi;
        kth -= below;
      }
    }
    if (lane == 0) out[row] = n_valid < k ? inf : fhi;
  }
}

}  // namespace

extern "C" {

// Largest shared window the kernel stages.
int bucket_kselect_max_window() { return kMaxWindow; }

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// qx / qy / out are (q,), px / py / valid (c,); q > 0;
// 0 < c <= bucket_kselect_max_window(); k > 0, iters >= 0.
int bucket_kselect_f32(const void* qx, const void* qy, const void* px,
                       const void* py, const void* valid, void* out, int q,
                       int c, int k, int iters, float hi_mul, float hi_add,
                       float tiny, void* stream) {
  if (q <= 0 || c <= 0 || c > kMaxWindow || k <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(c) * (2 * sizeof(float) + 1);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bucket_kselect_kernel, kWarp * kRowsPerBlock, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (q + kRowsPerBlock - 1) / kRowsPerBlock;
  const int fill = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = tiles < fill ? tiles : fill;
  bucket_kselect_kernel<<<blocks, kWarp * kRowsPerBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qx), static_cast<const float*>(qy),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const bool*>(valid), static_cast<float*>(out), q, c, k,
      iters, hi_mul, hi_add, tiny);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
