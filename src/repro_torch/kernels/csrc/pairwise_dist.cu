// Masked squared-L2 distance tile for Hopper: (Q,) queries x (C,) -> (Q, C).
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_dist.py::pairwise_dist
// (pl.pallas_call at pairwise_dist.py:53).  out[i, j] is
// fma(dx, dx, dy*dy) with dx = qx[i] - px[j], dy = qy[i] - py[j], or +inf
// where valid[j] is false: the form the reference's compiled kernel computes
// (its `dx*dx + dy*dy` is contracted into one fma), spelled __fmaf_rn with
// the build's --fmad=false, so no other contraction happens.
//
// Design: a thread owns four neighbouring columns (one 16-byte float4 of px,
// of py and four valid bytes, loaded once) and walks eight query rows,
// storing one float4 per row; neighbouring threads store neighbouring 16
// bytes of the same row, so every warp writes 512 contiguous bytes.  The
// grid is (C/4/256, Q/8) blocks of 256 threads; rows past 65535 * 8 loop.
// The stores use the streaming hint (__stcs): the tile is far larger than
// the 50 MB L2 and is not read again by this kernel.
//
// Bound on an H100: memory.  Per call it writes Q*C*4 bytes and reads
// C*9 + Q*8; at Q = 2048, C = 1,000,064 that is 8.19 GB, about 2.45 ms at
// 3.35 TB/s.  Five flops per entry are far below the card's rate.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // Q_TILE

__device__ __forceinline__ float dist2(float fx, float fy, float x, float y,
                                       unsigned char v) {
  const float dx = __fsub_rn(fx, x);
  const float dy = __fsub_rn(fy, y);
  return v ? __fmaf_rn(dx, dx, __fmul_rn(dy, dy)) : CUDART_INF_F;
}

__global__ void __launch_bounds__(kThreads)
pairwise_dist_kernel(const float* __restrict__ qx,
                     const float* __restrict__ qy,
                     const float4* __restrict__ px,
                     const float4* __restrict__ py,
                     const uchar4* __restrict__ valid,
                     float* __restrict__ out, int q, int c) {
  const int c4 = c / 4;
  const int j4 = blockIdx.x * kThreads + threadIdx.x;
  if (j4 >= c4) return;
  const float4 x = px[j4];
  const float4 y = py[j4];
  const uchar4 v = valid[j4];
  for (int row0 = blockIdx.y * kRows; row0 < q; row0 += gridDim.y * kRows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const float fx = qx[row];
      const float fy = qy[row];
      float4 o;
      o.x = dist2(fx, fy, x.x, y.x, v.x);
      o.y = dist2(fx, fy, x.y, y.y, v.y);
      o.z = dist2(fx, fy, x.z, y.z, v.z);
      o.w = dist2(fx, fy, x.w, y.w, v.w);
      __stcs(reinterpret_cast<float4*>(out + static_cast<size_t>(row) * c) +
                 j4,
             o);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// px, py and out 16-byte aligned, valid 4-byte aligned; q > 0 a multiple of
// 8, c > 0 a multiple of 4 (the wrapper pads c to 128).
int pairwise_dist_f32(const void* qx, const void* qy, const void* px,
                      const void* py, const void* valid, void* out, int q,
                      int c, void* stream) {
  if (q % kRows != 0 || c % 4 != 0) return cudaErrorInvalidValue;
  const int c4 = c / 4;
  const int rows = q / kRows;
  const dim3 grid((c4 + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
  pairwise_dist_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qx), static_cast<const float*>(qy),
      static_cast<const float4*>(px), static_cast<const float4*>(py),
      static_cast<const uchar4*>(valid), static_cast<float*>(out), q, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
