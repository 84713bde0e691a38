// Warp-wide selection rounds shared by the port's Hopper kernels.
//
// One warp holds one row: lane L holds columns L, L+32, L+64, ... in
// registers (P of them).  Each round takes the lexicographic (d2, id,
// column) minimum of the row with a 5-step shuffle butterfly, records it,
// and the owning lane masks its entry to +inf.  Rounds stop at the first
// +inf minimum: everything after it pads with (inf, -1); a -inf minimum
// leaves as (-inf, -1).  This is the
// reference's masked_argmin_rounds (repro/kernels/refine.py:56-88): lowest
// id on distance ties, then the lowest column.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // Q_TILE: one warp per row
constexpr unsigned kFull = 0xffffffffu;

// Lexicographic (d2, id, column) order of the selection rounds.
__device__ __forceinline__ bool lex_less(float d1, int i1, int c1, float d2,
                                         int i2, int c2) {
  if (d1 != d2) return d1 < d2;
  if (i1 != i2) return i1 < i2;
  return c1 < c2;
}

// k selection rounds over the warp's row; lane 0 writes round r's pair to
// sel_d[r] / sel_i[r] (the output row itself, in B1 and B4).  Returns the number of finite pairs selected.
template <int P>
__device__ __forceinline__ int warp_select_rounds(float (&d)[P],
                                                  const int (&id)[P], int k,
                                                  int lane, float* sel_d,
                                                  int* sel_i) {
  const float inf = CUDART_INF_F;
  int r = 0;
  for (; r < k; ++r) {
    float bd = inf;
    int bi = INT_MAX;
    int bc = INT_MAX;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int col = lane + kWarp * p;
      if (lex_less(d[p], id[p], col, bd, bi, bc)) {
        bd = d[p];
        bi = id[p];
        bc = col;
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      const float od = __shfl_xor_sync(kFull, bd, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      const int oc = __shfl_xor_sync(kFull, bc, o);
      if (lex_less(od, oi, oc, bd, bi, bc)) {
        bd = od;
        bi = oi;
        bc = oc;
      }
    }
    if (bd == inf) break;  // only +inf left: the rest pads with (inf, -1)
    if (lane == 0) {
      sel_d[r] = bd;
      sel_i[r] = isinf(bd) ? -1 : bi;  // -inf leaves with id -1
    }
    if (bc % kWarp == lane) {
      const int owner = bc / kWarp;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p == owner) d[p] = inf;
      }
    }
  }
  return r;
}

}  // namespace
