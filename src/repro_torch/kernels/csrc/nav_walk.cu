// Bounded navigation of one sweep pass for Hopper: one thread a row.
//
// Replaces no Pallas kernel.  It is the body of the reference's navigation
// loops, which XLA compiles in line: the `nav_body` lax.fori_loop of
// max_nav steps (src/repro/core/pipeline.py:281) and, inside each step, the
// `try_level` lax.fori_loop over the jump levels (pipeline.py:158).  In the
// port these were kernels/nav_walk.py::nav_walk_ref, about 150 eager PyTorch
// operations a step on (rows,) and (rows, l_max) int64 intermediates, each
// launched from the host: the card's work per launch was tiny and the host's
// dispatch set the pace.
//
// Per row, up to max_nav steps, bit for bit as nav_walk_ref:
// - the direction: go right while the right side is active and it is its
//   turn (or the left side is not active); the cursor is cr or cl;
// - exhausted (cursor at or past the domain's end in that direction): the
//   direction goes inactive, nothing else changes;
// - else the leaf beside the cursor (cprobe, leaf_level, its aligned key and
//   span, s and e from starts) is found when it holds objects and its box
//   lies within the row's k-th distance (`<=` kth2): the row schedules it,
//   its cursor steps over it, the next turn goes the other way;
// - else the cursor jumps over the largest aligned block at a level a in
//   max(a0, 1)..l_max that lies in the domain and is empty, or lies strictly
//   beyond the k-th distance (`>` kth2); over the leaf's own span (level a0)
//   when no such block exists.  Levels are tried from the top down and the
//   first admissible one wins, which is the plain version's largest; a level
//   above the cursor's alignment (its trailing zero bits) is never
//   admissible, so the walk starts at the highest aligned one.  The
//   pyramid's count is read first; the distance is computed only for a
//   block that is not empty.
// A row stops at its first found leaf or when both directions are
// inactive: the plain loop's later steps change nothing for such a row.
// Every table index is clamped as in the plain version, and the int32
// cursor arithmetic wraps as PyTorch's does.  The distances are
// core/morton.py's block_box and point_to_block_dist2 in registers: the
// same bit compaction of the code, cellw = side / 2^l_max, x0 =
// __fmaf_rn(cx, cellw, ox), x1 = x0 + span * cellw, the clamps of
// torch.maximum with its NaN propagation (fmaxf would drop a NaN), d2 =
// __fmaf_rn(dy, dy, dx * dx), under the build's --fmad=false.  A NaN
// distance or kth2 compares false both ways, as on the plain path.
// origin and side are read from their device tensors: no host read.
//
// Bound on an H100: memory and dependent L2 probes.  A navigating row reads
// 31 bytes (qx, qy, kth2, cl, cr, s, e, three flags) and writes 20 (cl, cr,
// s, e, three flags, found): 51 MB at 1M rows, 15.2 us at 3.35 TB/s.  The
// tables it probes (leaf_level and starts, 4^l_max entries each, and the
// pyramid) stay in the 50 MB L2 at the main path's l_max = 8 (256 KB,
// 256 KB, 350 KB), and each step's probes depend on the step before.
// Design: the row's whole state lives in registers across the steps, so no
// intermediate reaches device memory; one launch a pass replaces the plain
// loop's thousands; neighbouring threads take neighbouring rows, so the
// state's loads and stores are coalesced; the probes go through the
// read-only cache, and a block of 256 threads gives each SM enough warps
// to hide the probes' latency behind one another.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// core/morton.py::compact1by1 on the code's low 32 bits
__device__ __forceinline__ unsigned compact1by1(unsigned v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

// torch.maximum: NaN when either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Geometry {
  float ox, oy, cellw;
};

// core/morton.py::point_to_block_dist2 of the aligned block [code, code +
// 4^a): squared distance from (px, py) to its box
__device__ __forceinline__ float block_dist2(float px, float py, int code,
                                             int a, const Geometry& g) {
  const unsigned z = static_cast<unsigned>(code);
  const float cx = static_cast<float>(compact1by1(z));
  const float cy = static_cast<float>(compact1by1(z >> 1));
  const float ext = static_cast<float>(1 << a) * g.cellw;
  const float x0 = __fmaf_rn(cx, g.cellw, g.ox);
  const float y0 = __fmaf_rn(cy, g.cellw, g.oy);
  const float x1 = x0 + ext;
  const float y1 = y0 + ext;
  const float dx = nan_max(nan_max(x0 - px, px - x1), 0.0f);
  const float dy = nan_max(nan_max(y0 - py, py - y1), 0.0f);
  return __fmaf_rn(dy, dy, dx * dx);
}

struct Tables {
  const int* __restrict__ leaf_level;  // (4^l_max,)
  const int* __restrict__ starts;      // (4^l_max + 1,)
  const int* __restrict__ pyramid;     // (pyr_n,)
  const float* __restrict__ origin;    // (2,)
  const float* __restrict__ side;      // ()
  int l_max, pyr_n;
};

struct Rows {
  const float* __restrict__ qx;
  const float* __restrict__ qy;
  const float* __restrict__ kth2;
  const int* __restrict__ cl;
  const int* __restrict__ cr;
  const bool* __restrict__ act_l;
  const bool* __restrict__ act_r;
  const bool* __restrict__ next_right;
  const int* __restrict__ s;
  const int* __restrict__ e;
};

struct Out {
  int* __restrict__ cl;
  int* __restrict__ cr;
  bool* __restrict__ act_l;
  bool* __restrict__ act_r;
  bool* __restrict__ next_right;
  int* __restrict__ s;
  int* __restrict__ e;
  bool* __restrict__ found;
};

__global__ void __launch_bounds__(kThreads)
nav_walk_kernel(Rows in, Tables t, Out out, int n, int max_nav) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int l_max = t.l_max;
  const int n_fine = 1 << (2 * l_max);
  const Geometry g{__ldg(t.origin), __ldg(t.origin + 1),
                   __ldg(t.side) / static_cast<float>(1 << l_max)};
  const float px = in.qx[i];
  const float py = in.qy[i];
  const float kth2 = in.kth2[i];
  int cl = in.cl[i];
  int cr = in.cr[i];
  int s_cur = in.s[i];
  int e_cur = in.e[i];
  bool act_l = in.act_l[i];
  bool act_r = in.act_r[i];
  bool next_right = in.next_right[i];
  bool found_any = false;

  for (int step = 0; step < max_nav; ++step) {
    // not pending: the plain loop's remaining steps change nothing.  A
    // pending row always runs (pending implies act_r or act_l).
    if (found_any || !(act_l || act_r)) break;
    const bool right = act_r && (next_right || !act_l);
    const int cursor = right ? cr : cl;
    if (right ? cursor >= n_fine : cursor <= 0) {
      // exhausted: this direction goes inactive, the cursor stays
      if (right) {
        act_r = false;
      } else {
        act_l = false;
      }
      continue;
    }
    const int cprobe = clamp(right ? cursor : wrap_sub(cursor, 1), 0,
                             n_fine - 1);
    const int a0 = l_max - __ldg(t.leaf_level + cprobe);
    const int span0 = 1 << (2 * a0);
    const int leaf_key = right ? cprobe : (cprobe >> (2 * a0)) << (2 * a0);
    const int s = __ldg(t.starts + clamp(leaf_key, 0, n_fine - 1));
    const int e = __ldg(t.starts + clamp(wrap_add(leaf_key, span0), 0,
                                         n_fine));
    int jump;
    if (wrap_sub(e, s) > 0 && block_dist2(px, py, leaf_key, a0, g) <= kth2) {
      jump = span0;
      s_cur = s;
      e_cur = e;
      next_right = !right;  // alternate while both directions remain
      found_any = true;
    } else {
      int best = a0;
      // the highest level the cursor is aligned to: 4^a divides it
      const int top = cursor == 0 ? l_max
                                  : min(l_max, (__ffs(cursor) - 1) >> 1);
      const int low = a0 > 1 ? a0 : 1;
      for (int a = top; a >= low; --a) {
        const int blk = 1 << (2 * a);
        const bool in_dom = right ? wrap_add(cursor, blk) <= n_fine
                                  : wrap_sub(cursor, blk) >= 0;
        if (!in_dom) continue;
        const int lvl_off = ((1 << (2 * (l_max - a))) - 1) / 3;
        const int pidx = right ? cursor >> (2 * a)
                               : (cursor >> (2 * a)) - 1;
        bool ok = __ldg(t.pyramid +
                        clamp(wrap_add(lvl_off, pidx), 0, t.pyr_n - 1)) == 0;
        if (!ok) {
          const int code = right ? cursor : wrap_sub(cursor, blk);
          ok = block_dist2(px, py, code, a, g) > kth2;  // strict
        }
        if (ok) {
          best = a;
          break;
        }
      }
      jump = 1 << (2 * best);
    }
    if (right) {
      cr = wrap_add(cursor, jump);
    } else {
      cl = wrap_sub(cursor, jump);
    }
  }

  out.cl[i] = cl;
  out.cr[i] = cr;
  out.act_l[i] = act_l;
  out.act_r[i] = act_r;
  out.next_right[i] = next_right;
  out.s[i] = s_cur;
  out.e[i] = e_cur;
  out.found[i] = found_any;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers:
// rows[10] are qx, qy, kth2 (f32), cl, cr (i32), act_l, act_r, next_right
// (bool), s, e (i32), each (n,); tables[5] are leaf_level, starts, pyramid
// (i32), origin (2,) and side () (f32); outs[8] are cl, cr, act_l, act_r,
// next_right, s, e, found, each (n,).  0 <= l_max <= 15, every leaf level in
// [0, l_max], pyr_n the pyramid's length, n >= 0, max_nav >= 0.
int nav_walk_launch(void* const* rows, void* const* tables, void* const* outs,
                    int n, int l_max, int pyr_n, int max_nav, void* stream) {
  if (n < 0 || l_max < 0 || l_max > 15 || pyr_n <= 0 || max_nav < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Rows in{static_cast<const float*>(rows[0]),
                static_cast<const float*>(rows[1]),
                static_cast<const float*>(rows[2]),
                static_cast<const int*>(rows[3]),
                static_cast<const int*>(rows[4]),
                static_cast<const bool*>(rows[5]),
                static_cast<const bool*>(rows[6]),
                static_cast<const bool*>(rows[7]),
                static_cast<const int*>(rows[8]),
                static_cast<const int*>(rows[9])};
  const Tables t{static_cast<const int*>(tables[0]),
                 static_cast<const int*>(tables[1]),
                 static_cast<const int*>(tables[2]),
                 static_cast<const float*>(tables[3]),
                 static_cast<const float*>(tables[4]), l_max, pyr_n};
  const Out out{static_cast<int*>(outs[0]), static_cast<int*>(outs[1]),
                static_cast<bool*>(outs[2]), static_cast<bool*>(outs[3]),
                static_cast<bool*>(outs[4]), static_cast<int*>(outs[5]),
                static_cast<int*>(outs[6]), static_cast<bool*>(outs[7])};
  const int blocks = (n + kThreads - 1) / kThreads;
  nav_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, t, out, n, max_nav);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
