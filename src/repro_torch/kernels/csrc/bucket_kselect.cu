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
// Design: a block of 8 warps stages the window into shared memory once
// ((px, py) as float2, then valid: 9 bytes per candidate, C <= 4096 on the
// narrow route; wider windows below) and counts n_valid for the whole
// block; then each warp takes one query row at a time (rows grid-stride
// over a grid sized to fill the card).
// - A pass over the row recomputes d2 from the staged window with the same
//   __fmaf_rn, so the bits never change, and without a branch, so a pass
//   issues its loads before it uses them.  A row takes two such passes:
//   lo / hi, then one that keeps the entries that can decide the rounds.
// - A round's cost is its histogram: a division and a shared atomic per
//   entry in [flo, fhi).  The bin of an entry is monotone in its value, so
//   the entries of bins < m are those below one value, bin_edge(m), found
//   from fma(m, width, flo) by a few one-ulp steps of the same division.
//   The keeping pass writes the entries of bins < m to the warp's 4 KB of
//   shared memory (kCap = 1024); they decide the round if they fit and
//   reach rank kth, since their histogram gives every bin's cumulative
//   count up to the chosen one exactly.  m (1, 2, 4, 8, 16 or all) starts
//   from the warp's last rows and grows or shrinks one pass at a time.
// - The rounds then run on the kept entries: the histogram (lane L counts
//   bin L from five votes on the bits of each entry's bin: the kept
//   entries crowd a few bins, where atomics would serialise), and the edge
//   counts, wherever the kept entries hold all of [flo, new_hi); those
//   counts keep the new bucket's entries in place, so the next round's
//   histogram is complete.  Anything that does not fit, or an interval
//   that is not finite (a NaN row), takes a pass over every entry.
// - The row's d2 is not held in registers: 64 a lane, with the passes
//   unrolled over them, made a kernel too large for the instruction cache
//   at 16 warps an SM, slower than recomputing.
// - lo and hi propagate NaN, as jnp.min / jnp.max and torch's amin / amax
//   do: a NaN distance makes the row's interval, and its radius, NaN.
// - Three routes, by window C and k (launch()):
//   0, narrow: C <= kMaxWindow = 4096, bucket_kselect_kernel<8, kCap>.
//   1, staged: 4096 < C <= C_staged and k <= kStagedCap / 2: the same row
//   loop, bucket_kselect_kernel<kStagedWarps, kStagedCap>, 10 warps a
//   block keeping up to 2016 entries each.  At C = 16,384 a row's first
//   bin holds about C / 12 entries, past kCap, so the narrow loop's
//   keeping pass would fail and its rounds pass over the whole row; 2016
//   holds it.  C_staged is the largest window that fits beside the kept
//   entries (80,640 bytes) and the histograms in the card's opt-in shared
//   memory, read at launch: 16,725 on an H100's 232,448 bytes.  One block
//   an SM, so the passes are latency-bound.  The block shape is the
//   fastest without spills of those timed at C = 16,384, k = 32
//   (benchmarks_torch/b5_routes.py --shapes, Q = 65,536, NVIDIA H100
//   80GB HBM3, 700.00 W: 10 x 2016 4.06 ms, 9 x 2304 4.50, 12 x 1728
//   4.28, 8 x 2592 4.50, 7 x 2944 5.14; 11 x 1888 3.75 spills).
//   Past k = kStagedCap / 2 the bins that reach rank kth can hold more
//   than 2016 entries, and such a row pays failed keeping passes before
//   its passes over the whole row (b5_routes.py, the same card: the
//   staged route 1.63x to 2.20x faster than the template at k = 1008
//   from C = 4500 to 16,725; 0.97x to 1.26x at k = 1500; 0.61x to 0.78x
//   at k = 2000).
//   2, the wide template, bucket_kselect_wide_kernel, everywhere else:
//   the window is tiled through shared memory in slabs of kMaxWindow (the
//   same 36 KB).  The block's 8 warps take 8 rows at a time and make
//   every pass together, staging each slab in turn: lo / hi, then for each
//   round the histogram and the edge counts, 1 + 2 * iters passes over the
//   slabs.  It keeps no entries: each round counts over every slab, so it
//   needs no shared memory beyond one slab and no global scratch.
// Every multiply, add and divide is an explicit round-to-nearest intrinsic
// and the build passes --fmad=false.
//
// Bound on an H100: operations.  The inputs and the (Q,) output are a few
// megabytes, but each (query, candidate) pair costs one distance (5 flops)
// and a bin (about 3 flops) in each of the `iters` rounds: at Q = 1,000,000,
// C = 2048, iters = 4 about 3.5e10 flops, 0.52 ms at 67 TFLOP/s (f32).  The
// design never writes a distance and divides only the entries that can
// decide a round; its two recomputing passes are the cost above the bound.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // Q_TILE: one warp per row at a time
constexpr int kBins = 32;         // one histogram bin per lane
constexpr int kMaxWindow = 4096;  // 9 bytes each: 36 KB of shared memory
constexpr int kCap = 1024;        // kept entries a warp: 4 KB
constexpr unsigned kFull = 0xffffffffu;

// jnp.maximum (and torch.maximum) propagates NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// The d2 of staged candidate j (j < c), +inf where it is invalid.  No
// branch: a pass issues all its loads before it uses one.
__device__ __forceinline__ float dist2(const float2* p,
                                       const unsigned char* v, int j, float fx,
                                       float fy) {
  const float2 pj = p[j];
  const float dx = __fsub_rn(fx, pj.x);
  const float dy = __fsub_rn(fy, pj.y);
  const float d = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
  return v[j] ? d : CUDART_INF_F;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One row's distances, recomputed from the staged window on every read.
// `each` hands every lane one entry at a time, all lanes together (+inf
// past the window's end, which no pass counts), so a pass may vote.
struct Window {
  const float2* p;
  const unsigned char* v;
  int c, lane;
  float fx, fy;
  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll 4
    for (int base = 0; base < c; base += kWarp) {
      const int j = base + lane;
      const float x = dist2(p, v, min(j, c - 1), fx, fy);
      f(j < c ? x : CUDART_INF_F);
    }
  }
};

// A warp's compacted entries in shared memory: n of them, read 32 at a
// time by all lanes together (+inf past the end).
struct Kept {
  float* v;
  int n, lane;
  template <class F>
  __device__ __forceinline__ void each(F&& f) const {
    for (int base = 0; base < n; base += kWarp) {
      const int j = base + lane;
      f(j < n ? v[j] : CUDART_INF_F);
    }
  }
};

// The reference's bin of an entry inside [flo, fhi).
__device__ __forceinline__ int bin_of(float x, float flo, float width) {
  float b = floorf(__fdiv_rn(__fsub_rn(x, flo), width));
  b = fminf(fmaxf(b, 0.0f), static_cast<float>(kBins - 1));  // NaN -> 0
  return __float2int_rz(b);
}

// The least x whose quotient RN(RN(x - flo) / width) reaches m (an
// integer <= 31): an entry of [flo, fhi) has bin < m exactly when it lies
// below it, the quotient being monotone in x.  Found from fma(m, width,
// flo) by steps of one ulp; `ok` is false where 32 steps did not settle it.
__device__ __forceinline__ float bin_edge(float m, float flo, float width,
                                          bool& ok) {
  auto reaches = [&](float x) {
    return __fdiv_rn(__fsub_rn(x, flo), width) >= m;
  };
  float x = __fmaf_rn(m, width, flo);
  ok = false;
  if (reaches(x)) {
    for (int s = 0; s < 32; ++s) {
      const float y = nextafterf(x, -CUDART_INF_F);
      if (!reaches(y)) {
        ok = true;
        break;
      }
      x = y;
    }
  } else {
    for (int s = 0; s < 32; ++s) {
      x = nextafterf(x, CUDART_INF_F);
      if (reaches(x)) {
        ok = true;
        break;
      }
    }
  }
  return x;
}

// The round's bucket: the 32-bin histogram of the source's entries in
// [flo, fhi), an inclusive scan, and the first bin whose cumulative count
// reaches kth (0 if none does).  Over the whole row the bins are
// shared counters, one a lane, spread by atomics; the kept entries crowd a
// few bins (all of them in one, when only bin 0 is kept), where atomics
// would serialise, so there (BALLOT) lane L counts bin L from five votes
// on the bits of every entry's bin.
template <bool BALLOT, class Src>
__device__ __forceinline__ int select_bucket(const Src& src, float flo,
                                             float fhi, float width, int kth,
                                             int lane, int* hist) {
  int cum = 0;
  if (BALLOT) {
    src.each([&](float x) {
      const bool in = (x >= flo) & (x < fhi);
      unsigned m = __ballot_sync(kFull, in);
      const int b = in ? bin_of(x, flo, width) : 0;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const unsigned v = __ballot_sync(kFull, (b >> j) & 1);
        m &= ((lane >> j) & 1) ? v : ~v;
      }
      cum += __popc(m);
    });
  } else {
    hist[lane] = 0;
    __syncwarp();
    src.each([&](float x) {
      if ((x >= flo) & (x < fhi)) atomicAdd(&hist[bin_of(x, flo, width)], 1);
    });
    __syncwarp();
    cum = hist[lane];
  }
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    const int v = __shfl_up_sync(kFull, cum, o);
    if (lane >= o) cum += v;
  }
  const unsigned ge = __ballot_sync(kFull, cum >= kth);
  return ge ? __ffs(ge) - 1 : 0;
}

// The rank below the bucket, count(flo <= x < new_lo), and the bucket's
// count(new_lo <= x < new_hi), over the source's entries; the bucket's
// entries (up to CAP) are also written to `keep` in order.  In place (the
// source is `keep` itself) a write lands only on a slot already read.
// Returns the bucket's count.
template <int CAP, class Src>
__device__ __forceinline__ int count_bucket(const Src& src, float flo,
                                            float new_lo, float new_hi,
                                            float* keep, int lane,
                                            int& below) {
  int lt = 0;
  int inside = 0;
  src.each([&](float x) {
    lt += (x >= flo) & (x < new_lo);
    const bool in = (x >= new_lo) & (x < new_hi);
    const unsigned m = __ballot_sync(kFull, in);
    if (m != 0) {
      const int at = inside + __popc(m & ((1u << lane) - 1u));
      __syncwarp();  // every lane has read its entry
      if (in && at < CAP) keep[at] = x;
      inside += __popc(m);
    }
  });
  below = warp_sum(lt);
  return inside;
}

// The row loop, WARPS warps a block, CAP kept entries a warp: <kRowsPerBlock,
// kCap> the narrow route, <kStagedWarps, kStagedCap> the staged one.
template <int WARPS, int CAP>
__global__ void __launch_bounds__(kWarp * WARPS)
bucket_kselect_kernel(const float* __restrict__ qx,
                      const float* __restrict__ qy,
                      const float* __restrict__ px,
                      const float* __restrict__ py,
                      const bool* __restrict__ valid, float* __restrict__ out,
                      int q, int c, int k, int iters, float hi_mul,
                      float hi_add, float tiny) {
  extern __shared__ float smem[];
  __shared__ int hist_all[WARPS][kBins];
  float2* sp = reinterpret_cast<float2*>(smem);
  unsigned char* sv = reinterpret_cast<unsigned char*>(smem + 2 * c);
  float* kept_all = smem + 2 * c + (c + 3) / 4;

  // ---- stage the shared window; n_valid is one block-wide count.
  int n_valid = 0;
  for (int base = 0; base < c; base += blockDim.x) {
    const int j = base + threadIdx.x;
    bool v = false;
    if (j < c) {
      sp[j] = make_float2(px[j], py[j]);
      v = valid[j];
      sv[j] = v;
    }
    n_valid += __syncthreads_count(v);  // also the staging barrier
  }

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int* hist = hist_all[warp];
  float* kept = kept_all + warp * CAP;
  const float inf = CUDART_INF_F;
  int m_pred = 1;  // bins kept at first, from the warp's last rows
  for (int row = blockIdx.x * WARPS + warp; row < q;
       row += gridDim.x * WARPS) {
    const Window rd{sp, sv, c, lane, qx[row], qy[row]};

    // ---- lo, hi: NaN if any entry is NaN, as jnp.min / jnp.max give it.
    float lo = inf;
    float hi0 = -inf;
    bool nan = false;
    rd.each([&](float x) {
      lo = fminf(lo, x);
      hi0 = fmaxf(hi0, isinf(x) ? -inf : x);
      nan |= x != x;
    });
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi0 = fmaxf(hi0, __shfl_xor_sync(kFull, hi0, o));
    }
    if (__any_sync(kFull, nan)) lo = hi0 = CUDART_NAN_F;
    float flo = lo;
    float fhi = __fmaf_rn(nan_max(hi0, lo), hi_mul, hi_add);
    int kth = k;

    // ---- bucket refinement of the k-th distance.  `kept` holds every
    // entry of [flo, kept_hi), n_kept of them (-1: it holds nothing).
    int n_kept = -1;
    float kept_hi = 0.0f;
    for (int it = 0; it < iters; ++it) {
      const float width = nan_max(
          __fdiv_rn(__fsub_rn(fhi, flo), static_cast<float>(kBins)), tiny);
      if (n_kept < 0 && isfinite(flo) && isfinite(fhi) &&
          isfinite(width)) {
        // Keep the entries of bins < m, m = 1, 2, 4, 8, 16 or all, in one
        // pass: they serve if they fit and reach rank kth, or are all of
        // [flo, fhi).  m starts from the warp's last rows, grows while too
        // few reach kth and shrinks while too many to fit.
        int m = m_pred;
        int step = 0;  // +1 growing, -1 shrinking
        while (true) {
          bool ok = true;
          const float bound =
              m >= kBins ? fhi
                         : fminf(bin_edge(static_cast<float>(m), flo, width,
                                          ok),
                                 fhi);
          if (!ok) break;
          int n = 0;
          __syncwarp();
          rd.each([&](float x) {
            const bool keep = (x >= flo) & (x < bound);
            const unsigned mk = __ballot_sync(kFull, keep);
            const int at = n + __popc(mk & ((1u << lane) - 1u));
            if (keep && at < CAP) kept[at] = x;
            n += __popc(mk);
          });
          if (n <= CAP && (n >= kth || bound == fhi)) {
            n_kept = n;
            kept_hi = bound;
            // next row: the same m, or half of it where that kept twice
            // what it needed
            m_pred = m > 1 && m < kBins && n >= 2 * kth ? m / 2 : m;
            break;
          }
          if (n > CAP) {  // too many: shrink, unless that came up short
            if (step > 0 || m == 1) break;
            step = -1;
            m = m >= kBins ? 16 : m / 2;
          } else {  // too few: grow, unless that overflowed
            if (step < 0) break;
            step = 1;
            m = m >= 16 ? kBins : m * 2;
          }
        }
      }
      __syncwarp();
      const int sel =
          n_kept >= 0
              ? select_bucket<true>(Kept{kept, n_kept, lane}, flo, fhi,
                                    width, kth, lane, hist)
              : select_bucket<false>(rd, flo, fhi, width, kth, lane, hist);
      const float new_lo = __fmaf_rn(static_cast<float>(sel), width, flo);
      const float new_hi = __fadd_rn(new_lo, width);
      // The rank below the bucket, and whether the bucket holds the wanted
      // element, are counted against its edges (see the header), over the
      // kept entries where they hold all of [flo, new_hi).
      int below = 0;
      const int inside =
          n_kept >= 0 && new_hi <= kept_hi
              ? count_bucket<CAP>(Kept{kept, n_kept, lane}, flo, new_lo,
                                  new_hi, kept, lane, below)
              : count_bucket<CAP>(rd, flo, new_lo, new_hi, kept, lane, below);
      if (below < kth && below + inside >= kth) {
        flo = new_lo;
        fhi = new_hi;
        kth -= below;
        n_kept = inside <= CAP ? inside : -1;
        kept_hi = new_hi;
      } else {
        n_kept = -1;
      }
      __syncwarp();
    }
    if (lane == 0) out[row] = n_valid < k ? inf : fhi;
  }
}

// The wide template (see the header): 8 rows a block at a time, every pass
// over the window's slabs, each slab staged once a pass for all 8 rows.
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
bucket_kselect_wide_kernel(const float* __restrict__ qx,
                           const float* __restrict__ qy,
                           const float* __restrict__ px,
                           const float* __restrict__ py,
                           const bool* __restrict__ valid,
                           float* __restrict__ out, int q, int c, int k,
                           int iters, float hi_mul, float hi_add, float tiny) {
  __shared__ float2 sp[kMaxWindow];
  __shared__ unsigned char sv[kMaxWindow];
  __shared__ int hist_all[kRowsPerBlock][kBins];
  int n_valid = 0;
  for (int base = 0; base < c; base += blockDim.x) {
    const int j = base + threadIdx.x;
    n_valid += __syncthreads_count(j < c && valid[j]);
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int* hist = hist_all[warp];
  const float inf = CUDART_INF_F;
  for (int tile = blockIdx.x; tile < (q + kRowsPerBlock - 1) / kRowsPerBlock;
       tile += gridDim.x) {
    const int row = tile * kRowsPerBlock + warp;
    const bool live = row < q;
    const float fx = live ? qx[row] : 0.0f;
    const float fy = live ? qy[row] : 0.0f;
    // One pass: f over each of the row's entries, slab by slab; every
    // thread of the block calls it together.
    auto pass = [&](auto&& f) {
      for (int s0 = 0; s0 < c; s0 += kMaxWindow) {
        const int len = min(kMaxWindow, c - s0);
        __syncthreads();  // the last slab's readers are done
        for (int j = threadIdx.x; j < len; j += blockDim.x) {
          sp[j] = make_float2(px[s0 + j], py[s0 + j]);
          sv[j] = valid[s0 + j];
        }
        __syncthreads();
        Window{sp, sv, len, lane, fx, fy}.each(f);
      }
    };

    float lo = inf;
    float hi0 = -inf;
    bool nan = false;
    pass([&](float x) {
      lo = fminf(lo, x);
      hi0 = fmaxf(hi0, isinf(x) ? -inf : x);
      nan |= x != x;
    });
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi0 = fmaxf(hi0, __shfl_xor_sync(kFull, hi0, o));
    }
    if (__any_sync(kFull, nan)) lo = hi0 = CUDART_NAN_F;
    float flo = lo;
    float fhi = __fmaf_rn(nan_max(hi0, lo), hi_mul, hi_add);
    int kth = k;
    for (int it = 0; it < iters; ++it) {
      const float width = nan_max(
          __fdiv_rn(__fsub_rn(fhi, flo), static_cast<float>(kBins)), tiny);
      hist[lane] = 0;
      __syncwarp();
      pass([&](float x) {
        if ((x >= flo) & (x < fhi)) atomicAdd(&hist[bin_of(x, flo, width)], 1);
      });
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
      int lt = 0;
      int in = 0;
      pass([&](float x) {
        lt += (x >= flo) & (x < new_lo);
        in += (x >= new_lo) & (x < new_hi);
      });
      const int below = warp_sum(lt);
      const int inside = warp_sum(in);
      if (below < kth && below + inside >= kth) {
        flo = new_lo;
        fhi = new_hi;
        kth -= below;
      }
      __syncwarp();  // every lane has read its bin before the next reset
    }
    if (live && lane == 0) out[row] = n_valid < k ? inf : fhi;
  }
}

struct Args {
  const float* qx;
  const float* qy;
  const float* px;
  const float* py;
  const bool* valid;
  float* out;
  int q, c, k, iters;
  float hi_mul, hi_add, tiny;
  cudaStream_t stream;
};

// The staged route's block (see the header): kStagedWarps warps keeping up
// to kStagedCap entries each, 80,640 bytes beside the window.
constexpr int kStagedWarps = 10;
constexpr int kStagedCap = 2016;

// The row loop's dynamic shared memory at window c: the window (9 bytes a
// candidate), then `cap` kept floats for each of `warps` warps.
size_t loop_bytes(int c, int warps, int cap) {
  return sizeof(float) * (2 * static_cast<size_t>(c) + (c + 3) / 4 +
                          static_cast<size_t>(warps) * cap);
}

// Launches KERNEL, `warps` warps a block and `smem` bytes of dynamic shared
// memory, on a grid that fills the card: as many blocks as fit at once, at
// most one a block's rows.
template <auto KERNEL>
cudaError_t launch_on(const Args& a, int dev, int warps, size_t smem) {
  const void* fn = reinterpret_cast<const void*>(KERNEL);
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kWarp * warps, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.q + warps - 1) / warps;
  const int fill = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = tiles < fill ? tiles : fill;
  KERNEL<<<blocks, kWarp * warps, smem, a.stream>>>(
      a.qx, a.qy, a.px, a.py, a.valid, a.out, a.q, a.c, a.k, a.iters,
      a.hi_mul, a.hi_add, a.tiny);
  return cudaGetLastError();
}

// The route (see the header): 0 narrow, 1 staged, 2 the wide template.
cudaError_t launch(const Args& a, int* route) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (a.c <= kMaxWindow) {
    *route = 0;
    return launch_on<bucket_kselect_kernel<kRowsPerBlock, kCap>>(
        a, dev, kRowsPerBlock, loop_bytes(a.c, kRowsPerBlock, kCap));
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t staged = loop_bytes(a.c, kStagedWarps, kStagedCap);
  if (a.k <= kStagedCap / 2 &&
      staged + sizeof(int) * kStagedWarps * kBins <=
          static_cast<size_t>(optin)) {
    *route = 1;
    return launch_on<bucket_kselect_kernel<kStagedWarps, kStagedCap>>(
        a, dev, kStagedWarps, staged);
  }
  *route = 2;
  return launch_on<bucket_kselect_wide_kernel>(a, dev, kRowsPerBlock, 0);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  All pointers are device pointers;
// qx / qy / out are (q,), px / py / valid (c,); q > 0; c > 0; k > 0,
// iters >= 0.  *route is set to the route the launch took: 0 the narrow
// kernel, 1 the staged route, 2 the wide template.
int bucket_kselect_f32(const void* qx, const void* qy, const void* px,
                       const void* py, const void* valid, void* out, int q,
                       int c, int k, int iters, float hi_mul, float hi_add,
                       float tiny, void* stream, int* route) {
  if (q <= 0 || c <= 0 || k <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(qx), static_cast<const float*>(qy),
               static_cast<const float*>(px), static_cast<const float*>(py),
               static_cast<const bool*>(valid), static_cast<float*>(out),
               q, c, k, iters, hi_mul, hi_add, tiny,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch(a, route));
}

}  // extern "C"
