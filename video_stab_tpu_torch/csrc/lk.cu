// K6: the pyramidal Lucas-Kanade Newton ladder of lk_track, in one launch.
//
// Replaces the TPU kernels that gated an in-kernel LK (Mosaic never let it
// ship: DESIGN.md 5d-quater (a) and 5d-octies):
//   tools/lk_kernel_proto.py:kernel (K6a): per-point 16x16 window loads at
//     dynamic offsets and a bilinear blend, once per step;
//   tools/lk_inkernel_probe.py:kernel and kernel_noroll (K6b): per-point
//     slab loads and hat-weight reductions over the resident slabs;
//   tools/lk_inkernel_probe.py:kernel_loads (K6c): the template slab from
//     prev and the search slab from curr, per point;
//   tools/lk_inkernel_probe.py:kernel_newton (K6d): one level's Newton loop.
// K6d's loop is this kernel's Newton phase; what K6a-K6c exercise (window
// gathers at any offset, from prev and curr, at every level) is its gather
// phase. The function is video_stab_tpu_torch/kernels/lk.py:lk_levels_plain:
// for each point, from the top level down, the template window and its
// gradients, G and lvl_ok, then rounds of Newton steps with the search
// window re-anchored at each round's guess and clamped to the drift budget,
// the eps freeze, the level hand-off, and at level 0 the err window and the
// inside test.
//
// Arithmetic: every value is the plain version's expression, each step
// rounded (__fmul_rn and friends, --fmad=false), the hat weights as _hat
// computes them (relu(1 - |c + (i - a)|) at the two non-zero taps, not
// 1 - frac, which differs in the last bit for tiny frac), the plane read
// with clamped (replicate) indices where the plain version gathers a slab.
// Only the 225-term sums for G, b and err are taken in another order (a
// lane's pixels, then a butterfly over the warp) than the CPU's, so the
// kernel matches the plain version to a tolerance, not to bits.
//
// Bound on the H100: not bytes. A point needs a few KB of windows per level
// (~2.5 MB for 200 points at 3 levels, < 1 us at 3.35 TB/s) and well under
// a GFLOP in all; what takes the time is the latency of up to 60 dependent
// Newton steps, each a gather, a 225-term reduction and a 2x2 solve that the
// next step waits on. The design: one warp per point (200 points, 200
// warps, two to a block so they spread over the SMs), each lane holding its
// 8 (16 for win > 16) window pixels of the template in registers for the
// whole level, the search window read straight from the plane (L1/L2) with
// no slab materialized, the sums by shuffles with no block barrier, and a
// warp leaves a level as soon as its point has converged. One launch
// replaces ~2,000 small PyTorch launches per frame. Later work: several
// warps per point to cut the per-step latency, windows staged in shared
// memory by TMA, and the reductions on the tensor cores (wgmma).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 6;        // max_level <= 5 (kernels/lk.py)
constexpr int kWarpsPerBlock = 2;
constexpr int kDrift = 8;            // kernels/lk.py DRIFT
constexpr int kDriftTop = 24;        // kernels/lk.py DRIFT_TOP
// Plane indices are formed from a window origin clamped to [kFar, h]: any
// origin further out reads the same edge pixels (a window reaches at most
// 2 * kDriftTop + 22 + 1 pixels past its origin).
constexpr float kFar = -128.0f;

struct Planes {
  const float* prev[kMaxLevels];     // (3, h, w): value, d/dx, d/dy
  const float* curr[kMaxLevels];     // (h, w)
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Sum over the warp; every lane gets the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// The two non-zero hat weights max(0, 1 - |c + (i - a)|) of a window at
// in-slab offset c: taps a = i + k and i + k + 1 with k = floor(c).
struct Taps {
  int k;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float c) {
  const float f = floorf(c);
  Taps t;
  t.k = static_cast<int>(f);
  t.w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fadd_rn(c, -f))));
  t.w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fadd_rn(c, -(f + 1.0f)))));
  return t;
}

// An integer-valued window origin as an index, clamped to [kFar, n].
__device__ __forceinline__ int origin_index(float f, int n) {
  return static_cast<int>(fminf(fmaxf(f, kFar), static_cast<float>(n)));
}

// Bilinear value from plane p (h x w, replicate border) with rows y, y + 1
// and columns x, x + 1: rows first, then columns, as the hat-weight
// matmuls of the plain version.
__device__ __forceinline__ float sample(const float* __restrict__ p, int h,
                                        int w, int y, int x, const Taps& ty,
                                        const Taps& tx) {
  const int y0 = min(max(y, 0), h - 1) * w;
  const int y1 = min(max(y + 1, 0), h - 1) * w;
  const int x0 = min(max(x, 0), w - 1);
  const int x1 = min(max(x + 1, 0), w - 1);
  const float t0 = __fadd_rn(__fmul_rn(ty.w0, __ldg(p + y0 + x0)),
                             __fmul_rn(ty.w1, __ldg(p + y1 + x0)));
  const float t1 = __fadd_rn(__fmul_rn(ty.w0, __ldg(p + y0 + x1)),
                             __fmul_rn(ty.w1, __ldg(p + y1 + x1)));
  return __fadd_rn(__fmul_rn(t0, tx.w0), __fmul_rn(t1, tx.w1));
}

// One warp per point; each lane owns window pixels lane + 32 k, k < kPer.
template <int kPer>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_track_kernel(Planes pl, int n_levels, const float* __restrict__ prev_pts,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ init_pts, int n, int win, int iters,
                float eps2, float min_eig_thresh, float* __restrict__ out_pts,
                unsigned char* __restrict__ status,
                float* __restrict__ err_out) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= n) return;                        // the whole warp leaves
  const int npix = win * win;
  const float half = __fmul_rn(static_cast<float>(win - 1), 0.5f);

  int pi[kPer], pj[kPer];                    // window row, column; -1: none
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = lane + 32 * k;
    pi[k] = p < npix ? p / win : -1;
    pj[k] = p < npix ? p - (p / win) * win : 0;
  }

  const int top = n_levels - 1;
  const float px = prev_pts[2 * q];
  const float py = prev_pts[2 * q + 1];
  const float scale_top = 1.0f / static_cast<float>(1 << top);
  float gx = __fmul_rn(init_pts ? init_pts[2 * q] : px, scale_top);
  float gy = __fmul_rn(init_pts ? init_pts[2 * q + 1] : py, scale_top);
  bool ok = mask[q] != 0;
  float err = 0.0f;
  float iw[kPer], dxw[kPer], dyw[kPer];      // the level's template

  for (int level = top; level >= 0; --level) {
    const int h = pl.h[level];
    const int w = pl.w[level];
    const float* __restrict__ pv = pl.prev[level];
    const float* __restrict__ cv = pl.curr[level];
    const int plane = h * w;

    // Template: the window around prev_pts at this level, and G.
    const float lscale = static_cast<float>(1 << level);
    const float ty = __fsub_rn(__fdiv_rn(py, lscale), half);
    const float tx = __fsub_rn(__fdiv_rn(px, lscale), half);
    const float ty0 = floorf(ty);
    const float tx0 = floorf(tx);
    const Taps tty = taps(__fsub_rn(ty, ty0));
    const Taps ttx = taps(__fsub_rn(tx, tx0));
    const int tby = origin_index(ty0, h) + tty.k;
    const int tbx = origin_index(tx0, w) + ttx.k;
    float g11 = 0.0f, g12 = 0.0f, g22 = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      iw[k] = dxw[k] = dyw[k] = 0.0f;
      if (pi[k] >= 0) {
        const int y = tby + pi[k];
        const int x = tbx + pj[k];
        iw[k] = sample(pv, h, w, y, x, tty, ttx);
        dxw[k] = sample(pv + plane, h, w, y, x, tty, ttx);
        dyw[k] = sample(pv + 2 * plane, h, w, y, x, tty, ttx);
        g11 = __fadd_rn(g11, __fmul_rn(dxw[k], dxw[k]));
        g12 = __fadd_rn(g12, __fmul_rn(dxw[k], dyw[k]));
        g22 = __fadd_rn(g22, __fmul_rn(dyw[k], dyw[k]));
      }
    }
    g11 = warp_sum(g11);
    g12 = warp_sum(g12);
    g22 = warp_sum(g22);
    const float det = __fsub_rn(__fmul_rn(g11, g22), __fmul_rn(g12, g12));
    const float half_tr = __fmul_rn(0.5f, __fadd_rn(g11, g22));
    const float min_eig = __fsub_rn(
        half_tr, __fsqrt_rn(fmaxf(__fsub_rn(__fmul_rn(half_tr, half_tr), det),
                                  0.0f)));
    const bool lvl_ok =
        det > 1e-7f &&
        __fdiv_rn(min_eig, static_cast<float>(npix)) > min_eig_thresh;
    // -G^-1: the step is (dy, dx) = (ay * bx + by_ * by, ax * bx + ay * by).
    const float ay = lvl_ok ? -__fdiv_rn(-g12, det) : 0.0f;
    const float by_ = lvl_ok ? -__fdiv_rn(g11, det) : 0.0f;
    const float ax = lvl_ok ? -__fdiv_rn(g22, det) : 0.0f;

    // Newton: rounds of steps, the window re-anchored at each round's
    // guess and clamped to the drift budget. A point that converged (or
    // failed) stops; frozen points never move in the plain version either.
    const int drift = level == top ? kDriftTop : kDrift;
    const float cmax = static_cast<float>(2 * drift);   // s_c - win - 1
    const int rounds = level == top ? 4 : 2;
    const int iters_per = (iters + rounds - 1) / rounds;
    float pty = gy, ptx = gx;
    bool done = !lvl_ok || !ok;
    for (int r = 0; r < rounds && !done; ++r) {
      const float c0y = __fsub_rn(floorf(__fsub_rn(pty, half)),
                                  static_cast<float>(drift));
      const float c0x = __fsub_rn(floorf(__fsub_rn(ptx, half)),
                                  static_cast<float>(drift));
      const float oy = __fadd_rn(c0y, half);
      const float ox = __fadd_rn(c0x, half);
      const int cy0 = origin_index(c0y, h);
      const int cx0 = origin_index(c0x, w);
      for (int s = 0; s < iters_per && !done; ++s) {
        const Taps sy = taps(fminf(fmaxf(__fsub_rn(pty, oy), 0.0f), cmax));
        const Taps sx = taps(fminf(fmaxf(__fsub_rn(ptx, ox), 0.0f), cmax));
        const int by = cy0 + sy.k;
        const int bx = cx0 + sx.k;
        float bsx = 0.0f, bsy = 0.0f;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (pi[k] >= 0) {
            const float res = __fsub_rn(
                sample(cv, h, w, by + pi[k], bx + pj[k], sy, sx), iw[k]);
            bsx = __fadd_rn(bsx, __fmul_rn(dxw[k], res));
            bsy = __fadd_rn(bsy, __fmul_rn(dyw[k], res));
          }
        }
        bsx = warp_sum(bsx);
        bsy = warp_sum(bsy);
        const float dy = __fadd_rn(__fmul_rn(ay, bsx), __fmul_rn(by_, bsy));
        const float dx = __fadd_rn(__fmul_rn(ax, bsx), __fmul_rn(ay, bsy));
        pty = __fadd_rn(pty, dy);
        ptx = __fadd_rn(ptx, dx);
        done = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) <= eps2;
      }
    }

    // Level hand-off.
    ok = ok && lvl_ok;
    if (ok) {
      gx = ptx;
      gy = pty;
    }
    if (level > 0) {
      gx = __fmul_rn(gx, 2.0f);
      gy = __fmul_rn(gy, 2.0f);
    } else {
      // Final-window error at the converged position.
      const float ey = __fsub_rn(gy, half);
      const float ex = __fsub_rn(gx, half);
      const float ey0 = __fsub_rn(floorf(ey), 1.0f);
      const float ex0 = __fsub_rn(floorf(ex), 1.0f);
      const Taps ety = taps(__fsub_rn(ey, ey0));
      const Taps etx = taps(__fsub_rn(ex, ex0));
      const int eby = origin_index(ey0, h) + ety.k;
      const int ebx = origin_index(ex0, w) + etx.k;
      float e = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (pi[k] >= 0) {
          e = __fadd_rn(e, fabsf(__fsub_rn(
                               sample(cv, h, w, eby + pi[k], ebx + pj[k],
                                      ety, etx),
                               iw[k])));
        }
      }
      err = __fdiv_rn(warp_sum(e), static_cast<float>(npix));
    }
  }

  if (lane == 0) {
    const bool inside = gx >= 0.0f &&
                        gx <= static_cast<float>(pl.w[0] - 1) &&
                        gy >= 0.0f && gy <= static_cast<float>(pl.h[0] - 1);
    out_pts[2 * q] = gx;
    out_pts[2 * q + 1] = gy;
    status[q] = (ok && inside) ? 1 : 0;
    err_out[q] = err;
  }
}

}  // namespace

// planes: host array of 2 * n_levels device pointers, per level the
// (3, h, w) prev stack [value, d/dx, d/dy] then the (h, w) curr plane, all
// f32 with bfloat16 values; sizes: host array of 2 * n_levels ints (h, w).
// prev_pts, init_pts (may be null), out_pts: (n, 2) f32 (x, y); mask,
// status: (n,) bool; err: (n,) f32. eps2 = eps * eps. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int vs_lk_track(const void* planes, const void* sizes,
                           int n_levels, const void* prev_pts,
                           const void* mask, const void* init_pts, int n,
                           int win, int iters, float eps2,
                           float min_eig_thresh, void* out_pts, void* status,
                           void* err, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n <= 0 || win < 2 ||
      win * win > 32 * 16 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const* ptrs = static_cast<const void* const*>(planes);
  const int* hw = static_cast<const int*>(sizes);
  Planes pl = {};
  for (int l = 0; l < n_levels; ++l) {
    pl.prev[l] = static_cast<const float*>(ptrs[2 * l]);
    pl.curr[l] = static_cast<const float*>(ptrs[2 * l + 1]);
    pl.h[l] = hw[2 * l];
    pl.w[l] = hw[2 * l + 1];
    if (pl.h[l] <= 0 || pl.w[l] <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pts = static_cast<const float*>(prev_pts);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const float* init = static_cast<const float*>(init_pts);
  float* out = static_cast<float*>(out_pts);
  unsigned char* st = static_cast<unsigned char*>(status);
  float* e = static_cast<float*>(err);
  if (win * win <= 32 * 8) {
    lk_track_kernel<8><<<blocks, threads, 0, s>>>(
        pl, n_levels, pts, m, init, n, win, iters, eps2, min_eig_thresh, out,
        st, e);
  } else {
    lk_track_kernel<16><<<blocks, threads, 0, s>>>(
        pl, n_levels, pts, m, init, n, win, iters, eps2, min_eig_thresh, out,
        st, e);
  }
  return static_cast<int>(cudaGetLastError());
}
