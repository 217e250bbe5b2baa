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
// K6d's loop is this kernel's Newton phase; what K6a-K6c exercise (slabs
// cut at any offset, from prev and curr, at every level, resident while the
// steps run) is its staging phase. The function is
// video_stab_tpu_torch/kernels/lk.py:lk_levels_plain: for each point, from
// the top level down, the template window and its gradients, G and lvl_ok,
// then rounds of Newton steps with the search slab re-anchored at each
// round's guess and the window clamped to the drift budget, the eps freeze,
// the level hand-off, and at level 0 the err window and the inside test.
//
// Arithmetic: every value is the plain version's expression, each step
// rounded (__fmul_rn and friends, --fmad=false), the hat weights as _hat
// computes them (relu(1 - |c + (i - a)|) at the two non-zero taps, not
// 1 - frac, which differs in the last bit for tiny frac), the slabs cut
// with clamped (replicate) plane indices as _slab gathers them, the blend
// rows first, then columns, as the two hat-weight matmuls. Only the
// 225-term sums for G, b and err are taken in another order (a thread's
// pixels, a butterfly over the warp, then the warps' partials) than the
// CPU's, so the kernel matches the plain version to a tolerance, not to
// bits.
//
// Bound on the H100: neither bytes nor operations. A point needs a few KB
// of windows per level (~2.5 MB for 200 points at 3 levels, < 1 us at
// 3.35 TB/s) and well under a GFLOP in all. What takes the time is the
// latency of one point's chain of up to 60 dependent Newton steps: each
// step's window position comes out of the step before, and the launch ends
// when its slowest point ends. The tensor cores have no work here: a step
// is a 2 x 225 by 225 x 1 product on that chain, far below one wgmma tile,
// so none is used. A block is one warp per scheduler, so every
// instruction of a thread is on that chain too (~4-5 cycles each). The
// design shortens the step and what stands between the steps, since the
// number of steps is the algorithm's:
//   * one block of kThreads threads per point, each thread owning a
//     horizontal run of kRun window pixels, so a step's gather and residual
//     arithmetic are a few instructions per thread;
//   * the search slab in shared memory. The plain version gathers each
//     round's slab (s_c x s_c, s_c = win + 1 + 2 * drift: 64 x 64 at the
//     top level); the kernel stages a patch of it, win + 1 + 2 * 8 square
//     around the window, with the same clamped plane indices, and stages
//     a new one only when a step's window leaves it (rare: a window moves
//     a fraction of a pixel per step once it is near). Every step reads
//     the patch at [k + i][k' + j] with no clamp and no 2-D address
//     arithmetic. The copies are cp.async (all of a thread's copies in
//     flight at once, one wait), in aligned 16-byte pieces wherever the
//     patch lies between the plane's left and right edge. The (win + 3)^2
//     err slab is staged the same way;
//   * memory latency and address arithmetic off the chain: the templates
//     depend on prev_pts alone, so the (win + 1)^2 footprints of the three
//     prev planes of every level are requested when the block starts, a
//     warp per level; and each level's first search patch, whose corner is
//     known before the template is, is requested first and arrives while G
//     is summed and inverted;
//   * the bilinear window as a separable 2-tap filter: the row blend
//     w0y * P[i][j] + w1y * P[i + 1][j] is computed once per slab pixel of
//     a thread's run and shared between the two window pixels that use it;
//   * b's two sums: a butterfly over the warp, one exchange of the warps'
//     partials through shared memory (double-buffered by the step's
//     parity) and one block barrier per step; every thread then takes the
//     same 2x2 solve on the same bits, so the block's control flow stays
//     uniform without a broadcast;
//   * a block leaves a level as soon as its point has converged, and
//     writes how many Newton steps it ran.
// A TMA tile load would need a tensor map encoded on the host for each
// plane and call; it was not tried: a slab is at most 16 KB, and cp.async
// already takes the copies off the threads' registers.
//
// Streams: the multi-stream step (video_stab_tpu_torch/parallel/) tracks
// N streams' points over N pyramids in one launch. The grid is (points,
// streams), blockIdx.y the stream: each level's planes are N contiguous
// (3, h, w) stacks and (h, w) planes, a stream's a fixed stride from the
// level's base, and the point arrays are (N, P, ...). One stream's 200
// blocks fill under two of the 132 SMs' worth of the card at a time; N
// streams' N * 200 blocks run side by side, so the launch still ends when
// the slowest point of any stream ends. vs_lk_track is the N = 1 case.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 6;        // max_level <= 5 (kernels/lk.py)
constexpr int kMaxWin = 22;          // kernels/lk.py MAX_WIN
constexpr int kThreads = 128;        // threads per point
constexpr int kRun = 2;              // window pixels per thread, in a row
constexpr int kWarps = kThreads / 32;
constexpr int kDrift = 8;            // kernels/lk.py DRIFT
constexpr int kDriftTop = 24;        // kernels/lk.py DRIFT_TOP
// Row strides of the staged slabs, in floats: multiples of 4, so that a
// row starts on 16 bytes, and wide enough for the widest slab plus the up
// to 3 columns an aligned copy starts left of it (search patches:
// kMaxWin + 1 + 2 * kDrift + 3 = 42; template slabs: kMaxWin + 1 + 3).
constexpr int kStride = 48;
constexpr int kTStride = 28;
// Slab origins are clamped to [kFar, h] before they become indices: any
// origin further out cuts the same edge pixels (a slab reaches at most
// 2 * kDriftTop + kMaxWin pixels past its origin).
constexpr float kFar = -128.0f;

// Built with -DVS_CYCLES (video_stab_tpu_torch/tools/kernel_ab.py --cycles)
// the kernel also counts where a point's clock cycles go; a plain build
// has none of this.
#ifdef VS_CYCLES
constexpr int kCycleSlots = 8;       // set-up, templates, Newton, err,
constexpr int kCyclePoints = 4096;   // total, steps, patches staged again
__device__ long long vs_cycles[kCycleSlots * kCyclePoints];
#define VS_TICK(name) const long long name = clock64()
#define VS_SINCE(slot, since) cycles[slot] += clock64() - (since)
#define VS_COUNT(slot) ++cycles[slot]
#else
#define VS_TICK(name)
#define VS_SINCE(slot, since)
#define VS_COUNT(slot)
#endif

struct Planes {
  const float* prev[kMaxLevels];     // (3, h, w): value, d/dx, d/dy
  const float* curr[kMaxLevels];     // (h, w)
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Stream blockIdx.y's plane of a level whose base holds N stacks of
// ``planes`` (h, w) planes.
__device__ __forceinline__ const float* stream_plane(const float* base,
                                                     int planes, int h,
                                                     int w) {
  return base + static_cast<size_t>(blockIdx.y) * planes * h * w;
}

// Sum over the warp; every lane gets the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Sums of v[0..kN) over the block, the same bits in every thread: the warp
// butterflies, then the warps' partials in warp order. ``part`` holds two
// buffers of kWarps slots, used in turns (``phase``): a warp can only
// write a buffer again after every warp has passed the barrier of the sum
// in between, hence after every warp has read it.
template <int kN>
__device__ __forceinline__ void block_sum(float (&v)[kN], float4* part,
                                          int& phase, int warp, int lane) {
#pragma unroll
  for (int k = 0; k < kN; ++k) v[k] = warp_sum(v[k]);
  float4* p = part + phase * kWarps;
  if (lane == 0) {
    p[warp] = make_float4(v[0], v[kN > 1 ? 1 : 0], v[kN > 2 ? 2 : 0], 0.0f);
  }
  __syncthreads();
  float4 t = p[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 u = p[w];
    t.x = __fadd_rn(t.x, u.x);
    if constexpr (kN > 1) t.y = __fadd_rn(t.y, u.y);
    if constexpr (kN > 2) t.z = __fadd_rn(t.z, u.z);
  }
  v[0] = t.x;
  if constexpr (kN > 1) v[1] = t.y;
  if constexpr (kN > 2) v[2] = t.z;
  phase ^= 1;
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
  t.k = __float2int_rd(c);                   // (int)f, not waiting for f
  t.w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fadd_rn(c, -f))));
  t.w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fadd_rn(c, -(f + 1.0f)))));
  return t;
}

// taps(c) with k held to [0, kmax], for the offsets no clamp precedes.
__device__ __forceinline__ Taps taps_within(float c, int kmax) {
  Taps t = taps(c);
  t.k = min(max(t.k, 0), kmax);
  return t;
}

// An integer-valued slab origin as an index, clamped to [kFar, n].
__device__ __forceinline__ int origin_index(float f, int n) {
  return static_cast<int>(fminf(fmaxf(f, kFar), static_cast<float>(n)));
}

// kBytes (4 or 16) from global to shared memory without a register in
// between (cp.async): a thread starts all its copies of a slab back to back
// and waits once, so a staging costs one memory latency, not one per copy.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

// Wait for this thread's copies, then for the block's.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Where the slab's first column lands in its staged rows: 0, or x0 & 3
// when the copy can go in aligned 16-byte pieces (the plane's rows start
// on 16 bytes and the slab lies between the plane's left and right edge,
// so no column is clamped): the copy then starts at the aligned column
// left of x0.
__device__ __forceinline__ int slab_shift(const float* p, int w, int x0,
                                          int size) {
  const bool aligned = (w & 3) == 0 && x0 >= 0 && x0 + size <= w &&
                       (reinterpret_cast<unsigned long long>(p) & 15) == 0;
  return aligned ? (x0 & 3) : -1;
}

// Start staging the size x size slabs of kPlanes planes (h x w each,
// replicate border, ``plane`` floats apart) whose top-left corner is
// (y0, x0) into s (rows ``stride`` apart, slabs ``slab`` apart): element e
// of a slab to thread ``tid`` of ``n_threads`` with e mod n_threads == tid;
// staged() completes it. Returns the column of s that holds the slabs'
// first column.
template <int kPlanes>
__device__ __forceinline__ int stage(const float* __restrict__ p, int plane,
                                     int h, int w, int y0, int x0, int size,
                                     float* __restrict__ s, int slab,
                                     int stride, int tid, int n_threads) {
  const int shift = slab_shift(p, w, x0, size);
  // Pieces per row, and e / per_row for e < 4096 by a float product.
  const int per_row = shift >= 0 ? (shift + size + 3) >> 2 : size;
  const float inv = __frcp_rn(static_cast<float>(per_row));
  const int n = size * per_row;
  for (int e = tid; e < n; e += n_threads) {
    const int r = __float2int_rz(
        __fmul_rn(__fadd_rn(static_cast<float>(e), 0.5f), inv));
    const int c = e - r * per_row;
    const float* row = p + min(max(y0 + r, 0), h - 1) * w;
    const float* src = shift >= 0 ? row + (x0 - shift) + 4 * c
                                  : row + min(max(x0 + c, 0), w - 1);
    float* dst = s + r * stride + (shift >= 0 ? 4 * c : c);
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      if (shift >= 0) {
        copy_async<16>(dst + k * slab, src + k * plane);
      } else {
        copy_async<4>(dst + k * slab, src + k * plane);
      }
    }
  }
  return max(shift, 0);
}

// Bilinear values of a run of nv <= kRun window pixels from a staged slab,
// s pointing at the slab pixel under the run's first pixel's first tap:
// rows first (one blend per slab column of the run, shared by the two
// pixels that use it), then columns.
__device__ __forceinline__ void blend_run(const float* __restrict__ s,
                                          int stride, int nv, const Taps& ty,
                                          const Taps& tx,
                                          float (&out)[kRun]) {
  float t[kRun + 1];
#pragma unroll
  for (int m = 0; m <= kRun; ++m) {
    t[m] = m <= nv ? __fadd_rn(__fmul_rn(ty.w0, s[m]),
                               __fmul_rn(ty.w1, s[stride + m]))
                   : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < kRun; ++m) {
    out[m] = __fadd_rn(__fmul_rn(t[m], tx.w0), __fmul_rn(t[m + 1], tx.w1));
  }
}

// One block per point; thread t owns the runs t + kThreads * k, k < kPer,
// of the window's win * ceil(win / kRun) runs of kRun pixels. Dynamic
// shared memory: the block sums' partials (there, and not in a static
// array, so that their address is the buffer's plus a constant and is not
// formed anew in every step), the template slabs of every level (three
// planes each), then the search patch.
template <int kPer>
__global__ void __launch_bounds__(kThreads, 1)
lk_track_kernel(Planes pl, int n_levels, const float* __restrict__ prev_pts,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ init_pts, int win, int iters,
                float eps2, float min_eig_thresh, float* __restrict__ out_pts,
                unsigned char* __restrict__ status,
                float* __restrict__ err_out, int* __restrict__ steps_out) {
  extern __shared__ __align__(16) float shared[];
  float4* const part = reinterpret_cast<float4*>(shared);
  float* const smem = shared + 4 * 2 * kWarps;
#ifdef VS_CYCLES
  long long cycles[kCycleSlots] = {};
#endif
  VS_TICK(t_start);
  const int q = blockIdx.y * gridDim.x + blockIdx.x;   // (stream, point)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tplane = (win + 1) * kTStride;
  float* const slab = smem + n_levels * 3 * tplane;
  const int npix = win * win;
  const float half = __fmul_rn(static_cast<float>(win - 1), 0.5f);
  int phase = 0;

  const int runs_per_row = (win + kRun - 1) / kRun;
  int off[kPer], toff[kPer], nv[kPer];       // in-slab offsets; valid pixels
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int run = threadIdx.x + kThreads * k;
    const int i = run / runs_per_row;
    const int j = (run - i * runs_per_row) * kRun;
    nv[k] = i < win ? min(win - j, kRun) : 0;
    off[k] = nv[k] > 0 ? i * kStride + j : 0;
    toff[k] = nv[k] > 0 ? i * kTStride + j : 0;
  }

  const int top = n_levels - 1;
  const float px = prev_pts[2 * q];
  const float py = prev_pts[2 * q + 1];
  const float scale_top = 1.0f / static_cast<float>(1 << top);
  float gx = __fmul_rn(init_pts ? init_pts[2 * q] : px, scale_top);
  float gy = __fmul_rn(init_pts ? init_pts[2 * q + 1] : py, scale_top);
  bool ok = mask[q] != 0;
  float err = 0.0f;
  int n_steps = 0;
  float iw[kPer][kRun], dxw[kPer][kRun], dyw[kPer][kRun];   // the template

  // The templates depend on prev_pts alone: every level's three slabs are
  // requested now, in one memory latency, a warp per level (a staging's
  // address arithmetic is as long for 16 x 16 pixels as for many).
  // (1 / 2^level is exact, so the product is the plain version's quotient.)
  for (int level = warp; level < n_levels; level += kWarps) {
    const float lscale = __int_as_float((127 - level) << 23);   // 2^-level
    const int y0 = origin_index(
        floorf(__fsub_rn(__fmul_rn(py, lscale), half)), pl.h[level]);
    const int x0 = origin_index(
        floorf(__fsub_rn(__fmul_rn(px, lscale), half)), pl.w[level]);
    stage<3>(stream_plane(pl.prev[level], 3, pl.h[level], pl.w[level]),
             pl.h[level] * pl.w[level], pl.h[level],
             pl.w[level], y0, x0, win + 1, smem + level * 3 * tplane, tplane,
             kTStride, lane, 32);
  }

  VS_SINCE(0, t_start);
  for (int level = top; level >= 0; --level) {
    VS_TICK(t_level);
    const int h = pl.h[level];
    const int w = pl.w[level];
    const float* __restrict__ cv = stream_plane(pl.curr[level], 1, h, w);
    const float* const pv = stream_plane(pl.prev[level], 3, h, w);

    // The search window moves inside the round's slab (s_c x s_c, s_c =
    // win + 1 + 2 * drift, corner (cy0, cx0) in the plane); staged is a
    // patch of it, kPatch x kPatch at (py0, px0) in the plane, which has
    // kDrift pixels around the window it was staged for and is staged
    // again only when a step's window leaves it. Slab and patch read the
    // plane with the same clamped indices, so the values are the slab's.
    // The first window's corner is known before the template is: its patch
    // is requested here and arrives while G is summed and inverted. Every
    // thread is past the barrier that followed the patch's last reader (a
    // block_sum), so it can be overwritten.
    const int drift = level == top ? kDriftTop : kDrift;
    const int patch = win + 1 + 2 * kDrift;
    float pty = gy, ptx = gx;
    float c0y = __fsub_rn(floorf(__fsub_rn(pty, half)),
                          static_cast<float>(drift));
    float c0x = __fsub_rn(floorf(__fsub_rn(ptx, half)),
                          static_cast<float>(drift));
    int cy0 = origin_index(c0y, h);
    int cx0 = origin_index(c0x, w);
    int py0 = cy0 + drift - kDrift;
    int px0 = cx0 + drift - kDrift;
    int shift = 0;               // the patch's first column in its rows
    if (ok && iters > 0) {
      shift = stage<1>(cv, 0, h, w, py0, px0, patch, slab, 0, kStride,
                       threadIdx.x, kThreads);
    }

    // Template: the window around prev_pts at this level, and G.
    const float lscale = __int_as_float((127 - level) << 23);   // 2^-level
    const float ty = __fsub_rn(__fmul_rn(py, lscale), half);
    const float tx = __fsub_rn(__fmul_rn(px, lscale), half);
    const Taps tty = taps_within(__fsub_rn(ty, floorf(ty)), 0);
    const Taps ttx = taps_within(__fsub_rn(tx, floorf(tx)), 0);
    const int tx0 = origin_index(floorf(tx), w);
    if (level == top) staged();              // the templates are there
    float g[3] = {0.0f, 0.0f, 0.0f};         // g11, g12, g22
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      // The three planes of a level are staged alike: one column shift.
      const float* s = smem + level * 3 * tplane + toff[k] +
                       max(slab_shift(pv, w, tx0, win + 1), 0);
      blend_run(s, kTStride, nv[k], tty, ttx, iw[k]);
      blend_run(s + tplane, kTStride, nv[k], tty, ttx, dxw[k]);
      blend_run(s + 2 * tplane, kTStride, nv[k], tty, ttx, dyw[k]);
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        if (m < nv[k]) {
          g[0] = __fadd_rn(g[0], __fmul_rn(dxw[k][m], dxw[k][m]));
          g[1] = __fadd_rn(g[1], __fmul_rn(dxw[k][m], dyw[k][m]));
          g[2] = __fadd_rn(g[2], __fmul_rn(dyw[k][m], dyw[k][m]));
        }
      }
    }
    block_sum(g, part, phase, warp, lane);
    const float g11 = g[0], g12 = g[1], g22 = g[2];
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
    if (level < top) staged();               // the search patch is there
    VS_SINCE(1, t_level);
    VS_TICK(t_newton);

    // Newton: rounds of steps, the slab re-anchored at each round's guess
    // and the window clamped to the drift budget. A point that converged
    // (or failed) stops; frozen points never move in the plain version
    // either. Every thread holds the same pty, ptx and done.
    const float cmax = static_cast<float>(2 * drift);   // s_c - win - 1
    const int rounds = level == top ? 4 : 2;
    const int iters_per = (iters + rounds - 1) / rounds;
    bool done = !lvl_ok || !ok;
    for (int r = 0; r < rounds && !done && iters_per > 0; ++r) {
      if (r > 0) {
        c0y = __fsub_rn(floorf(__fsub_rn(pty, half)),
                        static_cast<float>(drift));
        c0x = __fsub_rn(floorf(__fsub_rn(ptx, half)),
                        static_cast<float>(drift));
        cy0 = origin_index(c0y, h);
        cx0 = origin_index(c0x, w);
      }
      const float oy = __fadd_rn(c0y, half);
      const float ox = __fadd_rn(c0x, half);
      for (int s = 0; s < iters_per && !done; ++s) {
        const Taps sy = taps(fminf(fmaxf(__fsub_rn(pty, oy), 0.0f), cmax));
        const Taps sx = taps(fminf(fmaxf(__fsub_rn(ptx, ox), 0.0f), cmax));
        // The window's corner in the patch; outside it, a new patch.
        int ry = cy0 + sy.k - py0;
        int rx = cx0 + sx.k - px0;
        if (static_cast<unsigned>(ry) > 2u * kDrift ||
            static_cast<unsigned>(rx) > 2u * kDrift) {
          py0 += ry - kDrift;
          px0 += rx - kDrift;
          ry = rx = kDrift;
          shift = stage<1>(cv, 0, h, w, py0, px0, patch, slab, 0, kStride,
                           threadIdx.x, kThreads);
          staged();
          VS_COUNT(6);
        }
        const float* base = slab + ry * kStride + rx + shift;
        float b[2] = {0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          float j[kRun];
          blend_run(base + off[k], kStride, nv[k], sy, sx, j);
#pragma unroll
          for (int m = 0; m < kRun; ++m) {
            if (m < nv[k]) {
              const float res = __fsub_rn(j[m], iw[k][m]);
              b[0] = __fadd_rn(b[0], __fmul_rn(dxw[k][m], res));
              b[1] = __fadd_rn(b[1], __fmul_rn(dyw[k][m], res));
            }
          }
        }
        block_sum(b, part, phase, warp, lane);
        const float dy = __fadd_rn(__fmul_rn(ay, b[0]), __fmul_rn(by_, b[1]));
        const float dx = __fadd_rn(__fmul_rn(ax, b[0]), __fmul_rn(ay, b[1]));
        pty = __fadd_rn(pty, dy);
        ptx = __fadd_rn(ptx, dx);
        done = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) <= eps2;
        ++n_steps;
      }
    }

    VS_SINCE(2, t_newton);

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
      // Final-window error at the converged position: a fresh
      // (win + 3)^2 slab one pixel up and left of the window's corner.
      VS_TICK(t_err);
      const float ey = __fsub_rn(gy, half);
      const float ex = __fsub_rn(gx, half);
      const float ey0 = __fsub_rn(floorf(ey), 1.0f);
      const float ex0 = __fsub_rn(floorf(ex), 1.0f);
      const Taps ety = taps_within(__fsub_rn(ey, ey0), 2);
      const Taps etx = taps_within(__fsub_rn(ex, ex0), 2);
      const int eshift =
          stage<1>(cv, 0, h, w, origin_index(ey0, h), origin_index(ex0, w),
                   win + 3, slab, 0, kStride, threadIdx.x, kThreads);
      staged();
      const float* base = slab + ety.k * kStride + etx.k + eshift;
      float e[1] = {0.0f};
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        float j[kRun];
        blend_run(base + off[k], kStride, nv[k], ety, etx, j);
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
          if (m < nv[k]) {
            e[0] = __fadd_rn(e[0], fabsf(__fsub_rn(j[m], iw[k][m])));
          }
        }
      }
      block_sum(e, part, phase, warp, lane);
      err = __fdiv_rn(e[0], static_cast<float>(npix));
      VS_SINCE(3, t_err);
    }
  }

  if (threadIdx.x == 0) {
    const bool inside = gx >= 0.0f &&
                        gx <= static_cast<float>(pl.w[0] - 1) &&
                        gy >= 0.0f && gy <= static_cast<float>(pl.h[0] - 1);
    out_pts[2 * q] = gx;
    out_pts[2 * q + 1] = gy;
    status[q] = (ok && inside) ? 1 : 0;
    err_out[q] = err;
    if (steps_out) steps_out[q] = n_steps;
#ifdef VS_CYCLES
    VS_SINCE(4, t_start);
    cycles[5] = n_steps;
    for (int k = 0; k < kCycleSlots && q < kCyclePoints; ++k) {
      vs_cycles[kCycleSlots * q + k] = cycles[k];
    }
#endif
  }
}

// Dynamic shared memory of a launch, in bytes.
size_t shared_bytes(int n_levels, int win) {
  return sizeof(float) * (4 * 2 * kWarps +
                          n_levels * 3 * (win + 1) * kTStride +
                          (win + 1 + 2 * kDrift) * kStride);
}

template <int kPer>
cudaError_t launch(Planes pl, int n_levels, const float* pts,
                   const unsigned char* mask, const float* init, int n,
                   int n_streams, int win, int iters, float eps2,
                   float min_eig_thresh,
                   float* out, unsigned char* status, float* err, int* steps,
                   cudaStream_t stream) {
  // Above 48 KB (deep pyramids with wide windows) a kernel has to opt in.
  static const cudaError_t opted = cudaFuncSetAttribute(
      lk_track_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes(kMaxLevels, kMaxWin)));
  if (opted != cudaSuccess) return opted;
  const dim3 grid(n, n_streams);
  lk_track_kernel<kPer><<<grid, kThreads, shared_bytes(n_levels, win),
                          stream>>>(pl, n_levels, pts, mask, init, win,
                                    iters, eps2, min_eig_thresh, out, status,
                                    err, steps);
  return cudaGetLastError();
}

}  // namespace

// planes: host array of 2 * n_levels device pointers, per level the
// (n_streams, 3, h, w) prev stacks [value, d/dx, d/dy] then the
// (n_streams, h, w) curr planes, all f32 with bfloat16 values; sizes: host
// array of 2 * n_levels ints (h, w). prev_pts, init_pts (may be null),
// out_pts: (n_streams, n, 2) f32 (x, y); mask, status: (n_streams, n)
// bool; err: (n_streams, n) f32; steps (may be null): (n_streams, n) i32,
// the Newton steps each point ran. eps2 = eps * eps. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int vs_lk_track_batched(const void* planes, const void* sizes,
                                   int n_levels, const void* prev_pts,
                                   const void* mask, const void* init_pts,
                                   int n, int n_streams, int win, int iters,
                                   float eps2, float min_eig_thresh,
                                   void* out_pts, void* status, void* err,
                                   void* steps, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n <= 0 || n_streams <= 0 ||
      n_streams > 65535 || win < 2 || win > kMaxWin || iters < 0) {
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
  const int runs = win * ((win + kRun - 1) / kRun);
  const auto go = runs <= kThreads ? launch<1> : launch<2>;
  static_assert(kMaxWin * ((kMaxWin + kRun - 1) / kRun) <= 2 * kThreads,
                "a thread owns at most two runs");
  return static_cast<int>(go(
      pl, n_levels, static_cast<const float*>(prev_pts),
      static_cast<const unsigned char*>(mask),
      static_cast<const float*>(init_pts), n, n_streams, win, iters, eps2,
      min_eig_thresh, static_cast<float*>(out_pts),
      static_cast<unsigned char*>(status), static_cast<float*>(err),
      static_cast<int*>(steps), static_cast<cudaStream_t>(stream)));
}

// One stream: the planes (3, h, w) and (h, w), the points (n, ...).
extern "C" int vs_lk_track(const void* planes, const void* sizes,
                           int n_levels, const void* prev_pts,
                           const void* mask, const void* init_pts, int n,
                           int win, int iters, float eps2,
                           float min_eig_thresh, void* out_pts, void* status,
                           void* err, void* steps, void* stream) {
  return vs_lk_track_batched(planes, sizes, n_levels, prev_pts, mask,
                             init_pts, n, 1, win, iters, eps2,
                             min_eig_thresh, out_pts, status, err, steps,
                             stream);
}

#ifdef VS_CYCLES
// Copies the last launch's counters, (4096, 8) int64, to host memory.
extern "C" int vs_lk_cycles(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, vs_cycles, sizeof(vs_cycles)));
}
#endif
