// K3: Shi-Tomasi corner response (cv::cornerMinEigenVal, block 3, aperture
// 3) and its 3x3 peak mask, in one launch.
//
// Replaces the Pallas kernel video_stab_tpu/pallas/features.py:_corner_kernel
// (via corner_response). It computes what the JAX package's GFTT actually
// dispatches — ops/features.py:min_eig_response followed by
// resp >= _dilate3x3(resp) — not the Pallas kernel's rim convention:
//   * every stage is reflect-101 on its OWN input, as sep_filter2d re-pads:
//     the Sobel reads reflect-101 source pixels, and the 3x3 box sums read
//     the product planes at reflect-101 indices (a product at a reflected
//     index is the product at that true pixel, not a product of reflected
//     gradients);
//   * the peak test wraps around the frame (jnp.roll): the neighbour of
//     column 0 is column w - 1, with that pixel's own reflect rules.
// Each 1-D stage sums its taps left to right, vertical pass first, every
// product and sum rounded to float32 (__fmul_rn/__fadd_rn, no FMA) — the
// order of video_stab_tpu_torch/ops/filters.py, so kernel and plain version
// agree bit for bit.
//
// Bound on the H100: bytes, 4.7 MB at 960x540 (gray in, response and peak
// mask out; 1.4 us at 3.35 TB/s), all of it resident in the 50 MB L2; the
// ~55 operations per pixel are far below the float32 rate. What a kernel
// loses here is instruction slots on redundant work and index arithmetic,
// so the design computes every intermediate once and keeps it in
// registers, with no shared memory and no barrier:
//   * a warp owns a strip of kStripW = 26 output columns (its 32 lanes less
//     a 3-column halo on each side: one column each for the Sobel, the box
//     sum and the peak test) and walks down kRows output rows plus 3 halo
//     rows above and below, one source row per step, a lane per column;
//   * all 22 source rows of a walk are requested before the first is used,
//     so a warp waits for memory once and the steps run from registers
//     (the walk is otherwise a chain of one load latency per row);
//   * vertical neighbours are the lane's own last three rows, held in
//     registers (the gray values, the three products, the row maxima);
//     horizontal neighbours come from the neighbouring lanes by shuffle:
//     12 shuffles per row for all three horizontal passes;
//   * the pipeline has three lags: the step that takes source row L makes
//     the Sobel pair and products of row L - 1, the box sums and response
//     of row L - 2, and writes response and peak flag of row L - 3.
// 16 rows a walk is the measured optimum between the halo's redundant rows
// (6 of 22) and the length of a warp's chain of dependent steps.
// The borders stay exact because a lane's column and a step's row are
// frame coordinates, wrapped around the frame (column -1 is column w - 1):
// the halo across the frame's edge is then the wrapped pixel, computed
// with its own neighbours, which is what the peak test wants. Within the
// frame each pass picks its neighbours by reflect-101 of that coordinate:
// at column 0 the left neighbour is the lane to the right (column 1), at
// column w - 1 the right neighbour is the lane to the left, and the same
// for rows with the lane's own registers. A one-pixel axis is its own
// neighbour.
//
// Streams: the multi-stream step (video_stab_tpu_torch/parallel/) detects
// on N streams' analysis grays in one launch, blockIdx.z the stream, with
// gray, response and peak mask (N, h, w). vs_corner_response is N = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 3;
constexpr int kStripW = 32 - 2 * kHalo;     // output columns of a warp
constexpr int kRows = 16;                   // output rows of a warp
constexpr int kWarpsPerBlock = 4;           // neighbouring strips

// Built with -DVS_CYCLES (video_stab_tpu_torch/tools/kernel_ab.py --cycles)
// each warp also records the clock cycles it spent requesting its source
// rows and walking them; a plain build has none of this.
#ifdef VS_CYCLES
constexpr int kCycleWarps = 4096;
__device__ long long vs_cycles[2 * kCycleWarps];
#endif

// Sum of k0*a + k1*b + k2*c, left to right, each product rounded.
__device__ __forceinline__ float taps3(float k0, float a, float k1, float b,
                                       float k2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k0, a), __fmul_rn(k1, b)),
                   __fmul_rn(k2, c));
}

// (a + b) + c: a box sum's three unit taps (1 * x is x).
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

__device__ __forceinline__ float min_eig(float sxx, float syy, float sxy) {
  const float half_tr = __fmul_rn(0.5f, __fadd_rn(sxx, syy));
  const float half_df = __fmul_rn(0.5f, __fsub_rn(sxx, syy));
  const float disc =
      __fadd_rn(__fmul_rn(half_df, half_df), __fmul_rn(sxy, sxy));
  return __fsub_rn(half_tr, __fsqrt_rn(disc));
}

__device__ __forceinline__ float from_lane(float v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

// i mod n, in [0, n).
__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The row above (refl101(r - 1)) and below of a row whose neighbours in
// walking order are ``before`` and ``after``: at the frame's first row the
// reflected row above is the row after it, at the last row the row below
// is the row before it; a one-row frame reflects onto itself.
__device__ __forceinline__ float above(bool first, bool single, float before,
                                       float self, float after) {
  return first ? (single ? self : after) : before;
}

__device__ __forceinline__ float below(bool last, bool single, float before,
                                       float self, float after) {
  return last ? (single ? self : before) : after;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
corner_strip_kernel(const float* __restrict__ img, int h, int w, float scale,
                    float* __restrict__ resp_out,
                    uint8_t* __restrict__ peak_out) {
  const int lane = threadIdx.x & 31;
  const int xs = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kStripW;
  const int ys = blockIdx.y * kRows;
  if (xs >= w) return;                       // the whole warp
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  img += plane;
  resp_out += plane;
  peak_out += plane;
#ifdef VS_CYCLES
  const long long t_start = clock64();
#endif

  // The lane's column, and the lanes that hold its reflect-101 neighbours.
  const int x = xs - kHalo + lane;
  const int col = wrap(x, w);
  const int left = col == 0 ? (w == 1 ? lane : lane + 1) : lane - 1;
  const int right = col == w - 1 ? (w == 1 ? lane : lane - 1) : lane + 1;
  const bool writes = lane >= kHalo && lane < kHalo + kStripW && x < w;
  const float* __restrict__ src = img + col;
  const bool single = h == 1;

  // Every source row of the walk is requested before the first is used,
  // so the walk waits for memory once. Bit t of ``first`` / ``last``: the
  // row of step t is the frame's first / last row.
  constexpr int kSteps = kRows + 2 * kHalo;
  static_assert(kSteps <= 32, "one bit per step");
  float g[kSteps];
  unsigned first = 0, last = 0;
  {
    int row = wrap(ys - kHalo, h);
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      g[t] = __ldg(src + row * w);
      first |= (row == 0 ? 1u : 0u) << t;
      last |= (row == h - 1 ? 1u : 0u) << t;
      row = row + 1 == h ? 0 : row + 1;
    }
  }

#ifdef VS_CYCLES
  const long long t_walk = clock64();
#endif

  // Step t has source rows t - 2 .. t (L - 2 .. L) and makes row L - 1's
  // products, row L - 2's response and row L - 3's output. What the first
  // steps make of rows above the halo is never used.
  float p0[3] = {}, p1[3] = {}, p2[3] = {};         // products: L - 3 .. L - 1
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;            // maxima: L - 4 .. L - 2
  float r1 = 0.0f;                                  // response of row L - 3
#pragma unroll
  for (int t = 1; t < kSteps; ++t) {
    // Row L - 1: the Sobel pair (vertical pass in registers, horizontal by
    // shuffle) and its three products.
    {
      const float g0 = g[t >= 2 ? t - 2 : 0], g1 = g[t - 1], g2 = g[t];
      const bool top = (first >> (t - 1)) & 1u;
      const bool bottom = (last >> (t - 1)) & 1u;
      const float up = above(top, single, g0, g1, g2);
      const float dn = below(bottom, single, g0, g1, g2);
      const float hs = taps3(1.0f, up, 2.0f, g1, 1.0f, dn);    // smooth
      const float hd = taps3(-1.0f, up, 0.0f, g1, 1.0f, dn);   // diff
      const float gx = __fmul_rn(
          taps3(-1.0f, from_lane(hs, left), 0.0f, hs, 1.0f,
                from_lane(hs, right)), scale);
      const float gy = __fmul_rn(
          taps3(1.0f, from_lane(hd, left), 2.0f, hd, 1.0f,
                from_lane(hd, right)), scale);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p0[k] = p1[k];
        p1[k] = p2[k];
      }
      p2[0] = __fmul_rn(gx, gx);
      p2[1] = __fmul_rn(gy, gy);
      p2[2] = __fmul_rn(gx, gy);
    }
    if (t < 2) continue;

    // Row L - 2: the box sums (vertical first), the response, and the
    // maximum over the row's three columns, whose neighbours wrap.
    float r;
    {
      const bool top = (first >> (t - 2)) & 1u;
      const bool bottom = (last >> (t - 2)) & 1u;
      float s[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = sum3(above(top, single, p0[k], p1[k], p2[k]), p1[k],
                             below(bottom, single, p0[k], p1[k], p2[k]));
        s[k] = sum3(from_lane(v, left), v, from_lane(v, right));
      }
      r = min_eig(s[0], s[1], s[2]);
      m0 = m1;
      m1 = m2;
      m2 = fmaxf(fmaxf(from_lane(r, lane - 1), r), from_lane(r, lane + 1));
    }

    // Row L - 3: its response, and its peak flag from the three row maxima.
    const int y = ys + t - 2 * kHalo;
    if (t >= 2 * kHalo && y < h && writes) {
      resp_out[y * w + x] = r1;
      peak_out[y * w + x] = r1 >= fmaxf(fmaxf(m0, m1), m2) ? 1 : 0;
    }
    r1 = r;
  }
#ifdef VS_CYCLES
  const int warp = (blockIdx.y * gridDim.x + blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
  if (lane == 0 && warp < kCycleWarps) {
    vs_cycles[2 * warp] = t_walk - t_start;
    vs_cycles[2 * warp + 1] = clock64() - t_walk;
  }
#endif
}

}  // namespace

// gray: (n, h, w) f32; resp: (n, h, w) f32; peak: (n, h, w) bool. One
// launch on ``stream``. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int vs_corner_response_batched(const void* gray, int n, int h,
                                          int w, float scale, void* resp,
                                          void* peak, void* stream) {
  if (h <= 0 || w <= 0 || n <= 0 || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int strip = kStripW * kWarpsPerBlock;
  const dim3 grid((w + strip - 1) / strip, (h + kRows - 1) / kRows, n);
  corner_strip_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), h, w, scale,
      static_cast<float*>(resp), static_cast<uint8_t*>(peak));
  return static_cast<int>(cudaGetLastError());
}

// One frame: gray, resp and peak (h, w).
extern "C" int vs_corner_response(const void* gray, int h, int w, float scale,
                                  void* resp, void* peak, void* stream) {
  return vs_corner_response_batched(gray, 1, h, w, scale, resp, peak,
                                    stream);
}

#ifdef VS_CYCLES
// Copies the last launch's counters, (4096, 2) int64, to host memory.
extern "C" int vs_corner_cycles(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, vs_cycles, sizeof(vs_cycles)));
}
#endif
