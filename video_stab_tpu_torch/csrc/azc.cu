// K7: auto zoom-crop's shrink loop, interior_rect, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs the loop as a
// jax.lax.while_loop (video_stab_tpu/core/autozoomcrop.py:interior_rect),
// which XLA keeps on the device. Without this kernel the port dispatches
// the loop from the host, about a hundred small tensor ops an iteration
// and a blocking read of a "still shrinking" flag every 32 iterations
// (the plain version, video_stab_tpu_torch/core/autozoomcrop.py).
//
// Input: the flat int32 table `cum` of per-row prefix sums of the holes
// (h rows of w + 1 entries, each row starting at 0) followed by per-column
// ones (w columns of h + 1). Output: the (4,) int32 rect [x0, y0, x1, y1],
// inclusive corners.
//
// 1. The starting rect, by the whole block: the first and last rows and
//    columns that hold content. Row r holds content iff its holes, the
//    last entry of its prefix row, are fewer than w (columns likewise with
//    h): the plain version's `any` over the mask, read from the table.
//    Each thread tests a few rows and columns; warp minima and maxima
//    (__reduce_*_sync), then warp 0 reduces the warps' results.
// 2. The loop, by warp 0 alone. An iteration: lanes 0-7 each load one of
//    the eight table entries whose differences are the holes on the
//    rect's four edges (the edges clamped into the frame, as the plain
//    _edge_holes does), eight shuffles give every lane the four counts,
//    and every lane applies the plain _shrink's rule in integers: stop
//    when no edge has a hole or the rect is empty, else move the edge(s)
//    the decision tree picks, and on a tie every edge that has a hole.
//    The loop ends there or after max_iters moves, as the JAX loop's
//    condition does.
//
// All of it is integer arithmetic on the same counts, so the rect is the
// plain version's, and the JAX package's, bit for bit.
//
// Bound on the H100: latency. An iteration is one round of dependent loads
// (the addresses follow from the last move) that hit L2, where the cumsums
// have just written the table (16.6 MB at 1080p of the 50 MB), then a few
// dozen dependent integer operations and shuffles: a few hundred cycles.
// The loop runs at most h + w iterations (each moves an edge inward). So
// the design keeps the whole loop in one launch with no host round trip,
// and each iteration to one load round.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Warp 0 reduces one partial per warp, a lane each.
static_assert(kWarps == 32, "one partial per lane of warp 0");

__device__ __forceinline__ int clamp_to(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
interior_rect_kernel(const int* __restrict__ cum, int h, int w,
                     int max_iters, int* __restrict__ rect) {
  __shared__ int part[4][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = h * (w + 1);  // where the per-column table starts

  // 1. The starting rect: [first column, first row, last column, last row]
  //    with content; (w, h, -1, -1) where there is none.
  int y0 = h, y1 = -1, x0 = w, x1 = -1;
  for (int r = tid; r < h; r += kThreads) {
    if (cum[r * (w + 1) + w] < w) {
      y0 = min(y0, r);
      y1 = max(y1, r);
    }
  }
  for (int c = tid; c < w; c += kThreads) {
    if (cum[col + c * (h + 1) + h] < h) {
      x0 = min(x0, c);
      x1 = max(x1, c);
    }
  }
  x0 = __reduce_min_sync(kFull, x0);
  y0 = __reduce_min_sync(kFull, y0);
  x1 = __reduce_max_sync(kFull, x1);
  y1 = __reduce_max_sync(kFull, y1);
  if (lane == 0) {
    part[0][warp] = x0;
    part[1][warp] = y0;
    part[2][warp] = x1;
    part[3][warp] = y1;
  }
  __syncthreads();
  if (warp != 0) return;
  x0 = __reduce_min_sync(kFull, part[0][lane]);
  y0 = __reduce_min_sync(kFull, part[1][lane]);
  x1 = __reduce_max_sync(kFull, part[2][lane]);
  y1 = __reduce_max_sync(kFull, part[3][lane]);

  // 2. The shrink loop. Lane e < 8 reads entry e of the pairs
  //    (left: column x0, rows y0..y1), (top: row y0, columns x0..x1),
  //    (right: column x1), (bottom: row y1); the even entry is the end of
  //    the range (+1), the odd one its start.
  const int edge = lane >> 1;
  const bool end = (lane & 1) == 0;
  for (int it = 0; it < max_iters; ++it) {
    const int cx0 = clamp_to(x0, 0, w - 1), cy0 = clamp_to(y0, 0, h - 1);
    const int cx1 = clamp_to(x1, 0, w - 1), cy1 = clamp_to(y1, 0, h - 1);
    int v = 0;
    if (lane < 8) {
      int idx;
      if ((edge & 1) == 0) {  // left, right: a column's prefix sums
        idx = col + (edge == 0 ? cx0 : cx1) * (h + 1) +
              (end ? cy1 + 1 : cy0);
      } else {                // top, bottom: a row's prefix sums
        idx = (edge == 1 ? cy0 : cy1) * (w + 1) + (end ? cx1 + 1 : cx0);
      }
      v = cum[idx];
    }
    const int cl = __shfl_sync(kFull, v, 0) - __shfl_sync(kFull, v, 1);
    const int ct = __shfl_sync(kFull, v, 2) - __shfl_sync(kFull, v, 3);
    const int cr = __shfl_sync(kFull, v, 4) - __shfl_sync(kFull, v, 5);
    const int cb = __shfl_sync(kFull, v, 6) - __shfl_sync(kFull, v, 7);
    const int total = cl + ct + cr + cb;
    if (!(total > 0 && x0 < x1 && y0 < y1)) break;
    const bool top = ct > cb && ct > cl && ct > cr;
    const bool bottom = !(ct > cb) && cb > cl && cb > cr;
    const bool left = cl >= cr && cl >= cb && cl >= ct;
    const bool right = !(cl >= cr) && cr >= ct && cr >= cb;
    // Guarantee progress when the counts tie everywhere (total > 0 here).
    const bool tie = !(top || bottom || left || right);
    x0 += (left || (tie && cl > 0)) ? 1 : 0;
    y0 += (top || (tie && ct > 0)) ? 1 : 0;
    x1 -= (right || (tie && cr > 0)) ? 1 : 0;
    y1 -= (bottom || (tie && cb > 0)) ? 1 : 0;
  }
  if (lane == 0) {
    rect[0] = x0;
    rect[1] = y0;
    rect[2] = x1;
    rect[3] = y1;
  }
}

}  // namespace

extern "C" int vs_interior_rect(const void* cum, int h, int w, int max_iters,
                                void* rect, void* stream) {
  if (h <= 0 || w <= 0 || cum == nullptr || rect == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interior_rect_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cum), h, w, max_iters, static_cast<int*>(rect));
  return static_cast<int>(cudaGetLastError());
}
