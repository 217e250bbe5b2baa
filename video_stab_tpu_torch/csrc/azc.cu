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

// ---------------------------------------------------------------------------
// K8: auto zoom-crop's content mask, gray, threshold and close, in one
// launch.
//
// Replaces no Pallas kernel: in the JAX package the mask is XLA ops
// (video_stab_tpu/core/autozoomcrop.py:105-107, ops/filters.py:141-160).
// Without this kernel the port dispatches it from the host: the gray, the
// threshold, and for each of the ellipse's off-centre offsets, in the
// dilate and again in the erode, a roll of the whole plane, its validity
// mask and a max or min, ~550 launches a frame at ksize 5 (the plain
// version, video_stab_tpu_torch/core/autozoomcrop.py:content_mask_plain).
//
// Computes morph_close(threshold_binary(bgr_to_gray(frame), thresh, 255),
// ksize) bit for bit: gray = (b * 0.114 + g * 0.587) + r * 0.299, each
// product rounded to float32 (__fmul_rn / __fadd_rn, no contraction, as
// K4's gray in csrc/enhance.cu); content = gray > thresh in float32; a
// dilate over the ellipse of ops/filters.py:_ellipse_offsets(ksize), the
// neighbours outside the frame skipped (its -inf fill), then an erode over
// the same ellipse, the outside skipped again (+inf). On a 0 / 255 mask
// max and min are OR and AND, so the close runs on bits. Input: the
// contiguous float32 (h, w, 3) BGR frame; output: the (h, w) float32 0 /
// 255 plane.
//
// The ellipse is one run of dx in [-hw, hw] per row dy in [-r, r]; the
// wrapper passes the run's half-widths, 4 bits a row (row dy in bits
// 4 (dy + r) ..), r <= kMaskMaxR (ksize <= 15).
//
// Bound on the H100: bytes. 1080p reads 24.9 MB and writes 8.3 MB: 9.9 us
// at 3.35 TB/s. The close itself is a few integer operations a 32-pixel
// word. A block takes a tile of kTileRows rows by kTileWords 32-pixel
// words and reads the frame once for it plus a halo of 2r rows above and
// below and 2r columns left and right (only the lanes of those columns
// load): 1.3 times the tile's bytes at r = 2, the halo mostly from L2,
// where the neighbouring tiles have just read it. The reads are
// per-lane (b, g, r) loads of neighbouring pixels, kBatch row-words a
// warp in flight at once; the threshold of a warp's 32 pixels becomes one
// word by __ballot_sync, in shared memory. The dilate ORs each row's run
// as funnel shifts of a word and its neighbours, over the tile plus an
// r-row, one-word halo; outside the frame its bits are set (what the
// erode skips). The erode ANDs likewise over the tile. Each output pixel
// is written once, 128 contiguous bytes a warp.

namespace {

constexpr int kMaskMaxR = 7;
constexpr int kMaskThreads = 512;
constexpr int kMaskWarps = kMaskThreads / 32;
constexpr int kTileWords = 8;                  // 256 output columns
constexpr int kTileRows = 32;
constexpr int kRowWords = kTileWords + 2;      // a halo word each side
constexpr int kBatch = 8;                      // row-words in flight a warp

__device__ __forceinline__ float gray_bgr(float b, float g, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(b, 0.114f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(r, 0.299f));
}

__host__ __device__ __forceinline__ int half_width(
    unsigned long long hw_bits, int row) {
  return static_cast<int>((hw_bits >> (4 * row)) & 15ull);
}

// Bit i of the result: the OR (dilate) or AND (erode) of bits i - hw ..
// i + hw of the row ... left | word | right ..., bit 0 the leftmost pixel.
template <bool kOr>
__device__ __forceinline__ unsigned run_of(unsigned left, unsigned word,
                                           unsigned right, int hw) {
  unsigned v = word;
  for (int s = 1; s <= hw; ++s) {
    const unsigned a = __funnelshift_r(word, right, s);  // pixel x + s
    const unsigned b = __funnelshift_l(left, word, s);   // pixel x - s
    v = kOr ? (v | a | b) : (v & a & b);
  }
  return v;
}

// The bits of the word whose bit 0 is pixel (y, xs) that lie in the frame.
__device__ __forceinline__ unsigned in_frame_bits(int y, int xs, int h,
                                                  int w) {
  if (y < 0 || y >= h) return 0u;
  const int lo = max(0, -xs), hi = min(32, w - xs);
  if (hi <= lo) return 0u;
  return static_cast<unsigned>(((1ull << hi) - 1ull) & ~((1ull << lo) - 1ull));
}

__global__ void __launch_bounds__(kMaskThreads)
content_mask_kernel(const float* __restrict__ frame, int h, int w,
                    float thresh, int r, unsigned long long hw_bits,
                    float* __restrict__ out) {
  // m: rows y0 - 2r ..; d: rows y0 - r ..; both words -1 .. kTileWords.
  __shared__ unsigned m[kTileRows + 4 * kMaskMaxR][kRowWords];
  __shared__ unsigned d[kTileRows + 2 * kMaskMaxR][kRowWords];
  __shared__ unsigned e[kTileRows][kTileWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTileWords * 32;
  const int y0 = blockIdx.y * kTileRows;
  const int wx = x0 - 32;                    // column of word -1's bit 0

  // 1. The threshold's bits, a row-word a warp.
  const int m_items = (kTileRows + 4 * r) * kRowWords;
  for (int base = warp; base < m_items; base += kMaskWarps * kBatch) {
    float cb[kBatch], cg[kBatch], cr[kBatch];
    bool in[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = base + k * kMaskWarps;
      const int row = item / kRowWords;
      const int word = item - row * kRowWords;
      const int y = y0 - 2 * r + row;
      const int x = wx + 32 * word + lane;
      // Of the halo words only the 2r columns next to the tile are read.
      const bool need = (word > 0 || lane >= 32 - 2 * r) &&
                        (word < kRowWords - 1 || lane < 2 * r);
      in[k] = item < m_items && need && y >= 0 && y < h && x >= 0 && x < w;
      cb[k] = cg[k] = cr[k] = 0.0f;
      if (in[k]) {
        const float* p = frame + 3 * (static_cast<long long>(y) * w + x);
        cb[k] = __ldg(p);
        cg[k] = __ldg(p + 1);
        cr[k] = __ldg(p + 2);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = base + k * kMaskWarps;
      const unsigned bits = __ballot_sync(
          kFull, in[k] && gray_bgr(cb[k], cg[k], cr[k]) > thresh);
      if (lane == 0 && item < m_items) (&m[0][0])[item] = bits;
    }
  }
  __syncthreads();

  // 2. The dilate over the tile and an r-row, one-word halo; bits outside
  //    the frame set.
  const int d_items = (kTileRows + 2 * r) * kRowWords;
  for (int item = tid; item < d_items; item += kMaskThreads) {
    const int row = item / kRowWords;
    const int word = item - row * kRowWords;
    unsigned acc = 0u;
    for (int dy = -r; dy <= r; ++dy) {
      const unsigned* mr = m[row + r + dy];
      acc |= run_of<true>(word > 0 ? mr[word - 1] : 0u, mr[word],
                          word < kRowWords - 1 ? mr[word + 1] : 0u,
                          half_width(hw_bits, dy + r));
    }
    d[row][word] = acc | ~in_frame_bits(y0 - r + row, wx + 32 * word, h, w);
  }
  __syncthreads();

  // 3. The erode over the tile.
  for (int item = tid; item < kTileRows * kTileWords; item += kMaskThreads) {
    const int row = item / kTileWords;
    const int word = item - row * kTileWords + 1;
    unsigned acc = ~0u;
    for (int dy = -r; dy <= r; ++dy) {
      const unsigned* dr = d[row + r + dy];
      acc &= run_of<false>(dr[word - 1], dr[word], dr[word + 1],
                           half_width(hw_bits, dy + r));
    }
    e[row][word - 1] = acc;
  }
  __syncthreads();

  // 4. The tile's pixels, 0 or 255.
  for (int idx = tid; idx < kTileRows * kTileWords * 32;
       idx += kMaskThreads) {
    const int row = idx / (kTileWords * 32);
    const int col = idx - row * (kTileWords * 32);
    const int y = y0 + row, x = x0 + col;
    if (y < h && x < w) {
      out[static_cast<long long>(y) * w + x] =
          ((e[row][col >> 5] >> (col & 31)) & 1u) ? 255.0f : 0.0f;
    }
  }
}

}  // namespace

// frame: (h, w, 3) f32 BGR, contiguous; out: (h, w) f32; hw_bits: the
// ellipse's half-width of row dy in bits 4 (dy + r) .. 4 (dy + r) + 3.
extern "C" int vs_content_mask(const void* frame, int h, int w, float thresh,
                               int r, unsigned long long hw_bits, void* out,
                               void* stream) {
  if (h <= 0 || w <= 0 || r < 0 || r > kMaskMaxR || frame == nullptr ||
      out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int row = 0; row <= 2 * r; ++row) {
    if (half_width(hw_bits, row) > r) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((w + kTileWords * 32 - 1) / (kTileWords * 32),
                  (h + kTileRows - 1) / kTileRows);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  content_mask_kernel<<<grid, kMaskThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frame), h, w, thresh, r, hw_bits,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
