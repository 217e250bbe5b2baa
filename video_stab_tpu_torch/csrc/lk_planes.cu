// K9: the planes LK's ladder (K6) reads, one launch a pyramid level.
//
// Replaces no Pallas kernel: the JAX package builds these planes with XLA
// ops in video_stab_tpu/ops/lk.py (each pyramid level a pair of dense
// operator matmuls, the Scharr pair banded ones, the bfloat16 rounding in
// the slab matmuls), which XLA fuses on the device. Without this kernel
// the port dispatches them from the host: each pyr_down as 5-tap
// index_select x weight + add chains along each axis, the Scharr pair as
// four reflect-padded 3-tap passes a level, the stack and the rounding,
// ~199 launches a frame at 3 levels (the plain version,
// video_stab_tpu_torch/ops/lk.py:lk_planes_plain).
//
// One launch computes level l of the prev and the curr gray of every
// stream (grid z = image x stream):
//   L = gray at l == 0, else pyr_down(level l - 1), unrounded float32;
//   prev: bf16([L, scharr_x(L), scharr_y(L)]) as (3, Hl, Wl);
//   curr: bf16(L) as (Hl, Wl);
// and, for levels below the top, L itself to a scratch buffer, which the
// next level's launch reads. bf16(x) rounds to bfloat16 (nearest even)
// and back, as the plain version's .to(torch.bfloat16).to(torch.float32).
//
// Arithmetic, bit for bit the plain version's (--fmad=false and
// __fmul_rn / __fadd_rn, so nothing is fused into an FMA):
//  - pyr_down, H first, then W: output o of an axis is the sum over the
//    operator row's taps t of src[idx[t][o]] * w[t][o], each product
//    rounded to float32, summed in tap order starting from the first
//    product. The taps are the plain version's own table
//    (ops/resize.py:_taps("pyr", ...): reflect-101 merged weights in
//    ascending source order, padded with zero-weight taps at index 0),
//    passed to the kernel as (k, n_out) tensors. The zero taps are
//    summed too (x * 0 carries x's sign), reading source row 0 or the H
//    pass at source column 0 where the block's window does not hold them.
//  - Scharr: sep_filter2d(L, smooth, diff) and sep_filter2d(L, diff,
//    smooth), smooth = (3, 10, 3) / 16, diff = (-1/2, 0, 1/2): H first,
//    then W, reflect-101, the three taps summed left to right with each
//    product rounded, the zero middle tap included.
//  - The Scharr pair and the next pyr_down read the unrounded L; only
//    the planes K6 reads are rounded.
//
// Bound on the H100: bytes. At 540 x 960 with 3 levels a call reads both
// grays twice (levels 0 and 1), writes 3 + 1 planes a level and the
// scratch level between launches: 21.3 MB, 6.3 us at 3.35 TB/s; the
// arithmetic is ~60 operations an output pixel. A block of kWarps warps
// owns a kTileH x kTileW tile of level l, a warp a tile row at a time (128
// contiguous bytes a plane). It stages in shared memory the source
// window under the tile and its 1-pixel Scharr halo (2 * tile + 7 a side:
// 4 source pixels before the tile, 3 after its last pair; the genuine
// taps of the halo'd rows all fall in it, since reflections fold inward),
// each thread's share loaded into registers at once so that its loads
// are in flight together, and the operator taps of the halo'd rows and
// columns; then runs pyr_down's H pass and W pass over the halo'd tile
// and Scharr's vertical and horizontal passes there, and writes each
// output once. Halo pixels outside the level are its reflect-101 images,
// so border blocks take no other code. Level 0 stages the gray itself;
// its curr plane is the rounding alone. The small levels (tens to a few
// hundred blocks) are bound by a block's latency, not by bytes. The
// launches of one call are stream-ordered, so no host read is needed
// between levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;                 // level rows a block
constexpr int kTileW = 32;                 // level columns a block: a warp
constexpr int kWarps = 8;                  // a block is kTileW x kWarps
constexpr int kThreads = kTileW * kWarps;
constexpr int kMaxTaps = 5;                // pyr_down taps a row (1 4 6 4 1)
constexpr int kHaloH = kTileH + 2;         // with Scharr's 1-pixel halo
constexpr int kHaloW = kTileW + 2;
constexpr int kSrcH = 2 * kTileH + 7;      // source rows under a halo'd tile
constexpr int kSrcW = 2 * kTileW + 7;
// A thread's share of a staged window, loaded into registers at once so
// that its loads are in flight together.
constexpr int kStageRows = (kSrcH + kWarps - 1) / kWarps;
constexpr int kStageCols = (kSrcW + kTileW - 1) / kTileW;
constexpr int kHaloRows = (kHaloH + kWarps - 1) / kWarps;
constexpr int kHaloCols = (kHaloW + kTileW - 1) / kTileW;
constexpr int kColRows = (kSrcH + kTileW - 1) / kTileW;
static_assert(kTileH % kWarps == 0, "whole tile rows a warp");
static_assert(kThreads >= 2 * kTileW && kThreads >= kHaloH, "staging lanes");

// Scharr's taps (ops/filters.py:scharr_derivs), exact in float32.
constexpr float kSmooth0 = 3.0f / 16.0f;
constexpr float kSmooth1 = 10.0f / 16.0f;
constexpr float kDiff0 = -0.5f;
constexpr float kDiff1 = 0.0f;
constexpr float kDiff2 = 0.5f;

// BORDER_REFLECT_101 of an index (ops/filters.py:reflect_101_index), by
// reflecting until it lies in [0, n): one step for the 1-pixel halo.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ((a * k0 + b * k1) + c * k2), each product rounded: correlate_1d's
// left-to-right sum of three taps.
__device__ __forceinline__ float taps3(float a, float b, float c, float k0,
                                       float k1, float k2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, k0), __fmul_rn(b, k1)),
                   __fmul_rn(c, k2));
}

__global__ void __launch_bounds__(kThreads)
lk_planes_kernel(const float* __restrict__ src_prev,
                 const float* __restrict__ src_curr, int n, int hs, int ws,
                 int hl, int wl, int down,
                 const long long* __restrict__ idx_h,
                 const float* __restrict__ w_h, int k_h,
                 const long long* __restrict__ idx_w,
                 const float* __restrict__ w_w, int k_w,
                 float* __restrict__ prev_out, float* __restrict__ curr_out,
                 float* __restrict__ next_prev,
                 float* __restrict__ next_curr) {
  // Source rows sr0 .., cols sc0 ..; row kSrcH: source row 0 there.
  __shared__ float s_src[kSrcH + 1][kSrcW];
  // Source column 0 of rows sr0 ..; entry kSrcH: source pixel (0, 0).
  __shared__ float s_col0[kSrcH + 1];
  __shared__ float s_v[kHaloH][kSrcW];     // pyr_down's H pass
  __shared__ float s_v0[kHaloH];           // and at source column 0
  __shared__ float s_l[kHaloH][kHaloW];    // level l, with the halo
  __shared__ float s_a[kTileH][kHaloW];    // smooth along H (for d/dx)
  __shared__ float s_b[kTileH][kHaloW];    // diff along H (for d/dy)
  // The halo'd rows' and columns' pyr_down taps: source index and weight.
  __shared__ int s_ti_h[kHaloH][kMaxTaps];
  __shared__ float s_tw_h[kHaloH][kMaxTaps];
  __shared__ int s_ti_w[kHaloW][kMaxTaps];
  __shared__ float s_tw_w[kHaloW][kMaxTaps];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const bool is_prev = static_cast<int>(blockIdx.z) < n;
  const int stream = is_prev ? blockIdx.z : blockIdx.z - n;
  const long long plane = static_cast<long long>(hl) * wl;
  const float* src = (is_prev ? src_prev : src_curr) +
                     static_cast<long long>(stream) * hs * ws;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const int t_rows = min(kTileH, hl - r0);
  const int t_cols = min(kTileW, wl - c0);
  float* next = is_prev ? next_prev : next_curr;

  if (!down && !is_prev) {
    // Level 0's curr plane: the rounding alone.
    float* out = curr_out + stream * plane;
    float v[kTileH / kWarps];
#pragma unroll
    for (int i = 0; i < kTileH / kWarps; ++i) {
      const int r = ty + i * kWarps;
      v[i] = (r < t_rows && tx < t_cols)
                 ? src[static_cast<long long>(r0 + r) * wl + c0 + tx]
                 : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTileH / kWarps; ++i) {
      const int r = ty + i * kWarps;
      if (r < t_rows && tx < t_cols) {
        out[static_cast<long long>(r0 + r) * wl + c0 + tx] = bf16_round(v[i]);
      }
    }
    return;
  }

  // Halo'd rows i = r0 - 1 .. min(r0 + kTileH, hl): past hl no output or
  // Scharr tap reads them. Columns likewise.
  const int rows = min(kHaloH, hl - r0 + 2);
  const int cols = min(kHaloW, wl - c0 + 2);

  if (!down) {
    // Level 0: the gray itself over the halo'd tile.
    float v[kHaloRows][kHaloCols];
#pragma unroll
    for (int i = 0; i < kHaloRows; ++i) {
      const int r = ty + i * kWarps;
      const long long row =
          static_cast<long long>(reflect101(r0 - 1 + r, hl)) * ws;
#pragma unroll
      for (int j = 0; j < kHaloCols; ++j) {
        const int c = tx + j * kTileW;
        v[i][j] = (r < rows && c < cols)
                      ? src[row + reflect101(c0 - 1 + c, wl)]
                      : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kHaloRows; ++i) {
#pragma unroll
      for (int j = 0; j < kHaloCols; ++j) {
        const int r = ty + i * kWarps, c = tx + j * kTileW;
        if (r < rows && c < cols) s_l[r][c] = v[i][j];
      }
    }
  } else {
    // 1. The source under the halo'd tile, whose genuine taps all lie in
    //    [2 r0 - 4, 2 (r0 + kTileH) + 2] (reflections fold inward), and the
    //    taps of the halo'd rows and columns.
    const int sr0 = max(0, 2 * r0 - 4);
    const int sr1 = min(hs - 1, 2 * (r0 + kTileH) + 2);
    const int sc0 = max(0, 2 * c0 - 4);
    const int sc1 = min(ws - 1, 2 * (c0 + kTileW) + 2);
    const int s_rows = sr1 - sr0 + 1, s_cols = sc1 - sc0 + 1;
    float v[kStageRows][kStageCols];
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) {
      const int r = ty + i * kWarps;
      const float* row = src + static_cast<long long>(sr0 + r) * ws + sc0;
#pragma unroll
      for (int j = 0; j < kStageCols; ++j) {
        const int c = tx + j * kTileW;
        v[i][j] = (r < s_rows && c < s_cols) ? row[c] : 0.0f;
      }
    }
    // Source row 0 and column 0, which the zero taps of the last rows and
    // columns read where the window does not hold them.
    float v0[kStageCols];
#pragma unroll
    for (int j = 0; j < kStageCols; ++j) {
      const int c = tx + j * kTileW;
      v0[j] = (ty == 0 && sr0 > 0 && c < s_cols) ? src[sc0 + c] : 0.0f;
    }
    float vc[kColRows];
#pragma unroll
    for (int j = 0; j < kColRows; ++j) {
      const int r = tx + j * kTileW;
      vc[j] = (ty == 1 && sc0 > 0 && r < s_rows)
                  ? src[static_cast<long long>(sr0 + r) * ws]
                  : 0.0f;
    }
    const float corner = (tid == 0 && sr0 > 0 && sc0 > 0) ? src[0] : 0.0f;
    // (The taps' loads go out while the window's are in flight.)
    for (int e = tid; e < (kHaloH + kHaloW) * kMaxTaps; e += kThreads) {
      const int j = e / kMaxTaps, t = e - (e / kMaxTaps) * kMaxTaps;
      if (j < kHaloH) {
        if (j < rows && t < k_h) {
          const int o = reflect101(r0 - 1 + j, hl);
          s_ti_h[j][t] = static_cast<int>(__ldg(idx_h + t * hl + o));
          s_tw_h[j][t] = __ldg(w_h + t * hl + o);
        }
      } else if (j - kHaloH < cols && t < k_w) {
        const int o = reflect101(c0 - 1 + j - kHaloH, wl);
        s_ti_w[j - kHaloH][t] = static_cast<int>(__ldg(idx_w + t * wl + o));
        s_tw_w[j - kHaloH][t] = __ldg(w_w + t * wl + o);
      }
    }
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) {
#pragma unroll
      for (int j = 0; j < kStageCols; ++j) {
        const int r = ty + i * kWarps, c = tx + j * kTileW;
        if (r < s_rows && c < s_cols) s_src[r][c] = v[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < kStageCols; ++j) {
      const int c = tx + j * kTileW;
      if (ty == 0 && sr0 > 0 && c < s_cols) s_src[kSrcH][c] = v0[j];
    }
#pragma unroll
    for (int j = 0; j < kColRows; ++j) {
      const int r = tx + j * kTileW;
      if (ty == 1 && sc0 > 0 && r < s_rows) s_col0[r] = vc[j];
    }
    if (tid == 0 && sr0 > 0 && sc0 > 0) s_col0[kSrcH] = corner;
    __syncthreads();
    // 2. The H pass at every staged column of the halo'd rows, and, where
    //    column 0 is not staged, at column 0 for the W pass's zero taps.
    //    Only a zero tap (index 0) falls outside the window: it reads the
    //    staged row 0.
    // Each thread's items are unrolled so that their tap chains interleave.
#pragma unroll
    for (int i = 0; i < kHaloRows; ++i) {
#pragma unroll
      for (int j = 0; j < kStageCols; ++j) {
        const int r = ty + i * kWarps, c = tx + j * kTileW;
        if (r < rows && c < s_cols) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < kMaxTaps; ++t) {
            if (t < k_h) {
              const int sr = s_ti_h[r][t];
              const float x = (sr >= sr0 && sr <= sr1) ? s_src[sr - sr0][c]
                                                       : s_src[kSrcH][c];
              const float p = __fmul_rn(x, s_tw_h[r][t]);
              acc = t == 0 ? p : __fadd_rn(acc, p);
            }
          }
          s_v[r][c] = acc;
        }
      }
    }
    // Column 0 by the last warp's lanes (the warp with the fewest rows).
    const int r_v0 = tid - (kThreads - kHaloH);
    if (sc0 > 0 && r_v0 >= 0 && r_v0 < rows) {
      const int r = r_v0;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t < k_h) {
          const int sr = s_ti_h[r][t];
          const float x = (sr >= sr0 && sr <= sr1) ? s_col0[sr - sr0]
                                                   : s_col0[kSrcH];
          const float p = __fmul_rn(x, s_tw_h[r][t]);
          acc = t == 0 ? p : __fadd_rn(acc, p);
        }
      }
      s_v0[r] = acc;
    }
    __syncthreads();
    // 3. The W pass: level l over the halo'd tile. A zero tap (column 0)
    //    outside the window reads the H pass there.
#pragma unroll
    for (int i = 0; i < kHaloRows; ++i) {
#pragma unroll
      for (int j = 0; j < kHaloCols; ++j) {
        const int r = ty + i * kWarps, c = tx + j * kTileW;
        if (r < rows && c < cols) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < kMaxTaps; ++t) {
            if (t < k_w) {
              const int sc = s_ti_w[c][t];
              const float x =
                  (sc >= sc0 && sc <= sc1) ? s_v[r][sc - sc0] : s_v0[r];
              const float p = __fmul_rn(x, s_tw_w[c][t]);
              acc = t == 0 ? p : __fadd_rn(acc, p);
            }
          }
          s_l[r][c] = acc;
        }
      }
    }
  }
  __syncthreads();

  if (!is_prev) {
    float* out = curr_out + stream * plane;
#pragma unroll
    for (int i = 0; i < kTileH / kWarps; ++i) {
      const int r = ty + i * kWarps;
      if (r < t_rows && tx < t_cols) {
        const float v = s_l[r + 1][tx + 1];
        const long long at = static_cast<long long>(r0 + r) * wl + c0 + tx;
        out[at] = bf16_round(v);
        if (next != nullptr) next[stream * plane + at] = v;
      }
    }
    return;
  }

  // 4. Scharr's vertical passes over the tile's rows and the halo columns.
#pragma unroll
  for (int i = 0; i < kTileH / kWarps; ++i) {
#pragma unroll
    for (int j = 0; j < kHaloCols; ++j) {
      const int r = ty + i * kWarps, c = tx + j * kTileW;
      if (r < t_rows && c < cols) {
        const float a = s_l[r][c], b = s_l[r + 1][c], d = s_l[r + 2][c];
        s_a[r][c] = taps3(a, b, d, kSmooth0, kSmooth1, kSmooth0);
        s_b[r][c] = taps3(a, b, d, kDiff0, kDiff1, kDiff2);
      }
    }
  }
  __syncthreads();
  // 5. The horizontal passes and the planes, a warp a row.
  float* out = prev_out + stream * 3 * plane;
#pragma unroll
  for (int i = 0; i < kTileH / kWarps; ++i) {
    const int r = ty + i * kWarps;
    if (r < t_rows && tx < t_cols) {
      const int c = tx;
      const float ix = taps3(s_a[r][c], s_a[r][c + 1], s_a[r][c + 2], kDiff0,
                             kDiff1, kDiff2);
      const float iy = taps3(s_b[r][c], s_b[r][c + 1], s_b[r][c + 2],
                             kSmooth0, kSmooth1, kSmooth0);
      const float v = s_l[r + 1][c + 1];
      const long long at = static_cast<long long>(r0 + r) * wl + c0 + c;
      out[at] = bf16_round(v);
      out[plane + at] = bf16_round(ix);
      out[2 * plane + at] = bf16_round(iy);
      if (next != nullptr) next[stream * plane + at] = v;
    }
  }
}

}  // namespace

// Level l of n streams' prev and curr grays. src_prev / src_curr: (n, hs,
// ws) float32, contiguous (level l - 1, or the grays at l = 0 with down =
// 0 and (hl, wl) = (hs, ws)). With down: (hl, wl) = ((hs + 1) / 2, (ws +
// 1) / 2) and the pyr_down tables idx_h (int64) / w_h (float32) of shape
// (k_h, hl), idx_w / w_w of shape (k_w, wl). prev_out: (n, 3, hl, wl);
// curr_out: (n, hl, wl); next_prev / next_curr: (n, hl, wl) unrounded
// level l, both or neither.
extern "C" int vs_lk_planes(const void* src_prev, const void* src_curr,
                            int n, int hs, int ws, int hl, int wl, int down,
                            const void* idx_h, const void* w_h, int k_h,
                            const void* idx_w, const void* w_w, int k_w,
                            void* prev_out, void* curr_out, void* next_prev,
                            void* next_curr, void* stream) {
  if (n < 1 || hs < 1 || ws < 1 || src_prev == nullptr ||
      src_curr == nullptr || prev_out == nullptr || curr_out == nullptr ||
      (next_prev == nullptr) != (next_curr == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (down) {
    if (hl != (hs + 1) / 2 || wl != (ws + 1) / 2 || k_h < 1 ||
        k_h > kMaxTaps || k_w < 1 || k_w > kMaxTaps || idx_h == nullptr ||
        w_h == nullptr || idx_w == nullptr || w_w == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (hl != hs || wl != ws) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((wl + kTileW - 1) / kTileW, (hl + kTileH - 1) / kTileH,
                  2 * n);
  if (grid.y > 65535u || grid.z > 65535u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lk_planes_kernel<<<grid, dim3(kTileW, kWarps), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src_prev),
      static_cast<const float*>(src_curr), n, hs, ws, hl, wl, down ? 1 : 0,
      static_cast<const long long*>(idx_h), static_cast<const float*>(w_h),
      k_h, static_cast<const long long*>(idx_w),
      static_cast<const float*>(w_w), k_w, static_cast<float*>(prev_out),
      static_cast<float*>(curr_out), static_cast<float*>(next_prev),
      static_cast<float*>(next_curr));
  return static_cast<int>(cudaGetLastError());
}
