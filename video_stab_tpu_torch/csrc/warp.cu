// K1: affine warp and K2: projective warp, u8 HWC -> u8 HWC, exact
// bilinear (cv2.warpAffine / cv2.warpPerspective).
//
// Replace the Pallas kernel video_stab_tpu/pallas/warp.py:_warp_kernel,
// driven by _warp_u8_impl through warp_affine_u8 (K1) and through
// warp_homography_u8 with projective=True (K2).
//
// dst(x, y) = src(M^-1 (x, y)) with bilinear sampling in float32, rounded
// half to even (rintf) and clipped to [0, 255]. M^-1 (6 values, or 9 for
// K2) is read from a device pointer, so a frame's matrix never crosses to
// the host. Border modes are the index maps of
// video_stab_tpu/ops/warp.py:_map_index, per tap; the constant mode
// substitutes border_value for each tap outside the source.
//
// K2 follows the JAX CPU path (video_stab_tpu/ops/warp.py:warp_perspective),
// not the Pallas kernel: the inverse is not normalized by h22, the
// denominator (g*x + h*y) + i is set to 1e-9 where its magnitude is below
// 1e-9, and sx, sy are IEEE divides (__fdiv_rn), not a reciprocal multiply.
//
// Bound on the H100. By bytes, 3.7 us for a 1080p x3 frame (6.2 MB read,
// each source byte about once, the neighbouring taps from L1/L2, and
// 6.2 MB written, at 3.35 TB/s). But the exact arithmetic is long: the
// interior path issues ~125 instructions per pixel (SASS of the C = 3
// kernel: 27 float operations of the blend, 24 to turn 12 tap bytes into
// floats, coordinates, floors, addresses, 6 loads, rounding, packing),
// and 2 M pixels of that take the card's issue rate for ~8 us. So the
// kernel is bound by instruction issue, not bytes, and the design spends
// instructions sparingly (PERF.md has the measured variants: staging the
// source footprint in shared memory and staging the stores through it
// were both slower than reading taps through L1):
// - each thread computes kRun = 4 horizontally adjacent output pixels and
//   stores them as one (C = 1) or three (C = 3) aligned 32-bit words; a
//   run past the row's end, or a row that does not start on a word,
//   stores byte by byte;
// - the border mode and C are template parameters (5 x 2 x {affine,
//   projective}), chosen once per launch on the host;
// - each warp computes one output row of a 128-pixel tile. In the C = 3
//   affine kernel (the emit warp) the warp maps the row's two ends
//   through M^-1 with the same arithmetic as each pixel (two lanes, then a
//   shuffle). When both lie 2 px inside [0, w-1) x [0, h-1), no tap of
//   the row can leave the source, and the warp skips the index maps and
//   validity tests: each source row's 6 tap bytes come from two or three
//   aligned 32-bit loads, shifted into place. For a stabilizing map that
//   is nearly every warp; the rest take the general per-tap path. Timed
//   against the same kernel without it, this interior path saves ~8 % of
//   the 1080p emit warp, but makes the C = 1 kernel slower and the
//   projective one no faster (PERF.md), so only that kernel has it;
// - no conversion unit (an eighth of the FP32 rate) on the interior
//   path: floor(s) for 0 <= s < 2^22 is s + 2^23 (rounded to an
//   integer) - 2^23, less 1 where that is above s, and the integer is in
//   the sum's bits; a byte placed in the mantissa of 2^23 (one byte
//   permute) less 2^23 is its value; and a value in [0, 255] plus 2^23 is
//   rounded half to even into its low byte, which is rint and the u8 cast
//   in one add (both paths).
// Either way each pixel's value is the same.
//
// Streams: the multi-stream emit (video_stab_tpu_torch/parallel/) warps N
// streams' queued frames in one launch, blockIdx.z the stream. The source
// is the streams' (N, Q, H, W, C) frame ring with a device int32 (N,)
// table of the slot each stream emits, so stream n reads frame
// ring + (n * Q + slot[n]) * H * W * C in place: no frame is gathered out
// of the ring first, and no slot is read on the host. M^-1 is (N, 6) or
// (N, 9), the output (N, oh, ow, C). The single-frame entries are the
// N = 1, Q = 1 case with no slot table, compiled without the stream
// offsets (kBatched false).
//
// The coordinate and blend arithmetic uses __fmul_rn/__fadd_rn, which are
// never contracted into FMAs, so the result is the same float32 value the
// plain PyTorch version (video_stab_tpu_torch/kernels/warp.py) computes,
// also at .5 ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBorderConstant = 0;
constexpr int kBorderReplicate = 1;
constexpr int kBorderReflect = 2;
constexpr int kBorderWrap = 3;
constexpr int kBorderReflect101 = 4;

constexpr int kRun = 4;                      // output pixels per thread
constexpr int kBlockX = 32;                  // one warp per output row
constexpr int kBlockY = 8;
constexpr int kTileW = kBlockX * kRun;       // 128 output pixels
constexpr int kTileH = kBlockY;              // 8 output rows
constexpr float kInteriorMargin = 2.0f;
constexpr float kMagic = 8388608.0f;         // 2^23
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int pos_mod(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// In-range index for integer sample index i; valid is false only for the
// constant mode's out-of-range taps.
template <int kMode>
__device__ __forceinline__ int map_index(int i, int n, bool* valid) {
  *valid = true;
  if (kMode == kBorderConstant) {
    *valid = (i >= 0) && (i <= n - 1);
    return min(max(i, 0), n - 1);
  } else if (kMode == kBorderReplicate) {
    return min(max(i, 0), n - 1);
  } else if (kMode == kBorderReflect) {
    if (n == 1) return 0;
    const int p = 2 * n;
    const int j = pos_mod(i, p);
    return j >= n ? p - 1 - j : j;
  } else if (kMode == kBorderReflect101) {
    if (n == 1) return 0;
    const int p = 2 * (n - 1);
    const int j = pos_mod(i, p);
    return j >= n ? p - j : j;
  } else {  // kBorderWrap
    return pos_mod(i, n);
  }
}

// (p * x + q * y) + r, each step rounded, never contracted.
__device__ __forceinline__ float lin(float p, float q, float r, float x,
                                     float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p, x), __fmul_rn(q, y)), r);
}

template <bool kProjective>
struct InverseMap {
  float m[kProjective ? 9 : 6];

  __device__ __forceinline__ void load(const float* __restrict__ minv) {
#pragma unroll
    for (int i = 0; i < (kProjective ? 9 : 6); ++i) m[i] = __ldg(minv + i);
  }

  // Source coordinates of output pixel (x, y).
  __device__ __forceinline__ void coords(float xf, float yf, float* sx,
                                         float* sy) const {
    *sx = lin(m[0], m[1], m[2], xf, yf);
    *sy = lin(m[3], m[4], m[5], xf, yf);
    if (kProjective) {
      float d = lin(m[6], m[7], m[8], xf, yf);
      if (fabsf(d) < 1.0e-9f) d = 1.0e-9f;
      *sx = __fdiv_rn(*sx, d);
      *sy = __fdiv_rn(*sy, d);
    }
  }
};

// Whether no tap of output row y, pixels [x0, x1], can leave the source
// under an affine map: both ends' coordinates lie kInteriorMargin inside
// [0, w-1) x [0, h-1), and the row's image is the segment between them.
// Lanes 0 and 1 map one end each; every lane of the warp must call it.
// Written so that a NaN coordinate fails it.
// tests/test_torch_warp_tiles.py mirrors this test.
__device__ __forceinline__ bool row_interior(const InverseMap<false>& m,
                                             int x0, int x1, int y, int h,
                                             int w) {
  int inside = 0;
  if (threadIdx.x < 2) {
    float sx, sy;
    m.coords(static_cast<float>(threadIdx.x ? x1 : x0), static_cast<float>(y),
             &sx, &sy);
    const float hx = static_cast<float>(w - 1) - kInteriorMargin;
    const float hy = static_cast<float>(h - 1) - kInteriorMargin;
    inside = sx >= kInteriorMargin && sx < hx && sy >= kInteriorMargin &&
             sy < hy;
  }
  const int at_x0 = __shfl_sync(kFullMask, inside, 0);
  const int at_x1 = __shfl_sync(kFullMask, inside, 1);
  return at_x0 && at_x1;
}

// floor(s) for 0 <= s < 2^22, and its int, without the conversion unit:
// s + 2^23 holds the integer nearest s (ties to even) in its low bits.
__device__ __forceinline__ float floor_small(float s, int* i) {
  const float t = __fadd_rn(s, kMagic);
  const float r = __fsub_rn(t, kMagic);
  const bool above = r > s;
  *i = (__float_as_int(t) - __float_as_int(kMagic)) - (above ? 1 : 0);
  return above ? __fsub_rn(r, 1.0f) : r;
}

// Byte k of w as a float: placed in the mantissa of 2^23, less 2^23.
template <int k>
__device__ __forceinline__ float byte_f(uint32_t w) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | k)),
                   kMagic);
}

__device__ __forceinline__ float u8_f(uint32_t b) {
  return __fsub_rn(__int_as_float(0x4B000000 | b), kMagic);
}

// clip(rint(v), 0, 255) in the low byte (round half to even).
__device__ __forceinline__ uint32_t u8_bits(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), kMagic));
}

// The low bytes of four u8_bits words, packed.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Bytes p[0..3] (lo) and p[4..7] (hi), from the aligned 32-bit words that
// hold them. Only the first kBytes (at most 6) are needed, and no word is
// read that holds none of those, so no read leaves the source.
template <int kBytes>
__device__ __forceinline__ void load_span(const uint8_t* p, uint32_t* lo,
                                          uint32_t* hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const uint32_t off = static_cast<uint32_t>(a & 3u);
  const uint32_t w0 = __ldg(w);
  // Word 1 holds a needed byte when the span crosses word 0's end; word 2
  // only for a 6-byte span starting at byte 3 of its word.
  const uint32_t w1 = (off + kBytes > 4u) ? __ldg(w + 1) : 0u;
  const uint32_t w2 = (off + kBytes > 8u) ? __ldg(w + 2) : 0u;
  *lo = __funnelshift_r(w0, w1, 8u * off);
  *hi = __funnelshift_r(w1, w2, 8u * off);
}

template <int i>
__device__ __forceinline__ float span_f(uint32_t lo, uint32_t hi) {
  return byte_f<i & 3>(i < 4 ? lo : hi);
}

__device__ __forceinline__ uint32_t blend(float v00, float v01, float v10,
                                          float v11, float fx, float fy,
                                          float gx, float gy) {
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return u8_bits(__fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy)));
}

// Output pixel (x, y), C = 3, of a row whose taps all lie inside the
// source.
__device__ __forceinline__ void pixel_interior(
    const InverseMap<false>& m, const uint8_t* __restrict__ src, int h,
    int w, float xf, float yf, uint32_t* res) {
  constexpr int C = 3;
  float sx, sy;
  m.coords(xf, yf, &sx, &sy);
  int ix, iy;
  const float fx = __fsub_rn(sx, floor_small(sx, &ix));
  const float fy = __fsub_rn(sy, floor_small(sy, &iy));
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  // The clamp changes no index the row test admits; it keeps every read
  // inside the source whatever the map.
  ix = min(max(ix, 0), w - 2);
  iy = min(max(iy, 0), h - 2);
  const size_t row = static_cast<size_t>(w) * C;
  const uint8_t* p0 = src + static_cast<size_t>(iy) * row + ix * C;
  uint32_t a_lo, a_hi, b_lo, b_hi;
  load_span<2 * C>(p0, &a_lo, &a_hi);
  load_span<2 * C>(p0 + row, &b_lo, &b_hi);
  res[0] = blend(span_f<0>(a_lo, a_hi), span_f<3>(a_lo, a_hi),
                 span_f<0>(b_lo, b_hi), span_f<3>(b_lo, b_hi), fx, fy, gx, gy);
  res[1] = blend(span_f<1>(a_lo, a_hi), span_f<4>(a_lo, a_hi),
                 span_f<1>(b_lo, b_hi), span_f<4>(b_lo, b_hi), fx, fy, gx, gy);
  res[2] = blend(span_f<2>(a_lo, a_hi), span_f<5>(a_lo, a_hi),
                 span_f<2>(b_lo, b_hi), span_f<5>(b_lo, b_hi), fx, fy, gx, gy);
}

// Output pixel (x, y) through the border mode's index maps, per tap.
template <int C, int kMode, bool kProjective>
__device__ __forceinline__ void pixel_general(
    const InverseMap<kProjective>& m, const uint8_t* __restrict__ src,
    int h, int w, float xf, float yf, float border_value, uint32_t* res) {
  float sx, sy;
  m.coords(xf, yf, &sx, &sy);
  // Clamp before the int conversion so x0 + 1 cannot overflow; such
  // coordinates are far outside any source either way.
  const float x0f = fminf(fmaxf(floorf(sx), -1.0e9f), 1.0e9f);
  const float y0f = fminf(fmaxf(floorf(sy), -1.0e9f), 1.0e9f);
  const float fx = __fsub_rn(sx, floorf(sx));
  const float fy = __fsub_rn(sy, floorf(sy));
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int ix = static_cast<int>(x0f);
  const int iy = static_cast<int>(y0f);
  bool vy0, vy1, vx0, vx1;
  const int ry0 = map_index<kMode>(iy, h, &vy0);
  const int ry1 = map_index<kMode>(iy + 1, h, &vy1);
  const int rx0 = map_index<kMode>(ix, w, &vx0);
  const int rx1 = map_index<kMode>(ix + 1, w, &vx1);
  const size_t row = static_cast<size_t>(w) * C;
  const uint8_t* row0 = src + static_cast<size_t>(ry0) * row;
  const uint8_t* row1 = src + static_cast<size_t>(ry1) * row;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float v00 = (vy0 && vx0) ? u8_f(row0[rx0 * C + ch]) : border_value;
    const float v01 = (vy0 && vx1) ? u8_f(row0[rx1 * C + ch]) : border_value;
    const float v10 = (vy1 && vx0) ? u8_f(row1[rx0 * C + ch]) : border_value;
    const float v11 = (vy1 && vx1) ? u8_f(row1[rx1 * C + ch]) : border_value;
    res[ch] = blend(v00, v01, v10, v11, fx, fy, gx, gy);
  }
}

template <int C, int kMode, bool kProjective, bool kBatched>
__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_tile_kernel(const uint8_t* __restrict__ src, int h, int w, int ring,
                 const int* __restrict__ slots, uint8_t* __restrict__ dst,
                 int oh, int ow, const float* __restrict__ minv,
                 float border_value) {
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (y >= oh) return;   // the whole warp: it is one output row
  if constexpr (kBatched) {
    // Stream blockIdx.z: its queued frame in the ring, its output and map.
    const int b = blockIdx.z;
    const int slot = slots ? min(max(__ldg(slots + b), 0), ring - 1) : 0;
    src += (static_cast<size_t>(b) * ring + slot) * h * w * C;
    dst += static_cast<size_t>(b) * oh * ow * C;
    minv += b * (kProjective ? 9 : 6);
  }
  InverseMap<kProjective> m;
  m.load(minv);
  const int tx0 = blockIdx.x * kTileW;
  constexpr bool kInterior = C == 3 && !kProjective;
  bool interior = false;
  if constexpr (kInterior) {
    interior = row_interior(m, tx0, min(tx0 + kTileW, ow) - 1, y, h, w);
  }
  const int xs = tx0 + threadIdx.x * kRun;
  if (xs >= ow) return;
  const float yf = static_cast<float>(y);
  const float xsf = static_cast<float>(xs);

  uint32_t res[kRun * C];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    // xs + j as a float without a conversion (exact below 2^24).
    const float xf = __fadd_rn(xsf, static_cast<float>(j));
    if (xs + j >= ow) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) res[j * C + ch] = 0u;
    } else if (interior) {
      if constexpr (kInterior) {
        pixel_interior(m, src, h, w, xf, yf, res + j * C);
      }
    } else {
      pixel_general<C, kMode, kProjective>(m, src, h, w, xf, yf,
                                           border_value, res + j * C);
    }
  }

  uint8_t* out = dst + (static_cast<size_t>(y) * ow + xs) * C;
  if (xs + kRun <= ow && (reinterpret_cast<uintptr_t>(out) & 3u) == 0) {
    uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int k = 0; k < kRun * C / 4; ++k) {
      o[k] = pack4(res[4 * k], res[4 * k + 1], res[4 * k + 2],
                   res[4 * k + 3]);
    }
  } else {
    const int n = min(kRun, ow - xs) * C;
#pragma unroll
    for (int k = 0; k < kRun * C; ++k) {
      if (k < n) out[k] = static_cast<uint8_t>(res[k]);
    }
  }
}

// The frames of one launch: n streams, each reading slot[b] (slots may
// be null: slot 0) of its ring of q frames.
struct Frames {
  int n, q;
  const int* slots;
};

template <int C, int kMode, bool kProjective>
void launch_one(const uint8_t* src, int h, int w, Frames fr, uint8_t* dst,
                int oh, int ow, const float* minv, float border_value,
                cudaStream_t s) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ow + kTileW - 1) / kTileW, (oh + kTileH - 1) / kTileH,
                  fr.n);
  // One frame takes the kernel without the stream offsets: they cost the
  // single-frame emit ~1.2 us of 13.7 in an A/B on an H100 (PERF.md).
  if (fr.n > 1 || fr.slots) {
    warp_tile_kernel<C, kMode, kProjective, true><<<grid, block, 0, s>>>(
        src, h, w, fr.q, fr.slots, dst, oh, ow, minv, border_value);
  } else {
    warp_tile_kernel<C, kMode, kProjective, false><<<grid, block, 0, s>>>(
        src, h, w, fr.q, fr.slots, dst, oh, ow, minv, border_value);
  }
}

template <int C, bool kProjective>
int launch_mode(const uint8_t* src, int h, int w, Frames fr, uint8_t* dst,
                int oh, int ow, const float* minv, int mode,
                float border_value, cudaStream_t s) {
  switch (mode) {
    case kBorderConstant:
      launch_one<C, kBorderConstant, kProjective>(src, h, w, fr, dst, oh, ow,
                                                  minv, border_value, s);
      break;
    case kBorderReplicate:
      launch_one<C, kBorderReplicate, kProjective>(src, h, w, fr, dst, oh, ow,
                                                   minv, border_value, s);
      break;
    case kBorderReflect:
      launch_one<C, kBorderReflect, kProjective>(src, h, w, fr, dst, oh, ow,
                                                 minv, border_value, s);
      break;
    case kBorderWrap:
      launch_one<C, kBorderWrap, kProjective>(src, h, w, fr, dst, oh, ow, minv,
                                              border_value, s);
      break;
    case kBorderReflect101:
      launch_one<C, kBorderReflect101, kProjective>(src, h, w, fr, dst, oh, ow,
                                                    minv, border_value, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kProjective>
int launch_warp(const void* src, int h, int w, int c, Frames fr, void* dst,
                int oh, int ow, const void* minv, int mode,
                float border_value, void* stream) {
  if (oh <= 0 || ow <= 0 || fr.n <= 0) return 0;
  if (h <= 0 || w <= 0 || fr.q <= 0 || fr.n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* out = static_cast<uint8_t*>(dst);
  const auto* m = static_cast<const float*>(minv);
  if (c == 1) {
    return launch_mode<1, kProjective>(in, h, w, fr, out, oh, ow, m, mode,
                                       border_value, s);
  }
  if (c == 3) {
    return launch_mode<3, kProjective>(in, h, w, fr, out, oh, ow, m, mode,
                                       border_value, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns the cudaError_t of the launch (0 on success). minv holds 6
// floats (a b c d e f) for the affine warp, 9 (row-major 3x3) for the
// projective one.
extern "C" int vs_warp_affine_u8(const void* src, int h, int w, int c,
                                 void* dst, int oh, int ow, const void* minv,
                                 int mode, float border_value, void* stream) {
  return launch_warp<false>(src, h, w, c, Frames{1, 1, nullptr}, dst, oh, ow,
                            minv, mode, border_value, stream);
}

extern "C" int vs_warp_homography_u8(const void* src, int h, int w, int c,
                                     void* dst, int oh, int ow,
                                     const void* minv, int mode,
                                     float border_value, void* stream) {
  return launch_warp<true>(src, h, w, c, Frames{1, 1, nullptr}, dst, oh, ow,
                           minv, mode, border_value, stream);
}

// N streams in one launch: src is the (n, q, h, w, c) ring, slots a device
// int32 (n,) table of the slot each stream reads (null: slot 0), dst
// (n, oh, ow, c), minv (n, 6) for the affine warp and (n, 9) for the
// projective one.
extern "C" int vs_warp_affine_u8_batched(const void* src, int n, int q,
                                         const void* slots, int h, int w,
                                         int c, void* dst, int oh, int ow,
                                         const void* minv, int mode,
                                         float border_value, void* stream) {
  return launch_warp<false>(src, h, w, c,
                            Frames{n, q, static_cast<const int*>(slots)},
                            dst, oh, ow, minv, mode, border_value, stream);
}

extern "C" int vs_warp_homography_u8_batched(
    const void* src, int n, int q, const void* slots, int h, int w, int c,
    void* dst, int oh, int ow, const void* minv, int mode,
    float border_value, void* stream) {
  return launch_warp<true>(src, h, w, c,
                           Frames{n, q, static_cast<const int*>(slots)},
                           dst, oh, ow, minv, mode, border_value, stream);
}
