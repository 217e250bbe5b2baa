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
// Bound on the H100: bytes. A 1080p x3 frame reads ~6.2 MB (each source
// byte about once, the neighbouring taps come from L1/L2) and writes
// ~6.2 MB; the arithmetic is ~30 flops per pixel. One thread per output
// pixel (all channels), 32x8 blocks, so a warp's reads and writes walk
// neighbouring addresses. The TPU kernel's envelope, tier ladder, tile
// pick and scalar prefetch exist for the TPU's DMA and VMEM and have no
// counterpart here: any affine or projective map is exact. K2 adds two
// divides per pixel, still far below the byte bound.
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

__device__ __forceinline__ int pos_mod(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// In-range index for integer sample index i; valid is false only for the
// constant mode's out-of-range taps.
__device__ __forceinline__ int map_index(int i, int n, int mode, bool* valid) {
  *valid = true;
  switch (mode) {
    case kBorderConstant:
      *valid = (i >= 0) && (i <= n - 1);
      return min(max(i, 0), n - 1);
    case kBorderReplicate:
      return min(max(i, 0), n - 1);
    case kBorderReflect: {
      if (n == 1) return 0;
      int p = 2 * n;
      int j = pos_mod(i, p);
      return j >= n ? p - 1 - j : j;
    }
    case kBorderReflect101: {
      if (n == 1) return 0;
      int p = 2 * (n - 1);
      int j = pos_mod(i, p);
      return j >= n ? p - j : j;
    }
    default:  // kBorderWrap
      return pos_mod(i, n);
  }
}

// (p * x + q * y) + r, each step rounded, never contracted.
__device__ __forceinline__ float lin(float p, float q, float r, float x,
                                     float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(p, x), __fmul_rn(q, y)), r);
}

template <int C, bool kProjective>
__global__ void warp_u8_kernel(const uint8_t* __restrict__ src, int h, int w,
                               uint8_t* __restrict__ dst, int oh, int ow,
                               const float* __restrict__ minv, int mode,
                               float border_value) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(y);
  float sx = lin(minv[0], minv[1], minv[2], xf, yf);
  float sy = lin(minv[3], minv[4], minv[5], xf, yf);
  if (kProjective) {
    float den = lin(minv[6], minv[7], minv[8], xf, yf);
    if (fabsf(den) < 1.0e-9f) den = 1.0e-9f;
    sx = __fdiv_rn(sx, den);
    sy = __fdiv_rn(sy, den);
  }
  // Clamp before the int conversion so x0 + 1 cannot overflow; such
  // coordinates are far outside any source either way.
  const float x0f = fminf(fmaxf(floorf(sx), -1.0e9f), 1.0e9f);
  const float y0f = fminf(fmaxf(floorf(sy), -1.0e9f), 1.0e9f);
  const float fx = __fsub_rn(sx, floorf(sx));
  const float fy = __fsub_rn(sy, floorf(sy));
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);

  bool vy0, vy1, vx0, vx1;
  const int ry0 = map_index(y0, h, mode, &vy0);
  const int ry1 = map_index(y0 + 1, h, mode, &vy1);
  const int rx0 = map_index(x0, w, mode, &vx0);
  const int rx1 = map_index(x0 + 1, w, mode, &vx1);
  const uint8_t* row0 = src + static_cast<size_t>(ry0) * w * C;
  const uint8_t* row1 = src + static_cast<size_t>(ry1) * w * C;
  uint8_t* out = dst + (static_cast<size_t>(y) * ow + x) * C;

#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float v00 = (vy0 && vx0) ? static_cast<float>(row0[rx0 * C + ch]) : border_value;
    const float v01 = (vy0 && vx1) ? static_cast<float>(row0[rx1 * C + ch]) : border_value;
    const float v10 = (vy1 && vx0) ? static_cast<float>(row1[rx0 * C + ch]) : border_value;
    const float v11 = (vy1 && vx1) ? static_cast<float>(row1[rx1 * C + ch]) : border_value;
    const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
    const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
    float v = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
    v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
    out[ch] = static_cast<uint8_t>(v);
  }
}

template <bool kProjective>
int launch_warp(const void* src, int h, int w, int c, void* dst, int oh,
                int ow, const void* minv, int mode, float border_value,
                void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((ow + block.x - 1) / block.x, (oh + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* out = static_cast<uint8_t*>(dst);
  const auto* m = static_cast<const float*>(minv);
  if (c == 1) {
    warp_u8_kernel<1, kProjective><<<grid, block, 0, s>>>(
        in, h, w, out, oh, ow, m, mode, border_value);
  } else if (c == 3) {
    warp_u8_kernel<3, kProjective><<<grid, block, 0, s>>>(
        in, h, w, out, oh, ow, m, mode, border_value);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the cudaError_t of the launch (0 on success). minv holds 6
// floats (a b c d e f) for the affine warp, 9 (row-major 3x3) for the
// projective one.
extern "C" int vs_warp_affine_u8(const void* src, int h, int w, int c,
                                 void* dst, int oh, int ow, const void* minv,
                                 int mode, float border_value, void* stream) {
  return launch_warp<false>(src, h, w, c, dst, oh, ow, minv, mode,
                            border_value, stream);
}

extern "C" int vs_warp_homography_u8(const void* src, int h, int w, int c,
                                     void* dst, int oh, int ow,
                                     const void* minv, int mode,
                                     float border_value, void* stream) {
  return launch_warp<true>(src, h, w, c, dst, oh, ow, minv, mode,
                           border_value, stream);
}
