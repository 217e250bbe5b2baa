// K3: Shi-Tomasi corner response (cv::cornerMinEigenVal, block 3, aperture
// 3) and its 3x3 peak mask.
//
// Replaces the Pallas kernel video_stab_tpu/pallas/features.py:_corner_kernel
// (via corner_response). It computes what the JAX package's GFTT actually
// dispatches — ops/features.py:min_eig_response followed by
// resp >= _dilate3x3(resp) — not the Pallas kernel's rim convention:
//   * every stage is reflect-101 on its OWN input, as sep_filter2d re-pads:
//     the Sobel reads reflect-101 source pixels, and the 3x3 box sums read
//     the product planes at reflect-101 indices;
//   * the peak test wraps around the frame (jnp.roll), so it runs as a
//     second launch over the finished response plane.
// Each 1-D stage sums its taps left to right, vertical pass first, every
// product and sum rounded to float32 (__fmul_rn/__fadd_rn, no FMA) — the
// order of video_stab_tpu_torch/ops/filters.py, so kernel and plain version
// agree bit for bit.
//
// Bound on the H100: at 960x540 the planes are 2 MB (gray in, response out)
// plus 0.5 MB (peak mask); all of it sits in the 50 MB L2. One thread per
// pixel recomputes the Sobel products of its 3x3 neighbourhood from the
// source (81 cached loads) instead of staging them in shared memory: simple
// first, a shared-memory tile is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int refl101(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) return -i;
  if (i >= n) return 2 * (n - 1) - i;
  return i;
}

// Sum of k0*a + k1*b + k2*c, left to right, each product rounded.
__device__ __forceinline__ float taps3(float k0, float a, float k1, float b,
                                       float k2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k0, a), __fmul_rn(k1, b)),
                   __fmul_rn(k2, c));
}

// Scaled Sobel gradients at (r, c).
__device__ __forceinline__ void sobel_at(const float* __restrict__ img, int h,
                                         int w, int r, int c, float scale,
                                         float* gx, float* gy) {
  const int rm = refl101(r - 1, h), rp = refl101(r + 1, h);
  const int cm = refl101(c - 1, w), cp = refl101(c + 1, w);
  const int cols[3] = {cm, c, cp};
  float hs[3], hd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float a = img[rm * w + cols[j]];
    const float b = img[r * w + cols[j]];
    const float d = img[rp * w + cols[j]];
    hs[j] = taps3(1.0f, a, 2.0f, b, 1.0f, d);    // H-smooth (gx's first pass)
    hd[j] = taps3(-1.0f, a, 0.0f, b, 1.0f, d);   // H-diff (gy's first pass)
  }
  *gx = __fmul_rn(taps3(-1.0f, hs[0], 0.0f, hs[1], 1.0f, hs[2]), scale);
  *gy = __fmul_rn(taps3(1.0f, hd[0], 2.0f, hd[1], 1.0f, hd[2]), scale);
}

__global__ void min_eig_kernel(const float* __restrict__ img, int h, int w,
                               float scale, float* __restrict__ resp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int rows[3] = {refl101(y - 1, h), y, refl101(y + 1, h)};
  const int cols[3] = {refl101(x - 1, w), x, refl101(x + 1, w)};
  float vxx[3], vyy[3], vxy[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float pxx[3], pyy[3], pxy[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float gx, gy;
      sobel_at(img, h, w, rows[i], cols[j], scale, &gx, &gy);
      pxx[i] = __fmul_rn(gx, gx);
      pyy[i] = __fmul_rn(gy, gy);
      pxy[i] = __fmul_rn(gx, gy);
    }
    vxx[j] = taps3(1.0f, pxx[0], 1.0f, pxx[1], 1.0f, pxx[2]);
    vyy[j] = taps3(1.0f, pyy[0], 1.0f, pyy[1], 1.0f, pyy[2]);
    vxy[j] = taps3(1.0f, pxy[0], 1.0f, pxy[1], 1.0f, pxy[2]);
  }
  const float sxx = taps3(1.0f, vxx[0], 1.0f, vxx[1], 1.0f, vxx[2]);
  const float syy = taps3(1.0f, vyy[0], 1.0f, vyy[1], 1.0f, vyy[2]);
  const float sxy = taps3(1.0f, vxy[0], 1.0f, vxy[1], 1.0f, vxy[2]);
  const float half_tr = __fmul_rn(0.5f, __fadd_rn(sxx, syy));
  const float half_df = __fmul_rn(0.5f, __fsub_rn(sxx, syy));
  const float disc = __fadd_rn(__fmul_rn(half_df, half_df), __fmul_rn(sxy, sxy));
  resp[y * w + x] = __fsub_rn(half_tr, __fsqrt_rn(disc));
}

// peak = resp >= every one of its 8 neighbours, indices wrapping around the
// frame (jnp.roll semantics).
__global__ void peak_kernel(const float* __restrict__ resp, int h, int w,
                            uint8_t* __restrict__ peak) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float v = resp[y * w + x];
  float m = v;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int r = (y + dy + h) % h;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int c = (x + dx + w) % w;
      m = fmaxf(m, resp[r * w + c]);
    }
  }
  peak[y * w + x] = v >= m ? 1 : 0;
}

}  // namespace

// Two launches on one stream: the response plane, then the wrapped peak
// test over it. Returns the cudaError_t of the launches (0 on success).
extern "C" int vs_corner_response(const void* gray, int h, int w, float scale,
                                  void* resp, void* peak, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  min_eig_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(gray), h, w,
                                        scale, static_cast<float*>(resp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  peak_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(resp), h, w,
                                     static_cast<uint8_t*>(peak));
  return static_cast<int>(cudaGetLastError());
}
