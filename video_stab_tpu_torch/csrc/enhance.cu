// K4: the enhancer's pointwise pass, fused with the frame's u8 -> f32 cast
// before it and the saturate_u8 after it.
//
// Replaces the Pallas kernel video_stab_tpu/pallas/enhance.py:_enhance_kernel
// (via enhance_pointwise). Per channel value, in the order of
// video_stab_tpu/core/enhancer.py:enhance_frame:
//   x = u8 -> f32
//   x = x * wb[c]                              (white balance on; the means
//                                               are a torch reduction before)
//   x = clip(x * contrast + brightness, 0, 255)   (contrast != 1 or
//                                                  brightness != 0)
//   x = powf(clip(x, 0, 255) / 255, gamma) * 255  (|gamma - 1| > 1e-3; a
//                                                  true division, as
//                                                  gamma_correct does)
//   out = clip(rint(x), 0, 255) as u8          (round half to even)
// The same pass can also write the BT.601 gray of the UNSATURATED x, which
// is what the fused chain's roll estimate and analysis resize read
// (core/chain.py: bgr_to_gray of the float frame): the frame is then read
// once for both.
//
// Bound on the H100: bytes. A 1080p frame is 6.2 MB in and 6.2 MB out
// (+ 8.3 MB of gray when asked for); the arithmetic is a few flops and one
// powf per value. One thread per pixel (its three channels), 256-thread
// blocks over the flat pixel index, so a warp's loads and stores cover
// neighbouring addresses. A CUDA kernel in the same library as K1 and K3
// keeps the build to one nvcc call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void enhance_u8_kernel(const uint8_t* __restrict__ src,
                                  uint8_t* __restrict__ dst,
                                  float* __restrict__ gray, long long n_pix,
                                  const float* __restrict__ wb, int do_cb,
                                  float contrast, float brightness,
                                  int do_gamma, float gamma) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  float v[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float x = static_cast<float>(src[p * 3 + ch]);
    if (wb != nullptr) x = __fmul_rn(x, wb[ch]);
    if (do_cb) {
      x = __fadd_rn(__fmul_rn(x, contrast), brightness);
      x = fminf(fmaxf(x, 0.0f), 255.0f);
    }
    if (do_gamma) {
      const float norm = __fdiv_rn(fminf(fmaxf(x, 0.0f), 255.0f), 255.0f);
      x = __fmul_rn(powf(norm, gamma), 255.0f);
    }
    v[ch] = x;
    dst[p * 3 + ch] = static_cast<uint8_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
  }
  if (gray != nullptr) {
    gray[p] = __fadd_rn(__fadd_rn(__fmul_rn(v[0], 0.114f), __fmul_rn(v[1], 0.587f)),
                        __fmul_rn(v[2], 0.299f));
  }
}

}  // namespace

// src/dst: (n_pix, 3) u8; gray: (n_pix,) f32 or null; wb: (3,) f32 device
// scales or null. Returns the cudaError_t of the launch (0 on success).
extern "C" int vs_enhance_u8(const void* src, void* dst, void* gray,
                             long long n_pix, const void* wb, int do_cb,
                             float contrast, float brightness, int do_gamma,
                             float gamma, void* stream) {
  const int block = 256;
  const long long grid = (n_pix + block - 1) / block;
  enhance_u8_kernel<<<static_cast<unsigned int>(grid), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<float*>(gray), n_pix, static_cast<const float*>(wb), do_cb,
      contrast, brightness, do_gamma, gamma);
  return static_cast<int>(cudaGetLastError());
}
