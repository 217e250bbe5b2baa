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
// Bound on the H100: bytes. A 1080p frame is 6.2 MB in and 6.2 MB out,
// + 8.3 MB of gray when asked for: 6.2 us at 3.35 TB/s. Evaluated per
// value, the chain costs an accurate powf and an IEEE divide for each of
// the 6.2 M values, which makes it compute-bound at several times that.
// But x depends only on the u8 input and its channel, so each block first
// builds a table of x in shared memory with the per-value expressions
// above: 256 entries per channel (one table for all three when white
// balance is off), built a few hundred times a frame, not 6.2 M times.
//
// The rest is moving bytes in wide, coalesced accesses. Each warp takes
// 512 pixels at a time: 1536 bytes in, as three 16-byte loads per lane
// on neighbouring addresses, staged in shared memory; each lane then
// reads its 4-pixel runs (12 bytes, three words), looks up 12 values,
// writes the 12 result bytes back in place and 4 grays as one 16-byte
// store (neighbouring lanes, neighbouring runs); the 1536 result bytes
// leave as three coalesced 16-byte stores per lane. The next 512 pixels'
// loads are issued before this step's work. The u8 result avoids the
// conversion unit (an eighth of the FP32 rate): a value in [0, 255] plus
// 2^23 is rounded half to even into the low byte of its bits, which is
// rint and the u8 cast in one add. Pixels past the last whole 512, and
// frames whose pointers are not 16-byte aligned (a view at an odd
// offset), take the scalar loop of the same kernel.
//
// Every float operation is __fmul_rn / __fadd_rn / __fdiv_rn / powf as
// before, so the results are the bits the per-value kernel computed.
//
// Two more launch modes serve the enhancer when CLAHE, vibrance, unsharp
// masking or denoising run between the pointwise stages
// (core/enhancer.py:enhance_frame_u8), where the frame stays in float and
// is saturated only at the end:
//   head (enhance_head_kernel): u8 in, f32 out: white balance and
//     contrast/brightness, gamma off; the table above without the final
//     rounding.
//   tail (enhance_tail_kernel): f32 in, u8 out: gamma, then saturate_u8,
//     plus the gray of the unsaturated result when asked for. The input is
//     no longer u8, so the table does not apply: each value is evaluated.
// Both take four pixels a thread (12 values: three 4-byte words of u8 or
// three 16-byte float4s), neighbouring threads on neighbouring pixels.
// Head moves 6.2 MB in and 24.9 MB out at 1080p (9.3 us at 3.35 TB/s);
// tail 24.9 MB in, 6.2 MB out, + 8.3 MB of gray (11.7 us); tail's powf
// (~40 operations a value, 250 MFLOP at 1080p, ~4 us at 67 TFLOP/s) stays
// under its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kStep = 512;             // pixels per warp and step
constexpr int kStepVec = kStep * 3 / 16;   // 96 uint4 of input per step
constexpr float kMagic = 8388608.0f;  // 2^23

__device__ __forceinline__ float enhance_value(float x, float scale,
                                               bool has_wb, int do_cb,
                                               float contrast,
                                               float brightness,
                                               int do_gamma, float gamma) {
  if (has_wb) x = __fmul_rn(x, scale);
  if (do_cb) {
    x = __fadd_rn(__fmul_rn(x, contrast), brightness);
    x = fminf(fmaxf(x, 0.0f), 255.0f);
  }
  if (do_gamma) {
    const float norm = __fdiv_rn(fminf(fmaxf(x, 0.0f), 255.0f), 255.0f);
    x = __fmul_rn(powf(norm, gamma), 255.0f);
  }
  return x;
}

// clip(rint(x), 0, 255) in the low byte (round half to even).
__device__ __forceinline__ uint32_t u8_bits(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.0f), 255.0f), kMagic));
}

// The low bytes of four u8_bits words, packed.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ float gray_of(float b, float g, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(b, 0.114f), __fmul_rn(g, 0.587f)),
                   __fmul_rn(r, 0.299f));
}

__global__ void __launch_bounds__(kThreads)
enhance_table_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                     float* __restrict__ gray, long long n_pix,
                     const float* __restrict__ wb, int do_cb, float contrast,
                     float brightness, int do_gamma, float gamma, int vec) {
  __shared__ float tab[3][256];
  __shared__ uint4 stage[kWarps][kStepVec];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_wb = wb != nullptr;
  // Channel ch's table: its own with white balance, else channel 0's.
  const int tab_ch[3] = {0, has_wb ? 1 : 0, has_wb ? 2 : 0};
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);

  const long long n_steps = vec ? n_pix / kStep : 0;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  long long step = static_cast<long long>(blockIdx.x) * kWarps + warp;

  // The first step's loads go out before the table is built.
  uint4 in[3];
  if (step < n_steps) {
#pragma unroll
    for (int k = 0; k < 3; ++k) in[k] = src4[step * kStepVec + 32 * k + lane];
  }

  const int n_entries = has_wb ? 3 * 256 : 256;
  for (int e = threadIdx.x; e < n_entries; e += kThreads) {
    const int ch = e >> 8;
    const float x = enhance_value(static_cast<float>(e & 255),
                                  has_wb ? wb[ch] : 1.0f, has_wb, do_cb,
                                  contrast, brightness, do_gamma, gamma);
    tab[ch][e & 255] = x;
  }
  __syncthreads();

  uint4* buf4 = stage[warp];
  uint32_t* buf = reinterpret_cast<uint32_t*>(buf4);
  for (; step < n_steps; step += warp_stride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) buf4[32 * k + lane] = in[k];
    __syncwarp();
    const long long next = step + warp_stride;
    if (next < n_steps) {   // the next step's loads overlap this step
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        in[k] = src4[next * kStepVec + 32 * k + lane];
      }
    }
#pragma unroll
    for (int sub = 0; sub < kStep / 128; ++sub) {   // 4 pixels a lane
      uint32_t* wv = buf + 96 * sub + 3 * lane;
      const uint32_t w[3] = {wv[0], wv[1], wv[2]};
      float v[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const uint32_t u = (w[i / 4] >> (8 * (i & 3))) & 0xffu;
        v[i] = tab[tab_ch[i % 3]][u];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        wv[k] = pack4(u8_bits(v[4 * k]), u8_bits(v[4 * k + 1]),
                      u8_bits(v[4 * k + 2]), u8_bits(v[4 * k + 3]));
      }
      if (gray != nullptr) {
        reinterpret_cast<float4*>(gray)[step * (kStep / 4) + 32 * sub +
                                        lane] =
            make_float4(gray_of(v[0], v[1], v[2]), gray_of(v[3], v[4], v[5]),
                        gray_of(v[6], v[7], v[8]),
                        gray_of(v[9], v[10], v[11]));
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dst4[step * kStepVec + 32 * k + lane] = buf4[32 * k + lane];
    }
    __syncwarp();
  }

  // The scalar loop: the pixels after the last whole step, or all of them
  // when a pointer is not 16-byte aligned.
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = n_steps * kStep + static_cast<long long>(blockIdx.x) *
                                           kThreads + threadIdx.x;
       p < n_pix; p += stride) {
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      v[ch] = tab[tab_ch[ch]][src[p * 3 + ch]];
      dst[p * 3 + ch] = static_cast<uint8_t>(u8_bits(v[ch]));
    }
    if (gray != nullptr) gray[p] = gray_of(v[0], v[1], v[2]);
  }
}

__device__ __forceinline__ float gamma_value(float x, float gamma) {
  const float norm = __fdiv_rn(fminf(fmaxf(x, 0.0f), 255.0f), 255.0f);
  return __fmul_rn(powf(norm, gamma), 255.0f);
}

// Head: u8 -> f32 through the table of white balance and contrast /
// brightness (gamma off). vec: src 4-byte and dst 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
enhance_head_kernel(const uint8_t* __restrict__ src, float* __restrict__ dst,
                    long long n_pix, const float* __restrict__ wb, int do_cb,
                    float contrast, float brightness, int vec) {
  __shared__ float tab[3][256];
  const bool has_wb = wb != nullptr;
  const int tab_ch[3] = {0, has_wb ? 1 : 0, has_wb ? 2 : 0};
  const int n_entries = has_wb ? 3 * 256 : 256;
  for (int e = threadIdx.x; e < n_entries; e += kThreads) {
    const int ch = e >> 8;
    tab[ch][e & 255] = enhance_value(static_cast<float>(e & 255),
                                     has_wb ? wb[ch] : 1.0f, has_wb, do_cb,
                                     contrast, brightness, 0, 1.0f);
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long n_groups = vec ? n_pix / 4 : 0;
  const uint32_t* src_w = reinterpret_cast<const uint32_t*>(src);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (long long g = first; g < n_groups; g += stride) {
    const uint32_t w[3] = {src_w[3 * g], src_w[3 * g + 1], src_w[3 * g + 2]};
    float v[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      v[i] = tab[tab_ch[i % 3]][(w[i / 4] >> (8 * (i & 3))) & 0xffu];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dst4[3 * g + k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                    v[4 * k + 3]);
    }
  }
  for (long long p = n_groups * 4 + first; p < n_pix; p += stride) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      dst[p * 3 + ch] = tab[tab_ch[ch]][src[p * 3 + ch]];
    }
  }
}

// Tail: f32 -> u8: gamma (when do_gamma), then clip(rint(x), 0, 255), and
// the gray of the unsaturated x. vec: src and gray 16-byte, dst 4-byte
// aligned.
__global__ void __launch_bounds__(kThreads)
enhance_tail_kernel(const float* __restrict__ src, uint8_t* __restrict__ dst,
                    float* __restrict__ gray, long long n_pix, int do_gamma,
                    float gamma, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long n_groups = vec ? n_pix / 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  uint32_t* dst_w = reinterpret_cast<uint32_t*>(dst);
  for (long long g = first; g < n_groups; g += stride) {
    float v[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 q = src4[3 * g + k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    if (do_gamma) {
#pragma unroll
      for (int i = 0; i < 12; ++i) v[i] = gamma_value(v[i], gamma);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dst_w[3 * g + k] = pack4(u8_bits(v[4 * k]), u8_bits(v[4 * k + 1]),
                               u8_bits(v[4 * k + 2]), u8_bits(v[4 * k + 3]));
    }
    if (gray != nullptr) {
      reinterpret_cast<float4*>(gray)[g] =
          make_float4(gray_of(v[0], v[1], v[2]), gray_of(v[3], v[4], v[5]),
                      gray_of(v[6], v[7], v[8]), gray_of(v[9], v[10], v[11]));
    }
  }
  for (long long p = n_groups * 4 + first; p < n_pix; p += stride) {
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float x = src[p * 3 + ch];
      v[ch] = do_gamma ? gamma_value(x, gamma) : x;
      dst[p * 3 + ch] = static_cast<uint8_t>(u8_bits(v[ch]));
    }
    if (gray != nullptr) gray[p] = gray_of(v[0], v[1], v[2]);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      n = 132;
    }
  }
  return n;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

// Blocks for n_pix pixels at 4 a thread, capped at kBlocksPerSm a SM.
unsigned int group_grid(long long n_pix) {
  long long grid = (n_pix / 4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  return static_cast<unsigned int>(grid);
}

}  // namespace

// src/dst: (n_pix, 3) u8; gray: (n_pix,) f32 or null; wb: (3,) f32 device
// scales or null. Returns the cudaError_t of the launch (0 on success).
extern "C" int vs_enhance_u8(const void* src, void* dst, void* gray,
                             long long n_pix, const void* wb, int do_cb,
                             float contrast, float brightness, int do_gamma,
                             float gamma, void* stream) {
  const int vec = aligned16(src) && aligned16(dst) &&
                  (gray == nullptr || aligned16(gray));
  const long long per_block =
      vec ? static_cast<long long>(kWarps) * kStep : kThreads;
  long long grid = (n_pix + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  enhance_table_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<float*>(gray), n_pix, static_cast<const float*>(wb), do_cb,
      contrast, brightness, do_gamma, gamma, vec);
  return static_cast<int>(cudaGetLastError());
}

// Head: src (n_pix, 3) u8, dst (n_pix, 3) f32, wb (3,) f32 device scales or
// null. Returns the cudaError_t of the launch.
extern "C" int vs_enhance_head(const void* src, void* dst, long long n_pix,
                               const void* wb, int do_cb, float contrast,
                               float brightness, void* stream) {
  const int vec = aligned4(src) && aligned16(dst);
  enhance_head_kernel<<<group_grid(n_pix), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<float*>(dst), n_pix,
      static_cast<const float*>(wb), do_cb, contrast, brightness, vec);
  return static_cast<int>(cudaGetLastError());
}

// Tail: src (n_pix, 3) f32, dst (n_pix, 3) u8, gray (n_pix,) f32 or null.
extern "C" int vs_enhance_tail(const void* src, void* dst, void* gray,
                               long long n_pix, int do_gamma, float gamma,
                               void* stream) {
  const int vec = aligned16(src) && aligned4(dst) &&
                  (gray == nullptr || aligned16(gray));
  enhance_tail_kernel<<<group_grid(n_pix), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<uint8_t*>(dst),
      static_cast<float*>(gray), n_pix, do_gamma, gamma, vec);
  return static_cast<int>(cudaGetLastError());
}
