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
//     rounding. Bound by bytes: 6.2 MB in and 24.9 MB out at 1080p, 9.3
//     us at 3.35 TB/s. The frame is a flat run of 3 H W values, value i
//     mapped to tab[i % 3][src[i]]; a warp step takes 1536 of them in
//     three 16-byte loads a lane, staged in shared memory, and writes
//     them as twelve float4 stores a lane, each store instruction of the
//     warp 512 contiguous bytes (its channel pattern is fixed per lane,
//     since a step starts at channel 0).
//   tail (enhance_tail_kernel<kGamma>): f32 in, u8 out: gamma, then
//     saturate_u8, plus the gray of the unsaturated result when asked
//     for. The input is no longer u8, so the table does not apply: each
//     value is evaluated. Bound by bytes: 24.9 MB in, 6.2 MB out, + 8.3
//     MB of gray, 11.8 us. With gamma the kernel is held by issue
//     instead, not by the function's least work: CUDA's accurate powf,
//     inlined with its special cases, is most of the vector loop's ~104
//     instructions a value (cuobjdump; chip_smoke.py reads it), ~19 us at
//     one instruction a lane and clock (132 SMs x 128 lanes x 1.98 GHz),
//     and the plain version's bits need that powf. So what else the
//     value costs is cut: the IEEE divide by 255 (~10 instructions, a
//     range check and a call to its slow path, which the compiler also
//     repeated inside powf's special-case branch) is div255 below, three
//     instructions with the same bits; gamma is a template argument, so
//     each loop holds one path; with gamma a step loads its own input
//     (fewer registers, more warps to issue from), without it the next
//     step's loads are issued first. I/O is staged through shared memory
//     as in the table kernel: coalesced 16-byte loads and stores a lane.
// Both take a scalar loop for the values after the last whole step and
// for pointers that are not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;       // the table kernel's grid cap
constexpr int kStep = 512;             // pixels per warp and step
constexpr int kStepVec = kStep * 3 / 16;   // 96 uint4 of input per step
constexpr int kHeadStep = kStep * 3;   // head: u8 values per warp and step
constexpr int kTailStep = 128;         // tail: pixels per warp and step
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

// x / 255 for x in [0, 255], correctly rounded as __fdiv_rn gives it: the
// product with RN(1/255), then one FMA correction (Markstein: with the
// reciprocal within half an ulp and the product within one, q + r/255
// rounds to the quotient). Three instructions where __fdiv_rn takes about
// ten and a range check with a call to its slow path. chip_smoke.py holds
// the tail to its plain version, a true division, for every float32 in
// [0, 255] (sweep_tail).
__device__ __forceinline__ float div255(float x) {
  constexpr float kInv255 = 1.0f / 255.0f;
  const float q = __fmul_rn(x, kInv255);
  const float r = __fmaf_rn(-q, 255.0f, x);
  return __fmaf_rn(r, kInv255, q);
}

__device__ __forceinline__ float gamma_value(float x, float gamma) {
  const float norm = div255(fminf(fmaxf(x, 0.0f), 255.0f));
  return __fmul_rn(powf(norm, gamma), 255.0f);
}

// Head: u8 -> f32 through the table of white balance and contrast /
// brightness (gamma off), as a flat map of the frame's 3 * n_pix values:
// value i is tab[i % 3][src[i]] (tab[0] for all without white balance).
// A warp step is 1536 values: three 16-byte loads a lane on neighbouring
// addresses, staged in shared memory, then twelve float4 stores a lane in
// which lane l of store k writes values 128 k + 4 l .. + 3, so each store
// instruction of the warp covers 512 contiguous bytes. The next step's
// loads are issued before this step's stores. vec: src and dst 16-byte
// aligned.
__global__ void __launch_bounds__(kThreads)
enhance_head_kernel(const uint8_t* __restrict__ src, float* __restrict__ dst,
                    long long n_values, const float* __restrict__ wb,
                    int do_cb, float contrast, float brightness, int vec) {
  __shared__ float tab[3 * 256];
  __shared__ uint4 stage[kWarps][kStepVec];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_wb = wb != nullptr;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  float4* dst4 = reinterpret_cast<float4*>(dst);

  const long long n_steps = vec ? n_values / kHeadStep : 0;
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
    tab[e] = enhance_value(static_cast<float>(e & 255),
                           has_wb ? wb[ch] : 1.0f, has_wb, do_cb, contrast,
                           brightness, 0, 1.0f);
  }
  __syncthreads();

  // A step starts at channel 0 (1536 = 0 mod 3), so value 128 k + 4 l + q
  // of a step has channel (2 k + l + q) mod 3; off[r] is the table of
  // channel (l + r) mod 3.
  int off[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) off[r] = has_wb ? 256 * ((lane + r) % 3) : 0;
  uint4* buf4 = stage[warp];
  const uint32_t* buf = reinterpret_cast<const uint32_t*>(buf4);
#pragma unroll 1
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
    float4* out = dst4 + step * (kHeadStep / 4);
#pragma unroll
    for (int k = 0; k < kHeadStep / 128; ++k) {
      const uint32_t w = buf[32 * k + lane];
      out[32 * k + lane] = make_float4(
          tab[off[(2 * k) % 3] + (w & 0xffu)],
          tab[off[(2 * k + 1) % 3] + ((w >> 8) & 0xffu)],
          tab[off[(2 * k + 2) % 3] + ((w >> 16) & 0xffu)],
          tab[off[(2 * k + 3) % 3] + (w >> 24)]);
    }
    __syncwarp();
  }

  // The scalar loop: the values after the last whole step, or all of them
  // when a pointer is not 16-byte aligned.
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = n_steps * kHeadStep +
                     static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n_values; i += stride) {
    dst[i] = tab[(has_wb ? 256 * static_cast<int>(i % 3) : 0) + src[i]];
  }
}

// Tail: f32 -> u8: gamma (kGamma), then clip(rint(x), 0, 255), and the
// gray of the unsaturated x. A warp step is 128 pixels: 96 float4 in,
// three 16-byte loads a lane on neighbouring addresses, staged in shared
// memory; lane l then reads its pixels 4 l .. 4 l + 3 as three float4 at a
// 48-byte stride (free of bank conflicts within a quarter-warp), writes
// its 12 result bytes back to the stage and its 4 grays as one float4;
// the 384 result bytes leave as 24 contiguous 16-byte stores. With gamma
// the step is bound by issue (powf), and registers buy more warps: the
// step loads its own input. Without gamma it moves bytes: the next step's
// loads are issued before this step's work. vec: src, dst and gray
// 16-byte aligned.
template <bool kGamma>
__global__ void __launch_bounds__(kThreads)
enhance_tail_kernel(const float* __restrict__ src, uint8_t* __restrict__ dst,
                    float* __restrict__ gray, long long n_pix, float gamma,
                    int vec) {
  __shared__ float4 stage[kWarps][kTailStep * 3 / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* src4 = reinterpret_cast<const float4*>(src);

  const long long n_steps = vec ? n_pix / kTailStep : 0;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  long long step = static_cast<long long>(blockIdx.x) * kWarps + warp;
  float4 in[3];
  if (!kGamma && step < n_steps) {
#pragma unroll
    for (int k = 0; k < 3; ++k) in[k] = src4[step * 96 + 32 * k + lane];
  }
  float4* buf = stage[warp];
  uint32_t* buf_w = reinterpret_cast<uint32_t*>(buf);
#pragma unroll 1
  for (; step < n_steps; step += warp_stride) {
    if (kGamma) {
#pragma unroll
      for (int k = 0; k < 3; ++k) in[k] = src4[step * 96 + 32 * k + lane];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) buf[32 * k + lane] = in[k];
    __syncwarp();
    const long long next = step + warp_stride;
    if (!kGamma && next < n_steps) {   // overlaps this step's stores
#pragma unroll
      for (int k = 0; k < 3; ++k) in[k] = src4[next * 96 + 32 * k + lane];
    }
    float v[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 q = buf[3 * lane + k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    __syncwarp();   // every lane has read before the bytes overwrite
    if (kGamma) {
#pragma unroll
      for (int i = 0; i < 12; ++i) v[i] = gamma_value(v[i], gamma);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      buf_w[3 * lane + k] = pack4(u8_bits(v[4 * k]), u8_bits(v[4 * k + 1]),
                                  u8_bits(v[4 * k + 2]),
                                  u8_bits(v[4 * k + 3]));
    }
    if (gray != nullptr) {
      reinterpret_cast<float4*>(gray)[step * (kTailStep / 4) + lane] =
          make_float4(gray_of(v[0], v[1], v[2]), gray_of(v[3], v[4], v[5]),
                      gray_of(v[6], v[7], v[8]),
                      gray_of(v[9], v[10], v[11]));
    }
    __syncwarp();
    if (lane < kTailStep * 3 / 16) {
      reinterpret_cast<uint4*>(dst)[step * (kTailStep * 3 / 16) + lane] =
          reinterpret_cast<const uint4*>(buf)[lane];
    }
    __syncwarp();
  }

  // The scalar loop: the pixels after the last whole step, or all of them
  // when a pointer is not 16-byte aligned.
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = n_steps * kTailStep +
                     static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < n_pix; p += stride) {
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float x = src[p * 3 + ch];
      v[ch] = kGamma ? gamma_value(x, gamma) : x;
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

// Blocks for a launch that needs `needed` blocks of kThreads, capped at
// the blocks of `Kernel` that the SMs hold at once (its occupancy, read
// once per kernel): the capped grid walks the rest in its loops.
template <auto Kernel>
unsigned int resident_grid(long long needed) {
  static int per_sm = 0;
  if (per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                     kThreads, 0) !=
           cudaSuccess ||
       per_sm < 1)) {
    per_sm = 1;
  }
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  if (needed > cap) needed = cap;
  if (needed < 1) needed = 1;
  return static_cast<unsigned int>(needed);
}

// Blocks for `n_steps` warp steps and `n_scalar` values of the scalar loop.
long long blocks_needed(long long n_steps, long long n_scalar) {
  const long long vector = (n_steps + kWarps - 1) / kWarps;
  const long long scalar = (n_scalar + kThreads - 1) / kThreads;
  return vector > scalar ? vector : scalar;
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
  const int vec = aligned16(src) && aligned16(dst);
  const long long n_values = 3 * n_pix;
  const long long n_steps = vec ? n_values / kHeadStep : 0;
  enhance_head_kernel<<<
      resident_grid<enhance_head_kernel>(
          blocks_needed(n_steps, n_values - n_steps * kHeadStep)),
      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<float*>(dst), n_values,
      static_cast<const float*>(wb), do_cb, contrast, brightness, vec);
  return static_cast<int>(cudaGetLastError());
}

// Tail: src (n_pix, 3) f32, dst (n_pix, 3) u8, gray (n_pix,) f32 or null.
extern "C" int vs_enhance_tail(const void* src, void* dst, void* gray,
                               long long n_pix, int do_gamma, float gamma,
                               void* stream) {
  const int vec = aligned16(src) && aligned16(dst) &&
                  (gray == nullptr || aligned16(gray));
  const long long n_steps = vec ? n_pix / kTailStep : 0;
  const long long needed = blocks_needed(n_steps, n_pix - n_steps * kTailStep);
  const auto kernel =
      do_gamma ? enhance_tail_kernel<true> : enhance_tail_kernel<false>;
  kernel<<<do_gamma ? resident_grid<enhance_tail_kernel<true>>(needed)
                    : resident_grid<enhance_tail_kernel<false>>(needed),
           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<uint8_t*>(dst),
      static_cast<float*>(gray), n_pix, gamma, vec);
  return static_cast<int>(cudaGetLastError());
}
