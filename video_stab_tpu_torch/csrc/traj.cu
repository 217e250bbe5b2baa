// K5a / K5b: windowed-sum box filters over a trajectory, f32 (N, C).
//
// Replaces the Pallas kernel video_stab_tpu/pallas/traj.py:_box_kernel,
// driven by box_filter_convolve (K5a: boxFilterConvolveCUDA semantics) and
// by box_filter_centered (K5b: the centered, count-normalized window the
// offline stabilizer smooths with).
//
// Both read the path through a virtual padded sequence
//   padded[j] = x[j - offset]  for 0 <= j - offset < n,  else pad[ch],
// and compute, per (output index i, channel ch),
//   acc = 0; acc = acc + padded[i + k] for k = 0 .. window - 1, in order;
//   out = acc * rcp(window)                         (K5a: window = r)
//   out = ((acc * rcp(window)) * window) / count(i) (K5b: window = 2r + 1)
// with count(i) = min(i + r, n - 1) - max(i - r, 0) + 1 and rcp the
// float32 reciprocal. That is the summation order of _box_kernel and the
// expression order of box_filter_centered (traj.py:130) as XLA compiles
// them (it turns the kernel's divide by the constant window into a
// multiply by its reciprocal), each step rounded (__fadd_rn and friends,
// never contracted), so the plain PyTorch versions in
// video_stab_tpu_torch/kernels/traj.py and the JAX kernel run on the CPU
// give the same bits. K5b pads with zeros; K5a pads with the per-channel
// upper median (sorted[n / 2], std::nth_element's), which the launch
// computes itself for a path one block can hold.
//
// Bound on the H100: one launch and one chain of dependent latencies (a
// read of the path, a barrier, `window` dependent adds, a store); the bytes
// are a few KB. So the design keeps that chain short and everything in one
// launch, and the pad is a kernel argument (a null pointer is zero), not a
// device array the caller fills.
//
// box_window_kernel (K5b, and K5a on a path too long for the median
// kernel): a block of (c, tile_rows) threads owns a tile of output rows and
// stages the tile and its window halo into shared memory with coalesced
// loads, writing the pad value into the halo slots that fall outside the
// path; the window loop then reads shared memory at consecutive addresses
// for consecutive threads (out element e reads s[e + k * c]) with no bounds
// test, sixteen loads issued ahead of their sixteen dependent adds. A
// thread's channel and row are its block indices: no division on the way.
// (16-byte loads where the address allowed measured slower at these sizes:
// the address set-up cost more than the loads saved. A window loop left to
// the compiler's unrolling ran its remainder, up to 15 of 31 taps, one
// dependent load and add at a time.)
//
// box_median_kernel (K5a with the median in the launch): one block per
// channel holds that channel's whole path. It ranks every sample among the
// channel's samples by counting: keys in a total order with NaN last, as
// torch.sort has it, ties broken by index (a sample counts the equal keys
// before it and the smaller keys everywhere), so exactly one sample has
// rank n / 2. That sample is the pad; the block writes it into the halo
// and sums the windows as above. All lanes of a warp read the same four
// keys at a time (a broadcast), two instructions a comparison.
//
// The TPU kernel's (8, 128) chunking and lane-aligned padding have no
// counterpart.

#include <cuda_runtime.h>

namespace {

// float32 -> uint32 key whose unsigned order is torch.sort's order: negative
// values below positive ones, every NaN last. (-0 sorts below +0 where
// torch.sort calls them equal; either is the same pad to a sum that starts
// at +0.)
__device__ __forceinline__ unsigned sort_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The window sum and its normalization, from staged values `stride`
// apart, in the order and the roundings stated at the top of the file. The
// taps go in chunks of 16: all of a chunk's loads, then its adds in order.
// The last chunk is filled up with +0, which leaves every bit of the sum as
// it is (the sum starts at +0 and can never be -0).
__device__ __forceinline__ float window_mean(const float* p, int stride,
                                             int window, int centered, int i,
                                             int r, int n) {
  constexpr int kChunk = 16;
  float acc = 0.0f;
  for (int k0 = 0; k0 < window; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      v[j] = (k0 + j < window) ? p[(k0 + j) * stride] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) acc = __fadd_rn(acc, v[j]);
  }
  const float wf = static_cast<float>(window);
  float o = __fmul_rn(acc, __frcp_rn(wf));
  if (centered) {
    const int count = min(i + r, n - 1) - max(i - r, 0) + 1;
    o = __fdiv_rn(__fmul_rn(o, wf), static_cast<float>(count));
  }
  return o;
}

// Block (c, tile_rows). Shared memory: (tile_rows + window - 1) * c staged
// values; s[f] is x[(row0 - offset) * c + f] where that lies in the path,
// else the pad of channel f % c.
__global__ void __launch_bounds__(1024)
box_window_kernel(const float* __restrict__ x, int n, int c, int offset,
                  int window, const float* __restrict__ pad, int centered,
                  int r, float* __restrict__ out) {
  extern __shared__ __align__(16) float s[];
  const int tile_rows = blockDim.y;
  const int tid = threadIdx.y * c + threadIdx.x;
  const int nthreads = tile_rows * c;
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - row0);
  const int staged = (rows + window - 1) * c;
  const int total = n * c;
  const int base = (row0 - offset) * c;

  for (int f = tid; f < staged; f += nthreads) {
    const int g = base + f;
    float v = 0.0f;
    if (g >= 0 && g < total) {
      v = x[g];
    } else if (pad) {
      v = pad[f % c];
    }
    s[f] = v;
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.y) < rows) {
    const int i = row0 + threadIdx.y;
    out[row0 * c + tid] = window_mean(s + tid, c, window, centered, i, r, n);
  }
}

// Grid (c,), one block per channel. Shared memory: [keys: n4][padv: 4]
// [s: n + window - 1], n4 = n rounded up to 4.
__global__ void __launch_bounds__(1024)
box_median_kernel(const float* __restrict__ x, int n, int c, int offset,
                  int window, int centered, int r, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ch = blockIdx.x;
  const int n4 = (n + 3) & ~3;
  const int staged = n + window - 1;
  unsigned* keys = reinterpret_cast<unsigned*>(smem);
  float* padv = smem + n4;
  float* s = padv + 4;

  // Keys and the staged channel; key slots n .. n4 - 1 hold the largest key
  // at an index above every sample's, which counts for no one.
  for (int a = tid; a < n4; a += nthreads) {
    const float v = a < n ? x[a * c + ch] : 0.0f;
    keys[a] = a < n ? sort_key(v) : 0xFFFFFFFFu;
    if (a < n && a + offset < staged) s[a + offset] = v;
  }
  __syncthreads();

  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  const int mid = n >> 1;
  for (int a = tid; a < n; a += nthreads) {
    const unsigned ka = keys[a];
    const int a4 = a >> 2;
    int rank = 0;
    for (int b4 = 0; b4 < a4; ++b4) {          // indices below a: <=
      const uint4 k = k4[b4];
      rank += (k.x <= ka) + (k.y <= ka) + (k.z <= ka) + (k.w <= ka);
    }
    {
      const uint4 k = k4[a4];
      const int j = a & 3;
      rank += (j > 0 ? k.x <= ka : k.x < ka) + (j > 1 ? k.y <= ka : k.y < ka) +
              (j > 2 ? k.z <= ka : k.z < ka) + (k.w < ka);
    }
    for (int b4 = a4 + 1; b4 < (n4 >> 2); ++b4) {   // indices above a: <
      const uint4 k = k4[b4];
      rank += (k.x < ka) + (k.y < ka) + (k.z < ka) + (k.w < ka);
    }
    if (rank == mid) padv[0] = x[a * c + ch];
  }
  __syncthreads();
  const float pv = padv[0];
  for (int j = tid; j < staged; j += nthreads) {
    const int row = j - offset;
    if (row < 0 || row >= n) s[j] = pv;
  }
  __syncthreads();

  for (int i = tid; i < n; i += nthreads) {
    out[i * c + ch] = window_mean(s + i, 1, window, centered, i, r, n);
  }
}

}  // namespace

// x, out: (n, c) row-major f32. pad: (c,) f32 on the device, or null for a
// zero pad; ignored when median != 0, where one block per channel (blocks
// must be c) computes that channel's upper median and pads with it.
// blocks, threads (for the tiled kernel: c * tile_rows, as a (c, tile_rows)
// block), tile_rows (output rows a block owns) and smem_bytes are the
// launch configuration, from kernels/traj.py:launch_config. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int vs_box_window(const void* x, int n, int c, int offset,
                             int window, const void* pad, int median,
                             int centered, int r, int blocks, int threads,
                             int tile_rows, int smem_bytes, void* out,
                             void* stream) {
  if (n <= 0 || c <= 0 || window <= 0 || offset < 0 || blocks <= 0 ||
      threads <= 0 || threads > 1024 || tile_rows <= 0 || smem_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (median ? blocks != c
             : (threads != c * tile_rows ||
                static_cast<long long>(blocks) * tile_rows < n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (median) {
    if (smem_bytes > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(
          box_median_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    box_median_kernel<<<blocks, threads, smem_bytes, st>>>(
        xf, n, c, offset, window, centered, r, of);
  } else {
    if (smem_bytes > 48 * 1024) {
      cudaError_t rc = cudaFuncSetAttribute(
          box_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    box_window_kernel<<<blocks, dim3(c, tile_rows), smem_bytes, st>>>(
        xf, n, c, offset, window, static_cast<const float*>(pad), centered,
        r, of);
  }
  return static_cast<int>(cudaGetLastError());
}
