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
// give the same bits. K5a pads with the per-channel upper median, K5b with
// zeros; pad is a (C,) device array.
//
// Bound on the H100: launch latency. A 240-frame path is a few thousand
// floats; one thread per output value reads its window from L1/L2, and the
// TPU kernel's (8, 128) chunking and lane-aligned padding have no
// counterpart. One launch replaces the TPU's per-channel pallas_call loop.

#include <cuda_runtime.h>

namespace {

__global__ void box_window_kernel(const float* __restrict__ x, int n, int c,
                                  int offset, int window,
                                  const float* __restrict__ pad, int centered,
                                  int r, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  const int i = idx / c;
  const int ch = idx - i * c;
  const float pv = pad[ch];
  float acc = 0.0f;
  for (int k = 0; k < window; ++k) {
    const int j = i + k - offset;
    const float v = (j >= 0 && j < n) ? x[j * c + ch] : pv;
    acc = __fadd_rn(acc, v);
  }
  const float wf = static_cast<float>(window);
  float o = __fmul_rn(acc, __frcp_rn(wf));
  if (centered) {
    const int count = min(i + r, n - 1) - max(i - r, 0) + 1;
    o = __fdiv_rn(__fmul_rn(o, wf), static_cast<float>(count));
  }
  out[idx] = o;
}

}  // namespace

// x, out: (n, c) row-major f32; pad: (c,) f32. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int vs_box_window(const void* x, int n, int c, int offset,
                             int window, const void* pad, int centered, int r,
                             void* out, void* stream) {
  if (n <= 0 || c <= 0 || window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 128;
  const int blocks = (n * c + threads - 1) / threads;
  box_window_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, c, offset, window,
      static_cast<const float*>(pad), centered, r, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
