// What K1's two backward kernels share (csrc/trunk.cu, csrc/trunk_bwd.cu):
// the flat parameter layout, the leaky ReLU, and the block-order sum of the
// backward's per-block partials.
#pragma once

#include "common.cuh"

// the widths with an instantiated kernel; the wrapper pads others upward
#define CT_TRUNK_WIDTHS(X)                                                   \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \
  X(14) X(15) X(16) X(20) X(24) X(28) X(32)

namespace {

constexpr int REDUCE_THREADS = 256;

// number of weight / bias floats in the flat parameter layout:
// W_0 (d_in, W), W_1..W_{L-1} (W, W)[, head (W, 2)]; b_0..b_{L-1} (W)[, (2)]
__host__ __device__ inline int n_weights(int d_in, int W, int L, bool head) {
  return d_in * W + (L - 1) * W * W + (head ? 2 * W : 0);
}
__host__ __device__ inline int n_biases(int W, int L, bool head) {
  return L * W + (head ? 2 : 0);
}
__host__ __device__ inline int w_offset(int l, int d_in, int W) {
  return l == 0 ? 0 : d_in * W + (l - 1) * W * W;
}

__device__ inline float leaky(float v, float leak) {
  return v >= 0.f ? v : leak * v;
}

// out[i] = sum over blocks, in block order, of part[blk][i]
__global__ void reduce_blocks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_blocks,
                                     int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk)
    s += part[static_cast<size_t>(blk) * size + i];
  out[i] = s;
}

inline cudaError_t reduce_blocks(const float* part, float* out,
                                 int n_blocks, int size,
                                 cudaStream_t stream) {
  reduce_blocks_kernel<<<ct_blocks(size, REDUCE_THREADS), REDUCE_THREADS, 0,
                         stream>>>(part, out, n_blocks, size);
  return cudaGetLastError();
}

}  // namespace
