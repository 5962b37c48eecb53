// What K1's kernels share (csrc/trunk.cu, csrc/trunk_bwd.cu,
// csrc/trunk_bwd_bf16.cu): the flat parameter layout, the leaky ReLU, the
// per-row layer product in K1-fwd's summation order, and the block-order
// sum of the backward's per-block partials.
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

// K1-fwd's order for one row's layer product: acc[j] += in_k * wt(k, j) for
// j < W, called for k = 0, 1, ... in order from acc = 0; then
// h[j] = leaky(acc[j] + b[j]). Every kernel that recomputes the forward for
// its backward sums in this order, so that each activation, and with it
// each slope of the leaky ReLU, is bit for bit the one the loss saw (a
// pre-activation within an ulp of zero takes the other slope under another
// order, and its row's gradient moves by 1 / leak). wt(k, j) returns the
// weight as an f32 (bf16-rounded where the operands are).
template <int W, class WeightAt>
__device__ __forceinline__ void axpy_k(float (&acc)[W], float in_k, int k,
                                       const WeightAt& wt) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = fmaf(in_k, wt(k, j), acc[j]);
}

template <int W>
__device__ __forceinline__ void bias_leaky(float (&h)[W],
                                           const float (&acc)[W],
                                           const float* b, float leak) {
#pragma unroll
  for (int j = 0; j < W; ++j) h[j] = leaky(acc[j] + b[j], leak);
}

// a hidden layer of width W on a width-W input `in`, in K1-fwd's order
template <int W, class WeightAt>
__device__ __forceinline__ void dense_layer(float (&h)[W],
                                            const float (&in)[W],
                                            const WeightAt& wt,
                                            const float* b, float leak) {
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) axpy_k<W>(acc, in[k], k, wt);
  bias_leaky<W>(h, acc, b, leak);
}

// out[i] = sum over blocks, in block order, of part[blk][i] (i < size;
// blocks `stride` floats apart)
__global__ void reduce_blocks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_blocks,
                                     int size, int stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk)
    s += part[static_cast<size_t>(blk) * stride + i];
  out[i] = s;
}

inline cudaError_t reduce_blocks(const float* part, float* out,
                                 int n_blocks, int size, int stride,
                                 cudaStream_t stream) {
  reduce_blocks_kernel<<<ct_blocks(size, REDUCE_THREADS), REDUCE_THREADS, 0,
                         stream>>>(part, out, n_blocks, size, stride);
  return cudaGetLastError();
}

}  // namespace
