// K1: the scaling-MLP trunk + linear head, forward and backward.
//
// Replaces careless_tpu/ops/fused_mlp.py:_fwd_kernel and :_bwd_kernel (the
// pallas_calls of _trunk_fwd and _trunk_bwd). Computes, for every
// observation n with metadata x[n] (d_in floats),
//     h_0 = x[n];  h_{l+1} = leaky(h_l W_l + b_l)  for l < L
//     (loc[n], raw[n]) = h_L W_L + b_L              (the head, width -> 2)
// with leaky(v) = v for v >= 0 and leak * v otherwise, in f32 throughout (no
// TF32, no tensor cores).
//
// What bounds it on the H100: operations. At the main path (N = 1M,
// d_in = width = 10, L = 20) the forward does 2 N (20*100 + 20) = 4.0 GFLOP
// on 48 MB of input and output; at 67 TFLOP/s f32 that is ~60 us against
// ~14 us of memory traffic. The backward recomputes the forward and adds the
// products for dW and for the cotangent, ~11.9 GFLOP.
//
// Design. The TPU kernel lane-packed 12 observations into one 128-wide MXU
// row and kept every layer's block-diagonal weight in VMEM. Here one thread
// owns one observation: its width-W activation lives in registers (W is a
// template parameter, so the per-layer product is a fully unrolled chain of
// W*W FMAs), and all layers' weights and biases sit in shared memory, where
// every thread of a warp reads the same word (a broadcast, no bank
// conflicts). Widths the library is not instantiated for are padded by the
// Python wrapper to the next instantiated width with zero weights, which is
// exact.
//
// The TPU backward accumulated dW/db across a sequential grid. Blocks run in
// parallel here, so the backward uses a fixed grid: block g walks the tiles
// g, g + G, g + 2G, ... of BWD_T observations, recomputes each tile's
// forward into shared memory (activations of all layers, one row per
// feature, padded to avoid bank conflicts), and sums each (k, j) product
// over the tile in a fixed order into a per-block partial in shared memory.
// The partials go to a (G, nw + nb) scratch and a second launch sums them
// over blocks in block order. No atomics: two runs give bitwise-identical
// dW and db.
#include "common.cuh"

namespace {

constexpr int FWD_THREADS = 128;
constexpr int BWD_T = 64;           // observations per backward tile
constexpr int PAD = BWD_T + 1;      // shared-memory row stride
constexpr int REDUCE_THREADS = 256;

// number of weight / bias floats in the flat parameter layout:
// W_0 (d_in, W), W_1..W_{L-1} (W, W), head (W, 2); b_0..b_{L-1} (W), head (2)
__host__ __device__ inline int n_weights(int d_in, int W, int L) {
  return d_in * W + (L - 1) * W * W + 2 * W;
}
__host__ __device__ inline int n_biases(int W, int L) { return L * W + 2; }
__host__ __device__ inline int w_offset(int l, int d_in, int W) {
  return l == 0 ? 0 : d_in * W + (l - 1) * W * W;
}

__device__ inline float leaky(float v, float leak) {
  return v >= 0.f ? v : leak * v;
}

template <int W>
__global__ void trunk_fwd_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 float* __restrict__ loc,
                                 float* __restrict__ raw, int n, int d_in,
                                 int L, float leak) {
  extern __shared__ float smem[];
  const int nw = n_weights(d_in, W, L);
  const int nb = n_biases(W, L);
  float* sw = smem;
  float* sb = smem + nw;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = b[i];
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;

  float h[W];
#pragma unroll
  for (int j = 0; j < W; ++j) h[j] = 0.f;
  const float* xr = x + static_cast<size_t>(row) * d_in;
  for (int k = 0; k < d_in; ++k) {
    const float xk = xr[k];
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = fmaf(xk, sw[k * W + j], h[j]);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) h[j] = leaky(h[j] + sb[j], leak);

  for (int l = 1; l < L; ++l) {
    const float* wl = sw + w_offset(l, d_in, W);
    const float* bl = sb + l * W;
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = fmaf(h[k], wl[k * W + j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = leaky(acc[j] + bl[j], leak);
  }

  const float* wh = sw + w_offset(L, d_in, W);
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    y0 = fmaf(h[k], wh[2 * k], y0);
    y1 = fmaf(h[k], wh[2 * k + 1], y1);
  }
  loc[row] = y0 + sb[L * W];
  raw[row] = y1 + sb[L * W + 1];
}

// Sum over the tile of a[k][r] * dp[j][r] for the pairs this thread owns,
// plus the bias rows sum_r dp[j][r]; added to the block's partials.
__device__ inline void accumulate_pairs(const float* a, const float* dp,
                                        int d_in_l, int d_out,
                                        float* acc_w, float* acc_b) {
  const int n_pairs = d_in_l * d_out + d_out;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    float s = 0.f;
    if (p < d_in_l * d_out) {
      const int k = p / d_out, j = p % d_out;
      const float* ak = a + k * PAD;
      const float* dj = dp + j * PAD;
      for (int r = 0; r < BWD_T; ++r) s = fmaf(ak[r], dj[r], s);
      acc_w[p] += s;
    } else {
      const float* dj = dp + (p - d_in_l * d_out) * PAD;
      for (int r = 0; r < BWD_T; ++r) s += dj[r];
      acc_b[p - d_in_l * d_out] += s;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(BWD_T)
trunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, const float* __restrict__ dloc,
                 const float* __restrict__ draw, float* __restrict__ dx,
                 float* __restrict__ part, int n, int d_in, int L,
                 float leak) {
  extern __shared__ float smem[];
  const int nw = n_weights(d_in, W, L);
  const int nb = n_biases(W, L);
  float* sw = smem;                     // weights            (nw)
  float* sb = sw + nw;                  // biases             (nb)
  float* acc_w = sb + nb;               // dW partial         (nw)
  float* acc_b = acc_w + nw;            // db partial         (nb)
  float* xs = acc_b + nb;               // x tile             (d_in rows)
  float* acts = xs + d_in * PAD;        // a_1..a_L           (L*W rows)
  float* dps = acts + L * W * PAD;      // current dpre       (W rows)
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    sw[i] = w[i];
    acc_w[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    sb[i] = b[i];
    acc_b[i] = 0.f;
  }

  const int t = threadIdx.x;
  const int n_tiles = (n + BWD_T - 1) / BWD_T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int first = tile * BWD_T;
    const int row = first + t;
    const bool valid = row < n;
    // stage the x tile, transposed, zero past the ragged edge
    for (int i = t; i < BWD_T * d_in; i += BWD_T) {
      const int r = i / d_in, k = i % d_in;
      xs[k * PAD + r] = first + r < n
          ? x[static_cast<size_t>(first) * d_in + i] : 0.f;
    }
    __syncthreads();

    // recompute the forward, keeping a_1..a_L in shared memory
    float h[W];
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = 0.f;
    for (int k = 0; k < d_in; ++k) {
      const float xk = xs[k * PAD + t];
#pragma unroll
      for (int j = 0; j < W; ++j) h[j] = fmaf(xk, sw[k * W + j], h[j]);
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      h[j] = leaky(h[j] + sb[j], leak);
      acts[j * PAD + t] = h[j];
    }
    for (int l = 1; l < L; ++l) {
      const float* wl = sw + w_offset(l, d_in, W);
      float acc[W];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) {
#pragma unroll
        for (int j = 0; j < W; ++j)
          acc[j] = fmaf(h[k], wl[k * W + j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        h[j] = leaky(acc[j] + sb[l * W + j], leak);
        acts[(l * W + j) * PAD + t] = h[j];
      }
    }

    // head: dpre = (dloc, draw); dh = dpre W_L^T
    const float d0 = valid ? dloc[row] : 0.f;
    const float d1 = valid ? draw[row] : 0.f;
    dps[t] = d0;
    dps[PAD + t] = d1;
    const float* wh = sw + w_offset(L, d_in, W);
    float dh[W];
#pragma unroll
    for (int k = 0; k < W; ++k) dh[k] = fmaf(d0, wh[2 * k], d1 * wh[2 * k + 1]);
    __syncthreads();
    accumulate_pairs(acts + (L - 1) * W * PAD, dps, W, 2,
                     acc_w + w_offset(L, d_in, W), acc_b + L * W);
    __syncthreads();

    for (int l = L - 1; l >= 0; --l) {
      // slope 1 where the activation is >= 0 (fused_mlp.py:141)
      float dpre[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float a = acts[(l * W + j) * PAD + t];
        dpre[j] = a >= 0.f ? dh[j] : leak * dh[j];
        dps[j * PAD + t] = dpre[j];
      }
      const float* wl = sw + w_offset(l, d_in, W);
      if (l > 0) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < W; ++j) s = fmaf(dpre[j], wl[k * W + j], s);
          dh[k] = s;
        }
      } else if (dx != nullptr && valid) {
        for (int k = 0; k < d_in; ++k) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < W; ++j) s = fmaf(dpre[j], wl[k * W + j], s);
          dx[static_cast<size_t>(row) * d_in + k] = s;
        }
      }
      __syncthreads();
      const float* a_in = l == 0 ? xs : acts + (l - 1) * W * PAD;
      accumulate_pairs(a_in, dps, l == 0 ? d_in : W, W,
                       acc_w + w_offset(l, d_in, W), acc_b + l * W);
      __syncthreads();
    }
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * (nw + nb);
  for (int i = threadIdx.x; i < nw + nb; i += blockDim.x) out[i] = acc_w[i];
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

size_t fwd_smem(int d_in, int W, int L) {
  return sizeof(float) * (n_weights(d_in, W, L) + n_biases(W, L));
}

size_t bwd_smem(int d_in, int W, int L) {
  const int rows = d_in + L * W + (W > 2 ? W : 2);
  return sizeof(float) *
      (2 * (n_weights(d_in, W, L) + n_biases(W, L)) + rows * PAD);
}

template <int W>
cudaError_t launch_fwd(const float* x, const float* w, const float* b,
                       float* loc, float* raw, int n, int d_in, int L,
                       float leak, cudaStream_t stream) {
  const size_t smem = fwd_smem(d_in, W, L);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_fwd_kernel<W><<<ct_blocks(n, FWD_THREADS), FWD_THREADS, smem,
                        stream>>>(x, w, b, loc, raw, n, d_in, L, leak);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_bwd(const float* x, const float* w, const float* b,
                       const float* dloc, const float* draw, float* dx,
                       float* part, float* out, int n, int d_in, int L,
                       int n_blocks, float leak, cudaStream_t stream) {
  const size_t smem = bwd_smem(d_in, W, L);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_bwd_kernel<W><<<n_blocks, BWD_T, smem, stream>>>(
      x, w, b, dloc, draw, dx, part, n, d_in, L, leak);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = n_weights(d_in, W, L) + n_biases(W, L);
  reduce_blocks_kernel<<<ct_blocks(size, REDUCE_THREADS), REDUCE_THREADS, 0,
                         stream>>>(part, out, n_blocks, size);
  return cudaGetLastError();
}

}  // namespace

// the widths with an instantiated kernel; the wrapper pads others upward
#define CT_TRUNK_WIDTHS(X)                                                   \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \
  X(14) X(15) X(16) X(20) X(24) X(28) X(32)

CT_API int ct_trunk_fwd(const float* x, const float* w, const float* b,
                        float* loc, float* raw, int n, int d_in, int width,
                        int n_layers, float leak, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_layers < 1 || d_in < 1) return cudaErrorInvalidValue;
  switch (width) {
#define CT_CASE(W)                                                           \
  case W:                                                                    \
    return launch_fwd<W>(x, w, b, loc, raw, n, d_in, n_layers, leak,        \
                         ct_stream(stream));
    CT_TRUNK_WIDTHS(CT_CASE)
#undef CT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// part: (n_blocks, nw + nb) scratch; out: (nw + nb) = [dW flat, db flat]
CT_API int ct_trunk_bwd(const float* x, const float* w, const float* b,
                        const float* dloc, const float* draw, float* dx,
                        float* part, float* out, int n, int d_in, int width,
                        int n_layers, int n_blocks, float leak,
                        void* stream) {
  if (n_layers < 1 || d_in < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  switch (width) {
#define CT_CASE(W)                                                           \
  case W:                                                                    \
    return launch_bwd<W>(x, w, b, dloc, draw, dx, part, out, n, d_in,       \
                         n_layers, n_blocks, leak, ct_stream(stream));
    CT_TRUNK_WIDTHS(CT_CASE)
#undef CT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

CT_API size_t ct_trunk_smem(int d_in, int width, int n_layers, int backward) {
  return backward ? bwd_smem(d_in, width, n_layers)
                  : fwd_smem(d_in, width, n_layers);
}
