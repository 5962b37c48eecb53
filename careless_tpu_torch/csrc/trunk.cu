// K1: the scaling-MLP trunk, with or without its linear head, in f32 or with
// bf16 operands, forward and backward.
//
// Replaces careless_tpu/ops/fused_mlp.py:_fwd_kernel and :_bwd_kernel (the
// pallas_calls of _trunk_fwd and _trunk_bwd) in all four of their
// instantiations (head or not, bf16 or not). Computes, for every observation
// n with metadata x[n] (d_in floats),
//     h_0 = x[n];  h_{l+1} = leaky(h_l W_l + b_l)  for l < L
//     (loc[n], raw[n]) = h_L W_L + b_L              (head: width -> 2)
//     out[n, :] = h_L                               (trunk only)
// with leaky(v) = v for v >= 0 and leak * v otherwise. In f32 every product
// is f32 (no TF32, no tensor cores). With bf16, as `_dot` there, both
// operands of every layer product are rounded to bf16 (to nearest, ties to
// even, as XLA's convert and torch's .bfloat16()) and the products sum in
// f32: h W and the head in the forward; bf16(a)^T bf16(dpre) for dW and
// bf16(dpre) bf16(W)^T for dh and dx in the backward. A product of two bf16
// values is exact in f32, so f32 FMAs on rounded operands compute exactly
// that. Biases, the leaky ReLU, the activations kept for its mask and
// db = sum dpre stay f32. `head` and `bf16` are runtime flags: they decide
// where operands are rounded and what the two ends of each direction read
// and write, and add no instantiation.
//
// What bounds it on the H100: operations. At the main path (N = 1M,
// d_in = width = 10, L = 20) the forward does 2 N (20*100 + 20) = 4.0 GFLOP
// on 48 MB of input and output; at 67 TFLOP/s f32 that is ~60 us against
// ~14 us of memory traffic. The backward recomputes the forward and adds the
// products for dW and for the cotangent, ~11.9 GFLOP. The bf16 variants do
// the same f32 FMAs (the least time for bf16 products is on tensor cores,
// which this kernel does not use).
//
// Design. The TPU kernel lane-packed 12 observations into one 128-wide MXU
// row and kept every layer's block-diagonal weight in VMEM. Here one thread
// owns one observation: its width-W activation lives in registers (W is a
// template parameter, so the per-layer product is a fully unrolled chain of
// W*W FMAs), and all layers' weights and biases sit in shared memory, where
// every thread of a warp reads the same word (a broadcast, no bank
// conflicts). With bf16 the weights are rounded once as they are staged.
// Widths the library is not instantiated for are padded by the Python
// wrapper to the next instantiated width with zero weights, which is exact;
// the trunk-only forward writes, and its backward reads, only the model's
// `out_w` columns of each row.
//
// The TPU backward accumulated dW/db across a sequential grid. Blocks run in
// parallel here, so the backward uses a fixed grid: block g walks the tiles
// g, g + G, g + 2G, ... of T observations (one thread each), recomputes each
// tile's forward into shared memory (activations of all layers, one row per
// feature, T + 1 floats apart to avoid bank conflicts), and sums each (k, j)
// product over the tile in a fixed order into a per-block partial in shared
// memory. The partials go to a (G, nw + nb) scratch and a second launch sums
// them over blocks in block order. No atomics: two runs give bitwise-
// identical dW and db. The tile height T (64, 32, 16 or 8) is the block size,
// chosen at run time by the wrapper as the largest whose shared memory fits
// in the block's 227 KB; deep wide trunks (width 28 and 32 at 20 layers) get
// a short tile and a small, slow block rather than a refusal.
#include <cuda_bf16.h>

#include "trunk_common.cuh"

namespace {

constexpr int FWD_THREADS = 128;
constexpr int MAX_BWD_T = 64;       // the tallest backward tile

// the nearest bf16 value (ties to even), as an f32
__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int W>
__device__ inline void round_all(float (&v)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = bf16_round(v[j]);
}

template <int W>
__global__ void trunk_fwd_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 float* __restrict__ out0,
                                 float* __restrict__ out1, int n, int d_in,
                                 int L, int out_w, bool head, bool bf16,
                                 float leak) {
  extern __shared__ float smem[];
  const int nw = n_weights(d_in, W, L, head);
  const int nb = n_biases(W, L, head);
  float* sw = smem;
  float* sb = smem + nw;
  for (int i = threadIdx.x; i < nw; i += blockDim.x)
    sw[i] = bf16 ? bf16_round(w[i]) : w[i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = b[i];
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;

  // the products in order of k, then the bias (trunk_common.cuh), the
  // order every backward's recompute follows
  float h[W];
  {
    float acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
    const float* xr = x + static_cast<size_t>(row) * d_in;
    const auto w0 = [&](int k, int j) { return sw[k * W + j]; };
    for (int k = 0; k < d_in; ++k)
      axpy_k<W>(acc, bf16 ? bf16_round(xr[k]) : xr[k], k, w0);
    bias_leaky<W>(h, acc, sb, leak);
  }
  for (int l = 1; l < L; ++l) {
    const float* wl = sw + w_offset(l, d_in, W);
    if (bf16) round_all(h);
    // h is read whole into the sums before it is overwritten
    dense_layer<W>(h, h, [&](int k, int j) { return wl[k * W + j]; },
                   sb + l * W, leak);
  }

  if (!head) {
    float* o = out0 + static_cast<size_t>(row) * out_w;
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (j < out_w) o[j] = h[j];
    return;
  }
  if (bf16) round_all(h);
  const float* wh = sw + w_offset(L, d_in, W);
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    y0 = fmaf(h[k], wh[2 * k], y0);
    y1 = fmaf(h[k], wh[2 * k + 1], y1);
  }
  out0[row] = y0 + sb[L * W];
  out1[row] = y1 + sb[L * W + 1];
}

// Sum over the tile's T rows of a[k][r] * dp[j][r] for the pairs this thread
// owns (both operands rounded to bf16 when asked), plus the bias rows
// sum_r dp[j][r] (never rounded); added to the block's partials. These sums
// are most of the backward's shared-memory loads, so the tallest tile, which
// every launch at the main path's shape takes, gets loops of a fixed count
// (FIXED_T) that the compiler unrolls; other heights run the same sums in
// the same order with T read at run time.
template <int FIXED_T>
__device__ inline void accumulate_pairs(const float* a, const float* dp,
                                        int d_in_l, int d_out, int T,
                                        bool bf16, float* acc_w,
                                        float* acc_b) {
  if (FIXED_T) T = FIXED_T;
  const int pad = T + 1;
  const int n_pairs = d_in_l * d_out + d_out;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    float s = 0.f;
    if (p < d_in_l * d_out) {
      const int k = p / d_out, j = p % d_out;
      const float* ak = a + k * pad;
      const float* dj = dp + j * pad;
      if (bf16) {
        for (int r = 0; r < T; ++r)
          s = fmaf(bf16_round(ak[r]), bf16_round(dj[r]), s);
      } else {
        for (int r = 0; r < T; ++r) s = fmaf(ak[r], dj[r], s);
      }
      acc_w[p] += s;
    } else {
      const float* dj = dp + (p - d_in_l * d_out) * pad;
      for (int r = 0; r < T; ++r) s += dj[r];
      acc_b[p - d_in_l * d_out] += s;
    }
  }
}

__device__ inline void tile_sums(const float* a, const float* dp, int d_in_l,
                                 int d_out, int T, bool bf16, float* acc_w,
                                 float* acc_b) {
  if (T == MAX_BWD_T)
    accumulate_pairs<MAX_BWD_T>(a, dp, d_in_l, d_out, T, bf16, acc_w, acc_b);
  else
    accumulate_pairs<0>(a, dp, d_in_l, d_out, T, bf16, acc_w, acc_b);
}

// dy0/dy1: the head's (dloc, draw), each (n,); trunk only: dy0 is the
// (n, out_w) cotangent of the last layer's activations and dy1 is unused.
template <int W>
__global__ void __launch_bounds__(MAX_BWD_T)
trunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, const float* __restrict__ dy0,
                 const float* __restrict__ dy1, float* __restrict__ dx,
                 float* __restrict__ part, int n, int d_in, int L, int out_w,
                 bool head, bool bf16, float leak) {
  extern __shared__ float smem[];
  const int T = blockDim.x;             // the tile height
  const int pad = T + 1;                // shared-memory row stride
  const int nw = n_weights(d_in, W, L, head);
  const int nb = n_biases(W, L, head);
  float* sw = smem;                     // weights            (nw)
  float* sb = sw + nw;                  // biases             (nb)
  float* acc_w = sb + nb;               // dW partial         (nw)
  float* acc_b = acc_w + nw;            // db partial         (nb)
  float* xs = acc_b + nb;               // x tile             (d_in rows)
  float* acts = xs + d_in * pad;        // a_1..a_L           (L*W rows)
  float* dps = acts + L * W * pad;      // current dpre       (max(W, 2) rows)
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    sw[i] = bf16 ? bf16_round(w[i]) : w[i];
    acc_w[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    sb[i] = b[i];
    acc_b[i] = 0.f;
  }

  const int t = threadIdx.x;
  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int first = tile * T;
    const int row = first + t;
    const bool valid = row < n;
    // stage the x tile, transposed, zero past the ragged edge
    for (int i = t; i < T * d_in; i += T) {
      const int r = i / d_in, k = i % d_in;
      xs[k * pad + r] = first + r < n
          ? x[static_cast<size_t>(first) * d_in + i] : 0.f;
    }
    __syncthreads();

    // recompute the forward, keeping a_1..a_L (f32) in shared memory
    float h[W];
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = 0.f;
    for (int k = 0; k < d_in; ++k) {
      const float xk = bf16 ? bf16_round(xs[k * pad + t]) : xs[k * pad + t];
#pragma unroll
      for (int j = 0; j < W; ++j) h[j] = fmaf(xk, sw[k * W + j], h[j]);
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      h[j] = leaky(h[j] + sb[j], leak);
      acts[j * pad + t] = h[j];
    }
    for (int l = 1; l < L; ++l) {
      const float* wl = sw + w_offset(l, d_in, W);
      if (bf16) round_all(h);
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
        acts[(l * W + j) * pad + t] = h[j];
      }
    }

    float dh[W];
    if (head) {
      // dpre = (dloc, draw); dh = dpre W_L^T
      const float d0 = valid ? dy0[row] : 0.f;
      const float d1 = valid ? dy1[row] : 0.f;
      dps[t] = d0;
      dps[pad + t] = d1;
      const float r0 = bf16 ? bf16_round(d0) : d0;
      const float r1 = bf16 ? bf16_round(d1) : d1;
      const float* wh = sw + w_offset(L, d_in, W);
#pragma unroll
      for (int k = 0; k < W; ++k)
        dh[k] = fmaf(r0, wh[2 * k], r1 * wh[2 * k + 1]);
      __syncthreads();
      tile_sums(acts + (L - 1) * W * pad, dps, W, 2, T, bf16,
                acc_w + w_offset(L, d_in, W), acc_b + L * W);
      __syncthreads();
    } else {
      // the cotangent of a_L, zero in the padded columns and rows
      const float* dr = dy0 + static_cast<size_t>(valid ? row : 0) * out_w;
#pragma unroll
      for (int j = 0; j < W; ++j) dh[j] = valid && j < out_w ? dr[j] : 0.f;
    }

    for (int l = L - 1; l >= 0; --l) {
      // slope 1 where the activation is >= 0 (fused_mlp.py:141)
      float dpre[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float a = acts[(l * W + j) * pad + t];
        dpre[j] = a >= 0.f ? dh[j] : leak * dh[j];
        dps[j * pad + t] = dpre[j];
      }
      if (bf16) round_all(dpre);
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
      const float* a_in = l == 0 ? xs : acts + (l - 1) * W * pad;
      tile_sums(a_in, dps, l == 0 ? d_in : W, W, T, bf16,
                acc_w + w_offset(l, d_in, W), acc_b + l * W);
      __syncthreads();
    }
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * (nw + nb);
  for (int i = threadIdx.x; i < nw + nb; i += blockDim.x) out[i] = acc_w[i];
}

size_t fwd_smem(int d_in, int W, int L, bool head) {
  return sizeof(float) * (n_weights(d_in, W, L, head) + n_biases(W, L, head));
}

size_t bwd_smem(int d_in, int W, int L, bool head, int T) {
  const int rows = d_in + L * W + (W > 2 ? W : 2);
  return sizeof(float) * (2 * (n_weights(d_in, W, L, head) +
                               n_biases(W, L, head)) +
                          static_cast<size_t>(rows) * (T + 1));
}

template <int W>
cudaError_t launch_fwd(const float* x, const float* w, const float* b,
                       float* out0, float* out1, int n, int d_in, int L,
                       int out_w, bool head, bool bf16, float leak,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(d_in, W, L, head);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_fwd_kernel<W><<<ct_blocks(n, FWD_THREADS), FWD_THREADS, smem,
                        stream>>>(x, w, b, out0, out1, n, d_in, L, out_w,
                                  head, bf16, leak);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_bwd(const float* x, const float* w, const float* b,
                       const float* dy0, const float* dy1, float* dx,
                       float* part, float* out, int n, int d_in, int L,
                       int out_w, bool head, bool bf16, int tile,
                       int n_blocks, float leak, cudaStream_t stream) {
  const size_t smem = bwd_smem(d_in, W, L, head, tile);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_bwd_kernel<W><<<n_blocks, tile, smem, stream>>>(
      x, w, b, dy0, dy1, dx, part, n, d_in, L, out_w, head, bf16, leak);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = n_weights(d_in, W, L, head) + n_biases(W, L, head);
  return reduce_blocks(part, out, n_blocks, size, size, stream);
}

}  // namespace

// head: out0 = loc, out1 = raw, each (n,); trunk only: out0 is (n, out_w),
// the first out_w of the kernel's `width` columns, and out1 is unused
CT_API int ct_trunk_fwd(const float* x, const float* w, const float* b,
                        float* out0, float* out1, int n, int d_in, int width,
                        int n_layers, int head, int out_w, int bf16,
                        float leak, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_layers < 1 || d_in < 1) return cudaErrorInvalidValue;
  if (!head && (out_w < 1 || out_w > width)) return cudaErrorInvalidValue;
  switch (width) {
#define CT_CASE(W)                                                           \
  case W:                                                                    \
    return launch_fwd<W>(x, w, b, out0, out1, n, d_in, n_layers, out_w,     \
                         head != 0, bf16 != 0, leak, ct_stream(stream));
    CT_TRUNK_WIDTHS(CT_CASE)
#undef CT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// dy0, dy1 as ct_trunk_fwd's outputs; tile: the backward's tile height (its
// block size); part: (n_blocks, nw + nb) scratch; out: (nw + nb) =
// [dW flat, db flat]
CT_API int ct_trunk_bwd(const float* x, const float* w, const float* b,
                        const float* dy0, const float* dy1, float* dx,
                        float* part, float* out, int n, int d_in, int width,
                        int n_layers, int head, int out_w, int bf16, int tile,
                        int n_blocks, float leak, void* stream) {
  if (n_layers < 1 || d_in < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  if (tile < 1 || tile > MAX_BWD_T) return cudaErrorInvalidValue;
  if (!head && (out_w < 1 || out_w > width)) return cudaErrorInvalidValue;
  switch (width) {
#define CT_CASE(W)                                                           \
  case W:                                                                    \
    return launch_bwd<W>(x, w, b, dy0, dy1, dx, part, out, n, d_in,         \
                         n_layers, out_w, head != 0, bf16 != 0, tile,       \
                         n_blocks, leak, ct_stream(stream));
    CT_TRUNK_WIDTHS(CT_CASE)
#undef CT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// tile 0: the forward's shared memory; else the backward's at that height
CT_API size_t ct_trunk_smem(int d_in, int width, int n_layers, int head,
                            int tile) {
  return tile ? bwd_smem(d_in, width, n_layers, head != 0, tile)
              : fwd_smem(d_in, width, n_layers, head != 0);
}
