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
// The forward's design. The TPU kernel lane-packed 12 observations into
// one 128-wide MXU row and kept every layer's block-diagonal weight in
// VMEM. Here the weights and biases sit in shared memory and every FMA
// takes a weight that all lanes of a warp read alike (a broadcast). With
// one row a thread each broadcast fed one FMA, and the SM's shared-memory
// path, one broadcast a clock, bounded the forward at ~2.6x its operations
// bound. So a thread owns R rows (fwd_rows: 4 up to width 10, as many as
// 2 R W floats of activations and sums fit in registers), each broadcast
// feeds R FMAs, and the hidden layers are read 16 bytes at a time; what
// bounds it then is instruction issue: per output and layer, W FMAs beside
// the bias add and the leaky ReLU's compare and multiply. Each block of
// FWD_WARPS warps stages the weights once and its warps walk tiles of 32 R
// rows of their own over a grid of what is resident (no barrier after the
// staging). W is a template parameter, so a layer is a fully unrolled
// product. Each output still sums in K1-fwd's order, the order every
// backward recomputes (trunk_common.cuh), so the outputs do not depend on
// R and equal csrc/trunk_wide.cu's bit for bit. With bf16 the
// weights are rounded once as they are staged. Widths the library is not
// instantiated for are padded by the Python wrapper to the next
// instantiated width with zero weights, which is exact; the trunk-only
// forward writes, and its backward reads, only the model's `out_w` columns
// of each row. The backward below keeps one thread a row.
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

constexpr int MAX_BWD_T = 64;       // the tallest backward tile
// the forward: the warps of a block, and the warps a SM its launch bounds
// keep registers for
constexpr int FWD_WARPS = 8;
constexpr int FWD_WARPS_PER_SM = 16;

// rows a thread of the forward at width W: each weight a warp loads feeds R
// FMAs; the R rows' activations and sums (2 R W floats) stay in registers
// under the launch bounds' 128 a thread (2 R W = 80 at most: at 96, widths
// 12 and 24, ptxas spills)
__host__ __device__ constexpr int fwd_rows(int W) {
  return W <= 10 ? 4 : W <= 20 ? 2 : 1;
}

// the nearest bf16 value (ties to even), as an f32
__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int W>
__device__ inline void round_all(float (&v)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = bf16_round(v[j]);
}

// The forward. A block of FWD_WARPS warps stages every weight and bias
// once (rounded to bf16 where asked), the hidden layers' weights first:
// W_1 .. W_{L-1} (W x W each, a multiple of 4 floats for even W, so each
// starts on 16 bytes and is read by 16-byte broadcasts), then W_0 (d_in x
// W), the head's (W x 2) and the biases, with no padding (the shared sum is
// the flat parameters'). Each warp then walks tiles of ROWS = 32 R rows of
// its own, one a round of gridDim.x * FWD_WARPS tiles, with no barrier
// past the staging. Lane t owns the rows t, t + 32, ..., t + 32 (R - 1) of
// a tile, their activations in registers, so every weight the warp loads,
// a broadcast, feeds R FMAs; it reads its rows' x itself (a row's d_in
// floats stay in L1 for its next columns). Each output sums in K1-fwd's
// order (see trunk_common.cuh): the products in order of k from 0, then
// the bias.
template <int W>
__global__ void __launch_bounds__(32 * FWD_WARPS,
                                  FWD_WARPS_PER_SM / FWD_WARPS)
trunk_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ out0,
                 float* __restrict__ out1, int n, int d_in, int L, int out_w,
                 bool head, bool bf16, float leak) {
  constexpr int R = fwd_rows(W);
  constexpr int ROWS = 32 * R;
  constexpr int WW = W * W;
  extern __shared__ float4 fwd_shared[];
  float* smem = reinterpret_cast<float*>(fwd_shared);
  const int first_w = d_in * W;                 // flat: W_1's first weight
  const int hidden = (L - 1) * WW;              // the hidden layers' floats
  const int nw = n_weights(d_in, W, L, head);
  const int nb = n_biases(W, L, head);
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int at = i < first_w ? hidden + i
                               : i < first_w + hidden ? i - first_w : i;
    smem[at] = bf16 ? bf16_round(w[i]) : w[i];
  }
  for (int i = threadIdx.x; i < nb; i += blockDim.x) smem[nw + i] = b[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_tiles = n / ROWS + (n % ROWS != 0);
  for (int tile = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
       tile < n_tiles; tile += gridDim.x * FWD_WARPS) {
    const long long first = static_cast<long long>(tile) * ROWS;
    const int rows = static_cast<int>(min(static_cast<long long>(ROWS),
                                          n - first));
    // this lane's rows of x (past the last row, the last row again: its
    // outputs are not stored)
    const float* xr[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xr[r] = x + (first + min(lane + 32 * r, rows - 1)) * d_in;
    float h[R][W];
    {
      // layer 0, its weights at `hidden`
      float acc[R][W];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[r][j] = 0.f;
      // four columns a step, so that a lane has four loads in flight
#pragma unroll 4
      for (int k = 0; k < d_in; ++k) {
        float in[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          in[r] = bf16 ? bf16_round(xr[r][k]) : xr[r][k];
        const int wk = hidden + k * W;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float wv = smem[wk + j];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][j] = fmaf(in[r], wv, acc[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) bias_leaky<W>(h[r], acc[r], smem + nw, leak);
    }
    for (int l = 1; l < L; ++l) {
      if (bf16) {
#pragma unroll
        for (int r = 0; r < R; ++r) round_all(h[r]);
      }
      // W_l at (l - 1) W^2 as 16-byte broadcasts where W is even, in flat
      // order: for each j the products still come in order of k
      const int at = (l - 1) * WW;
      float acc[R][W];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[r][j] = 0.f;
      if constexpr (WW % 4 == 0) {
#pragma unroll
        for (int c = 0; c < WW / 4; ++c) {
          const float4 p = fwd_shared[at / 4 + c];
          const float v[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = (4 * c + e) / W, j = (4 * c + e) % W;
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r][j] = fmaf(h[r][k], v[e], acc[r][j]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k)
#pragma unroll
          for (int j = 0; j < W; ++j) {
            const float wv = smem[at + k * W + j];
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r][j] = fmaf(h[r][k], wv, acc[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        bias_leaky<W>(h[r], acc[r], smem + nw + l * W, leak);
    }

    if (head) {
      const int wh = hidden + first_w;   // (wh[2k], wh[2k + 1]) for k < W
      float y0[R], y1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (bf16) round_all(h[r]);
        y0[r] = 0.f;
        y1[r] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float w0 = smem[wh + 2 * k], w1 = smem[wh + 2 * k + 1];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          y0[r] = fmaf(h[r][k], w0, y0[r]);
          y1[r] = fmaf(h[r][k], w1, y1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane + 32 * r < rows) {
          out0[first + lane + 32 * r] = y0[r] + smem[nw + L * W];
          out1[first + lane + 32 * r] = y1[r] + smem[nw + L * W + 1];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane + 32 * r < rows) {
          float* o = out0 + (first + lane + 32 * r) * out_w;
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (j < out_w) o[j] = h[r][j];
        }
      }
    }
  }
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
                       int out_w, bool head, bool bf16, int n_blocks,
                       float leak, cudaStream_t stream) {
  const size_t smem = fwd_smem(d_in, W, L, head);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_fwd_kernel<W><<<n_blocks, 32 * FWD_WARPS, smem, stream>>>(
      x, w, b, out0, out1, n, d_in, L, out_w, head, bf16, leak);
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
// the first out_w of the kernel's `width` columns, and out1 is unused;
// n_blocks: the grid (the caller's choice: kernels.trunk_fwd_blocks)
CT_API int ct_trunk_fwd(const float* x, const float* w, const float* b,
                        float* out0, float* out1, int n, int d_in, int width,
                        int n_layers, int head, int out_w, int bf16,
                        int n_blocks, float leak, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (n_layers < 1 || d_in < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  if (!head && (out_w < 1 || out_w > width)) return cudaErrorInvalidValue;
  switch (width) {
#define CT_CASE(W)                                                           \
  case W:                                                                    \
    return launch_fwd<W>(x, w, b, out0, out1, n, d_in, n_layers, out_w,     \
                         head != 0, bf16 != 0, n_blocks, leak,              \
                         ct_stream(stream));
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

// the forward's rows a thread at a kernel width
CT_API int ct_trunk_fwd_rows(int width) { return fwd_rows(width); }

// the forward's warps a block and the warps a SM its launch bounds keep
// registers for
CT_API void ct_trunk_fwd_limits(int* warps, int* warps_per_sm) {
  *warps = FWD_WARPS;
  *warps_per_sm = FWD_WARPS_PER_SM;
}
