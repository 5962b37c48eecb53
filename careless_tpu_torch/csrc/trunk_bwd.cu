// K1-bwd in f32: the scaling-MLP trunk's backward, with or without its
// linear head, laid out for the H100's shared memory. (The bf16 backward is
// csrc/trunk_bwd_bf16.cu; both forwards, and the backward for shapes that
// fit neither, are in csrc/trunk.cu.)
//
// Replaces careless_tpu/ops/fused_mlp.py:_bwd_kernel (the pallas_call of
// _trunk_bwd) in its two f32 instantiations, head or trunk only. For every
// observation with metadata x (d_in floats) it recomputes the forward
//     h_0 = x;  h_{l+1} = leaky(h_l W_l + b_l)  for l < L
// and, from the cotangent of (loc, raw) = h_L W_L + b_L (head) or of h_L
// (trunk only), runs the chain back:
//     dpre_l = dh_{l+1} * (h_{l+1} >= 0 ? 1 : leak);   dh_l = dpre_l W_l^T
//     dW_l = sum over observations of h_l^T dpre_l;    db_l = sum dpre_l
// (dx = dh_0 only when asked). Every product is an f32 FMA: no TF32, no
// tensor cores, so it holds the f32 tolerances against the JAX package.
//
// What bounds it on the H100: operations, ~11.9 GFLOP at the main path
// (N = 1M, d_in = W = 10, L = 20, head: the recomputed forward, dh and
// dW), 0.178 ms at 67 TFLOP/s, against ~0.02 ms of memory traffic. What
// holds both this kernel and csrc/trunk.cu's backward far above that is
// shared memory: the bytes it delivers to registers (128 a clock per SM,
// broadcast or not), and latency, with four warps resident per SM (the
// stash of activations takes ~1 KB per row). PERF.md has the times
// (tools/trunk_bwd_probe.py times it beside csrc/trunk.cu's backward).
//
// Design, one thread per observation, each warp a tile of 32 of them (a
// block is T / 32 warps, each walking its own tiles; they share only the
// weights, so no barrier of the tile loop spans more than a warp, and a
// warp in its tile sums runs beside one in its chain):
// - The weights and biases sit in shared memory in their flat layout and
//   are read as scalar broadcasts: a 16-byte load delivers 512 bytes to a
//   warp's registers, broadcast or not, so it costs the data path as much
//   as four scalar ones, and rows padded to 16 bytes waste the rest.
// - The forward is recomputed in K1-fwd's order (the products in order of
//   k, then the bias), so every activation, and with it every slope of
//   the leaky ReLU, is bit for bit the one the loss saw: a pre-activation
//   within an ulp of zero takes the other slope under another order, and
//   its row's gradient then moves by a factor of 1 / leak.
// - The stash keeps, per tile, x and a_1..a_L row-major ([row][feature]),
//   each row at a stride of an odd number of quads (16 bytes), so that the
//   16-byte accesses of eight consecutive rows fall on 32 distinct banks.
//   In the backward dpre_l overwrites a_{l+1}, which nothing reads after
//   its mask; the head's cotangent (dloc, draw) has a slot of one quad.
// - The tile sums are register-blocked: a thread owns one 4x4 block of
//   (k, j) (an item) and a group of the tile's rows (g, g + G, ...); per row
//   it loads a[r][k0..k0+3] and dpre[r][j0..j0+3] (two 16-byte loads, 512
//   useful bytes a warp) for 16 FMAs, and sums dpre[r][j0..j0+3] for db
//   (kept by the items with k0 = 0). Where the width fixes the number of
//   items, the row loop has a fixed count and unrolls. The groups' partials
//   are added by warp shuffles, in group order, and group 0's lanes add
//   them to the warp's partial, which is kept in the items' layout (16
//   floats an item, the biases a quad per j-block).
// - A fixed grid: warp w of block b walks the tiles b V + w, then G V on
//   (G blocks of V warps); at the end the block adds its warps' partials
//   in warp order and writes the sum, in the flat layout, to a (G, nw + nb)
//   scratch, which a second launch sums in block order, as csrc/trunk.cu's
//   backward does. No atomics, so dW and db repeat bit for bit from run to
//   run (they differ from csrc/trunk.cu's by summation order).
// The block's rows T (32 a warp) are chosen by the wrapper (the most whose
// shared memory fits; kernels.trunk_bwd_f32_smem is a copy of
// bwd_f32_smem below); a shape that fits not even one warp runs
// csrc/trunk.cu's backward.
#include "trunk_common.cuh"

namespace {

constexpr int MAX_T = 128;   // the most rows (threads) of a block
constexpr int TILE = 32;     // rows of a tile: one warp's
constexpr int MAX_GROUPS = 8;   // row groups of a layer's tile sums

__host__ __device__ constexpr int quads(int n) { return (n + 3) / 4; }

// a stash row's stride in floats: whole quads, an odd number of them
__host__ __device__ constexpr int stash_stride(int n) {
  return 4 * (quads(n) | 1);
}

// the first item of layer l (l = L: the head) in the block's partial
__host__ __device__ inline int item_offset(int l, int d_in, int W) {
  return l == 0 ? 0
                : quads(d_in) * quads(W) + (l - 1) * quads(W) * quads(W);
}

// A block's shared memory, in floats, region by region (each a whole
// number of quads, so every region is 16-byte aligned): the parameters,
// then for each warp its partial and its stash.
struct Layout {
  int params;   // the weights and biases, flat
  int acc_w;    // a warp's dW partial: 16 floats an item
  int acc_b;    // its db partial: a quad per j-block and layer
  int xs, ws;   // stash strides of x and of the activations
  int stash;    // a tile's x, a_1..a_L (then dpre), the head's cotangent
  int warp;     // all of one warp's
  __host__ __device__ Layout(int d_in, int W, int L, bool head)
      : params(4 * quads(n_weights(d_in, W, L, head) +
                         n_biases(W, L, head))),
        acc_w(16 * (item_offset(L, d_in, W) + (head ? quads(W) : 0))),
        acc_b(4 * (L * quads(W) + (head ? 1 : 0))),
        xs(stash_stride(d_in)),
        ws(stash_stride(W)),
        stash(TILE * (xs + L * ws + (head ? 4 : 0))),
        warp(acc_w + acc_b + stash) {}
  __host__ __device__ int total(int T) const {
    return params + T / TILE * warp;
  }
};

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void add4(float4* dst, const float4& v) {
  const float4 d = *dst;
  *dst = make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
}

// acc[j] += s * w[j] for j < W (a row of weights, scalar broadcasts)
template <int W>
__device__ __forceinline__ void axpy_row(float (&acc)[W], float s,
                                         const float* w) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = fmaf(s, w[j], acc[j]);
}

// sum over j < W of v[j] * w[j], in order of j
template <int W>
__device__ __forceinline__ float dot_row(const float (&v)[W],
                                         const float* w) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) s = fmaf(v[j], w[j], s);
  return s;
}

// this thread's stash row: the W values of v, zero in the padding lanes
template <int W>
__device__ __forceinline__ void store_row(float4* dst, const float (&v)[W]) {
#pragma unroll
  for (int q = 0; q < quads(W); ++q) {
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = 4 * q + c < W ? v[4 * q + c] : 0.f;
    dst[q] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// One row of an item's sums: s[4 kk + jj] += a[r][k0 + kk] dp[r][j0 +
// jj] and sb[jj] += dp[r][j0 + jj], from two 16-byte loads.
__device__ __forceinline__ void row_sums(const float* ar, const float* dr,
                                         float (&s)[16], float (&sb)[4]) {
  const float4 av = *reinterpret_cast<const float4*>(ar);
  const float4 dv = *reinterpret_cast<const float4*>(dr);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      s[4 * kk + jj] = fmaf(lane(av, kk), lane(dv, jj), s[4 * kk + jj]);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) sb[jj] += lane(dv, jj);
}

// Adds an item's sums (s: its 4x4 dW block, sb: the db of its 4 columns,
// kept only by the items of k-block 0) to the warp's partial.
__device__ __forceinline__ void add_item(const float (&s)[16],
                                         const float (&sb)[4], int i, int kb,
                                         int jb, float4* acc_w,
                                         float4* acc_b) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    add4(acc_w + 4 * i + e, make_float4(s[4 * e], s[4 * e + 1],
                                        s[4 * e + 2], s[4 * e + 3]));
  if (kb == 0) add4(acc_b + jb, make_float4(sb[0], sb[1], sb[2], sb[3]));
}

// A warp's tile sums for one layer: over the tile's rows r, a[r][k]
// dp[r][j] into the layer's items of the warp's partial (acc_w, 4 quads an
// item, items in (k-block, j-block) order) and dp[r][j] into its db quads
// (acc_b). a and dp are stash slots with row strides as and ds (whole
// quads); the layer has kbs k-blocks and jbs j-blocks, known at compile
// time (KBS, JBS) where they follow from the width, so that the row loop
// unrolls with all its loads in flight, else read at run time (KBS = 0).
// With fewer items than lanes, lane g * items + i sums item i over the
// rows g, g + G, ... (G groups, at most MAX_GROUPS), and the groups'
// partials are added by shuffles, in group order, into the lanes of group
// 0; with more, a lane takes its items in turn over all rows. Ends with
// the warp synchronised after its last read of a and dp.
template <int KBS, int JBS>
__device__ __forceinline__ void tile_sums(const float* a, int as,
                                          const float* dp, int ds, int kbs,
                                          int jbs, int lane_id,
                                          float4* acc_w, float4* acc_b) {
  constexpr bool FIXED = KBS > 0;
  if (FIXED) kbs = KBS, jbs = JBS;
  const int items = kbs * jbs;
  if (items >= TILE / 2) {
    for (int i = lane_id; i < items; i += TILE) {
      const int kb = i / jbs, jb = i - kb * jbs;
      float s[16] = {}, sb[4] = {};
#pragma unroll 4
      for (int r = 0; r < TILE; ++r)
        row_sums(a + 4 * kb + r * as, dp + 4 * jb + r * ds, s, sb);
      add_item(s, sb, i, kb, jb, acc_w, acc_b);
    }
    __syncwarp();
    return;
  }
  constexpr int GF_ = TILE / (FIXED ? KBS * JBS : TILE);
  constexpr int GF = GF_ < MAX_GROUPS ? GF_ : MAX_GROUPS;
  const int G = FIXED ? GF : min(MAX_GROUPS, TILE / items);
  const int g = lane_id / items, i = lane_id - g * items;
  const int kb = i / jbs, jb = i - kb * jbs;
  float s[16] = {}, sb[4] = {};
  if (g < G) {
    const float* ar = a + 4 * kb;
    const float* dr = dp + 4 * jb;
    if constexpr (FIXED) {
#pragma unroll
      for (int m = 0; m < (TILE + GF - 1) / GF; ++m) {
        const int r = g + GF * m;
        if (r < TILE) row_sums(ar + r * as, dr + r * ds, s, sb);
      }
    } else {
#pragma unroll 4
      for (int r = g; r < TILE; r += G)
        row_sums(ar + r * as, dr + r * ds, s, sb);
    }
  }
  __syncwarp();
  // group h's partial, h = 1 .. G - 1 in order, onto group 0's lanes
  float t[16], tb[4];
#pragma unroll
  for (int e = 0; e < 16; ++e) t[e] = s[e];
#pragma unroll
  for (int e = 0; e < 4; ++e) tb[e] = sb[e];
  for (int h = 1; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      t[e] += __shfl_down_sync(0xffffffffu, s[e], h * items);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tb[e] += __shfl_down_sync(0xffffffffu, sb[e], h * items);
  }
  if (g == 0) add_item(t, tb, i, kb, jb, acc_w, acc_b);
}

// dy0/dy1: the head's (dloc, draw), each (n,); trunk only: dy0 is the
// (n, out_w) cotangent of the last layer's activations and dy1 is unused.
template <int W>
__global__ void __launch_bounds__(MAX_T, 1)
trunk_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b,
                     const float* __restrict__ dy0,
                     const float* __restrict__ dy1, float* __restrict__ dx,
                     float* __restrict__ part, int n, int d_in, int L,
                     int out_w, bool head, float leak) {
  extern __shared__ float4 smem4[];
  constexpr int Q = quads(W);
  constexpr int T = TILE;
  const int t = threadIdx.x % TILE, warp = threadIdx.x / TILE;
  const int warps = blockDim.x / TILE;
  const Layout lay(d_in, W, L, head);
  const int nw = n_weights(d_in, W, L, head);
  const int nb = n_biases(W, L, head);
  float* sw = reinterpret_cast<float*>(smem4);  // weights, then biases
  const float* sb = sw + nw;
  float4* acc_w = smem4 + (lay.params + warp * lay.warp) / 4;  // dW partial
  float4* acc_b = acc_w + lay.acc_w / 4;        // db partial, by quads
  float* xt = reinterpret_cast<float*>(acc_b + lay.acc_b / 4);  // stash: x
  float* acts = xt + T * lay.xs;                // a_l at acts + (l-1) T ws
  float* hd = acts + L * T * lay.ws;            // (dloc, draw, 0, 0) rows
  const int xs = lay.xs, ws = lay.ws;

  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sw[nw + i] = b[i];
  for (int i = t; i < (lay.acc_w + lay.acc_b) / 4; i += T)
    acc_w[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x * warps + warp; tile < n_tiles;
       tile += gridDim.x * warps) {
    const int row = tile * T + t;
    const bool valid = row < n;
    // this row of x into the stash, zero past the ragged edge
    float4* xr = reinterpret_cast<float4*>(xt + t * xs);
    const float* xg = x + static_cast<size_t>(valid ? row : 0) * d_in;
    for (int q = 0; q < xs / 4; ++q) {
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[c] = valid && 4 * q + c < d_in ? xg[4 * q + c] : 0.f;
      xr[q] = make_float4(e[0], e[1], e[2], e[3]);
    }

    // recompute the forward in K1-fwd's order, keeping a_1..a_L in the
    // stash
    float h[W];
    {
      float pre[W];
#pragma unroll
      for (int j = 0; j < W; ++j) pre[j] = 0.f;
      for (int q = 0; q < quads(d_in); ++q) {
        const float4 v = xr[q];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * q + c < d_in)
            axpy_row<W>(pre, lane(v, c), sw + (4 * q + c) * W);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) h[j] = leaky(pre[j] + sb[j], leak);
      store_row<W>(reinterpret_cast<float4*>(acts + t * ws), h);
    }
    for (int l = 1; l < L; ++l) {
      const float* wl = sw + w_offset(l, d_in, W);
      float pre[W];
#pragma unroll
      for (int j = 0; j < W; ++j) pre[j] = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) axpy_row<W>(pre, h[k], wl + k * W);
#pragma unroll
      for (int j = 0; j < W; ++j) h[j] = leaky(pre[j] + sb[l * W + j], leak);
      store_row<W>(reinterpret_cast<float4*>(acts + (l * T + t) * ws), h);
    }

    float dh[W];
    if (head) {
      // dpre = (dloc, draw); dh = dpre W_L^T
      const float d0 = valid ? dy0[row] : 0.f;
      const float d1 = valid ? dy1[row] : 0.f;
      reinterpret_cast<float4*>(hd)[t] = make_float4(d0, d1, 0.f, 0.f);
      const float* wh = sw + w_offset(L, d_in, W);
#pragma unroll
      for (int k = 0; k < W; ++k)
        dh[k] = fmaf(d0, wh[2 * k], d1 * wh[2 * k + 1]);
      __syncwarp();
      tile_sums<Q, 1>(acts + (L - 1) * T * ws, ws, hd, 4, Q, 1, t,
                      acc_w + 4 * item_offset(L, d_in, W), acc_b + L * Q);
    } else {
      // the cotangent of a_L, zero in the padded columns and rows
      const float* dr = dy0 + static_cast<size_t>(valid ? row : 0) * out_w;
#pragma unroll
      for (int j = 0; j < W; ++j) dh[j] = valid && j < out_w ? dr[j] : 0.f;
    }

    for (int l = L - 1; l >= 0; --l) {
      // slope 1 where the activation is >= 0 (fused_mlp.py:141); dpre_l
      // takes the place of a_{l+1} in the stash
      float4* slot = reinterpret_cast<float4*>(acts + (l * T + t) * ws);
      float dpre[W];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 a = slot[q];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * q + c;
          if (j < W) dpre[j] = lane(a, c) >= 0.f ? dh[j] : leak * dh[j];
        }
      }
      store_row<W>(slot, dpre);
      const float* wl = sw + w_offset(l, d_in, W);
      if (l > 0) {
#pragma unroll
        for (int k = 0; k < W; ++k) dh[k] = dot_row<W>(dpre, wl + k * W);
      } else if (dx != nullptr && valid) {
        float* dxr = dx + static_cast<size_t>(row) * d_in;
        for (int k = 0; k < d_in; ++k)
          dxr[k] = dot_row<W>(dpre, wl + k * W);
      }
      __syncwarp();
      float4* aw = acc_w + 4 * item_offset(l, d_in, W);
      if (l > 0)
        tile_sums<Q, Q>(acts + (l - 1) * T * ws, ws, acts + l * T * ws, ws,
                        Q, Q, t, aw, acc_b + l * Q);
      else if (quads(d_in) == Q)
        tile_sums<Q, Q>(xt, xs, acts, ws, Q, Q, t, aw, acc_b);
      else
        tile_sums<0, 0>(xt, xs, acts, ws, quads(d_in), Q, t, aw, acc_b);
    }
  }
  __syncthreads();
  // the block's partial, its warps' in warp order, in the flat layout of
  // `part`: dW of every layer (d_in_l, d_out) row-major, the head's (W, 2),
  // then db
  const float* aw = reinterpret_cast<const float*>(smem4) + lay.params;
  const float* ab = aw + lay.acc_w;
  float* out = part + static_cast<size_t>(blockIdx.x) * (nw + nb);
  for (int i = threadIdx.x; i < nw + nb; i += blockDim.x) {
    int l, r, d_out, at;
    if (i >= nw) {                     // db; the head's at l = L
      const int c = i - nw;
      l = min(c / W, L);
      at = lay.acc_w + 4 * l * Q + (c - l * W);
    } else {
      if (i < d_in * W) {
        l = 0, r = i, d_out = W;
      } else if (i < w_offset(L, d_in, W)) {
        const int c = i - d_in * W;
        l = 1 + c / (W * W), r = c - (l - 1) * W * W, d_out = W;
      } else {
        l = L, r = i - w_offset(L, d_in, W), d_out = 2;
      }
      const int k = r / d_out, j = r - k * d_out;
      const int item =
          item_offset(l, d_in, W) + (k / 4) * quads(d_out) + j / 4;
      at = 16 * item + 4 * (k % 4) + j % 4;
    }
    float v = 0.f;
    for (int wp = 0; wp < warps; ++wp) v += aw[wp * lay.warp + at];
    out[i] = v;
  }
}

size_t bwd_f32_smem(int d_in, int W, int L, bool head, int T) {
  return sizeof(float) * static_cast<size_t>(
                             Layout(d_in, W, L, head).total(T));
}

template <int W>
cudaError_t launch(const float* x, const float* w, const float* b,
                   const float* dy0, const float* dy1, float* dx, float* part,
                   float* out, int n, int d_in, int L, int out_w, bool head,
                   int tile, int n_blocks, float leak, cudaStream_t stream) {
  const size_t smem = bwd_f32_smem(d_in, W, L, head, tile);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_f32_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_bwd_f32_kernel<W><<<n_blocks, tile, smem, stream>>>(
      x, w, b, dy0, dy1, dx, part, n, d_in, L, out_w, head, leak);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = n_weights(d_in, W, L, head) + n_biases(W, L, head);
  return reduce_blocks(part, out, n_blocks, size, size, stream);
}

}  // namespace

// As csrc/trunk.cu's ct_trunk_bwd with bf16 = 0: dy0, dy1 the cotangents;
// tile: the block's rows (its size, whole warps up to MAX_T); part: (n_blocks,
// nw + nb) scratch; out: (nw + nb) = [dW flat, db flat]; dx may be null.
CT_API int ct_trunk_bwd_f32(const float* x, const float* w, const float* b,
                            const float* dy0, const float* dy1, float* dx,
                            float* part, float* out, int n, int d_in,
                            int width, int n_layers, int head, int out_w,
                            int tile, int n_blocks, float leak,
                            void* stream) {
  if (n_layers < 1 || d_in < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  if (tile < TILE || tile > MAX_T || tile % TILE) return cudaErrorInvalidValue;
  if (!head && (out_w < 1 || out_w > width)) return cudaErrorInvalidValue;
  switch (width) {
#define CT_CASE(W)                                                           \
  case W:                                                                    \
    return launch<W>(x, w, b, dy0, dy1, dx, part, out, n, d_in, n_layers,   \
                     out_w, head != 0, tile, n_blocks, leak,                 \
                     ct_stream(stream));
    CT_TRUNK_WIDTHS(CT_CASE)
#undef CT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// the kernel's shared memory for a block of `tile` rows, in bytes
CT_API size_t ct_trunk_bwd_f32_smem(int d_in, int width, int n_layers,
                                    int head, int tile) {
  return bwd_f32_smem(d_in, width, n_layers, head != 0, tile);
}
