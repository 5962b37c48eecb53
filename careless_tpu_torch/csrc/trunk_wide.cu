// K1 for wide or deep trunks: the scaling-MLP trunk, with or without its
// linear head, in f32 or with bf16 operands, forward and backward, at kernel
// widths up to 128 and at any depth.
//
// Replaces careless_tpu/ops/fused_mlp.py:_fwd_kernel and :_bwd_kernel (the
// pallas_calls of _trunk_fwd and _trunk_bwd) in all four of their
// instantiations (head or not, bf16 or not) for the shapes csrc/trunk.cu,
// csrc/trunk_bwd.cu and csrc/trunk_bwd_bf16.cu do not take: max(d_in, width)
// from 33 to 128 (the JAX kernel's 128 lanes are its whole domain), and
// narrower trunks whose weights do not fit in a block's shared memory
// (kernels.trunk_route decides). It computes what csrc/trunk.cu computes:
//     h_0 = x[n];  h_{l+1} = leaky(h_l W_l + b_l)  for l < L
//     (loc[n], raw[n]) = h_L W_L + b_L              (head: width -> 2)
//     out[n, :] = h_L                               (trunk only)
// and in the backward dW, db (and dx when asked) from the cotangent, with
// the same bf16 contract (both operands of every product rounded to bf16,
// f32 sums; the backward rounds its operands, not its results; db and the
// leaky ReLU's mask in f32).
//
// What bounds it on the H100: operations. At the `--mlp-width 128` slice
// (N = 1M, d_in = 10, width 128, L = 20, head) the forward does
// 2 N (10*128 + 19*128^2 + 2*128) = 0.63 TFLOP, 9.3 ms at 67 TFLOP/s f32;
// the backward (recompute, dh, dW) ~1.9 TFLOP, 28 ms. In bf16 the least
// time is on tensor cores (0.63 and 1.9 ms at 989 TFLOP/s), which this
// kernel does not use: every product is an f32 FMA on the SIMT units, so a
// bf16 trunk takes as long as an f32 one here.
//
// Sum order, the one hard rule: every output (r, j) of a layer is the chain
// acc = 0; acc = fmaf(h[r][k], W[k][j], acc) for k = 0, 1, ... in order,
// then leaky(acc + b[j]), as trunk_common.cuh's axpy_k and dense_layer; no
// output's chain is split across threads. So this forward, the backward's
// recompute here, and csrc/trunk.cu's forward give the same activations bit
// for bit, and a backward may run in another kernel than its forward (a
// pre-activation within an ulp of zero that took the other slope would move
// its row's gradient by 1 / leak). Zero padding adds fmaf(0, w, acc) terms
// at the end of a chain, which leave acc unchanged (a chain from +0 never
// holds -0). dh sums in csrc/trunk.cu's order too: ascending j from 0, on
// bf16-rounded dpre and weights.
//
// Design: a block owns a tile of ROWS rows and keeps the tile's current
// activations in shared memory, ROWS x kw f32 (kw: the width rounded up to
// 16; rows at a stride of kw + 4 floats so that the 16-byte loads of
// neighbouring rows fall on other banks). The weights stream one layer at a
// time from device memory (L2: 1.3 MB at width 128 and 20 layers) into
// shared memory, kw x kw (64 KB at 128), where no design that holds every
// layer fits. Every copy into shared memory (weights, x tiles, stash rows)
// is a cp.async, so all of a thread's copies are in flight at once (a load
// and a store through generic pointers would wait for each other); the
// forward copies the next layer while the current one computes (two weight
// slots). A block has 4 kw threads; thread (g, c) owns rows g, g + 16,
// g + 32, g + 48 and columns 4c .. 4c + 3 of a layer's outputs and per step
// of k loads four 16-byte rows of activations and four of weights for 64
// FMAs. No tensor cores, no TMA: this is the simple kernel that is right;
// making it fast is later work.
//
// The backward: a fixed grid of as many blocks as fit on the card at once
// (kernels._wide_blocks_per_card). Block g walks the tiles g, g + G, ...; per
// tile it recomputes the forward layer by layer as the forward kernel does,
// writing a_1 .. a_{L-1} to a per-block stash in device memory (ROWS rows
// of kw floats a layer), then runs the chain back one layer at a time:
// dpre_l = mask(a_{l+1}) dh, dh = dpre_l W_l^T (dx at l = 0 when asked),
// and the tile's sums over its rows in order, sum_r a_l[r][k] dpre_l[r][j]
// and sum_r dpre_l[r][j], added to the block's partial in device memory (the
// (G, nw + nb) scratch of the flat layout). A second launch sums the
// partials in block order (trunk_common.cuh's reduce_blocks). No atomics:
// dW and db repeat bit for bit from run to run.
//
// Shared memory (wide_smem below; kernels.trunk_wide_smem is a copy that a
// card test holds equal): buffers of ROWS x stride floats (2 in the
// forward, 3 in the backward) and weight slots of one layer (max(d4, kw) x
// kw) and its bias (kw) each (2 in the forward, 1 in the backward), with
// d4 = d_in rounded up to 4 and stride = max(d4, kw) + 4. At d_in <= 128
// and width 128: 199,680 bytes forward, 167,424 backward, one block of 512
// threads a SM.
#include <cuda_bf16.h>

#include "trunk_common.cuh"

namespace {

constexpr int ROWS = 64;              // rows of a tile: a block's
constexpr int GROUPS = 16;            // row groups of a block's threads
constexpr int TR = ROWS / GROUPS;     // rows a thread owns in a tile
constexpr int MAX_WIDTH = 128;        // the JAX kernel's 128 lanes

// the nearest bf16 value (ties to even), as an f32
__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ inline float4 round4(float4 v, bool bf16) {
  if (bf16) {
    v.x = bf16_round(v.x);
    v.y = bf16_round(v.y);
    v.z = bf16_round(v.z);
    v.w = bf16_round(v.w);
  }
  return v;
}

__device__ inline float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The shapes of one launch: `width` is the packed width of the flat layout
// (the model's width padded as kernels.trunk_width says), kw the width this
// kernel computes at.
struct Wide {
  int kw;       // width rounded up to 16
  int d4;       // d_in rounded up to 4
  int cols;     // max(d4, kw): the widest row a buffer or layer holds
  int stride;   // an activation row's stride in shared memory
  __host__ __device__ Wide(int d_in, int width)
      : kw((width + 15) / 16 * 16),
        d4((d_in + 3) / 4 * 4),
        cols(d4 > kw ? d4 : kw),
        stride(cols + 4) {}
  // a weight slot: one layer's weights and its biases
  __host__ __device__ int slot() const { return cols * kw + kw; }
  __host__ __device__ size_t floats(bool bwd) const {
    return static_cast<size_t>(bwd ? 3 : 2) * ROWS * stride +
           static_cast<size_t>(bwd ? 1 : 2) * slot();
  }
};

size_t wide_smem(int d_in, int width, bool bwd) {
  return sizeof(float) * Wide(d_in, width).floats(bwd);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one float from device memory to shared memory, asynchronously; zero
// (src not read) where !valid
__device__ inline void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes, both ends 16-byte aligned; zero (src not read) where !valid
__device__ inline void copy16(float* dst, const float* src,
                              bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this thread's copies but the newest N groups
template <int N>
__device__ inline void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where layer l (l = L: the head) lives in the flat layout, and the shape
// a slot holds it in: rows x src_cols in device memory, rows_pad x dst_cols
// in the slot (zero past rows and src_cols), then dst_cols biases.
struct LayerAt {
  const float* w;
  const float* b;
  int rows, rows_pad, src_cols, dst_cols;
  __device__ LayerAt(int l, const float* w0, const float* b0, int d_in,
                     int width, int L, const Wide& s)
      : w(w0 + w_offset(l, d_in, width)),
        b(b0 + l * width),
        rows(l == 0 ? d_in : width),
        rows_pad(l == 0 ? s.d4 : s.kw),
        src_cols(l < L ? width : 2),
        dst_cols(l < L ? s.kw : 2) {}
};

// Start copying a layer's weights and biases into a slot (the biases at
// cols x kw floats in); the caller commits. A hidden or first layer's
// weights go by column quads: thread t copies quad t % (kw / 4) of rows
// t / (kw / 4) + GROUPS i, 16 bytes a copy where the rows are 16-byte
// aligned in device memory, else four floats; the head's (kw x 2) float by
// float. round_layer visits the same elements.
__device__ void copy_layer(float* slot, const LayerAt& at, const Wide& s) {
  if (at.dst_cols == 2) {
    for (int i = threadIdx.x; i < 2 * at.rows_pad; i += blockDim.x)
      copy4(slot + i, i < 2 * at.rows ? at.w + i : at.w, i < 2 * at.rows);
  } else {
    const int nc = s.kw / 4, q = threadIdx.x % nc;
    const bool vec = at.src_cols % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(at.w) & 15) == 0;
    for (int k = threadIdx.x / nc; k < at.rows_pad; k += GROUPS) {
      float* dst = slot + k * s.kw + 4 * q;
      const float* src = at.w + k * at.src_cols + 4 * q;
      if (vec) {
        const bool in = k < at.rows && 4 * q < at.src_cols;
        copy16(dst, in ? src : at.w, in);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = k < at.rows && 4 * q + j < at.src_cols;
          copy4(dst + j, in ? src + j : at.w, in);
        }
      }
    }
  }
  for (int j = threadIdx.x; j < at.dst_cols; j += blockDim.x)
    copy4(slot + s.cols * s.kw + j, j < at.src_cols ? at.b + j : at.b,
          j < at.src_cols);
}

// After this thread's copies of a layer have landed: round the weights it
// copied to bf16 when asked (the caller's barrier then publishes them)
__device__ void round_layer(float* slot, const LayerAt& at, const Wide& s,
                            bool bf16) {
  if (!bf16) return;
  if (at.dst_cols == 2) {
    for (int i = threadIdx.x; i < 2 * at.rows_pad; i += blockDim.x)
      slot[i] = bf16_round(slot[i]);
    return;
  }
  const int nc = s.kw / 4, q = threadIdx.x % nc;
  for (int k = threadIdx.x / nc; k < at.rows_pad; k += GROUPS) {
    float4* v = reinterpret_cast<float4*>(slot + k * s.kw + 4 * q);
    *v = round4(*v, true);
  }
}

// start copying the x tile (ROWS x d4, zero past d_in and past the last
// row) into buf; the caller commits
__device__ void copy_x(float* buf, const float* __restrict__ x, int first,
                       int n, int d_in, const Wide& s) {
  for (int i = threadIdx.x; i < ROWS * s.d4; i += blockDim.x) {
    const int r = i / s.d4, k = i - r * s.d4;
    const bool in = first + r < n && k < d_in;
    copy4(buf + r * s.stride + k,
          in ? x + static_cast<size_t>(first + r) * d_in + k : x, in);
  }
}

// One layer over the tile: out[r][j] = leaky(sum_k in[r][k] sw[k][j] + sb[j])
// for j < kw, each output one FMA chain over k = 0 .. k_pad - 1 in order
// from 0 (K1-fwd's order). Thread (g, c) owns rows g + GROUPS i and columns
// 4c .. 4c + 3. With `stash`, the outputs also go there (ROWS x kw).
__device__ void layer(const float* in, int k_pad, const float* sw,
                      const float* sb, float* out, float* stash,
                      const Wide& s, bool bf16, float leak) {
  const int nc = s.kw / 4;
  const int c = threadIdx.x % nc, g = threadIdx.x / nc;
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < k_pad; k += 4) {
    float4 h[TR], wt[4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      h[i] = round4(*reinterpret_cast<const float4*>(
                        in + (g + GROUPS * i) * s.stride + k), bf16);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      wt[m] = *reinterpret_cast<const float4*>(sw + (k + m) * s.kw + 4 * c);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float hk = lane(h[i], m);
        acc[i][0] = fmaf(hk, wt[m].x, acc[i][0]);
        acc[i][1] = fmaf(hk, wt[m].y, acc[i][1]);
        acc[i][2] = fmaf(hk, wt[m].z, acc[i][2]);
        acc[i][3] = fmaf(hk, wt[m].w, acc[i][3]);
      }
  }
  const float4 bias = *reinterpret_cast<const float4*>(sb + 4 * c);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = g + GROUPS * i;
    const float4 v = make_float4(leaky(acc[i][0] + bias.x, leak),
                                 leaky(acc[i][1] + bias.y, leak),
                                 leaky(acc[i][2] + bias.z, leak),
                                 leaky(acc[i][3] + bias.w, leak));
    *reinterpret_cast<float4*>(out + r * s.stride + 4 * c) = v;
    if (stash != nullptr)
      *reinterpret_cast<float4*>(stash + r * s.kw + 4 * c) = v;
  }
}

// The forward over the tile starting at `first`, from x into bufs[0]; every
// layer's output goes to the other buffer (and, with `stash`, a_1 .. a_{L-1}
// to stash + (l - 1) ROWS kw). With two weight slots the next layer (the
// head's weights after the last layer when `then_head`) is copied while the
// current one computes; with one (slots[0] == slots[1]), after it. Returns
// the buffer that holds a_L. Ends with a barrier.
__device__ float* forward_tile(float* const bufs[2], float* const slots[2],
                               const float* x, const float* w, const float* b,
                               float* stash, int first, int n, int d_in,
                               int width, int L, bool then_head,
                               const Wide& s, bool bf16, float leak) {
  const bool two = slots[0] != slots[1];
  copy_x(bufs[0], x, first, n, d_in, s);
  copy_layer(slots[0], LayerAt(0, w, b, d_in, width, L, s), s);
  commit_copies();
  int cur = 0;
  for (int l = 0; l < L; ++l) {
    float* slot = slots[l & 1];
    if (two && (l + 1 < L || then_head)) {
      copy_layer(slots[(l + 1) & 1], LayerAt(l + 1, w, b, d_in, width, L, s),
                 s);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    round_layer(slot, LayerAt(l, w, b, d_in, width, L, s), s, bf16);
    __syncthreads();
    layer(bufs[cur], l == 0 ? s.d4 : s.kw, slot, slot + s.cols * s.kw,
          bufs[cur ^ 1],
          stash != nullptr && l < L - 1 ? stash + l * ROWS * s.kw : nullptr,
          s, bf16, leak);
    __syncthreads();
    cur ^= 1;
    if (!two && l + 1 < L) {
      copy_layer(slot, LayerAt(l + 1, w, b, d_in, width, L, s), s);
      commit_copies();
    }
  }
  return bufs[cur];
}

__global__ void __launch_bounds__(4 * MAX_WIDTH)
trunk_wide_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ out0,
                      float* __restrict__ out1, int n, int d_in, int width,
                      int L, int out_w, bool head, bool bf16, float leak) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Wide s(d_in, width);
  float* const bufs[2] = {smem, smem + ROWS * s.stride};
  float* const slots[2] = {smem + 2 * ROWS * s.stride,
                           smem + 2 * ROWS * s.stride + s.slot()};
  const int first = blockIdx.x * ROWS;
  const float* h = forward_tile(bufs, slots, x, w, b, nullptr, first, n,
                                d_in, width, L, head, s, bf16, leak);
  if (!head) {
    for (int i = threadIdx.x; i < ROWS * out_w; i += blockDim.x) {
      const int r = i / out_w, j = i - r * out_w;
      if (first + r < n)
        out0[static_cast<size_t>(first) * out_w + i] = h[r * s.stride + j];
    }
    return;
  }
  // the head, in csrc/trunk.cu's order: y_c = sum_k h[k] W_L[k][c] from 0,
  // then the bias; its weights were copied during the last layer
  const float* sw = slots[L & 1];
  const float* sb = sw + s.cols * s.kw;
  wait_copies<0>();
  round_layer(slots[L & 1], LayerAt(L, w, b, d_in, width, L, s), s,
              bf16);
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * ROWS; o += blockDim.x) {
    const int r = o >> 1, c = o & 1;
    if (first + r >= n) continue;
    const float* hr = h + r * s.stride;
    float y = 0.f;
    for (int k = 0; k < s.kw; ++k)
      y = fmaf(bf16 ? bf16_round(hr[k]) : hr[k], sw[2 * k + c], y);
    (c ? out1 : out0)[first + r] = y + sb[c];
  }
}

// dpre = mask(a) * dh over the tile: slope 1 where the activation is >= 0
__device__ void mask_tile(float* dp, const float* a, const float* dh,
                          const Wide& s, float leak) {
  const int nc = s.kw / 4;
  for (int o = threadIdx.x; o < ROWS * nc; o += blockDim.x) {
    const int at = (o / nc) * s.stride + 4 * (o % nc);
    const float4 av = *reinterpret_cast<const float4*>(a + at);
    const float4 dv = *reinterpret_cast<const float4*>(dh + at);
    *reinterpret_cast<float4*>(dp + at) = make_float4(
        av.x >= 0.f ? dv.x : leak * dv.x, av.y >= 0.f ? dv.y : leak * dv.y,
        av.z >= 0.f ? dv.z : leak * dv.z, av.w >= 0.f ? dv.w : leak * dv.w);
  }
}

// dh[r][k] = sum_j bf(dp[r][j]) sw[k][j] for k < k_out (k_pad: k_out rounded
// up to 4), each a chain over j = 0 .. kw - 1 in order from 0 (csrc/
// trunk.cu's order); into dh (ROWS x stride), or, with dx, the rows < n of
// dx (n x d_in, k_out = d_in).
__device__ void dh_tile(float* dh, float* __restrict__ dx, const float* dp,
                        const float* sw, int k_out, int k_pad, int first,
                        int n, const Wide& s, bool bf16) {
  const int nc = s.kw / 4;
  const int c0 = threadIdx.x % nc, g = threadIdx.x / nc;
  for (int c = c0; 4 * c < k_pad; c += nc) {
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[i][m] = 0.f;
    for (int j = 0; j < s.kw; j += 4) {
      float4 d[TR], wt[4];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        d[i] = round4(*reinterpret_cast<const float4*>(
                          dp + (g + GROUPS * i) * s.stride + j), bf16);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        wt[m] = *reinterpret_cast<const float4*>(sw + (4 * c + m) * s.kw + j);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[i][m] = fmaf(d[i].x, wt[m].x, acc[i][m]);
          acc[i][m] = fmaf(d[i].y, wt[m].y, acc[i][m]);
          acc[i][m] = fmaf(d[i].z, wt[m].z, acc[i][m]);
          acc[i][m] = fmaf(d[i].w, wt[m].w, acc[i][m]);
        }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = g + GROUPS * i;
      if (dx == nullptr) {
        *reinterpret_cast<float4*>(dh + r * s.stride + 4 * c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else if (first + r < n) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (4 * c + m < k_out)
            dx[static_cast<size_t>(first + r) * k_out + 4 * c + m] =
                acc[i][m];
      }
    }
  }
}

// The tile's sums over its rows, in order of r from 0: for k < k_in, j <
// width, sum_r bf(a[r][k]) bf(dp[r][j]) added to pw[k * width + j], and
// sum_r dp[r][j] (unrounded) added to pb[j]. A thread owns 4 x 4 blocks of
// (k, j) (items), in turn.
__device__ void tile_sums(float* pw, float* pb, const float* a,
                          const float* dp, int k_in, int k_pad, int width,
                          const Wide& s, bool bf16) {
  const int nc = s.kw / 4;
  const int items = k_pad / 4 * nc;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int kq = it / nc, jq = it - kq * nc;
    // the partial's old values, loaded together before the row loop (a
    // load after a store to pw would wait for it)
    float old[4][4], oldb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        old[m][j] = 4 * kq + m < k_in && 4 * jq + j < width
                        ? pw[(4 * kq + m) * width + 4 * jq + j] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      oldb[j] = kq == 0 && 4 * jq + j < width ? pb[4 * jq + j] : 0.f;
    float acc[4][4], accb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    for (int r = 0; r < ROWS; ++r) {
      const float4 av = round4(*reinterpret_cast<const float4*>(
                                   a + r * s.stride + 4 * kq), bf16);
      const float4 dv =
          *reinterpret_cast<const float4*>(dp + r * s.stride + 4 * jq);
      const float4 dr = round4(dv, bf16);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float ak = lane(av, m);
        acc[m][0] = fmaf(ak, dr.x, acc[m][0]);
        acc[m][1] = fmaf(ak, dr.y, acc[m][1]);
        acc[m][2] = fmaf(ak, dr.z, acc[m][2]);
        acc[m][3] = fmaf(ak, dr.w, acc[m][3]);
      }
      if (kq == 0) {
        accb[0] += dv.x;
        accb[1] += dv.y;
        accb[2] += dv.z;
        accb[3] += dv.w;
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = 4 * kq + m;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k < k_in && 4 * jq + j < width)
          pw[k * width + 4 * jq + j] = old[m][j] + acc[m][j];
    }
    if (kq == 0)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * jq + j < width) pb[4 * jq + j] = oldb[j] + accb[j];
  }
}

// dy0/dy1: the head's (dloc, draw), each (n,); trunk only: dy0 is the
// (n, out_w) cotangent of the last layer's activations and dy1 is unused.
// part: (gridDim.x, nw + nb), this block's partial in the flat layout;
// stash: (gridDim.x, max(L - 1, 1) ROWS kw).
__global__ void __launch_bounds__(4 * MAX_WIDTH)
trunk_wide_bwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ b,
                      const float* __restrict__ dy0,
                      const float* __restrict__ dy1, float* __restrict__ dx,
                      float* __restrict__ part, float* __restrict__ stash,
                      int n, int d_in, int width, int L, int out_w, bool head,
                      bool bf16, float leak) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Wide s(d_in, width);
  float* const bufs[2] = {smem, smem + ROWS * s.stride};
  float* dp = smem + 2 * ROWS * s.stride;   // dpre_l (ROWS x stride)
  float* sw = dp + ROWS * s.stride;          // the one weight slot
  float* const slots[2] = {sw, sw};
  const int nw = n_weights(d_in, width, L, head);
  float* pw = part + static_cast<size_t>(blockIdx.x) *
                         (nw + n_biases(width, L, head));
  float* pb = pw + nw;
  float* st = stash + static_cast<size_t>(blockIdx.x) *
                          (L > 1 ? L - 1 : 1) * ROWS * s.kw;
  for (int i = threadIdx.x; i < nw + n_biases(width, L, head);
       i += blockDim.x)
    pw[i] = 0.f;
  // (the barriers below order these stores before the partial's sums)

  const int n_tiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int first = tile * ROWS;
    float* a = forward_tile(bufs, slots, x, w, b, st, first, n, d_in, width,
                            L, false, s, bf16, leak);      // a_L
    float* dh = a == bufs[0] ? bufs[1] : bufs[0];
    if (head) {
      const LayerAt at(L, w, b, d_in, width, L, s);
      copy_layer(sw, at, s);
      commit_copies();
      // the head's cotangent (dloc, draw) in dp's first two columns
      for (int o = threadIdx.x; o < 2 * ROWS; o += blockDim.x) {
        const int r = o >> 1, c = o & 1;
        dp[r * s.stride + c] =
            first + r < n ? (c ? dy1 : dy0)[first + r] : 0.f;
      }
      wait_copies<0>();
      round_layer(sw, at, s, bf16);
      __syncthreads();
      // dh = (dloc, draw) W_L^T in csrc/trunk.cu's order
      for (int o = threadIdx.x; o < ROWS * s.kw; o += blockDim.x) {
        const int r = o / s.kw, k = o - r * s.kw;
        const float* d = dp + r * s.stride;
        const float r0 = bf16 ? bf16_round(d[0]) : d[0];
        const float r1 = bf16 ? bf16_round(d[1]) : d[1];
        dh[r * s.stride + k] = fmaf(r0, sw[2 * k], r1 * sw[2 * k + 1]);
      }
      // the head's dW (width x 2) and db (2)
      for (int o = threadIdx.x; o < 2 * width + 2; o += blockDim.x) {
        const int c = o < 2 * width ? (o & 1) : o - 2 * width;
        const float* d = dp + c;
        float sum = 0.f;
        if (o < 2 * width) {
          const float* ak = a + (o >> 1);
          for (int r = 0; r < ROWS; ++r) {
            const float av = ak[r * s.stride], dv = d[r * s.stride];
            sum = fmaf(bf16 ? bf16_round(av) : av,
                       bf16 ? bf16_round(dv) : dv, sum);
          }
          pw[w_offset(L, d_in, width) + o] += sum;   // one a thread
        } else {
          for (int r = 0; r < ROWS; ++r) sum += d[r * s.stride];
          pb[L * width + c] += sum;
        }
      }
      __syncthreads();
    } else {
      // the cotangent of a_L, zero in the padded columns and rows
      for (int o = threadIdx.x; o < ROWS * s.kw; o += blockDim.x) {
        const int r = o / s.kw, j = o - r * s.kw;
        dh[r * s.stride + j] =
            first + r < n && j < out_w
                ? dy0[static_cast<size_t>(first + r) * out_w + j] : 0.f;
      }
      __syncthreads();
    }

    for (int l = L - 1; l >= 0; --l) {
      // a holds a_{l+1}, dh the cotangent of a_{l+1}; W_l is copied while
      // the mask is applied
      const LayerAt at(l, w, b, d_in, width, L, s);
      copy_layer(sw, at, s);
      commit_copies();
      mask_tile(dp, a, dh, s, leak);
      wait_copies<0>();
      round_layer(sw, at, s, bf16);
      __syncthreads();
      // a_l into a (a_{l+1} is read), copied while dh_l = dpre_l W_l^T goes
      // into dh
      if (l > 0) {
        const float* src = st + (l - 1) * ROWS * s.kw;
        const int nc = s.kw / 4;
        for (int o = threadIdx.x; o < ROWS * nc; o += blockDim.x) {
          const int r = o / nc, q = o - r * nc;
          copy16(a + r * s.stride + 4 * q, src + r * s.kw + 4 * q);
        }
        commit_copies();
        dh_tile(dh, nullptr, dp, sw, s.kw, s.kw, first, n, s, bf16);
      } else {
        copy_x(a, x, first, n, d_in, s);
        commit_copies();
        if (dx != nullptr)
          dh_tile(nullptr, dx, dp, sw, d_in, s.d4, first, n, s, bf16);
      }
      wait_copies<0>();
      __syncthreads();
      tile_sums(pw + w_offset(l, d_in, width), pb + l * width, a, dp,
                l == 0 ? d_in : width, l == 0 ? s.d4 : s.kw, width, s, bf16);
      __syncthreads();
    }
  }
}

bool wide_args_ok(int d_in, int width, int n_layers, int head, int out_w) {
  if (n_layers < 1 || d_in < 1 || d_in > MAX_WIDTH) return false;
  if (width < 1 || width > MAX_WIDTH) return false;
  return head || (out_w >= 1 && out_w <= width);
}

}  // namespace

// as ct_trunk_fwd (csrc/trunk.cu), at any width up to 128 and any depth
CT_API int ct_trunk_wide_fwd(const float* x, const float* w, const float* b,
                             float* out0, float* out1, int n, int d_in,
                             int width, int n_layers, int head, int out_w,
                             int bf16, float leak, void* stream) {
  if (!wide_args_ok(d_in, width, n_layers, head, out_w))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const size_t smem = wide_smem(d_in, width, false);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_wide_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_wide_fwd_kernel<<<ct_blocks(n, ROWS), 4 * Wide(d_in, width).kw, smem,
                          ct_stream(stream)>>>(x, w, b, out0, out1, n, d_in,
                                               width, n_layers, out_w,
                                               head != 0, bf16 != 0, leak);
  return cudaGetLastError();
}

// as ct_trunk_bwd, with stash: (n_blocks, max(n_layers - 1, 1) 64 kw) floats
// of scratch (kw: width rounded up to 16)
CT_API int ct_trunk_wide_bwd(const float* x, const float* w, const float* b,
                             const float* dy0, const float* dy1, float* dx,
                             float* part, float* stash, float* out, int n,
                             int d_in, int width, int n_layers, int head,
                             int out_w, int bf16, int n_blocks, float leak,
                             void* stream) {
  if (!wide_args_ok(d_in, width, n_layers, head, out_w) || n_blocks < 1)
    return cudaErrorInvalidValue;
  const size_t smem = wide_smem(d_in, width, true);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_wide_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_wide_bwd_kernel<<<n_blocks, 4 * Wide(d_in, width).kw, smem,
                          ct_stream(stream)>>>(
      x, w, b, dy0, dy1, dx, part, stash, n, d_in, width, n_layers, out_w,
      head != 0, bf16 != 0, leak);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_blocks(part, out, n_blocks,
                       n_weights(d_in, width, n_layers, head != 0) +
                           n_biases(width, n_layers, head != 0),
                       ct_stream(stream));
}

// bwd 0: the forward's shared memory; else the backward's
CT_API size_t ct_trunk_wide_smem(int d_in, int width, int bwd) {
  return wide_smem(d_in, width, bwd != 0);
}
