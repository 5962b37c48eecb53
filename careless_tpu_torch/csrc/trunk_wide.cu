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
// the backward (recompute, dh, dW) ~1.9 TFLOP, 28 ms. Every product is an
// f32 FMA on the SIMT units (TF32 tensor cores keep too few digits for f32,
// and bf16 keeps the f32 kernel's order of sums), so a bf16 trunk takes as
// long as an f32 one here.
//
// Sum orders, the one hard rule: every output (r, j) of a layer is the chain
// acc = 0; acc = fmaf(h[r][k], W[k][j], acc) for k = 0, 1, ... in order,
// then leaky(acc + b[j]), as trunk_common.cuh's axpy_k and dense_layer; no
// output's chain is split across threads. So this forward, the backward's
// recompute here, and csrc/trunk.cu's forward give the same activations bit
// for bit, and a backward may run in another kernel than its forward (a
// pre-activation within an ulp of zero that took the other slope would move
// its row's gradient by 1 / leak). Zero padding adds fmaf(0, w, acc) terms
// at the end of a chain, which leave acc unchanged (a chain from +0 never
// holds -0). dh sums in csrc/trunk.cu's order too: ascending j from 0, on
// bf16-rounded dpre and weights. dW and db sum a tile's rows in order from 0
// and add that to the block's partial: a fixed order, so they repeat bit for
// bit.
//
// Design: one register-tiled product on the SIMT units, used four ways (the
// forward's layers, the backward's recompute, dh and dW). A block of 2 kw
// threads (kw: the width rounded up to 16) owns a tile of TILE_ROWS = 128
// rows; thread t = (ty, tx), tx = t % (kw / 8), owns an 8 x 8 block of a
// product's outputs: rows ty + 16 i (i < 8) by columns 4 tx .. 4 tx + 3 and
// kw / 2 + 4 tx .. + 3 (forward; dW's rows are the 8 inputs 8 ty .. 8 ty + 7)
// or, for dh, the inputs k = tx + (kw / 8) c (c < 8). Both operands lie row
// major in shared memory, so one step of four along the reduction index is
// 16 loads of 16 bytes for 256 FMAs: 16 wavefronts per 64 warp-FMAs, where
// the FMA pipe takes 16 clocks for them. The loads are free of bank
// conflicts: a quarter warp reads one activation row (a broadcast) or rows
// at an odd number of quads apart, and 8 consecutive quads of a weight row,
// or (dh) 8 consecutive weight rows at a stride of kw + 4 floats (an odd
// number of quads). Every operand is addressed from the shared-memory array
// itself (shm() plus an offset), so each is an LDS: through a pointer kept
// in an array or swapped between regions the compiler emits generic loads
// (LD), which cost the backward a fifth of its time. A layer's outputs stay
// in registers until every thread has read its inputs, and then overwrite
// them in place, so the forward holds one buffer of activations; the
// biases go into registers before that barrier, since the next layer's copy
// may overwrite their slot right after it. The weights stream one layer at
// a time from device memory (L2: 1.3 MB at width 128 and 20 layers) by
// cp.async, the next layer while the current one computes. No tensor
// cores, no TMA.
//
// The backward: a fixed grid of as many blocks as fit on the card at once
// (kernels._wide_blocks_per_card). Block g walks the tiles g, g + G, ...; per
// tile it recomputes the forward layer by layer as the forward kernel does,
// writing a_1 .. a_{L-1} from registers to a per-block stash in device
// memory (TILE_ROWS rows of kw floats a layer), then runs the chain back a
// layer at a time. Entering layer l, dpre_l = mask(a_{l+1}) dh_{l+1} is in one
// region, W_l in another, and a_l is on its way from the stash (cp.async)
// into the activation buffer while dh_l = dpre_l W_l^T goes into registers;
// then dh_l, masked by a_l, overwrites W_l's region as dpre_{l-1}; the tile's
// sums over its rows, sum_r a_l[r][k] dpre_l[r][j] and sum_r dpre_l[r][j],
// are added to the block's partial in device memory (the flat layout's
// nw + nb floats a block, at a stride of whole quads, read and written 16
// bytes at a time); and W_{l-1} is copied into dpre_l's region. A second
// launch sums the partials in block order (trunk_common.cuh's
// reduce_blocks). No atomics.
//
// Shared memory (wide_smem below; kernels.trunk_wide_smem is a copy that a
// card test holds equal), with d4 = d_in rounded up to 4, cols = max(d4,
// kw): an activation buffer of TILE_ROWS rows at a stride of 4 (cols / 4 | 1)
// floats (an odd number of quads) and a weight slot of cols rows at a stride
// of kw + 4 and its kw biases. The forward holds one buffer and two slots;
// the backward three regions, each the larger of a buffer and a slot: the
// activations, and two that take turns as weight slot and dpre (in the
// recompute, the two weight slots). At d_in <= 128 and width 128: 203,776
// bytes forward, 204,288 backward, one block of 256 threads a SM.
//
// The design loop: tools/trunk_wide_probe.py builds this file alone, prints
// its registers, spills and SASS counts, holds both directions against the
// plain version and times them at the `wide` slice's shape and at 100k rows,
// and times the backward with each of its parts knocked out.
#include <cuda_bf16.h>

#include "trunk_common.cuh"

namespace {

constexpr int TILE_ROWS = 128;        // rows of a tile: a block's
constexpr int ROW_GROUPS = 16;        // a thread's rows are ty + 16 i
constexpr int TM = TILE_ROWS / ROW_GROUPS;   // rows a thread owns: 8
constexpr int MAX_WIDTH = 128;        // the JAX kernel's 128 lanes
constexpr int MAX_THREADS = 2 * MAX_WIDTH;

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

// The block's dynamic shared memory. Regions are passed around as float
// offsets from it and turned into pointers where they are used, so that the
// compiler sees a shared-memory address at every load (a pointer that went
// through an array or a swap is a generic one, loaded by LD instead of LDS).
__device__ inline float* shm() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ inline void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The shapes of one launch: `width` is the packed width of the flat layout
// (the model's width padded as kernels.trunk_width says), kw the width this
// kernel computes at.
struct Wide {
  int kw;        // width rounded up to 16
  int d4;        // d_in rounded up to 4
  int cols;      // max(d4, kw): the widest row a buffer or layer holds
  int stride;    // an activation row's stride: an odd number of quads
  int wstride;   // a weight row's stride in a slot: kw + 4
  __host__ __device__ Wide(int d_in, int width)
      : kw((width + 15) / 16 * 16),
        d4((d_in + 3) / 4 * 4),
        cols(d4 > kw ? d4 : kw),
        stride(4 * ((cols / 4) | 1)),
        wstride(kw + 4) {}
  __host__ __device__ int threads() const { return 2 * kw; }
  __host__ __device__ int buffer() const { return TILE_ROWS * stride; }
  // a weight slot: one layer's weights and its biases
  __host__ __device__ int slot() const { return cols * wstride + kw; }
  __host__ __device__ int region() const {
    return buffer() > slot() ? buffer() : slot();
  }
  __host__ __device__ size_t floats(bool bwd) const {
    return bwd ? 3 * static_cast<size_t>(region())
               : static_cast<size_t>(buffer()) + 2 * slot();
  }
};

// A block's partial of dW and db: nw + nb floats at a stride rounded up to
// a quad, so that with a width of a multiple of 4 every row of every
// layer's dW starts 16 bytes aligned
__host__ __device__ inline int part_stride(int d_in, int width, int L,
                                           bool head) {
  return (n_weights(d_in, width, L, head) + n_biases(width, L, head) + 3) /
         4 * 4;
}

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
// in the slot (zero past rows and src_cols; rows at wstride floats), then
// dst_cols biases at cols x wstride floats in.
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

// Start copying a layer's weights and biases into a slot; the caller
// commits. A hidden or first layer's weights go by column quads: thread t
// copies quad t % (kw / 4) of rows t / (kw / 4) + 8 i, 16 bytes a copy where
// the rows are 16-byte aligned in device memory, else four floats; the
// head's (kw x 2) float by float, packed. round_layer visits the same
// elements.
__device__ void copy_layer(float* slot, const LayerAt& at, const Wide& s) {
  if (at.dst_cols == 2) {
    for (int i = threadIdx.x; i < 2 * at.rows_pad; i += blockDim.x)
      copy4(slot + i, i < 2 * at.rows ? at.w + i : at.w, i < 2 * at.rows);
  } else {
    const int nc = s.kw / 4, q = threadIdx.x % nc, step = blockDim.x / nc;
    const bool vec = at.src_cols % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(at.w) & 15) == 0;
    for (int k = threadIdx.x / nc; k < at.rows_pad; k += step) {
      float* dst = slot + k * s.wstride + 4 * q;
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
    copy4(slot + s.cols * s.wstride + j, j < at.src_cols ? at.b + j : at.b,
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
  const int nc = s.kw / 4, q = threadIdx.x % nc, step = blockDim.x / nc;
  for (int k = threadIdx.x / nc; k < at.rows_pad; k += step) {
    float* v = slot + k * s.wstride + 4 * q;
    st4(v, round4(ld4(v), true));
  }
}

// start copying the x tile (TILE_ROWS x d4, zero past d_in and past the
// last row) into buf; the caller commits
__device__ void copy_x(float* buf, const float* __restrict__ x, int first,
                       int n, int d_in, const Wide& s) {
  for (int i = threadIdx.x; i < TILE_ROWS * s.d4; i += blockDim.x) {
    const int r = i / s.d4, k = i - r * s.d4;
    const bool in = first + r < n && k < d_in;
    copy4(buf + r * s.stride + k,
          in ? x + static_cast<size_t>(first + r) * d_in + k : x, in);
  }
}

// start copying a stashed activation (TILE_ROWS x kw, rows kw floats apart)
// into buf; the caller commits
__device__ void copy_stash(float* buf, const float* src, const Wide& s) {
  const int nc = s.kw / 4;
  for (int o = threadIdx.x; o < TILE_ROWS * nc; o += blockDim.x) {
    const int r = o / nc, q = o - r * nc;
    copy16(buf + r * s.stride + 4 * q, src + r * s.kw + 4 * q);
  }
}

// The register tile of a product: acc[i][c] for the thread's row i (ty +
// 16 i) and its column c, 4 tx + c for c < 4 and kw / 2 + 4 tx + c - 4 after
// (the forward); or, in dh, the input tx + (kw / 8) c.
using Tile = float[TM][8];

__device__ inline void zero(Tile& acc) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
}

// acc[i][c] = sum_k bf(in[r_i][k]) sw[k][col_c] over k = 0 .. k_pad - 1 in
// order from 0 (K1-fwd's order), for k_pad a multiple of 4
__device__ void layer_product(Tile& acc, const float* in, int k_pad,
                              const float* sw, const Wide& s, bool bf16) {
  const int nq = s.kw / 8;
  const int tx = threadIdx.x % nq, ty = threadIdx.x / nq;
  const float* h0 = in + ty * s.stride;
  const float* w0 = sw + 4 * tx;
  const float* w1 = w0 + s.kw / 2;
  zero(acc);
  for (int k = 0; k < k_pad; k += 4) {
    float4 h[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      h[i] = round4(ld4(h0 + ROW_GROUPS * i * s.stride + k), bf16);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 a = ld4(w0 + (k + m) * s.wstride);
      const float4 b = ld4(w1 + (k + m) * s.wstride);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float hk = lane(h[i], m);
        acc[i][0] = fmaf(hk, a.x, acc[i][0]);
        acc[i][1] = fmaf(hk, a.y, acc[i][1]);
        acc[i][2] = fmaf(hk, a.z, acc[i][2]);
        acc[i][3] = fmaf(hk, a.w, acc[i][3]);
        acc[i][4] = fmaf(hk, b.x, acc[i][4]);
        acc[i][5] = fmaf(hk, b.y, acc[i][5]);
        acc[i][6] = fmaf(hk, b.z, acc[i][6]);
        acc[i][7] = fmaf(hk, b.w, acc[i][7]);
      }
    }
  }
}

// The biases of the thread's columns (before the barrier after which the
// next layer's copy may overwrite their slot)
__device__ inline void layer_bias(float4 (&bias)[2], const float* sb,
                                  const Wide& s) {
  const int tx = threadIdx.x % (s.kw / 8);
  bias[0] = ld4(sb + 4 * tx);
  bias[1] = ld4(sb + s.kw / 2 + 4 * tx);
}

// The layer's outputs from layer_product's sums: leaky(acc + b) into out
// (TILE_ROWS x stride) and, with `stash`, there too (TILE_ROWS x kw)
__device__ void layer_out(const Tile& acc, const float4 (&bias)[2],
                          float* out, float* __restrict__ stash,
                          const Wide& s, float leak) {
  const int nq = s.kw / 8;
  const int tx = threadIdx.x % nq, ty = threadIdx.x / nq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = half * (s.kw / 2) + 4 * tx;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + ROW_GROUPS * i;
      const float* a = acc[i] + 4 * half;
      const float4 v = make_float4(leaky(a[0] + bias[half].x, leak),
                                   leaky(a[1] + bias[half].y, leak),
                                   leaky(a[2] + bias[half].z, leak),
                                   leaky(a[3] + bias[half].w, leak));
      st4(out + r * s.stride + col, v);
      if (stash != nullptr) st4(stash + r * s.kw + col, v);
    }
  }
}

// The forward over the tile starting at `first`, from x in place in buf
// (a_L there at the end; with `stash`, a_1 .. a_{L-1} also to stash + (l - 1)
// TILE_ROWS kw). The next layer (the head's weights after the last layer
// when `then_head`) is copied into the other slot while the current one
// computes. Ends with a barrier, every copy landed.
__device__ void forward_tile(int buf_at, int slot0, int slot1,
                             const float* x, const float* w, const float* b,
                             float* stash, int first, int n, int d_in,
                             int width, int L, bool then_head, const Wide& s,
                             bool bf16, float leak) {
  float* const buf = shm() + buf_at;
  copy_x(buf, x, first, n, d_in, s);
  copy_layer(shm() + slot0, LayerAt(0, w, b, d_in, width, L, s), s);
  commit_copies();
  for (int l = 0; l < L; ++l) {
    float* slot = shm() + (l & 1 ? slot1 : slot0);
    if (l + 1 < L || then_head) {
      copy_layer(shm() + (l & 1 ? slot0 : slot1),
                 LayerAt(l + 1, w, b, d_in, width, L, s), s);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    round_layer(slot, LayerAt(l, w, b, d_in, width, L, s), s, bf16);
    __syncthreads();
    Tile acc;
    layer_product(acc, buf, l == 0 ? s.d4 : s.kw, slot, s, bf16);
    float4 bias[2];
    layer_bias(bias, slot + s.cols * s.wstride, s);
    // every thread has read buf and the slot: overwrite buf, and the next
    // iteration may copy into the slot
    __syncthreads();
    layer_out(acc, bias, buf,
              stash != nullptr && l < L - 1
                  ? stash + static_cast<size_t>(l) * TILE_ROWS * s.kw
                  : nullptr,
              s, leak);
  }
  wait_copies<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
trunk_wide_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ out0,
                      float* __restrict__ out1, int n, int d_in, int width,
                      int L, int out_w, bool head, bool bf16, float leak) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Wide s(d_in, width);
  float* h = smem;
  const int first = blockIdx.x * TILE_ROWS;
  forward_tile(0, s.buffer(), s.buffer() + s.slot(), x, w, b, nullptr, first,
               n, d_in, width, L, head, s, bf16, leak);
  if (!head) {
    for (int i = threadIdx.x; i < TILE_ROWS * out_w; i += blockDim.x) {
      const int r = i / out_w, j = i - r * out_w;
      if (first + r < n)
        out0[static_cast<size_t>(first) * out_w + i] = h[r * s.stride + j];
    }
    return;
  }
  // the head, in csrc/trunk.cu's order: y_c = sum_k h[k] W_L[k][c] from 0,
  // then the bias; its weights were copied during the last layer
  float* sw = smem + s.buffer() + (L & 1 ? s.slot() : 0);
  const float* sb = sw + s.cols * s.wstride;
  round_layer(sw, LayerAt(L, w, b, d_in, width, L, s), s, bf16);
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * TILE_ROWS; o += blockDim.x) {
    const int r = o >> 1, c = o & 1;
    if (first + r >= n) continue;
    const float* hr = h + r * s.stride;
    float y = 0.f;
    for (int k = 0; k < s.kw; ++k)
      y = fmaf(bf16 ? bf16_round(hr[k]) : hr[k], sw[2 * k + c], y);
    (c ? out1 : out0)[first + r] = y + sb[c];
  }
}

// acc[i][c] = sum_j bf(dp[r_i][j]) sw[k_c][j] over j = 0 .. kw - 1 in order
// from 0 (csrc/trunk.cu's order), for the thread's rows and its inputs
// k_c = k0 + tx + (kw / 8) c (rows past the slot's read its last row; the
// caller drops those sums)
__device__ void dh_product(Tile& acc, const float* dp, const float* sw,
                           int k0, const Wide& s, bool bf16) {
  const int nq = s.kw / 8;
  const int tx = threadIdx.x % nq, ty = threadIdx.x / nq;
  int row[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int k = k0 + tx + nq * c;
    row[c] = (k < s.cols ? k : s.cols - 1) * s.wstride;
  }
  const float* d0 = dp + ty * s.stride;
  zero(acc);
  for (int j = 0; j < s.kw; j += 4) {
    float4 d[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      d[i] = round4(ld4(d0 + ROW_GROUPS * i * s.stride + j), bf16);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 wt = ld4(sw + row[c] + j);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float a = acc[i][c];
        a = fmaf(d[i].x, wt.x, a);
        a = fmaf(d[i].y, wt.y, a);
        a = fmaf(d[i].z, wt.z, a);
        acc[i][c] = fmaf(d[i].w, wt.w, a);
      }
    }
  }
}

// The tile's sums over its rows for one layer, in order of r from 0: for
// k < k_in, j < width, sum_r bf(a[r][k]) bf(dp[r][j]) added to
// pw[k * width + j] (thread (ty, tx) owns k = 8 ty .. 8 ty + 7 and the
// forward's columns of tx); and sum_r dp[r][j] (unrounded) added to pb[j]
// (thread j < kw). k_pad: k_in rounded up to 4.
__device__ void tile_sums(float* pw, float* pb, const float* a,
                          const float* dp, int k_in, int k_pad, int width,
                          const Wide& s, bool bf16) {
  const int nq = s.kw / 8;
  const int tx = threadIdx.x % nq, ty = threadIdx.x / nq;
  if (8 * ty < k_pad) {
    float acc[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
    const float* ar = a + 8 * ty;
    const float* dr = dp + 4 * tx;
#pragma unroll 2
    for (int r = 0; r < TILE_ROWS; ++r) {
      const float4 a0 = round4(ld4(ar + r * s.stride), bf16);
      const float4 a1 = round4(ld4(ar + r * s.stride + 4), bf16);
      const float4 d0 = round4(ld4(dr + r * s.stride), bf16);
      const float4 d1 = round4(ld4(dr + r * s.stride + s.kw / 2), bf16);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float ak = m < 4 ? lane(a0, m) : lane(a1, m - 4);
        acc[m][0] = fmaf(ak, d0.x, acc[m][0]);
        acc[m][1] = fmaf(ak, d0.y, acc[m][1]);
        acc[m][2] = fmaf(ak, d0.z, acc[m][2]);
        acc[m][3] = fmaf(ak, d0.w, acc[m][3]);
        acc[m][4] = fmaf(ak, d1.x, acc[m][4]);
        acc[m][5] = fmaf(ak, d1.y, acc[m][5]);
        acc[m][6] = fmaf(ak, d1.z, acc[m][6]);
        acc[m][7] = fmaf(ak, d1.w, acc[m][7]);
      }
    }
    // the partial's old values, loaded after the row loop (before it they
    // take 64 registers through it) and all before the first store (a load
    // after a store to pw would wait for it); 16 bytes at a time where the
    // width is a multiple of 4 (part_stride keeps those rows aligned)
    if (width % 4 == 0) {
      float4 old[8][2];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * ty + m, col = h * (s.kw / 2) + 4 * tx;
          old[m][h] = k < k_in && col < width
                          ? ld4(pw + k * width + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * ty + m, col = h * (s.kw / 2) + 4 * tx;
          const float* sum = acc[m] + 4 * h;
          if (k < k_in && col < width)
            st4(pw + k * width + col,
                make_float4(old[m][h].x + sum[0], old[m][h].y + sum[1],
                            old[m][h].z + sum[2], old[m][h].w + sum[3]));
        }
    } else {
      float old[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = 8 * ty + m;
          const int col = (j >> 2) * (s.kw / 2) + 4 * tx + (j & 3);
          old[m][j] = k < k_in && col < width ? pw[k * width + col] : 0.f;
        }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = 8 * ty + m;
          const int col = (j >> 2) * (s.kw / 2) + 4 * tx + (j & 3);
          if (k < k_in && col < width) pw[k * width + col] =
              old[m][j] + acc[m][j];
        }
    }
  }
  const int j = threadIdx.x;
  if (j < width) {
    const float oldb = pb[j];
    float sum = 0.f;
#pragma unroll 8
    for (int r = 0; r < TILE_ROWS; ++r) sum += dp[r * s.stride + j];
    pb[j] = oldb + sum;
  }
}

// dy0/dy1: the head's (dloc, draw), each (n,); trunk only: dy0 is the
// (n, out_w) cotangent of the last layer's activations and dy1 is unused.
// part: (gridDim.x, part_stride), this block's partial in the flat layout;
// stash: (gridDim.x, max(L - 1, 1) TILE_ROWS kw).
__global__ void __launch_bounds__(MAX_THREADS, 1)
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
  float* const act = smem;                       // the activations
  // the two other regions, by their offsets: they take turns as the weight
  // slot and dpre in the chain back
  const int two0 = s.region(), two1 = 2 * s.region();
  const int nw = n_weights(d_in, width, L, head);
  float* pw = part + static_cast<size_t>(blockIdx.x) *
                         part_stride(d_in, width, L, head);
  float* pb = pw + nw;
  float* st = stash + static_cast<size_t>(blockIdx.x) *
                          (L > 1 ? L - 1 : 1) * TILE_ROWS * s.kw;
  for (int i = threadIdx.x; i < nw + n_biases(width, L, head);
       i += blockDim.x)
    pw[i] = 0.f;
  // (the barriers below order these stores before the partial's sums)

  const int nq = s.kw / 8;
  const int tx = threadIdx.x % nq, ty = threadIdx.x / nq;
  const int n_tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int first = tile * TILE_ROWS;
    forward_tile(0, two0, two1, x, w, b, st, first, n, d_in, width, L, false,
                 s, bf16, leak);                  // a_L in act
    // dpre_{L-1} = mask(a_L) (the cotangent of a_L) into region two1
    int dp_at = two1, sw_at = two0;
    if (head) {
      float* sw = smem + sw_at;
      float* dp = smem + dp_at;
      // the head's weights in region two0, its cotangent (dloc, draw) after
      // them (2 kw + 2 TILE_ROWS <= cols (kw + 4) at every kw >= 16, before
      // the biases)
      const LayerAt at(L, w, b, d_in, width, L, s);
      float* cot = sw + 2 * s.kw;
      copy_layer(sw, at, s);
      for (int o = threadIdx.x; o < 2 * TILE_ROWS; o += blockDim.x) {
        const int r = o >> 1;
        const bool in = first + r < n;
        copy4(cot + o, in ? (o & 1 ? dy1 : dy0) + first + r : dy0, in);
      }
      commit_copies();
      wait_copies<0>();
      round_layer(sw, at, s, bf16);
      __syncthreads();
      // the head's dW (width x 2) and db (2)
      for (int o = threadIdx.x; o < 2 * width + 2; o += blockDim.x) {
        const int c = o < 2 * width ? (o & 1) : o - 2 * width;
        float sum = 0.f;
        if (o < 2 * width) {
          const float* ak = act + (o >> 1);
          for (int r = 0; r < TILE_ROWS; ++r) {
            const float av = ak[r * s.stride], dv = cot[2 * r + c];
            sum = fmaf(bf16 ? bf16_round(av) : av,
                       bf16 ? bf16_round(dv) : dv, sum);
          }
          pw[w_offset(L, d_in, width) + o] += sum;   // one a thread
        } else {
          for (int r = 0; r < TILE_ROWS; ++r) sum += cot[2 * r + c];
          pb[L * width + c] += sum;
        }
      }
      // dh = (dloc, draw) W_L^T in csrc/trunk.cu's order, masked by a_L
      for (int o = threadIdx.x; o < TILE_ROWS * s.kw; o += blockDim.x) {
        const int r = o / s.kw, k = o - r * s.kw;
        const float r0 = bf16 ? bf16_round(cot[2 * r]) : cot[2 * r];
        const float r1 = bf16 ? bf16_round(cot[2 * r + 1]) : cot[2 * r + 1];
        const float v = fmaf(r0, sw[2 * k], r1 * sw[2 * k + 1]);
        dp[r * s.stride + k] = act[r * s.stride + k] >= 0.f ? v : leak * v;
      }
    } else {
      // the cotangent of a_L, zero in the padded columns and rows, masked
      for (int o = threadIdx.x; o < TILE_ROWS * s.kw; o += blockDim.x) {
        const int r = o / s.kw, j = o - r * s.kw;
        const float v = first + r < n && j < out_w
            ? dy0[static_cast<size_t>(first + r) * out_w + j] : 0.f;
        smem[dp_at + r * s.stride + j] =
            act[r * s.stride + j] >= 0.f ? v : leak * v;
      }
    }
    __syncthreads();

    // the chain back, layer by layer
    // entering layer l: dp holds dpre_l, sw W_l (landed and rounded); a_l
    // is on its way into act
    copy_layer(smem + sw_at, LayerAt(L - 1, w, b, d_in, width, L, s), s);
    commit_copies();
    if (L > 1)
      copy_stash(act, st + static_cast<size_t>(L - 2) * TILE_ROWS * s.kw, s);
    else
      copy_x(act, x, first, n, d_in, s);
    commit_copies();
    wait_copies<1>();
    round_layer(smem + sw_at, LayerAt(L - 1, w, b, d_in, width, L, s), s,
                bf16);
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      float* const dp = shm() + dp_at;
      float* const sw = shm() + sw_at;
      Tile acc;
      if (l > 0) {
        dh_product(acc, dp, sw, 0, s, bf16);
      } else if (dx != nullptr) {
        // dx = dpre_0 W_0^T, k < d_in, kw inputs at a time
        for (int k0 = 0; k0 < d_in; k0 += s.kw) {
          dh_product(acc, dp, sw, k0, s, bf16);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r = ty + ROW_GROUPS * i;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int k = k0 + tx + nq * c;
              if (first + r < n && k < d_in)
                dx[static_cast<size_t>(first + r) * d_in + k] = acc[i][c];
            }
          }
        }
      }
      wait_copies<0>();
      __syncthreads();   // a_l landed; every thread has read W_l
      if (l > 0) {
        // dpre_{l-1} = mask(a_l) dh_l over W_l's region
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = ty + ROW_GROUPS * i;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int at = r * s.stride + tx + nq * c;
            sw[at] = act[at] >= 0.f ? acc[i][c] : leak * acc[i][c];
          }
        }
      }
      tile_sums(pw + w_offset(l, d_in, width), pb + l * width, act, dp,
                l == 0 ? d_in : width, l == 0 ? s.d4 : s.kw, width, s, bf16);
      __syncthreads();   // every thread has read a_l and dpre_l
      if (l > 0) {
        const int next = dp_at;   // W_{l-1} into dpre_l's region
        dp_at = sw_at;
        sw_at = next;
        copy_layer(shm() + sw_at, LayerAt(l - 1, w, b, d_in, width, L, s), s);
        commit_copies();
        if (l > 1)
          copy_stash(act, st + static_cast<size_t>(l - 2) * TILE_ROWS * s.kw,
                     s);
        else
          copy_x(act, x, first, n, d_in, s);
        commit_copies();
        wait_copies<1>();
        round_layer(shm() + sw_at, LayerAt(l - 1, w, b, d_in, width, L, s), s,
                    bf16);
        __syncthreads();
      }
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
  trunk_wide_fwd_kernel<<<ct_blocks(n, TILE_ROWS),
                          Wide(d_in, width).threads(), smem,
                          ct_stream(stream)>>>(x, w, b, out0, out1, n, d_in,
                                               width, n_layers, out_w,
                                               head != 0, bf16 != 0, leak);
  return cudaGetLastError();
}

// as ct_trunk_bwd, with part: (n_blocks, nw + nb rounded up to 4) and
// stash: (n_blocks, max(n_layers - 1, 1) 128 kw) floats of scratch (kw:
// width rounded up to 16)
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
  trunk_wide_bwd_kernel<<<n_blocks, Wide(d_in, width).threads(), smem,
                          ct_stream(stream)>>>(
      x, w, b, dy0, dy1, dx, part, stash, n, d_in, width, n_layers, out_w,
      head != 0, bf16 != 0, leak);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_blocks(part, out, n_blocks,
                       n_weights(d_in, width, n_layers, head != 0) +
                           n_biases(width, n_layers, head != 0),
                       part_stride(d_in, width, n_layers, head != 0),
                       ct_stream(stream));
}

// bwd 0: the forward's shared memory; else the backward's
CT_API size_t ct_trunk_wide_smem(int d_in, int width, int bwd) {
  return wide_smem(d_in, width, bwd != 0);
}
