// K1-bwd with bf16 operands: the scaling-MLP trunk's backward, with or
// without its linear head, on the H100's tensor cores (mma.sync).
//
// Replaces careless_tpu/ops/fused_mlp.py:_bwd_kernel (the pallas_call of
// _trunk_bwd) in its two bf16 instantiations, head or trunk only, where
// `_dot` (:60-74) rounds both operands of every product to bf16 and sums in
// f32. For every observation with metadata x it recomputes the forward
//     h_0 = x;  h_{l+1} = leaky(bf16(h_l) bf16(W_l) + b_l)  for l < L
// and, from the cotangent of (loc, raw) = bf16(h_L) bf16(W_L) + b_L (head)
// or of h_L (trunk only), runs the chain back:
//     dpre_l = dh_{l+1} * (a_{l+1} >= 0 ? 1 : leak)            (f32)
//     dh_l = bf16(dpre_l) bf16(W_l)^T
//     dW_l = sum over observations of bf16(a_l)^T bf16(dpre_l)
//     db_l = sum over observations of dpre_l                   (f32)
// (dx = dh_0 only when asked). A product of two bf16 values is exact in
// f32, so dW, a sum of such products over the observations, is what bf16
// `mma` with f32 accumulation computes, in its own order.
//
// What bounds it on the H100: bytes (x and the cotangents read once, dW and
// db written, ~0.014 ms at the main path, N = 1M, d_in = W = 10, L = 20,
// head); the products are ~12 GFLOP (0.012 ms at 989 TFLOP/s). What holds
// it far above that is what runs on the SIMT units, the recomputed forward
// and dh, each about K1-fwd's work (~0.17 ms at full occupancy), and their
// latency at the few warps a SM that the stash (~21 KB a warp) leaves room
// for: the time fell with the warps resident, 4 to 6, whatever else
// changed (PERF.md).
//
// Design, one warp per 32-row tile (a block is 1 to 8 warps, each walking
// tiles of its own; they share only the weights):
// - The forward is recomputed one row a lane, with trunk_common.cuh's
//   layer product, in K1-fwd's order (products in order of k, then the
//   bias), so every slope is the one the loss saw.
// - dh = bf16(dpre) bf16(W)^T runs one row a lane too, as FMAs in order of
//   j from 0: csrc/trunk.cu's order, and the plain version's, so dpre is
//   their f32 value and rounds to the same bf16 value. Not on mma: there it
//   sums in the tensor core's order, a dpre near a bf16 rounding midpoint
//   then rounds the other way, that row's later terms move by ~2^-8 of
//   themselves, and the sums over 1M rows parted from the plain version by
//   up to 1.05x the 1e-4 gate (H100, tools/trunk_bwd_probe.py; PERF.md).
// - dW = sum over rows of bf16(a_l)^T bf16(dpre_l) runs on mma (m16n8k16,
//   bf16 operands, f32 accumulator): the rows are mma's K. Its A operand
//   comes from the stash by ldmatrix.trans, its B operand from a per-warp
//   buffer of bf16(dpre) [row][j] by ldmatrix.trans. An order of summation
//   over rows moves dW only by f32 rounding, as any order would.
// - The stash keeps per tile, in shared memory, bf16(x) and bf16(a_l) for
//   l = 1..L (dW's A operands), row-major with each row's 16-byte chunks
//   XOR-swizzled so that ldmatrix's eight row reads, and eight lanes'
//   16-byte stores, fall on distinct banks; and one 32-bit mask per row and
//   layer: bit j is (a_{l+1}[j] >= 0) of the f32 activation (not
//   re-derived from bf16(a): a negative |a| < 2^-134 rounds to -0.0, which
//   is >= 0).
// - Widths pad to KW = 16 or 32, d_in to a multiple of 16, the head's two
//   columns to 8, all with zeros, which is exact. The weights, rounded to
//   bf16 once, are staged per block as pairs of bf16, read by the SIMT
//   products as broadcasts.
// - db sums the f32 dpre over the tile's rows by halving warp shuffles in
//   a fixed order (KW - 1 shuffles a layer).
// - dW and db accumulate in each warp's partial, f32 in their flat layout
//   in shared memory (the accumulator tiles' padding is not kept: at width
//   10 it would take 2.5x the room and cost two warps a SM): each tile's
//   32-row product from a zero accumulator, added by f32 adds, in fixed
//   tile order. The block adds its warps' partials in warp order into a
//   (G, nw + nb) scratch and reduce_blocks sums that in block order: no
//   atomics, so dW and db repeat bit for bit (they differ from
//   csrc/trunk.cu's by summation order).
// The block's rows (32 a warp) are chosen by the wrapper, the most whose
// shared memory fits (kernels.trunk_bwd_bf16_smem is a copy of
// bwd_bf16_smem below); a shape that fits not even one warp runs
// csrc/trunk.cu's backward.
#include <cuda_bf16.h>
#include <string.h>

#include "trunk_common.cuh"

namespace {

constexpr int ROWS = 32;          // rows of a warp's tile, one a lane
constexpr int MAX_WARPS = 8;      // warps of a block
constexpr uint32_t FULL = 0xffffffffu;

__host__ __device__ constexpr int kernel_kw(int W) { return W <= 16 ? 16 : 32; }
__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// A block's shared memory, in bytes, region by region (each a multiple of
// 16): the biases (f32) and the weights (bf16 pairs, each layer's rows of
// (W + 1) / 2 words, the head's of one), shared; then for each warp its
// partial of dW and db (f32, in their flat layout), its masks (one a row
// and layer), its stash (bf16(x) at DX columns, bf16(a_1..a_L) at KW, ROWS
// rows each) and its dpre buffer (ROWS rows of KW bf16).
struct Layout {
  int kw, dx;               // padded width and d_in
  int pairs;                // words of a weight row: (W + 1) / 2
  int bias, params, acc, masks, stash, buf, warp;
  __host__ __device__ Layout(int d_in, int W, int L, bool head)
      : kw(kernel_kw(W)),
        dx(pad16(d_in)),
        pairs((W + 1) / 2),
        bias(16 * ((n_biases(W, L, head) + 3) / 4)),
        params(bias + 16 * (((d_in + (L - 1) * W) * pairs + (head ? W : 0)
                             + 3) / 4)),
        acc(16 * ((n_weights(d_in, W, L, head) + n_biases(W, L, head) + 3)
                  / 4)),
        masks(4 * ROWS * L),
        stash(2 * ROWS * (dx + L * kw)),
        buf(2 * ROWS * kw),
        warp(acc + masks + stash + buf) {}
  __host__ __device__ int total(int warps) const {
    return params + warps * warp;
  }
};

// two values rounded to bf16 (ties to even) by one packed conversion, the
// first in the low half (mma's order)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// half h (0: low) of a pair of bf16, as an f32
__device__ __forceinline__ float unpack(uint32_t u, int h) {
  return __uint_as_float(h ? (u & 0xFFFF0000u) : (u << 16));
}

// v[0..W) rounded to bf16 in place, and the pairs as words of a stash row
// of KW columns, zero past W
template <int N, int W, int KW>
__device__ __forceinline__ void round_row(float (&v)[N],
                                          uint32_t (&u)[KW / 2]) {
#pragma unroll
  for (int p = 0; p < KW / 2; ++p)
    u[p] = 2 * p >= W ? 0u : pack2(v[2 * p], 2 * p + 1 < W ? v[2 * p + 1]
                                                         : 0.f);
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = unpack(u[j >> 1], j & 1);
}

// The byte offset of 16-byte chunk q of row r in a region whose rows have
// C chunks (C even): the chunk index XORed with a function of the row, so
// that eight consecutive rows' chunk q (an ldmatrix 8x8 read, or eight
// lanes' 16-byte stores) fall on eight distinct groups of four banks.
__device__ __forceinline__ int swz(int r, int q, int C) {
  const int f = C % 8 == 0 ? (r & 7) : C % 4 == 0 ? ((r >> 1) & 3)
                                                  : ((r >> 2) & 1);
  return r * C * 16 + (q ^ f) * 16;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a b on one m16n8k16 tile, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One layer's weights W_l[k][j] as bf16 pairs (j, j + 1), row k at
// `pairs` words (trunk_common.cuh's WeightAt: the weight as an f32)
struct PairWeights {
  const uint32_t* base;
  int pairs;
  __device__ __forceinline__ float operator()(int k, int j) const {
    return unpack(base[k * pairs + (j >> 1)], j & 1);
  }
};

// The weights from the flat f32 layout (trunk_common.cuh), rounded to bf16
// in pairs, a row of `pairs` words per input feature (one for the head's
// two columns), zero past the last column.
__device__ void stage_weights(const float* __restrict__ w, uint32_t* ws,
                              int P, int d_in, int W, int L, bool head) {
  const int hidden = (d_in + (L - 1) * W) * P;
  const int total = hidden + (head ? W : 0);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    // the hidden layers' rows follow each other in the flat layout
    const int row = i / P, j = 2 * (i - row * P);
    const float* wr = i < hidden ? w + static_cast<size_t>(row) * W + j
                                 : w + w_offset(L, d_in, W) + 2 * (i - hidden);
    const bool pair = i >= hidden || j + 1 < W;
    ws[i] = pack2(wr[0], pair ? wr[1] : 0.f);
  }
}

// a stash or buffer row of KW / 8 swizzled 16-byte chunks
template <int KW>
__device__ __forceinline__ void store_row(char* slot, int r,
                                          const uint32_t (&u)[KW / 2]) {
#pragma unroll
  for (int q = 0; q < KW / 8; ++q)
    *reinterpret_cast<uint4*>(slot + swz(r, q, KW / 8)) =
        make_uint4(u[4 * q], u[4 * q + 1], u[4 * q + 2], u[4 * q + 3]);
}

// The partial += one 16 x 8 accumulator tile of dW (rows k0.., columns
// j0.. of a layer whose flat block starts at dw, rows of d_out), by f32
// adds of the elements inside the layer. Each tile's products start from a
// zero accumulator, so that the partial's sum over a warp's tiles rounds as
// f32 adds do, whatever mma's accumulator does.
__device__ __forceinline__ void add_tile(float* dw, int d_in_l, int d_out,
                                         int k0, int j0, int lane,
                                         const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + (lane >> 2) + 8 * (e >> 1);
    const int j = j0 + 2 * (lane & 3) + (e & 1);
    if (k < d_in_l && j < d_out) dw[k * d_out + j] += c[e];
  }
}

// dW += A^T B over the tile's 32 rows for one layer: A^T from a stash slot
// (rows of CA chunks, d_in_l features), B from the dpre buffer (rows of
// KW / 8 chunks, d_out columns); dw: the layer's block of the warp's flat
// partial. Rows are mma's K: two slabs of 16, in order.
template <int KW>
__device__ __forceinline__ void dw_sums(const char* a_slot, int CA,
                                        int d_in_l, int d_out,
                                        const char* buf, int lane,
                                        float* dw) {
  constexpr int NT = KW / 8;
  const int q = lane >> 3, i = lane & 7;
  for (int mt = 0; mt < (d_in_l + 15) / 16; ++mt) {
    float c[NT][4] = {};
#pragma unroll
    for (int s = 0; s < ROWS / 16; ++s) {
      uint32_t a[4];
      ldsm_x4_trans(a, a_slot + swz(16 * s + 8 * (q >> 1) + i,
                                    2 * mt + (q & 1), CA));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (16 * np >= d_out) break;
        uint32_t b[4];
        ldsm_x4_trans(b, buf + swz(16 * s + 8 * (q & 1) + i,
                                   2 * np + (q >> 1), KW / 8));
        mma(c[2 * np], a, b[0], b[1]);
        mma(c[2 * np + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= d_out) break;
      add_tile(dw, d_in_l, d_out, 16 * mt, 8 * nt, lane, c[nt]);
    }
  }
}

// the sum of v over the warp's 32 lanes (lane 0's is the one used)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One halving exchange: lanes with bit `o` set keep the upper HALF of v,
// the others the lower, each adding its partner's copy of what it keeps.
template <int HALF>
__device__ __forceinline__ void fold(float* v, int lane, int o) {
  const bool upper = lane & o;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, o);
  }
}

// The sums over the warp's 32 lanes of each of v[0..N), N = 16 or 32, by
// halving exchanges in a fixed order (N - 1 shuffles, not 5 N): returns
// the sum of column lane (N = 32) or lane >> 1 (N = 16, where lanes 2 i
// and 2 i + 1 hold the same one).
template <int N>
__device__ __forceinline__ float column_sums(float (&v)[N], int lane) {
  if constexpr (N == 32) fold<16>(v, lane, 16);
  fold<8>(v, lane, N == 32 ? 8 : 16);
  fold<4>(v, lane, N == 32 ? 4 : 8);
  fold<2>(v, lane, N == 32 ? 2 : 4);
  fold<1>(v, lane, N == 32 ? 1 : 2);
  if constexpr (N == 16) v[0] += __shfl_xor_sync(FULL, v[0], 1);
  return v[0];
}

// sum over j < W, in order from 0, of dp[j] wt(k, j): csrc/trunk.cu's
// order for dh, and the plain version's
template <int W, int KW>
__device__ __forceinline__ float dot_j(const float (&dp)[KW],
                                       const PairWeights& wt, int k) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) s = fmaf(dp[j], wt(k, j), s);
  return s;
}

// dy0/dy1: the head's (dloc, draw), each (n,); trunk only: dy0 is the
// (n, out_w) cotangent of the last layer's activations and dy1 is unused.
template <int W>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
trunk_bwd_bf16_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ b,
                      const float* __restrict__ dy0,
                      const float* __restrict__ dy1, float* __restrict__ dx,
                      float* __restrict__ part, int n, int d_in, int L,
                      int out_w, bool head, float leak) {
  constexpr int KW = kernel_kw(W), CA = KW / 8;
  constexpr int slot = ROWS * KW * 2;    // bytes of a layer's stash
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  const Layout lay(d_in, W, L, head);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int CX = lay.dx / 8;             // chunks of a stash row of x
  const int nw = n_weights(d_in, W, L, head);
  const int nb = n_biases(W, L, head);
  float* sb = reinterpret_cast<float*>(base);
  uint32_t* ws = reinterpret_cast<uint32_t*>(base + lay.bias);
  char* mine = base + lay.params + warp * lay.warp;
  float* acc = reinterpret_cast<float*>(mine);  // dW then db, flat
  float* accb = acc + nw;
  uint32_t* masks = reinterpret_cast<uint32_t*>(mine + lay.acc);
  char* xs = mine + lay.acc + lay.masks;        // bf16(x)
  char* acts = xs + ROWS * lay.dx * 2;   // bf16(a_l) at acts + (l-1) slot
  char* buf = xs + lay.stash;            // bf16(dpre), rows as K of dW

  for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = b[i];
  stage_weights(w, ws, lay.pairs, d_in, W, L, head);
  for (int i = lane; i < lay.acc / 16; i += 32)
    reinterpret_cast<uint4*>(mine)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const auto layer_w = [&](int l) {
    return PairWeights{
        ws + (l == 0 ? 0 : (d_in + (l - 1) * W) * lay.pairs),
        l == L ? 1 : lay.pairs};
  };

  const int n_tiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x * warps + warp; tile < n_tiles;
       tile += gridDim.x * warps) {
    const int row = tile * ROWS + lane;
    const bool valid = row < n;

    // the forward in K1-fwd's order (trunk_common.cuh), keeping bf16(x),
    // bf16(a_1..a_L) and the f32 signs of a_1..a_L
    float h[W];
    {
      float pre[W];
#pragma unroll
      for (int j = 0; j < W; ++j) pre[j] = 0.f;
      const float* xg = x + static_cast<size_t>(valid ? row : 0) * d_in;
      const PairWeights w0 = layer_w(0);
      for (int q = 0; q < CX; ++q) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = 8 * q + e;
          v[e] = valid && k < d_in ? xg[k] : 0.f;
        }
        uint32_t u[4];
        round_row<8, 8, 8>(v, u);
        *reinterpret_cast<uint4*>(xs + swz(lane, q, CX)) =
            make_uint4(u[0], u[1], u[2], u[3]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * q + e < d_in) axpy_k<W>(pre, v[e], 8 * q + e, w0);
      }
      bias_leaky<W>(h, pre, sb, leak);
    }
    for (int l = 0;; ++l) {
      // h = a_{l+1}: its mask, and its rounding into the stash
      uint32_t m = 0u;
#pragma unroll
      for (int j = 0; j < W; ++j) m |= (h[j] >= 0.f ? 1u : 0u) << j;
      masks[l * ROWS + lane] = m;
      uint32_t u[KW / 2];
      round_row<W, W, KW>(h, u);
      store_row<KW>(acts + l * slot, lane, u);
      if (l + 1 == L) break;
      // h is read whole into the sums before it is overwritten
      dense_layer<W>(h, h, layer_w(l + 1), sb + (l + 1) * W, leak);
    }
    __syncwarp();

    // the backward, one row a lane: dh and dpre in f32 registers
    float dh[W];
    if (head) {
      // dpre = (dloc, draw); dh = bf16(dpre) bf16(W_L)^T, as csrc/trunk.cu
      const float d0 = valid ? dy0[row] : 0.f;
      const float d1 = valid ? dy1[row] : 0.f;
      const float s0 = warp_sum(d0), s1 = warp_sum(d1);
      if (lane == 0) {
        accb[L * W] += s0;
        accb[L * W + 1] += s1;
      }
      const PairWeights wh = layer_w(L);
      const uint32_t u = pack2(d0, d1);
      const float r0 = unpack(u, 0), r1 = unpack(u, 1);
#pragma unroll
      for (int k = 0; k < W; ++k)
        dh[k] = fmaf(r0, wh(k, 0), r1 * wh(k, 1));
      // (dloc, draw) as columns 0 and 1 of the buffer, for the head's dW
      *reinterpret_cast<uint4*>(buf + swz(lane, 0, CA)) =
          make_uint4(u, 0u, 0u, 0u);
      __syncwarp();
      dw_sums<KW>(acts + (L - 1) * slot, CA, W, 2, buf, lane,
                  acc + w_offset(L, d_in, W));
      __syncwarp();
    } else {
      const float* dr = dy0 + static_cast<size_t>(valid ? row : 0) * out_w;
#pragma unroll
      for (int j = 0; j < W; ++j) dh[j] = valid && j < out_w ? dr[j] : 0.f;
    }

    for (int l = L - 1; l >= 0; --l) {
      // dpre_l in f32: slope 1 where a_{l+1} >= 0 (fused_mlp.py:141)
      const uint32_t m = masks[l * ROWS + lane];
      float dp[KW];
#pragma unroll
      for (int j = 0; j < W; ++j) dp[j] = (m >> j) & 1u ? dh[j] : leak * dh[j];
#pragma unroll
      for (int j = W; j < KW; ++j) dp[j] = 0.f;
      // db_l: the column sums of the f32 dpre over the tile's rows
      {
        float v[KW];
#pragma unroll
        for (int j = 0; j < KW; ++j) v[j] = dp[j];
        const float s = column_sums<KW>(v, lane);
        const int col = KW == 32 ? lane : lane >> 1;
        if ((KW == 32 || (lane & 1) == 0) && col < W)
          accb[l * W + col] += s;
      }
      // bf16(dpre) into the buffer, dW's B operand with rows as K; then
      // dh_l = bf16(dpre) bf16(W_l)^T in order of j, csrc/trunk.cu's (and
      // the plain version's) order, so that dpre_{l-1} is their f32 value
      // and rounds to bf16 as theirs does
      uint32_t u[KW / 2];
      round_row<KW, W, KW>(dp, u);
      store_row<KW>(buf, lane, u);
      const PairWeights wl = layer_w(l);
      if (l > 0) {
#pragma unroll
        for (int k = 0; k < W; ++k) dh[k] = dot_j<W, KW>(dp, wl, k);
      } else if (dx != nullptr && valid) {
        float* dxr = dx + static_cast<size_t>(row) * d_in;
        for (int k = 0; k < d_in; ++k) dxr[k] = dot_j<W, KW>(dp, wl, k);
      }
      __syncwarp();
      // dW_l += bf16(a_l)^T bf16(dpre_l)
      if (l > 0)
        dw_sums<KW>(acts + (l - 1) * slot, CA, W, W, buf, lane,
                    acc + w_offset(l, d_in, W));
      else
        dw_sums<KW>(xs, CX, d_in, W, buf, lane, acc);
      __syncwarp();
    }
  }
  __syncthreads();
  // the block's partial, its warps' in warp order: dW of every layer
  // (d_in_l, d_out) row-major, the head's (W, 2), then db
  const float* parts = reinterpret_cast<const float*>(base + lay.params);
  float* out = part + static_cast<size_t>(blockIdx.x) * (nw + nb);
  for (int i = threadIdx.x; i < nw + nb; i += blockDim.x) {
    float v = 0.f;
    for (int wp = 0; wp < warps; ++wp) v += parts[wp * (lay.warp / 4) + i];
    out[i] = v;
  }
}

// the shared memory of a block of `rows` rows (rows / 32 warps)
size_t bwd_bf16_smem(int d_in, int W, int L, bool head, int rows) {
  return static_cast<size_t>(Layout(d_in, W, L, head).total(rows / ROWS));
}

template <int W>
cudaError_t launch(const float* x, const float* w, const float* b,
                   const float* dy0, const float* dy1, float* dx, float* part,
                   float* out, int n, int d_in, int L, int out_w, bool head,
                   int rows, int n_blocks, float leak, cudaStream_t stream) {
  const size_t smem = bwd_bf16_smem(d_in, W, L, head, rows);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_bf16_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  trunk_bwd_bf16_kernel<W><<<n_blocks, rows, smem, stream>>>(
      x, w, b, dy0, dy1, dx, part, n, d_in, L, out_w, head, leak);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = n_weights(d_in, W, L, head) + n_biases(W, L, head);
  return reduce_blocks(part, out, n_blocks, size, size, stream);
}

}  // namespace

// As csrc/trunk_bwd.cu's ct_trunk_bwd_f32, with bf16 operands: dy0, dy1
// the cotangents; tile: the block's rows (its size), whole warps of ROWS
// rows, at most MAX_WARPS of them; part: (n_blocks,
// nw + nb) scratch; out: (nw + nb) = [dW flat, db flat]; dx may be null.
CT_API int ct_trunk_bwd_bf16(const float* x, const float* w, const float* b,
                             const float* dy0, const float* dy1, float* dx,
                             float* part, float* out, int n, int d_in,
                             int width, int n_layers, int head, int out_w,
                             int tile, int n_blocks, float leak,
                             void* stream) {
  if (n_layers < 1 || d_in < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  if (tile < ROWS || tile > MAX_WARPS * ROWS || tile % ROWS)
    return cudaErrorInvalidValue;
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
CT_API size_t ct_trunk_bwd_bf16_smem(int d_in, int width, int n_layers,
                                     int head, int tile) {
  return bwd_bf16_smem(d_in, width, n_layers, head != 0, tile);
}

