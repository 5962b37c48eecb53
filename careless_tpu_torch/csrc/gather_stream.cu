// K5: streaming windowed gather, out[k] = table[ids[k]] with per-tile
// windows, for tables too large to stay near the SMs (the Laue chain
// layout's backward permute: the "table" is the (N,) cotangent itself).
//
// Replaces careless_tpu/ops/table_gather.py:windowed_gather_stream (kernel
// _stream_kernel). Its contract is kept: ids come in tiles of `tile`
// entries; tile i resolves only ids inside table entries
// [128 base_i, 128 (base_i + window)), anything else gives 0, and the table
// reads as zeros past its end. The TPU kernel's rounding of the window to
// 8 rows was sublane alignment and is not ported.
//
// What bounds it on the H100: bytes. Each id is read once and each output
// written once (8 bytes per entry), and the table needs one read (4 bytes
// per entry): 120 MB at 10M entries, ~36 us at 3.35 TB/s. The windows of
// neighbouring tiles overlap, so the kernel stages more than the table
// (n_tiles * window * 512 bytes); the overlap is read again from L2.
//
// Design: one block per tile. The block copies its window into dynamic
// shared memory with 16-byte loads (zeros past the table's end), the
// counterpart of the TPU kernel's window DMA, then resolves its ids from
// shared memory with 16-byte loads of ids and 16-byte stores of out. At the
// Laue chain layout's 160-chunk cap the window is 80 KB, so two blocks of
// 1024 threads fill an SM.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int LANES = 128;

__device__ __forceinline__ float pick(const float* win, long long lo,
                                      long long span, int id) {
  const long long off = static_cast<long long>(id) - lo;
  return (off >= 0 && off < span) ? win[off] : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
    gather_stream_kernel(const float* __restrict__ table, long long t,
                         const int* __restrict__ ids,
                         const int* __restrict__ bases,
                         float* __restrict__ out, int tile, int window) {
  extern __shared__ float4 win4[];
  float* win = reinterpret_cast<float*>(win4);
  const long long lo = static_cast<long long>(LANES) * bases[blockIdx.x];
  const int span = window * LANES;
  // table + lo is 16-byte aligned: the table is (the wrapper checks) and lo
  // is a multiple of 128 entries
  const float4* src = reinterpret_cast<const float4*>(table + lo);
  for (int q = threadIdx.x; q < span / 4; q += THREADS) {
    const long long g = lo + 4LL * q;
    float4 v;
    if (g + 4 <= t) {
      v = __ldg(src + q);
    } else {
      v.x = g < t ? table[g] : 0.0f;
      v.y = g + 1 < t ? table[g + 1] : 0.0f;
      v.z = g + 2 < t ? table[g + 2] : 0.0f;
      v.w = 0.0f;  // g + 3 >= t here
    }
    win4[q] = v;
  }
  __syncthreads();
  // ids and out are 16-byte aligned (the wrapper checks) and every tile
  // starts at a multiple of 128 entries
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const int4* ids4 = reinterpret_cast<const int4*>(ids + first);
  float4* out4 = reinterpret_cast<float4*>(out + first);
  for (int q = threadIdx.x; q < tile / 4; q += THREADS) {
    const int4 v = ids4[q];
    out4[q] = make_float4(pick(win, lo, span, v.x), pick(win, lo, span, v.y),
                          pick(win, lo, span, v.z), pick(win, lo, span, v.w));
  }
}

}  // namespace

// tile = block_rows * 128; table, ids (n_tiles * tile) and out 16-byte
// aligned; window * 512 bytes must fit in a block's shared memory (the
// wrapper checks against the card's 227 KB)
CT_API int ct_gather_stream(const float* table, long long t, const int* ids,
                            const int* bases, float* out, int n_tiles,
                            int tile, int window, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(window) * LANES * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gather_stream_kernel<<<n_tiles, THREADS, smem, ct_stream(stream)>>>(
      table, t, ids, bases, out, tile, window);
  return cudaGetLastError();
}
