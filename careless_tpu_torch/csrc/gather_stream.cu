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
// Design: one block per tile. As the TPU kernel starts its window DMA and
// reads its ids while the copy runs, one thread issues the window's
// in-bounds part as one bulk asynchronous copy (cp.async.bulk, the copy
// engine of Hopper's TMA) into dynamic shared memory, completing on an
// mbarrier; meanwhile the block writes the window's ragged edges and the
// zeros past the table's end, and loads its ids with an evict-first hint.
// Then it waits on the barrier and resolves the ids from shared memory,
// storing with an evict-first hint. The window sits in shared memory at the
// table's own alignment modulo 16 bytes, so any table alignment is copied
// without a host-side copy. At the Laue chain layout's 160-chunk cap the
// window is 80 KB, so two blocks of 1024 threads fill an SM.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int LANES = 128;
constexpr int MAX_DEVICES = 64;

// the largest dynamic shared memory set so far on each device
std::atomic<int> configured_smem[MAX_DEVICES];

// bytes of dynamic shared memory for a window of `window` rows: the
// mbarrier (padded to 16 bytes), then window * 128 floats and the up to 3
// floats the alignment shift adds, rounded up to 16 bytes
size_t smem_bytes(int window) {
  return 16 + sizeof(float) * (static_cast<size_t>(window) * LANES + 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float pick(const float* win, long long lo,
                                      long long span, int id) {
  const long long off = static_cast<long long>(id) - lo;
  return (off >= 0 && off < span) ? win[off] : 0.0f;
}

__device__ __forceinline__ float4 resolve(const float* win, long long lo,
                                          long long span, int4 v) {
  return make_float4(pick(win, lo, span, v.x), pick(win, lo, span, v.y),
                     pick(win, lo, span, v.z), pick(win, lo, span, v.w));
}

__global__ void __launch_bounds__(THREADS, 2)
    gather_stream_kernel(const float* __restrict__ table, long long t,
                         const int* __restrict__ ids,
                         const int* __restrict__ bases,
                         float* __restrict__ out, int tile, int window) {
  extern __shared__ float4 smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const long long lo = static_cast<long long>(LANES) * bases[blockIdx.x];
  const int span = window * LANES;
  // win[j] = table[lo + j]: win + j and table + lo + j share their address
  // modulo 16 bytes, so the 16-byte-aligned middle copies in bulk
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(table + lo) >> 2) & 3);
  float* win = reinterpret_cast<float*>(smem + 1) + shift;
  const long long left = t - lo;  // table entries from lo on
  const int valid = left <= 0 ? 0 : (left >= span ? span
                                                  : static_cast<int>(left));
  const int j0 = min((4 - shift) & 3, valid);  // first 16-byte boundary
  const int j1 = j0 + (valid - j0) / 4 * 4;    // end of the aligned middle
  const uint32_t bytes = 4u * static_cast<uint32_t>(j1 - j0);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(bar)),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && bytes > 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(win + j0)),
        "l"(table + lo + j0), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
  // while the copy runs: the ragged edges (< 4 entries each), the zeros
  // past the table's end, and this thread's ids
  if (threadIdx.x < j0) win[threadIdx.x] = table[lo + threadIdx.x];
  if (threadIdx.x < valid - j1)
    win[j1 + threadIdx.x] = table[lo + j1 + threadIdx.x];
  for (int j = valid + threadIdx.x; j < span; j += THREADS) win[j] = 0.0f;
  // ids and out are 16-byte aligned (the wrapper checks) and every tile
  // starts at a multiple of 128 entries
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const int4* ids4 = reinterpret_cast<const int4*>(ids + first);
  float4* out4 = reinterpret_cast<float4*>(out + first);
  const int quads = tile / 4;
  const int q0 = threadIdx.x, q1 = threadIdx.x + THREADS;
  int4 u = make_int4(0, 0, 0, 0), v = u;
  if (q0 < quads) u = __ldcs(ids4 + q0);
  if (q1 < quads) v = __ldcs(ids4 + q1);
  __syncthreads();  // the edges and zeros are in place
  if (bytes > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(smem_addr(bar)), "r"(0)
          : "memory");
    }
  }
  if (q0 < quads) __stcs(out4 + q0, resolve(win, lo, span, u));
  if (q1 < quads) __stcs(out4 + q1, resolve(win, lo, span, v));
  for (int q = q1 + THREADS; q < quads; q += THREADS)
    __stcs(out4 + q, resolve(win, lo, span, __ldcs(ids4 + q)));
}

}  // namespace

CT_API size_t ct_gather_stream_smem(int window) { return smem_bytes(window); }

// tile = block_rows * 128; ids (n_tiles * tile) and out 16-byte aligned, the
// table at any float alignment; smem_bytes(window) must fit in a block's
// shared memory (the wrapper checks against the card's 227 KB). The
// kernel's shared-memory limit is raised once per device, and again only
// for a wider window.
CT_API int ct_gather_stream(const float* table, long long t, const int* ids,
                            const int* bases, float* out, int n_tiles,
                            int tile, int window, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const int smem = static_cast<int>(smem_bytes(window));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > configured_smem[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(gather_stream_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    configured_smem[dev].store(smem, std::memory_order_relaxed);
  }
  gather_stream_kernel<<<n_tiles, THREADS, smem, ct_stream(stream)>>>(
      table, t, ids, bases, out, tile, window);
  return cudaGetLastError();
}
