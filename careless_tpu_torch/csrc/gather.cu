// K2: table gather, out[k] = table[ids[k]] for static ids.
//
// Replaces careless_tpu/ops/table_gather.py:windowed_gather (kernel _kernel).
// The TPU kernel resolved ids window by window because Mosaic has no
// general in-kernel gather; its 128-entry window chunks and per-tile bases
// were VMEM mechanics and are not ported.
//
// What bounds it on the H100: bytes. A 1M-entry gather reads 4 MB of ids and
// writes 4 MB of output (plus one read of the table, 200 KB for z_f at 50k
// reflections, 8 KB for 2k image scales), ~2.5 us at 3.35 TB/s. The tables
// stay resident in the 50 MB L2, so the random reads are L2 hits.
//
// Design: one thread per four outputs, with one 16-byte load of ids and one
// 16-byte store of out; the ragged tail goes one element at a time. The
// plan validates the id range on the host once, so the kernel does no
// bounds checks beyond the ragged edge.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ ids,
                              float* __restrict__ out, int n) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long first = 4 * q;
  if (first + 3 < n) {
    const int4 v = reinterpret_cast<const int4*>(ids)[q];
    reinterpret_cast<float4*>(out)[q] =
        make_float4(__ldg(table + v.x), __ldg(table + v.y),
                    __ldg(table + v.z), __ldg(table + v.w));
  } else {
    for (long long k = first; k < n; ++k) out[k] = __ldg(table + ids[k]);
  }
}

}  // namespace

// ids and out must be 16-byte aligned (the wrapper checks)
CT_API int ct_gather(const float* table, const int* ids, float* out, int n,
                     void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long quads = (static_cast<long long>(n) + 3) / 4;
  gather_kernel<<<ct_blocks(quads, THREADS), THREADS, 0, ct_stream(stream)>>>(
      table, ids, out, n);
  return cudaGetLastError();
}

CT_API const char* ct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
