// K2: table gather, out[k] = table[ids[k]] for static ids.
//
// Replaces careless_tpu/ops/table_gather.py:windowed_gather (kernel _kernel).
// The TPU kernel resolved ids window by window because Mosaic has no
// general in-kernel gather; its 128-entry window chunks and per-tile bases
// were VMEM mechanics and are not ported.
//
// What bounds it on the H100: bytes, at the mono shapes. A gather of n
// entries reads 4n bytes of ids, writes 4n bytes of output and needs one
// read of the table: 1M ids into the 50k-entry z_f table or the 2k-entry
// image table take ~2.5 us at 3.35 TB/s, with the table resident in L2.
// At the Laue step's image cotangent permute (10M random ids into a 10M
// table) the bound is the random table reads instead: each 4-byte read
// costs a whole 32-byte sector request, and index_select, 8 ids per thread
// and L2 evict-last / evict-first cache policies all take the same time
// there (PERF.md; tools/gather_variants.py).
//
// Design: one thread per four outputs, with one 16-byte load of ids and one
// 16-byte store of out; the ragged tail goes one element at a time. The ids
// are loaded and the output stored with evict-first hints (ld.global.cs,
// st.global.cs): each is touched once, and the table keeps the L2. No
// access-policy window is set: that is stream state other kernels would
// inherit. The plan validates the id range on the host once, so the kernel
// does no bounds checks beyond the ragged edge.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const float* __restrict__ table,
                  const int* __restrict__ ids, float* __restrict__ out,
                  long long n) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long first = 4 * q;
  if (first + 4 <= n) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(ids) + q);
    __stcs(reinterpret_cast<float4*>(out) + q,
           make_float4(__ldg(table + v.x), __ldg(table + v.y),
                       __ldg(table + v.z), __ldg(table + v.w)));
  } else {
    for (long long k = first; k < n; ++k)
      out[k] = __ldg(table + __ldcs(ids + k));
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
