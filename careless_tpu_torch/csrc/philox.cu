// K3: standard normals from a counter-based Philox4x32-10 generator.
//
// Replaces careless_tpu/ops/fused_elbo.py:prng_normal_probe (through
// prng_normal), which drew Box-Muller normals from the TPU's in-kernel
// PRNG with 23-bit uniforms, u1 clamped at 1e-12 and a seed of seed + block.
//
// What bounds it on the H100: bytes (4 MB written per 1M normals, ~1.2 us at
// 3.35 TB/s); ten Philox rounds are ~40 integer operations per element.
//
// Design: element i of a call with key (seed_lo, seed_hi) and offset o uses
// the 64-bit counter o + i (words 0 and 1; words 2 and 3 are zero), so two
// calls with one key and disjoint [o, o + n) ranges never share a counter.
// The generator and its Box-Muller map live in philox.cuh, which K4
// (fused_ll.cu) shares, so both draw the same eps for one (key, counter).
// The TPU kernel's clamp spike at |x| ~ 7.4 cannot occur. Built without
// --use_fast_math: logf, sqrtf and cosf are the accurate versions, so the
// plain PyTorch version, which implements the same Philox bit for bit,
// matches the uniforms exactly and the normals to a few ulp.
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void philox_normal_kernel(float* __restrict__ out,
                                     uint32_t* __restrict__ bits, int n,
                                     uint32_t k0, uint32_t k1,
                                     uint64_t offset) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t r0, r1;
  out[i] = ct_philox_normal(offset + static_cast<uint64_t>(i), k0, k1, &r0,
                            &r1);
  if (bits != nullptr) {
    bits[2 * i] = r0;
    bits[2 * i + 1] = r1;
  }
}

}  // namespace

// bits may be null; when given, it receives (r0, r1) per element, (n, 2)
CT_API int ct_philox_normal(float* out, uint32_t* bits, int n,
                            uint32_t seed_lo, uint32_t seed_hi,
                            uint64_t offset, void* stream) {
  if (n <= 0) return cudaSuccess;
  philox_normal_kernel<<<ct_blocks(n, THREADS), THREADS, 0,
                         ct_stream(stream)>>>(out, bits, n, seed_lo, seed_hi,
                                              offset);
  return cudaGetLastError();
}
