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
// Of the four output words, r0 gives u1 and r1 gives u2, each from its top
// 24 bits mapped to (0, 1] as (k + 1) * 2^-24, so log() never sees 0 and the
// TPU kernel's clamp spike at |x| ~ 7.4 cannot occur (the largest |x| is
// sqrt(-2 log 2^-24) = 5.77). x = sqrt(-2 log u1) cos(2 pi u2). Built without
// --use_fast_math: logf, sqrtf and cosf are the accurate versions, so the
// plain PyTorch version, which implements the same Philox bit for bit,
// matches the uniforms exactly and the normals to a few ulp.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ inline void philox4x32_10(uint32_t c[4], uint32_t k0,
                                     uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__global__ void philox_normal_kernel(float* __restrict__ out,
                                     uint32_t* __restrict__ bits, int n,
                                     uint32_t k0, uint32_t k1,
                                     uint64_t offset) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t ctr = offset + static_cast<uint64_t>(i);
  uint32_t c[4] = {static_cast<uint32_t>(ctr),
                   static_cast<uint32_t>(ctr >> 32), 0u, 0u};
  philox4x32_10(c, k0, k1);
  const float u1 = static_cast<float>((c[0] >> 8) + 1u) * 5.9604644775390625e-8f;
  const float u2 = static_cast<float>((c[1] >> 8) + 1u) * 5.9604644775390625e-8f;
  const float r = sqrtf(-2.0f * logf(u1));
  out[i] = r * cosf(6.28318548202514648f * u2);
  if (bits != nullptr) {
    bits[2 * i] = c[0];
    bits[2 * i + 1] = c[1];
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
