// Philox4x32-10 and its Box-Muller normal, shared by K3 (philox.cu) and K4
// (fused_ll.cu), so that both draw bitwise the same eps for one (key,
// counter).
//
// Counter c = (c0, c1, 0, 0) holds a 64-bit element index; the key is the
// 64-bit seed split into (k0, k1). Of the four output words, r0 gives u1 and
// r1 gives u2, each from its top 24 bits mapped to (0, 1] as
// (k + 1) * 2^-24, so log() never sees 0 (the largest |x| is
// sqrt(-2 log 2^-24) = 5.77). x = sqrt(-2 log u1) cos(2 pi u2). The last
// product is __fmul_rn so that no caller's arithmetic can fuse it into an
// FMA: an eps drawn here equals, bit for bit, the same eps read from memory.
#pragma once

#include "common.cuh"

__device__ __forceinline__ void ct_philox4x32_10(uint32_t c[4], uint32_t k0,
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

// the standard normal at 64-bit counter ctr; r0, r1 receive the two words
__device__ __forceinline__ float ct_philox_normal(uint64_t ctr, uint32_t k0,
                                                  uint32_t k1, uint32_t* r0,
                                                  uint32_t* r1) {
  uint32_t c[4] = {static_cast<uint32_t>(ctr),
                   static_cast<uint32_t>(ctr >> 32), 0u, 0u};
  ct_philox4x32_10(c, k0, k1);
  *r0 = c[0];
  *r1 = c[1];
  constexpr float TWO_M24 = 5.9604644775390625e-8f;  // 2^-24
  const float u1 = static_cast<float>((c[0] >> 8) + 1u) * TWO_M24;
  const float u2 = static_cast<float>((c[1] >> 8) + 1u) * TWO_M24;
  const float r = sqrtf(-2.0f * logf(u1));
  return __fmul_rn(r, cosf(6.28318548202514648f * u2));
}
