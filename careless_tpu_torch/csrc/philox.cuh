// Philox4x32-10 and its Box-Muller normals, shared by K3 (philox.cu) and K4
// (fused_ll.cu), so that both draw bitwise the same eps for one (key,
// element index).
//
// Element e (a 64-bit index) lies in Philox block e >> 2, at slot e & 3.
// The block's counter is (e >> 2) in words 0 and 1 (words 2 and 3 zero);
// the key is the 64-bit seed split into (k0, k1). The block's four output
// words r0..r3 give two Box-Muller pairs: slots 0 and 1 are
// R(r0) cos(2 pi u(r1)) and R(r0) sin(2 pi u(r1)), slots 2 and 3 the same
// of (r2, r3). u(r) maps the top 24 bits to (0, 1] as (k + 1) * 2^-24, so
// log() never sees 0, and R(r) = sqrt(-2 log u(r)) (the largest |x| is
// sqrt(-2 log 2^-24) = 5.77). sincosf gives both of a pair at once; K4,
// which needs one, calls it too, so that its value is K3's. The last
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

constexpr float CT_TWO_M24 = 5.9604644775390625e-8f;  // 2^-24
constexpr float CT_TWO_PI = 6.28318548202514648f;

// the output words of Philox block `blk` under key (k0, k1)
__device__ __forceinline__ void ct_philox_block(uint64_t blk, uint32_t k0,
                                                uint32_t k1, uint32_t c[4]) {
  c[0] = static_cast<uint32_t>(blk);
  c[1] = static_cast<uint32_t>(blk >> 32);
  c[2] = 0u;
  c[3] = 0u;
  ct_philox4x32_10(c, k0, k1);
}

// the Box-Muller pair of words (ra, rb): (R cos, R sin)
__device__ __forceinline__ void ct_box_muller(uint32_t ra, uint32_t rb,
                                              float* x_cos, float* x_sin) {
  const float u1 = static_cast<float>((ra >> 8) + 1u) * CT_TWO_M24;
  const float u2 = static_cast<float>((rb >> 8) + 1u) * CT_TWO_M24;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(CT_TWO_PI * u2, &s, &c);
  *x_cos = __fmul_rn(r, c);
  *x_sin = __fmul_rn(r, s);
}

// the standard normal of element e; ra, rb receive the two words it used
__device__ __forceinline__ float ct_philox_normal(uint64_t e, uint32_t k0,
                                                  uint32_t k1, uint32_t* ra,
                                                  uint32_t* rb) {
  uint32_t c[4];
  ct_philox_block(e >> 2, k0, k1, c);
  const int slot = static_cast<int>(e & 3);
  *ra = slot < 2 ? c[0] : c[2];
  *rb = slot < 2 ? c[1] : c[3];
  float xc, xs;
  ct_box_muller(*ra, *rb, &xc, &xs);
  return slot & 1 ? xs : xc;
}
