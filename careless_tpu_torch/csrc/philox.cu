// K3: standard normals from a counter-based Philox4x32-10 generator.
//
// Replaces careless_tpu/ops/fused_elbo.py:prng_normal_probe (through
// prng_normal), which drew Box-Muller normals from the TPU's in-kernel
// PRNG with 23-bit uniforms, u1 clamped at 1e-12 and a seed of seed + block.
//
// What bounds it on the H100: bytes (4 MB written per 1M normals, ~1.2 us at
// 3.35 TB/s). Ten Philox rounds are ~40 integer operations (mostly IMAD.HI,
// IMAD and LOP3) per block of four normals, plus a log, a sqrt and a
// sincos per pair.
//
// Design: element i of a call with key (seed_lo, seed_hi) and offset o is
// the normal of absolute index e = o + i (philox.cuh): slot e & 3 of Philox
// block e >> 2, so two calls with one key and disjoint [o, o + n) ranges
// never share a value, and a call split in two gives the same stream. One
// thread computes one block and writes its up-to-four elements of the call:
// one 16-byte store where the block lies whole in the call and o is a
// multiple of 4 (its elements then start 16-byte aligned), else scalar
// stores for the head and tail of an unaligned range. So each block's
// integer work serves four normals (a draw of one normal per block cost four
// times as much). The generator lives in philox.cuh, which K4 (fused_ll.cu)
// shares, so both draw the same eps for one (key, index). The TPU kernel's
// clamp spike at |x| ~ 7.4 cannot occur. Built without --use_fast_math:
// logf, sqrtf and sincosf are the accurate versions, so the plain PyTorch
// version, which implements the same Philox bit for bit, matches the words
// exactly and the normals to a few ulp.
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void philox_normal_kernel(float* __restrict__ out,
                                     uint32_t* __restrict__ bits, int n,
                                     int n_blocks, uint32_t k0, uint32_t k1,
                                     uint64_t offset) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_blocks) return;
  const uint64_t blk = (offset >> 2) + static_cast<uint64_t>(t);
  uint32_t c[4];
  ct_philox_block(blk, k0, k1, c);
  float x[4];
  ct_box_muller(c[0], c[1], &x[0], &x[1]);
  ct_box_muller(c[2], c[3], &x[2], &x[3]);
  // the call's index of the block's slot 0 (negative for a head block)
  const long long i0 = static_cast<long long>(4 * blk - offset);
  if ((offset & 3) == 0 && i0 + 4 <= n) {
    reinterpret_cast<float4*>(out)[t] = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const long long i = i0 + s;
      if (i >= 0 && i < n) out[i] = x[s];
    }
  }
  if (bits != nullptr) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const long long i = i0 + s;
      if (i >= 0 && i < n)
        reinterpret_cast<uint2*>(bits)[i] =
            s < 2 ? make_uint2(c[0], c[1]) : make_uint2(c[2], c[3]);
    }
  }
}

}  // namespace

// bits may be null; when given, it receives per element the two words it
// used, (n, 2): (r0, r1) for slots 0 and 1, (r2, r3) for slots 2 and 3.
// out must be 16-byte aligned (torch.empty's allocations are).
CT_API int ct_philox_normal(float* out, uint32_t* bits, int n,
                            uint32_t seed_lo, uint32_t seed_hi,
                            uint64_t offset, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int n_blocks = static_cast<int>(
      ((offset + n - 1) >> 2) - (offset >> 2) + 1);
  philox_normal_kernel<<<ct_blocks(n_blocks, THREADS), THREADS, 0,
                         ct_stream(stream)>>>(out, bits, n, n_blocks, seed_lo,
                                              seed_hi, offset);
  return cudaGetLastError();
}
