// Design variants of the gathers K2 and K5, timed side by side by
// tools/gather_variants.py. Not part of the port: careless_tpu_torch/csrc
// holds the kernels it runs (K2's kept variant is csrc/gather.cu, K5's
// csrc/gather_stream.cu); these are the alternatives they were measured
// against, and the earlier K5, which stages its window synchronously.
#include <cuda_runtime.h>
#include <stdint.h>
#define API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float ld_el(const float* p, uint64_t keep) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(keep));
  return v;
}
__device__ __forceinline__ uint64_t pol_last() {
  uint64_t k;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(k));
  return k;
}
__device__ __forceinline__ uint64_t pol_first() {
  uint64_t k;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(k));
  return k;
}

// PER ids per thread; MODE 0: table by __ldg, 1: with an L2 evict_last
// policy; CS: ids and out with evict-first hints (__ldcs, __stcs)
template <int PER, int MODE, bool CS>
__global__ void __launch_bounds__(256) kvar(const float* __restrict__ table,
                                            const int* __restrict__ ids,
                                            float* __restrict__ out, long long n) {
  uint64_t keep = 0;
  if (MODE) keep = pol_last();
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long first = PER * q;
  auto tab = [&](int i) -> float {
    if (MODE == 0) return __ldg(table + i);
    return ld_el(table + i, keep);
  };
  if (first + PER <= n) {
    const int4* src = reinterpret_cast<const int4*>(ids + first);
    float4* dst = reinterpret_cast<float4*>(out + first);
    int4 v[PER / 4];
#pragma unroll
    for (int k = 0; k < PER / 4; ++k) v[k] = CS ? __ldcs(src + k) : src[k];
#pragma unroll
    for (int k = 0; k < PER / 4; ++k) {
      float4 o = make_float4(tab(v[k].x), tab(v[k].y), tab(v[k].z), tab(v[k].w));
      if (CS) __stcs(dst + k, o); else dst[k] = o;
    }
  } else {
    for (long long k = first; k < n; ++k) out[k] = tab(ids[k]);
  }
}

// 8 ids per thread, evict_first policy on the streams, evict_last on the
// table
__global__ void __launch_bounds__(256) kef8(const float* __restrict__ table,
                                            const int* __restrict__ ids,
                                            float* __restrict__ out, long long n) {
  const uint64_t keep = pol_last(), drop = pol_first();
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long first = 8 * q;
  if (first + 8 <= n) {
    int a[8];
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0,%1,%2,%3}, [%4], %5;"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "l"(ids + first), "l"(drop));
    asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 {%0,%1,%2,%3}, [%4], %5;"
        : "=r"(a[4]), "=r"(a[5]), "=r"(a[6]), "=r"(a[7]) : "l"(ids + first + 4), "l"(drop));
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = ld_el(table + a[k], keep);
    asm volatile("st.global.L1::no_allocate.L2::cache_hint.v4.f32 [%0], {%1,%2,%3,%4}, %5;"
        :: "l"(out + first), "f"(o[0]), "f"(o[1]), "f"(o[2]), "f"(o[3]), "l"(drop) : "memory");
    asm volatile("st.global.L1::no_allocate.L2::cache_hint.v4.f32 [%0], {%1,%2,%3,%4}, %5;"
        :: "l"(out + first + 4), "f"(o[4]), "f"(o[5]), "f"(o[6]), "f"(o[7]), "l"(drop) : "memory");
  } else {
    for (long long k = first; k < n; ++k) out[k] = ld_el(table + ids[k], keep);
  }
}

// the earlier K5 kernel, for a same-call comparison
__global__ void __launch_bounds__(1024) k5_old(const float* __restrict__ table, long long t,
                                               const int* __restrict__ ids,
                                               const int* __restrict__ bases,
                                               float* __restrict__ out, int tile, int window) {
  extern __shared__ float4 win4[];
  float* win = reinterpret_cast<float*>(win4);
  const long long lo = 128LL * bases[blockIdx.x];
  const int span = window * 128;
  const float4* src = reinterpret_cast<const float4*>(table + lo);
  for (int q = threadIdx.x; q < span / 4; q += 1024) {
    const long long g = lo + 4LL * q;
    float4 v;
    if (g + 4 <= t) {
      v = __ldg(src + q);
    } else {
      v.x = g < t ? table[g] : 0.0f;
      v.y = g + 1 < t ? table[g + 1] : 0.0f;
      v.z = g + 2 < t ? table[g + 2] : 0.0f;
      v.w = 0.0f;
    }
    win4[q] = v;
  }
  __syncthreads();
  const long long first = (long long)blockIdx.x * tile;
  const int4* ids4 = reinterpret_cast<const int4*>(ids + first);
  float4* out4 = reinterpret_cast<float4*>(out + first);
  for (int q = threadIdx.x; q < tile / 4; q += 1024) {
    const int4 v = ids4[q];
    auto pick = [&](int id) {
      const long long off = (long long)id - lo;
      return (off >= 0 && off < span) ? win[off] : 0.0f;
    };
    out4[q] = make_float4(pick(v.x), pick(v.y), pick(v.z), pick(v.w));
  }
}

template <int PER>
static int blocks(long long n) { return (int)(((n + PER - 1) / PER + 255) / 256); }

// variant 0 is the earlier K2 (no cache hints); 1 is csrc/gather.cu's design
API int kv_launch(int variant, const float* table, const int* ids, float* out, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: kvar<4, 0, false><<<blocks<4>(n), 256, 0, s>>>(table, ids, out, n); break;
    case 1: kvar<4, 0, true><<<blocks<4>(n), 256, 0, s>>>(table, ids, out, n); break;
    case 2: kvar<4, 1, true><<<blocks<4>(n), 256, 0, s>>>(table, ids, out, n); break;
    case 3: kvar<8, 0, true><<<blocks<8>(n), 256, 0, s>>>(table, ids, out, n); break;
    case 4: kvar<8, 1, true><<<blocks<8>(n), 256, 0, s>>>(table, ids, out, n); break;
    case 5: kef8<<<blocks<8>(n), 256, 0, s>>>(table, ids, out, n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

API int k5_old_launch(const float* table, long long t, const int* ids, const int* bases,
                      float* out, int n_tiles, int tile, int window, void* stream) {
  const size_t smem = (size_t)window * 512;
  cudaError_t err = cudaFuncSetAttribute(k5_old, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k5_old<<<n_tiles, 1024, smem, (cudaStream_t)stream>>>(table, t, ids, bases, out, tile, window);
  return cudaGetLastError();
}
