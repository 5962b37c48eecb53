// K4: the fused per-observation likelihood chain of the ELBO, forward
// (K4-fwd) and backward (K4-bwd).
//
// Replaces careless_tpu/ops/fused_elbo.py:_fused_ll_fwd and _fused_ll_bwd
// (pallas_calls at :291 and :311, kernels _make_fwd_kernel and
// _make_bwd_kernel). Per observation i, with a = image scale and F = the
// reflection's sample, both gathered outside the kernel:
//
//     eps   = N(0, 1) of index offset + i (philox.cuh: slot (offset + i)
//             & 3 of a Philox block, bitwise K3's) or noise[i] when the
//             caller supplies it
//     z     = a loc + |a| scale eps
//     ipred = z F^2
//     fwd:  sum_i mask_i ll(iobs_i, sig_i, ipred_i)
//     bwd:  ct * (dloc, dscale, da, dF) per observation, and for the Ev11
//           kinds ct * sum_i mask_i d ll / d(sdfac, sdadd, sdb)
//
// ll is one of normal, studentt, laplace, normal_ev11 and studentt_ev11
// (fused_elbo.py:123-183); the Ev11 kinds widen the scale to
// s = sdfac sqrt(sig^2 + sdb softplus(ipred) + sdadd softplus(ipred)^2).
//
// What bounds it on the H100: bytes. At 1M observations the forward reads
// six f32 arrays (24 MB, ~7 us at 3.35 TB/s), the backward reads the same
// and writes four (40 MB, ~12 us). Philox, log, sqrt and sincos are ~60
// operations per observation, ~1 us of the card's f32 rate.
//
// Forward design: one launch over a resident grid (the caller sizes it from
// the SM count, ct_fused_ll_parts). A thread takes whole Philox blocks, the
// quads of observations whose indices offset + i share one block, striding
// over the grid: it draws the block once and feeds its two Box-Muller pairs
// to the quad's four observations (eps bitwise K3's, philox.cuh), reading
// the quad's inputs as 16-byte loads where offset is a multiple of 4 and
// every array is 16-byte aligned, else (and at a ragged head or tail quad)
// one float at a time. Each thread sums its observations in quad order,
// each warp by shuffles, each block its warps in order into one partial;
// the last block to finish (a device ticket that wraps back to 0 as it
// hands out the last number, so it is ready for the next launch) adds the
// partials in block order. So the loss repeats bit for bit, with supplied
// noise as with the kernel's own, and no second launch is needed. The
// TPU's (R, 128) lane layout and 8192-row blocks were VMEM mechanics and
// are not carried over. The backward keeps one thread per observation; its
// Ev11 sums take the same block sums and last-block ticket. The cotangent
// is read from device memory, so the backward needs no host sync. Calls
// that share a device must not overlap in time (one stream, as PyTorch
// issues them): the tickets are per device. Where the numbers could part
// from the JAX package's: sign(0) is 0 (never copysignf's +-1), softplus is
// max(x, 0) + log1p(exp(-|x|)) as logaddexp(0, x), and the sigmoid
// 1 / (1 + exp(-x)) gives 0 or 1, never NaN, for large |x| (exp overflows
// to inf, 1 / inf is 0). Built without --use_fast_math.
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;           // a block of either direction
constexpr int WARPS = THREADS / 32;
constexpr int FWD_BLOCKS_PER_SM = 4;   // the forward's resident grid

enum Kind { NORMAL = 0, STUDENTT = 1, LAPLACE = 2, NORMAL_EV11 = 3,
            STUDENTT_EV11 = 4 };

constexpr float HALF_LOG_2PI = 0.918938533204672742f;
constexpr float SQRT2 = 1.41421356237309505f;

// one per direction: the blocks of a launch that have written their
// partials; the last one's atomicInc wraps it back to 0 for the next
__device__ unsigned int fwd_ticket = 0;
__device__ unsigned int bwd_ticket = 0;

struct Args {
  const float* loc;
  const float* scale;
  const float* a;
  const float* f;
  const float* iobs;
  const float* sig;
  const float* mask;   // null: ones
  const float* noise;  // null: Philox
  const float* ev;     // (3,) sdfac, sdadd, sdb after softplus; Ev11 only
  int n;
  uint32_t k0, k1;
  uint64_t offset;
  float dof;
  float t_const;       // lgamma((dof+1)/2) - lgamma(dof/2) - log(dof pi)/2
};

template <int KIND>
__host__ __device__ constexpr bool is_ev11() {
  return KIND == NORMAL_EV11 || KIND == STUDENTT_EV11;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// (eps, a, loc, scale, z, F, ipred) of observation i
struct Chain {
  float eps, a, loc, scale, z, f, ipred;
};

template <bool NOISE>
__device__ __forceinline__ Chain chain(const Args& p, int i) {
  Chain c;
  if (NOISE) {
    c.eps = p.noise[i];
  } else {
    uint32_t ra, rb;
    c.eps = ct_philox_normal(p.offset + static_cast<uint64_t>(i), p.k0, p.k1,
                             &ra, &rb);
  }
  c.a = p.a[i];
  c.loc = p.loc[i];
  c.scale = p.scale[i];
  c.z = c.a * c.loc + fabsf(c.a) * c.scale * c.eps;
  c.f = p.f[i];
  c.ipred = c.z * c.f * c.f;
  return c;
}

// the likelihood's scale s, and softplus(ipred) for the Ev11 kinds
template <int KIND>
__device__ __forceinline__ float effective_scale(float sig, float ipred,
                                                 const float ev[3],
                                                 float* sp) {
  if (is_ev11<KIND>()) {
    *sp = softplus(ipred);
    const float u = sig * sig + ev[2] * *sp + ev[1] * *sp * *sp;
    return ev[0] * sqrtf(u);
  }
  *sp = 0.f;
  return sig;
}

template <int KIND>
__device__ __forceinline__ float pointwise_ll(float iobs, float sig,
                                              float ipred, const float ev[3],
                                              float dof, float t_const) {
  float sp;
  const float s = effective_scale<KIND>(sig, ipred, ev, &sp);
  const float r = (iobs - ipred) / s;
  if (KIND == NORMAL || KIND == NORMAL_EV11)
    return -0.5f * r * r - logf(s) - HALF_LOG_2PI;
  if (KIND == STUDENTT || KIND == STUDENTT_EV11)
    return t_const - logf(s) - 0.5f * (dof + 1.f) * log1pf(r * r / dof);
  return -logf(SQRT2 * s) - SQRT2 * fabsf(r);  // LAPLACE, scale sig / sqrt 2
}

// d ll / d ipred; for the Ev11 kinds also d ll / d(sdfac, sdadd, sdb)
template <int KIND>
__device__ __forceinline__ float pointwise_grads(float iobs, float sig,
                                                 float ipred,
                                                 const float ev[3], float dof,
                                                 float dev[3]) {
  float sp;
  const float s = effective_scale<KIND>(sig, ipred, ev, &sp);
  const float r = (iobs - ipred) / s;
  if (KIND == LAPLACE) return sgn(r) * SQRT2 / s;
  float base, t;  // t = s * d ll / d s
  if (KIND == NORMAL || KIND == NORMAL_EV11) {
    base = r / s;
    t = r * r - 1.f;
  } else {
    const float q = dof + r * r;
    base = (dof + 1.f) * r / (q * s);
    t = (dof + 1.f) * r * r / q - 1.f;
  }
  if (!is_ev11<KIND>()) return base;
  const float sdfac = ev[0], sdadd = ev[1], sdb = ev[2];
  const float sigm = 1.f / (1.f + expf(-ipred));
  const float ds_dip = sdfac * sdfac * (sdb + 2.f * sdadd * sp) * sigm /
                       (2.f * s);
  const float half_fac = sdfac * sdfac / (2.f * s * s);
  dev[0] = t / sdfac;
  dev[1] = t * half_fac * sp * sp;
  dev[2] = t * half_fac * sp;
  return base + t * ds_dip / s;
}

template <int KIND>
__device__ __forceinline__ void load_ev(const Args& p, float ev[3]) {
  if (is_ev11<KIND>()) {
    ev[0] = p.ev[0];
    ev[1] = p.ev[1];
    ev[2] = p.ev[2];
  } else {
    ev[0] = ev[1] = ev[2] = 0.f;
  }
}

// v[k] summed over the block, in a fixed order (each warp by shuffles,
// then its warps in order); the block's thread 0 gets the sums
template <int K>
__device__ __forceinline__ void block_sums(float v[K]) {
  __shared__ float warp_sums[K][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], d);
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = warp_sums[k][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += warp_sums[k][w];
      v[k] = s;
    }
  }
  __syncthreads();  // warp_sums may be written again by the caller's next use
}

// Each block's K sums (thread 0's v) go to part[block * K + k]; the last
// block to finish adds the partials in block order and writes
// out[k] = w * sum (w = *scale, or 1 when scale is null).
template <int K>
__device__ __forceinline__ void grid_sums(float v[K], float* part,
                                          unsigned int* ticket,
                                          const float* scale, float* out) {
  __shared__ bool last;
  block_sums<K>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[blockIdx.x * K + k] = v[k];
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0.f;
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += __ldcg(part + b * K + k);
  }
  block_sums<K>(s);
  if (threadIdx.x == 0) {
    const float w = scale != nullptr ? *scale : 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = s[k] * w;
  }
}

__device__ __forceinline__ void load4(const float* x, long long i,
                                      float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(x + i));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// the sum of mask * ll over the quad's observations i0 + j in [0, n)
template <int KIND, bool NOISE, bool WHOLE>
__device__ __forceinline__ float quad_ll(const Args& p, const float ev[3],
                                         const float eps_in[4], long long i0,
                                         bool vec) {
  float loc[4], scale[4], a[4], f[4], iobs[4], sig[4], mask[4], eps[4];
  if (WHOLE && vec) {
    load4(p.loc, i0, loc);
    load4(p.scale, i0, scale);
    load4(p.a, i0, a);
    load4(p.f, i0, f);
    load4(p.iobs, i0, iobs);
    load4(p.sig, i0, sig);
    if (p.mask != nullptr) load4(p.mask, i0, mask);
    if (NOISE) load4(p.noise, i0, eps);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      if (WHOLE || (i >= 0 && i < p.n)) {
        loc[j] = __ldg(p.loc + i);
        scale[j] = __ldg(p.scale + i);
        a[j] = __ldg(p.a + i);
        f[j] = __ldg(p.f + i);
        iobs[j] = __ldg(p.iobs + i);
        sig[j] = __ldg(p.sig + i);
        if (p.mask != nullptr) mask[j] = __ldg(p.mask + i);
        if (NOISE) eps[j] = __ldg(p.noise + i);
      }
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = i0 + j;
    if (WHOLE || (i >= 0 && i < p.n)) {
      const float e = NOISE ? eps[j] : eps_in[j];
      const float z = a[j] * loc[j] + fabsf(a[j]) * scale[j] * e;
      const float ipred = z * f[j] * f[j];
      const float ll = pointwise_ll<KIND>(iobs[j], sig[j], ipred, ev, p.dof,
                                          p.t_const);
      acc += p.mask != nullptr ? mask[j] * ll : ll;
    }
  }
  return acc;
}

__device__ __forceinline__ bool aligned16(const float* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

template <int KIND, bool NOISE>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS_PER_SM)
    fused_ll_fwd_kernel(const Args p, float* __restrict__ part,
                        float* __restrict__ out) {
  float ev[3];
  load_ev<KIND>(p, ev);
  // quads q0 .. q_end - 1 hold the call's indices offset .. offset + n - 1
  const uint64_t q0 = p.offset >> 2;
  const uint64_t q_end = (p.offset + static_cast<uint64_t>(p.n) + 3) >> 2;
  const bool vec = (p.offset & 3) == 0 && aligned16(p.loc) &&
                   aligned16(p.scale) && aligned16(p.a) && aligned16(p.f) &&
                   aligned16(p.iobs) && aligned16(p.sig) &&
                   (p.mask == nullptr || aligned16(p.mask)) &&
                   (!NOISE || aligned16(p.noise));
  float acc[1] = {0.f};
  for (uint64_t q = q0 + blockIdx.x * THREADS + threadIdx.x; q < q_end;
       q += static_cast<uint64_t>(gridDim.x) * THREADS) {
    float eps[4];
    if (!NOISE) {
      uint32_t c[4];
      ct_philox_block(q, p.k0, p.k1, c);
      ct_box_muller(c[0], c[1], &eps[0], &eps[1]);
      ct_box_muller(c[2], c[3], &eps[2], &eps[3]);
    }
    // the call's index of the quad's slot 0 (negative for a head quad)
    const long long i0 = static_cast<long long>(4 * q - p.offset);
    if (i0 >= 0 && i0 + 4 <= p.n)
      acc[0] += quad_ll<KIND, NOISE, true>(p, ev, eps, i0, vec);
    else
      acc[0] += quad_ll<KIND, NOISE, false>(p, ev, eps, i0, vec);
  }
  grid_sums<1>(acc, part, &fwd_ticket, nullptr, out);
}

template <int KIND, bool NOISE>
__global__ void __launch_bounds__(THREADS)
    fused_ll_bwd_kernel(const Args p, const float* __restrict__ ct,
                        float* __restrict__ dloc, float* __restrict__ dscale,
                        float* __restrict__ da, float* __restrict__ df,
                        float* __restrict__ part, float* __restrict__ dev_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float dev[3] = {0.f, 0.f, 0.f};
  if (i < p.n) {
    float ev[3];
    load_ev<KIND>(p, ev);
    const Chain c = chain<NOISE>(p, i);
    float d[3];
    const float dip = pointwise_grads<KIND>(p.iobs[i], p.sig[i], c.ipred, ev,
                                            p.dof, d);
    const float m = p.mask != nullptr ? p.mask[i] : 1.f;
    const float g = m * dip;  // d (sum of mask ll) / d ipred
    const float dz = g * c.f * c.f;
    const float w = *ct;
    dloc[i] = w * (dz * c.a);
    dscale[i] = w * (dz * fabsf(c.a) * c.eps);
    df[i] = w * (g * c.z * 2.f * c.f);
    da[i] = w * (dz * c.loc + sgn(c.a) * c.scale * c.eps * dz);
    if (is_ev11<KIND>()) {
      dev[0] = m * d[0];
      dev[1] = m * d[1];
      dev[2] = m * d[2];
    }
  }
  if constexpr (is_ev11<KIND>())
    grid_sums<3>(dev, part, &bwd_ticket, ct, dev_out);
}

int fwd_parts(int n, int sm_count) {
  const int quads = ct_blocks(n, 4) + 1;  // the most any offset gives
  const int blocks = ct_blocks(quads, THREADS);
  const int resident = FWD_BLOCKS_PER_SM * sm_count;
  return blocks < resident ? blocks : (resident < 1 ? 1 : resident);
}

// the Ev11 kinds launch at n = 0 too: their one block writes dev = 0
int bwd_parts(int n) { return n > 0 ? ct_blocks(n, THREADS) : 1; }

template <int KIND>
cudaError_t launch_fwd(const Args& p, int n_parts, float* part, float* out,
                       cudaStream_t stream) {
  if (p.noise != nullptr)
    fused_ll_fwd_kernel<KIND, true><<<n_parts, THREADS, 0, stream>>>(p, part,
                                                                     out);
  else
    fused_ll_fwd_kernel<KIND, false><<<n_parts, THREADS, 0, stream>>>(p, part,
                                                                      out);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_bwd(const Args& p, const float* ct, float* dloc,
                       float* dscale, float* da, float* df, float* part,
                       float* dev, cudaStream_t stream) {
  const int blocks = is_ev11<KIND>() ? bwd_parts(p.n)
                                     : ct_blocks(p.n, THREADS);
  if (blocks < 1) return cudaSuccess;
  if (p.noise != nullptr)
    fused_ll_bwd_kernel<KIND, true><<<blocks, THREADS, 0, stream>>>(
        p, ct, dloc, dscale, da, df, part, dev);
  else
    fused_ll_bwd_kernel<KIND, false><<<blocks, THREADS, 0, stream>>>(
        p, ct, dloc, dscale, da, df, part, dev);
  return cudaGetLastError();
}

Args make_args(const float* loc, const float* scale, const float* a,
               const float* f, const float* iobs, const float* sig,
               const float* mask, const float* noise, const float* ev, int n,
               uint32_t seed_lo, uint32_t seed_hi, uint64_t offset, float dof,
               float t_const) {
  return Args{loc, scale, a, f, iobs, sig, mask, noise, ev, n,
              seed_lo, seed_hi, offset, dof, t_const};
}

}  // namespace

// the forward's grid, and so its partial sums, for n observations on a card
// of sm_count SMs: blocks enough for every quad, at most FWD_BLOCKS_PER_SM a
// SM, at least 1
CT_API int ct_fused_ll_parts(int n, int sm_count) {
  return fwd_parts(n, sm_count);
}

// the backward's blocks, and so the Ev11 kinds' partial sums (3 each), for
// n observations, at least 1
CT_API int ct_fused_ll_bwd_parts(int n) { return bwd_parts(n); }

// part: (n_parts,) scratch, n_parts = ct_fused_ll_parts(n, SMs) (any count
// >= 1 gives a correct sum; the sum's rounding depends on it); out: (1,)
// the masked sum
CT_API int ct_fused_ll_fwd(const float* loc, const float* scale,
                           const float* a, const float* f, const float* iobs,
                           const float* sig, const float* mask,
                           const float* noise, const float* ev, float* part,
                           float* out, int n, int n_parts, int kind,
                           float dof, float t_const, uint32_t seed_lo,
                           uint32_t seed_hi, uint64_t offset, void* stream) {
  if (n < 0 || n_parts < 1) return cudaErrorInvalidValue;
  const Args p = make_args(loc, scale, a, f, iobs, sig, mask, noise, ev, n,
                           seed_lo, seed_hi, offset, dof, t_const);
  const cudaStream_t s = ct_stream(stream);
  switch (kind) {
    case NORMAL: return launch_fwd<NORMAL>(p, n_parts, part, out, s);
    case STUDENTT: return launch_fwd<STUDENTT>(p, n_parts, part, out, s);
    case LAPLACE: return launch_fwd<LAPLACE>(p, n_parts, part, out, s);
    case NORMAL_EV11:
      return launch_fwd<NORMAL_EV11>(p, n_parts, part, out, s);
    case STUDENTT_EV11:
      return launch_fwd<STUDENTT_EV11>(p, n_parts, part, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// ct: (1,) cotangent of the sum; dloc, dscale, da, df: (n,); for the Ev11
// kinds part: (ct_fused_ll_bwd_parts(n), 3) scratch and dev: (3,), else
// unused
CT_API int ct_fused_ll_bwd(const float* loc, const float* scale,
                           const float* a, const float* f, const float* iobs,
                           const float* sig, const float* mask,
                           const float* noise, const float* ev,
                           const float* ct, float* dloc, float* dscale,
                           float* da, float* df, float* part, float* dev,
                           int n, int kind, float dof, float t_const,
                           uint32_t seed_lo, uint32_t seed_hi,
                           uint64_t offset, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  const Args p = make_args(loc, scale, a, f, iobs, sig, mask, noise, ev, n,
                           seed_lo, seed_hi, offset, dof, t_const);
  const cudaStream_t s = ct_stream(stream);
  switch (kind) {
#define CT_BWD(K) \
    return launch_bwd<K>(p, ct, dloc, dscale, da, df, part, dev, s)
    case NORMAL: CT_BWD(NORMAL);
    case STUDENTT: CT_BWD(STUDENTT);
    case LAPLACE: CT_BWD(LAPLACE);
    case NORMAL_EV11: CT_BWD(NORMAL_EV11);
    case STUDENTT_EV11: CT_BWD(STUDENTT_EV11);
#undef CT_BWD
    default: return cudaErrorInvalidValue;
  }
}

// out: (2,) host memory; receives the current device's forward and
// backward tickets (0 between launches), after the device finishes its work
CT_API int ct_fused_ll_tickets(unsigned int* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, fwd_ticket, sizeof(unsigned int));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + 1, bwd_ticket, sizeof(unsigned int));
  return err;
}
