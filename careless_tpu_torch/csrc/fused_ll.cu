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
// Design: one thread per observation; the TPU's (R, 128) lane layout and
// 8192-row blocks were VMEM mechanics and are not carried over, so nothing
// is padded. The TPU kernel summed across its sequential grid in SMEM; here
// each block writes its partial sums (a fixed shared-memory tree) and a
// second launch adds the partials in block order, so the loss and the Ev11
// gradients repeat bit for bit without atomics. The cotangent is read from
// device memory, so the backward needs no host sync. Where the numbers could
// part from the JAX package's: sign(0) is 0 (never copysignf's +-1),
// softplus is max(x, 0) + log1p(exp(-|x|)) as logaddexp(0, x), and the
// sigmoid 1 / (1 + exp(-x)) gives 0 or 1, never NaN, for large |x| (exp
// overflows to inf, 1 / inf is 0). Built without --use_fast_math.
#include "philox.cuh"

namespace {

constexpr int THREADS = 256;         // observations per block (one partial)
constexpr int REDUCE_THREADS = 256;

enum Kind { NORMAL = 0, STUDENTT = 1, LAPLACE = 2, NORMAL_EV11 = 3,
            STUDENTT_EV11 = 4 };

constexpr float HALF_LOG_2PI = 0.918938533204672742f;
constexpr float SQRT2 = 1.41421356237309505f;

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

// sums red[k][0 .. THREADS) into red[k][0] for k < K, in a fixed order
template <int K>
__device__ __forceinline__ void block_sums(float (*red)[THREADS]) {
  __syncthreads();
#pragma unroll
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        red[k][threadIdx.x] += red[k][threadIdx.x + stride];
    }
    __syncthreads();
  }
}

template <int KIND, bool NOISE>
__global__ void __launch_bounds__(THREADS)
    fused_ll_fwd_kernel(const Args p, float* __restrict__ part) {
  __shared__ float red[1][THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float v = 0.f;
  if (i < p.n) {
    float ev[3];
    load_ev<KIND>(p, ev);
    const Chain c = chain<NOISE>(p, i);
    const float ll = pointwise_ll<KIND>(p.iobs[i], p.sig[i], c.ipred, ev,
                                        p.dof, p.t_const);
    v = p.mask != nullptr ? p.mask[i] * ll : ll;
  }
  red[0][threadIdx.x] = v;
  block_sums<1>(red);
  if (threadIdx.x == 0) part[blockIdx.x] = red[0][0];
}

template <int KIND, bool NOISE>
__global__ void __launch_bounds__(THREADS)
    fused_ll_bwd_kernel(const Args p, const float* __restrict__ ct,
                        float* __restrict__ dloc, float* __restrict__ dscale,
                        float* __restrict__ da, float* __restrict__ df,
                        float* __restrict__ part) {
  __shared__ float red[3][THREADS];
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
  if constexpr (is_ev11<KIND>()) {
#pragma unroll
    for (int k = 0; k < 3; ++k) red[k][threadIdx.x] = dev[k];
    block_sums<3>(red);
    if (threadIdx.x < 3)
      part[blockIdx.x * 3 + threadIdx.x] = red[threadIdx.x][0];
  }
}

// out[k] = w * sum over p of part[p * width + k], in a fixed order, for
// k < width (one block each); w = *scale, or 1 when scale is null
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_parts_kernel(const float* __restrict__ part, int n_parts,
                        int width, const float* __restrict__ scale,
                        float* __restrict__ out) {
  __shared__ float red[REDUCE_THREADS];
  const int k = blockIdx.x;
  float s = 0.f;
  for (int q = threadIdx.x; q < n_parts; q += REDUCE_THREADS)
    s += part[static_cast<size_t>(q) * width + k];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = scale != nullptr ? red[0] * *scale : red[0];
}

cudaError_t reduce_parts(const float* part, int n_parts, int width,
                         const float* scale, float* out,
                         cudaStream_t stream) {
  reduce_parts_kernel<<<width, REDUCE_THREADS, 0, stream>>>(
      part, n_parts, width, scale, out);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_fwd(const Args& p, float* part, float* out,
                       cudaStream_t stream) {
  const int blocks = ct_blocks(p.n, THREADS);
  if (blocks > 0) {
    if (p.noise != nullptr)
      fused_ll_fwd_kernel<KIND, true><<<blocks, THREADS, 0, stream>>>(p, part);
    else
      fused_ll_fwd_kernel<KIND, false><<<blocks, THREADS, 0, stream>>>(p,
                                                                        part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return reduce_parts(part, blocks, 1, nullptr, out, stream);
}

template <int KIND>
cudaError_t launch_bwd(const Args& p, const float* ct, float* dloc,
                       float* dscale, float* da, float* df, float* part,
                       float* dev, cudaStream_t stream) {
  const int blocks = ct_blocks(p.n, THREADS);
  if (blocks > 0) {
    if (p.noise != nullptr)
      fused_ll_bwd_kernel<KIND, true><<<blocks, THREADS, 0, stream>>>(
          p, ct, dloc, dscale, da, df, part);
    else
      fused_ll_bwd_kernel<KIND, false><<<blocks, THREADS, 0, stream>>>(
          p, ct, dloc, dscale, da, df, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!is_ev11<KIND>()) return cudaSuccess;
  return reduce_parts(part, blocks, 3, ct, dev, stream);
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

// the number of per-block partial sums a call over n observations writes
CT_API int ct_fused_ll_parts(int n) { return ct_blocks(n, THREADS); }

// part: (ct_fused_ll_parts(n),) scratch; out: (1,) the masked sum
CT_API int ct_fused_ll_fwd(const float* loc, const float* scale,
                           const float* a, const float* f, const float* iobs,
                           const float* sig, const float* mask,
                           const float* noise, const float* ev, float* part,
                           float* out, int n, int kind, float dof,
                           float t_const, uint32_t seed_lo, uint32_t seed_hi,
                           uint64_t offset, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  const Args p = make_args(loc, scale, a, f, iobs, sig, mask, noise, ev, n,
                           seed_lo, seed_hi, offset, dof, t_const);
  const cudaStream_t s = ct_stream(stream);
  switch (kind) {
    case NORMAL: return launch_fwd<NORMAL>(p, part, out, s);
    case STUDENTT: return launch_fwd<STUDENTT>(p, part, out, s);
    case LAPLACE: return launch_fwd<LAPLACE>(p, part, out, s);
    case NORMAL_EV11: return launch_fwd<NORMAL_EV11>(p, part, out, s);
    case STUDENTT_EV11: return launch_fwd<STUDENTT_EV11>(p, part, out, s);
    default: return cudaErrorInvalidValue;
  }
}

// ct: (1,) cotangent of the sum; dloc, dscale, da, df: (n,); for the Ev11
// kinds part: (ct_fused_ll_parts(n), 3) scratch and dev: (3,), else unused
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
