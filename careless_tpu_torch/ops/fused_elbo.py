"""The fused ELBO likelihood (K4) and its standard normals (K3): kernels
and plain versions.

Counterpart of careless_tpu/ops/fused_elbo.py: prng_normal (the TPU's
in-kernel PRNG through prng_normal_probe) and fused_likelihood_sum (the
Pallas kernels of _fused_ll_fwd / _fused_ll_bwd). Per observation, with
a = image_scales[image_id] and F = z_f[refl_id] gathered OUTSIDE the kernel
by plan_gather (K2 forward, the planned segment sum backward):

    eps   ~ N(0, 1)                      Philox, as K3, or `noise`
    z     = a * loc + |a| * scale * eps
    ipred = z * F^2
    out   = sum(mask * ll(kind; iobs, sig, ipred))

and a backward that regenerates the same eps and returns dloc, dscale, da,
dF per observation and, for the Ev11 kinds, the gradient in the three Ev11
scalars. On the card these are K4-fwd and K4-bwd (csrc/fused_ll.cu); on the
CPU the plain versions below, with explicit gradients, as the kernel has.

Noise streams. The Philox stream is counter-based: element i of a call with
64-bit key `seed` and `offset` o is a function of (seed, o + i) alone, so
calls with one key and disjoint index ranges never share a number, a call
split in two gives the same stream, and any range can be regenerated.
Index e lies in Philox block e >> 2 (the counter) at slot e & 3: the
block's four output words give two pairs of uniforms on (0, 1],
u = ((r >> 8) + 1) * 2^-24, and each pair, (r0, r1) and (r2, r3), two
Box-Muller normals: slot 0 is sqrt(-2 log u(r0)) cos(2 pi u(r1)), slot 1
the same with sin, slots 2 and 3 the same of (r2, r3). The plain version
implements the same Philox bit for bit in int64 arithmetic, so the card can
compare the kernel's raw words exactly and its normals to a few ulp. The
ELBO's step key is base | (step << 32) and sample s of a step uses indices
[s N, (s + 1) N): the unfused path draws all S N normals with one K3
launch, and K4 regenerates sample s's range in forward and backward, so the
fused and unfused ELBO are one estimator. This layout, with the reflection
uniforms u_f of shape (S, n_refl), replaces the TPU's per-sample seeds
seed + 65537 s (careless_tpu/models/merging/variational.py:51-64), which
were needed because its in-kernel PRNG was seeded per 8192-row block.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import kernels
from .distributions import softplus
from .plan_gather import GatherPlan, plan_gather

_M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
_TWO_M24 = 2.0 ** -24


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for uint32 m and x held in int64,
    without overflowing int64 (x is split into 16-bit halves)."""
    t1 = m * (x & 0xFFFF)
    t2 = m * (x >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & _M32


def philox4x32_10(counter: torch.Tensor, seed: int):
    """Philox4x32-10 on 64-bit counters (int64 tensor, words 2 and 3 zero)
    under the 64-bit key `seed`; returns the four output words as int64
    tensors holding uint32 values."""
    c0 = counter & _M32
    c1 = (counter >> 32) & _M32
    c2 = torch.zeros_like(counter)
    c3 = torch.zeros_like(counter)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(word: torch.Tensor) -> torch.Tensor:
    return ((word >> 8) + 1).to(torch.float32) * _TWO_M24


def plain_prng_normal(n: int, seed: int, offset: int, device,
                      with_bits: bool = False):
    """The plain PyTorch version of K3 (same words, same arithmetic); with
    with_bits also the (n, 2) words each element used, as int32."""
    e = offset + torch.arange(n, dtype=torch.int64, device=device)
    r0, r1, r2, r3 = philox4x32_10(e >> 2, int(seed))
    slot = e & 3
    high = slot >= 2
    ra, rb = torch.where(high, r2, r0), torch.where(high, r3, r1)
    angle = TWO_PI_F32 * _uniform(rb)
    trig = torch.where((slot & 1) == 1, torch.sin(angle), torch.cos(angle))
    out = torch.sqrt(-2.0 * torch.log(_uniform(ra))) * trig
    if not with_bits:
        return out
    bits = torch.stack([ra, rb], dim=1)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return out, bits


def prng_normal(n: int, seed: int, offset: int, device) -> torch.Tensor:
    """(n,) standard normals of indices offset .. offset + n - 1 under the
    64-bit key `seed`. On the CPU this is the plain version; on the card K3
    (csrc/philox.cu)."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain_prng_normal(n, seed, offset, device)
    return kernels.philox_normal(n, int(seed), int(offset), device)


EV11_KINDS = ("normal_ev11", "studentt_ev11")
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)


def studentt_log_norm(dof: float) -> float:
    """lgamma((dof + 1) / 2) - lgamma(dof / 2) - log(dof pi) / 2, on the
    host in double precision, as careless_tpu/ops/fused_elbo.py:145-146."""
    return (math.lgamma((dof + 1.0) / 2.0) - math.lgamma(dof / 2.0)
            - 0.5 * math.log(dof * math.pi))


def _effective_scale(kind, ev, sig, ipred):
    """(s, sp): the likelihood's scale s and, for the Ev11 kinds,
    sp = softplus(ipred). Plain kinds use sig; the Ev11 kinds
    s = sdfac sqrt(sig^2 + sdb sp + sdadd sp^2)."""
    if kind not in EV11_KINDS:
        return sig, None
    sdfac, sdadd, sdb = ev[0], ev[1], ev[2]
    sp = softplus(ipred)
    u = sig * sig + sdb * sp + sdadd * sp * sp
    return sdfac * torch.sqrt(u), sp


def pointwise_ll(kind: str, dof: float, ev, iobs, sig, ipred):
    """Per-observation log-likelihood (fused_elbo.py:136-152)."""
    s, _ = _effective_scale(kind, ev, sig, ipred)
    r = (iobs - ipred) / s
    if kind in ("normal", "normal_ev11"):
        return -0.5 * r * r - torch.log(s) - _HALF_LOG_2PI
    if kind in ("studentt", "studentt_ev11"):
        return (studentt_log_norm(dof) - torch.log(s)
                - 0.5 * (dof + 1.0) * torch.log1p(r * r / dof))
    if kind == "laplace":   # scale sig / sqrt 2
        return -torch.log(_SQRT2 * s) - _SQRT2 * torch.abs(r)
    raise ValueError(f"unsupported fused likelihood kind: {kind}")


def pointwise_grads(kind: str, dof: float, ev, iobs, sig, ipred):
    """(d ll / d ipred, (d ll / d sdfac, sdadd, sdb) or None) per
    observation (fused_elbo.py:155-183). torch.sign(0) is 0, as jnp.sign."""
    s, sp = _effective_scale(kind, ev, sig, ipred)
    r = (iobs - ipred) / s
    if kind in ("normal", "normal_ev11"):
        base = r / s
        t = r * r - 1.0                      # s * d ll / d s
    elif kind in ("studentt", "studentt_ev11"):
        base = (dof + 1.0) * r / ((dof + r * r) * s)
        t = (dof + 1.0) * r * r / (dof + r * r) - 1.0
    elif kind == "laplace":
        return torch.sign(r) * _SQRT2 / s, None
    else:
        raise ValueError(f"unsupported fused likelihood kind: {kind}")
    if kind not in EV11_KINDS:
        return base, None
    sdfac, sdadd, sdb = ev[0], ev[1], ev[2]
    # ds/dipred = sdfac^2 (sdb + 2 sdadd sp) sigmoid(ipred) / (2 s)
    sigm = 1.0 / (1.0 + torch.exp(-ipred))
    ds_dip = sdfac * sdfac * (sdb + 2.0 * sdadd * sp) * sigm / (2.0 * s)
    half_fac = sdfac * sdfac / (2.0 * s * s)
    return base + t * ds_dip / s, (t / sdfac, t * half_fac * sp * sp,
                                   t * half_fac * sp)


def _chain(loc, scale, a, f, eps):
    z = a * loc + torch.abs(a) * scale * eps
    return z, z * f * f


def plain_fused_likelihood_sum(loc, scale, a, f, iobs, sig, mask, ev, eps, *,
                               kind: str, dof: float) -> torch.Tensor:
    """The plain PyTorch version of K4-fwd: the 0-d sum of mask * ll over
    observations, from the gathered a and f and the normals eps."""
    _, ipred = _chain(loc, scale, a, f, eps)
    ll = pointwise_ll(kind, dof, ev, iobs, sig, ipred)
    return torch.sum(ll if mask is None else mask * ll)


def plain_fused_likelihood_grads(loc, scale, a, f, iobs, sig, mask, ev, eps,
                                 ct, *, kind: str, dof: float):
    """The plain PyTorch version of K4-bwd: ct * (dloc, dscale, da, df),
    and ct * the (3,) gradient in the Ev11 scalars (None for other kinds),
    of plain_fused_likelihood_sum (fused_elbo.py:232-248)."""
    z, ipred = _chain(loc, scale, a, f, eps)
    dip, dev = pointwise_grads(kind, dof, ev, iobs, sig, ipred)
    g = dip if mask is None else mask * dip
    dz = g * f * f
    grads = (dz * a, dz * torch.abs(a) * eps, dz * loc
             + torch.sign(a) * scale * eps * dz, g * z * 2.0 * f)
    dloc, dscale, da, df = (ct * x for x in grads)
    if dev is not None:
        dev = ct * torch.stack([torch.sum(d if mask is None else mask * d)
                                for d in dev])
    return dloc, dscale, da, df, dev


def _t_const(kind: str, dof: float) -> float:
    return studentt_log_norm(dof) if kind.startswith("studentt") else 0.0


class _FusedLL(torch.autograd.Function):
    """K4 on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, loc, scale, a, f, iobs, sig, mask, ev, noise, cfg):
        kind, dof, seed, offset = cfg
        if loc.device.type == "cpu":
            eps = noise if noise is not None else plain_prng_normal(
                loc.shape[0], seed, offset, loc.device)
            out = plain_fused_likelihood_sum(loc, scale, a, f, iobs, sig,
                                             mask, ev, eps, kind=kind,
                                             dof=dof)
            noise = eps   # the backward reuses the normals
        else:
            out = kernels.fused_ll_fwd(
                loc, scale, a, f, iobs, sig, mask, noise, ev, kind=kind,
                dof=dof, t_const=_t_const(kind, dof), seed=seed,
                offset=offset)
        ctx.save_for_backward(loc, scale, a, f, iobs, sig, mask, ev, noise)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, ct):
        loc, scale, a, f, iobs, sig, mask, ev, noise = ctx.saved_tensors
        kind, dof, seed, offset = ctx.cfg
        if loc.device.type == "cpu":
            dloc, dscale, da, df, dev = plain_fused_likelihood_grads(
                loc, scale, a, f, iobs, sig, mask, ev, noise, ct, kind=kind,
                dof=dof)
        else:
            dloc, dscale, da, df, dev = kernels.fused_ll_bwd(
                loc, scale, a, f, iobs, sig, mask, noise, ev,
                ct.contiguous(), kind=kind, dof=dof,
                t_const=_t_const(kind, dof), seed=seed, offset=offset)
        return dloc, dscale, da, df, None, None, None, dev, None, None


def fused_likelihood_sum(loc, scale, image_scales, z_f, refl_id, image_id,
                         iobs, sig, mask=None, *, seed: int, offset: int = 0,
                         noise: Optional[torch.Tensor] = None,
                         refl_plan: Optional[GatherPlan],
                         image_plan: Optional[GatherPlan],
                         kind: str = "normal", dof: float = 0.0, ev11=None
                         ) -> torch.Tensor:
    """sum over observations of mask * log p(z F^2; iobs, sig), z = a loc +
    |a| scale eps. Differentiable in loc, scale, image_scales, z_f and the
    Ev11 scalars.

    kind/dof select the pointwise likelihood: 'normal', 'laplace' (scale
    sig / sqrt 2), 'studentt' with `dof` degrees of freedom, or the Ev11
    variants 'normal_ev11' / 'studentt_ev11', which need `ev11` = (sdfac,
    sdadd, sdb) after softplus (0-d tensors); their gradients flow back
    through the caller's softplus. eps is `noise` (N,) when given, else the
    Philox normals of indices offset .. offset + N - 1 under the 64-bit key
    `seed`. The gathers use the plans; image_plan may be None only for a
    one-entry image_scales (the MLP scaler alone), which is broadcast.
    CPU tensors run the plain versions, CUDA tensors K4 or raise."""
    n = loc.shape[0]
    if image_plan is None and image_scales.numel() == 1:
        a_obs = image_scales.reshape(1).expand(n)
    else:
        a_obs = plan_gather(image_scales, image_id, image_plan)
    f_obs = plan_gather(z_f, refl_id, refl_plan)
    return fused_likelihood_sum_gathered(
        loc, scale, a_obs, f_obs, iobs, sig, mask, seed=seed, offset=offset,
        noise=noise, kind=kind, dof=dof, ev11=ev11)


def fused_likelihood_sum_gathered(loc, scale, a_obs, f_obs, iobs, sig,
                                  mask=None, *, seed: int, offset: int = 0,
                                  noise: Optional[torch.Tensor] = None,
                                  kind: str = "normal", dof: float = 0.0,
                                  ev11=None) -> torch.Tensor:
    """fused_likelihood_sum from the gathered a = image_scales[image_id]
    and F = z_f[refl_id] per observation: one K4 launch (CPU tensors: the
    plain version). The parallel crossvalidation gathers once over all
    halves and sums each half's rows with its own key."""
    if kind not in kernels.FUSED_KINDS:
        raise ValueError(f"unsupported fused likelihood kind: {kind}")
    if kind in EV11_KINDS:
        if ev11 is None:
            raise ValueError(f"kind={kind} requires ev11 scalars")
        ev = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                          device=loc.device).reshape(())
                          for v in ev11])
    else:
        ev = torch.zeros(3, dtype=torch.float32, device=loc.device)
    return _FusedLL.apply(
        loc.contiguous(), scale.contiguous(), a_obs.contiguous(),
        f_obs.contiguous(), iobs.contiguous(), sig.contiguous(),
        None if mask is None else mask.contiguous(), ev,
        None if noise is None else noise.contiguous(),
        (kind, float(dof), int(seed), int(offset)))
