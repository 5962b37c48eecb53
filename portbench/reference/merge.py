"""The plain reference of `careless mono` and `careless poly` under the
CLI's defaults: three full-batch steps of the negative ELBO and Adam.

Model (Dalton et al., Nat Commun 13, 7764, 2022; careless v0.5.4), per
observation i of reflection h(i) on image k(i), with metadata x_i:

    (mu_i, r_i)  = MLP(x_i): L leaky-ReLU (0.01) layers of width w, a
                   linear head; s_i = exp(r_i) + 1e-7
    a_k          = 1 for image 0, a trained scale for the others
    Sigma_i      = a_k mu_i + |a_k| s_i eps_i,  eps_i ~ N(0, 1)
    F_h          ~ q_h = TruncatedNormal(exp(l_h), exp(t_h) + 1e-7) on
                   [1e-32 (0 if centric), 1e10], by its inverse CDF at a
                   uniform u_h
    Ipred_i      = Sigma_i F_h(i)^2
    loss         = -sum_i log N(Iobs_i; Ipred_i, SigIobs_i)
                   + sum_h [log q_h(F_h) - log p_h(F_h)]

with the Wilson prior p (centric: half-normal, acentric: Rayleigh, both of
scale sqrt(multiplicity)). Laue sums Ipred over each harmonic group first
and scores every row j of the group table against its packed intensity
(rows no group reaches score a prediction of 0). The gradient's global
norm is taken, non-finite entries are zeroed, and Adam (lr, beta_1,
beta_2, eps 1e-7) steps every parameter.

The noise is the port's contract with its callers, worked out here again:
the merge's torch.Generator draws a 32-bit base key, then each step's
(1, n_refl) uniforms; step t's scale noise is Philox under the key
base | (t << 32), index i going to row i of the training layout (layout.py).
The MLP runs in blocks of rows: a forward without autograd for the (N, 2)
head outputs, then per block a forward and backward for the weights'
gradients.

`tf32` rounds both operands of every product of the MLP, forward and
backward, to TF32 (10 bits of mantissa, round to nearest even) and sums in
f32, as the card's TF32 tensor cores do: the control of the comparison.
`fault="half"` scores half of the rows (the even rows, Laue: the even
group-table rows) and doubles their sum: a fault the comparison must see.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import philox
from .layout import row_order

LEAK = 0.01
LOG_2PI_F32 = float(np.float32(math.log(2.0 * math.pi)))
SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
SQRT_2_OVER_PI = 0.7978845608028654
HIGH = 1e10
BLOCK_ROWS = 1 << 21

# the flags whose CLI defaults this reference implements
DEFAULTS = dict(mc_samples=1, structure_factor_init_scale=1.0,
                freeze_structure_factors=False, studentt_likelihood_dof=None,
                refine_uncertainties=False, clipnorm=None, clipvalue=None,
                global_clipnorm=None, kl_weight=None, wilson_prior_b=None,
                parents=None, analytic_kl=False, freeze_scales=False,
                image_layers=0, use_image_scales=True, scale_bijector="exp",
                mlp_dtype="float32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """The nearest TF32 value of each f32 entry (ties to even), as f32."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & -8192).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        ct = round_tf32(ct)
        return ct @ b.T, a.T @ ct


def _mm(a, b, tf32: bool):
    return _TF32Matmul.apply(a, b) if tf32 else a @ b


def mlp(x, weights, n_layers: int, tf32: bool):
    h = x
    for i in range(n_layers):
        h = _mm(h, weights[f"scaler/mlp/layers/{i}/w"], tf32) \
            + weights[f"scaler/mlp/layers/{i}/b"]
        h = torch.where(h >= 0, h, LEAK * h)
    return _mm(h, weights["scaler/mlp/out/w"], tf32) \
        + weights["scaler/mlp/out/b"]


def check_flags(cli: dict) -> None:
    for k, v in DEFAULTS.items():
        if cli.get(k, v) != v:
            raise ValueError(f"the reference implements --{k} {v!r} only; "
                             f"the configuration sets {cli[k]!r}")


def initial_params(problem, cli: dict, device) -> Dict[str, torch.Tensor]:
    """The merge's starting point, worked out from the problem: the
    posterior at the Wilson prior's moments, identity MLP layers with zero
    biases, image scales of 1."""
    d = problem.metadata.shape[1]
    width = cli.get("mlp_width") or d
    lam = torch.sqrt(torch.as_tensor(problem.asu.multiplicity,
                                     dtype=torch.float32))
    centric = torch.as_tensor(problem.asu.centric)
    k = torch.full_like(lam, 2.0)
    mean = torch.where(centric, lam * SQRT_2_OVER_PI,
                       lam * torch.exp(torch.lgamma(1.0 + 1.0 / k)))
    var_a = torch.square(lam) * (torch.exp(torch.lgamma(1.0 + 2.0 / k))
                                 - torch.exp(2.0 * torch.lgamma(1.0 + 1.0 / k)))
    std = torch.where(centric, lam * math.sqrt(1.0 - 2.0 / math.pi),
                      torch.sqrt(var_a))
    eps = np.float32(cli["epsilon"])
    std = std.numpy() * np.float32(cli["structure_factor_init_scale"])
    out = {"posterior/loc_raw": np.log(mean.numpy()),
           "posterior/scale_raw": np.log(np.maximum(std - eps, 1e-30)),
           "scaler/image/scales": np.ones(int(problem.image_id.max()),
                                          np.float32)}
    d_in = d
    for i in range(cli["mlp_layers"]):
        out[f"scaler/mlp/layers/{i}/w"] = np.eye(d_in, width, dtype=np.float32)
        out[f"scaler/mlp/layers/{i}/b"] = np.zeros(width, np.float32)
        d_in = width
    out["scaler/mlp/out/w"] = np.eye(d_in, 2, dtype=np.float32)
    out["scaler/mlp/out/b"] = np.zeros(2, np.float32)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in out.items()}


def _normal_lp(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * LOG_2PI_F32


def _ndtr_log(x):
    return torch.special.log_ndtr(x)


def truncated_normal(loc, scale, low, u):
    """(sample at uniforms u by the inverse CDF, the log density there)."""
    alpha, beta = (low - loc) / scale, (HIGH - loc) / scale
    a = torch.erf(alpha / SQRT2_F32)
    b = torch.erf(beta / SQRT2_F32)
    s = SQRT2_F32 * torch.erfinv(torch.maximum(a, u * (b - a) + a))
    inf = torch.tensor(float("inf"), device=s.device)
    s = torch.minimum(torch.maximum(s, torch.nextafter(alpha.detach(), inf)),
                      torch.nextafter(beta.detach(), -inf))
    z = torch.maximum(low, loc + scale * s)
    la, lb = _ndtr_log(alpha), _ndtr_log(beta)
    log_z = lb + torch.log1p(-torch.exp(torch.clamp(la - lb, max=-1e-20)))
    t = (z - loc) / scale
    lp = -0.5 * t * t - 0.5 * LOG_2PI_F32 - torch.log(scale) - log_z
    lp = torch.where((z < low) | (z > HIGH), torch.full_like(lp, -math.inf),
                     lp)
    return z, lp


def wilson_lp(x, centric, lam):
    half_normal = (0.5 * math.log(2.0 / math.pi) - torch.log(lam)
                   - 0.5 * torch.square(x / lam))
    k = torch.full_like(lam, 2.0)
    t = torch.log(x) - torch.log(lam)
    rayleigh = torch.log(k) - torch.log(lam) + (k - 1.0) * t \
        - torch.exp(k * t)
    return torch.where(centric, half_normal, rayleigh)


class Reference:
    """The reference merge of one problem on `device`."""

    def __init__(self, problem, config: dict, device, order=None):
        self.cli = config["cli"]
        check_flags(self.cli)
        self.device = device
        self.n_layers = self.cli["mlp_layers"]
        self.eps = float(self.cli["epsilon"])
        put = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                            device=device)
        self.refl = put(problem.refl_id, torch.int64)
        self.image = put(problem.image_id, torch.int64)
        self.meta = put(problem.metadata, torch.float32)
        self.iobs = put(problem.intensities, torch.float32)
        self.sig = put(problem.uncertainties, torch.float32)
        self.hid = (None if problem.harmonic_id is None
                    else put(problem.harmonic_id, torch.int64))
        self.centric = put(problem.asu.centric, torch.bool)
        self.lam = torch.sqrt(put(problem.asu.multiplicity, torch.float32))
        self.low = torch.where(self.centric, 0.0, 1e-32).float()
        self.n = problem.n_obs
        self.n_refl = len(problem.asu.centric)
        order = row_order(problem) if order is None else order
        # the layout position of each original row
        pos = np.empty(self.n, np.int64)
        pos[order] = np.arange(self.n)
        self.pos = put(pos, torch.int64)
        self.params0 = initial_params(problem, self.cli, device)

    def _scaler_out(self, w, tf32):
        with torch.no_grad():
            return torch.cat([mlp(self.meta[lo:lo + BLOCK_ROWS], w,
                                  self.n_layers, tf32)
                              for lo in range(0, self.n, BLOCK_ROWS)])

    def _scaler_grads(self, w, dy, tf32):
        names = [k for k in w if k.startswith("scaler/mlp/")]
        leaves = {k: w[k].detach().clone().requires_grad_(True)
                  for k in names}
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        for lo in range(0, self.n, BLOCK_ROWS):
            y = mlp(self.meta[lo:lo + BLOCK_ROWS], leaves, self.n_layers,
                    tf32)
            got = torch.autograd.grad(y, [leaves[k] for k in names],
                                      dy[lo:lo + BLOCK_ROWS])
            for k, g in zip(names, got):
                grads[k] += g
        return grads

    def loss_and_grads(self, p, u, noise, tf32=False, fault=None):
        """(loss, {leaf: gradient}) at parameters p, the posterior's
        uniforms u (n_refl,) and each original row's scale noise."""
        y = self._scaler_out(p, tf32).requires_grad_(True)
        leaves = {k: p[k].detach().clone().requires_grad_(True)
                  for k in ("posterior/loc_raw", "posterior/scale_raw",
                            "scaler/image/scales")}
        loc = y[:, 0]
        scale = torch.exp(y[:, 1]) + self.eps
        s = leaves["scaler/image/scales"]
        a = torch.cat([torch.ones(1, device=s.device), s])[self.image]
        sigma = a * loc + torch.abs(a) * scale * noise
        q_loc = torch.exp(leaves["posterior/loc_raw"])
        q_scale = torch.exp(leaves["posterior/scale_raw"]) + self.eps
        f, q_lp = truncated_normal(q_loc, q_scale, self.low, u)
        ipred = sigma * torch.square(f[self.refl])
        if self.hid is not None:
            ipred = torch.zeros_like(ipred).index_add(0, self.hid, ipred)
        ll = _normal_lp(ipred, self.iobs, self.sig)
        if fault == "half":
            ll = 2.0 * ll[0::2]
        kl = torch.sum(q_lp - wilson_lp(f, self.centric, self.lam))
        loss = -torch.sum(ll) + kl
        names = list(leaves)
        got = torch.autograd.grad(loss, [y] + [leaves[k] for k in names])
        grads = dict(zip(names, got[1:]))
        grads.update(self._scaler_grads(p, got[0], tf32))
        return float(loss.detach()), grads

    def run(self, gen_seed: int, steps: int = 3, tf32=False,
            fault: Optional[str] = None) -> dict:
        """Steps 1..steps of the merge from the seed of its generator:
        {losses, grads (step 1's, as Adam takes them), params0, params}."""
        cli = self.cli
        lr, b1, b2 = cli["learning_rate"], cli["beta_1"], cli["beta_2"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(gen_seed))
        base = int(torch.randint(0, 2 ** 32, (1,), generator=gen,
                                 device=self.device).item())
        p = {k: v.clone() for k, v in self.params0.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first = [], None
        for t in range(steps):
            u = torch.rand((1, self.n_refl), generator=gen,
                           device=self.device, dtype=torch.float32)[0]
            noise = philox.normals(self.n, base | (t << 32), 0,
                                   self.device)[self.pos]
            loss, g = self.loss_and_grads(p, u, noise, tf32, fault)
            losses.append(loss)
            g = {k: torch.where(torch.isfinite(x), x, torch.zeros_like(x))
                 for k, x in g.items()}
            if first is None:
                first = {k: x.clone() for k, x in g.items()}
            bc1, bc2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
            for k in p:
                m[k] = b1 * m[k] + (1.0 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
                denom = torch.sqrt(v2[k]) / math.sqrt(bc2) + 1e-7
                p[k] = p[k] - (lr / bc1) * m[k] / denom
        return dict(losses=losses, grads=first, params0=self.params0,
                    params=p)
