"""Expectation propagation for latent Gaussian processes (port of
``bayesianinference_tpu.ops.gp_ep``).

Parallel (all-sites-at-once) damped EP (Minka 2001; Rasmussen & Williams
2006 sec. 3.6; van Gerven et al. 2009): every sweep recomputes the full
posterior from the current sites with one [n, n] Cholesky of
B = I + S^1/2 K S^1/2 (through the ``cholesky`` op, so on the card the
hand-written kernel), moment-matches all cavities at once by Gauss-Hermite
quadrature of the likelihood, and applies one damped site update.

As in :mod:`.gp_laplace`, everything works over an explicit batch axis
(``k`` [..., n, n]) and the fixed point is a host loop over the whole
batch: a converged lane is frozen and the loop ends when no lane moves,
one host read per sweep, so each lane's sites, logZ and sweep count are
the JAX function's on that lane alone.

The site moments are the JAX package's: log Z_i(mu, s2) = log E[p(y_i|f)]
under the cavity by Gauss-Hermite, alpha and beta its first two
mu-derivatives.  JAX takes them by ``jax.grad`` through the quadrature;
with f_j = mu + s nodes_j they are the softmax-weighted moments of the
likelihood's own derivatives,

    alpha = sum_j p_j d1(f_j),   beta = sum_j p_j (d2(f_j) + (d1(f_j) - alpha)^2),

which is what this module computes (one pass over the nodes).

The hyperparameter gradient is the closed form of the EP stationarity
property (GPML sec. 5.5.2), a :class:`torch.autograd.Function`:

    dlogZ_EP/dK = (b b^T - S^1/2 B^-1 S^1/2) / 2,   b = S^1/2 B^-1 S^-1/2 nu.

When a gradient is wanted its sites carry a graph: one undamped sweep from
the detached fixed point with the graph on, entering as
``tau + (tau1 - tau1.detach())``, so that a second derivative sees the
sites move with K to first order (the damped map has the same fixed point
and the same implicit derivative).

The marginal-likelihood identity (equivalent to GPML eq. 3.65):

    log Z_EP = sum_i [ log Zhat_i + (log(1 + tau_i s2cav_i)
                       + (mucav_i - mu~_i)^2 / (s2cav_i + 1/tau_i)) / 2 ]
               - sum_i log L_ii - ||L^-1 S^-1/2 nu||^2 / 2.

A failed Cholesky yields NaN, mapped to the finite log-zero sentinel by
the problem layer's guard.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .gp_kernels import _inv_from_chol
from .gp_laplace import LatentLikelihood, _b_factor, _default_tol, _flat, _mv, _straight_through

__all__ = [
    "EPState",
    "gp_ep_state",
    "gp_ep_log_marginal",
    "gp_ep_latent_moments",
]


class EPState(NamedTuple):
    """Converged site parameters and posterior of a parallel-EP run, each
    with the batch's leading dims."""

    tau: torch.Tensor  # [..., n] site precisions (>= 0)
    nu: torch.Tensor  # [..., n] site precision-means
    mu: torch.Tensor  # [..., n] posterior mean
    sigma2: torch.Tensor  # [..., n] posterior marginal variances
    iterations: torch.Tensor  # [...] int32 sweeps used


def _gh_rule(num_points, dtype, device):
    nodes, weights = np.polynomial.hermite_e.hermegauss(num_points)
    logw = np.log(weights) - 0.5 * np.log(2.0 * np.pi)
    return (torch.as_tensor(nodes, dtype=dtype, device=device),
            torch.as_tensor(logw, dtype=dtype, device=device))


def _site_moments(derivs, mu, s2, y, rule, want_derivs: bool = True):
    """(log Zhat, alpha, beta) [B, n] of the tilted sites at cavities (mu, s2)."""
    nodes, logw = rule
    lpf, d1f, d2f, _ = derivs
    f = mu.unsqueeze(-2) + torch.sqrt(s2).unsqueeze(-2) * nodes[:, None]  # [B, P, n]
    t = lpf(f, y) + logw[:, None]
    logz = torch.logsumexp(t, dim=-2)
    if not want_derivs:
        return logz, None, None
    p = torch.exp(t - logz.unsqueeze(-2))
    g1 = d1f(f, y)
    alpha = (p * g1).sum(dim=-2)
    dev = g1 - alpha.unsqueeze(-2)
    beta = (p * (d2f(f, y) + dev * dev)).sum(dim=-2)
    return logz, alpha, beta


def _posterior_from_sites(k, tau, nu):
    """Stable q(f) moments from sites: one Cholesky + solves (GPML 3.66-68).
    Returns (mu, sigma2, L, sqrt_tau)."""
    st = torch.sqrt(tau)
    ell = _b_factor(k, st)
    v = torch.linalg.solve_triangular(ell, st.unsqueeze(-1) * k, upper=False)  # V = L^-1 S^1/2 K
    sigma2 = torch.diagonal(k, dim1=-2, dim2=-1) - (v * v).sum(dim=-2)
    mu = _mv(k, nu) - _mv(v.mT, _mv(v, nu))  # Sigma nu with Sigma = K - V^T V
    return mu, sigma2, ell, st


def _tau_floor(dtype) -> float:
    return torch.finfo(dtype).tiny * 1e4


def _cavity(mu, sigma2, tau, nu, floor):
    """Cavity natural parameters, floored to stay a proper Gaussian, as
    (mu_cav, s2_cav, tau_cav, nu_cav)."""
    tau_cav = torch.clamp(1.0 / sigma2 - tau, min=floor)
    nu_cav = mu / sigma2 - nu
    return nu_cav / tau_cav, 1.0 / tau_cav, tau_cav, nu_cav


def _ep_sweep(k, y, derivs, tau, nu, rule, damping: float, floor: float):
    """One damped parallel-EP sweep: posterior -> cavities -> matched
    moments -> new damped sites.  Returns (tau', nu', delta [B])."""
    mu, sigma2, _, _ = _posterior_from_sites(k, tau, nu)
    mu_cav, s2_cav, tau_cav, nu_cav = _cavity(mu, sigma2, tau, nu, floor)
    _, alpha, beta = _site_moments(derivs, mu_cav, s2_cav, y, rule)
    m_hat = mu_cav + s2_cav * alpha
    v_hat = s2_cav * (1.0 + s2_cav * beta)
    v_hat = torch.maximum(v_hat, 1e-12 * s2_cav)
    tau_new = torch.clamp(1.0 / v_hat - tau_cav, min=floor)
    nu_new = m_hat / v_hat - nu_cav
    tau_next = (1.0 - damping) * tau + damping * tau_new
    nu_next = (1.0 - damping) * nu + damping * nu_new
    delta = torch.maximum((tau_next - tau).abs().amax(dim=-1), (nu_next - nu).abs().amax(dim=-1))
    return tau_next, nu_next, delta


def _ep_loop(k, y, derivs, maxiter, tol, damping, rule):
    """The damped fixed point on every lane of ``k`` [B, n, n], without a
    graph: (tau, nu, sweeps [B] int32)."""
    bsz, n = k.shape[0], k.shape[-1]
    floor = _tau_floor(k.dtype)
    with torch.no_grad():
        tau = torch.full((bsz, n), floor, dtype=k.dtype, device=k.device)
        nu = torch.zeros_like(tau)
        delta = torch.full((bsz,), math.inf, dtype=k.dtype, device=k.device)
        it = torch.zeros((bsz,), dtype=torch.int32, device=k.device)
        while True:
            active = (it < maxiter) & (delta > tol)
            if not bool(active.any()):
                break
            tau2, nu2, d = _ep_sweep(k, y, derivs, tau, nu, rule, damping, floor)
            # a NaN change (failed factorization) stops the lane; its NaN sites propagate to logZ
            d = torch.nan_to_num(d, nan=0.0)
            tau = torch.where(active[:, None], tau2, tau)
            nu = torch.where(active[:, None], nu2, nu)
            delta = torch.where(active, d, delta)
            it = it + active.to(torch.int32)
    return tau, nu, it



def gp_ep_state(k, y, lik: LatentLikelihood, maxiter: int = 60, tol=None, damping: float = 0.7,
                num_quad_points: int = 32) -> EPState:
    """Run damped parallel EP to its fixed point on every matrix of ``k``
    [..., n, n]; returns the converged :class:`EPState` (no gradient)."""
    kf, y, lead = _flat(k, y)
    tol = _default_tol(kf.dtype) if tol is None else tol
    kf = kf.detach()
    rule = _gh_rule(int(num_quad_points), kf.dtype, kf.device)
    tau, nu, it = _ep_loop(kf, y, lik._derivs(), int(maxiter), tol, float(damping), rule)
    with torch.no_grad():
        mu, sigma2, _, _ = _posterior_from_sites(kf, tau, nu)
    n = kf.shape[-1]
    return EPState(*(t.reshape(*lead, n) for t in (tau, nu, mu, sigma2)), iterations=it.reshape(lead))


def _logz_at_sites(k, y, derivs, tau, nu, rule):
    """log Z_EP at converged sites (module-docstring identity)."""
    floor = _tau_floor(k.dtype)
    mu, sigma2, ell, _ = _posterior_from_sites(k, tau, nu)
    mu_cav, s2_cav, _, _ = _cavity(mu, sigma2, tau, nu, floor)
    logz_hat, _, _ = _site_moments(derivs, mu_cav, s2_cav, y, rule, want_derivs=False)
    tau_s = torch.clamp(tau, min=floor)
    mu_site = nu / tau_s
    denom = s2_cav + 1.0 / tau_s
    z = torch.linalg.solve_triangular(ell, (nu / torch.sqrt(tau_s)).unsqueeze(-1), upper=False).squeeze(-1)
    return (logz_hat.sum(dim=-1) + 0.5 * torch.log1p(tau_s * s2_cav).sum(dim=-1)
            + 0.5 * ((mu_cav - mu_site) ** 2 / denom).sum(dim=-1)
            - torch.log(torch.diagonal(ell, dim1=-2, dim2=-1)).sum(dim=-1) - 0.5 * (z * z).sum(dim=-1))


class _EPLogML(torch.autograd.Function):
    """log Z_EP with the closed-form stationary gradient in K (GPML 5.27).

    Inputs (k, value, tau, nu): the value is computed outside; ``tau`` and
    ``nu`` carry their dependence on K (module docstring).  The backward
    gives the gradient for ``k`` alone, in differentiable ops."""

    generate_vmap_rule = True

    @staticmethod
    def forward(k, value, tau, nu):
        return value.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        k, _, tau, nu = inputs
        ctx.save_for_backward(k, tau, nu)

    @staticmethod
    def backward(ctx, g):
        k, tau, nu = ctx.saved_tensors
        st = torch.sqrt(tau)
        b_inv = _inv_from_chol(_b_factor(k, st))
        r = st.unsqueeze(-1) * b_inv * st.unsqueeze(-2)  # (K + S^-1)^-1
        pos = st > 0
        b = st * _mv(b_inv, torch.where(pos, nu / torch.where(pos, st, torch.ones_like(st)), torch.zeros_like(nu)))
        dk = g[..., None, None] * 0.5 * (b.unsqueeze(-1) * b.unsqueeze(-2) - r)
        return dk, None, None, None


def gp_ep_log_marginal(k, y, lik: LatentLikelihood, maxiter: int = 60, tol=None, damping: float = 0.7,
                       num_quad_points: int = 32) -> torch.Tensor:
    """EP-approximate log marginal likelihood log Z_EP(y | X, theta)
    (GPML eq. 3.65) of every matrix of ``k`` [..., n, n], with the
    closed-form stationary gradient.  ``k`` is symmetrized on entry."""
    kf, y, lead = _flat(k, y)
    tol = _default_tol(kf.dtype) if tol is None else float(tol)
    kf = 0.5 * (kf + kf.mT)
    derivs = lik._derivs()
    rule = _gh_rule(int(num_quad_points), kf.dtype, kf.device)
    tau, nu, _ = _ep_loop(kf.detach(), y, derivs, int(maxiter), tol, float(damping), rule)
    with torch.no_grad():
        value = _logz_at_sites(kf, y, derivs, tau, nu, rule)
    if not (torch.is_grad_enabled() and kf.requires_grad):
        return value.reshape(lead)
    # one undamped sweep from the detached fixed point with the graph on
    tau1, nu1, _ = _ep_sweep(kf, y, derivs, tau, nu, rule, 1.0, _tau_floor(kf.dtype))
    out = _EPLogML.apply(kf, value, _straight_through(tau, tau1), _straight_through(nu, nu1))
    return out.reshape(lead)


def gp_ep_latent_moments(k, y, lik: LatentLikelihood, k_cross, k_query_diag, maxiter: int = 60, tol=None,
                         damping: float = 0.7, num_quad_points: int = 32):
    """EP latent predictive moments at query points (GPML 3.60-3.61):

        mu*    = k*^T S^1/2 B^-1 S^-1/2 nu
        sig*^2 = k** - || L^-1 (S^1/2 k*) ||^2

    ``k`` [..., n, n], ``k_cross`` [..., n, q], ``k_query_diag`` [..., q];
    returns (mu, var), each [..., q]; no gradient."""
    with torch.no_grad():
        kf, y, lead = _flat(k, y)
        n = kf.shape[-1]
        tol = _default_tol(kf.dtype) if tol is None else tol
        rule = _gh_rule(int(num_quad_points), kf.dtype, kf.device)
        tau, nu, _ = _ep_loop(kf, y, lik._derivs(), int(maxiter), tol, float(damping), rule)
        st = torch.sqrt(tau)
        ell = _b_factor(kf, st)
        # mu* = k*^T (nu - S^1/2 B^-1 S^1/2 K nu)  [GPML 3.60 rearranged]
        w1 = torch.linalg.solve_triangular(ell, (st * _mv(kf, nu)).unsqueeze(-1), upper=False)
        w2 = torch.linalg.solve_triangular(ell.mT, w1, upper=True).squeeze(-1)
        kc = torch.as_tensor(k_cross, dtype=kf.dtype, device=kf.device)
        kc = kc.expand(*lead, *kc.shape[-2:]).reshape(-1, n, kc.shape[-1])
        mu = (kc.mT @ (nu - st * w2).unsqueeze(-1)).squeeze(-1)
        v = torch.linalg.solve_triangular(ell, st.unsqueeze(-1) * kc, upper=False)
        kqd = torch.as_tensor(k_query_diag, dtype=kf.dtype, device=kf.device).reshape(mu.shape)
        var = torch.clamp(kqd - (v * v).sum(dim=-2), min=0.0)
        q = mu.shape[-1]
        return mu.reshape(*lead, q), var.reshape(*lead, q)
