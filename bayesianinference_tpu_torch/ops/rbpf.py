"""Rao-Blackwellized particle filtering (port of
``bayesianinference_tpu.ops.rbpf``).

For conditionally linear-Gaussian models (Doucet, de Freitas, Murphy &
Russell 2000): a nonlinear substate u_t carried by particles and a linear
substate x_t marginalized exactly by one Kalman filter per particle,

    u_1 ~ p(u_1),  u_t ~ f(u_t | u_{t-1})                (particles)
    x_1 ~ N(m0(u_1), P0(u_1))
    x_t = A(u_t) x_{t-1} + c(u_t) + w_t,  w_t ~ N(0, Q(u_t))
    y_t = H(u_t) x_t + d(u_t) + v_t,      v_t ~ N(0, R(u_t)).

Time starts at the first observation, as in :mod:`.kalman` and :mod:`.hmm`:
no transition before y_1.  The importance weight is the per-particle
innovation likelihood, so the estimate stays unbiased in p-space with the
x-dimensions out of the Monte Carlo.

Particles are [P, du] with Kalman moments [P, dx] and [P, dx, dx]; the
``linear_*`` callables take one particle's u, as in the JAX package, and
are mapped over the particles with ``torch.func.vmap``; systematic
resampling moves (u, m, P) together under the ESS test's ``where``.  The
transition draw at t = 1 is made and discarded, as the JAX package's
branch-free step makes it, so a generator's stream stays aligned with the
JAX key tree.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import LOG2PI, filter_logsumexp
from .metropolis import small_cholesky
from .particle import _resample_uniforms, _systematic_resample

__all__ = [
    "RBPFModel",
    "RBPFResult",
    "rbpf_filter",
    "rbpf_log_likelihood",
]



class RBPFModel(NamedTuple):
    """A conditionally linear-Gaussian model:

    * ``init_sampler(generator, num_particles) -> u0 [P, du]``
    * ``transition_sampler(generator, u, t) -> u' [P, du]``
    * ``linear_init(u0) -> (m0 [dx], P0 [dx, dx])`` for one particle
    * ``linear_transition(u, t) -> (A [dx, dx], c [dx], Q [dx, dx])``
    * ``linear_observation(u, t) -> (H [dy, dx], d [dy], R [dy, dy])``

    The ``linear_*`` callables take one particle's u (the filter maps them
    with ``torch.func.vmap``); ``t`` is a Python int."""

    init_sampler: Callable
    transition_sampler: Callable
    linear_init: Callable
    linear_transition: Callable
    linear_observation: Callable


class RBPFResult(NamedTuple):
    log_likelihood: torch.Tensor  # estimate of log p(y | theta)
    nonlinear_means: torch.Tensor  # [T, du] weighted particle means
    linear_means: torch.Tensor  # [T, dx] weighted Kalman means
    ess: torch.Tensor  # [T] effective sample size before resampling


def rbpf_filter(model: RBPFModel, y, num_particles: int, generator: Optional[torch.Generator],
                ess_threshold: float = 0.5, uniforms=None) -> RBPFResult:
    """Run the marginalized filter over ``y`` [T, dy] (or [T]); ``uniforms``
    [T] are the resampling offsets (drawn from ``generator`` when None)."""
    u = model.init_sampler(generator, num_particles)
    y = torch.as_tensor(y, device=u.device)
    if y.dim() == 1:
        y = y[:, None]
    dy = y.shape[1]
    offsets = _resample_uniforms(generator, uniforms, (y.shape[0],), u)
    m, pc = torch.func.vmap(model.linear_init)(u)
    p, du, dx = num_particles, u.shape[1], m.shape[-1]
    log_uniform = torch.full((p,), -math.log(p), dtype=u.dtype, device=u.device)
    log_w, ll = log_uniform, torch.zeros((), dtype=u.dtype, device=u.device)
    eye = torch.eye(dx, dtype=u.dtype, device=u.device)
    mu, mx, esss = [], [], []
    for t in range(y.shape[0]):
        moved = model.transition_sampler(generator, u, t)
        if t > 0:  # u_1 and x_1 are the initial draws: no transition before y_1
            u = moved
        a, c, q = torch.func.vmap(lambda uu: model.linear_transition(uu, t))(u)
        h, d, r = torch.func.vmap(lambda uu: model.linear_observation(uu, t))(u)
        if t > 0:  # per-particle Kalman predict
            m = (a @ m[..., None])[..., 0] + c
            pc = a @ pc @ a.mT + q
        # innovation moments and the Rao-Blackwellized weight
        e = y[t] - ((h @ m[..., None])[..., 0] + d)
        ph = pc @ h.mT  # P H' [P, dx, dy]
        s = h @ ph + r
        ls = small_cholesky(s)
        z = torch.linalg.solve_triangular(ls, e[..., None], upper=False)[..., 0]
        logdet = torch.sum(torch.log(torch.diagonal(ls, dim1=-2, dim2=-1)), dim=-1)
        log_obs = -0.5 * torch.sum(z * z, dim=-1) - logdet - 0.5 * dy * LOG2PI
        # Kalman update, Joseph form
        gain = torch.cholesky_solve(ph.mT, ls).mT  # (S^-1 H P)' [P, dx, dy]
        m = m + (gain @ e[..., None])[..., 0]
        imkh = eye - gain @ h
        pc = imkh @ pc @ imkh.mT + gain @ r @ gain.mT

        log_w_new = log_w + log_obs
        lse_new = filter_logsumexp(log_w_new)
        ll = ll + lse_new - filter_logsumexp(log_w)
        log_w_norm = log_w_new - lse_new
        ess = torch.exp(-filter_logsumexp(2.0 * log_w_norm))
        w = torch.exp(log_w_norm)[:, None]
        mu.append(torch.sum(w * u, dim=0))
        mx.append(torch.sum(w * m, dim=0))
        esss.append(ess)
        # resample (u, m, P) jointly under the ESS test
        stacked = torch.cat([u, m, pc.reshape(p, dx * dx)], dim=1)
        do_res = ess < ess_threshold * p
        stacked = torch.where(do_res, _systematic_resample(offsets[t], log_w_norm, stacked), stacked)
        u, m, pc = stacked[:, :du], stacked[:, du:du + dx], stacked[:, du + dx:].reshape(p, dx, dx)
        log_w = torch.where(do_res, log_uniform, log_w_norm)
    return RBPFResult(log_likelihood=ll, nonlinear_means=torch.stack(mu), linear_means=torch.stack(mx),
                      ess=torch.stack(esss))


def rbpf_log_likelihood(model: RBPFModel, y, num_particles: int, generator: Optional[torch.Generator],
                        ess_threshold: float = 0.5, uniforms=None):
    """Marginal-likelihood estimate, unbiased in p-space: the drop-in for
    :func:`.particle.particle_log_likelihood` on conditionally
    linear-Gaussian models."""
    return rbpf_filter(model, y, num_particles, generator, ess_threshold, uniforms).log_likelihood
