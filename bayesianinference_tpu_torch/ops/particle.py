"""Bootstrap particle filtering for nonlinear / non-Gaussian state-space
models (port of ``bayesianinference_tpu.ops.particle``).

The bootstrap filter (Gordon, Salmond & Smith 1993) gives an estimate of
p(y_{1:T} | theta) that is unbiased in p-space for any model given by
samplers and a pointwise observation density; pseudo-marginal MCMC
(``engines.particle.pmmh_sample``) needs exactly that.

Particles are a [P, ds] batch and the filter is a host loop over T.
Systematic resampling (one uniform, a cumulative sum and a
``searchsorted``) runs every step and an effective-sample-size test
selects between the resampled and the original particles with a
``where``: no data-dependent control flow and no host read, as in the
JAX package.  The filter runs C models at once on an explicit chain axis
(one model is C = 1); PMMH's chains go through
:func:`batched_log_likelihood`, which maps only the user's samplers and
density over the chains with ``torch.func.vmap``.

Randomness: the model's samplers draw from the ``torch.Generator`` they
are handed (where the JAX samplers take a key), and the resampling
uniforms are an input (``uniforms`` [T]) or come from that generator.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import filter_logsumexp

__all__ = [
    "ParticleModel",
    "ParticleFilterResult",
    "particle_filter",
    "particle_log_likelihood",
    "particle_forecast",
]


class ParticleModel(NamedTuple):
    """A state-space model as samplers and a pointwise density:

    * ``init_sampler(generator, num_particles) -> [P, ds]``
    * ``transition_sampler(generator, particles, t) -> [P, ds]``
    * ``observation_log_prob(particles, y_t, t) -> [P]``

    ``t`` is the step's index (a Python int); the samplers draw from
    ``generator``."""

    init_sampler: Callable
    transition_sampler: Callable
    observation_log_prob: Callable


class ParticleFilterResult(NamedTuple):
    log_likelihood: torch.Tensor  # estimate of log p(y | theta)
    filter_means: torch.Tensor  # [T, ds] weighted posterior means
    ess: torch.Tensor  # [T] effective sample size before resampling


def _systematic_resample(u, log_w, particles, grid=None, weights=None):
    """Systematic resampling with offsets ``u`` [...]: positions (u + i) / P
    against the cumulative weights of ``log_w`` [..., P]; the equally
    weighted particles [..., P, ...].  ``grid`` is 0..P-1 in ``log_w``'s
    dtype and ``weights`` softmax(log_w), when the caller has them."""
    p = log_w.shape[-1]
    cum = torch.cumsum(torch.softmax(log_w, dim=-1) if weights is None else weights, dim=-1)
    if grid is None:
        grid = torch.arange(p, dtype=log_w.dtype, device=log_w.device)
    idx = torch.clamp(torch.searchsorted(cum, (u[..., None] + grid) / p), 0, p - 1)
    if log_w.dim() == 1:
        return particles[idx]
    idx = idx.reshape(idx.shape + (1,) * (particles.dim() - idx.dim()))
    return torch.take_along_dim(particles, idx, dim=log_w.dim() - 1)


def _resample_uniforms(generator, uniforms, shape, like: torch.Tensor):
    if uniforms is not None:
        return torch.as_tensor(uniforms, dtype=like.dtype, device=like.device)
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def _filter(init, move, y, num_particles: int, generator, ess_threshold: float, uniforms, moments: bool = True):
    """The bootstrap filter of C models at once: ``init(generator, P)`` ->
    particles [C, P, ds]; ``move(generator, particles, y_t, t)`` -> the
    propagated particles [C, P, ds] and their observation log-densities
    [C, P]; ``uniforms`` [C, T].  Returns
    (final particles, final normalized log-weights [C, P], log-likelihoods
    [C], means [C, T, ds], ESS [C, T]); without ``moments`` the means and
    ESS are not kept (None), as a compiled JAX program drops the outputs
    nobody reads."""
    particles = init(generator, num_particles)
    y = torch.as_tensor(y, device=particles.device)
    c, p = particles.shape[0], num_particles
    u = _resample_uniforms(generator, uniforms, (c, y.shape[0]), particles)
    kw = dict(dtype=particles.dtype, device=particles.device)
    log_uniform = torch.full((p,), -math.log(p), **kw)
    grid = torch.arange(p, **kw)
    log_w, ll = log_uniform.expand(c, p), torch.zeros((c,), **kw)
    means, esss = [], []
    for t in range(y.shape[0]):
        # propagate through the transition prior (bootstrap proposal)
        particles, log_obs = move(generator, particles, y[t], t)
        log_w_new = log_w + log_obs
        # increment log sum w'_i - log sum w_i (w need not be uniform); the
        # two sums as one reduction over their rows
        lse_new, lse_old = filter_logsumexp(torch.stack([log_w_new, log_w.expand_as(log_w_new)]))
        ll = ll + lse_new - lse_old
        log_w_norm = log_w_new - lse_new[:, None]
        # the normalized weights, which the resampling reads too: ESS =
        # 1 / sum w^2, the JAX package's exp(-logsumexp(2 log w)) to rounding
        # (a NaN weight makes it NaN, and the step does not resample)
        w = torch.softmax(log_w_norm, dim=-1)
        ess = 1.0 / torch.sum(w * w, dim=-1)
        if moments:
            means.append(torch.sum(w[..., None] * particles, dim=1))
            esss.append(ess)
        resampled = _systematic_resample(u[:, t], log_w_norm, particles, grid, weights=w)
        do_res = ess < ess_threshold * p
        particles = torch.where(do_res[:, None, None], resampled, particles)
        log_w = torch.where(do_res[:, None], log_uniform, log_w_norm)
    if not moments:
        return particles, log_w, ll, None, None
    return particles, log_w, ll, torch.stack(means, dim=1), torch.stack(esss, dim=1)


def _one(model: ParticleModel, y, num_particles, generator, ess_threshold, uniforms, moments=True):
    """:func:`_filter` of one model (C = 1), the chain axis taken off again."""
    def move(g, x, y_t, t):
        x = model.transition_sampler(g, x[0], t)
        return x[None], model.observation_log_prob(x, y_t, t)[None]

    out = _filter(lambda g, n: model.init_sampler(g, n)[None], move, y, num_particles, generator, ess_threshold,
                  None if uniforms is None else uniforms[None], moments)
    return tuple(None if o is None else o[0] for o in out)


def batched_log_likelihood(model_builder: Callable, theta, y, num_particles: int, generator, ess_threshold: float,
                           uniforms) -> torch.Tensor:
    """Bootstrap-filter estimates [C] for C parameter vectors theta [C, d] of
    ``model_builder(theta) -> ParticleModel``: one filter over [C, P, ds].
    The models' samplers and densities are mapped over the chains by
    ``torch.func.vmap`` (different randomness per chain; one builder call
    and one map a step), the weights and resampling run on the explicit
    chain axis.  ``uniforms`` [C, T]."""
    def move_one(th, x, y_t, g, t):
        model = model_builder(th)
        x = model.transition_sampler(g, x, t)
        return x, model.observation_log_prob(x, y_t, t)

    init = torch.func.vmap(lambda th, g, n: model_builder(th).init_sampler(g, n), in_dims=(0, None, None),
                           randomness="different")
    move = torch.func.vmap(move_one, in_dims=(0, 0, None, None, None), randomness="different")
    return _filter(lambda g, n: init(theta, g, n), lambda g, x, y_t, t: move(theta, x, y_t, g, t), y, num_particles,
                   generator, ess_threshold, uniforms, moments=False)[2]


def particle_filter(model: ParticleModel, y, num_particles: int, generator: Optional[torch.Generator],
                    ess_threshold: float = 0.5, uniforms=None) -> ParticleFilterResult:
    """Run the bootstrap filter over ``y`` [T, ...].  Resampling triggers
    when ESS < ess_threshold * P (1.0 = always, 0.0 = never); ``uniforms``
    [T] are the resampling offsets (drawn from ``generator`` when None)."""
    _, _, ll, means, ess = _one(model, y, num_particles, generator, ess_threshold, uniforms)
    return ParticleFilterResult(log_likelihood=ll, filter_means=means, ess=ess)


def particle_forecast(model: ParticleModel, y, horizon: int, num_particles: int,
                      generator: Optional[torch.Generator], ess_threshold: float = 0.5, uniforms=None):
    """Forecast the latent state ``horizon`` steps past the data: filter
    ``y``, resample the terminal cloud to equal weights, then propagate it
    through the transition sampler.  Returns particles [horizon, P, ds].
    ``uniforms`` [T + 1]: the filter's offsets, then the terminal one."""
    t_total = torch.as_tensor(y).shape[0]
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms)
        filt_u, last_u = uniforms[:t_total], uniforms[t_total]
    else:
        filt_u, last_u = None, None
    particles, log_w, _, _, _ = _one(model, y, num_particles, generator, ess_threshold, filt_u, moments=False)
    if last_u is None:
        last_u = torch.rand((), generator=generator, dtype=particles.dtype, device=particles.device)
    particles = _systematic_resample(torch.as_tensor(last_u, dtype=particles.dtype, device=particles.device),
                                     log_w, particles)
    path = []
    for h in range(horizon):
        particles = model.transition_sampler(generator, particles, t_total + h)
        path.append(particles)
    return torch.stack(path)


def particle_log_likelihood(model: ParticleModel, y, num_particles: int, generator: Optional[torch.Generator],
                            ess_threshold: float = 0.5, uniforms=None) -> torch.Tensor:
    """Marginal-likelihood estimate log p_hat(y | theta), unbiased in p-space."""
    return _one(model, y, num_particles, generator, ess_threshold, uniforms, moments=False)[2]
