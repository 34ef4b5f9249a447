"""IBIS: iterated batch importance sampling, data-tempered SMC (port of
``bayesianinference_tpu.engines.ibis``).

IBIS (Chopin 2002) anneals through data prefixes,

    pi_t(theta) ∝ prior(theta) prod_{j < c_t} p(y_j | theta),

so after each batch of observations the particles are the current
posterior, and the log-evidence decomposes into prequential one-step-ahead
scores log p(y_batch_t | y_{<t}).

Each stage reweights by the new batch (the full pointwise log-likelihood
matrix against a prefix mask, as in the JAX package), then reads the ESS
test once on the host: the JAX package's ``lax.cond`` becomes a Python
``if``, so quiet stages skip the move.  A move resamples systematically and
rejuvenates every particle with one block of adaptive-Metropolis steps
(:mod:`..ops.metropolis`), seeded with the resampled cloud's mean and
covariance.  A stage's random inputs are :class:`IBISStageDraws` (the
resampling offset and the block's normals and log-uniforms), replayable
from another run.  The particles may be split over the shards of a mesh
axis (``shards=``, for :func:`..parallel.parallel_ibis`): the stage's
weights then meet in a logsumexp across the shards and the move reads the
population gathered on the home device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..core.numerics import log_zero
from ..core.shards import ShardAxis
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_block, am_init, proposal_chol
from ..ops.particle import _systematic_resample

__all__ = ["IBISResult", "IBISStageDraws", "ibis_stage_draws", "ibis_sampler"]


@dataclasses.dataclass(frozen=True)
class IBISResult:
    """Streaming-posterior output.  ``log_predictives[t]`` = log p(y_batch_t
    | y_earlier); their sum is ``log_evidence``.  ``points`` and
    ``log_weights`` plug into every consumer."""

    particles: torch.Tensor  # [n, d]
    log_weights_: torch.Tensor  # [n] normalized
    log_evidence: torch.Tensor
    log_predictives: torch.Tensor  # [num_stages]
    ess_history: torch.Tensor  # [num_stages] ESS before any resample
    resampled: torch.Tensor  # [num_stages] bool
    acceptance_history: torch.Tensor  # [num_stages] (nan where no move)

    @property
    def points(self):
        return self.particles

    @property
    def log_weights(self):
        return self.log_weights_


class IBISStageDraws(NamedTuple):
    """One stage's random inputs: the resampling ``offset`` (a uniform), and
    the move's normals ``z`` [n, d, steps] and acceptance log-uniforms
    ``log_u`` [n, steps] (see :func:`..ops.metropolis.am_draws`)."""

    offset: torch.Tensor
    z: torch.Tensor
    log_u: torch.Tensor


def ibis_stage_draws(generator: torch.Generator, n: int, d: int, steps: int, *, dtype=None,
                     device=None) -> IBISStageDraws:
    """:class:`IBISStageDraws` from ``generator``."""
    kw = dict(generator=generator, dtype=dtype, device=device if device is not None else generator.device)
    u = torch.rand((n, steps), **kw)
    return IBISStageDraws(offset=torch.rand((), **kw), z=torch.randn((n, d, steps), **kw),
                          log_u=torch.log(1e-38 + (1.0 - 1e-38) * u))


def ibis_sampler(
    problem: InferenceProblem,
    pointwise_loglike: Callable,
    data,
    generator: Optional[torch.Generator] = None,
    *,
    n_particles: int = 1024,
    batch_size: int = 1,
    mcmc_steps: int = 30,
    ess_threshold: float = 0.5,
    covariance_learn_delay: int = 10,
    starting_points=None,
    draws: Optional[Sequence[Optional[IBISStageDraws]]] = None,
    shards=None,
    shard_problems=None,
) -> IBISResult:
    """Run IBIS over ``data`` (leading axis = observations).

    ``problem`` supplies the prior (sampleable), box and support guard;
    ``pointwise_loglike(theta, data) -> [n_obs]`` the per-observation
    log-densities of one theta [d] (mapped over the particles with
    ``torch.func.vmap``).  The particles start at ``starting_points`` [n, d]
    or at prior draws from ``generator`` (default: seed 0 on the problem's
    device); ``draws`` holds one :class:`IBISStageDraws` (or None) per stage,
    read only by the stages that move.

    With ``shards`` (a :class:`..core.shards.ShardAxis` whose home is
    the problem's device, and each shard's copy of the problem in
    ``shard_problems``) each shard holds its block of the particles on its
    device, with the data there: the stage's increment, normalization and
    ESS come from the global logsumexp of the shards' weights, the
    resampling and the proposal's mean and covariance from the population
    gathered on the home device (each shard moving its rows of the
    resampled cloud), and the acceptance from the shards' counts summed,
    as the JAX package's ``parallel_ibis`` does."""
    data = torch.as_tensor(data, device=problem.device)
    data = data.to(problem.dtype) if data.is_floating_point() else data
    n_obs = data.shape[0]
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    num_stages = -(-n_obs // batch_size)
    dtype, dev = problem.dtype, problem.device
    lz = log_zero(dtype)
    n, d = n_particles, problem.dim
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if shards is None:
        shards, shard_problems = ShardAxis.one(dev), [problem]
    on_shards = shards.send(data)
    obs = [torch.arange(n_obs, device=x.device) for x in on_shards]
    pointwise = [torch.func.vmap(functools.partial(_with_data, pointwise_loglike, x)) for x in on_shards]

    def masked_sum(lps, mask):
        val = torch.sum(torch.where(mask, lps, torch.zeros((), dtype=lps.dtype, device=lps.device)), dim=-1)
        return torch.clamp(torch.where(torch.isnan(val), torch.full_like(val, lz), val), lz, -lz)

    def stage_density(p, pw, idx, cut):
        def density(x):
            val = p.guarded_log_prior(x) + masked_sum(pw(x), idx < cut)
            return torch.where(p.in_support(x), val, torch.full_like(val, lz))

        return density

    if starting_points is None:
        particles = problem.prior_distribution.sample(generator, (n,))
    else:
        particles = starting_points
    particles = shards.split(torch.as_tensor(particles, dtype=dtype, device=dev).reshape(n, d))
    log_uniform = shards.split(torch.full((n,), -math.log(n), dtype=dtype, device=dev))
    log_w, log_z = log_uniform, torch.zeros((), dtype=dtype, device=dev)
    preds, esss, res, accs = [], [], [], []
    for t in range(num_stages):
        lo, hi = t * batch_size, min(t * batch_size + batch_size, n_obs)
        # reweight by the new batch
        lw_raw = [lw + masked_sum(pw(x), (idx >= lo) & (idx < hi)) for lw, pw, x, idx in
                  zip(log_w, pointwise, particles, obs)]
        norm = shards.logsumexp(lw_raw)
        inc = norm - shards.logsumexp(log_w)
        log_w = [lw - c for lw, c in zip(lw_raw, shards.send(norm))]
        ess = torch.exp(-shards.logsumexp([2.0 * lw for lw in log_w]))
        do_res = bool(ess < ess_threshold * n)  # the stage's one host read
        acc = torch.full((), math.nan, dtype=dtype, device=dev)
        if do_res:
            st_draws = draws[t] if draws is not None and draws[t] is not None else ibis_stage_draws(
                generator, n, d, mcmc_steps, dtype=dtype, device=dev)
            resampled = _systematic_resample(st_draws.offset, shards.gather(log_w), shards.gather(particles))
            mean = torch.mean(resampled, dim=0)
            cov = torch.cov(resampled.T).reshape(d, d) + 1e-10 * torch.eye(d, dtype=dtype, device=dev)
            moved, accepted = [], []
            for p, pw, idx, x, m, c, f, z, log_u in zip(
                    shard_problems, pointwise, obs, shards.split(resampled), shards.send(mean), shards.send(cov),
                    shards.send(proposal_chol(cov)), shards.split(st_draws.z), shards.split(st_draws.log_u)):
                density = stage_density(p, pw, idx, hi)
                state = am_block(am_init(x, density, mean0=m, cov0=c, t0=10, chol0=f), density, z, log_u,
                                 covariance_learn_delay)
                moved.append(state.x)
                accepted.append(torch.sum(state.accepted))
            particles, log_w = moved, log_uniform
            acc = shards.sum(accepted).to(dtype) / (n * mcmc_steps)
        log_z = log_z + inc
        preds.append(inc)
        esss.append(ess)
        res.append(do_res)
        accs.append(acc)
    return IBISResult(particles=shards.gather(particles), log_weights_=shards.gather(log_w), log_evidence=log_z,
                      log_predictives=torch.stack(preds), ess_history=torch.stack(esss),
                      resampled=torch.tensor(res, device=dev), acceptance_history=torch.stack(accs))


def _with_data(pointwise_loglike, data, theta):
    return pointwise_loglike(theta, data)
