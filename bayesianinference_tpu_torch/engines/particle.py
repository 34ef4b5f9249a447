"""Particle-marginal Metropolis-Hastings for nonlinear state-space models
(port of ``bayesianinference_tpu.engines.particle``).

The bootstrap filter's unbiased likelihood estimate (:mod:`..ops.particle`,
or the Rao-Blackwellized :mod:`..ops.rbpf` for an ``RBPFModel``) drives a
pseudo-marginal MH chain (Andrieu & Roberts 2009): carrying the estimate of
the current point makes the chain target the exact posterior.

All chains advance together: each MH step runs every chain's filter as one
[C, P, ds] batch (:func:`..ops.particle.batched_log_likelihood`: the
models' samplers mapped over the chains by ``torch.func.vmap`` with
different randomness per chain; an RBPF model's whole filter is mapped so),
and accepts or rejects with
``where``, so a step reads nothing back to the host.  Proposal scales adapt
per chain toward 0.234 acceptance during warmup (Robbins-Monro in log
space), frozen after; the box rides the unconstrained bijection with its
log-Jacobian.  The proposal normals, accept uniforms and resampling
offsets are :class:`PMMHDraws`; the filters' own samplers draw from the
generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.device import resolve_device
from ..core.numerics import log_zero
from ..core.transforms import box_bijection
from ..models.problem import define_inference_problem
from ..ops.particle import batched_log_likelihood
from ..ops.rbpf import RBPFModel, rbpf_log_likelihood

__all__ = ["PMMHResult", "PMMHDraws", "pmmh_draws", "pmmh_sample"]


@dataclasses.dataclass(frozen=True)
class PMMHResult:
    """Samples [C, S, d] (after warmup), their log-likelihood estimates
    [C, S], acceptance rate per chain [C] and the adapted proposal scales
    [C, d]; ``points`` and ``log_weights`` make it a weighted-sample carrier."""

    samples: torch.Tensor
    log_likelihoods: torch.Tensor
    acceptance_rate: torch.Tensor
    proposal_scales: torch.Tensor

    @property
    def points(self):
        return self.samples.reshape(-1, self.samples.shape[-1])

    @property
    def log_weights(self):
        return torch.zeros(self.points.shape[0], dtype=self.samples.dtype, device=self.samples.device)


class PMMHDraws(NamedTuple):
    """The chain's random inputs: proposal ``normals`` [steps, C, d], accept
    ``uniforms`` [steps, C] on [1e-12, 1), and the filters' resampling
    offsets ``resample`` [steps + 1, C, T] (row 0 for the starting point's
    estimate)."""

    normals: torch.Tensor
    uniforms: torch.Tensor
    resample: torch.Tensor


def pmmh_draws(generator: torch.Generator, num_steps: int, num_chains: int, dim: int, num_obs: int, *,
               dtype=None, device=None) -> PMMHDraws:
    """:class:`PMMHDraws` from ``generator``."""
    kw = dict(generator=generator, dtype=dtype, device=device if device is not None else generator.device)
    u = torch.rand((num_steps, num_chains), **kw)
    return PMMHDraws(normals=torch.randn((num_steps, num_chains, dim), **kw), uniforms=1e-12 + (1.0 - 1e-12) * u,
                     resample=torch.rand((num_steps + 1, num_chains, num_obs), **kw))


def pmmh_sample(
    model_builder: Callable,
    y,
    parameters,
    generator: Optional[torch.Generator] = None,
    *,
    num_particles: int = 256,
    num_samples: int = 500,
    num_warmup: int = 500,
    num_chains: int = 8,
    thin: int = 1,
    prior_distribution=None,
    log_prior=None,
    initial_scale: float = 0.2,
    ess_threshold: float = 0.5,
    target_acceptance: float = 0.234,
    mesh=None,
    axis_name: str = "chains",
    draws: Optional[PMMHDraws] = None,
    device=None,
) -> PMMHResult:
    """Sample p(theta | y) for a particle state-space model.

    ``model_builder(theta) -> ParticleModel`` for one theta [d], or an
    ``RBPFModel`` for a conditionally linear-Gaussian model (the type is
    read once, from the first chain's start, and the marginalized filter
    takes over).  A ``ParticleModel`` is built anew under ``vmap`` at every
    filter step, so work that only one sampler needs belongs inside it.
    ``parameters`` are (name, low, high) boxes; the prior follows
    :func:`define_inference_problem`.  Every proposal's estimate uses fresh
    randomness (the pseudo-marginal requirement).

    Chains start at prior draws from ``generator`` (the box midpoint's
    image when the prior cannot be sampled).  ``draws`` replace the
    generator's proposal, accept and resampling draws.  The problem lives
    on ``y``'s device (a tensor) or on ``device`` (the card when ``None``),
    in ``y``'s floating dtype (the default dtype for integer data).
    ``mesh`` (the port's :class:`~..parallel.sharding.Mesh`) splits the
    chains over ``mesh.shape[axis_name]`` shards, a multiple of it each;
    with no collective between chains, the shards that share a device run
    as one batch there (on one device the result is the unsharded run's),
    and a shard on another device runs on a generator of its own seeded
    from ``generator``."""
    if isinstance(y, torch.Tensor):
        y = y if device is None else y.to(torch.device(device))
    else:
        y = torch.as_tensor(y, device=resolve_device(device))
    dtype = y.dtype if y.is_floating_point() else torch.get_default_dtype()
    y = y.to(dtype)
    # the problem layer parses the prior and the box only
    problem = define_inference_problem(parameters=parameters, log_likelihood=lambda th: th.sum() * 0.0,
                                       prior_distribution=prior_distribution, log_prior=log_prior, validate=False,
                                       device=y.device, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=y.device).manual_seed(0)
    bij = box_bijection(problem.lower, problem.upper)
    c, d = num_chains, problem.dim
    total_steps = num_warmup + num_samples * thin
    if draws is None:
        draws = pmmh_draws(generator, total_steps, c, d, y.shape[0], dtype=dtype, device=y.device)

    from ..parallel.sharding import check_mesh, device_groups, generator_on, in_batch_order

    groups = [(torch.arange(c, device=y.device), y.device)]
    if mesh is not None:
        n_shards = check_mesh(mesh, "pmmh_sample").shape[axis_name]
        if c % n_shards:
            raise ValueError(f"num_chains={c} must be a multiple of the mesh '{axis_name}' axis size {n_shards}")
        groups = device_groups(mesh.axis_devices(axis_name), c, y.device)

    try:
        u0 = bij.to_z(problem.prior_distribution.sample(generator, (c,)).to(dtype).reshape(c, d))
    except (NotImplementedError, AttributeError):
        u0 = torch.zeros((c, d), dtype=dtype, device=y.device)
    out = [_pmmh_chains(model_builder, y.to(dev), problem, bij, u0[idx].to(dev),
                        PMMHDraws(*(t[:, idx.to(t.device)].to(dev) for t in draws)), generator_on(generator, dev),
                        num_particles, num_warmup, num_samples, thin, initial_scale, ess_threshold, target_acceptance)
           for idx, dev in groups]
    return PMMHResult(*(in_batch_order([getattr(o, f) for o in out], groups, y.device)
                        for f in ("samples", "log_likelihoods", "acceptance_rate", "proposal_scales")))


def _pmmh_chains(model_builder, y, problem, bij, u, draws: PMMHDraws, generator, num_particles, num_warmup,
                 num_samples, thin, initial_scale, ess_threshold, target_acceptance) -> PMMHResult:
    """The chains started at ``u`` [C, d], all on ``y``'s device, as one batch."""
    c, d = u.shape
    dtype = y.dtype
    lz = log_zero(dtype)
    total_steps = num_warmup + num_samples * thin
    # dispatch once on the model type: an RBPFModel gets the marginalized filter
    if isinstance(model_builder(bij.to_x(u[:1].to(problem.device))[0]), RBPFModel):
        def one(th, offsets):
            return rbpf_log_likelihood(model_builder(th), y, num_particles, generator, ess_threshold, offsets)

        batched = torch.func.vmap(one, randomness="different")
    else:
        def batched(theta, offsets):
            return batched_log_likelihood(model_builder, theta, y, num_particles, generator, ess_threshold, offsets)

    home = problem.device  # the prior and the box live there

    def to_x(u):
        return bij.to_x(u.to(home)).to(u.device)

    def parts(u, offsets):
        theta = to_x(u)
        lp = (torch.func.vmap(problem.log_prior)(theta.to(home)) + bij.log_jacobian(u.to(home))).to(u.device)
        ll = batched(theta, offsets)
        return lp, torch.where(torch.isnan(ll), torch.full_like(ll, lz), ll)

    lp, ll = parts(u, draws.resample[0])
    log_scale = torch.full((c, d), math.log(initial_scale), dtype=dtype, device=y.device)
    acc = torch.zeros((c,), dtype=torch.int64, device=y.device)
    thetas, lls = [], []
    for t in range(total_steps):
        u_new = u + torch.exp(log_scale) * draws.normals[t]
        lp_new, ll_new = parts(u_new, draws.resample[t + 1])
        accept = torch.log(draws.uniforms[t]) < (lp_new + ll_new) - (lp + ll)
        u = torch.where(accept[:, None], u_new, u)
        lp = torch.where(accept, lp_new, lp)
        ll = torch.where(accept, ll_new, ll)  # the pseudo-marginal carry
        if t < num_warmup:  # warmup-only Robbins-Monro adaptation toward the target
            log_scale = log_scale + (1.0 / math.sqrt(1.0 + t)) * (accept.to(dtype) - target_acceptance)[:, None]
        else:
            acc = acc + accept
        thetas.append(to_x(u))
        lls.append(ll)
    keep = slice(num_warmup, None, thin if thin > 1 else 1)
    samples = torch.stack(thetas[keep][:num_samples], dim=1)
    return PMMHResult(samples=samples, log_likelihoods=torch.stack(lls[keep][:num_samples], dim=1),
                      acceptance_rate=acc.to(dtype) / (num_samples * thin), proposal_scales=torch.exp(log_scale))
