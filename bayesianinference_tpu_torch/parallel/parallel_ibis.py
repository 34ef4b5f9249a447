"""IBIS over the whole particle population (port of
``bayesianinference_tpu.parallel.parallel_ibis``).

The JAX function shards the particles over a ``particles`` mesh axis:
each stage's prequential increment, normalization and ESS take a global
logsumexp (``pmax`` and ``psum``), the systematic resampling and the
proposal mean and covariance read the full population (one
``all_gather``), and the acceptance is a ``psum``.  Without a mesh the
particles are one batch on the problem's device and every collective is
the reduction over all of them, which is :func:`..engines.ibis.ibis_sampler`:
a fixed loop of ``ceil(n_obs / batch_size)`` stages over the masked
pointwise likelihood (NaN and clip guards at log-zero), each reweighting
by its batch, and below the ESS threshold resampling systematically from
the whole population and moving every particle by ``mcmc_steps``
adaptive-Metropolis steps seeded with the resampled cloud's mean and
covariance (+ 1e-10 I).  The ESS test is one host read per stage where JAX
has a ``lax.cond``.

With ``mesh=`` (the port's Mesh, a ``particles`` axis dividing the
particles) each shard holds its block of the particles on its device, with
the data and its copy of the problem there, and the collectives combine
the shards in axis order on the problem's device
(``ibis_sampler(shards=)``): one run of the same code, whatever the
devices.

Not ported: the compiled program and its cache
(``_parallel_ibis_program``) and the default mesh.  The JAX function folds
the shard index into each stage's move key, so its chains' numbers differ
from ``ibis_sampler``'s; here random numbers are inputs
(``starting_points``, the prior draws, and ``draws``, one
:class:`..engines.ibis.IBISStageDraws` per stage over all particles, each
shard taking its rows), from which a run of the JAX function on a mesh can
be replayed.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..engines.ibis import IBISResult, IBISStageDraws, ibis_sampler
from ..models.problem import InferenceProblem
from ._mesh import check_movable, shard_axis

__all__ = ["parallel_ibis"]


def parallel_ibis(
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
    mesh=None,
    starting_points=None,
    draws: Optional[Sequence[Optional[IBISStageDraws]]] = None,
) -> IBISResult:
    """IBIS of ``n_particles`` particles, as one batch on the problem's
    device without a mesh, else split over ``mesh``'s ``particles`` axis;
    the contract of :func:`..engines.ibis.ibis_sampler`
    (``pointwise_loglike(theta, data) -> [n_obs]``)."""
    kw = dict(n_particles=n_particles, batch_size=batch_size, mcmc_steps=mcmc_steps, ess_threshold=ess_threshold,
              covariance_learn_delay=covariance_learn_delay, starting_points=starting_points, draws=draws)
    shards, problems = shard_axis("parallel_ibis", mesh, "particles", n_particles, f"n_particles={n_particles}",
                                  problem)
    for dev in set(shards.devices) - {problem.device}:
        check_movable(pointwise_loglike, dev, "pointwise_loglike")
    return ibis_sampler(problem, pointwise_loglike, data, generator, shards=shards, shard_problems=problems, **kw)
