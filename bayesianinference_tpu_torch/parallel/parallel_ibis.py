"""IBIS over the whole particle population on one card (port of
``bayesianinference_tpu.parallel.parallel_ibis``).

The JAX function shards the particles over a ``particles`` mesh axis:
each stage's prequential increment, normalization and ESS take a global
logsumexp (``pmax`` and ``psum``), the systematic resampling and the
proposal mean and covariance read the full population (one
``all_gather``), and the acceptance is a ``psum``.  On one card the
particles are one batch and every collective is the reduction over all of
them, which is :func:`..engines.ibis.ibis_sampler`: a fixed loop of
``ceil(n_obs / batch_size)`` stages over the masked pointwise likelihood
(NaN and clip guards at log-zero), each reweighting by its batch, and
below the ESS threshold resampling systematically from the whole
population and moving every particle by ``mcmc_steps`` adaptive-Metropolis
steps seeded with the resampled cloud's mean and covariance (+ 1e-10 I).
The ESS test is one host read per stage where JAX has a ``lax.cond``.

Not ported: the compiled program and its cache
(``_parallel_ibis_program``), the global-logsumexp helper and the default
mesh.  ``mesh=`` (the port's Mesh, a ``particles`` axis) runs as this batch
when its shards share the problem's device, after the JAX function's check
that the particles divide over it (:mod:`._mesh`).  The JAX function folds the shard index into each
stage's move key, so its chains' numbers differ from ``ibis_sampler``'s;
here random numbers are inputs (``starting_points``, the prior draws, and
``draws``, one :class:`..engines.ibis.IBISStageDraws` per stage), from
which a run of the JAX function on a mesh can be replayed.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..engines.ibis import IBISResult, IBISStageDraws, ibis_sampler
from ..models.problem import InferenceProblem
from ._mesh import mesh_shards

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
    """IBIS of ``n_particles`` particles as one batch on the problem's
    device; the contract of :func:`..engines.ibis.ibis_sampler`
    (``pointwise_loglike(theta, data) -> [n_obs]``).  ``mesh``: see
    :mod:`._mesh` (a ``particles`` axis)."""
    if mesh is not None:
        mesh_shards("parallel_ibis", mesh, "particles", n_particles, f"n_particles={n_particles}", problem)
    return ibis_sampler(problem, pointwise_loglike, data, generator, n_particles=n_particles,
                        batch_size=batch_size, mcmc_steps=mcmc_steps, ess_threshold=ess_threshold,
                        covariance_learn_delay=covariance_learn_delay, starting_points=starting_points, draws=draws)
