"""HMC chains with global adaptation on one card (port of
``bayesianinference_tpu.parallel.parallel_hmc``).

The JAX function shards the chains over a ``chains`` mesh axis and shares
the warmup through collectives: dual averaging reads the ``pmean`` of the
acceptance over all chains, the inverse mass comes from the Welford
moments merged by ``psum``, and with ``num_leapfrog="auto"`` the ChEES
chain means and gradient ride the same axis, so every shard freezes one
step size, one mass and one trajectory length.  On one card the chains are
one batch and each collective is the plain reduction over the whole chain
axis, which is what :func:`..engines.hmc.bijected_warmup_and_sample`
computes, and :func:`..engines.hmc.hmc_sample` runs it: the mean
acceptance of all chains, the moments of all chains, one trajectory
length.  Sampling shares nothing.

Not ported: the compiled program and its cache (``_parallel_hmc_program``),
the default mesh and the multiple-of-shards check, which cannot fail with
one shard; ``mesh=`` raises.  The JAX function keys each shard and splits
that key over its chains, so it is not :func:`..engines.hmc.hmc_sample`
draw for draw; here random numbers are inputs (``draws``: ``HMCDraws``,
or ``ChEESDraws`` for ``"auto"``, one row per trajectory), from which a
run of the JAX function on a mesh can be replayed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..engines.hmc import HMCResult, hmc_sample
from ..models.problem import InferenceProblem
from ._mesh import refuse_mesh

__all__ = ["parallel_hmc"]


def parallel_hmc(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_chains: int = 8,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_leapfrog: Union[int, str] = 32,
    thinning: int = 1,
    target_accept: float = 0.8,
    mesh=None,
    starting_points=None,
    initial_step_size: float = 0.1,
    dense_mass: bool = False,
    max_leapfrog: int = 256,
    draws=None,
) -> HMCResult:
    """HMC of ``num_chains`` chains as one batch on the problem's device,
    with one step size, inverse mass (``dense_mass=True``: a [d, d]
    covariance) and, for ``num_leapfrog="auto"``, one ChEES trajectory
    length adapted from all of them: :func:`..engines.hmc.hmc_sample` for a
    problem.  Chains start at prior draws from ``generator`` (None: one on
    the problem's device seeded 0) or at ``starting_points``
    [num_chains, d]."""
    refuse_mesh("parallel_hmc", mesh)
    if not isinstance(problem, InferenceProblem) or isinstance(starting_points, str):
        raise ValueError("parallel_hmc takes an InferenceProblem and starting_points [num_chains, d] or None")
    return hmc_sample(problem, generator, num_chains=num_chains, num_samples=num_samples, num_warmup=num_warmup,
                      num_leapfrog=num_leapfrog, thinning=thinning, target_accept=target_accept,
                      starting_points=starting_points, initial_step_size=initial_step_size, dense_mass=dense_mass,
                      max_leapfrog=max_leapfrog, draws=draws)
