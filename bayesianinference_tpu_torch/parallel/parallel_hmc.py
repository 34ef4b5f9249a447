"""HMC chains with global adaptation (port of
``bayesianinference_tpu.parallel.parallel_hmc``).

The JAX function shards the chains over a ``chains`` mesh axis and shares
the warmup through collectives: dual averaging reads the ``pmean`` of the
acceptance over all chains, the inverse mass comes from the Welford
moments merged by ``psum`` (the Chan combine of the shards' moments), and
with ``num_leapfrog="auto"`` the ChEES chain means, weighted gradient and
acceptance ride the same axis, so every shard freezes one step size, one
mass and one trajectory length.  Sampling shares nothing.

Without a mesh the chains are one batch on the problem's device and each
collective is the plain reduction over the chain axis:
:func:`..engines.hmc.hmc_sample`.  With ``mesh=`` (the port's Mesh, a
``chains`` axis dividing the chains) each shard runs its block of the
chains as its own batch on its device, against that device's copy of the
problem (a GP problem's model and prior go with it, :mod:`._mesh`), and
the collectives combine the shards in axis order on the problem's device
in the JAX function's order: the shards' mean acceptances averaged, the
shards' moments Chan-merged, the ChEES sums summed.  The step size, mass
and length then go back to every shard.  Four shards on one card run the
same code as four shards on four cards.

Not ported: the compiled program and its cache (``_parallel_hmc_program``),
the default mesh.  The JAX function keys each shard and splits that key
over its chains, so it is not :func:`..engines.hmc.hmc_sample` draw for
draw; here random numbers are inputs (``draws``: ``HMCDraws``, or
``ChEESDraws`` for ``"auto"``, one row per trajectory over all chains, each
shard taking its rows), from which a run of the JAX function on a mesh can
be replayed; without them each trajectory's draws of all chains come from
``generator``, the same numbers with a mesh or without.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..engines.hmc import HMCResult, kernel_options, sample_problem
from ..models.problem import InferenceProblem
from ._mesh import shard_axis

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
    """HMC of ``num_chains`` chains with one step size, inverse mass
    (``dense_mass=True``: a [d, d] covariance) and, for
    ``num_leapfrog="auto"``, one ChEES trajectory length adapted from all
    of them: as one batch on the problem's device without a mesh (the
    problem path of :func:`..engines.hmc.hmc_sample`), else each shard of
    ``mesh``'s ``chains`` axis its block.  Chains start at prior draws from
    ``generator`` (None: one on the problem's device seeded 0) or at
    ``starting_points`` [num_chains, d]."""
    if not isinstance(problem, InferenceProblem) or isinstance(starting_points, str):
        raise ValueError("parallel_hmc takes an InferenceProblem and starting_points [num_chains, d] or None")
    options = kernel_options(num_warmup=num_warmup, num_samples=num_samples, num_leapfrog=num_leapfrog,
                             thinning=thinning, target_accept=target_accept, initial_step_size=initial_step_size,
                             dense_mass=dense_mass, max_leapfrog=max_leapfrog, draws=draws)
    shards, problems = shard_axis("parallel_hmc", mesh, "chains", num_chains, f"num_chains={num_chains}", problem)
    return sample_problem(problem, generator, num_chains, starting_points, options, shards, problems)
