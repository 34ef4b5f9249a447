"""Replicate SMC ladders as one batch on one card (port of
``bayesianinference_tpu.parallel.parallel_smc``).

The ladders share nothing, so the JAX package's ``shard_map`` over a
``runs`` mesh axis needs no collective; on one card that axis is the run
axis of :func:`..engines.smc._smc_ladders`, whose stage loop already
advances all R ladders and runs their rejuvenation chains as one [R n]
batch.  Given the same generator this is :func:`..engines.smc.smc_sampler`
bit for bit, as the JAX function is ``smc_sampler`` given the same key.

Not ported: the compiled program and its cache (``_parallel_smc_program``),
the default mesh (the largest device count dividing ``num_runs``) and the
multiple-of-shards check, which cannot fail with one shard.  ``mesh=``
raises.  Random numbers are inputs: ``draws`` holds one
:class:`..engines.smc.SMCStageDraws` per stage, so a run of the JAX
function on a mesh can be replayed from its keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..engines.smc import (
    SMCConfig,
    SMCResult,
    SMCStageDraws,
    _smc_ladders,
    prepare_smc_starting_points,
    states_to_result,
)
from ..models.problem import InferenceProblem
from ._mesh import refuse_mesh

__all__ = ["parallel_smc"]


def parallel_smc(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_runs: int = 8,
    n_particles: int = 1000,
    mesh=None,
    starting_points=None,
    max_stages: int = 100,
    mcmc_steps: int = 10,
    ess_target: float = 0.5,
    covariance_learn_delay: int = 10,
    draws: Optional[Sequence[SMCStageDraws]] = None,
) -> SMCResult:
    """``num_runs`` independent SMC ladders as one batch on the problem's
    device; the contract (and, per generator, the result) of
    :func:`..engines.smc.smc_sampler`.  ``generator`` None is one on that
    device seeded 0; ``draws[t]`` replaces its numbers at stage t."""
    refuse_mesh("parallel_smc", mesh)
    generator = torch.Generator(device=problem.device).manual_seed(0) if generator is None else generator
    starting_points, n_particles = prepare_smc_starting_points(problem, generator, starting_points, num_runs,
                                                               n_particles)
    cfg = SMCConfig(max_stages=max_stages, mcmc_steps=mcmc_steps, ess_target=float(ess_target),
                    covariance_learn_delay=covariance_learn_delay)
    states = _smc_ladders(problem, starting_points, generator, cfg, draws)
    return states_to_result(states, cfg, problem.param_names)
