"""Replicate SMC ladders as one batch on one card (port of
``bayesianinference_tpu.parallel.parallel_smc``).

The ladders share nothing, so the JAX package's ``shard_map`` over a
``runs`` mesh axis needs no collective; on one card that axis is the run
axis of :func:`..engines.smc._smc_ladders`, whose stage loop already
advances all R ladders and runs their rejuvenation chains as one [R n]
batch.  Given the same generator this is :func:`..engines.smc.smc_sampler`
bit for bit, as the JAX function is ``smc_sampler`` given the same key.

Not ported: the compiled program and its cache (``_parallel_smc_program``)
and the default mesh (the largest device count dividing ``num_runs``).
``mesh=`` (the port's Mesh, a ``runs`` axis, which the runs must divide)
splits the ladders by device: the shards of one device run as one batch
there (:mod:`._mesh`).  Random numbers are inputs: ``draws`` holds one
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
from ._mesh import mesh_devices, problem_on
from .sharding import device_groups, generator_on, in_batch_order

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
    groups = [(torch.arange(num_runs, device=problem.device), problem.device)]
    if mesh is not None:
        groups = device_groups(mesh_devices("parallel_smc", mesh, "runs", num_runs, f"num_runs={num_runs}"),
                               num_runs, problem.device)
    generator = torch.Generator(device=problem.device).manual_seed(0) if generator is None else generator
    starting_points, n_particles = prepare_smc_starting_points(problem, generator, starting_points, num_runs,
                                                               n_particles)
    cfg = SMCConfig(max_stages=max_stages, mcmc_steps=mcmc_steps, ess_target=float(ess_target),
                    covariance_learn_delay=covariance_learn_delay)
    parts = [_smc_ladders(problem_on(problem, dev), starting_points[idx].to(dev), generator_on(generator, dev),
                          cfg, None if draws is None else _GroupDraws(draws, idx, dev))
             for idx, dev in groups]
    states = type(parts[0])(*(in_batch_order(f, groups, problem.device) for f in zip(*parts)))
    return states_to_result(states, cfg, problem.param_names)


class _GroupDraws:
    """Stage t's draws of the runs ``idx`` on ``dev``, made when the stage
    asks for them: ``draws`` need only be indexed by stage (it may have no
    length, as a source that makes any stage's numbers on demand)."""

    def __init__(self, draws, idx: torch.Tensor, dev):
        self.draws, self.idx, self.dev = draws, idx, dev

    def __getitem__(self, t: int) -> SMCStageDraws:
        return _draws_of(self.draws[t], self.idx, self.dev)


def _draws_of(d: SMCStageDraws, idx: torch.Tensor, dev) -> SMCStageDraws:
    """The rows of one stage's draws that belong to the runs ``idx``."""
    n_runs = d.offset.shape[0]
    rows = lambda t: t.reshape(n_runs, -1, *t.shape[1:])[idx.to(t.device)].reshape(-1, *t.shape[1:])  # noqa: E731
    return SMCStageDraws(d.offset[idx.to(d.offset.device)].to(dev), rows(d.z).to(dev), rows(d.log_u).to(dev))
