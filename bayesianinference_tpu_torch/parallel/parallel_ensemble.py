"""The affine-invariant ensemble with its red/black sweep over the whole
ensemble on one card (port of
``bayesianinference_tpu.parallel.parallel_ensemble``).

The JAX function shards each half of the ensemble over a ``walkers`` mesh
axis: a shard updates its part of half A against all of half B (one
``all_gather``), then its part of B against all of the updated A.  On one
card each half is one batch and the gather is the half itself, so a sweep
is :func:`..ops.ensemble.ensemble_sweep`: half A (``[:W/2]``) against the
whole of half B (``[W/2:]``), then B against the updated A.  That is
:func:`..engines.ensemble.ensemble_sample` for a problem, with its warmup,
``thinning`` and acceptance of the recorded sweeps; the walkers move in
the box bijection's z-space.

Not ported: the compiled program and its cache
(``_parallel_ensemble_program``), the default mesh and the check that the
half divides by the shard count, which cannot fail with one shard;
``mesh=`` raises.  The JAX function keys each shard and splits that key
locally, so it is not ``ensemble_sample`` draw for draw; here random
numbers are inputs (``draws``: the two halves' ``StretchDraws`` or
``DEDraws`` with a leading sweep axis, warmup first), from which a run of
the JAX function on a mesh can be replayed.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engines.ensemble import EnsembleResult, ensemble_sample
from ..models.problem import InferenceProblem
from ._mesh import refuse_mesh

__all__ = ["parallel_ensemble"]


def parallel_ensemble(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_walkers: int = 256,
    num_samples: int = 500,
    num_warmup: int = 500,
    thinning: int = 1,
    move: str = "stretch",
    stretch_scale: Optional[float] = None,
    gamma_jump_prob: Optional[float] = None,
    mesh=None,
    starting_points=None,
    draws=None,
) -> EnsembleResult:
    """Ensemble sampling of a problem with ``num_walkers`` walkers (even,
    at least 2d + 2) as two half-batches on the problem's device:
    :func:`..engines.ensemble.ensemble_sample` for a problem.  Walkers
    start at prior draws from ``generator`` (None: one on the problem's
    device seeded 0) or at ``starting_points`` [num_walkers, d]."""
    refuse_mesh("parallel_ensemble", mesh)
    if not isinstance(problem, InferenceProblem):
        raise ValueError("parallel_ensemble takes an InferenceProblem")
    return ensemble_sample(problem, generator, num_walkers=num_walkers, num_samples=num_samples,
                           num_warmup=num_warmup, thinning=thinning, move=move, stretch_scale=stretch_scale,
                           gamma_jump_prob=gamma_jump_prob, starting_points=starting_points, draws=draws)
