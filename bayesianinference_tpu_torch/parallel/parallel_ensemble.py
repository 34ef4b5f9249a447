"""The affine-invariant ensemble with its red/black sweep over the whole
ensemble (port of ``bayesianinference_tpu.parallel.parallel_ensemble``).

The JAX function shards each half of the ensemble over a ``walkers`` mesh
axis: a shard updates its part of half A against all of half B (one
``all_gather``), then its part of B against all of the updated A.  Without
a mesh each half is one batch on the problem's device and the gather is
the half itself, so a sweep is :func:`..ops.ensemble.ensemble_sweep`: half A
(``[:W/2]``) against the whole of half B (``[W/2:]``), then B against the
updated A.  That is :func:`..engines.ensemble.ensemble_sample` for a
problem, with its warmup, ``thinning`` and acceptance of the recorded
sweeps; the walkers move in the box bijection's z-space.

With ``mesh=`` (the port's Mesh, a ``walkers`` axis dividing each half)
shard s holds block s of each half on its device and moves it against the
whole complementary half, gathered on the problem's device and sent back
(:func:`..ops.ensemble.shard_sweep`), with its densities on that device's
copy of the problem (:mod:`._mesh`): a GP problem's kernels then run on
every card.  The DE move's spread is taken over the whole gathered half.

Not ported: the compiled program and its cache
(``_parallel_ensemble_program``) and the default mesh.  The JAX function
keys each shard and splits that key locally, so it is not
``ensemble_sample`` draw for draw; here random numbers are inputs
(``draws``: the two halves' ``StretchDraws`` or ``DEDraws`` with a leading
sweep axis, warmup first, each shard taking its rows), from which a run of
the JAX function on a mesh can be replayed.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engines.ensemble import EnsembleResult, run_options, sample_problem
from ..models.problem import InferenceProblem
from ._mesh import shard_axis

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
    at least 2d + 2): as two half-batches on the problem's device without a
    mesh (the problem path of :func:`..engines.ensemble.ensemble_sample`), else
    each half split over ``mesh``'s ``walkers`` axis, which must divide it.
    Walkers start at prior draws from ``generator`` (None: one on the
    problem's device seeded 0) or at ``starting_points`` [num_walkers, d]."""
    if not isinstance(problem, InferenceProblem):
        raise ValueError("parallel_ensemble takes an InferenceProblem")
    options = run_options(num_walkers=num_walkers, num_warmup=num_warmup, num_samples=num_samples,
                          thinning=thinning, move=move, stretch_scale=stretch_scale,
                          gamma_jump_prob=gamma_jump_prob, draws=draws)
    shards, problems = shard_axis("parallel_ensemble", mesh, "walkers", num_walkers // 2,
                                  f"half-ensemble size {num_walkers // 2}", problem)
    return sample_problem(problem, generator, num_walkers, starting_points, options, shards, problems)
