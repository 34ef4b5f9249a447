"""Dynamic nested sampling with each stage's batches run as one batch of
runs (port of ``bayesianinference_tpu.parallel.parallel_dynamic_ns``).

Dynamic NS is sequential between stages (each stage's logL interval
depends on the merged run so far), but the batches of one stage are
independent: R constrained runs of ``batch_size`` live points at one
constraint level merge exactly, since
:func:`..engines.dynamic_ns.merge_segments` counts births and deaths per
segment.  So the base run is R unconstrained runs of ``sample_pool_size``
live points, and each of the ``ceil(num_batches / R)`` stages is one
:func:`..engines.nested_sampling.run_loop_batched` call over R runs,
seeded by ``_stage_seeds`` (R x ``batch_size`` decorrelated points above
the stage's lower level) and stopped at its upper level.  The single-run
engine is the same function with R = 1 (``_dynamic_runs`` in
:mod:`..engines.dynamic_ns`), so the two cannot drift.

The one stated departure: the JAX function reads R from the size of its
mesh's ``runs`` axis, which by default takes every device.  On one card R
is the number of runs folded into the batch, the argument ``num_runs``
(default 1, what the JAX default gives on one device).

Not ported: the compiled programs and their cache (``_batch_runs_program``,
the base run through ``_parallel_runs_program``) and the default mesh;
``mesh=`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engines.dynamic_ns import _dynamic_runs
from ..engines.evidence import NestedSamplingResult
from ..models.problem import InferenceProblem
from ._mesh import refuse_mesh

__all__ = ["parallel_dynamic_nested_sampling"]


def parallel_dynamic_nested_sampling(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_runs: int = 1,
    mesh=None,
    **options,
) -> NestedSamplingResult:
    """Dynamic nested sampling on the problem's device with ``num_runs``
    runs (R) a stage: the options and semantics of
    :func:`..engines.dynamic_ns.dynamic_nested_sampling` (less
    ``starting_points``), but the base run is R runs of
    ``sample_pool_size`` live points and each stage adds R batches of
    ``batch_size`` live points at one constraint interval, so
    ``num_batches`` batches take ``ceil(num_batches / R)`` stages (rounded
    up to a multiple of R).  The user's ``min_iterations`` applies to the
    base run; the batches run from ``min_iterations=1`` to their level.
    ``generator`` None is one on the problem's device seeded 0."""
    refuse_mesh("parallel_dynamic_nested_sampling", mesh)
    return _dynamic_runs(problem, generator, num_runs, None, **options)
