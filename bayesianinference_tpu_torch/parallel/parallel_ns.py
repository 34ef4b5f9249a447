"""Run-level parallel nested sampling (port of
``bayesianinference_tpu.parallel.parallel_ns``).

R independent runs go through the loop as one batch
(:func:`~..engines.nested_sampling.run_loop_batched`): every iteration
runs the R x ``num_delete`` replacement chains of the runs still going as
one batch, so each chain step is one density call for all runs, and the
termination test is one host read for all of them.  The runs are then
merged exactly: nested sampling runs combine by the ordering of their
prior masses, so the union of their samples, with the runs' pools summed
at every level, is one run of the combined pool.

Not ported: the JAX package's ``shard_map`` program over a ``runs`` mesh
axis (``_parallel_runs_program`` and its compile cache).  ``mesh=`` (the
port's Mesh, a ``runs`` axis, which the runs must divide) splits the runs by
device: the shards of one device run as one batch there (:mod:`._mesh`), on
the whole batch's generator on the problem's device and on one seeded from
it elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..engines.evidence import NestedSamplingResult, dedup_by_point, evidence_sampling
from ..engines.nested_sampling import generate_starting_points, make_loop_config, runs_by_device
from ..models.problem import InferenceProblem
from ._mesh import mesh_devices
from .sharding import device_groups

__all__ = ["parallel_nested_sampling", "merge_runs"]


def merge_runs(
    dead_points: torch.Tensor,  # [R, cap, d]
    dead_logl: torch.Tensor,  # [R, cap]
    dead_logp: torch.Tensor,  # [R, cap]
    n_dead: Sequence[int],  # [R]
    live_points: torch.Tensor,  # [R, n, d]
    live_logl: torch.Tensor,  # [R, n]
    live_logp: torch.Tensor,  # [R, n]
    *,
    total_pool: int,
    num_delete: int = 1,
    generator: Optional[torch.Generator] = None,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    param_names=(),
) -> NestedSamplingResult:
    """Exact merge of R independent runs: each run's dead prefix and its
    live set sorted by logL, the union deduplicated by point and sorted,
    then evidence resampling with the union's last ``total_pool`` points
    (the runs' pools summed) as its live set.  Deterministic without
    resampling (``post_process_sampling_runs=None``).

    The merged pool at a death is the sum of the runs' pools at that level.
    With one deletion per iteration (``num_delete=1``) that is
    ``total_pool`` throughout, the JAX function's constant pool.  A run
    that deletes k per iteration has n - (j mod k) points left at its
    (j+1)-th death (its ``pool_schedule``), and the merge sums those.  (The
    JAX function takes the constant pool for every k, which biases logZ
    high when k > 1.)"""
    n_dead = [int(v) for v in torch.as_tensor(n_dead).tolist()]
    n_runs, n_live = live_logl.shape
    dev = live_logl.device
    order = torch.argsort(live_logl, dim=1, stable=True)
    live_points = torch.gather(live_points, 1, order[..., None].expand(-1, -1, live_points.shape[-1]))
    live_logl, live_logp = torch.gather(live_logl, 1, order), torch.gather(live_logp, 1, order)
    runs = range(n_runs)
    pts = torch.cat([torch.cat([dead_points[r, : n_dead[r]], live_points[r]]) for r in runs])
    ll = torch.cat([torch.cat([dead_logl[r, : n_dead[r]], live_logl[r]]) for r in runs])
    lp = torch.cat([torch.cat([dead_logp[r, : n_dead[r]], live_logp[r]]) for r in runs])
    run_of = torch.cat([torch.full((n_dead[r] + n_live,), r, device=dev) for r in runs])
    is_dead = torch.cat([torch.arange(n_dead[r] + n_live, device=dev) < n_dead[r] for r in runs])
    pts, ll, lp, run_of, is_dead = dedup_by_point(pts, ll, lp, run_of, is_dead)
    order = torch.argsort(ll, stable=True)
    schedule = None  # the constant combined pool
    if num_delete > 1:
        dead_of = torch.nn.functional.one_hot(run_of[order], n_runs) * is_dead[order, None]
        before = torch.cumsum(dead_of, dim=0) - dead_of  # each run's deaths below each merged point
        schedule = (n_live - before % num_delete).sum(dim=1).to(ll.dtype)
    return evidence_sampling(
        points=pts[order],
        log_likelihoods=ll[order],
        log_priors=lp[order],
        sample_pool_size=total_pool,
        schedule=schedule,
        generator=generator,
        num_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=param_names,
    )


def parallel_nested_sampling(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_runs: int = 4,
    sample_pool_size: int = 100,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    mesh=None,
    **loop_kwargs,
) -> NestedSamplingResult:
    """``num_runs`` independent runs of ``sample_pool_size`` live points
    each (the combined pool is their product), run as one batch on the
    problem's device and merged exactly.  Each run draws its own starting
    points; ``generator`` (on the problem's device) defaults to one seeded
    with 0.  ``loop_kwargs`` are the loop options of
    :func:`~..engines.nested_sampling.nested_sampling_loop` but for
    ``stop_at_log_likelihood``; ``monte_carlo_steps=None`` (the default)
    takes the chosen chains' dimension law, as a single run does.  The
    result reports the runs' evaluations summed and the most iterations
    any run made.  ``mesh``: see :mod:`._mesh`."""
    groups = [(torch.arange(num_runs, device=problem.device), problem.device)]
    if mesh is not None:
        groups = device_groups(mesh_devices("parallel_nested_sampling", mesh, "runs", num_runs,
                                            f"num_runs={num_runs}"), num_runs, problem.device)
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    cfg = make_loop_config(problem.dim, gradient_check=problem.gradient_sanity, **loop_kwargs)
    if not 1 <= cfg.num_delete < sample_pool_size:
        raise ValueError("need 1 <= num_delete < sample_pool_size")
    starts = torch.stack([generate_starting_points(problem, generator, sample_pool_size) for _ in range(num_runs)])
    runs = runs_by_device(problem, starts, generator, cfg, groups=groups, n_live=sample_pool_size)
    result = merge_runs(
        runs.dead_points, runs.dead_logl, runs.dead_logp, runs.n_dead,
        runs.live_points, runs.live_logl, runs.live_logp,
        total_pool=num_runs * sample_pool_size,
        num_delete=cfg.num_delete,
        generator=generator,
        post_process_sampling_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=problem.param_names,
    )
    return dataclasses.replace(result, num_likelihood_evals=int(runs.num_likelihood_evals.sum()),
                               iterations=max(runs.iteration) - 1)
