"""Nested sampling over a runs x live x data mesh (port of
``bayesianinference_tpu.parallel.multi_axis_ns``).

Three parallel axes in one call:

* ``runs``: independent pool-sharded runs, merged by
  :func:`~.parallel_ns.merge_runs`; nothing crosses this axis;
* ``live``: each run's pool split over its slice of the mesh, driven by
  the loop of :mod:`.sharded_pool_ns` (its gathers and sums stay within
  the run);
* ``data``: the likelihood's observation axis split over the devices of a
  ``(run, live)`` position; a density call sends the points to each data
  shard's device, evaluates ``local_log_likelihood`` there and sums the
  partial values back (one ``psum`` over ``data`` a call).

Departures from the JAX function: the chains of a ``(run, live)`` position
run once, on its ``data`` index 0 device, where JAX runs them on every data
shard (identical copies); the runs run one after another; the merge sums
the runs' k-deletion pool schedules (``merge_runs(num_delete=k)``), where
the JAX merge takes a constant pool, which biases logZ high for k > 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core.numerics import guard_log_density
from ..engines.evidence import NestedSamplingResult
from ..engines.nested_sampling import generate_starting_points
from ..models.problem import InferenceProblem
from .parallel_ns import merge_runs
from .sharded_pool_ns import (
    on_own_device,
    pool_config,
    pool_loop_init,
    run_pool_loop,
    shard_generators,
)
from .sharding import Mesh, make_mesh

__all__ = ["multi_axis_nested_sampling", "make_multi_axis_mesh"]


def make_multi_axis_mesh(runs: int, live: int, data: int, devices=None) -> Mesh:
    """Mesh over ``runs * live * data`` devices (default: every CUDA
    device) with the axes ("runs", "live", "data"); "data", one sum per
    density call, innermost.  A device may repeat in ``devices``."""
    devices = list(make_mesh(("all",)).devices.flat) if devices is None else list(devices)
    need = runs * live * data
    if len(devices) < need:
        raise ValueError(f"mesh ({runs}, {live}, {data}) needs {need} devices, found {len(devices)}")
    return make_mesh(("runs", "live", "data"), shape=(runs, live, data), devices=devices[:need])


def _data_sharded_likelihood(local: Callable, shards, devices) -> Callable:
    """The batched guarded likelihood of points on any device: the partial
    sums of ``local(theta, shard)`` on each data shard's device, summed
    (the ``psum`` over "data") on the points' device."""
    per_point = [torch.func.vmap(lambda th, s=s: local(th, s)) for s in shards]

    def log_likelihood(x):
        total = None
        for f, dev in zip(per_point, devices):
            part = f(x.to(dev)).to(x.device)
            total = part if total is None else total + part
        return guard_log_density(total)

    return log_likelihood


def multi_axis_nested_sampling(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    mesh: Mesh,
    sample_pool_size: int,
    num_delete: Optional[int] = None,
    data=None,
    local_log_likelihood: Optional[Callable] = None,
    max_iterations: int = 1000,
    min_iterations: int = 10,
    monte_carlo_steps=None,
    termination_fraction: float = 0.01,
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0),
    covariance_learn_delay: int = 10,
    starting_points=None,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    monte_carlo_method: str = "auto",
) -> NestedSamplingResult:
    """``mesh.shape['runs']`` independent pool-sharded runs, merged.

    ``sample_pool_size`` is the pool of each run, split over "live" (a
    multiple of it, with ``num_delete`` as in
    :func:`~.sharded_pool_ns.sharded_pool_nested_sampling`).  Data
    sharding: pass ``data`` (observations first, a multiple of the "data"
    axis size) with ``local_log_likelihood(theta [d], data_shard) -> the
    shard's log-likelihood sum``; without them the problem's likelihood is
    used and the "data" axis must have size 1.  ``starting_points`` [runs,
    pool, d] is for tests; by default each run draws its own from the
    prior with ``generator`` (on the problem's device, default seed 0),
    which also seeds the shards' draws and runs the merge's resampling."""
    for ax in ("runs", "live", "data"):
        if ax not in mesh.shape:
            raise ValueError(f"mesh must have axes ('runs', 'live', 'data'); missing {ax!r} (size-1 axes are fine; "
                             "see make_multi_axis_mesh)")
    n_runs, n_live_dev, n_data_dev = mesh.shape["runs"], mesh.shape["live"], mesh.shape["data"]
    n = int(sample_pool_size)
    k = int(num_delete if num_delete is not None else n_live_dev)
    if n % n_live_dev or k % n_live_dev:
        raise ValueError(f"per-run pool {n} and num_delete {k} must be multiples of the 'live' axis size {n_live_dev}")
    if k >= n // n_live_dev:
        raise ValueError(f"num_delete {k} must be < pool/live-devices = {n // n_live_dev}")
    if (data is None) != (local_log_likelihood is None):
        raise ValueError("pass data and local_log_likelihood together (or neither)")
    if data is None and n_data_dev != 1:
        raise ValueError("a data axis of size > 1 needs data + local_log_likelihood (otherwise every data shard "
                         "replicates the same likelihood)")
    if data is not None:
        data = torch.as_tensor(data)
        if data.shape[0] % n_data_dev:
            raise ValueError(f"data length {data.shape[0]} must be a multiple of the 'data' axis size {n_data_dev}")
    cfg = pool_config(n, k, n_live_dev, problem.dim, max_iterations=max_iterations, min_iterations=min_iterations,
                      monte_carlo_steps=monte_carlo_steps, termination_fraction=termination_fraction,
                      min_max_acceptance_rate=min_max_acceptance_rate,
                      covariance_learn_delay=covariance_learn_delay, monte_carlo_method=monte_carlo_method,
                      engine="'live' axis size", sizes="per-run pool")
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    if starting_points is None:
        starting_points = torch.stack([generate_starting_points(problem, generator, n) for _ in range(n_runs)])
    starting_points = torch.as_tensor(starting_points, dtype=problem.dtype, device=problem.device)
    if tuple(starting_points.shape[:2]) != (n_runs, n):
        raise ValueError(f"starting_points must be [runs={n_runs}, pool={n}, d]; got {tuple(starting_points.shape)}")

    lp, support = on_own_device(problem.guarded_log_prior), on_own_device(problem.in_support)
    per_data = 0 if data is None else data.shape[0] // n_data_dev
    runs = []
    for r in range(n_runs):
        devices = [mesh.devices[r, i, 0] for i in range(n_live_dev)]
        if data is None:
            lls = [on_own_device(problem.guarded_log_likelihood)] * n_live_dev
        else:
            lls = []
            for i in range(n_live_dev):
                data_devs = [mesh.devices[r, i, j] for j in range(n_data_dev)]
                shards = [data[j * per_data:(j + 1) * per_data].to(dev) for j, dev in enumerate(data_devs)]
                lls.append(_data_sharded_likelihood(local_log_likelihood, shards, data_devs))
        starts = [starting_points[r, i * cfg.n_loc:(i + 1) * cfg.n_loc].to(d) for i, d in enumerate(devices)]
        state = pool_loop_init(starts, lls, lp, n=n, capacity=cfg.capacity)
        runs.append(run_pool_loop(state, cfg, lls, lp, support, shard_generators(generator, devices)))

    first = mesh.first_device
    stack = lambda f: torch.stack([getattr(s, f).to(first) for s in runs])  # noqa: E731
    live = lambda f: torch.stack([torch.cat([t.to(first) for t in getattr(s, f)]) for s in runs])  # noqa: E731
    result = merge_runs(
        stack("dead_points"), stack("dead_logl"), stack("dead_logp"), [s.n_dead for s in runs],
        live("live"), live("logl"), live("logp"),
        total_pool=n_runs * n, num_delete=k, generator=generator,
        post_process_sampling_runs=post_process_sampling_runs, empirical_posterior_type=empirical_posterior_type,
        param_names=problem.param_names,
    )
    return dataclasses.replace(result, num_likelihood_evals=int(sum(int(s.evals) for s in runs)),
                               iterations=max(s.iteration for s in runs) - 1)
