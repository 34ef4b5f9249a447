"""Nested sampling with the live-point axis sharded over a mesh (port of
``bayesianinference_tpu.parallel.sharded_pool_ns``).

One NS run whose pool of n live points is split over the P devices of a
mesh axis (n/P each).  The JAX package's ``while_loop`` inside one
``shard_map`` becomes a host loop here; each iteration:

* **global worst-k**: each shard offers its k smallest log-likelihoods (a
  stable sort), the [P k] candidates are gathered, and the k-th in
  (logL, global index) order is the threshold, so exactly k points die
  even with exact ties;
* **counts and offsets** of the dying points per shard, by an exclusive
  cumulative sum over the gathered counts;
* **the dead ledger**: the k dying points gathered and sorted; the port
  keeps the one copy, on the axis's first device, that every JAX device
  holds;
* **moments**: the ``psum`` of the shards' sums and scatters gives the
  proposal's mean and covariance estimates;
* **k/P chains per shard**, adaptive-Metropolis or slice, started at that
  shard's survivors on that shard's device;
* **routing**: the k new points are gathered, evaluated once, and each
  shard fills its dying slots by its offset.

Every random number is an input (:class:`PoolDraws`, one per iteration):
each shard's Gumbel noise, whose argmax over its survivors picks the
chains' starts (``jax.random.categorical``'s form), and its chains' draws.
:func:`pool_draws` makes them from one generator per shard; tests replay
the JAX per-shard key tree (``fold_in(k_pick, shard)``, ``fold_in(k_chain,
shard)``) through them.

The density of a chain runs on the problem's device (a problem is not
copied between devices; on one card that is the shards' device too).
``"chmc"`` and ``num_delete >= pool / P`` are refused, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.numerics import log_zero, logsumexp
from ..engines.evidence import NestedSamplingResult, evidence_sampling, evidence_sampling_padded
from ..engines.nested_sampling import default_monte_carlo_steps, generate_starting_points, resolve_monte_carlo_method
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_block, am_init, proposal_chol, run_chain_adaptive, small_cholesky
from ..ops.ns_math import crude_log_x_deleted, pool_schedule
from ..ops.slice import SliceDraws, run_slice_chain, slice_draws
from .sharding import Mesh, cat_to, make_mesh, sum_to

__all__ = ["PoolDraws", "PoolState", "pool_draws", "pool_loop_init", "pool_loop_step", "sharded_pool_nested_sampling"]


class PoolDraws(NamedTuple):
    """The random numbers of one iteration, one entry per shard (on the
    shard's device).  ``gumbels[s]`` [c, n_loc]: chain i of shard s starts
    at the survivor with the largest ``gumbels[s][i]``.  Adaptive
    Metropolis: ``z[s]`` [c, d, steps] and ``log_u[s]`` [c, steps], one
    :func:`~..ops.metropolis.am_block`; slice: ``slice[s]`` a
    :class:`~..ops.slice.SliceDraws` with a leading update axis."""

    gumbels: List[torch.Tensor]
    z: Optional[List[torch.Tensor]] = None
    log_u: Optional[List[torch.Tensor]] = None
    slice: Optional[List[SliceDraws]] = None


def pool_draws(generators: Sequence[torch.Generator], cfg: "PoolConfig", dim: int, dtype) -> PoolDraws:
    """One iteration's draws from one generator per shard."""
    gumbels, z, log_u, sl = [], [], [], []
    for g in generators:
        kw = dict(generator=g, dtype=dtype, device=g.device)
        u = torch.rand((cfg.c, cfg.n_loc), **kw)
        gumbels.append(-torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny))))
        if cfg.method == "slice":
            sl.append(slice_draws(g, cfg.c, dim, num_updates=cfg.mc[0], dtype=dtype))
        else:
            zz = torch.randn((cfg.c, dim, cfg.mc[0]), **kw)
            z.append(zz)
            log_u.append(torch.log(1e-38 + (1.0 - 1e-38) * torch.rand((cfg.c, cfg.mc[0]), **kw)))
    if cfg.method == "slice":
        return PoolDraws(gumbels, slice=sl)
    return PoolDraws(gumbels, z, log_u)


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """The static configuration of a pool-sharded loop."""

    n: int  # the whole pool
    k: int  # deletions per iteration
    n_loc: int  # live points per shard
    c: int  # chains per shard, k / P
    capacity: int
    mc: Tuple[int, int, int]
    min_max_acceptance_rate: Tuple[float, float]
    covariance_learn_delay: int
    method: str  # "adaptive_metropolis" or "slice"
    max_iterations: int
    min_iterations: int
    termination_fraction: float


@dataclasses.dataclass
class PoolState:
    """The loop's state: the live points per shard (on their devices) and
    the replicated rest once, on the axis's first device."""

    live: List[torch.Tensor]  # per shard [n_loc, d]
    logl: List[torch.Tensor]  # per shard [n_loc]
    logp: List[torch.Tensor]
    dead_points: torch.Tensor  # [capacity, d]
    dead_logl: torch.Tensor  # [capacity]
    dead_logp: torch.Tensor
    n_dead: int
    iteration: int  # 1 before the first
    mean_est: torch.Tensor  # [d]
    cov_est: torch.Tensor  # [d, d]
    evals: torch.Tensor  # int64 on the first device
    log_z: torch.Tensor
    log_missing: torch.Tensor


def _moments(live: Sequence[torch.Tensor], n: int, device):
    """The pool's mean and covariance (n - 1 denominator) by two ``psum``s."""
    gmean = sum_to([x.sum(dim=0) for x in live], device) / n
    scatter = []
    for x in live:
        c = x - gmean.to(x.device)
        scatter.append(c.mT @ c)
    return gmean, sum_to(scatter, device) / (n - 1)


def pool_loop_init(starts: Sequence[torch.Tensor], log_likelihoods: Sequence[Callable], log_prior: Callable, *,
                   n: int, capacity: int) -> PoolState:
    """The loop's first state from each shard's starting points [n_loc, d]
    (on its device); ``log_likelihoods[s]`` is shard s's batched guarded
    likelihood, ``log_prior`` the batched guarded prior."""
    first = starts[0].device
    dtype, dim = starts[0].dtype, starts[0].shape[1]
    lz = log_zero(dtype)
    gmean, gcov = _moments(starts, n, first)
    kw = dict(dtype=dtype, device=first)
    return PoolState(
        live=list(starts),
        logl=[ll(x).to(dtype) for ll, x in zip(log_likelihoods, starts)],
        logp=[log_prior(x).to(dtype) for x in starts],
        dead_points=torch.zeros((capacity, dim), **kw),
        dead_logl=torch.full((capacity,), lz, **kw),
        dead_logp=torch.full((capacity,), lz, **kw),
        n_dead=0,
        iteration=1,
        mean_est=gmean,
        cov_est=gcov,
        evals=torch.zeros((), dtype=torch.int64, device=first),
        log_z=torch.full((), lz, **kw),
        log_missing=torch.zeros((), **kw),
    )


def _worst_k(logl: Sequence[torch.Tensor], k: int, n_loc: int, first):
    """(threshold logL, its global index): the k-th smallest of the pool in
    (logL, global index) order, from each shard's k smallest."""
    cand_l, cand_g = [], []
    for s, ll in enumerate(logl):
        order = torch.argsort(ll, stable=True)[:k]
        cand_l.append(ll[order])
        cand_g.append(order + s * n_loc)
    all_l, all_g = cat_to(cand_l, first), cat_to(cand_g, first)
    order = torch.argsort(all_g, stable=True)
    order = order[torch.argsort(all_l[order], stable=True)]  # by (logL, index)
    kth = order[k - 1]
    return all_l[kth], all_g[kth]


def pool_loop_step(state: PoolState, draws: PoolDraws, cfg: PoolConfig, log_likelihoods: Sequence[Callable],
                   log_prior: Callable, in_support: Callable, generators=None) -> PoolState:
    """One iteration of the loop (module docstring).  ``generators`` (one
    per shard) run the adaptive-Metropolis retry blocks when
    ``min_max_acceptance_rate`` is not (0, 1)."""
    k, n_loc, n = cfg.k, cfg.n_loc, cfg.n
    first = state.mean_est.device
    dtype = state.mean_est.dtype
    lz = log_zero(dtype)
    n_shards = len(state.live)

    # global worst-k with the (logL, global index) tie-break
    t_logl, t_gidx = _worst_k(state.logl, k, n_loc, first)
    dying = []
    for s, ll in enumerate(state.logl):
        g_idx = torch.arange(n_loc, device=ll.device) + s * n_loc
        t_l, t_g = t_logl.to(ll.device), t_gidx.to(ll.device)
        dying.append((ll < t_l) | ((ll == t_l) & (g_idx <= t_g)))
    counts = cat_to([d.sum().reshape(1) for d in dying], first)
    offsets = torch.cumsum(counts, 0) - counts

    # the replicated dead ledger: the k dying points of the pool, sorted
    pts, gl, gp = [], [], []
    for live, ll, lp, dy in zip(state.live, state.logl, state.logp, dying):
        pad = torch.argsort(torch.where(dy, ll, torch.full_like(ll, math.inf)), stable=True)[:k]
        pts.append(live[pad])
        gl.append(torch.where(dy[pad], ll[pad], torch.full_like(ll[pad], math.inf)))
        gp.append(lp[pad])
    g_logl = cat_to(gl, first)
    g_order = torch.argsort(g_logl, stable=True)[:k]  # the valid ones first, ascending
    slots = slice(state.n_dead, state.n_dead + k)
    dead_points, dead_logl, dead_logp = state.dead_points.clone(), state.dead_logl.clone(), state.dead_logp.clone()
    dead_points[slots] = cat_to(pts, first)[g_order]
    dead_logl[slots] = g_logl[g_order]
    dead_logp[slots] = cat_to(gp, first)[g_order]

    # the proposal's moment estimates
    _, gcov = _moments(state.live, n, first)
    cov_est = 0.5 * (state.cov_est + gcov)

    # k / P constrained chains per shard, started at its survivors.  The
    # shards that share a device run their chains as one batch there: each
    # chain's arithmetic is its own, so this changes no value.
    new_x, means, covs, proposed = [None] * n_shards, [None] * n_shards, [None] * n_shards, [None] * n_shards
    groups = {}
    for s in range(n_shards):
        groups.setdefault(state.live[s].device, []).append(s)
    for dev, members in groups.items():
        thr, mean_d, cov_d = t_logl.to(dev), state.mean_est.to(dev), cov_est.to(dev)
        ll_d = log_likelihoods[members[0]]

        def density(x, ll_d=ll_d, thr=thr):
            ok = in_support(x) & (ll_d(x) > thr)
            return torch.where(ok, log_prior(x), torch.full((), lz, dtype=x.dtype, device=x.device))

        x0 = []
        for s in members:
            surv = torch.where(dying[s], -math.inf, 0.0).to(dtype)
            x0.append(state.live[s][torch.argmax(draws.gumbels[s] + surv, dim=-1)])
        x0 = torch.cat(x0)
        if cfg.method == "slice":
            eye = torch.eye(x0.shape[1], dtype=dtype, device=dev)
            dir_chol = small_cholesky(cov_d + 1e-10 * eye)
            dir_chol = torch.where(torch.isfinite(dir_chol).all(), dir_chol, eye)
            d = SliceDraws(*(torch.cat(f, dim=1) for f in zip(*(draws.slice[s] for s in members))))
            st = run_slice_chain(d, x0, density, dir_chol)
            chain_mean, chain_cov, chain_evals = None, None, st.evals
        else:
            st = am_init(x0, density, mean0=mean_d, cov0=cov_d, t0=10, chol0=proposal_chol(cov_d))
            st = am_block(st, density, torch.cat([draws.z[s] for s in members]),
                          torch.cat([draws.log_u[s] for s in members]), cfg.covariance_learn_delay)
            lo, hi = cfg.min_max_acceptance_rate
            if not (lo <= 0.0 and hi >= 1.0):
                # the retry blocks past the first (the JAX function's inner while_loop)
                st, _ = run_chain_adaptive(generators[members[0]], st, density, 0, cfg.mc[1], cfg.mc[2], lo, hi,
                                           cfg.covariance_learn_delay)
            chain_mean, chain_cov, chain_evals = st.mean, st.cov, st.proposed
        for j, s in enumerate(members):
            rows = slice(j * cfg.c, (j + 1) * cfg.c)
            new_x[s] = st.x[rows]
            means[s] = mean_d if chain_mean is None else chain_mean[rows].mean(dim=0)
            covs[s] = cov_d if chain_cov is None else chain_cov[rows].mean(dim=0)
            proposed[s] = chain_evals[rows].sum()

    # route the k new points into the shards' dying slots
    g_new = cat_to(new_x, first)  # [k, d]
    g_new_logl = log_likelihoods[0](g_new).to(dtype)
    g_new_logp = log_prior(g_new).to(dtype)
    live, logl, logp = [], [], []
    for s, dy in enumerate(dying):
        dev = dy.device
        rank = torch.cumsum(dy.to(torch.int64), 0) - 1
        idx = torch.clamp(offsets[s].to(dev) + rank, 0, k - 1)
        live.append(torch.where(dy[:, None], g_new.to(dev)[idx], state.live[s]))
        logl.append(torch.where(dy, g_new_logl.to(dev)[idx], state.logl[s]))
        logp.append(torch.where(dy, g_new_logp.to(dev)[idx], state.logp[s]))

    # crude evidence and the termination quantities
    n_dead = state.n_dead + k
    log_xd = _log_x_deleted(cfg, dtype, first)
    prev = torch.cat([torch.zeros((1,), dtype=dtype, device=first), log_xd[:-1]])
    w_dead = prev + torch.log1p(-torch.exp(log_xd - prev))
    active = torch.arange(cfg.capacity, device=first) < n_dead
    log_z_dead = logsumexp(torch.where(active, w_dead + dead_logl, torch.full_like(w_dead, lz)))
    x_last = log_xd[n_dead - 1]
    lmax = torch.stack([ll.max().to(first) for ll in logl]).max()
    lse_live = sum_to([torch.exp(logsumexp(ll) - lmax.to(ll.device)) for ll in logl], first)
    log_z_live = x_last + lmax + torch.log(lse_live) - math.log(n)
    cov_new = sum_to(covs, first) / n_shards
    return PoolState(
        live=live, logl=logl, logp=logp,
        dead_points=dead_points, dead_logl=dead_logl, dead_logp=dead_logp,
        n_dead=n_dead,
        iteration=state.iteration + 1,
        mean_est=sum_to(means, first) / n_shards,
        cov_est=0.5 * (cov_new + cov_new.mT),
        evals=state.evals + sum_to(proposed, first) + k,
        log_z=torch.logaddexp(log_z_dead, log_z_live),
        log_missing=x_last + lmax,
    )


@functools.lru_cache(maxsize=16)
def _log_x_deleted(cfg: PoolConfig, dtype, device) -> torch.Tensor:
    return crude_log_x_deleted(pool_schedule(cfg.n, cfg.k, cfg.capacity, dtype=dtype, device=device))


def pool_loop_running(state: PoolState, cfg: PoolConfig) -> bool:
    """The loop's condition; past ``min_iterations`` one host read of the
    termination test."""
    if state.iteration > cfg.max_iterations:
        return False
    if state.iteration <= cfg.min_iterations:
        return True
    return bool(state.log_missing > state.log_z + math.log(cfg.termination_fraction))


def run_pool_loop(state: PoolState, cfg: PoolConfig, log_likelihoods, log_prior, in_support, generators,
                  draws: Optional[Sequence[PoolDraws]] = None) -> PoolState:
    """Iterate until the condition fails: each iteration takes the next of
    ``draws``, or makes its own from ``generators``."""
    dim, dtype = state.mean_est.shape[0], state.mean_est.dtype
    it = 0
    while pool_loop_running(state, cfg):
        if draws is not None:
            if it >= len(draws):
                raise ValueError(f"draws cover {len(draws)} iterations; the run needs more")
            d = draws[it]
        else:
            d = pool_draws(generators, cfg, dim, dtype)
        state = pool_loop_step(state, d, cfg, log_likelihoods, log_prior, in_support, generators)
        it += 1
    return state


def on_own_device(fn: Callable) -> Callable:
    """``fn`` (a problem's batched density, which runs on the problem's
    device) with its result returned to its argument's device."""
    return lambda x: fn(x).to(x.device)


def pool_config(n: int, k: int, n_dev: int, dim: int, *, max_iterations, min_iterations, monte_carlo_steps,
                termination_fraction, min_max_acceptance_rate, covariance_learn_delay, monte_carlo_method,
                engine: str, sizes: str) -> PoolConfig:
    """Validate a pool-sharded run's options (the JAX package's errors)."""
    if n % n_dev or k % n_dev:
        raise ValueError(f"{sizes} {n} and num_delete {k} must be multiples of the {engine} {n_dev}")
    n_loc, c = n // n_dev, k // n_dev
    if k >= n_loc:
        raise ValueError(f"num_delete {k} must be < pool/devices = {n_loc} so every device keeps survivors to seed "
                         "its chains")
    # no gradient check: the chain bodies are the gradient-free slice and AM kernels
    method = resolve_monte_carlo_method(monte_carlo_method, dim)
    if method == "chmc":
        raise ValueError("monte_carlo_method='chmc' is not supported by the pool-sharded NS engine (its chain "
                         "body implements the slice and adaptive-Metropolis kernels); use slice here or the "
                         "single-device/parallel-runs engines for constrained HMC")
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(method, dim)
    if isinstance(monte_carlo_steps, int):
        mc = (monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps)
    else:
        mc = tuple(monte_carlo_steps)
    return PoolConfig(n=n, k=k, n_loc=n_loc, c=c, capacity=max_iterations * k, mc=mc,
                      min_max_acceptance_rate=tuple(min_max_acceptance_rate),
                      covariance_learn_delay=covariance_learn_delay, method=method, max_iterations=max_iterations,
                      min_iterations=min_iterations, termination_fraction=float(termination_fraction))


def shard_generators(generator: torch.Generator, devices) -> list:
    """One generator per shard on its device, seeded from ``generator``."""
    seeds = torch.randint(0, 2**62, (len(devices),), generator=generator, device=generator.device).tolist()
    return [torch.Generator(device=d).manual_seed(int(s)) for d, s in zip(devices, seeds)]


def sharded_pool_nested_sampling(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    sample_pool_size: int,
    mesh: Optional[Mesh] = None,
    axis_name: str = "live",
    num_delete: Optional[int] = None,
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
    draws: Optional[Sequence[PoolDraws]] = None,
) -> NestedSamplingResult:
    """One pool-sharded NS run, post-processed as the single-device
    pipeline is.  ``sample_pool_size`` is the whole pool; ``num_delete``
    (default: the axis size) must be a multiple of the axis size, and the
    pool a multiple of both.  ``mesh`` defaults to every CUDA device on
    ``axis_name``.  ``generator`` (on the problem's device; default seed 0)
    draws the starting points, seeds one generator per shard for the
    iterations' draws unless ``draws`` (one :class:`PoolDraws` per
    iteration) are given, and runs the evidence resampling."""
    if mesh is None:
        mesh = make_mesh((axis_name,))
    devices = mesh.axis_devices(axis_name)
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    n = int(sample_pool_size)
    k = int(num_delete if num_delete is not None else len(devices))
    cfg = pool_config(n, k, len(devices), problem.dim, max_iterations=max_iterations, min_iterations=min_iterations,
                      monte_carlo_steps=monte_carlo_steps, termination_fraction=termination_fraction,
                      min_max_acceptance_rate=min_max_acceptance_rate,
                      covariance_learn_delay=covariance_learn_delay, monte_carlo_method=monte_carlo_method,
                      engine="mesh axis size", sizes="pool")
    if starting_points is None:
        starting_points = generate_starting_points(problem, generator, n)
    starting_points = torch.as_tensor(starting_points, dtype=problem.dtype, device=problem.device)
    gens = shard_generators(generator, devices)
    ll = on_own_device(problem.guarded_log_likelihood)
    lp, support = on_own_device(problem.guarded_log_prior), on_own_device(problem.in_support)
    starts = [starting_points[i * cfg.n_loc:(i + 1) * cfg.n_loc].to(d) for i, d in enumerate(devices)]
    state = pool_loop_init(starts, [ll] * len(devices), lp, n=n, capacity=cfg.capacity)
    state = run_pool_loop(state, cfg, [ll] * len(devices), lp, support, gens, draws)
    result = pool_result(state, cfg, generator, post_process_sampling_runs, empirical_posterior_type,
                         problem.param_names)
    return dataclasses.replace(result, num_likelihood_evals=int(state.evals), iterations=state.iteration - 1)


def pool_result(state: PoolState, cfg: PoolConfig, generator, post_process_sampling_runs, empirical_posterior_type,
                param_names) -> NestedSamplingResult:
    """Evidence post-processing of one run's capacity-padded ledger and its
    live set, as the single-device pipeline does."""
    first = state.mean_est.device
    live, logl, logp = cat_to(state.live, first), cat_to(state.logl, first), cat_to(state.logp, first)
    order = torch.argsort(logl, stable=True)
    dtype = logl.dtype
    if post_process_sampling_runs and post_process_sampling_runs > 0:
        return evidence_sampling_padded(
            dead_points=state.dead_points, dead_logl=state.dead_logl, dead_logp=state.dead_logp,
            live_points=live[order], live_logl=logl[order], live_logp=logp[order], n_dead=state.n_dead,
            schedule=pool_schedule(cfg.n, cfg.k, cfg.capacity, dtype=dtype, device=first), generator=generator,
            num_runs=int(post_process_sampling_runs), empirical_posterior_type=empirical_posterior_type,
            param_names=param_names)
    nd = state.n_dead
    return evidence_sampling(
        points=torch.cat([state.dead_points[:nd], live[order]]),
        log_likelihoods=torch.cat([state.dead_logl[:nd], logl[order]]),
        log_priors=torch.cat([state.dead_logp[:nd], logp[order]]),
        sample_pool_size=cfg.n, schedule=pool_schedule(cfg.n, cfg.k, nd, dtype=dtype, device=first),
        generator=generator, num_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type, param_names=param_names)
