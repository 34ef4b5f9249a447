"""Dynamic nested sampling (port of ``bayesianinference_tpu.engines.dynamic_ns``;
Higson, Handley, Hobson & Lasenby 2019, the dynesty algorithm).

After a standard base run, extra "batch" runs put live points only inside
the logL interval that dominates the chosen importance (posterior mass,
evidence, or a blend); then all runs merge exactly into one variable-pool
run.

The merge needs no per-point birth records.  A constant-pool segment is a
list of events: ``n_live`` births at its constraint level, ``num_delete``
replacement births at each iteration's threshold (the largest logL of that
deletion batch), and one death per sample (the final live points die at
their own level, unreplaced).  Sorting the events of all segments and
counting births minus deaths gives the pool size ``m_i`` just above each
death; for one segment that is ``ops.ns_math.pool_schedule`` exactly, so
the shrinkage ``-log t_i ~ Exp(1) / m_i`` applies unchanged.

Every segment is the same loop as
:func:`.nested_sampling.nested_sampling_loop` (a batch sets
``stop_at_log_likelihood``), run through
:func:`.nested_sampling.run_loop_batched`, so that one function
(:func:`_dynamic_runs`) serves this engine (one run a stage) and the
parallel engine (R runs a stage).  The event merge is a host-side numpy sort,
once per batch stage; the evidence post-processing runs on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.device import as_float_on
from ..core.numerics import log_zero, logsumexp
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_init, proposal_chol, run_chain
from ..ops.ns_math import entropy_from_weights, log_trapezoid_weights
from .evidence import MeanAndError, NestedSamplingResult, _exponential, _mean_and_error
from .nested_sampling import (
    NSBatchState,
    NSRunData,
    default_monte_carlo_steps,
    generate_starting_points,
    make_loop_config,
    resolve_monte_carlo_method,
    runs_by_device,
    shared_factor,
    shared_factor_chains,
)

__all__ = [
    "NSSegment",
    "dynamic_nested_sampling",
    "merge_segments",
    "merged_evidence_sampling",
    "segment_from_run",
]


@dataclasses.dataclass(frozen=True)
class NSSegment:
    """One constant-pool run (base or batch) in merge normal form, on the
    host: deaths ascending in logL (the dead prefix, then the final live
    points), the pool size, and the constraint level its live points were
    born at."""

    points: np.ndarray  # [N, d] deaths, ascending logL
    log_likelihoods: np.ndarray  # [N]
    log_priors: np.ndarray  # [N]
    n_live: int
    num_delete: int
    n_dead: int  # the first n_dead entries are deletions; the rest is the tail
    constraint_logl: float  # live points born at this level (-inf: the prior)
    num_likelihood_evals: int = 0


def _segments_from_batch(b: NSBatchState, n_live: int, num_delete: int, constraint_logl: float) -> List[NSSegment]:
    """The R runs of a batch state as R segments (one copy to the host per
    array, whatever R)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    dp, dl, dpr = host(b.dead_points), host(b.dead_logl), host(b.dead_logp)
    lp, ll, lpr, evals = host(b.live_points), host(b.live_logl), host(b.live_logp), host(b.num_likelihood_evals)
    segments = []
    for r, nd in enumerate(b.n_dead):
        order = np.argsort(ll[r], kind="stable")
        segments.append(NSSegment(
            points=np.concatenate([dp[r, :nd], lp[r][order]]),
            log_likelihoods=np.concatenate([dl[r, :nd], ll[r][order]]),
            log_priors=np.concatenate([dpr[r, :nd], lpr[r][order]]),
            n_live=n_live,
            num_delete=num_delete,
            n_dead=nd,
            constraint_logl=float(constraint_logl),
            num_likelihood_evals=int(evals[r]),
        ))
    return segments


def segment_from_run(run: NSRunData, constraint_logl: float = -math.inf) -> NSSegment:
    """A loop's output as an :class:`NSSegment` (one copy to the host)."""
    return _segments_from_batch(NSBatchState.of_state(run.state), run.n_live, run.num_delete, constraint_logl)[0]


def merge_segments(segments):
    """Merge segments into one variable-pool run.

    Returns numpy arrays (points [N, d], logl [N], logp [N], schedule m [N])
    with deaths ascending in logL and ``m[i]`` the number of points alive
    just above death i's level."""
    if not segments:
        raise ValueError("need at least one segment")
    levels = np.concatenate([s.log_likelihoods for s in segments])
    points = np.concatenate([s.points for s in segments])
    logp = np.concatenate([s.log_priors for s in segments])
    order = np.argsort(levels, kind="stable")
    levels_s = levels[order]
    n_total = levels.shape[0]

    # death -> merged position, per segment
    offsets = np.cumsum([0] + [s.log_likelihoods.shape[0] for s in segments])
    pos_of = np.empty(n_total, dtype=np.int64)
    pos_of[order] = np.arange(n_total)

    # a birth counts for the deaths at merged positions strictly after its
    # activation index
    activations, counts = [], []
    for si, s in enumerate(segments):
        # initial births: the first position whose level exceeds the
        # constraint (ties at the constraint level do not see them)
        if np.isneginf(s.constraint_logl):
            a0 = 0
        else:
            a0 = int(np.searchsorted(levels_s, s.constraint_logl, side="right"))
        activations.append(a0)
        counts.append(s.n_live)
        # replacement births: k per deletion batch, at that batch's largest
        # death (its position in the merged order, so logL ties across
        # segments cannot misplace them)
        k = s.num_delete
        nb = s.n_dead // k
        if nb:
            gen = pos_of[offsets[si] + (np.arange(1, nb + 1) * k - 1)]
            activations.extend((gen + 1).tolist())
            counts.extend([k] * nb)
    births_at = np.zeros(n_total + 1, dtype=np.int64)
    np.add.at(births_at, np.asarray(activations, dtype=np.int64), np.asarray(counts, dtype=np.int64))
    m = np.cumsum(births_at)[:n_total] - np.arange(n_total)
    if m.min() < 1:
        raise AssertionError(
            "merge accounting produced a non-positive pool size: the "
            "segments are inconsistent (wrong constraint levels?)"
        )
    return points[order], levels_s, logp[order], m.astype(float)


def merged_evidence_sampling(
    *,
    points,
    log_likelihoods,
    log_priors,
    schedule,
    generator: Optional[torch.Generator] = None,
    num_runs: Optional[int] = 100,
    sample_pool_size: int = 0,
    param_names: Tuple[str, ...] = (),
    empirical_posterior_type: str = "Simple",
    device=None,
) -> NestedSamplingResult:
    """Evidence post-processing of a variable-pool (merged) run, deaths
    ascending in logL with pool sizes ``schedule``.

    There is no analytic live tail: every sample is a death, the crude
    schedule is ``logX_i = -sum_j 1 / m_j`` and the simulated trajectories
    draw ``-log t_i ~ Exp(1) / m_i`` throughout.  Tensors keep their device;
    numpy arrays go to ``device`` (default: the card)."""
    points = as_float_on(points, device)
    dev = points.device
    logl = as_float_on(log_likelihoods, dev)
    dtype = logl.dtype
    points = points.to(dtype)
    logp = as_float_on(log_priors, dev).to(dtype)
    m = as_float_on(schedule, dev).to(dtype)
    n_total = logl.shape[0]

    log_x = -torch.cumsum(1.0 / m, dim=0)
    crude_lw = log_trapezoid_weights(log_x) + logl
    crude_log_z = logsumexp(crude_lw)
    crude_entropy = entropy_from_weights(crude_lw, logl, crude_log_z)
    ll_max = logl.max()
    order = torch.argsort(-crude_lw, stable=True)
    common = dict(
        points=points[order],
        log_likelihoods=logl[order],
        log_priors=logp[order],
        crude_log_posterior_weights=(crude_lw - crude_log_z)[order],
        log_x=log_x[order],
        crude_log_evidence=crude_log_z,
        log_likelihood_maximum=ll_max,
        log_estimated_missing_evidence=log_x[-1] + ll_max,
        crude_relative_entropy=crude_entropy,
        sample_pool_size=sample_pool_size,
        generated_nested_samples=int(n_total),
        total_samples=int(n_total),
        param_names=tuple(param_names),
        empirical_posterior_type=empirical_posterior_type,
    )
    runs = int(num_runs) if num_runs and num_runs > 0 else 0
    if not runs:
        nan_n = torch.full((n_total,), math.nan, dtype=dtype, device=dev)
        nan0 = torch.tensor(math.nan, dtype=dtype, device=dev)
        return NestedSamplingResult(
            sampled_log_x=MeanAndError(nan_n, nan_n),
            log_posterior_weights=MeanAndError(nan_n, nan_n),
            log_evidence=MeanAndError(crude_log_z, nan0),
            relative_entropy=MeanAndError(crude_entropy, nan0),
            parameter_expected_values=MeanAndError(
                torch.exp(crude_lw - crude_log_z) @ points,
                torch.full((points.shape[1],), math.nan, dtype=dtype, device=dev),
            ),
            **common,
        )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    e = _exponential(generator, (runs, n_total), dtype)
    s_log_x = -torch.cumsum(e / m[None, :], dim=-1)
    log_ev_w = log_trapezoid_weights(s_log_x) + logl[None, :]
    z_samples = logsumexp(log_ev_w, dim=-1)
    log_post_w = log_ev_w - z_samples[:, None]
    post_w = torch.exp(log_post_w)
    safe_ll = torch.where(logl > 0.5 * log_zero(dtype), logl, torch.zeros_like(logl))
    return NestedSamplingResult(
        sampled_log_x=_mean_and_error(s_log_x[:, order]),
        log_posterior_weights=_mean_and_error(log_post_w[:, order]),
        log_evidence=_mean_and_error(z_samples),
        relative_entropy=_mean_and_error(post_w @ safe_ll - z_samples),
        parameter_expected_values=_mean_and_error(post_w @ points),
        posterior_weight_runs=post_w[:, order] if empirical_posterior_type != "Simple" else None,
        **common,
    )


def _decorrelate(problem: InferenceProblem, generator, candidates, threshold: float, cov, n_seeds: int,
                 steps: int, method: str):
    """``n_seeds`` rows picked from ``candidates`` (points above
    ``threshold``), each moved by a full-length chain of the kind the loop
    uses for replacements, so that they are approximately independent draws
    from the prior restricted to logL > threshold.  Returns
    (points [n_seeds, d], likelihood evaluations)."""
    idx = torch.randint(0, candidates.shape[0], (n_seeds,), generator=generator, device=candidates.device)
    seeds = candidates[idx]
    if method in ("slice", "chmc"):
        x, _, evals = shared_factor_chains(problem, generator, seeds, threshold, shared_factor(cov), method, steps)
        return x, int(evals.sum())

    def density(x):
        return problem.constrained_log_prior(x, threshold)

    st = am_init(seeds, density, mean0=seeds.mean(dim=0), t0=10, chol0=proposal_chol(cov))
    st = run_chain(generator, st, density, steps, learn_delay=10)
    return st.x, n_seeds * steps


def _stage_interval(segments, *, posterior_fraction: float, importance_fraction: float,
                    target_posterior_ess: Optional[float], device):
    """The next batch's logL interval from the merged run's importance
    (dynesty eqs. 4-5).  ``None`` once ``target_posterior_ess`` is met, else
    ``(log_l_lo, log_l_hi, points, logl)`` with the merged host arrays."""
    pts, logl_np, _, m_np = merge_segments(segments)
    logl = torch.as_tensor(logl_np, device=device)
    m = torch.as_tensor(m_np, device=device).to(logl.dtype)
    lw = log_trapezoid_weights(-torch.cumsum(1.0 / m, dim=0)) + logl
    w_post = torch.exp(lw - logsumexp(lw))
    ess = 1.0 / torch.sum(w_post * w_post)
    imp_z = 1.0 - torch.cumsum(w_post, dim=0)  # evidence importance: what is still missing
    tiny = torch.finfo(logl.dtype).tiny
    imp = posterior_fraction * w_post / torch.clamp(w_post.max(), min=tiny) + (1.0 - posterior_fraction) * (
        imp_z / torch.clamp(imp_z.max(), min=tiny)
    )
    # first and last index where the importance exceeds its share of the
    # maximum (the maximum itself always does)
    mask = (imp > importance_fraction * imp.max()).to(torch.int8)
    lo_idx = torch.argmax(mask)
    hi_idx = logl.shape[0] - 1 - torch.argmax(mask.flip(0))
    log_l_lo = torch.where(lo_idx == 0, torch.full_like(ess, -math.inf), logl[torch.clamp(lo_idx, min=1) - 1])
    ess, lo, hi = torch.stack([ess, log_l_lo, logl[hi_idx]]).tolist()  # one host read
    if target_posterior_ess and ess >= target_posterior_ess:
        return None
    return lo, hi, pts, logl_np


def _stage_seeds(problem: InferenceProblem, generator, pts, logl, log_l_lo: float, n_seeds: int, *,
                 num_delete: int, monte_carlo_steps, method: str):
    """``n_seeds`` approximately independent draws from the prior restricted
    to logL > ``log_l_lo`` (prior draws when unconstrained): merged points
    just above the constraint, decorrelated by full-length chains.  Returns
    (seeds [n_seeds, d], likelihood evaluations)."""
    if np.isneginf(log_l_lo):
        return generate_starting_points(problem, generator, n_seeds), 0
    above = np.nonzero(logl > log_l_lo)[0]
    # the least upward-biased candidates: the points just above the constraint
    candidates = pts[above[: max(n_seeds, 4 * num_delete)]]
    dim = pts.shape[1]
    cov = np.cov(pts[above].T).reshape(dim, dim) + 1e-12 * np.eye(dim)
    steps = monte_carlo_steps if isinstance(monte_carlo_steps, int) else monte_carlo_steps[0]
    as_t = lambda a: torch.as_tensor(a, dtype=problem.dtype, device=problem.device)  # noqa: E731
    return _decorrelate(problem, generator, as_t(candidates), log_l_lo, as_t(cov), n_seeds, steps, method)


def dynamic_nested_sampling(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    sample_pool_size: int = 100,
    num_batches: int = 4,
    batch_size: Optional[int] = None,
    target_posterior_ess: Optional[float] = None,
    posterior_fraction: float = 1.0,
    importance_fraction: float = 0.8,
    monte_carlo_steps=None,
    monte_carlo_method: str = "auto",
    num_delete: int = 1,
    max_iterations: int = 10000,
    batch_max_iterations: int = 5000,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    starting_points=None,
    **loop_kwargs,
) -> NestedSamplingResult:
    """Dynamic nested sampling on the problem's device.

    A standard base run of ``sample_pool_size`` live points is followed by
    up to ``num_batches`` batch runs of ``batch_size`` (default: the pool
    size) live points, each confined to the logL interval where the
    importance exceeds ``importance_fraction`` of its maximum.
    ``posterior_fraction`` blends the two importance targets: 1.0 puts the
    points on the posterior bulk, 0.0 on the evidence, values between mix
    linearly.  ``target_posterior_ess`` stops adding batches once the merged
    run's posterior effective sample size ``1 / sum(w^2)`` reaches it.

    All segments merge exactly (:func:`merge_segments`) and go through the
    variable-pool evidence post-processing; the result is a standard
    :class:`~.evidence.NestedSamplingResult`."""
    if starting_points is not None:
        starting_points = torch.as_tensor(starting_points, dtype=problem.dtype, device=problem.device)[None]
    return _dynamic_runs(
        problem, generator, 1, starting_points, sample_pool_size=sample_pool_size, num_batches=num_batches,
        batch_size=batch_size, target_posterior_ess=target_posterior_ess, posterior_fraction=posterior_fraction,
        importance_fraction=importance_fraction, monte_carlo_steps=monte_carlo_steps,
        monte_carlo_method=monte_carlo_method, num_delete=num_delete, max_iterations=max_iterations,
        batch_max_iterations=batch_max_iterations, post_process_sampling_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type, **loop_kwargs)


def _dynamic_runs(
    problem: InferenceProblem,
    generator: Optional[torch.Generator],
    num_runs: int,
    starting_points: Optional[torch.Tensor],
    *,
    groups=None,
    sample_pool_size: int = 100,
    num_batches: int = 4,
    batch_size: Optional[int] = None,
    target_posterior_ess: Optional[float] = None,
    posterior_fraction: float = 1.0,
    importance_fraction: float = 0.8,
    monte_carlo_steps=None,
    monte_carlo_method: str = "auto",
    num_delete: int = 1,
    max_iterations: int = 10000,
    batch_max_iterations: int = 5000,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    **loop_kwargs,
) -> NestedSamplingResult:
    """:func:`dynamic_nested_sampling` with ``num_runs`` (R) runs a stage,
    each stage one :func:`.nested_sampling.run_loop_batched` call: the base
    run is R runs of ``sample_pool_size`` live points (from
    ``starting_points`` [R, pool, d], or prior draws), and each stage adds R
    batches of ``batch_size`` live points at one constraint interval, so
    ``num_batches`` batches take ``ceil(num_batches / R)`` stages.  The
    user's ``min_iterations`` applies to the base run; the batches run from
    ``min_iterations=1`` to their level.  With R = 1 this is the single-run
    engine.  ``groups`` (:func:`..parallel.sharding.device_groups` of the
    R runs; None: one group on the problem's device, the one-batch call)
    splits each stage's runs over devices
    (:func:`.nested_sampling.runs_by_device`), each device keeping one copy
    of the problem for every stage."""
    if not 0.0 <= posterior_fraction <= 1.0:
        raise ValueError("posterior_fraction must be in [0, 1]")
    if not 0.0 < importance_fraction < 1.0:
        raise ValueError("importance_fraction must be in (0, 1)")
    if num_runs < 1:
        raise ValueError("num_runs must be >= 1")
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    batch_size = batch_size or sample_pool_size
    pool = sample_pool_size if starting_points is None else int(starting_points.shape[1])
    if num_delete < 1 or num_delete >= min(int(pool), int(batch_size)):
        raise ValueError(
            "need 1 <= num_delete < min(sample_pool_size, batch_size) "
            f"(got num_delete={num_delete}, sample_pool_size={sample_pool_size}, batch_size={batch_size})")
    method = resolve_monte_carlo_method(monte_carlo_method, problem.dim, gradient_check=problem.gradient_sanity)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(method, problem.dim)
    loop_kwargs = dict(loop_kwargs)
    base_min = loop_kwargs.pop("min_iterations", None)
    chains = dict(monte_carlo_steps=monte_carlo_steps, monte_carlo_method=method, num_delete=num_delete,
                  **loop_kwargs)
    base_cfg = make_loop_config(problem.dim, max_iterations=max_iterations,
                                **({} if base_min is None else {"min_iterations": base_min}), **chains)
    cfg = make_loop_config(problem.dim, max_iterations=batch_max_iterations, min_iterations=1, **chains)

    if starting_points is None:
        starting_points = torch.stack([generate_starting_points(problem, generator, sample_pool_size)
                                       for _ in range(num_runs)])
    if groups is None:
        groups = [(torch.arange(num_runs, device=problem.device), problem.device)]
    run_batch = functools.partial(runs_by_device, problem, groups=groups, copies={})
    base = run_batch(starting_points, generator, base_cfg, n_live=pool)
    segments = _segments_from_batch(base, pool, num_delete, -math.inf)
    extra_evals = 0
    for _ in range(-(-int(num_batches) // num_runs)):
        stage = _stage_interval(segments, posterior_fraction=posterior_fraction,
                                importance_fraction=importance_fraction,
                                target_posterior_ess=target_posterior_ess, device=problem.device)
        if stage is None:
            break
        log_l_lo, log_l_hi, pts, logl = stage
        seeds, evals = _stage_seeds(problem, generator, pts, logl, log_l_lo, num_runs * batch_size,
                                    num_delete=num_delete, monte_carlo_steps=monte_carlo_steps, method=method)
        extra_evals += evals
        runs = run_batch(seeds.reshape(num_runs, batch_size, problem.dim), generator, cfg, n_live=batch_size,
                         stop_at_log_likelihood=log_l_hi)
        segments.extend(_segments_from_batch(runs, batch_size, num_delete, log_l_lo))

    pts, logl, logp, m = merge_segments(segments)
    as_t = lambda a: torch.as_tensor(a, dtype=problem.dtype, device=problem.device)  # noqa: E731
    result = merged_evidence_sampling(
        points=as_t(pts), log_likelihoods=as_t(logl), log_priors=as_t(logp), schedule=as_t(m),
        generator=generator, num_runs=post_process_sampling_runs, sample_pool_size=sample_pool_size,
        param_names=problem.param_names, empirical_posterior_type=empirical_posterior_type,
    )
    return dataclasses.replace(
        result,
        num_likelihood_evals=sum(s.num_likelihood_evals for s in segments) + extra_evals,
        iterations=sum(s.n_dead // s.num_delete for s in segments),
    )
