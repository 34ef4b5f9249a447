"""Evidence resampling (port of ``bayesianinference_tpu.engines.evidence``):
Monte-Carlo error bars on logZ, posterior weights, parameter expectations
and exact multi-run combination.

The X-shrinkage trajectory is re-simulated ``num_runs`` times: the i-th
deleted point's shrinkage is ``-log t_i ~ Exponential(m_i)``, and the final
live tail is a sorted Exponential(1) tail beyond the last deleted logX.
The exponential draws are inputs of the inner functions
(:func:`simulate_log_x`, :func:`padded_evidence_program`), so tests can
feed them the JAX package's draws; the public functions draw them from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import log_zero, logaddexp, logsubexp, logsumexp
from ..dists.empirical import Empirical
from ..ops.ns_math import (
    crude_log_x_deleted,
    entropy_from_weights,
    log_trapezoid_weights,
    log_x_live_tail,
)

__all__ = [
    "MeanAndError",
    "NestedSamplingResult",
    "simulate_log_x",
    "padded_evidence_program",
    "evidence_sampling",
    "evidence_sampling_padded",
    "combine_runs",
    "dedup_by_point",
    "log_bayes_factor",
]

_LOG2 = math.log(2.0)
_LOG_HALF = math.log(0.5)


@dataclasses.dataclass(frozen=True)
class MeanAndError:
    """Mean and standard error across simulated runs."""

    mean: torch.Tensor
    standard_error: torch.Tensor

    def __repr__(self):
        if torch.as_tensor(self.mean).numel() == 1:
            return f"{float(self.mean):.6g} ± {float(self.standard_error):.3g}"
        return f"MeanAndError(mean={self.mean}, standard_error={self.standard_error})"


def _mean_and_error(x: torch.Tensor, dim: int = 0) -> MeanAndError:
    return MeanAndError(mean=x.mean(dim=dim), standard_error=x.std(dim=dim, correction=1))


@dataclasses.dataclass(frozen=True)
class NestedSamplingResult:
    """The posterior object of a nested-sampling run.  Samples are sorted
    descending by crude posterior weight."""

    points: torch.Tensor  # [N, d]
    log_likelihoods: torch.Tensor  # [N]
    log_priors: torch.Tensor  # [N]
    crude_log_posterior_weights: torch.Tensor  # [N], normalized
    log_x: torch.Tensor  # [N] crude logX
    sampled_log_x: MeanAndError  # [N]
    log_posterior_weights: MeanAndError  # [N]
    log_evidence: MeanAndError
    crude_log_evidence: torch.Tensor
    log_likelihood_maximum: torch.Tensor
    log_estimated_missing_evidence: torch.Tensor
    crude_relative_entropy: torch.Tensor
    relative_entropy: MeanAndError
    parameter_expected_values: MeanAndError  # [d]
    sample_pool_size: int = 0
    generated_nested_samples: int = 0
    total_samples: int = 0
    param_names: Tuple[str, ...] = ()
    empirical_posterior_type: str = "Simple"
    acceptance_rates: Optional[torch.Tensor] = None  # [N] (NaN for live points)
    posterior_weight_runs: Optional[torch.Tensor] = None  # [R, N] (non-Simple)
    num_likelihood_evals: int = 0
    iterations: int = 0

    @property
    def parameter_ranges(self) -> torch.Tensor:
        return torch.stack([self.points.amin(dim=0), self.points.amax(dim=0)], dim=-1)

    def posterior_samples(self) -> WeightedSamples:
        return WeightedSamples(
            points=self.points,
            log_weights=self.crude_log_posterior_weights,
            log_likelihoods=self.log_likelihoods,
        )

    def empirical_posterior(self) -> Empirical:
        """"Simple": the crude weights; otherwise a uniform mixture over the
        per-run weight vectors."""
        if self.empirical_posterior_type == "Simple" or self.posterior_weight_runs is None:
            return Empirical(points=self.points, log_weights=self.crude_log_posterior_weights)
        w = self.posterior_weight_runs
        safe = torch.where(w > 0, w, torch.ones_like(w))
        log_w = torch.where(w > 0, torch.log(safe), torch.full_like(w, log_zero(w.dtype)))
        lw = logsumexp(log_w, dim=0) - math.log(w.shape[0])
        return Empirical(points=self.points, log_weights=lw)


def dedup_by_point(points: torch.Tensor, *aligned):
    """Drop samples whose point duplicates an earlier one, keeping first
    occurrences in the given order."""
    _, inverse = torch.unique(points, dim=0, return_inverse=True)
    n = points.shape[0]
    pos = torch.arange(n, device=points.device)
    first = torch.full((int(inverse.max()) + 1,), n, device=points.device)
    first = first.scatter_reduce(0, inverse, pos, reduce="amin")
    keep = torch.sort(first).values
    return (points[keep],) + tuple(a[keep] for a in aligned)


def simulate_log_x(e_deleted: torch.Tensor, e_live: torch.Tensor, schedule: torch.Tensor) -> torch.Tensor:
    """[R, n_del + n] simulated logX trajectories from Exponential(1) draws
    ``e_deleted`` [R, n_del] and ``e_live`` [R, n]."""
    log_x_del = -torch.cumsum(e_deleted / schedule, dim=-1)
    if schedule.shape[0] > 0:
        last = -log_x_del[:, -1:]
    else:
        last = torch.zeros_like(e_live[:, :1])
    log_x_live = -torch.sort(last + e_live, dim=-1).values
    return torch.cat([log_x_del, log_x_live], dim=-1)


def _exponential(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=generator.device).exponential_(generator=generator)


def _crude_arrays(schedule, log_likelihoods, sample_pool_size: int):
    log_x_del = crude_log_x_deleted(schedule)
    log_x_live = log_x_live_tail(
        sample_pool_size, log_x_del[-1], dtype=log_likelihoods.dtype, device=log_likelihoods.device
    )
    log_x = torch.cat([log_x_del, log_x_live])
    crude_lw = log_trapezoid_weights(log_x) + log_likelihoods
    crude_log_z = logsumexp(crude_lw)
    crude_entropy = entropy_from_weights(crude_lw, log_likelihoods, crude_log_z)
    ll_max = log_likelihoods.max()
    log_missing = log_x.min() + ll_max
    order = torch.argsort(-crude_lw, stable=True)
    return log_x, crude_lw, crude_log_z, crude_entropy, ll_max, log_missing, order


def simulated_arrays(sampled_log_x: torch.Tensor, log_likelihoods: torch.Tensor, points: torch.Tensor):
    """Per-run evidence, posterior weights, parameter means and relative
    entropies from simulated logX trajectories [R, N]."""
    lz = log_zero(log_likelihoods.dtype)
    log_ev_w = log_trapezoid_weights(sampled_log_x) + log_likelihoods[None, :]
    z_samples = logsumexp(log_ev_w, dim=-1)  # [R]
    log_post_w = log_ev_w - z_samples[:, None]
    post_w = torch.exp(log_post_w)
    param_means = post_w @ points  # [R, d]
    safe_ll = torch.where(log_likelihoods > 0.5 * lz, log_likelihoods, torch.zeros_like(log_likelihoods))
    rel_entropy = post_w @ safe_ll - z_samples
    return z_samples, log_post_w, post_w, param_means, rel_entropy


def padded_evidence_program(
    e_dead: torch.Tensor,  # [R, cap] Exponential(1) draws
    e_live: torch.Tensor,  # [R, n_live] Exponential(1) draws
    schedule: torch.Tensor,  # [cap] pool sizes (values beyond n_dead ignored)
    dead_logl: torch.Tensor,  # [cap]
    live_logl: torch.Tensor,  # [n_live] sorted ascending
    dead_points: torch.Tensor,  # [cap, d]
    live_points: torch.Tensor,  # [n_live, d]
    n_dead: int,
):
    """All evidence post-processing on capacity-padded buffers.  Invalid
    dead slots (index >= n_dead) carry weight log-zero and shrink X by a
    factor of exactly 1.  Returns padded arrays."""
    from .nested_sampling import crude_log_z_masked

    dtype = live_logl.dtype
    dev = live_logl.device
    cap = schedule.shape[0]
    lz = log_zero(dtype)
    idx = torch.arange(cap, device=dev)
    active = idx < n_dead
    dead_logl = torch.where(active, dead_logl.to(dtype), torch.full((cap,), lz, dtype=dtype, device=dev))
    sched = torch.where(active, schedule.to(dtype), torch.full((cap,), math.inf, dtype=dtype, device=dev))

    # crude (deterministic X schedule)
    log_xd = -torch.cumsum(1.0 / sched, dim=0)
    crude_log_z, dead_w, live_w, live_log_x = crude_log_z_masked(log_xd, n_dead, dead_logl, live_logl)
    crude_lw = torch.cat([torch.where(active, dead_w + dead_logl, torch.full_like(dead_w, lz)), live_w + live_logl])
    log_x_all = torch.cat([log_xd, live_log_x])
    ll_all = torch.cat([dead_logl, live_logl])
    crude_entropy = entropy_from_weights(crude_lw, ll_all, crude_log_z)
    ll_max = live_logl.max()
    log_missing = live_log_x[-1] + ll_max

    # simulated X trajectories
    s_log_xd = -torch.cumsum(e_dead / sched, dim=-1)  # [R, cap], flat beyond n_dead
    s_log_xl = -torch.sort(-s_log_xd[:, -1:] + e_live, dim=-1).values  # [R, n]
    mirror = logsubexp(_LOG2, s_log_xd[:, :1])
    prev_d = torch.cat([mirror, s_log_xd[:, :-1]], dim=-1)
    nxt_d = torch.cat([s_log_xd[:, 1:], torch.full_like(s_log_xd[:, :1], lz)], dim=-1)
    nxt_d = torch.where(idx == n_dead - 1, s_log_xl[:, :1], nxt_d)
    w_dead = torch.where(active, _LOG_HALF + logsubexp(prev_d, nxt_d), torch.full_like(nxt_d, lz))
    prev_l = torch.cat([s_log_xd[:, -1:], s_log_xl[:, :-1]], dim=-1)
    nxt_l = torch.cat([s_log_xl[:, 1:], torch.full_like(s_log_xl[:, :1], lz)], dim=-1)
    w_live = _LOG_HALF + logsubexp(prev_l, nxt_l)
    w_live = torch.cat(
        [w_live[:, :-1], _LOG_HALF + logaddexp(s_log_xl[:, -2:-1], s_log_xl[:, -1:])], dim=-1
    )
    log_ev_w = torch.cat(
        [torch.where(active, w_dead + dead_logl, torch.full_like(w_dead, lz)), w_live + live_logl], dim=-1
    )  # [R, cap + n]
    z_samples = logsumexp(log_ev_w, dim=-1)
    log_post_w = log_ev_w - z_samples[:, None]
    post_w = torch.exp(log_post_w)
    pts_all = torch.cat([dead_points.to(dtype), live_points.to(dtype)])
    param_means = post_w @ pts_all
    safe_ll = torch.where(ll_all > 0.5 * lz, ll_all, torch.zeros_like(ll_all))
    rel_entropy = post_w @ safe_ll - z_samples
    sampled_log_x = torch.cat([s_log_xd, s_log_xl], dim=-1)
    return (
        crude_lw, crude_log_z, crude_entropy, ll_max, log_missing, log_x_all,
        sampled_log_x, z_samples, log_post_w, post_w, param_means, rel_entropy,
    )


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def evidence_sampling_padded(
    *,
    dead_points,
    dead_logl,
    dead_logp,
    live_points,
    live_logl,
    live_logp,
    n_dead: int,
    schedule,
    generator: Optional[torch.Generator] = None,
    num_runs: int = 100,
    empirical_posterior_type: str = "Simple",
    param_names: Tuple[str, ...] = (),
) -> NestedSamplingResult:
    """Fixed-shape evidence post-processing of capacity-padded dead buffers
    (deletion order) and the live set (sorted ascending by logL)."""
    if not num_runs or num_runs <= 0:
        raise ValueError("evidence_sampling_padded needs num_runs >= 1")
    nd = int(n_dead)
    if nd < 1:
        raise ValueError(
            "evidence_sampling_padded needs n_dead >= 1; use evidence_sampling "
            "for zero-deletion sample sets"
        )
    dtype = live_logl.dtype
    generator = generator or _default_generator(live_logl.device)
    n_live = live_logl.shape[0]
    cap = dead_logl.shape[0]
    e_dead = _exponential(generator, (num_runs, cap), dtype)
    e_live = _exponential(generator, (num_runs, n_live), dtype)
    (
        crude_lw, crude_log_z, crude_entropy, ll_max, log_missing, log_x_all,
        sampled_log_x, z_samples, log_post_w, post_w, param_means, rel_entropy,
    ) = padded_evidence_program(
        e_dead, e_live, schedule, dead_logl, live_logl, dead_points, live_points, nd
    )
    dev = crude_lw.device
    # valid slots in padded order: dead [0, nd) and live [cap, cap + n),
    # ordered by descending crude weight
    keep = torch.cat([torch.arange(nd, device=dev), torch.arange(cap, cap + n_live, device=dev)])
    sel = keep[torch.argsort(-crude_lw[keep], stable=True)]
    pos = torch.full((cap + n_live,), -1, dtype=torch.long, device=dev)
    pos[keep] = torch.arange(nd + n_live, device=dev)
    sel_c = pos[sel]
    pts_all = torch.cat([dead_points[:nd], live_points])
    lp_all = torch.cat([dead_logp[:nd], live_logp])
    ll_all = torch.cat([dead_logl[:nd], live_logl])
    return NestedSamplingResult(
        points=pts_all[sel_c],
        log_likelihoods=ll_all[sel_c],
        log_priors=lp_all[sel_c],
        crude_log_posterior_weights=(crude_lw - crude_log_z)[sel],
        log_x=log_x_all[sel],
        sampled_log_x=_mean_and_error(sampled_log_x[:, sel]),
        log_posterior_weights=_mean_and_error(log_post_w[:, sel]),
        log_evidence=_mean_and_error(z_samples),
        crude_log_evidence=crude_log_z,
        log_likelihood_maximum=ll_max,
        log_estimated_missing_evidence=log_missing,
        crude_relative_entropy=crude_entropy,
        relative_entropy=_mean_and_error(rel_entropy),
        parameter_expected_values=_mean_and_error(param_means),
        sample_pool_size=n_live,
        generated_nested_samples=nd,
        total_samples=nd + n_live,
        param_names=tuple(param_names),
        empirical_posterior_type=empirical_posterior_type,
        posterior_weight_runs=post_w[:, sel] if empirical_posterior_type != "Simple" else None,
    )


def evidence_sampling(
    *,
    points,
    log_likelihoods,
    log_priors=None,
    sample_pool_size: int,
    schedule=None,
    generator: Optional[torch.Generator] = None,
    num_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    param_names: Tuple[str, ...] = (),
) -> NestedSamplingResult:
    """Post-process a sample set sorted ascending by logL (dead points then
    the final live set).  ``schedule`` is the per-deletion pool size m_i
    ([n_deleted]); it defaults to the constant ``sample_pool_size``."""
    points = torch.as_tensor(points)
    log_likelihoods = torch.as_tensor(log_likelihoods, device=points.device)
    if not log_likelihoods.is_floating_point():
        log_likelihoods = log_likelihoods.to(torch.get_default_dtype())
    dtype, dev = log_likelihoods.dtype, log_likelihoods.device
    n_total = points.shape[0]
    n = sample_pool_size
    n_deleted = n_total - n
    if n_deleted < 1:
        raise ValueError("need more samples than the live pool size")
    if log_priors is None:
        log_priors = torch.full((n_total,), math.nan, dtype=dtype, device=dev)
    if schedule is None:
        schedule = torch.full((n_deleted,), float(n), dtype=dtype, device=dev)
    schedule = torch.as_tensor(schedule, dtype=dtype, device=dev)[:n_deleted]

    log_x, crude_lw, crude_log_z, crude_entropy, ll_max, log_missing, order = _crude_arrays(
        schedule, log_likelihoods, n
    )
    common = dict(
        points=points[order],
        log_likelihoods=log_likelihoods[order],
        log_priors=log_priors[order],
        crude_log_posterior_weights=(crude_lw - crude_log_z)[order],
        log_x=log_x[order],
        crude_log_evidence=crude_log_z,
        log_likelihood_maximum=ll_max,
        log_estimated_missing_evidence=log_missing,
        crude_relative_entropy=crude_entropy,
        sample_pool_size=n,
        generated_nested_samples=int(n_deleted),
        total_samples=int(n_total),
        param_names=tuple(param_names),
        empirical_posterior_type=empirical_posterior_type,
    )
    if not num_runs or num_runs <= 0:
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
    generator = generator or _default_generator(dev)
    sampled_log_x = simulate_log_x(
        _exponential(generator, (int(num_runs), n_deleted), dtype),
        _exponential(generator, (int(num_runs), n), dtype),
        schedule,
    )
    z_samples, log_post_w, post_w, param_means, rel_entropy = simulated_arrays(
        sampled_log_x, log_likelihoods, points
    )
    return NestedSamplingResult(
        sampled_log_x=_mean_and_error(sampled_log_x[:, order]),
        log_posterior_weights=_mean_and_error(log_post_w[:, order]),
        log_evidence=_mean_and_error(z_samples),
        relative_entropy=_mean_and_error(rel_entropy),
        parameter_expected_values=_mean_and_error(param_means),
        posterior_weight_runs=post_w[:, order] if empirical_posterior_type != "Simple" else None,
        **common,
    )


def combine_runs(
    *results: NestedSamplingResult,
    generator: Optional[torch.Generator] = None,
    num_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
) -> NestedSamplingResult:
    """Merge independent runs of one problem exactly: union the samples
    (deduplicated by point), sum the pool sizes, and rerun evidence
    sampling with the combined pool."""
    if len(results) < 2:
        raise ValueError("need at least two runs to combine")
    pts = torch.cat([r.points for r in results])
    ll = torch.cat([r.log_likelihoods for r in results])
    lp = torch.cat([r.log_priors for r in results])
    pts, ll, lp = dedup_by_point(pts, ll, lp)
    order = torch.argsort(ll, stable=True)
    return evidence_sampling(
        points=pts[order],
        log_likelihoods=ll[order],
        log_priors=lp[order],
        sample_pool_size=sum(r.sample_pool_size for r in results),
        generator=generator,
        num_runs=num_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=results[0].param_names,
    )


def log_bayes_factor(result_a, result_b) -> MeanAndError:
    """log B_ab = logZ_a - logZ_b with the errors combined in quadrature."""

    def split(r):
        le = getattr(r, "log_evidence", r)
        if isinstance(le, MeanAndError):
            return torch.as_tensor(le.mean), torch.as_tensor(le.standard_error)
        le = torch.as_tensor(le)
        return le, torch.zeros_like(le)

    ma, ea = split(result_a)
    mb, eb = split(result_b)
    return MeanAndError(mean=ma - mb, standard_error=torch.sqrt(ea**2 + eb**2))
