"""Nested sampling (port of the adaptive-Metropolis path of
``bayesianinference_tpu.engines.nested_sampling``).

Each iteration deletes the ``num_delete`` worst live points and replaces
them by that many adaptive-Metropolis chains run as one batch: every chain
step evaluates the batch's likelihoods in one call (for a GP likelihood,
one batched covariance assembly and one batched Cholesky on the card).

The JAX package's on-device ``while_loop`` is a Python loop here.  The
per-iteration work stays batched tensor ops with no host synchronization,
except the termination test: it reads logZ and the missing-evidence
estimate back to the host once per iteration after ``min_iterations``.
Dead-point buffers are capacity-padded (``max_iterations * num_delete``)
and written in place; ``n_dead`` and the iteration count are Python ints.
The likelihood-evaluation counter is one int64 tensor on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..core.numerics import log_zero, logaddexp, logsubexp, logsumexp
from ..models.problem import InferenceProblem, random_domain_points
from ..ops.metropolis import am_init, proposal_chol, run_chain, run_chain_adaptive
from ..ops.ns_math import crude_log_x_deleted, entropy_from_weights, log_x_live_tail, pool_schedule
from .evidence import NestedSamplingResult, evidence_sampling, evidence_sampling_padded

__all__ = [
    "NSState",
    "NSRunData",
    "crude_log_z_masked",
    "default_monte_carlo_steps",
    "resolve_monte_carlo_method",
    "nested_sampling_loop",
    "generate_starting_points",
    "nested_sampling",
]

# the d <= 16 crossover of the JAX package's "auto" policy
_AUTO_SLICE_DIM = 16
_AUTO_CHMC_DIM = 64
_LOG2 = math.log(2.0)
_LOG_HALF = math.log(0.5)


@dataclasses.dataclass
class NSState:
    """State of the nested-sampling loop.  The buffers are updated in
    place from one iteration to the next."""

    live_points: torch.Tensor  # [n, d], sorted ascending by logL
    live_logl: torch.Tensor  # [n]
    live_logp: torch.Tensor  # [n]
    dead_points: torch.Tensor  # [cap, d]
    dead_logl: torch.Tensor  # [cap]
    dead_logp: torch.Tensor  # [cap]
    dead_acc: torch.Tensor  # [cap] acceptance rate of the chain that replaced it
    n_dead: int
    iteration: int  # 1-based
    mean_est: torch.Tensor  # [d]
    cov_est: torch.Tensor  # [d, d]
    log_z: torch.Tensor  # crude log evidence
    entropy: torch.Tensor
    log_missing: torch.Tensor  # log of the estimated missing evidence
    num_likelihood_evals: torch.Tensor  # int64
    interrupted: bool = False


def default_monte_carlo_steps(method: str, dim: int) -> int:
    """Dimension-scaled default chain length per replacement (the JAX
    package's laws: slice 3d, chmc 6d above d = 64, adaptive-Metropolis 200)."""
    if method == "slice":
        return max(200, 3 * dim)
    if method == "chmc":
        return max(200, 6 * dim) if dim > _AUTO_CHMC_DIM else 200
    return 200


def resolve_monte_carlo_method(method: str, dim: int) -> str:
    """Resolve ``"auto"`` as the JAX package does: adaptive-Metropolis up to
    d = 16, slice sampling above, constrained HMC above d = 64.  Only the
    adaptive-Metropolis kernel is ported so far: a method that resolves to
    slice or chmc raises ``NotImplementedError``."""
    if method == "auto":
        method = "adaptive_metropolis" if dim <= _AUTO_SLICE_DIM else "slice"
    if method not in ("adaptive_metropolis", "slice", "chmc"):
        raise ValueError(
            f"unknown monte_carlo_method {method!r}; expected 'auto', "
            "'adaptive_metropolis', 'slice' or 'chmc'"
        )
    if method != "adaptive_metropolis":
        raise NotImplementedError(
            f"monte_carlo_method={method!r} (d={dim}) is not ported yet: slice and "
            "constrained-HMC nested sampling (ops/slice.py, ops/chmc.py) are the "
            "ROADMAP.md (queue 1, 'Still to port'); use "
            "monte_carlo_method='adaptive_metropolis'"
        )
    return method


def crude_log_z_masked(
    log_xd: torch.Tensor,  # [cap] analytic deleted logX
    n_dead: int,
    dead_logl: torch.Tensor,  # [cap]
    live_logl_sorted: torch.Tensor,  # [n] ascending
):
    """Crude logZ and the trapezoid log-weights (without the logL term) of
    the dead prefix and the live tail.  Returns
    (log_z, dead_w [cap], live_w [n], live_log_x [n])."""
    dtype, dev = log_xd.dtype, log_xd.device
    cap = log_xd.shape[0]
    n = live_logl_sorted.shape[0]
    lz = log_zero(dtype)
    active = torch.arange(cap, device=dev) < n_dead
    log_x_last = log_xd[n_dead - 1] if n_dead > 0 else torch.zeros((), dtype=dtype, device=dev)
    live_log_x = log_x_live_tail(n, log_x_last, dtype=dtype, device=dev)  # descending

    prev = torch.cat([logsubexp(_LOG2, log_xd[:1]), log_xd[:-1]])
    nxt = torch.cat([log_xd[1:], torch.full((1,), lz, dtype=dtype, device=dev)])
    if n_dead > 0:
        nxt = nxt.clone()
        nxt[n_dead - 1] = live_log_x[0]
    dead_w = torch.where(active, _LOG_HALF + logsubexp(prev, nxt), torch.full_like(nxt, lz))

    first_prev = log_x_last if n_dead > 0 else logsubexp(_LOG2, live_log_x[0])
    live_prev = torch.cat([first_prev.reshape(1), live_log_x[:-1]])
    live_nxt = torch.cat([live_log_x[1:], torch.full((1,), lz, dtype=dtype, device=dev)])
    live_w = _LOG_HALF + logsubexp(live_prev, live_nxt)
    live_w = torch.cat([live_w[:-1], _LOG_HALF + logaddexp(live_log_x[-2:-1], live_log_x[-1:])])

    log_z = logaddexp(
        logsumexp(torch.where(active, dead_w + dead_logl, torch.full_like(dead_w, lz))),
        logsumexp(live_w + live_logl_sorted),
    )
    return log_z, dead_w, live_w, live_log_x


@dataclasses.dataclass(frozen=True)
class NSRunData:
    """Raw output of the loop, consumed by evidence resampling."""

    state: NSState
    n_live: int
    num_delete: int
    capacity: int

    def finalize(self):
        """(points, logl, logp, acc, n_deleted): the dead prefix followed by
        the live points sorted ascending by logL."""
        s = self.state
        nd = s.n_dead
        order = torch.argsort(s.live_logl, stable=True)
        points = torch.cat([s.dead_points[:nd], s.live_points[order]])
        logl = torch.cat([s.dead_logl[:nd], s.live_logl[order]])
        logp = torch.cat([s.dead_logp[:nd], s.live_logp[order]])
        acc = torch.cat([s.dead_acc[:nd], torch.full((self.n_live,), math.nan, dtype=s.dead_acc.dtype,
                                                      device=s.dead_acc.device)])
        return points, logl, logp, acc, nd


def _init_state(problem: InferenceProblem, starting_points: torch.Tensor, capacity: int) -> NSState:
    n_live, dim = starting_points.shape
    dtype, dev = starting_points.dtype, starting_points.device
    lz = log_zero(dtype)
    logl = problem.guarded_log_likelihood(starting_points)
    logp = problem.guarded_log_prior(starting_points)
    order = torch.argsort(logl, stable=True)
    return NSState(
        live_points=starting_points[order],
        live_logl=logl[order],
        live_logp=logp[order],
        dead_points=torch.zeros((capacity, dim), dtype=dtype, device=dev),
        dead_logl=torch.full((capacity,), lz, dtype=dtype, device=dev),
        dead_logp=torch.full((capacity,), lz, dtype=dtype, device=dev),
        dead_acc=torch.zeros((capacity,), dtype=dtype, device=dev),
        n_dead=0,
        iteration=1,
        mean_est=starting_points.mean(dim=0),
        cov_est=torch.cov(starting_points.T, correction=1).reshape(dim, dim),
        log_z=torch.tensor(lz, dtype=dtype, device=dev),
        entropy=torch.zeros((), dtype=dtype, device=dev),
        log_missing=torch.zeros((), dtype=dtype, device=dev),
        num_likelihood_evals=torch.zeros((), dtype=torch.int64, device=dev),
    )


def nested_sampling_loop(
    problem: InferenceProblem,
    starting_points,
    generator: torch.Generator,
    *,
    max_iterations: int = 10000,
    min_iterations: int = 100,
    monte_carlo_steps=None,
    termination_fraction: float = 0.01,
    num_delete: int = 1,
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0),
    covariance_learn_delay: int = 10,
    log_likelihood_maximum: Optional[float] = None,
    progress_callback: Optional[Callable] = None,
    progress_interval: int = 0,
    interrupt_check: Optional[Callable] = None,
    monte_carlo_method: str = "auto",
) -> NSRunData:
    """Run the nested-sampling loop on the device of ``starting_points``
    [n_live, d] with randomness from ``generator``; returns the raw buffers
    (use :func:`nested_sampling` for the whole pipeline).

    ``monte_carlo_steps`` is an int ``s`` (first chain ``s`` steps, retry
    blocks of ``s`` up to ``5 s``) or a triple.  ``progress_callback(
    iteration, n_samples, log_z, entropy)`` is called every
    ``progress_interval`` iterations and ``interrupt_check()`` once per
    iteration; both are plain host calls."""
    starting_points = torch.as_tensor(starting_points, dtype=problem.dtype, device=problem.device)
    n_live, dim = starting_points.shape
    if num_delete < 1 or num_delete >= n_live:
        raise ValueError("need 1 <= num_delete < n_live")
    resolve_monte_carlo_method(monte_carlo_method, dim)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps("adaptive_metropolis", dim)
    if isinstance(monte_carlo_steps, int):
        num_steps, extra_steps, max_steps = monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps
    else:
        num_steps, extra_steps, max_steps = monte_carlo_steps
    max_iterations = max(max_iterations, min_iterations)
    k = num_delete
    capacity = max_iterations * k
    dtype, dev = starting_points.dtype, starting_points.device
    lz = log_zero(dtype)
    log_xd = crude_log_x_deleted(pool_schedule(n_live, k, capacity, dtype=dtype, device=dev))
    log_term = math.log(termination_fraction)
    min_acc, max_acc = min_max_acceptance_rate

    s = _init_state(problem, starting_points, capacity)

    def keep_going() -> bool:
        if s.interrupted or s.iteration > max_iterations:
            return False
        if s.iteration == 1 or s.iteration <= min_iterations:
            return True
        return bool(s.log_missing > s.log_z + log_term)  # one host read

    while keep_going():
        threshold = s.live_logl[k - 1]
        live_cov = torch.cov(s.live_points.T, correction=1).reshape(dim, dim)
        cov_est = 0.5 * (s.cov_est + live_cov)

        def density(x):
            ok = problem.in_support(x) & (problem.guarded_log_likelihood(x) > threshold)
            return torch.where(ok, problem.guarded_log_prior(x), torch.full((x.shape[0],), lz, dtype=dtype, device=dev))

        # chains start at random survivors (ranks >= k)
        start_idx = torch.randint(k, n_live, (k,), generator=generator, device=dev)
        st = am_init(s.live_points[start_idx], density, mean0=s.mean_est, t0=10,
                     chol0=proposal_chol(cov_est))
        st, accs = run_chain_adaptive(
            generator, st, density, num_steps, extra_steps, max_steps,
            min_acceptance=min_acc, max_acceptance=max_acc,
            learn_delay=covariance_learn_delay,
        )
        xs = st.x
        new_logl = problem.guarded_log_likelihood(xs)
        new_logp = problem.guarded_log_prior(xs)

        slots = slice(s.n_dead, s.n_dead + k)
        s.dead_points[slots] = s.live_points[:k]
        s.dead_logl[slots] = s.live_logl[:k]
        s.dead_logp[slots] = s.live_logp[:k]
        s.dead_acc[slots] = accs
        live_points = torch.cat([xs, s.live_points[k:]])
        live_logl = torch.cat([new_logl, s.live_logl[k:]])
        live_logp = torch.cat([new_logp, s.live_logp[k:]])
        order = torch.argsort(live_logl, stable=True)
        s.live_points, s.live_logl, s.live_logp = live_points[order], live_logl[order], live_logp[order]
        s.n_dead += k

        log_z, dead_w, live_w, live_log_x = crude_log_z_masked(log_xd, s.n_dead, s.dead_logl, s.live_logl)
        lmax = s.live_logl[-1] if log_likelihood_maximum is None else log_likelihood_maximum
        s.log_missing = live_log_x[-1] + lmax
        active = torch.arange(capacity, device=dev) < s.n_dead
        lz_cap = torch.full((capacity,), lz, dtype=dtype, device=dev)
        s.entropy = entropy_from_weights(
            torch.cat([torch.where(active, dead_w + s.dead_logl, lz_cap), live_w + s.live_logl]),
            torch.cat([torch.where(active, s.dead_logl, lz_cap), s.live_logl]),
            log_z,
        )
        s.log_z = log_z
        if progress_callback is not None and progress_interval > 0 and s.iteration % progress_interval == 0:
            progress_callback(s.iteration, s.n_dead + n_live, float(log_z), float(s.entropy))
        if interrupt_check is not None:
            s.interrupted = bool(interrupt_check())
        covs = st.cov.mean(dim=0)
        s.mean_est = st.mean.mean(dim=0)
        s.cov_est = 0.5 * (covs + covs.T)
        s.num_likelihood_evals = s.num_likelihood_evals + st.proposed.sum() + k
        s.iteration += 1
    return NSRunData(state=s, n_live=n_live, num_delete=k, capacity=capacity)


def generate_starting_points(
    problem: InferenceProblem,
    generator: torch.Generator,
    n: int,
    burn_in: int = 1000,
    thinning: int = 1000,
) -> torch.Tensor:
    """n prior samples [n, d]: drawn directly when the prior can be sampled,
    otherwise by an adaptive-Metropolis chain on the prior density seeded
    from truncated-Cauchy domain points."""
    if problem.prior_distribution is not None:
        try:
            pts = problem.prior_distribution.sample(generator, (n,))
            pts = pts.to(dtype=problem.dtype, device=problem.device)
            return pts[:, None] if pts.dim() == 1 else pts
        except NotImplementedError:
            pass
    crude = random_domain_points(generator, problem.lower, problem.upper, 100)
    density = problem.guarded_log_prior
    st = am_init(crude[:1], density, cov0=torch.diag(crude.var(dim=0, correction=0)), t0=0)
    st = run_chain(generator, st, density, burn_in, learn_delay=20)
    pts = []
    for _ in range(n):
        st = run_chain(generator, st, density, thinning, learn_delay=20)
        pts.append(st.x[0])
    return torch.stack(pts)


def nested_sampling(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    sample_pool_size: int = 100,
    starting_points=None,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    checkpoint_path=None,
    checkpoint_every: Optional[int] = None,
    **loop_kwargs,
) -> NestedSamplingResult:
    """Starting points, the loop, then evidence resampling.  Runs on the
    problem's device; ``generator`` (on that device) defaults to one seeded
    with 0."""
    if checkpoint_path is not None or checkpoint_every is not None:
        raise NotImplementedError(
            "checkpointing waits for the port of engines/checkpoint.py (ROADMAP port queue)"
        )
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    if starting_points is None:
        starting_points = generate_starting_points(problem, generator, sample_pool_size)
    run = nested_sampling_loop(problem, starting_points, generator, **loop_kwargs)
    s = run.state
    if post_process_sampling_runs and post_process_sampling_runs > 0:
        order = torch.argsort(s.live_logl, stable=True)
        result = evidence_sampling_padded(
            dead_points=s.dead_points,
            dead_logl=s.dead_logl,
            dead_logp=s.dead_logp,
            live_points=s.live_points[order],
            live_logl=s.live_logl[order],
            live_logp=s.live_logp[order],
            n_dead=s.n_dead,
            schedule=pool_schedule(run.n_live, run.num_delete, run.capacity,
                                   dtype=s.live_logl.dtype, device=s.live_logl.device),
            generator=generator,
            num_runs=int(post_process_sampling_runs),
            empirical_posterior_type=empirical_posterior_type,
            param_names=problem.param_names,
        )
        acc = torch.cat([s.dead_acc[: s.n_dead], torch.full((run.n_live,), math.nan, dtype=s.dead_acc.dtype,
                                                              device=s.dead_acc.device)])
    else:
        points, logl, logp, acc, n_deleted = run.finalize()
        result = evidence_sampling(
            points=points,
            log_likelihoods=logl,
            log_priors=logp,
            sample_pool_size=run.n_live,
            schedule=pool_schedule(run.n_live, run.num_delete, n_deleted, dtype=logl.dtype, device=logl.device),
            generator=generator,
            num_runs=post_process_sampling_runs,
            empirical_posterior_type=empirical_posterior_type,
            param_names=problem.param_names,
        )
    return dataclasses.replace(
        result,
        acceptance_rates=acc,
        num_likelihood_evals=int(s.num_likelihood_evals),
        iterations=s.iteration - 1,
    )
