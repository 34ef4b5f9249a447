"""Nested sampling (port of ``bayesianinference_tpu.engines.nested_sampling``).

Each iteration deletes the ``num_delete`` worst live points and replaces
them by that many chains run as one batch, started at random survivors:
adaptive-Metropolis chains up to d = 16, random-direction slice chains
above, constrained-HMC chains above d = 64 where the likelihood has a
usable gradient (the ``"auto"`` policy; each can be asked for by name).
Every chain step evaluates the batch's likelihoods in one call (for a GP
likelihood, one batched covariance assembly and one batched Cholesky on
the card; the constrained-HMC chains also run their reverse rules).

The JAX package's on-device ``while_loop`` is a Python loop here.  The
per-iteration work stays batched tensor ops; the termination test reads
logZ and the missing-evidence estimate (or, for a dynamic-NS batch, the
deletion threshold) back to the host once per iteration after
``min_iterations``, and the slice chains read one flag per pass of their
step-out and shrink loops.  Dead-point buffers are capacity-padded
(``max_iterations * num_delete``) and written in place; ``n_dead`` and the
iteration count are Python ints.  The likelihood-evaluation counter is one
int64 tensor on the device.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple

import torch

from ..core.numerics import log_zero, logaddexp, logsubexp, logsumexp
from ..models.problem import InferenceProblem, random_domain_points
from ..ops.chmc import chmc_draws, run_chmc_chain
from ..ops.metropolis import am_init, proposal_chol, run_chain, run_chain_adaptive, small_cholesky
from ..ops.ns_math import crude_log_x_deleted, entropy_from_weights, log_x_live_tail, pool_schedule
from ..ops.slice import run_slice_chain, slice_draws
from .evidence import NestedSamplingResult, evidence_sampling, evidence_sampling_padded

__all__ = [
    "NSState",
    "NSRunData",
    "crude_log_z_masked",
    "default_monte_carlo_steps",
    "default_chmc_step_size",
    "default_chmc_num_leapfrog",
    "resolve_monte_carlo_method",
    "warn_if_slice_steps_below_dim",
    "shared_factor_chains",
    "run_loop_from_state",
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


def default_chmc_step_size(dim: int) -> float:
    """Dimension-scaled leapfrog step of the constrained-HMC chains.

    In whitened momentum space a step moves the point by ``eps * |u|`` with
    ``|u| ~ sqrt(d)``, so a fixed eps overshoots the O(1)-radius constrained
    region as d grows.  ``eps = 0.8 / sqrt(d)`` holds the per-step
    displacement at about 0.8 of the whitened region's scale; 0.4 caps it,
    so d <= 4 is unchanged.  (The law is the JAX package's, found unbiased
    on its d = 16 to 256 grids.)"""
    return min(0.4, 0.8 / math.sqrt(max(dim, 1)))


def default_chmc_num_leapfrog(dim: int) -> int:
    """Leapfrog steps per trajectory: 16 up to the ``auto`` crossover, 4
    above it.  Under a flat prior a trajectory is a straight line (plus
    reflections) along one whitened direction, so at high d the number of
    trajectories, not their length, decorrelates a replacement from its
    seed."""
    return 16 if dim <= _AUTO_CHMC_DIM else 4


def default_monte_carlo_steps(method: str, dim: int) -> int:
    """Dimension-scaled default chain length per replacement (the JAX
    package's laws: slice 3d, chmc 6d above d = 64, adaptive-Metropolis 200)."""
    if method == "slice":
        return max(200, 3 * dim)
    if method == "chmc":
        return max(200, 6 * dim) if dim > _AUTO_CHMC_DIM else 200
    return 200


def resolve_monte_carlo_method(
    method: str, dim: int, gradient_check: Optional[Callable[[], bool]] = None
) -> str:
    """Resolve ``"auto"`` as the JAX package does: adaptive-Metropolis up to
    d = 16, slice sampling above, and constrained HMC above d = 64 when a
    ``gradient_check`` thunk is given and passes (it is only called there).
    Without a thunk ``auto`` stays on the gradient-free slice chains; a
    failing probe falls back to slice with a warning.  Explicit names pass
    through unchanged."""
    if method == "auto":
        if dim <= _AUTO_SLICE_DIM:
            return "adaptive_metropolis"
        if dim <= _AUTO_CHMC_DIM or gradient_check is None:
            return "slice"
        if gradient_check():
            return "chmc"
        warnings.warn(
            f"auto would pick the constrained-HMC kernel at d={dim} "
            "(the policy above d=64), but the likelihood gradient "
            "probe failed (non-finite or identically zero at the probe "
            "points); falling back to slice sampling. Pass "
            "monte_carlo_method='chmc' explicitly if the gradient is "
            "valid elsewhere in the domain.",
            stacklevel=3,
        )
        return "slice"
    if method not in ("adaptive_metropolis", "slice", "chmc"):
        raise ValueError(
            f"unknown monte_carlo_method {method!r}; expected 'auto', "
            "'adaptive_metropolis', 'slice' or 'chmc'"
        )
    return method


def warn_if_slice_steps_below_dim(method: str, monte_carlo_steps, dim: int, chmc_num_leapfrog=None):
    """Warn when a replacement gets fewer decorrelation units than there are
    dimensions, which biases logZ high.  The unit is the slice update or the
    chmc trajectory: each explores one random direction."""
    steps0 = monte_carlo_steps if isinstance(monte_carlo_steps, int) else monte_carlo_steps[0]
    if method == "slice" and steps0 < dim:
        warnings.warn(
            f"{steps0} slice updates per replacement at d={dim}: "
            "fewer updates than dimensions leaves seed-replacement "
            "correlation that biases logZ high by several nats; use "
            "roughly 2-5x the dimension",
            stacklevel=3,
        )
    if method == "chmc":
        n_leap = chmc_num_leapfrog if chmc_num_leapfrog is not None else default_chmc_num_leapfrog(dim)
        n_traj = steps0 // max(n_leap, 1)
        if dim > _AUTO_CHMC_DIM and n_traj < dim:
            warnings.warn(
                f"{n_traj} chmc trajectories per replacement at d={dim}: "
                "fewer trajectories than dimensions leaves seed-replacement "
                "correlation that biases logZ high; use ~1.5x the dimension "
                "(the default monte_carlo_steps=None resolves to 6d steps at "
                "4 leapfrog steps each)",
                stacklevel=3,
            )


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


def _mc_steps_triple(monte_carlo_steps) -> Tuple[int, int, int]:
    if isinstance(monte_carlo_steps, int):
        return monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps
    return tuple(monte_carlo_steps)


def shared_factor(cov_est: torch.Tensor) -> torch.Tensor:
    """The factor of ``cov_est + 1e-10 I`` that the slice and chmc chains
    share; the identity where that factor is not finite."""
    eye = torch.eye(cov_est.shape[-1], dtype=cov_est.dtype, device=cov_est.device)
    factor = small_cholesky(cov_est + 1e-10 * eye)
    return torch.where(torch.isfinite(factor).all(), factor, eye)


def shared_factor_chains(
    problem: InferenceProblem,
    generator: torch.Generator,
    x0: torch.Tensor,  # [chains, d]
    threshold,
    cov: torch.Tensor,
    method: str,  # "slice" or "chmc"
    num_steps: int,
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
):
    """The slice or constrained-HMC chains from ``x0`` on the prior where
    the likelihood exceeds ``threshold``, shaped by the factor of ``cov``:
    ``num_steps`` slice updates, or ``num_steps // chmc_num_leapfrog``
    trajectories.  Returns (points [chains, d], the share of updates that
    moved or of trajectories accepted [chains], likelihood evaluations)."""
    chains, dim = x0.shape
    dtype = x0.dtype
    if method == "slice":
        draws = slice_draws(generator, chains, dim, num_updates=num_steps, dtype=dtype)
        st = run_slice_chain(draws, x0, lambda x: problem.constrained_log_prior(x, threshold), shared_factor(cov))
        return st.x, st.moved.to(dtype) / num_steps, st.evals.sum()
    n_leap = chmc_num_leapfrog if chmc_num_leapfrog is not None else default_chmc_num_leapfrog(dim)
    n_traj = max(1, num_steps // n_leap)
    st = run_chmc_chain(
        chmc_draws(generator, n_traj, chains, dim, dtype=dtype), x0,
        problem.guarded_log_likelihood, problem.guarded_log_prior, threshold,
        shared_factor(cov), problem.lower, problem.upper, n_leap,
        chmc_step_size if chmc_step_size is not None else default_chmc_step_size(dim),
        in_support=problem.in_support,
    )
    return st.x, st.accepted.to(dtype) / n_traj, st.evals.sum()


def run_loop_from_state(
    problem: InferenceProblem,
    s: NSState,
    generator: torch.Generator,
    *,
    n_live: int,
    num_delete: int,
    max_iterations: int,
    min_iterations: int,
    monte_carlo_steps,
    monte_carlo_method: str,
    termination_fraction: float = 0.01,
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0),
    covariance_learn_delay: int = 10,
    log_likelihood_maximum: Optional[float] = None,
    progress_callback: Optional[Callable] = None,
    progress_interval: int = 0,
    interrupt_check: Optional[Callable] = None,
    stop_at_log_likelihood: Optional[float] = None,
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
) -> NSState:
    """Iterate the loop from ``s`` (a fresh state or a resumed one) until it
    terminates.  ``s`` is updated in place and returned; its dead buffers
    must hold ``max_iterations * num_delete`` slots.  ``monte_carlo_method``
    is a resolved name, not ``"auto"``, and ``monte_carlo_steps`` an int or
    a triple."""
    k = num_delete
    dim = s.live_points.shape[1]
    capacity = s.dead_logl.shape[0]
    if capacity != max_iterations * k:
        raise ValueError(f"dead buffers hold {capacity} slots, the loop needs {max_iterations * k}")
    num_steps, extra_steps, max_steps = _mc_steps_triple(monte_carlo_steps)
    dtype, dev = s.live_points.dtype, s.live_points.device
    lz = log_zero(dtype)
    log_xd = crude_log_x_deleted(pool_schedule(n_live, k, capacity, dtype=dtype, device=dev))
    log_term = math.log(termination_fraction)
    min_acc, max_acc = min_max_acceptance_rate

    def keep_going() -> bool:
        if s.interrupted or s.iteration > max_iterations:
            return False
        if s.iteration == 1 or s.iteration <= min_iterations:
            return True
        # one host read
        if stop_at_log_likelihood is not None:
            # a dynamic-NS batch: march the threshold up to the level and
            # ignore the evidence criterion
            return bool(s.live_logl[k - 1] <= stop_at_log_likelihood)
        return bool(s.log_missing > s.log_z + log_term)

    while keep_going():
        threshold = s.live_logl[k - 1]
        live_cov = torch.cov(s.live_points.T, correction=1).reshape(dim, dim)
        cov_est = 0.5 * (s.cov_est + live_cov)

        # chains start at random survivors (ranks >= k)
        start_idx = torch.randint(k, n_live, (k,), generator=generator, device=dev)
        x0 = s.live_points[start_idx]
        if monte_carlo_method in ("slice", "chmc"):
            xs, accs, evals = shared_factor_chains(problem, generator, x0, threshold, cov_est, monte_carlo_method,
                                                   num_steps, chmc_step_size, chmc_num_leapfrog)
            mean_est, covs = s.mean_est, cov_est
        else:
            def density(x):
                return problem.constrained_log_prior(x, threshold)

            st = am_init(x0, density, mean0=s.mean_est, t0=10, chol0=proposal_chol(cov_est))
            st, accs = run_chain_adaptive(
                generator, st, density, num_steps, extra_steps, max_steps,
                min_acceptance=min_acc, max_acceptance=max_acc,
                learn_delay=covariance_learn_delay,
            )
            xs, evals = st.x, st.proposed.sum()
            mean_est, covs = st.mean.mean(dim=0), st.cov.mean(dim=0)
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
        s.mean_est = mean_est
        s.cov_est = 0.5 * (covs + covs.T)
        s.num_likelihood_evals = s.num_likelihood_evals + evals + k
        s.iteration += 1
    return s


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
    stop_at_log_likelihood: Optional[float] = None,
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
) -> NSRunData:
    """Run the nested-sampling loop on the device of ``starting_points``
    [n_live, d] with randomness from ``generator``; returns the raw buffers
    (use :func:`nested_sampling` for the whole pipeline).

    ``monte_carlo_method`` is ``"auto"`` (by dimension, see
    :func:`resolve_monte_carlo_method`), ``"adaptive_metropolis"``,
    ``"slice"`` or ``"chmc"``.  ``monte_carlo_steps`` is an int ``s`` or a
    triple, ``None`` for the method's dimension law: Metropolis steps (first
    chain ``s`` steps, retry blocks of ``s`` up to ``5 s``), slice updates,
    or leapfrog steps (``s // chmc_num_leapfrog`` trajectories).
    ``stop_at_log_likelihood`` replaces the evidence criterion by "iterate
    while the next deletion threshold is at most this level" (a dynamic-NS
    batch).  ``progress_callback(iteration, n_samples, log_z, entropy)`` is
    called every ``progress_interval`` iterations and ``interrupt_check()``
    once per iteration; both are plain host calls."""
    starting_points = torch.as_tensor(starting_points, dtype=problem.dtype, device=problem.device)
    n_live, dim = starting_points.shape
    if num_delete < 1 or num_delete >= n_live:
        raise ValueError("need 1 <= num_delete < n_live")
    monte_carlo_method = resolve_monte_carlo_method(monte_carlo_method, dim, gradient_check=problem.gradient_sanity)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(monte_carlo_method, dim)
    warn_if_slice_steps_below_dim(monte_carlo_method, monte_carlo_steps, dim, chmc_num_leapfrog)
    max_iterations = max(max_iterations, min_iterations)
    capacity = max_iterations * num_delete
    state = run_loop_from_state(
        problem, _init_state(problem, starting_points, capacity), generator,
        n_live=n_live, num_delete=num_delete, max_iterations=max_iterations, min_iterations=min_iterations,
        monte_carlo_steps=monte_carlo_steps, monte_carlo_method=monte_carlo_method,
        termination_fraction=termination_fraction, min_max_acceptance_rate=min_max_acceptance_rate,
        covariance_learn_delay=covariance_learn_delay, log_likelihood_maximum=log_likelihood_maximum,
        progress_callback=progress_callback, progress_interval=progress_interval,
        interrupt_check=interrupt_check, stop_at_log_likelihood=stop_at_log_likelihood,
        chmc_step_size=chmc_step_size, chmc_num_leapfrog=chmc_num_leapfrog,
    )
    return NSRunData(state=state, n_live=n_live, num_delete=num_delete, capacity=capacity)


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


def _segmented_loop(problem, starting_points, generator, checkpoint_path, checkpoint_every: int,
                    loop_kwargs: dict) -> NSRunData:
    """The loop in segments of ``checkpoint_every`` iterations, each saved."""
    from .checkpoint import resume_nested_sampling_loop, save_ns_run

    total_max = loop_kwargs.get("max_iterations", 10000)
    total_min = loop_kwargs.get("min_iterations", 100)
    seg_max = min(checkpoint_every, total_max)
    # the loop raises max_iterations to min_iterations: cap the segment's
    # min_iterations so it cannot run past its checkpoint boundary
    seg_kwargs = dict(loop_kwargs, max_iterations=seg_max, min_iterations=min(total_min, seg_max))
    run = nested_sampling_loop(problem, starting_points, generator, **seg_kwargs)
    save_ns_run(checkpoint_path, run, generator)
    # the resume entry resolves "auto" and monte_carlo_steps=None as the loop does,
    # so every segment runs the chains the first one ran
    resume_kwargs = {key: v for key, v in loop_kwargs.items()
                     if key not in ("max_iterations", "min_iterations", "num_delete")}
    while True:
        done = run.state.iteration - 1
        terminated = done < run.capacity // run.num_delete or run.state.interrupted
        if terminated or done >= total_max:
            return run
        extra = min(checkpoint_every, total_max - done)
        run = resume_nested_sampling_loop(problem, run, generator, extra_iterations=extra,
                                          min_iterations=min(total_min, done + extra), **resume_kwargs)
        save_ns_run(checkpoint_path, run, generator)


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
    with 0.

    With ``checkpoint_path`` and ``checkpoint_every`` the loop runs in
    segments of that many iterations and writes a resumable checkpoint
    after each (see :mod:`.checkpoint`)."""
    if generator is None:
        generator = torch.Generator(device=problem.device).manual_seed(0)
    if starting_points is None:
        starting_points = generate_starting_points(problem, generator, sample_pool_size)
    if checkpoint_path is not None and checkpoint_every:
        run = _segmented_loop(problem, starting_points, generator, checkpoint_path, checkpoint_every, loop_kwargs)
    else:
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
