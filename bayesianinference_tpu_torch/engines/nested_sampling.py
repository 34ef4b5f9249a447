"""Nested sampling (port of ``bayesianinference_tpu.engines.nested_sampling``).

Each iteration deletes the ``num_delete`` worst live points and replaces
them by that many chains run as one batch, started at random survivors:
adaptive-Metropolis chains up to d = 16, random-direction slice chains
above, constrained-HMC chains above d = 64 where the likelihood has a
usable gradient (the ``"auto"`` policy; each can be asked for by name).
Every chain step evaluates the batch's likelihoods in one call (for a GP
likelihood, one batched covariance assembly and one batched Cholesky on
the card; the constrained-HMC chains also run their reverse rules).

The JAX package's on-device ``while_loop`` is a Python loop here, over a
leading run axis (:func:`run_loop_batched`: R runs with their chains in one
batch, which the parallel runs use; a single run is R = 1).  The
per-iteration work stays batched tensor ops; the termination test reads
logZ and the missing-evidence estimate (or, for a dynamic-NS batch, the
deletion threshold) of every run back to the host once per iteration after
``min_iterations``, and the slice chains read one flag per pass of their
step-out and shrink loops.  Dead-point buffers are capacity-padded
(``max_iterations * num_delete``) and written in place; ``n_dead`` and the
iteration count are Python ints.  The likelihood-evaluation counter is one
int64 tensor on the device (the JAX package's (hi, lo) int32 digits and
``evals_to_int`` work around the TPU's lack of int64 and are not ported).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, List, Optional, Tuple

import torch

from ..core.numerics import log_zero, logaddexp, logsubexp, logsumexp
from ..core.shards import generator_on, in_batch_order
from ..models.placement import problem_on
from ..models.problem import InferenceProblem, random_domain_points
from ..ops.chmc import chmc_draws, run_chmc_chain
from ..ops.metropolis import am_init, proposal_chol, run_chain, run_chain_adaptive, small_cholesky
from ..ops.ns_math import crude_log_x_deleted, entropy_from_weights, log_x_live_tail, pool_schedule
from ..ops.slice import run_slice_chain, slice_draws
from .evidence import NestedSamplingResult, evidence_sampling, evidence_sampling_padded

__all__ = [
    "NSState",
    "NSBatchState",
    "NSRunData",
    "LoopConfig",
    "make_loop_config",
    "crude_log_z_masked",
    "default_monte_carlo_steps",
    "default_chmc_step_size",
    "default_chmc_num_leapfrog",
    "resolve_monte_carlo_method",
    "warn_if_slice_steps_below_dim",
    "shared_factor",
    "shared_factor_chains",
    "run_loop_batched",
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
    dead_logl: torch.Tensor,  # [..., cap]
    live_logl_sorted: torch.Tensor,  # [..., n] ascending
):
    """Crude logZ and the trapezoid log-weights (without the logL term) of
    the dead prefix and the live tail.  The weights depend on ``n_dead``
    alone, so runs that have made as many deletions share them.  Returns
    (log_z [...], dead_w [cap], live_w [n], live_log_x [n])."""
    dtype, dev = log_xd.dtype, log_xd.device
    cap = log_xd.shape[0]
    n = live_logl_sorted.shape[-1]
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
        logsumexp(torch.where(active, dead_w + dead_logl, torch.full_like(dead_w, lz)), dim=-1),
        logsumexp(live_w + live_logl_sorted, dim=-1),
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


@dataclasses.dataclass
class NSBatchState:
    """State of R runs of the loop, one leading run axis on every tensor
    of :class:`NSState`.  Runs that are still going have done the same
    number of iterations; a run that has ended keeps its state."""

    live_points: torch.Tensor  # [R, n, d], each run sorted ascending by logL
    live_logl: torch.Tensor  # [R, n]
    live_logp: torch.Tensor  # [R, n]
    dead_points: torch.Tensor  # [R, cap, d]
    dead_logl: torch.Tensor  # [R, cap]
    dead_logp: torch.Tensor  # [R, cap]
    dead_acc: torch.Tensor  # [R, cap]
    n_dead: List[int]
    iteration: List[int]  # 1-based
    mean_est: torch.Tensor  # [R, d]
    cov_est: torch.Tensor  # [R, d, d]
    log_z: torch.Tensor  # [R]
    entropy: torch.Tensor  # [R]
    log_missing: torch.Tensor  # [R]
    num_likelihood_evals: torch.Tensor  # [R] int64
    interrupted: bool = False

    @classmethod
    def of_state(cls, s: NSState) -> "NSBatchState":
        """One run as a batch of one; its tensors are views of ``s``'s."""
        kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(NSState)}
        kw = {k: v.unsqueeze(0) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        return cls(**dict(kw, n_dead=[s.n_dead], iteration=[s.iteration]))

    def state(self, r: int) -> NSState:
        """Run ``r`` as an :class:`NSState` (views of the batch's tensors)."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(NSState)}
        kw = {k: v[r] if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        return NSState(**dict(kw, n_dead=self.n_dead[r], iteration=self.iteration[r]))


def _batched_cov(x: torch.Tensor) -> torch.Tensor:
    """Sample covariance (ddof 1) of each run's points: [R, n, d] -> [R, d, d]."""
    xm = x - x.mean(dim=1, keepdim=True)
    return xm.mT @ xm / (x.shape[1] - 1)


def _init_batch(problem: InferenceProblem, starting_points: torch.Tensor, capacity: int) -> NSBatchState:
    """The state of R fresh runs from their starting points [R, n, d]; all
    R * n likelihoods in one batched call."""
    r, _, dim = starting_points.shape
    dtype, dev = starting_points.dtype, starting_points.device
    lz = log_zero(dtype)
    logl = problem.guarded_log_likelihood(starting_points)
    logp = problem.guarded_log_prior(starting_points)
    order = torch.argsort(logl, dim=1, stable=True)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=dev)  # noqa: E731
    return NSBatchState(
        live_points=torch.gather(starting_points, 1, order[..., None].expand(-1, -1, dim)),
        live_logl=torch.gather(logl, 1, order),
        live_logp=torch.gather(logp, 1, order),
        dead_points=torch.zeros((r, capacity, dim), dtype=dtype, device=dev),
        dead_logl=full((r, capacity), lz),
        dead_logp=full((r, capacity), lz),
        dead_acc=torch.zeros((r, capacity), dtype=dtype, device=dev),
        n_dead=[0] * r,
        iteration=[1] * r,
        mean_est=starting_points.mean(dim=1),
        cov_est=_batched_cov(starting_points),
        log_z=full((r,), lz),
        entropy=torch.zeros((r,), dtype=dtype, device=dev),
        log_missing=torch.zeros((r,), dtype=dtype, device=dev),
        num_likelihood_evals=torch.zeros((r,), dtype=torch.int64, device=dev),
    )


def _init_state(problem: InferenceProblem, starting_points: torch.Tensor, capacity: int) -> NSState:
    return _init_batch(problem, starting_points[None], capacity).state(0)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """The loop's options, resolved: a named chain kind (never ``"auto"``),
    the chain length as a triple, ``max_iterations >= min_iterations``."""

    max_iterations: int
    min_iterations: int
    mc_steps: Tuple[int, int, int]  # first chain, retry block, most steps (adaptive Metropolis)
    termination_fraction: float
    num_delete: int
    min_max_acceptance_rate: Tuple[float, float]
    covariance_learn_delay: int
    log_likelihood_maximum: Optional[float]
    progress_callback: Optional[Callable]
    progress_interval: int
    interrupt_check: Optional[Callable]
    monte_carlo_method: str
    chmc_step_size: Optional[float]
    chmc_num_leapfrog: Optional[int]

    @property
    def capacity(self) -> int:
        """Dead-buffer slots of one run."""
        return self.max_iterations * self.num_delete


def make_loop_config(
    dim: int,
    *,
    gradient_check: Optional[Callable[[], bool]] = None,
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
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
) -> LoopConfig:
    """The loop options of a ``dim``-dimensional problem, resolved once:
    ``"auto"`` through :func:`resolve_monte_carlo_method` (with the
    problem's ``gradient_check``), ``monte_carlo_steps=None`` to the chosen
    method's dimension law, an int ``s`` to the triple ``(s, s, 5 s)``.
    Warns where the chains get fewer updates or trajectories than there
    are dimensions.  The single-run loop, its resume and the parallel runs
    share it.  (The JAX ``make_loop_config`` defaults to 200 steps at every
    dimension and leaves ``"auto"`` to its caller.)"""
    method = resolve_monte_carlo_method(monte_carlo_method, dim, gradient_check=gradient_check)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(method, dim)
    warn_if_slice_steps_below_dim(method, monte_carlo_steps, dim, chmc_num_leapfrog)
    if isinstance(monte_carlo_steps, int):
        mc_steps = (monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps)
    else:
        mc_steps = tuple(int(v) for v in monte_carlo_steps)
    return LoopConfig(
        max_iterations=max(max_iterations, min_iterations),
        min_iterations=min_iterations,
        mc_steps=mc_steps,
        termination_fraction=float(termination_fraction),
        num_delete=num_delete,
        min_max_acceptance_rate=tuple(min_max_acceptance_rate),
        covariance_learn_delay=covariance_learn_delay,
        log_likelihood_maximum=log_likelihood_maximum,
        progress_callback=progress_callback,
        progress_interval=progress_interval,
        interrupt_check=interrupt_check,
        monte_carlo_method=method,
        chmc_step_size=None if chmc_step_size is None else float(chmc_step_size),
        chmc_num_leapfrog=None if chmc_num_leapfrog is None else int(chmc_num_leapfrog),
    )


def shared_factor(cov_est: torch.Tensor) -> torch.Tensor:
    """The factor of ``cov_est + 1e-10 I`` ([d, d] or one per run,
    [R, d, d]) that the slice and chmc chains of a run share; the identity
    where that factor is not finite."""
    eye = torch.eye(cov_est.shape[-1], dtype=cov_est.dtype, device=cov_est.device)
    factor = small_cholesky(cov_est + 1e-10 * eye)
    return torch.where(torch.isfinite(factor).flatten(-2).all(dim=-1)[..., None, None], factor, eye)


def shared_factor_chains(
    problem: InferenceProblem,
    generator: torch.Generator,
    x0: torch.Tensor,  # [chains, d]
    threshold,
    factor: torch.Tensor,
    method: str,  # "slice" or "chmc"
    num_steps: int,
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
):
    """The slice or constrained-HMC chains from ``x0`` on the prior where
    the likelihood exceeds ``threshold`` (a scalar or one per chain),
    shaped by ``factor`` (:func:`shared_factor`; [d, d], or [chains, d, d]
    for one per chain): ``num_steps`` slice updates, or
    ``num_steps // chmc_num_leapfrog`` trajectories.  Returns (points
    [chains, d], the share of updates that moved or of trajectories
    accepted [chains], likelihood evaluations per chain [chains])."""
    chains, dim = x0.shape
    dtype = x0.dtype
    if method == "slice":
        draws = slice_draws(generator, chains, dim, num_updates=num_steps, dtype=dtype)
        st = run_slice_chain(draws, x0, lambda x: problem.constrained_log_prior(x, threshold), factor)
        return st.x, st.moved.to(dtype) / num_steps, st.evals
    n_leap = chmc_num_leapfrog if chmc_num_leapfrog is not None else default_chmc_num_leapfrog(dim)
    n_traj = max(1, num_steps // n_leap)
    st = run_chmc_chain(
        chmc_draws(generator, n_traj, chains, dim, dtype=dtype), x0,
        problem.guarded_log_likelihood, problem.guarded_log_prior, threshold,
        factor, problem.lower, problem.upper, n_leap,
        chmc_step_size if chmc_step_size is not None else default_chmc_step_size(dim),
        in_support=problem.in_support,
    )
    return st.x, st.accepted.to(dtype) / n_traj, st.evals


def run_loop_batched(
    problem: InferenceProblem,
    b: NSBatchState,
    generator: torch.Generator,
    cfg: LoopConfig,
    *,
    n_live: int,
    stop_at_log_likelihood: Optional[float] = None,
) -> NSBatchState:
    """Iterate R runs of the loop from ``b`` until each has ended.  ``b`` is
    updated in place and returned; its dead buffers must hold
    ``cfg.capacity`` slots per run.

    An iteration treats the runs that are still going as one batch: one
    ``randint`` for the survivors that seed the chains ([R, k]), one batch
    of R * k chains (each run's chains share that run's proposal factor,
    and each chain gets its run's threshold), one likelihood call, a per-run
    stable re-sort and crude logZ.  The termination test reads one [R]
    vector back to the host per iteration after ``min_iterations``
    (counted in ``run_loop_batched.host_reads``).  A run that has ended
    keeps its state and its evaluation counter, as under the JAX package's
    vmapped ``while_loop``, and its chains leave the batch.  With R = 1 this
    is the single-run loop: the same draws in the same order."""
    k = cfg.num_delete
    n_runs, _, dim = b.live_points.shape
    capacity = b.dead_logl.shape[1]
    if capacity != cfg.capacity:
        raise ValueError(f"dead buffers hold {capacity} slots, the loop needs {cfg.capacity}")
    num_steps, extra_steps, max_steps = cfg.mc_steps
    dtype, dev = b.live_points.dtype, b.live_points.device
    lz = log_zero(dtype)
    log_xd = crude_log_x_deleted(pool_schedule(n_live, k, capacity, dtype=dtype, device=dev))
    log_term = math.log(cfg.termination_fraction)
    min_acc, max_acc = cfg.min_max_acceptance_rate
    slots_all = torch.arange(capacity, device=dev)
    lz_cap = torch.full((capacity,), lz, dtype=dtype, device=dev)
    going = [r for r in range(n_runs) if b.iteration[r] <= cfg.max_iterations and not b.interrupted]
    # runs still going have done the same number of iterations
    if len({b.iteration[r] for r in going}) > 1:
        raise ValueError("the runs still going must stand at the same iteration")

    while going:
        it = b.iteration[going[0]]
        if b.interrupted or it > cfg.max_iterations:
            break
        if it > 1 and it > cfg.min_iterations:
            if stop_at_log_likelihood is not None:
                # a dynamic-NS batch: march the threshold up to the level and ignore the evidence criterion
                keep = b.live_logl[going, k - 1] <= stop_at_log_likelihood
            else:
                keep = b.log_missing[going] > b.log_z[going] + log_term
            run_loop_batched.host_reads += 1
            going = [r for r, kp in zip(going, keep.tolist()) if kp]
            if not going:
                break
        every = len(going) == n_runs
        rows = slice(None) if every else torch.tensor(going, device=dev)
        ra, c = len(going), len(going) * k
        live_points, live_logl, live_logp = b.live_points[rows], b.live_logl[rows], b.live_logp[rows]
        threshold = live_logl[:, k - 1]
        cov_est = 0.5 * (b.cov_est[rows] + _batched_cov(live_points))
        mean_est = b.mean_est[rows]

        # chains start at random survivors (ranks >= k) of their own run
        start_idx = torch.randint(k, n_live, (ra, k), generator=generator, device=dev)
        x0 = live_points[torch.arange(ra, device=dev)[:, None], start_idx].reshape(c, dim)
        chain_threshold = threshold[:, None].expand(ra, k).reshape(c)
        if cfg.monte_carlo_method in ("slice", "chmc"):
            factor = shared_factor(cov_est)
            # one run's chains share one factor
            factor = factor[0] if ra == 1 else factor.repeat_interleave(k, dim=0)
            xs, accs, evals = shared_factor_chains(problem, generator, x0, chain_threshold, factor,
                                                   cfg.monte_carlo_method, num_steps, cfg.chmc_step_size,
                                                   cfg.chmc_num_leapfrog)
            mean_new, covs = mean_est, cov_est
        else:
            def density(x):
                return problem.constrained_log_prior(x, chain_threshold)

            st = am_init(x0, density, mean0=mean_est.repeat_interleave(k, dim=0), t0=10,
                         chol0=proposal_chol(cov_est).repeat_interleave(k, dim=0))
            st, accs = run_chain_adaptive(
                generator, st, density, num_steps, extra_steps, max_steps,
                min_acceptance=min_acc, max_acceptance=max_acc, learn_delay=cfg.covariance_learn_delay,
            )
            xs, evals = st.x, st.proposed
            mean_new, covs = st.mean.reshape(ra, k, dim).mean(dim=1), st.cov.reshape(ra, k, dim, dim).mean(dim=1)
        new_logl = problem.guarded_log_likelihood(xs).reshape(ra, k)
        new_logp = problem.guarded_log_prior(xs).reshape(ra, k)

        nd = b.n_dead[going[0]]
        slots = slice(nd, nd + k)
        b.dead_points[rows, slots] = live_points[:, :k]
        b.dead_logl[rows, slots] = live_logl[:, :k]
        b.dead_logp[rows, slots] = live_logp[:, :k]
        b.dead_acc[rows, slots] = accs.reshape(ra, k)
        live_points = torch.cat([xs.reshape(ra, k, dim), live_points[:, k:]], dim=1)
        live_logl = torch.cat([new_logl, live_logl[:, k:]], dim=1)
        live_logp = torch.cat([new_logp, live_logp[:, k:]], dim=1)
        order = torch.argsort(live_logl, dim=1, stable=True)
        live_points = torch.gather(live_points, 1, order[..., None].expand(-1, -1, dim))
        live_logl, live_logp = torch.gather(live_logl, 1, order), torch.gather(live_logp, 1, order)
        nd += k

        dead_logl = b.dead_logl[rows]
        log_z, dead_w, live_w, live_log_x = crude_log_z_masked(log_xd, nd, dead_logl, live_logl)
        lmax = live_logl[:, -1] if cfg.log_likelihood_maximum is None else torch.full(
            (ra,), cfg.log_likelihood_maximum, dtype=dtype, device=dev)
        active = slots_all < nd
        entropy = entropy_from_weights(
            torch.cat([torch.where(active, dead_w + dead_logl, lz_cap), live_w + live_logl], dim=-1),
            torch.cat([torch.where(active, dead_logl, lz_cap), live_logl], dim=-1),
            log_z,
        )
        if every:
            b.live_points, b.live_logl, b.live_logp = live_points, live_logl, live_logp
            b.log_z, b.entropy, b.log_missing = log_z, entropy, live_log_x[-1] + lmax
            b.mean_est, b.cov_est = mean_new, 0.5 * (covs + covs.mT)
            b.num_likelihood_evals = b.num_likelihood_evals + evals.reshape(ra, k).sum(dim=1) + k
        else:
            b.live_points[rows], b.live_logl[rows], b.live_logp[rows] = live_points, live_logl, live_logp
            b.log_z[rows], b.entropy[rows], b.log_missing[rows] = log_z, entropy, live_log_x[-1] + lmax
            b.mean_est[rows], b.cov_est[rows] = mean_new, 0.5 * (covs + covs.mT)
            b.num_likelihood_evals[rows] += evals.reshape(ra, k).sum(dim=1) + k
        if cfg.progress_callback is not None and cfg.progress_interval > 0 and it % cfg.progress_interval == 0:
            for j, r in enumerate(going):
                cfg.progress_callback(it, nd + n_live, float(log_z[j]), float(entropy[j]))
        if cfg.interrupt_check is not None:
            b.interrupted = bool(cfg.interrupt_check())
        for r in going:
            b.n_dead[r] = nd
            b.iteration[r] = it + 1
    return b


run_loop_batched.host_reads = 0


def _in_batch_order(parts, groups, device) -> NSBatchState:
    """The device groups' run batches as one, in the runs' order."""
    order = torch.argsort(torch.cat([idx.cpu() for idx, _ in groups])).tolist()
    kw = {}
    for f in dataclasses.fields(NSBatchState):
        vals = [getattr(p, f.name) for p in parts]
        if isinstance(vals[0], torch.Tensor):
            kw[f.name] = in_batch_order(vals, groups, device)
        elif isinstance(vals[0], list):
            joined = [v for part in vals for v in part]
            kw[f.name] = [joined[i] for i in order]
        else:
            kw[f.name] = any(vals)
    return NSBatchState(**kw)


def runs_by_device(problem: InferenceProblem, starts, generator, cfg, *, groups, n_live: int, copies=None,
                   **loop) -> NSBatchState:
    """The runs from ``starts`` [R, n_live, d], each device group of
    ``groups`` (:func:`..parallel.sharding.device_groups`) as one
    :func:`run_loop_batched` batch on its device against its copy of the
    problem (kept in ``copies`` by device, when given, for the next call),
    merged on the problem's device in the runs' order.  One group on the
    problem's device is the one-batch call."""
    copies = {} if copies is None else copies
    parts = []
    for idx, dev in groups:
        if dev not in copies:
            copies[dev] = problem_on(problem, dev)
        p = copies[dev]
        parts.append(run_loop_batched(p, _init_batch(p, starts[idx].to(dev), cfg.capacity),
                                      generator_on(generator, dev), cfg, n_live=n_live, **loop))
    return _in_batch_order(parts, groups, problem.device)


def run_loop_from_state(
    problem: InferenceProblem,
    s: NSState,
    generator: torch.Generator,
    cfg: LoopConfig,
    *,
    n_live: int,
    stop_at_log_likelihood: Optional[float] = None,
) -> NSState:
    """Iterate one run from ``s`` (a fresh state or a resumed one) until it
    terminates: :func:`run_loop_batched` on a batch of one.  The dead
    buffers of ``s`` are written in place; they must hold ``cfg.capacity``
    slots."""
    b = run_loop_batched(problem, NSBatchState.of_state(s), generator, cfg, n_live=n_live,
                         stop_at_log_likelihood=stop_at_log_likelihood)
    return b.state(0)


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
    cfg = make_loop_config(
        dim, gradient_check=problem.gradient_sanity, max_iterations=max_iterations,
        min_iterations=min_iterations, monte_carlo_steps=monte_carlo_steps,
        termination_fraction=termination_fraction, num_delete=num_delete,
        min_max_acceptance_rate=min_max_acceptance_rate, covariance_learn_delay=covariance_learn_delay,
        log_likelihood_maximum=log_likelihood_maximum, progress_callback=progress_callback,
        progress_interval=progress_interval, interrupt_check=interrupt_check,
        monte_carlo_method=monte_carlo_method, chmc_step_size=chmc_step_size, chmc_num_leapfrog=chmc_num_leapfrog,
    )
    state = run_loop_from_state(problem, _init_state(problem, starting_points, cfg.capacity), generator, cfg,
                                n_live=n_live, stop_at_log_likelihood=stop_at_log_likelihood)
    return NSRunData(state=state, n_live=n_live, num_delete=num_delete, capacity=cfg.capacity)


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
