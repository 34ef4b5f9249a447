"""Adaptive tempered sequential Monte Carlo (port of
``bayesianinference_tpu.engines.smc``).

The prior anneals into the posterior along
``pi_beta(theta) ~ prior(theta) * likelihood(theta)^beta``; each stage
picks the temperature step by bisection so that the incremental weights
keep a target effective-sample fraction, adds
``logmeanexp(delta * logL)`` to logZ, resamples systematically and
rejuvenates the particles with block adaptive-Metropolis chains
(:mod:`..ops.metropolis`) aimed at the new temperature.

The R replicate runs advance together, as in the JAX package's flat
batch: their [R, n] ladders share one stage loop, and the rejuvenation
chains of all runs form one [R n] batch, each run's mean, covariance and
proposal factor repeated over its block and the tempered density taking a
per-chain beta.  A finished run's updates are masked.  The stage loop reads
one value to the host per stage (whether any run is still going); the
bisection is a fixed number of batched steps with no read.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.containers import WeightedSamples
from ..core.numerics import log_zero, logsumexp
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_block, am_init, proposal_chol, run_chain
from ..results.diagnostics import _host
from .evidence import MeanAndError

__all__ = [
    "SMCConfig",
    "SMCResult",
    "SMCStageDraws",
    "smc_sampler",
    "smc_log_evidence",
    "states_to_result",
    "thermodynamic_log_evidence",
]


def prepare_smc_starting_points(problem: InferenceProblem, generator: torch.Generator, starting_points, num_runs,
                                n_particles):
    """The [num_runs, n_particles, d] starting particles and n_particles:
    prior draws for ``None``; a 2-D [n_particles, d] array is taken for
    ``num_runs == 1``; otherwise the leading axis must be ``num_runs``."""
    if num_runs < 1:
        raise ValueError("num_runs must be >= 1")
    if starting_points is None:
        from .nested_sampling import generate_starting_points

        pts = generate_starting_points(problem, generator, num_runs * n_particles)
        return pts.reshape(num_runs, n_particles, -1), n_particles
    starting_points = torch.as_tensor(starting_points, dtype=problem.dtype, device=problem.device)
    if starting_points.dim() == 2 and num_runs == 1:
        starting_points = starting_points[None]
    if starting_points.dim() != 3 or starting_points.shape[0] != num_runs:
        raise ValueError(
            f"starting_points must be [num_runs={num_runs}, n_particles, d] (or [n_particles, d] when "
            f"num_runs == 1), got shape {tuple(starting_points.shape)}")
    return starting_points, starting_points.shape[1]


class SMCConfig(NamedTuple):
    """Static SMC configuration."""

    max_stages: int = 100
    mcmc_steps: int = 10
    ess_target: float = 0.5  # target ESS fraction of the delta-beta search
    covariance_learn_delay: int = 10
    bisection_iters: int = 50


class SMCStageDraws(NamedTuple):
    """One stage's random inputs for R ladders of n particles: the
    resampling offsets ``offset`` [R] (uniforms) and the rejuvenation
    block's normals ``z`` [R n, d, mcmc_steps] and acceptance log-uniforms
    ``log_u`` [R n, mcmc_steps] (see :func:`..ops.metropolis.am_draws`)."""

    offset: torch.Tensor
    z: torch.Tensor
    log_u: torch.Tensor


class _SMCState(NamedTuple):
    """Ladder state, batched over the replicate-run axis R."""

    particles: torch.Tensor  # [R, n, d]
    logl: torch.Tensor  # [R, n] guarded log-likelihood at the particles
    beta: torch.Tensor  # [R] temperatures in [0, 1]
    log_z: torch.Tensor  # [R] accumulated log-evidence
    stage: torch.Tensor  # [R] int64: completed stages
    betas: torch.Tensor  # [R, max_stages] temperature after each stage
    ess_hist: torch.Tensor  # [R, max_stages] ESS fraction per stage
    acc_hist: torch.Tensor  # [R, max_stages] mean MH acceptance per stage
    logl_mean_hist: torch.Tensor  # [R, max_stages] E_beta[logL] per stage
    logl_var_hist: torch.Tensor  # [R, max_stages] Var_beta[logL] per stage
    logl_mean0: torch.Tensor  # [R] E_prior[logL] (the beta = 0 end of TI)
    logl_var0: torch.Tensor  # [R] Var_prior[logL]


def _ess_fraction(delta, logl: torch.Tensor, n: int) -> torch.Tensor:
    """ESS fraction of the weights exp(delta * logl) over the last axis of
    ``logl`` [..., n], for ``delta`` of the leading shape.  The max-shift
    keeps the exponentials in range with sentinels in ``logl``."""
    delta = torch.as_tensor(delta, dtype=logl.dtype, device=logl.device)
    lw = delta[..., None] * logl
    lw = lw - lw.amax(dim=-1, keepdim=True)
    return torch.exp(2.0 * logsumexp(lw, dim=-1) - logsumexp(2.0 * lw, dim=-1)) / n


def _find_delta(logl: torch.Tensor, beta, cfg: SMCConfig):
    """The largest delta-beta whose ESS fraction stays at or above the
    target, by ``cfg.bisection_iters`` bisection steps, for ``logl``
    [..., n] and ``beta`` [...]; the whole remaining step when even that
    keeps the target.  Returns (delta, full_ok)."""
    dtype = logl.dtype
    n = logl.shape[-1]
    beta = torch.as_tensor(beta, dtype=dtype, device=logl.device)
    remaining = 1.0 - beta
    target = cfg.ess_target
    full_ok = _ess_fraction(remaining, logl, n) >= target
    lo, hi = torch.zeros_like(remaining), remaining
    for _ in range(cfg.bisection_iters):
        mid = 0.5 * (lo + hi)
        ok = _ess_fraction(mid, logl, n) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    delta = torch.where(full_ok, remaining, lo)
    # a degenerate population (all weight on one particle at any delta)
    # still moves.  The floor must survive beta + delta in this dtype:
    # remaining * 2^-50 alone vanishes against float32's eps and would
    # re-test one beta for all max_stages stages
    eps = torch.finfo(dtype).eps
    min_delta = torch.maximum(remaining * 2.0 ** (-cfg.bisection_iters),
                              4.0 * eps * torch.clamp(beta, min=0.5))
    return torch.minimum(torch.clamp(torch.maximum(delta, min_delta), min=0.0), remaining), full_ok


def _systematic_resample(u: torch.Tensor, log_w: torch.Tensor) -> torch.Tensor:
    """Systematic resampling of [..., n] log-weights with one uniform
    offset ``u`` [...] each: the indices at the grid (i + u) / n of the
    normalized cumulative weights, by ``searchsorted`` (left side)."""
    n = log_w.shape[-1]
    w = torch.exp(log_w - logsumexp(log_w, dim=-1, keepdim=True))
    cum = torch.cumsum(w, dim=-1)
    cum = cum / cum[..., -1:]
    positions = (torch.arange(n, dtype=log_w.dtype, device=log_w.device) + u[..., None]) / n
    return torch.clamp(torch.searchsorted(cum.contiguous(), positions.contiguous()), 0, n - 1)


def _population_logl_moments(logl: torch.Tensor, lz: float):
    """Equal-weight mean and variance of logL over the last axis, without
    the log-zero sentinels: the thermodynamic-integration integrand
    E_beta[logL] and its derivative Var_beta[logL]."""
    ok = logl > 0.5 * lz
    cnt = torch.clamp(ok.sum(dim=-1), min=1).to(logl.dtype)
    zero = torch.zeros_like(logl)
    mean = torch.where(ok, logl, zero).sum(dim=-1) / cnt
    var = torch.where(ok, (logl - mean[..., None]) ** 2, zero).sum(dim=-1) / cnt
    return mean, var


def _tempered_density(problem: InferenceProblem, beta, lz: float):
    """log pi_beta = logprior + beta logL, log-zero outside the support;
    ``beta`` is a number or one per chain [C]."""

    def density(x):
        val = problem.guarded_log_prior(x) + beta * problem.guarded_log_likelihood(x)
        return torch.where(problem.in_support(x), val, torch.full_like(val, lz))

    return density


def _smc_ladders(problem: InferenceProblem, particles: torch.Tensor, generator: torch.Generator,
                 cfg: SMCConfig, draws: Optional[Sequence[SMCStageDraws]] = None) -> _SMCState:
    """All R ladders in one stage loop over a flat chain batch, from the
    [R, n, d] prior particles to beta = 1.  ``draws[t]`` (one
    :class:`SMCStageDraws` per pass of the stage loop) replaces the
    generator's numbers of pass t."""
    num_runs, n, d = particles.shape
    dtype, dev = particles.dtype, particles.device
    lz = log_zero(dtype)
    r_idx = torch.arange(num_runs, device=dev)
    eye = torch.eye(d, dtype=dtype, device=dev)

    logl0 = problem.guarded_log_likelihood(particles)
    mean0, var0 = _population_logl_moments(logl0, lz)
    nan_hist = lambda: torch.full((num_runs, cfg.max_stages), math.nan, dtype=dtype, device=dev)  # noqa: E731
    s = _SMCState(
        particles=particles, logl=logl0, beta=torch.zeros((num_runs,), dtype=dtype, device=dev),
        log_z=torch.zeros((num_runs,), dtype=dtype, device=dev),
        stage=torch.zeros((num_runs,), dtype=torch.int64, device=dev),
        betas=nan_hist(), ess_hist=nan_hist(), acc_hist=nan_hist(), logl_mean_hist=nan_hist(),
        logl_var_hist=nan_hist(), logl_mean0=mean0, logl_var0=var0,
    )

    for t in itertools.count():
        active = (s.beta < 1.0) & (s.stage < cfg.max_stages)  # [R]
        if not bool(active.any()):  # the loop's one host read per stage
            break
        delta, full_ok = _find_delta(s.logl, s.beta, cfg)
        # a finished run self-masks: at beta = 1 the remaining step is 0
        beta_new = torch.where(full_ok, torch.ones_like(s.beta), s.beta + delta)
        beta_new = torch.where(active, beta_new, s.beta)

        # evidence increment with equal pre-weights (resampled every stage)
        lw = delta[:, None] * s.logl  # [R, n]
        inc = logsumexp(lw, dim=1) - math.log(n)
        log_z = s.log_z + torch.where(active, inc, torch.zeros_like(inc))
        ess_frac = _ess_fraction(delta, s.logl, n)

        stage_draws = None if draws is None else draws[t]
        u = (torch.rand((num_runs,), generator=generator, dtype=dtype, device=dev) if stage_draws is None
             else stage_draws.offset)
        idx = _systematic_resample(u, lw)  # [R, n]
        resampled = torch.gather(s.particles, 1, idx[:, :, None].expand(-1, -1, d))

        # rejuvenation: per-run proposal factors from each run's population
        # covariance, repeated over that run's block of the flat batch
        means = resampled.mean(dim=1)  # [R, d]
        centred = resampled - means[:, None]
        covs = centred.mT @ centred / (n - 1) + 1e-10 * eye
        chols = proposal_chol(covs)
        rep = lambda a: torch.repeat_interleave(a, n, dim=0)  # noqa: E731
        density = _tempered_density(problem, rep(beta_new), lz)
        st = am_init(resampled.reshape(num_runs * n, d), density, mean0=rep(means), t0=10, chol0=rep(chols))
        if stage_draws is None:
            st = run_chain(generator, st, density, cfg.mcmc_steps, cfg.covariance_learn_delay)
        else:
            st = am_block(st, density, stage_draws.z, stage_draws.log_u, cfg.covariance_learn_delay)
        xs = st.x.reshape(num_runs, n, d)
        logl = problem.guarded_log_likelihood(xs)
        acc_rate = st.accepted.reshape(num_runs, n).sum(dim=1).to(dtype) / (n * cfg.mcmc_steps)
        stage_mean, stage_var = _population_logl_moments(logl, lz)

        # only the active runs commit; histories write at each run's own
        # stage cursor (clamped: a finished run masks its write anyway)
        cur = torch.clamp(s.stage, max=cfg.max_stages - 1)

        def record(hist, val):
            hist = hist.clone()
            hist[r_idx, cur] = torch.where(active, val, hist[r_idx, cur])
            return hist

        s = _SMCState(
            particles=torch.where(active[:, None, None], xs, s.particles),
            logl=torch.where(active[:, None], logl, s.logl),
            beta=beta_new,
            log_z=log_z,
            stage=s.stage + active,
            betas=record(s.betas, beta_new),
            ess_hist=record(s.ess_hist, ess_frac),
            acc_hist=record(s.acc_hist, acc_rate),
            logl_mean_hist=record(s.logl_mean_hist, stage_mean),
            logl_var_hist=record(s.logl_var_hist, stage_var),
            logl_mean0=s.logl_mean0,
            logl_var0=s.logl_var0,
        )
    return s


@dataclasses.dataclass(frozen=True)
class SMCResult:
    """Output of :func:`smc_sampler`: equal-weight posterior particles per
    replicate run and the runs' logZ estimates."""

    particles: torch.Tensor  # [R, n, d] final (beta = 1) particles
    log_likelihoods: torch.Tensor  # [R, n]
    log_z_runs: torch.Tensor  # [R]
    log_evidence: MeanAndError  # mean +- SEM across runs (NaN SEM at R = 1)
    betas: torch.Tensor  # [R, max_stages] temperature ladder (NaN-padded)
    ess_fractions: torch.Tensor  # [R, max_stages]
    acceptance_rates: torch.Tensor  # [R, max_stages]
    n_stages: torch.Tensor  # [R]
    logl_means: Optional[torch.Tensor] = None  # [R, max_stages] E_beta[logL] per stage
    logl_vars: Optional[torch.Tensor] = None  # [R, max_stages] Var_beta[logL] per stage
    logl_mean_prior: Optional[torch.Tensor] = None  # [R] E_prior[logL]
    logl_var_prior: Optional[torch.Tensor] = None  # [R] Var_prior[logL]
    param_names: Tuple[str, ...] = ()
    num_likelihood_evals: int = 0

    @property
    def num_runs(self) -> int:
        return self.particles.shape[0]

    def posterior_samples(self) -> WeightedSamples:
        """All runs pooled as equal-weight posterior samples."""
        r, n, d = self.particles.shape
        pts = self.particles.reshape(r * n, d)
        return WeightedSamples(points=pts, log_weights=torch.zeros((r * n,), dtype=pts.dtype, device=pts.device),
                               log_likelihoods=self.log_likelihoods.reshape(r * n))


def smc_sampler(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    n_particles: int = 1000,
    num_runs: int = 4,
    starting_points=None,
    max_stages: int = 100,
    mcmc_steps: int = 10,
    ess_target: float = 0.5,
    covariance_learn_delay: int = 10,
) -> SMCResult:
    """Run ``num_runs`` independent adaptive tempered-SMC ladders on the
    problem's device (``generator`` None: one on that device seeded 0).

    Each run starts from ``n_particles`` prior draws (or rows of
    ``starting_points`` [num_runs, n_particles, d]), anneals to the
    posterior with ESS-adaptive temperature steps and gives one logZ; the
    replicates give the error bar.  ``mcmc_steps`` block-AM rejuvenation
    steps run per stage."""
    generator = torch.Generator(device=problem.device).manual_seed(0) if generator is None else generator
    starting_points, n_particles = prepare_smc_starting_points(problem, generator, starting_points, num_runs,
                                                               n_particles)
    cfg = SMCConfig(max_stages=max_stages, mcmc_steps=mcmc_steps, ess_target=float(ess_target),
                    covariance_learn_delay=covariance_learn_delay)
    states = _smc_ladders(problem, starting_points, generator, cfg)
    return states_to_result(states, cfg, problem.param_names)


def states_to_result(states: _SMCState, cfg: SMCConfig, param_names: Tuple[str, ...]) -> SMCResult:
    """The public result from the batched final ladder states."""
    num_runs, n_particles = states.logl.shape
    if bool((states.beta < 1.0).any()):
        warnings.warn(
            f"SMC ladder hit max_stages={cfg.max_stages} before beta=1 in at least one run; its logZ is an "
            "underestimate — raise max_stages or ess_target", stacklevel=2)
    log_z_runs = states.log_z
    sem = (torch.std(log_z_runs, correction=1) / math.sqrt(num_runs) if num_runs > 1
           else torch.tensor(math.nan, dtype=log_z_runs.dtype, device=log_z_runs.device))
    stages = states.stage
    # per stage: n chain-step evals + n fresh logL evals + the init eval
    # inside am_init; plus the n initial prior-particle evaluations
    evals = int(stages.sum()) * n_particles * (cfg.mcmc_steps + 2) + num_runs * n_particles
    return SMCResult(
        particles=states.particles, log_likelihoods=states.logl, log_z_runs=log_z_runs,
        log_evidence=MeanAndError(mean=log_z_runs.mean(), standard_error=sem),
        betas=states.betas, ess_fractions=states.ess_hist, acceptance_rates=states.acc_hist, n_stages=stages,
        logl_means=states.logl_mean_hist, logl_vars=states.logl_var_hist, logl_mean_prior=states.logl_mean0,
        logl_var_prior=states.logl_var0, param_names=param_names, num_likelihood_evals=evals,
    )


def smc_log_evidence(problem: InferenceProblem, generator: Optional[torch.Generator] = None,
                     **kwargs) -> MeanAndError:
    """Just the logZ estimate (mean +- SEM across runs)."""
    return smc_sampler(problem, generator, **kwargs).log_evidence


def thermodynamic_log_evidence(result: SMCResult) -> MeanAndError:
    """Thermodynamic-integration logZ from an SMC run's ladder:
    ``logZ = integral_0^1 E_beta[logL] dbeta`` per run by the
    variance-corrected trapezoid rule of Friel, Hurn & Wyse (2014),

        (b-a)(E_a + E_b)/2 - (b-a)^2 (V_b - V_a)/12  on each [a, b],

    with Var_beta[logL] = dE/dbeta as exact endpoint derivatives; both
    moments were recorded during the ladder.  An estimator independent of
    ``result.log_evidence``'s weights: disagreement beyond the error bars
    flags an under-resolved ladder.  Returns the across-run mean +- SEM
    (NaN SEM at one run), host-side numpy as in the JAX package."""
    if result.logl_means is None:
        raise ValueError("this SMCResult has no recorded logl_means; re-run smc_sampler to use thermodynamic "
                         "integration")
    betas, means, vars_ = _host(result.betas), _host(result.logl_means), _host(result.logl_vars)
    e0, v0 = _host(result.logl_mean_prior), _host(result.logl_var_prior)
    vals = []
    for r in range(betas.shape[0]):
        m = np.isfinite(betas[r])
        b = np.concatenate([[0.0], betas[r][m]])
        e = np.concatenate([[e0[r]], means[r][m]])
        v = np.concatenate([[v0[r]], vars_[r][m]])
        db = np.diff(b)
        vals.append(np.sum(db * (e[:-1] + e[1:]) / 2.0) - np.sum(db**2 * (v[1:] - v[:-1]) / 12.0))
    vals = np.asarray(vals)
    sem = np.std(vals, ddof=1) / np.sqrt(len(vals)) if len(vals) > 1 else np.nan
    ref = result.log_z_runs
    return MeanAndError(mean=torch.tensor(vals.mean(), dtype=ref.dtype, device=ref.device),
                        standard_error=torch.tensor(sem, dtype=ref.dtype, device=ref.device))
