"""Hamiltonian Monte Carlo: jittered fixed-length leapfrog trajectories
and a dual-averaging, windowed warmup (port of
``bayesianinference_tpu.ops.hmc``).

The JAX package writes one chain and ``vmap``s it; here the chains are a
written-out leading axis: ``x`` is [C, d] and ``log_density_fn`` maps
[C, d] -> [C].  Value and gradient come from autograd on the batched call
(``ops/chmc.py::_value_and_grad``): the rows are independent, so one
backward pass of the summed values gives every chain its own gradient and
runs each reverse rule once at batch size C.  ``lax.scan`` becomes a host
loop with no host read inside it.

The inverse mass is one matrix shared by the chains: a [d] vector of
variances or a dense [d, d] covariance.  Every trajectory draws a fresh
momentum, a step-size jitter in [0.8, 1.2] eps and an acceptance uniform
per chain; those numbers are inputs (:class:`HMCDraws`, made by
:func:`hmc_draws`), so the CPU tests feed the port the very draws of the
JAX function.

The chains may also be split over the shards of a mesh axis
(``shards=``, a :class:`..core.shards.ShardAxis`, as the JAX
function's ``axis_name``): each shard steps its block on its device with
its own density, and the acceptance mean and the moments are reduced
across the shards on the home device, the moments by the JAX package's
Chan merge of the shards' own.  One batch is the one-shard case of the
same code.

Out-of-support points carry the finite log-zero sentinel.  Non-finite
gradients are zeroed after the call; a trajectory that ends on the
sentinel, or whose energy error is non-finite or above 1000 (divergent),
has acceptance probability 0.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import is_log_zero
from ..core.shards import ShardAxis
from .chmc import _safe_grad, _value_and_grad
from .gp_kernels import cholesky

__all__ = [
    "HMCState",
    "HMCDraws",
    "DAState",
    "hmc_init",
    "hmc_draws",
    "hmc_step",
    "leapfrog",
    "momentum_factor",
    "dual_averaging_init",
    "dual_averaging_update",
    "warmup_and_sample",
]

# energy error above which a trajectory counts as divergent (Stan's cutoff)
_DIVERGENCE_THRESHOLD = 1000.0


class HMCState(NamedTuple):
    """Chain state: positions with their cached density and gradient."""

    x: torch.Tensor  # [C, d]
    log_density: torch.Tensor  # [C]
    grad: torch.Tensor  # [C, d]
    accepted: torch.Tensor  # [C] int64
    proposed: torch.Tensor  # [C] int64
    divergences: torch.Tensor  # [C] int64


class HMCDraws(NamedTuple):
    """The random inputs of one trajectory of C chains, or of T trajectories
    with that as the leading axis."""

    momentum: torch.Tensor  # [..., C, d] standard normal
    jitter: torch.Tensor  # [..., C] uniform on [-1, 1): the step is eps (1 + jitter * this)
    accept: torch.Tensor  # [..., C] uniform on [0, 1)


def hmc_draws(generator: torch.Generator, chains: int, dim: int, *, num_trajectories: Optional[int] = None,
              dtype: Optional[torch.dtype] = None) -> HMCDraws:
    lead = () if num_trajectories is None else (num_trajectories,)
    kw = dict(generator=generator, dtype=dtype or torch.get_default_dtype(), device=generator.device)
    return HMCDraws(
        momentum=torch.randn(lead + (chains, dim), **kw),
        jitter=2.0 * torch.rand(lead + (chains,), **kw) - 1.0,
        accept=torch.rand(lead + (chains,), **kw),
    )


def _zero_counts(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:1], dtype=torch.int64, device=x.device)


def hmc_init(x0: torch.Tensor, log_density_fn: Callable) -> HMCState:
    lp, g = _value_and_grad(log_density_fn, x0)
    zero = _zero_counts(x0)
    return HMCState(x=x0.detach(), log_density=lp, grad=_safe_grad(g), accepted=zero, proposed=zero,
                    divergences=zero)


def _apply_inv_mass(inv_mass: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """M^-1 p for each row of ``p`` [C, d]: one [C, d] @ [d, d] product for a
    dense (symmetric) inverse mass."""
    if inv_mass.dim() == 2:
        return p @ inv_mass
    return inv_mass * p


def _kinetic(p: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * (p * _apply_inv_mass(inv_mass, p)).sum(dim=-1)


def _col(step_size):
    """A per-chain [C] step size as a column that broadcasts over [C, d]."""
    return step_size[:, None] if isinstance(step_size, torch.Tensor) and step_size.dim() == 1 else step_size


def leapfrog(x, p, grad, log_density_fn: Callable, step_size, inv_mass, num_steps: int):
    """``num_steps`` leapfrog steps of every chain from (x, p) with the
    gradient at x supplied, so each step costs one batched
    value-and-gradient.  ``step_size`` is a number, a 0-d tensor or one per
    chain [C].  Returns (x, p, log_density, grad) at the trajectory end."""
    eps = _col(step_size)
    lp = None
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * grad
        x = x + eps * _apply_inv_mass(inv_mass, p_half)
        lp, g = _value_and_grad(log_density_fn, x)
        grad = _safe_grad(g)
        p = p_half + 0.5 * eps * grad
    return x, p, lp, grad


def momentum_factor(inv_mass: torch.Tensor) -> torch.Tensor:
    """The factor that turns standard normals into p ~ N(0, M):
    1/sqrt(var) for a diagonal inverse mass; for a dense one
    U = L^-1 with inv_mass = L L^T (so U^T U = M), the factor through the
    ``cholesky`` op (the hand kernel on the card, NaN if not positive
    definite)."""
    if inv_mass.dim() == 2:
        lc = cholesky(0.5 * (inv_mass + inv_mass.mT))
        eye = torch.eye(inv_mass.shape[-1], dtype=inv_mass.dtype, device=inv_mass.device)
        return torch.linalg.solve_triangular(lc, eye, upper=False)
    return 1.0 / torch.sqrt(inv_mass)


def _sample_momentum(z: torch.Tensor, p_chol: torch.Tensor) -> torch.Tensor:
    return z @ p_chol if p_chol.dim() == 2 else z * p_chol


def _accept_prob(h0, h1, lp_new):
    """(acceptance probability, divergent) of trajectories with start and
    end energies h0, h1 [C]."""
    energy_error = h1 - h0
    divergent = torch.logical_not(torch.isfinite(energy_error)) | (energy_error > _DIVERGENCE_THRESHOLD)
    # sentinel end states are never accepted
    bad = divergent | is_log_zero(lp_new)
    prob = torch.where(bad, torch.zeros_like(energy_error), torch.clamp(torch.exp(-energy_error), max=1.0))
    return prob, divergent


def _select(accept, old: HMCState, x_new, lp_new, g_new, divergent) -> HMCState:
    """The accepted chains' end states, the others' old ones, and the
    counters advanced."""
    col = accept[:, None]
    return HMCState(
        x=torch.where(col, x_new, old.x),
        log_density=torch.where(accept, lp_new, old.log_density),
        grad=torch.where(col, g_new, old.grad),
        accepted=old.accepted + accept,
        proposed=old.proposed + 1,
        divergences=old.divergences + divergent,
    )


def hmc_step(draws: HMCDraws, state: HMCState, log_density_fn: Callable, step_size, inv_mass, num_leapfrog: int,
             jitter: float = 0.2, p_chol: Optional[torch.Tensor] = None):
    """One trajectory of every chain: momentum refresh, leapfrog with a
    per-chain jittered step, Metropolis test.  Returns (state, acceptance
    probability [C]): the probability, not the outcome, is what dual
    averaging consumes.  ``p_chol`` is :func:`momentum_factor` of
    ``inv_mass``, made here when omitted."""
    if p_chol is None:
        p_chol = momentum_factor(inv_mass)
    p0 = _sample_momentum(draws.momentum, p_chol)
    eps = step_size * (1.0 + jitter * draws.jitter)  # [C]
    x_new, p_new, lp_new, g_new = leapfrog(state.x, p0, state.grad, log_density_fn, eps, inv_mass, num_leapfrog)
    h0 = -state.log_density + _kinetic(p0, inv_mass)
    h1 = -lp_new + _kinetic(p_new, inv_mass)
    prob, divergent = _accept_prob(h0, h1, lp_new)
    accept = draws.accept < prob
    return _select(accept, state, x_new, lp_new, g_new, divergent), prob


class DAState(NamedTuple):
    """Dual-averaging accumulators (Hoffman & Gelman 2014, Alg. 5)."""

    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    t: int  # updates so far (known on the host: no read)
    mu: torch.Tensor  # shrinkage target log(10 eps0)


def dual_averaging_init(eps0: torch.Tensor) -> DAState:
    return DAState(log_eps=torch.log(eps0), log_eps_bar=torch.zeros_like(eps0), h_bar=torch.zeros_like(eps0), t=0,
                   mu=torch.log(10.0 * eps0))


def dual_averaging_update(da: DAState, accept_prob, target_accept: float = 0.8, gamma: float = 0.05,
                          t0: float = 10.0, kappa: float = 0.75) -> DAState:
    t = da.t + 1
    w = 1.0 / (t + t0)
    h_bar = (1.0 - w) * da.h_bar + w * (target_accept - accept_prob)
    log_eps = da.mu - math.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * da.log_eps_bar
    return DAState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t, mu=da.mu)


class _Welford(NamedTuple):
    """Moments over chain positions: mean [d], M2 ([d] or [d, d]), count."""

    mean: torch.Tensor
    m2: torch.Tensor
    n: int

    @classmethod
    def empty(cls, x: torch.Tensor, dense: bool) -> "_Welford":
        d = x.shape[-1]
        kw = dict(dtype=x.dtype, device=x.device)
        return cls(torch.zeros((d,), **kw), torch.zeros((d, d) if dense else (d,), **kw), 0)

    def merge(self, x: torch.Tensor) -> "_Welford":
        """Fold one iteration's [C, d] group in by the exact Chan merge."""
        c = x.shape[0]
        gm = x.mean(dim=0)
        diff = x - gm
        dense = self.m2.dim() == 2
        g_m2 = diff.T @ diff if dense else (diff * diff).sum(dim=0)
        tot = self.n + c
        delta = gm - self.mean
        corr = torch.outer(delta, delta) if dense else delta * delta
        return _Welford(self.mean + delta * (c / tot), self.m2 + g_m2 + corr * (self.n * c / tot), tot)

    def inv_mass(self) -> torch.Tensor:
        """The regularized inverse mass: ``nf/(nf+5) cov + shrink I`` with
        ``shrink = 1e-3 * 5/(nf+5)`` (Stan's), floored at 1e-10 when
        diagonal; the identity term keeps a dense one positive definite."""
        nf = float(self.n)
        mom2 = self.m2 / max(nf - 1.0, 1.0)
        shrink = (5.0 / (nf + 5.0)) * 1e-3
        if self.m2.dim() == 2:
            eye = torch.eye(self.m2.shape[0], dtype=self.m2.dtype, device=self.m2.device)
            return (nf / (nf + 5.0)) * mom2 + shrink * eye
        return torch.clamp((nf / (nf + 5.0)) * mom2 + shrink, min=1e-10)


class _FixedLength(NamedTuple):
    """The iteration of :func:`warmup_and_sample`: :func:`hmc_step`'s
    jittered trajectory of ``num_leapfrog`` steps on every shard of
    ``shards`` (each with its density in ``log_density_fns``)."""

    log_density_fns: list
    num_leapfrog: int
    shards: ShardAxis

    def step(self, draws, states, eps, inv_mass, p_chol, i: int, adapt: bool):
        """Iteration ``i`` of the run (0 at the first warmup iteration) from
        the shards' draws, states, inverse masses and momentum factors and
        the step size ``eps`` on the home device.  Returns (the shards'
        states, the mean acceptance probability of all chains: the ``pmean``
        of the shards' means)."""
        out = [hmc_step(dr, st, fn, e, m, self.num_leapfrog, p_chol=pc) for dr, st, fn, e, m, pc in
               zip(draws, states, self.log_density_fns, self.shards.send(eps), inv_mass, p_chol)]
        return [st for st, _ in out], self.shards.mean([probs.mean() for _, probs in out])

    def freeze(self, step_size):
        """The sampling phase's trajectory length, once warmup has ended."""
        return self.num_leapfrog * step_size


def _warmup_phase(next_draws: Callable, states: list, iteration, da: DAState, inv_mass, first: int,
                  num_iters: int, target_accept: float, collect_welford: bool, dense: bool = False):
    """One warmup phase, iterations ``first`` to ``first + num_iters - 1``:
    the chains of every shard step together, their MEAN acceptance
    probability drives one shared dual-averaging step size, and with
    ``collect_welford`` each iteration's positions are merged into each
    shard's moments ([d] variances, or the [d, d] covariance when
    ``dense``), returned per shard."""
    shards = iteration.shards
    p_chol, inv_mass = shards.send(momentum_factor(inv_mass)), shards.send(inv_mass)
    wfs = [_Welford.empty(st.x, dense) for st in states]
    for i in range(first, first + num_iters):
        states, ap_mean = iteration.step(next_draws(), states, torch.exp(da.log_eps), inv_mass, p_chol, i, True)
        da = dual_averaging_update(da, ap_mean, target_accept)
        if collect_welford:
            wfs = [wf.merge(st.x) for wf, st in zip(wfs, states)]
    return states, da, wfs


def _phase_lengths(num_warmup: int):
    p1 = max(num_warmup // 3, 1)
    p2 = max(num_warmup // 3, 1)
    return p1, p2, max(num_warmup - p1 - p2, 1)


def _draw_source(generator, draws, chains: int, dim: int, dtype, shards, make=hmc_draws):
    """A callable giving the next trajectory's draws, each shard's rows on
    its device: row t of ``draws`` at the t-th call, or fresh draws of all
    chains from ``generator`` when ``draws`` is None (the same numbers
    however the chains are sharded)."""
    rows = itertools.count()

    def take():
        if draws is None:
            whole = make(generator, chains, dim, dtype=dtype)
        else:
            t = next(rows)
            whole = type(draws)(*(a[t] for a in draws))
        return [type(whole)(*fields) for fields in zip(*(shards.split(a) for a in whole))]

    return take


def _on_shards(shards, log_density_fn, device):
    """(shards, the per-shard densities): with ``shards`` None, one shard
    on ``device`` and its density ``log_density_fn``; else ``shards`` and
    ``log_density_fn``, one density per shard."""
    if shards is not None:
        return shards, list(log_density_fn)
    return ShardAxis.one(device), [log_density_fn]


def _reset_counts(states: HMCState) -> HMCState:
    zero = torch.zeros_like(states.accepted)
    return states._replace(accepted=zero, proposed=zero, divergences=zero)


def _adapt_and_sample(next_draws: Callable, x0: torch.Tensor, iteration, *, num_warmup: int, num_samples: int,
                      thinning: int, target_accept: float, initial_step_size: float, dense_mass: bool):
    """The run of :func:`warmup_and_sample`, for any ``iteration``
    (:class:`_FixedLength`, or ChEES's learned length), each shard of
    ``iteration.shards`` running its block of the chains ``x0`` [C, d] (on
    the home device).  Returns (samples [C, num_samples, d], final states,
    step size, inverse mass, trajectory length), all on the home device."""
    c, d = x0.shape
    dtype = x0.dtype
    shards = iteration.shards
    states = [hmc_init(x, fn) for x, fn in zip(shards.split(x0), iteration.log_density_fns)]
    inv_mass = torch.ones((d,), dtype=dtype, device=x0.device)
    da = dual_averaging_init(torch.full((), initial_step_size, dtype=dtype, device=x0.device))
    p1, p2, p3 = _phase_lengths(num_warmup)
    states, da, _ = _warmup_phase(next_draws, states, iteration, da, inv_mass, 0, p1, target_accept, False)
    states, da, wfs = _warmup_phase(next_draws, states, iteration, da, inv_mass, p1, p2, target_accept, True,
                                    dense=dense_mass)
    inv_mass = _Welford(*shards.welford(wfs)).inv_mass()
    da = dual_averaging_init(torch.exp(da.log_eps_bar))
    states, da, _ = _warmup_phase(next_draws, states, iteration, da, inv_mass, p1 + p2, p3, target_accept, False)
    step_size = torch.exp(da.log_eps_bar)
    traj_len = iteration.freeze(step_size)
    # the reported acceptance covers the sampling phase only
    states = [_reset_counts(st) for st in states]
    p_chol, masses = shards.send(momentum_factor(inv_mass)), shards.send(inv_mass)
    samples = [torch.empty((num_samples,) + tuple(st.x.shape), dtype=dtype, device=st.x.device) for st in states]
    i = num_warmup
    for s in range(num_samples):
        for _ in range(thinning):
            states, _ = iteration.step(next_draws(), states, step_size, masses, p_chol, i, False)
            i += 1
        for buf, st in zip(samples, states):
            buf[s] = st.x
    states = HMCState(*(shards.gather(list(field)) for field in zip(*states)))
    return shards.gather([buf.transpose(0, 1) for buf in samples]), states, step_size, inv_mass, traj_len


def warmup_and_sample(
    generator: Optional[torch.Generator],
    x0: torch.Tensor,  # [C, d]
    log_density_fn: Callable,
    *,
    num_warmup: int,
    num_samples: int,
    num_leapfrog: int,
    thinning: int = 1,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    dense_mass: bool = False,
    draws: Optional[HMCDraws] = None,
    shards=None,
):
    """The whole run: three warmup phases of lengths p1, p2, p3 (step size
    alone with unit mass; the same while the moments accumulate; the mass
    set to the regularized moments and dual averaging restarted at the
    averaged step), then ``num_samples`` recorded states, each after
    ``thinning`` trajectories at the frozen step size and mass.

    ``draws`` (leading axis p1 + p2 + p3 + num_samples * thinning, in run
    order) replaces the generator's draws.  ``shards`` (a
    :class:`..core.shards.ShardAxis`; ``log_density_fn`` then one
    density per shard) runs each shard's block of the chains on its device,
    the acceptance mean and the moments merged across the shards as the
    JAX function's ``axis_name`` does.  Returns (samples [C, num_samples,
    d], final states, step size, inverse mass: the [d] variances or, with
    ``dense_mass``, the [d, d] covariance)."""
    x0 = x0.detach()
    shards, fns = _on_shards(shards, log_density_fn, x0.device)
    next_draws = _draw_source(generator, draws, x0.shape[0], x0.shape[1], x0.dtype, shards)
    out = _adapt_and_sample(next_draws, x0, _FixedLength(fns, num_leapfrog, shards), num_warmup=num_warmup,
                            num_samples=num_samples, thinning=thinning, target_accept=target_accept,
                            initial_step_size=initial_step_size, dense_mass=dense_mass)
    return out[:4]
