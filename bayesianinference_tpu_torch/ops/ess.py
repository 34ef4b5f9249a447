"""Elliptical slice sampling for Gaussian-prior latent vectors (port of
``bayesianinference_tpu.ops.ess``).

Elliptical slice sampling (Murray, Adams & MacKay, AISTATS 2010) draws
asymptotically exact samples from any posterior of the form

    p(f | y)  propto  N(f; mean, K) * L(f)

with no step size and no acceptance test.  One update is one prior draw
``nu = L z`` and a shrinking bracket of rotations ``f cos(t) + nu sin(t)``
until the slice level is met.

The chains are an explicit axis: ``f`` is [C, n] and ``log_lik_fn`` maps
[C, n] to [C].  The shrink loop is a host loop over all chains: a chain
whose proposal met its level (or that hit ``max_shrink``) is frozen, and
the loop ends when none is left, with one host read per pass, so each
chain moves exactly as the JAX ``while_loop`` under ``vmap`` moves it.

The random numbers are inputs (:class:`ESSDraws`), so a run can replay
another's: per update and chain a standard normal [n] (the prior draw's
z), a uniform for the slice level, one for the first angle and
``max_shrink`` for the bracket.  The JAX package draws the level as
``uniform(1e-12, 1)`` and each angle as ``uniform(lo, hi)``, that is
``max(lo, u (hi - lo) + lo)`` of a [0, 1) uniform u; this module applies
the same formulas to its [0, 1) inputs.

If ``max_shrink`` is hit the state is kept: the kernel stays exactly
invariant, since f is on the slice by construction.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "ESSDraws",
    "EllipticalState",
    "ess_draws",
    "ess_init",
    "ess_update",
    "run_ess_chain",
    "ess_sample",
]


class EllipticalState(NamedTuple):
    f: torch.Tensor  # [C, n] current latent vectors
    log_lik: torch.Tensor  # [C] log L(f) (likelihood only, no prior)
    evals: torch.Tensor  # [C] int32 likelihood evaluations so far
    moved: torch.Tensor  # [C] int32 completed updates (always move)


class ESSDraws(NamedTuple):
    """The random inputs of C chains' updates, with any leading axes (one
    per update of a run)."""

    normal: torch.Tensor  # [..., C, n] standard normal: the prior draw is chol @ normal
    level: torch.Tensor  # [..., C] uniform on [0, 1): the slice level
    angle: torch.Tensor  # [..., C] uniform on [0, 1): the first angle, times 2 pi
    shrink: torch.Tensor  # [..., C, max_shrink] uniforms on [0, 1): the bracket's angles


def ess_draws(generator: torch.Generator, chains: int, n: int, *, num_updates: Optional[int] = None,
              max_shrink: int = 64, dtype: Optional[torch.dtype] = None) -> ESSDraws:
    """Draws for ``chains`` chains of dimension ``n`` (for ``num_updates``
    updates, as a leading axis, when given) from ``generator``."""
    lead = () if num_updates is None else (num_updates,)
    kw = dict(generator=generator, dtype=dtype or torch.get_default_dtype(), device=generator.device)
    return ESSDraws(
        normal=torch.randn(lead + (chains, n), **kw),
        level=torch.rand(lead + (chains,), **kw),
        angle=torch.rand(lead + (chains,), **kw),
        shrink=torch.rand(lead + (chains, max_shrink), **kw),
    )


def ess_init(f0, log_lik_fn: Callable) -> EllipticalState:
    """The state at ``f0`` [C, n]: its likelihood, one evaluation each."""
    f0 = torch.as_tensor(f0)
    c = f0.shape[0]
    ones = torch.ones((c,), dtype=torch.int32, device=f0.device)
    return EllipticalState(f=f0, log_lik=log_lik_fn(f0), evals=ones, moved=torch.zeros_like(ones))


def _uniform_between(u, lo, hi):
    """The JAX package's ``uniform(minval=lo, maxval=hi)`` of a [0, 1) draw u."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def ess_update(draws: ESSDraws, state: EllipticalState, log_lik_fn: Callable, chol_k: torch.Tensor, *,
               mean=None, max_shrink: int = 64) -> EllipticalState:
    """One elliptical slice move of every chain (Murray et al. 2010, fig. 2).

    ``log_lik_fn`` is the LIKELIHOOD alone, [C, n] -> [C]; the N(mean, K)
    prior is handled exactly by the ellipse.  ``chol_k`` [n, n] is the
    lower factor of the prior covariance, shared by the chains."""
    f = state.f
    dtype = f.dtype
    nu = draws.normal.to(dtype) @ chol_k.mT
    two_pi = 2.0 * math.pi
    logy = state.log_lik + torch.log(_uniform_between(draws.level.to(dtype), torch.full_like(state.log_lik, 1e-12),
                                                      torch.ones_like(state.log_lik)))
    theta = draws.angle.to(dtype) * two_pi
    lo, hi = theta - two_pi, theta
    f0 = f if mean is None else f - mean
    shrink = draws.shrink.to(dtype)

    def propose(t):
        fp = f0 * torch.cos(t)[:, None] + nu * torch.sin(t)[:, None]
        return fp if mean is None else fp + mean

    c = f.shape[0]
    n_try = torch.zeros((c,), dtype=torch.int32, device=f.device)
    accepted = torch.zeros((c,), dtype=torch.bool, device=f.device)
    lp_fin = state.log_lik
    while True:
        active = ~accepted & (n_try < max_shrink)
        if not bool(active.any()):
            break
        lp = log_lik_fn(propose(theta))
        ok = lp > logy
        # shrink the bracket toward 0 on rejection
        lo_next = torch.where(ok | (theta >= 0), lo, theta)
        hi_next = torch.where(ok | (theta < 0), hi, theta)
        u = shrink.gather(1, torch.clamp(n_try, max=shrink.shape[1] - 1).to(torch.int64)[:, None])[:, 0]
        theta_next = torch.where(ok, theta, _uniform_between(u, lo_next, hi_next))
        theta = torch.where(active, theta_next, theta)
        lo = torch.where(active, lo_next, lo)
        hi = torch.where(active, hi_next, hi)
        lp_fin = torch.where(active, lp, lp_fin)
        accepted = torch.where(active, ok, accepted)
        n_try = n_try + active.to(torch.int32)
    f_new = propose(theta)
    return EllipticalState(
        f=torch.where(accepted[:, None], f_new, f),
        log_lik=torch.where(accepted, lp_fin, state.log_lik),
        evals=state.evals + n_try,
        moved=state.moved + accepted.to(torch.int32),
    )


def _at(draws: ESSDraws, i: int) -> ESSDraws:
    return ESSDraws(*(t[i] for t in draws))


def run_ess_chain(draws: ESSDraws, f0, log_lik_fn: Callable, chol_k, num_steps: int, *, mean=None,
                  max_shrink: int = 64) -> EllipticalState:
    """``num_steps`` successive updates (``draws`` with a leading axis of
    at least ``num_steps``); returns the final state."""
    state = ess_init(f0, log_lik_fn)
    for i in range(num_steps):
        state = ess_update(_at(draws, i), state, log_lik_fn, chol_k, mean=mean, max_shrink=max_shrink)
    return state


def ess_sample(draws: ESSDraws, f0, log_lik_fn: Callable, chol_k, num_samples: int, *, mean=None,
               burn_in: int = 64, thin: int = 1, max_shrink: int = 64):
    """Burn in, then collect ``num_samples`` draws ``thin`` updates apart.

    ``draws`` has a leading axis of ``burn_in + num_samples * thin``
    updates, taken in that order.  Returns ``(draws [C, num_samples, n],
    final EllipticalState)``."""
    state = run_ess_chain(draws, f0, log_lik_fn, chol_k, burn_in, mean=mean, max_shrink=max_shrink)
    out = []
    for s in range(num_samples):
        for j in range(thin):
            state = ess_update(_at(draws, burn_in + s * thin + j), state, log_lik_fn, chol_k, mean=mean,
                               max_shrink=max_shrink)
        out.append(state.f)
    return torch.stack(out, dim=1), state
