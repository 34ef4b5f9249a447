"""Affine-invariant ensemble moves, stretch and differential evolution
(port of ``bayesianinference_tpu.ops.ensemble``).

* **stretch** (Goodman & Weare 2010): walker k takes a partner x_j from
  the other half, draws z ~ g(z) ~ 1/sqrt(z) on [1/a, a], proposes
  y = x_j + z (x_k - x_j) and accepts with probability
  min(1, z^(d-1) exp(logp(y) - logp(x_k)));
* **de** (ter Braak 2006): y = x_k + gamma (x_r1 - x_r2) + eps, with
  gamma = 2.38 / sqrt(2d) or, with probability ``gamma_jump_prob``, 1, and
  a plain Metropolis test.

The ensemble [W, d] splits into two fixed halves updated in turn: the
first against the second, then the second against the updated first (the
schedule that keeps the ensemble distribution invariant).  Each half is
one batched proposal and one density call over [W/2, d].  The random
numbers of a half are inputs (:class:`StretchDraws`, :class:`DEDraws`),
as for the other chains; a NaN log-acceptance compares false and rejects.
:func:`shard_sweep` is the sweep with each half's rows split over the
shards of a mesh axis, each shard moving its part against the gathered
complementary half; :func:`ensemble_sweep` is its one-shard case.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core.shards import ShardAxis

__all__ = ["EnsembleState", "StretchDraws", "DEDraws", "ensemble_init", "ensemble_draws", "ensemble_sweep",
           "shard_sweep"]


class EnsembleState(NamedTuple):
    """Walker positions, their log densities and per-walker counts."""

    x: torch.Tensor  # [W, d]
    log_density: torch.Tensor  # [W]
    accepted: torch.Tensor  # [W] int64
    proposed: torch.Tensor  # [W] int64


class StretchDraws(NamedTuple):
    """The random inputs of one stretch half-update of m walkers."""

    partner: torch.Tensor  # [m] int64 in [0, m2): the complement walker
    z_u: torch.Tensor  # [m] uniform on [0, 1): the stretch factor by inverse CDF
    accept: torch.Tensor  # [m] uniform on [0, 1)


class DEDraws(NamedTuple):
    """The random inputs of one differential-evolution half-update."""

    r1: torch.Tensor  # [m] int64 in [0, m2)
    r2_offset: torch.Tensor  # [m] int64 in [0, m2 - 1): r2 = (r1 + 1 + offset) mod m2, never r1
    jump: torch.Tensor  # [m] uniform on [0, 1): gamma = 1 below gamma_jump_prob
    noise: torch.Tensor  # [m, d] standard normal: the jitter direction
    accept: torch.Tensor  # [m] uniform on [0, 1)


HalfDraws = Union[StretchDraws, DEDraws]


def ensemble_init(x0: torch.Tensor, log_density_batch: Callable) -> EnsembleState:
    """State from [W, d] starting walkers (W even and at least 4: the sweep
    updates two fixed halves)."""
    w = x0.shape[0]
    if w % 2 != 0 or w < 4:
        raise ValueError(f"need an even number of walkers >= 4, got {w}")
    zero = torch.zeros((w,), dtype=torch.int64, device=x0.device)
    return EnsembleState(x=x0, log_density=log_density_batch(x0), accepted=zero, proposed=zero)


def _half_draws(generator: torch.Generator, m: int, m2: int, d: int, move: str, dtype) -> HalfDraws:
    kw = dict(generator=generator, device=generator.device)
    fl = dict(kw, dtype=dtype)
    if move == "stretch":
        return StretchDraws(partner=torch.randint(0, m2, (m,), **kw), z_u=torch.rand((m,), **fl),
                            accept=torch.rand((m,), **fl))
    return DEDraws(r1=torch.randint(0, m2, (m,), **kw), r2_offset=torch.randint(0, m2 - 1, (m,), **kw),
                   jump=torch.rand((m,), **fl), noise=torch.randn((m, d), **fl), accept=torch.rand((m,), **fl))


def ensemble_draws(generator: torch.Generator, walkers: int, dim: int, *, move: str = "stretch",
                   dtype: Optional[torch.dtype] = None) -> Tuple[HalfDraws, HalfDraws]:
    """The draws of one sweep: one set per half."""
    h = walkers // 2
    dtype = dtype or torch.get_default_dtype()
    return (_half_draws(generator, h, walkers - h, dim, move, dtype),
            _half_draws(generator, walkers - h, h, dim, move, dtype))


def _metropolis(log_acc, draws, y, lp_y, x_act, lp_act):
    # a NaN log_acc (a degenerate proposal) compares false: a rejection
    accept = torch.log(draws.accept) < log_acc
    return torch.where(accept[:, None], y, x_act), torch.where(accept, lp_y, lp_act), accept


def _stretch_half(draws: StretchDraws, x_act, lp_act, x_comp, log_density_batch, a):
    """One stretch update of the active half against the complement."""
    d = x_act.shape[-1]
    xj = x_comp[draws.partner]
    # z = ((a-1)u + 1)^2 / a draws from g(z) ~ 1/sqrt(z) by inverse CDF
    z = torch.square((a - 1.0) * draws.z_u + 1.0) / a
    y = xj + z[:, None] * (x_act - xj)
    lp_y = log_density_batch(y)
    return _metropolis((d - 1) * torch.log(z) + lp_y - lp_act, draws, y, lp_y, x_act, lp_act)


def _de_half(draws: DEDraws, x_act, lp_act, x_comp, log_density_batch, gamma_jump_prob):
    """One differential-evolution update of the active half: the difference
    of two distinct complement walkers."""
    d = x_act.shape[-1]
    m2 = x_comp.shape[0]
    r2 = torch.remainder(draws.r1 + 1 + draws.r2_offset, m2)
    diff = x_comp[draws.r1] - x_comp[r2]
    gamma0 = 2.38 / math.sqrt(2.0 * d)
    gamma = torch.where(draws.jump < gamma_jump_prob, torch.ones_like(draws.jump),
                        torch.full_like(draws.jump, gamma0))
    # a small isotropic jitter breaks the lattice of differences; it scales
    # with the ensemble's spread, so it stays affine-benign
    spread = torch.sqrt(x_comp.var(dim=0, correction=0).mean() + 1e-30)
    y = x_act + gamma[:, None] * diff + 1e-4 * spread * draws.noise
    lp_y = log_density_batch(y)
    return _metropolis(lp_y - lp_act, draws, y, lp_y, x_act, lp_act)


def _update_half(shards, half, draws, active, complement, log_density_fns, knob) -> list:
    """Each shard's part of the active half (its state in ``active``) moved
    against the whole complementary half: the shards' parts of it gathered
    on the home device (the tiled ``all_gather``) and sent to each."""
    whole = shards.send(shards.gather([st.x for st in complement]))
    out = []
    for dr, st, x_comp, fn in zip(draws, active, whole, log_density_fns):
        x, lp, acc = half(dr, st.x, st.log_density, x_comp, fn, knob)
        out.append(EnsembleState(x=x, log_density=lp, accepted=st.accepted + acc, proposed=st.proposed + 1))
    return out


def shard_sweep(shards, draws, halves, log_density_fns, *, move: str = "stretch", a: float = 2.0,
                gamma_jump_prob: float = 0.1):
    """One sweep of an ensemble whose halves are split over the shards of
    ``shards`` (:class:`..core.shards.ShardAxis`): ``halves`` is
    (the shards' states of their rows of the first half, the same of the
    second), ``draws`` the two halves' draws as per-shard lists (each
    shard's rows), ``log_density_fns`` one density per shard.  Each shard
    updates its part of the first half against the whole second half, then
    its part of the second against the whole updated first: the JAX
    function's two gathers a sweep.  Returns the new ``halves``."""
    half = _stretch_half if move == "stretch" else _de_half
    knob = a if move == "stretch" else gamma_jump_prob
    first = _update_half(shards, half, draws[0], halves[0], halves[1], log_density_fns, knob)
    return first, _update_half(shards, half, draws[1], halves[1], first, log_density_fns, knob)


def ensemble_sweep(draws: Tuple[HalfDraws, HalfDraws], state: EnsembleState, log_density_batch: Callable, *,
                   move: str = "stretch", a: float = 2.0, gamma_jump_prob: float = 0.1) -> EnsembleState:
    """One sweep: the first half against the second, then the second
    against the UPDATED first (:func:`shard_sweep` on one shard)."""
    h = state.x.shape[0] // 2
    halves = ([EnsembleState(*(f[:h] for f in state))], [EnsembleState(*(f[h:] for f in state))])
    (first,), (second,) = shard_sweep(ShardAxis.one(state.x.device), ([draws[0]], [draws[1]]), halves,
                                      [log_density_batch], move=move, a=a, gamma_jump_prob=gamma_jump_prob)
    return EnsembleState(*(torch.cat(pair) for pair in zip(first, second)))
