"""ChEES-HMC: the trajectory length learned by gradient ascent (port of
``bayesianinference_tpu.ops.chees``; Hoffman, Radul & Sountsov 2021).

One trajectory length T, shared by the chains, adapts by Adam on log T
along the ChEES criterion's per-chain gradient estimate
``delta * <x' - m', v'> * t``, weighted by acceptance probability.  Each
iteration draws one jitter fraction h from the base-2 van der Corput
sequence, shared by the chains: the trajectory runs ``t = h T`` for
``n = ceil(t / eps)`` steps, clipped to [1, max_leapfrog].

The chains are a leading [C, d] axis as in :mod:`.hmc`, or split over
the shards of a mesh axis (``shards=``): the chain means, the weighted
gradient's sums and the acceptance then come from all shards.  Because n is one
number for all chains, it is read to the host once per trajectory and the
leapfrog loop runs exactly n steps: no chain runs masked steps to a
worst-case length.  Step size, mass, warmup phases, divergence and the
sentinel are :mod:`.hmc`'s.  The momenta and acceptance uniforms are
inputs (:class:`ChEESDraws`), as for the fixed-length kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.optim import adam_init, adam_step
from .hmc import (
    _accept_prob,
    _adapt_and_sample,
    _apply_inv_mass,
    _draw_source,
    _kinetic,
    _on_shards,
    _sample_momentum,
    _select,
    leapfrog,
)

__all__ = ["ChEESDraws", "chees_draws", "chees_warmup_and_sample", "halton_base2"]

_HALTON_BITS = 16


def halton_base2(i: int) -> float:
    """Van der Corput base-2 radical inverse of ``i``: its low 16 bits
    reversed across the binary point (exact in float32, as the JAX
    function computes it)."""
    return sum(((i >> b) & 1) * 2.0 ** -(b + 1) for b in range(_HALTON_BITS))


class ChEESDraws(NamedTuple):
    """The random inputs of one ChEES iteration of C chains (or of T, with
    that as the leading axis)."""

    momentum: torch.Tensor  # [..., C, d] standard normal
    accept: torch.Tensor  # [..., C] uniform on [0, 1)


def chees_draws(generator: torch.Generator, chains: int, dim: int, *, num_trajectories: Optional[int] = None,
                dtype: Optional[torch.dtype] = None) -> ChEESDraws:
    lead = () if num_trajectories is None else (num_trajectories,)
    kw = dict(generator=generator, dtype=dtype or torch.get_default_dtype(), device=generator.device)
    return ChEESDraws(momentum=torch.randn(lead + (chains, dim), **kw), accept=torch.rand(lead + (chains,), **kw))


def _chees_iteration(shards, draws, states, log_density_fns, step_size, inv_mass, p_chol, traj_time,
                     max_leapfrog: int, adapt: bool = True):
    """One iteration of every chain on every shard of ``shards`` (the
    shards' draws, states, densities, inverse masses and momentum factors
    as lists; the step size and ``traj_time`` on the home device): a
    trajectory of the shared length ``traj_time``, a Metropolis test per
    chain, and with ``adapt`` the ChEES log-T gradient from the chain means,
    weighted sum and weight of all shards (the JAX function's ``pmean`` and
    ``psum``s).  Returns (the shards' states, mean acceptance probability,
    gradient or None)."""
    # a NaN length takes one step, as XLA's float-to-int conversion (NaN -> 0) and the clip give
    num_steps = torch.clamp(torch.nan_to_num(torch.ceil(traj_time / step_size), nan=0.0), 1, max_leapfrog)
    num_steps = int(num_steps)  # the trajectory's one host read: its step count
    out, ends, probs = [], [], []
    for dr, st, fn, eps, m, pc in zip(draws, states, log_density_fns, shards.send(step_size), inv_mass, p_chol):
        p0 = _sample_momentum(dr.momentum, pc)
        x_new, p_new, lp_new, g_new = leapfrog(st.x, p0, st.grad, fn, eps, m, num_steps)
        prob, divergent = _accept_prob(-st.log_density + _kinetic(p0, m), -lp_new + _kinetic(p_new, m), lp_new)
        out.append(_select(dr.accept < prob, st, x_new, lp_new, g_new, divergent))
        ends.append((x_new, p_new))
        probs.append(prob)
    ap_mean = shards.mean([prob.mean() for prob in probs])
    if not adapt:
        return out, ap_mean, None

    # the ChEES log-T gradient (the paper's dChEES/dT, times t by the chain rule)
    m_cur = shards.send(shards.mean([st.x.mean(dim=0) for st in states]))
    m_new = shards.send(shards.mean([x_new.mean(dim=0) for x_new, _ in ends]))
    sums, weights = [], []
    for st, (x_new, p_new), prob, m, mc, mn, t in zip(states, ends, probs, inv_mass, m_cur, m_new,
                                                      shards.send(traj_time)):
        c_new = x_new - mn
        delta = (c_new * c_new).sum(dim=-1) - ((st.x - mc) ** 2).sum(dim=-1)
        v_new = _apply_inv_mass(m, p_new)  # end velocity M^-1 p'
        per_chain = delta * (c_new * v_new).sum(dim=-1) * t
        sums.append((prob * per_chain).sum())
        weights.append(prob.sum())
    chees_grad = shards.sum(sums) / torch.clamp(shards.sum(weights), min=1e-6)
    # the scale is normalized out, which keeps one learning rate for every target
    chees_grad = chees_grad / (torch.abs(chees_grad) + 1e-12)
    return out, ap_mean, chees_grad


class _LearnedLength:
    """The iteration of :func:`chees_warmup_and_sample` for
    :func:`.hmc._adapt_and_sample`: during warmup the trajectory length T
    adapts by Adam on log T, capped at ``max_leapfrog`` steps of the
    current step size; :meth:`freeze` fixes it to the Polyak average.  Each
    iteration ``i`` runs ``halton_base2(i + 1) * T``.  T lives on the home
    device of ``shards``, one for all of them."""

    def __init__(self, log_density_fns: list, shards, max_leapfrog: int, initial_length: torch.Tensor):
        self.log_density_fns = log_density_fns
        self.shards = shards
        self.max_leapfrog = max_leapfrog
        self.log_t = torch.log(initial_length)
        self.log_t_avg = self.log_t  # Polyak t^-0.75 average: the frozen value
        self.adam = adam_init({"log_t": self.log_t})
        self.length = None

    def step(self, draws, states, eps, inv_mass, p_chol, i: int, adapt: bool):
        big_t = torch.minimum(torch.exp(self.log_t), self.max_leapfrog * eps) if adapt else self.length
        states, ap_mean, grad = _chees_iteration(self.shards, draws, states, self.log_density_fns, eps, inv_mass,
                                                 p_chol, halton_base2(i + 1) * big_t, self.max_leapfrog, adapt)
        if adapt:  # Adam ascent on log T: a descent step on -grad
            params, self.adam = adam_step({"log_t": self.log_t}, {"log_t": -grad}, self.adam, 0.025)
            self.log_t = params["log_t"]
            eta = self.adam.count ** (-0.75)  # the decay family of dual averaging's kappa
            self.log_t_avg = eta * self.log_t + (1.0 - eta) * self.log_t_avg
        return states, ap_mean

    def freeze(self, step_size):
        self.length = torch.minimum(torch.exp(self.log_t_avg), self.max_leapfrog * step_size)
        return self.length


def chees_warmup_and_sample(
    generator: Optional[torch.Generator],
    x0: torch.Tensor,  # [C, d]
    log_density_fn: Callable,
    *,
    num_warmup: int,
    num_samples: int,
    max_leapfrog: int = 256,
    thinning: int = 1,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    initial_trajectory_length: float = 1.0,
    dense_mass: bool = False,
    draws: Optional[ChEESDraws] = None,
    shards=None,
):
    """:func:`.hmc.warmup_and_sample` with the trajectory length learned:
    the same three warmup phases, log T adapting throughout and frozen to
    its Polyak average (capped at ``max_leapfrog`` steps); sampling jitters
    each iteration's length by the van der Corput sequence, continued from
    where warmup left it.  ``shards`` as for :func:`.hmc.warmup_and_sample`:
    the chain means, the weighted gradient and the acceptance then come
    from all shards, so they learn one length.

    Returns (samples [C, num_samples, d], final states, step size, inverse
    mass, trajectory length)."""
    x0 = x0.detach()
    shards, fns = _on_shards(shards, log_density_fn, x0.device)
    next_draws = _draw_source(generator, draws, x0.shape[0], x0.shape[1], x0.dtype, shards, make=chees_draws)
    t0 = torch.full((), initial_trajectory_length, dtype=x0.dtype, device=x0.device)
    return _adapt_and_sample(next_draws, x0, _LearnedLength(fns, shards, max_leapfrog, t0), num_warmup=num_warmup,
                             num_samples=num_samples, thinning=thinning, target_accept=target_accept,
                             initial_step_size=initial_step_size, dense_mass=dense_mass)
