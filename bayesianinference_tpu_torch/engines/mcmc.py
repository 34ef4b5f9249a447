"""The public Markov-chain API (port of ``bayesianinference_tpu.engines.mcmc``):
build a chain on the unnormalized posterior density of an
:class:`InferenceProblem` (or on any per-point log-density) and iterate it
with thinning, collecting samples.

A starting point [d] makes one chain and ``iterate_mcmc`` returns samples
[num_samples, d]; starting points [C, d] make C chains run as one batch
and the samples are [num_samples, C, d].

The JAX package's two compiled-program caches are not ported: eager
PyTorch has nothing to retrace.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..core.device import as_float_on
from ..models.problem import InferenceProblem
from ..ops.metropolis import AMState, am_init, run_chain, welford_absorb_chol
from ..ops.slice import SliceState, slice_draws, slice_update

__all__ = ["MCMCChain", "create_mcmc_chain", "iterate_mcmc"]


@dataclasses.dataclass(frozen=True)
class MCMCChain:
    state: AMState  # of C chains (C = 1 for a single starting point)
    log_density: Callable  # batched: [C, d] -> [C]
    covariance_learn_delay: int = 20
    method: str = "adaptive_metropolis"
    problem: Optional[InferenceProblem] = None
    single: bool = True  # built from one starting point [d]

    @property
    def acceptance_rate(self) -> torch.Tensor:
        s = self.state
        rate = s.accepted / torch.clamp(s.proposed, min=1)
        return rate[0] if self.single else rate


def create_mcmc_chain(
    target: Union[InferenceProblem, Callable],
    starting_point,
    *,
    initial_covariance=1.0,
    covariance_learn_delay: int = 20,
    method: str = "adaptive_metropolis",
    device=None,
) -> MCMCChain:
    """Build a chain on ``target``: a problem (its guarded posterior
    density, on its device) or a per-point callable ``theta [d] -> scalar``.

    ``initial_covariance`` is a scalar, a [d] diagonal or a [d, d] matrix.
    ``method`` is ``"adaptive_metropolis"`` or ``"slice"``: random-direction
    slice updates whose directions follow the same running covariance.  For
    a callable target the chain lives where ``starting_point`` does: a
    tensor keeps its device, anything else goes to ``device`` (default: the
    card)."""
    if method not in ("adaptive_metropolis", "slice"):
        raise ValueError(f"unknown method {method!r}")
    if isinstance(target, InferenceProblem):
        problem = target
        log_density = target.log_posterior_density
        x0 = torch.as_tensor(starting_point, dtype=target.dtype, device=target.device)
    else:
        problem = None
        log_density = torch.func.vmap(target)
        x0 = as_float_on(starting_point, device)
    single = x0.dim() == 1
    x0 = x0[None] if single else x0
    d = x0.shape[-1]
    cov0 = torch.as_tensor(initial_covariance, dtype=x0.dtype, device=x0.device)
    if cov0.dim() == 0:
        cov0 = cov0 * torch.eye(d, dtype=x0.dtype, device=x0.device)
    elif cov0.dim() == 1:
        cov0 = torch.diag(cov0)
    return MCMCChain(
        state=am_init(x0, log_density, cov0=cov0, t0=0),
        log_density=log_density,
        covariance_learn_delay=covariance_learn_delay,
        method=method,
        problem=problem,
        single=single,
    )


def _slice_block(generator: torch.Generator, st: AMState, log_density: Callable, num: int,
                 learn_delay: int) -> AMState:
    """``num`` slice updates on an :class:`AMState`.  The block's direction
    factor is each chain's running-covariance factor (the identity before
    the learn delay), so nothing is factored; every visited point goes back
    into the running statistics by a rank-one update of the factor, and the
    next block's directions follow."""
    c, d = st.x.shape
    eye = torch.eye(d, dtype=st.x.dtype, device=st.x.device)
    usable = torch.isfinite(st.chol).all(dim=-1).all(dim=-1) & (st.step >= learn_delay)
    factor = torch.where(usable[:, None, None], st.chol, eye)
    zeros = torch.zeros_like(st.step)
    for _ in range(num):
        ss = slice_update(SliceState(st.x, st.log_density, zeros, zeros), log_density, factor,
                          slice_draws(generator, c, d, dtype=st.x.dtype))
        mean, chol, t = welford_absorb_chol(st.mean, st.chol, st.step, ss.x)
        st = AMState(x=ss.x, log_density=ss.log_density, mean=mean, chol=chol, step=t,
                     accepted=st.accepted + ss.moved, proposed=st.proposed + 1)
    return st


def iterate_mcmc(chain: MCMCChain, generator: torch.Generator, num_samples: int, thinning: int = 1):
    """Advance the chain ``num_samples * thinning`` steps and keep every
    ``thinning``-th state.  Returns (samples, the advanced chain)."""
    st = chain.state
    samples = []
    for _ in range(num_samples):
        if chain.method == "slice":
            st = _slice_block(generator, st, chain.log_density, thinning, chain.covariance_learn_delay)
        else:
            st = run_chain(generator, st, chain.log_density, thinning, chain.covariance_learn_delay)
        samples.append(st.x)
    samples = torch.stack(samples)
    return (samples[:, 0] if chain.single else samples), dataclasses.replace(chain, state=st)
