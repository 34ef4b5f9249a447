"""Random-direction slice sampling (port of ``bayesianinference_tpu.ops.slice``).

One update: a random direction shaped by the live-point covariance, a
bracket stepped out until both ends leave the slice, then shrinkage until
a point on the slice is found (Neal 2003).

The JAX package writes one chain and ``vmap``s it; here every function
works on a written-out leading chain axis: ``x`` is [C, d],
``log_density_fn`` maps [C, d] -> [C].  The random numbers of an update
are inputs (:class:`SliceDraws`, made by :func:`slice_draws`), so the port
and the JAX function can be held against each other on the same draws.

The step-out and shrink loops end per chain at a data-dependent pass.  In
the batch a pass is one density call for all chains under a per-chain
"still running" mask: a finished chain's probe is evaluated with the batch
and discarded, and ``evals`` counts only the probes a chain really made,
so the counter equals the JAX one.  The loops stop as soon as no chain
runs, at the cost of one host read of ``active.any()`` per pass.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import is_log_zero

__all__ = ["SliceState", "SliceDraws", "slice_init", "slice_draws", "slice_update", "run_slice_chain"]

class SliceState(NamedTuple):
    x: torch.Tensor  # [C, d]
    log_density: torch.Tensor  # [C]
    evals: torch.Tensor  # [C] int64: density evaluations so far
    moved: torch.Tensor  # [C] int64: successful slice moves


class SliceDraws(NamedTuple):
    """The random inputs of one update of C chains, or of ``num_updates``
    updates with that as the leading axis."""

    z: torch.Tensor  # [..., C, d] standard normal: the direction before shaping
    level: torch.Tensor  # [..., C] uniform on [1e-12, 1): the slice level is log_density + log(level)
    offset: torch.Tensor  # [..., C] uniform on [0, 1): where the unit bracket sits around 0
    shrink: torch.Tensor  # [..., C, max_shrink] uniform on [0, 1): pass i proposes lo + (hi - lo) * shrink[i]


def slice_init(x0: torch.Tensor, log_density_fn: Callable) -> SliceState:
    c = x0.shape[0]
    return SliceState(
        x=x0,
        log_density=log_density_fn(x0),
        evals=torch.ones((c,), dtype=torch.int64, device=x0.device),
        moved=torch.zeros((c,), dtype=torch.int64, device=x0.device),
    )


def slice_draws(
    generator: torch.Generator,
    chains: int,
    dim: int,
    *,
    num_updates: Optional[int] = None,
    max_shrink: int = 32,
    dtype: Optional[torch.dtype] = None,
) -> SliceDraws:
    """Draws for one update of ``chains`` chains (or ``num_updates`` of
    them, stacked in front) on the generator's device."""
    lead = () if num_updates is None else (num_updates,)
    kw = dict(generator=generator, dtype=dtype or torch.get_default_dtype(), device=generator.device)
    return SliceDraws(
        z=torch.randn(lead + (chains, dim), **kw),
        level=1e-12 + (1.0 - 1e-12) * torch.rand(lead + (chains,), **kw),
        offset=torch.rand(lead + (chains,), **kw),
        shrink=torch.rand(lead + (chains, max_shrink), **kw),
    )


def slice_update(
    state: SliceState,
    log_density_fn: Callable,
    direction_chol: torch.Tensor,  # [d, d] shared by the chains, or [C, d, d]
    draws: SliceDraws,
    *,
    width: float = 1.0,
    max_stepout: int = 8,
) -> SliceState:
    """One random-direction slice update of every chain.  ``max_shrink`` is
    the last size of ``draws.shrink``."""
    x, lp0 = state.x, state.log_density
    max_shrink = draws.shrink.shape[-1]

    # |direction| = width * |L z| / |z|
    z = draws.z
    shaped = (direction_chol @ z.unsqueeze(-1)).squeeze(-1)
    direction = width * shaped / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-30)
    logu = lp0 + torch.log(draws.level)

    def on_slice(t):
        lp = log_density_fn(x + t[:, None] * direction)
        return torch.logical_not(is_log_zero(lp)) & (lp >= logu), lp

    def stepout(bound, sign):
        active, _ = on_slice(bound)
        evals = torch.ones_like(state.evals)
        for _ in range(max_stepout):
            if not bool(active.any()):
                break
            bound = torch.where(active, bound + sign, bound)
            inside, _ = on_slice(bound)
            evals = evals + active
            active = active & inside
        return bound, evals

    lo, ev_lo = stepout(-draws.offset, -1.0)
    hi, ev_hi = stepout(1.0 - draws.offset, 1.0)

    x_new, lp_new = x, lp0
    found = torch.zeros_like(lp0, dtype=torch.bool)
    n_shrink = torch.zeros_like(state.evals)
    for i in range(max_shrink):
        active = torch.logical_not(found)
        if not bool(active.any()):
            break
        t = lo + (hi - lo) * draws.shrink[:, i]
        ok, lp = on_slice(t)
        # the bracket shrinks only for a running chain, only on the side of
        # t's sign, and only when the probe failed
        failed = active & torch.logical_not(ok)
        lo = torch.where(failed & (t < 0), t, lo)
        hi = torch.where(failed & (t >= 0), t, hi)
        hit = active & ok
        x_new = torch.where(hit[:, None], x + t[:, None] * direction, x_new)
        lp_new = torch.where(hit, lp, lp_new)
        n_shrink = n_shrink + active
        found = found | hit
    # a chain that used up max_shrink probes stays put: x_new is still x
    return SliceState(
        x=x_new,
        log_density=lp_new,
        evals=state.evals + ev_lo + ev_hi + n_shrink,
        moved=state.moved + found,
    )


def run_slice_chain(
    draws: SliceDraws,
    x0: torch.Tensor,
    log_density_fn: Callable,
    direction_chol: torch.Tensor,
    *,
    width: float = 1.0,
    max_stepout: int = 8,
) -> SliceState:
    """``draws.z.shape[0]`` successive slice updates of the chains started
    at ``x0`` [C, d]; ``draws`` carries a leading update axis."""
    state = slice_init(x0, log_density_fn)
    for s in range(draws.z.shape[0]):
        state = slice_update(state, log_density_fn, direction_chol, SliceDraws(*(a[s] for a in draws)),
                             width=width, max_stepout=max_stepout)
    return state
