"""Adaptive-Metropolis chains (port of ``bayesianinference_tpu.ops.metropolis``:
the block-adaptive path the nested-sampling loop runs, and the per-step
``am_step`` with its rank-one Welford update).

The JAX package writes one chain and ``vmap``s it; here every function
works on a written-out leading chain axis: ``x`` is [C, d], the factor is
[C, d, d], and ``log_density_fn`` maps [C, d] -> [C].  ``lax.scan`` over
steps becomes a Python loop of batched tensor ops.

Within a block the proposal covariance is frozen: all step vectors come
from one batched product ``scale * L @ Z``; each step runs accept/reject
and absorbs the visited state into the running mean and a scaled-delta
buffer; at block end the factor is rebuilt once from
``M = [sqrt(T0/Tj) L | D / sqrt(Tj)]`` as ``chol(M M^T + jitter I)``.

The JAX package's unrolled small-matrix helpers (``_small_matvecs``,
``_small_syrk``, the unrolled Crout Cholesky) work around XLA-on-TPU
limits and are not ported: batched ``matmul`` and
``torch.linalg.cholesky_ex`` take their place.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import is_log_zero

__all__ = [
    "AMState",
    "small_cholesky",
    "proposal_chol",
    "am_init",
    "am_draws",
    "am_block",
    "chol_rank1_update",
    "welford_absorb",
    "welford_absorb_chol",
    "am_step_draws",
    "am_step",
    "run_chain",
    "run_chain_adaptive",
]

# Haario et al. (2001) optimal scaling and regularization
_SCALING = 2.38**2
_JITTER = 1e-10
_JITTER_STD = 1e-5  # sqrt(_JITTER): standard deviation of am_step's jitter floor


class AMState(NamedTuple):
    """Adaptive-Metropolis state of C chains.  The running covariance is
    carried as its lower Cholesky factor ``chol``."""

    x: torch.Tensor  # [C, d] current points
    log_density: torch.Tensor  # [C]
    mean: torch.Tensor  # [C, d] running means
    chol: torch.Tensor  # [C, d, d] factors of the running covariances
    step: torch.Tensor  # [C] int64: points absorbed
    accepted: torch.Tensor  # [C] int64: accepted moves since init
    proposed: torch.Tensor  # [C] int64: proposals since init

    @property
    def cov(self) -> torch.Tensor:
        """Dense running covariances [C, d, d], rebuilt from the factors."""
        return self.chol @ self.chol.mT


def small_cholesky(a: torch.Tensor, *, symmetrize_input: bool = True) -> torch.Tensor:
    """Batched lower Cholesky factor whose failed (non-PD) elements are NaN,
    the contract of ``jnp.linalg.cholesky``.

    ``symmetrize_input=True`` factors ``(a + a^T) / 2``, as
    ``lax.linalg.cholesky`` does; pass False only when ``a`` is symmetric
    by construction."""
    if symmetrize_input:
        a = 0.5 * (a + a.mT)
    factor, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], factor, torch.full_like(factor, math.nan))


def proposal_chol(cov0: torch.Tensor) -> torch.Tensor:
    """Jittered factor of a carried-over covariance, with a per-matrix
    diagonal fallback for non-PD inputs (degenerate live sets)."""
    d = cov0.shape[-1]
    eye = torch.eye(d, dtype=cov0.dtype, device=cov0.device)
    factor = small_cholesky(cov0 + _JITTER * eye)
    diag = torch.diagonal(cov0, dim1=-2, dim2=-1)
    fallback = torch.sqrt(torch.abs(diag) + _JITTER)[..., None] * eye
    ok = torch.isfinite(factor).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    return torch.where(ok, factor, fallback)


def am_init(
    x0: torch.Tensor,
    log_density_fn: Callable,
    mean0=None,
    cov0=None,
    t0: int = 10,
    chol0=None,
) -> AMState:
    """Seed C chains at ``x0`` [C, d] with an optional carried-over
    (mean, cov), as if ``t0`` points were already absorbed.  ``cov0`` is
    factored here (jittered); pass ``chol0`` to share one factorization."""
    c, d = x0.shape
    mean0 = x0 if mean0 is None else torch.broadcast_to(mean0, (c, d))
    if chol0 is None:
        if cov0 is None:
            cov0 = torch.eye(d, dtype=x0.dtype, device=x0.device)
        chol0 = proposal_chol(0.5 * (cov0 + cov0.mT))
    count = lambda v: torch.full((c,), v, dtype=torch.int64, device=x0.device)  # noqa: E731
    return AMState(
        x=x0,
        log_density=log_density_fn(x0),
        mean=mean0.clone(),
        chol=torch.broadcast_to(chol0, (c, d, d)).clone(),
        step=count(t0),
        accepted=count(0),
        proposed=count(0),
    )


def am_draws(generator: torch.Generator, state: AMState, num_steps: int):
    """The random inputs of one :func:`am_block`: standard-normal step
    directions ``z`` [C, d, j] and log-uniform acceptance draws
    ``log_u`` [C, j] (uniform on [1e-38, 1), as the JAX package draws)."""
    c, d = state.x.shape
    kw = dict(generator=generator, dtype=state.x.dtype, device=state.x.device)
    z = torch.randn((c, d, num_steps), **kw)
    u = torch.rand((c, num_steps), **kw)
    return z, torch.log(1e-38 + (1.0 - 1e-38) * u)


def am_block(
    state: AMState,
    log_density_fn: Callable,
    z: torch.Tensor,
    log_u: torch.Tensor,
    learn_delay: int = 20,
) -> AMState:
    """``j = z.shape[-1]`` Metropolis steps of every chain with the proposal
    covariance frozen for the block and one factor rebuild at its end.
    ``z`` [C, d, j] and ``log_u`` [C, j] are the block's random draws."""
    x = state.x
    c, d = x.shape
    j = z.shape[-1]
    dtype = x.dtype
    scale = math.sqrt(_SCALING / d)
    s_learn = scale * (state.chol @ z)  # [C, d, j]
    s_base = scale * z
    lp, mean, accepted, t = state.log_density, state.mean, state.accepted, state.step
    deltas = torch.empty((c, d, j), dtype=dtype, device=x.device)
    for s in range(j):
        learn = (t >= learn_delay)[:, None]
        x_new = x + torch.where(learn, s_learn[..., s], s_base[..., s])
        lp_new = log_density_fn(x_new)
        accept = torch.logical_not(is_log_zero(lp_new)) & (log_u[:, s] < lp_new - lp)
        x = torch.where(accept[:, None], x_new, x)
        lp = torch.where(accept, lp_new, lp)
        t = t + 1
        tf = t.to(dtype)
        delta = x - mean
        mean = mean + delta / tf[:, None]
        deltas[..., s] = delta * torch.sqrt((tf - 1.0) / tf)[:, None]
        accepted = accepted + accept
    t0f = state.step.to(dtype)
    tjf = t.to(dtype)
    m = torch.cat(
        [
            torch.sqrt(t0f / tjf)[:, None, None] * state.chol,
            deltas / torch.sqrt(tjf)[:, None, None],
        ],
        dim=-1,
    )
    cov = m @ m.mT + _JITTER * torch.eye(d, dtype=dtype, device=x.device)
    chol_new = small_cholesky(cov, symmetrize_input=False)  # syrk: symmetric
    ok = torch.isfinite(chol_new).all(dim=-1).all(dim=-1)
    return AMState(
        x=x,
        log_density=lp,
        mean=mean,
        chol=torch.where(ok[:, None, None], chol_new, state.chol),
        step=t,
        accepted=accepted,
        proposed=state.proposed + j,
    )


def chol_rank1_update(chol: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The lower factor of ``A + v v^T`` from the lower factor ``chol`` of
    ``A`` ([..., d, d] and [..., d]): a LINPACK ``dchud``-style sweep of d
    Givens stages, each a few [..., d] vector operations, O(d^2) in all.
    An update (plus sign) keeps the factor positive definite."""
    d = chol.shape[-1]
    idx = torch.arange(d, device=chol.device)
    x = v
    out = []
    for k in range(d):
        col = chol[..., :, k]
        lkk = col[..., k]
        xk = x[..., k]
        r = torch.sqrt(lkk * lkk + xk * xk)
        c = (r / lkk)[..., None]
        s = (xk / lkk)[..., None]
        below = idx > k
        newcol = torch.where(below, (col + s * x) / c, torch.zeros_like(col))
        newcol = torch.where(idx == k, r[..., None], newcol)
        x = torch.where(below, c * x - s * newcol, x)
        out.append(newcol)
    return torch.stack(out, dim=-1)


def welford_absorb(mean, cov, step, x):
    """Absorb one point per chain into dense running statistics
    (mean [..., d], cov [..., d, d], step [...]).  Returns
    (mean, cov, step + 1)."""
    t = step + 1
    tf = t.to(x.dtype)[..., None]
    delta = x - mean
    mean = mean + delta / tf
    delta2 = x - mean
    cov = cov * ((tf - 1.0) / tf)[..., None] + delta[..., :, None] * delta2[..., None, :] / tf[..., None]
    return mean, 0.5 * (cov + cov.mT), t


def welford_absorb_chol(mean, chol, step, x):
    """Absorb one point per chain into the running mean and the factor of
    the running covariance: the Welford recursion
    ``cov <- ((t-1)/t) cov + ((t-1)/t^2) dd^T`` with ``d = x - mean_old`` is
    a scaling and a rank-one update of the factor.  Returns
    (mean, chol, step + 1)."""
    t = step + 1
    tf = t.to(x.dtype)[..., None]
    delta = x - mean
    mean = mean + delta / tf
    a = (tf - 1.0) / tf
    b = torch.sqrt(tf - 1.0) / tf
    # a == 0 only at t == 1, where the candidate is dropped below; the floor
    # keeps the rotations free of 0/0
    cand = chol_rank1_update(torch.sqrt(torch.clamp(a, min=0.25))[..., None] * chol, b * delta)
    ok = (t > 1) & torch.isfinite(cand).all(dim=-1).all(dim=-1)
    return mean, torch.where(ok[..., None, None], cand, chol), t


def am_step_draws(generator: torch.Generator, state: AMState):
    """The random inputs of one :func:`am_step`: proposal directions
    ``z`` [C, d], jitter-floor directions ``z2`` [C, d] and log-uniform
    acceptance draws ``log_u`` [C]."""
    kw = dict(generator=generator, dtype=state.x.dtype, device=state.x.device)
    z, z2 = torch.randn(state.x.shape, **kw), torch.randn(state.x.shape, **kw)
    u = torch.rand(state.x.shape[:1], **kw)
    return z, z2, torch.log(1e-38 + (1.0 - 1e-38) * u)


def am_step(state: AMState, log_density_fn: Callable, z, z2, log_u, learn_delay: int = 20) -> AMState:
    """One Metropolis step of every chain with a per-step Welford update of
    the mean and the factor.  The proposal is
    ``x + sqrt(s) L z + sqrt(jitter) z2`` with ``s = 2.38^2 / d``: proposal
    covariance ``s cov + jitter I`` with no factorization of the jittered
    matrix."""
    x, lp = state.x, state.log_density
    d = x.shape[-1]
    learn = (state.step >= learn_delay)[:, None]
    shaped = (state.chol @ z[..., None])[..., 0]
    x_new = x + math.sqrt(_SCALING / d) * torch.where(learn, shaped, z) + _JITTER_STD * z2
    lp_new = log_density_fn(x_new)
    accept = torch.logical_not(is_log_zero(lp_new)) & (log_u < lp_new - lp)
    x = torch.where(accept[:, None], x_new, x)
    mean, chol, t = welford_absorb_chol(state.mean, state.chol, state.step, x)
    return AMState(
        x=x,
        log_density=torch.where(accept, lp_new, lp),
        mean=mean,
        chol=chol,
        step=t,
        accepted=state.accepted + accept,
        proposed=state.proposed + 1,
    )


def run_chain(
    generator: torch.Generator,
    state: AMState,
    log_density_fn: Callable,
    num_steps: int,
    learn_delay: int = 20,
    block_size: Optional[int] = None,
) -> AMState:
    """``num_steps`` adaptive-Metropolis steps: one :func:`am_block` by
    default, or blocks of ``block_size`` steps with a factor rebuild after
    each."""
    j = num_steps if block_size is None else max(1, min(block_size, num_steps))
    done = 0
    while done < num_steps:
        n = min(j, num_steps - done)
        z, log_u = am_draws(generator, state, n)
        state = am_block(state, log_density_fn, z, log_u, learn_delay)
        done += n
    return state


def _acc_rate(accepted, proposed, dtype) -> torch.Tensor:
    return accepted.to(dtype) / torch.clamp(proposed.to(dtype), min=1.0)


def run_chain_adaptive(
    generator: torch.Generator,
    state: AMState,
    log_density_fn: Callable,
    num_steps: int,
    extra_steps: int,
    max_steps: int,
    min_acceptance: float = 0.0,
    max_acceptance: float = 1.0,
    learn_delay: int = 20,
):
    """Run the chains, then keep running blocks of ``extra_steps`` for every
    chain whose acceptance rate over its most recent block lies outside
    ``[min_acceptance, max_acceptance]``, until ``max_steps`` proposals.

    The JAX package's per-chain ``while_loop`` becomes a loop over the
    whole batch with a per-chain "still running" mask: a finished chain's
    state is frozen (its proposals are still evaluated with the batch and
    discarded).  Deciding whether any chain still runs costs one host read
    per extra block; with the default (0, 1) bounds the loop never runs.

    Returns ``(state, acceptance_rate)`` with the cumulative rate [C]."""
    dtype = state.x.dtype
    state = run_chain(generator, state, log_density_fn, num_steps, learn_delay)
    trivial_bounds = min_acceptance <= 0.0 and max_acceptance >= 1.0
    if extra_steps <= 0 or max_steps <= num_steps or trivial_bounds:
        return state, _acc_rate(state.accepted, state.proposed, dtype)
    prev_acc = torch.zeros_like(state.accepted)
    prev_prop = torch.zeros_like(state.proposed)
    while True:
        r = _acc_rate(state.accepted - prev_acc, state.proposed - prev_prop, dtype)
        running = ((r < min_acceptance) | (r > max_acceptance)) & (state.proposed < max_steps)
        if not bool(running.any()):
            break
        prev_acc = torch.where(running, state.accepted, prev_acc)
        prev_prop = torch.where(running, state.proposed, prev_prop)
        new = run_chain(generator, state, log_density_fn, extra_steps, learn_delay)
        state = AMState(
            *(
                torch.where(running.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(new, state)
            )
        )
    return state, _acc_rate(state.accepted, state.proposed, dtype)
