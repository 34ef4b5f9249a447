"""Constrained Hamiltonian Monte Carlo for nested-sampling replacements
(port of ``bayesianinference_tpu.ops.chmc``; Betancourt 2010, Skilling's
Galilean Monte Carlo).

The chains sample the prior restricted to ``logL(x) > threshold`` by
Hamiltonian trajectories whose momentum reflects off the likelihood
iso-contour and off the box faces.  The construction is the JAX package's,
step for step:

* momenta live in whitened u-space (``v = L u`` with the mass factor
  ``L = chol``, shared by the chains or one per chain): the kinetic energy
  is ``|u|^2 / 2``, the prior kick is
  ``u += (eps / 2) L^T grad logprior``, and a reflection off a normal ``n``
  is the Householder ``u -= 2 (w.u / |w|^2) w`` with ``w = L^T n``;
* a violating primary move is retried within the same step by the
  specularly reflected move THROUGH the outside point
  (``x2 = x1 + eps L u_ref``); if that violates too, the momentum is fully
  reversed and the chain stays.  Both proposals are evaluated every step;
* each trajectory ends in a Metropolis test on the Hamiltonian error.

Chains are a written-out leading axis: ``x`` is [C, d] and the densities
map [C, d] -> [C].  Value and gradient of the per-chain likelihood and
prior come from autograd on the batched call: the rows are independent, so
the gradient of the sum over chains is each chain's own gradient, and one
backward pass runs every reverse rule (for a GP likelihood: the covariance
and Cholesky kernels' rules) once at batch size C.  The carried state is
detached at every step, so no graph outlives the step that built it.  The
random numbers are inputs (:class:`CHMCDraws`), as for the other chains.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import is_log_zero

__all__ = ["CHMCState", "CHMCDraws", "chmc_draws", "run_chmc_chain"]


class CHMCState(NamedTuple):
    """Chain output: final points and acceptance bookkeeping."""

    x: torch.Tensor  # [C, d]
    logl: torch.Tensor  # [C] logL(x)
    logp: torch.Tensor  # [C] logprior(x)
    accepted: torch.Tensor  # [C] int64: accepted trajectories
    evals: torch.Tensor  # [C] int64: likelihood(+gradient) evaluations


class CHMCDraws(NamedTuple):
    momenta: torch.Tensor  # [T, C, d] standard normal, one per trajectory
    accept: torch.Tensor  # [T, C] uniform on [1e-38, 1)


def chmc_draws(generator: torch.Generator, num_trajectories: int, chains: int, dim: int,
               dtype: Optional[torch.dtype] = None) -> CHMCDraws:
    kw = dict(generator=generator, dtype=dtype or torch.get_default_dtype(), device=generator.device)
    return CHMCDraws(
        momenta=torch.randn((num_trajectories, chains, dim), **kw),
        accept=1e-38 + (1.0 - 1e-38) * torch.rand((num_trajectories, chains), **kw),
    )


def _value_and_grad(fn: Callable, x: torch.Tensor):
    """(fn(x) [C], its per-chain gradient [C, d]), both detached.  A value
    that does not depend on ``x`` has gradient zero."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        value = fn(xg)
        if not value.requires_grad:
            return value.detach(), torch.zeros_like(x)
        (grad,) = torch.autograd.grad(value.sum(), xg)
    return value.detach(), grad


def _safe_grad(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def run_chmc_chain(
    draws: CHMCDraws,
    x0: torch.Tensor,  # [C, d]; every row must satisfy the constraint
    log_likelihood: Callable,
    log_prior: Callable,
    threshold,
    chol: torch.Tensor,  # [d, d] lower Cholesky factor of the mass matrix, or [C, d, d] one per chain
    lower: torch.Tensor,
    upper: torch.Tensor,
    num_leapfrog: int,
    step_size: float,
    in_support: Optional[Callable] = None,
) -> CHMCState:
    """``draws.momenta.shape[0]`` trajectories of ``num_leapfrog`` steps for
    every chain, each trajectory with fresh momenta.  A shared [d, d]
    factor is taken as one copy per chain, so that a [C, d, d] factor of
    equal rows gives the same chains bit for bit."""
    num_trajectories = draws.momenta.shape[0]
    eps = float(step_size)
    x0 = x0.detach()
    chol = chol.expand(x0.shape[0], *chol.shape[-2:]).contiguous()

    def times_l(v):
        """Rows v_c L_c."""
        return torch.bmm(v.unsqueeze(1), chol).squeeze(1)

    def times_lt(v):
        """Rows v_c L_c^T."""
        return torch.bmm(v.unsqueeze(1), chol.mT).squeeze(1)

    def constraint_normal(x_prop, g_like):
        """Inward normal at a violating proposal: grad logL for likelihood
        violations; for out-of-box proposals the combined inward normal of
        the violated faces, which dominates when present."""
        box_n = torch.where(x_prop < lower, 1.0, torch.where(x_prop > upper, -1.0, 0.0)).to(x_prop.dtype)
        out_of_box = (box_n != 0).any(dim=-1, keepdim=True)
        return torch.where(out_of_box, box_n, _safe_grad(g_like))

    def valid(x_prop, logl_p, logp_p):
        ok = (logl_p > threshold) & torch.logical_not(is_log_zero(logp_p))
        ok = ok & (x_prop >= lower).all(dim=-1) & (x_prop <= upper).all(dim=-1)
        if in_support is not None:  # constraints beyond the box
            ok = ok & in_support(x_prop)
        return ok

    def reflect(u, n):
        """Householder on the whitened momentum; a degenerate normal falls
        back to full reversal."""
        w = times_l(n)  # rows L^T n
        w2 = (w * w).sum(dim=-1, keepdim=True)
        wu = (w * u).sum(dim=-1, keepdim=True)
        return torch.where(w2 > 1e-30, u - (2.0 * wu / torch.where(w2 > 0, w2, torch.ones_like(w2))) * w, -u)

    def pick(ok1, use2, a1, a2, a0):
        if a1.dim() > ok1.dim():
            ok1, use2 = ok1[:, None], use2[:, None]
        return torch.where(ok1, a1, torch.where(use2, a2, a0))

    def leapfrog(x, u, logl_x, logp_x, gp_x):
        u_half = u + (0.5 * eps) * times_l(_safe_grad(gp_x))
        x1 = x + eps * times_lt(u_half)
        logl_1, gl_1 = _value_and_grad(log_likelihood, x1)
        logp_1, gp_1 = _value_and_grad(log_prior, x1)
        ok1 = valid(x1, logl_1, logp_1)
        # Galilean retry: reflect at the violating point and go on from it
        u_ref = reflect(u_half, constraint_normal(x1, gl_1))
        x2 = x1 + eps * times_lt(u_ref)
        with torch.no_grad():  # the retry's likelihood gradient is never used
            logl_2 = log_likelihood(x2)
        logp_2, gp_2 = _value_and_grad(log_prior, x2)
        ok2 = valid(x2, logl_2, logp_2)

        not1 = torch.logical_not(ok1)
        use2 = not1 & ok2
        stuck = not1 & torch.logical_not(ok2)
        x_n = pick(ok1, use2, x1, x2, x)
        u_move = torch.where(ok1[:, None], u_half, u_ref)
        logl_n = pick(ok1, use2, logl_1, logl_2, logl_x)
        logp_n = pick(ok1, use2, logp_1, logp_2, logp_x)
        gp_n = pick(ok1, use2, gp_1, gp_2, gp_x)
        # second half-kick at the landing point; a double failure reverses
        u_n = torch.where(stuck[:, None], -u, u_move + (0.5 * eps) * times_l(_safe_grad(gp_n)))
        return x_n, u_n, logl_n, logp_n, gp_n

    x = x0
    with torch.no_grad():
        logl = log_likelihood(x0)
    logp, gp = _value_and_grad(log_prior, x0)
    gp = _safe_grad(gp)
    n_acc = torch.zeros((x0.shape[0],), dtype=torch.int64, device=x0.device)
    for t in range(num_trajectories):
        u0 = draws.momenta[t]
        h0 = -logp + 0.5 * (u0 * u0).sum(dim=-1)
        x_e, u_e, logl_e, logp_e, gp_e = x, u0, logl, logp, gp
        for _ in range(num_leapfrog):
            x_e, u_e, logl_e, logp_e, gp_e = leapfrog(x_e, u_e, logl_e, logp_e, gp_e)
        h1 = -logp_e + 0.5 * (u_e * u_e).sum(dim=-1)
        accept = torch.log(draws.accept[t]) < h0 - h1
        x = torch.where(accept[:, None], x_e, x)
        logl = torch.where(accept, logl_e, logl)
        logp = torch.where(accept, logp_e, logp)
        gp = torch.where(accept[:, None], gp_e, gp)
        n_acc = n_acc + accept
    return CHMCState(
        x=x,
        logl=logl,
        logp=logp,
        accepted=n_acc,
        evals=torch.full_like(n_acc, 2 * num_trajectories * num_leapfrog),
    )
