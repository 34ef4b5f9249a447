"""Laplace-marginalized latent variables: collapsed likelihoods for any
engine (port of ``bayesianinference_tpu.models.marginalize``).

Hierarchical models carry latents z beside the parameters theta,
log p(y, z | theta) = log p(y | z, theta) + log p(z | theta).
:func:`marginalize_latents` collapses z with a nested Laplace
approximation (the INLA/TMB idea):

    log p(y | theta) ~= log p(y, z*(theta) | theta) + (m/2) log 2 pi
                        - (1/2) log det H(theta),
    z*(theta) = argmax_z log p(y, z | theta),
    H = -grad^2_z log p(y, z | theta) at z*,

exact when z is conditionally Gaussian given theta, and the standard
approximation for log-concave latent likelihoods.

Mechanics in the port:

* **An explicit batch.**  ``log_density`` takes theta [d] or [B, d].  The
  JAX package's inner Newton ascent is a ``lax.while_loop`` that batches
  under ``vmap``; here it is a host loop over the whole batch in which a
  lane that has converged (or failed to improve, or used its
  ``newton_steps``) is frozen while the others go on, one host read per
  step, as ``ops.gp_laplace._newton_loop`` does.  Each lane ends where the
  JAX function ends on that theta alone.  The loop runs without a graph,
  so ``log_density`` is meant for
  ``define_inference_problem(batched_likelihood=True)``, never for
  ``torch.func.vmap``.
* **Derivatives by re-attaching the optimum.**  After the loop,
  ``refine_steps`` plain Newton steps run from the detached z* with theta
  live: their value is z* again and their Jacobian the implicit-function
  sensitivity dz*/dtheta, so a gradient (1 step) or a Hessian over theta
  (2 steps) sees exact sensitivities without differentiating the loop.
* **The latent derivatives** are ``torch.func`` transforms of the
  per-point joint, mapped over the batch by ``torch.func.vmap``: the
  gradient by ``grad``, the latent Hessian by ``jacrev(jacrev)``, reverse
  over reverse, so that a joint density that reaches one of the port's
  custom ops (the SE covariance, the Cholesky) is differentiated through
  the ops' reverse rules (``torch.func.hessian`` is forward over reverse,
  and forward mode does not reach a custom op).
* **Factorizations.**  The latent Hessian [m, m] is not a GP covariance,
  and its factors are ``torch.linalg.cholesky_ex`` (NaN where it fails, as
  XLA's Cholesky), like the Laplace engine's precision matrix: the
  hand-written Cholesky kernel is the GP path's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..core.numerics import guard_log_density, log_zero
from .problem import _tree_map

__all__ = ["LaplaceMarginal", "marginalize_latents"]

_LADDER = (1.0, 0.5, 0.25, 0.1, 0.03)  # the damped Newton step's backtracking ladder


def _dtype_tol(dtype) -> float:
    # gradient infinity-norm stop at the dtype's autodiff noise floor
    return 1e-9 if dtype == torch.float64 else 1e-4


def _chol(h: torch.Tensor) -> torch.Tensor:
    """Lower factor of the symmetrized ``h`` (XLA's Cholesky symmetrizes
    its input), all NaN where the factorization fails."""
    factor, info = torch.linalg.cholesky_ex(0.5 * (h + h.mT))
    return torch.where((info == 0)[..., None, None], factor, torch.full_like(factor, math.nan))


@dataclasses.dataclass(frozen=True)
class LaplaceMarginal:
    """Collapsed-likelihood bundle returned by :func:`marginalize_latents`.

    ``log_density(theta[, data])`` takes theta [d] (a scalar back) or
    [B, d] ([B] back) and plugs into
    ``define_inference_problem(log_likelihood=..., batched_likelihood=True)``;
    ``latent_posterior(theta[, data])`` gives the conditional Laplace
    posterior q(z | y, theta) = N(z*, H^-1) as (z* [..., m], cov [..., m, m]).
    ``newton_loop_steps`` holds the host Newton steps of the last call and
    ``newton_iterations`` its per-lane counts."""

    log_density: Callable
    latent_posterior: Callable
    latent_dim: int
    last: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def newton_loop_steps(self) -> int:
        return self.last.get("steps", 0)

    @property
    def newton_iterations(self) -> Optional[torch.Tensor]:
        return self.last.get("iterations")


def marginalize_latents(
    joint_log_density: Callable,
    latent_dim: int,
    *,
    z_init=None,
    newton_steps: int = 50,
    tol: Optional[float] = None,
    refine_steps: int = 1,
    jitter: float = 0.0,
) -> LaplaceMarginal:
    """Collapse ``latent_dim`` latents out of a joint log density.

    ``joint_log_density``: ``(theta [d], z [m]) -> scalar`` or
    ``(theta, z, data) -> scalar``, log p(y, z | theta) in torch ops, twice
    differentiable in z.  ``z_init``: the Newton start, an [m] tensor, a
    callable theta [d] -> [m] (mapped over the batch by ``vmap``), or None
    (zeros).  ``newton_steps`` and ``tol`` (the gradient infinity-norm stop,
    1e-9 in float64 and 1e-4 in float32 by default) bound the inner solve.
    ``refine_steps`` differentiable Newton steps are re-attached after it:
    1 gives exact first derivatives in theta, 2 Hessians.  ``jitter`` is an
    extra ridge on the negated latent Hessian in the solves (not in the
    log determinant).  A failed solve or a Hessian that is not positive
    definite gives the finite log-zero sentinel, not NaN."""
    m = int(latent_dim)
    last: dict = {}

    def _bind(data):
        if data is None:
            return joint_log_density
        return lambda theta, z: joint_log_density(theta, z, data)

    def _grad_and_value(fn):
        return torch.func.vmap(torch.func.grad_and_value(fn, argnums=1))

    def _neg_hessian(fn):
        hess = torch.func.vmap(torch.func.jacrev(torch.func.jacrev(fn, argnums=1), argnums=1))
        return lambda theta, z: -hess(theta, z)

    def _z0(theta):
        if z_init is None:
            return torch.zeros((theta.shape[0], m), dtype=theta.dtype, device=theta.device)
        if callable(z_init):
            return torch.func.vmap(lambda t: torch.as_tensor(z_init(t), dtype=t.dtype, device=t.device))(theta)
        z0 = torch.as_tensor(z_init, dtype=theta.dtype, device=theta.device)
        return z0.expand(theta.shape[0], m).clone()

    def _newton_solve(fn, theta, z0):
        """Damped Newton ascent on every lane, without a graph: each step
        tries a ladder of step lengths at once and keeps the best."""
        dtype, dev = z0.dtype, z0.device
        bsz = z0.shape[0]
        eye = torch.eye(m, dtype=dtype, device=dev)
        tol_ = _dtype_tol(dtype) if tol is None else tol
        ladder = torch.tensor(_LADDER, dtype=dtype, device=dev)
        grad_and_value, neg_hessian, value = _grad_and_value(fn), _neg_hessian(fn), torch.func.vmap(fn)
        theta_ladder = theta.repeat_interleave(len(_LADDER), dim=0)
        z = z0
        done = torch.zeros((bsz,), dtype=torch.bool, device=dev)
        it = torch.zeros((bsz,), dtype=torch.int32, device=dev)
        loops = 0
        with torch.no_grad():
            while True:
                active = ~done & (it < newton_steps)
                if not bool(active.any()):
                    break
                loops += 1
                grad, val = grad_and_value(theta, z)
                h = neg_hessian(theta, z)
                ridge = jitter + 1e-6 * torch.abs(torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)) / m + 1e-12
                hl = _chol(h + ridge[:, None, None] * eye)
                step = torch.cholesky_solve(grad[..., None], hl)[..., 0]
                # a failed factorization (NaN step) falls back to gradient ascent
                step = torch.where(torch.isfinite(step).all(dim=-1, keepdim=True), step, grad)
                cands = z[:, None, :] + ladder[None, :, None] * step[:, None, :]  # [B, L, m]
                vals = value(theta_ladder, cands.reshape(-1, m)).reshape(bsz, len(_LADDER))
                vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, -math.inf))
                best = torch.argmax(vals, dim=-1)
                best_val = torch.gather(vals, 1, best[:, None])[:, 0]
                improved = best_val > val
                pick = torch.gather(cands, 1, best[:, None, None].expand(bsz, 1, m))[:, 0]
                z_next = torch.where(improved[:, None], pick, z)
                gnorm = torch.amax(torch.abs(grad), dim=-1)
                z = torch.where(active[:, None], z_next, z)
                done = torch.where(active, ~improved | (gnorm < tol_), done)
                it = it + active.to(torch.int32)
        last.update(steps=loops, iterations=it)
        return z

    def _refine(fn, theta, z):
        """Differentiable plain Newton steps from the detached optimum: value
        z*, Jacobian the implicit sensitivity dz*/dtheta."""
        grad_and_value, neg_hessian = _grad_and_value(fn), _neg_hessian(fn)
        eye = torch.eye(m, dtype=z.dtype, device=z.device)
        for _ in range(refine_steps):
            grad, _ = grad_and_value(theta, z)
            z = z + torch.cholesky_solve(grad[..., None], _chol(neg_hessian(theta, z) + jitter * eye))[..., 0]
        return z

    def _mode(theta, data):
        theta = torch.as_tensor(theta)
        theta = theta if theta.is_floating_point() else theta.to(torch.get_default_dtype())
        single = theta.dim() == 1
        theta = torch.atleast_2d(theta)
        frozen = _bind(None if data is None else _tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, data))
        z_hat = _newton_solve(frozen, theta.detach(), _z0(theta.detach()))
        live = _bind(data)
        return _refine(live, theta, z_hat.detach()), live, theta, single

    def log_density(theta, data=None):
        z_hat, fn, theta, single = _mode(theta, data)
        hl = _chol(_neg_hessian(fn)(theta, z_hat))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(hl, dim1=-2, dim2=-1)), dim=-1)
        val = torch.func.vmap(fn)(theta, z_hat) + 0.5 * m * math.log(2.0 * math.pi) - 0.5 * logdet
        out = guard_log_density(torch.where(torch.isfinite(logdet), val, torch.full_like(val, log_zero(val.dtype))))
        return out[0] if single else out

    def latent_posterior(theta, data=None) -> Tuple[torch.Tensor, torch.Tensor]:
        z_hat, fn, theta, single = _mode(theta, data)
        hl = _chol(_neg_hessian(fn)(theta, z_hat))
        cov = torch.cholesky_solve(torch.eye(m, dtype=z_hat.dtype, device=z_hat.device).expand_as(hl), hl)
        return (z_hat[0], cov[0]) if single else (z_hat, cov)

    return LaplaceMarginal(log_density=log_density, latent_posterior=latent_posterior, latent_dim=m, last=last)
