"""Bridge-sampling log evidence from posterior draws (port of
``bayesianinference_tpu.engines.bridge``).

Bridge sampling (Meng & Wong 1996; the optimal-bridge iteration of Gronau
et al. 2017) turns any batch of posterior draws (HMC chains, SMC
particles, a Pathfinder pool, resampled NS output) into a log-evidence
estimate with a relative-error diagnostic.  The draws map to the
unconstrained space of the box bijection, where a moment-matched Gaussian
proposal g is fitted on the even-indexed half; the odd half and as many
proposal draws enter the fixed point

    r = E_g[ q/(s1 q + s2 r g) ] / E_q[ g/(s1 q + s2 r g) ],

iterated with a median shift for overflow safety.  Both density sweeps are
batched calls of the problem's density (on a GP problem, both hand kernels
at B = the draw count, in chunks of ``vi.EVAL_CHUNK``); the proposal's
[d, d] factor is ``torch.linalg.cholesky_ex`` (NaN where the draws'
covariance is not positive definite, as in JAX).

The shift is the true median (the mean of the two middle values of an even
count, as ``jnp.median``; ``torch.median`` would take the lower one) and
the variances are the population ones (``jnp.var``'s ddof 0).  The random
numbers are inputs: ``indices`` (the resampling of non-uniform weights)
and ``proposal_normals`` replace the generator's.

Not ported, as XLA workarounds: the ``jax.jit`` program cache keyed on the
static arguments (``_bridge_program``) and the scalar ``lax.while_loop``
(a host loop of at most ``maxiter`` iterations here).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.containers import WeightedSamples
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from .vi import in_chunks, z_log_target

__all__ = ["BridgeResult", "bridge_sampling_evidence"]


@dataclasses.dataclass(frozen=True)
class BridgeResult:
    """Bridge-sampling evidence estimate."""

    log_evidence: torch.Tensor  # scalar logZ
    relative_error: torch.Tensor  # approximate relative MSE^(1/2) of Z
    num_iterations: int  # fixed-point iterations used
    converged: bool  # tolerance reached before maxiter
    num_posterior_draws: int = 0
    num_proposal_draws: int = 0

    @property
    def standard_error(self) -> torch.Tensor:
        """SE of logZ ~= relative error of Z (delta method)."""
        return self.relative_error


def _median(x: torch.Tensor) -> torch.Tensor:
    s, _ = torch.sort(x)
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) * 0.5


def _as_points(draws, generator, n_cap: int, indices) -> torch.Tensor:
    """Equal-weight [n, d] points from any draw container."""
    if isinstance(draws, WeightedSamples):
        lw = draws.log_weights
        if float(torch.max(lw) - torch.min(lw)) > 1e-9:  # non-uniform weights: resample to equal weight first
            if indices is None:
                indices = torch.multinomial(draws.normalized_weights(), min(draws.n, n_cap), replacement=True,
                                            generator=generator)
            return draws.points[torch.as_tensor(indices, device=draws.points.device)]
        return draws.points
    if hasattr(draws, "posterior_samples"):
        try:
            ws = draws.posterior_samples()
        except TypeError:  # PathfinderResult: its resampling takes the generator (or the indices)
            ws = draws.posterior_samples(generator, indices=indices)
            indices = None
        return _as_points(ws, generator, n_cap, indices)
    pts = torch.as_tensor(draws)
    if pts.dim() == 3:  # [chains, samples, d] HMC layout
        pts = pts.reshape(-1, pts.shape[-1])
    if pts.dim() != 2:
        raise ValueError(f"draws must be [n, d], got shape {tuple(pts.shape)}")
    return pts


def bridge_sampling_evidence(
    problem: InferenceProblem,
    draws,
    generator: Optional[torch.Generator] = None,
    *,
    num_proposal_draws: int = 0,
    maxiter: int = 200,
    tol: float = 0.0,
    indices: Optional[torch.Tensor] = None,
    proposal_normals: Optional[torch.Tensor] = None,
) -> BridgeResult:
    """Estimate log evidence by optimal bridge sampling.

    ``draws``: posterior draws for ``problem``: an [n, d] tensor, a
    [chains, samples, d] HMC stack, a ``WeightedSamples`` (non-uniform
    weights are resampled to equal weight), or a result with
    ``posterior_samples()`` (NS, SMC, HMC) or
    ``posterior_samples(generator)`` (Pathfinder).  Draws should be about
    independent: thin autocorrelated chains first, or read
    ``relative_error`` as optimistic.

    ``num_proposal_draws`` defaults to the number of posterior draws in the
    bridge; ``tol`` defaults to the dtype's sqrt-eps.  The estimate runs on
    the problem's device; ``generator`` None is one there seeded 0;
    ``indices`` fixes the resampling of weighted draws and
    ``proposal_normals`` [num_proposal_draws, d] the proposal's draws."""
    dev, dtype = problem.device, problem.dtype
    generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
    pts = _as_points(draws, generator, 100_000, indices)
    pts = torch.as_tensor(pts, dtype=dtype, device=dev)
    n = pts.shape[0]
    if n < 16:
        raise ValueError(f"need at least 16 draws, got {n}")
    bij = box_bijection(problem.lower, problem.upper)
    z = bij.to_z(pts)
    # an even/odd split decorrelates chain halves better than a contiguous
    # cut when the draws arrive in chain order
    z_fit, z_eval = z[0::2], z[1::2]
    n1 = z_eval.shape[0]
    n2 = int(num_proposal_draws) if num_proposal_draws else n1
    if tol <= 0:
        tol = math.sqrt(torch.finfo(dtype).eps)
    d = z.shape[-1]
    log_q = z_log_target(problem, bij)
    with torch.no_grad():
        # the moment-matched Gaussian proposal from the fit half
        mu = torch.mean(z_fit, dim=0)
        zc = z_fit - mu
        cov = (zc.T @ zc) / (z_fit.shape[0] - 1)
        cov = cov + 1e-8 * torch.trace(cov) / d * torch.eye(d, dtype=dtype, device=dev)
        chol, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where(info == 0, chol, math.nan)  # as XLA's factor of a matrix that is not positive definite
        half_logdet = torch.sum(torch.log(torch.diagonal(chol)))
        const = 0.5 * d * math.log(2.0 * math.pi)

        def log_g(zz):
            sol = torch.linalg.solve_triangular(chol, (zz - mu).T, upper=False)
            return -const - half_logdet - 0.5 * torch.sum(sol * sol, dim=0)

        if proposal_normals is None:
            proposal_normals = torch.randn((n2, d), generator=generator, dtype=dtype, device=dev)
        eps = torch.as_tensor(proposal_normals, dtype=dtype, device=dev)
        if tuple(eps.shape) != (n2, d):
            raise ValueError(f"proposal_normals must be [{n2}, {d}]")
        z_g = mu + eps @ chol.T
        l1 = in_chunks(log_q, z_eval) - log_g(z_eval)  # [N1]
        l2 = in_chunks(log_q, z_g) - log_g(z_g)  # [N2]
        s1, s2 = n1 / (n1 + n2), n2 / (n1 + n2)
        lstar = _median(l1)  # overflow shift (Gronau et al. 2017, appendix A)
        e1 = torch.exp(l1 - lstar)
        e2 = torch.exp(l2 - lstar)
        r = torch.ones((), dtype=dtype, device=dev)
        iters, delta = 0, math.inf
        while iters < maxiter and delta > tol:
            num = torch.mean(e2 / (s1 * e2 + s2 * r))
            den = torch.mean(1.0 / (s1 * e1 + s2 * r))
            r_new = num / den
            delta = float(torch.abs(r_new - r) / r_new)
            r, iters = r_new, iters + 1
        log_ml = torch.log(r) + lstar
        # approximate relative error (Gronau et al. 2017, eqs. 16-17, for
        # independent draws; thin MCMC output or the estimate is optimistic)
        f1 = e2 / (s1 * e2 + s2 * r)  # over proposal draws
        f2 = 1.0 / (s1 * e1 + s2 * r)  # over posterior draws
        re2 = (torch.var(f1, correction=0) / (torch.mean(f1) ** 2) / n2
               + torch.var(f2, correction=0) / (torch.mean(f2) ** 2) / n1)
    return BridgeResult(log_evidence=log_ml, relative_error=torch.sqrt(re2), num_iterations=iters,
                        converged=bool(delta <= tol), num_posterior_draws=int(n1), num_proposal_draws=n2)
