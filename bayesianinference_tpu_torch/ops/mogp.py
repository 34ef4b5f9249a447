"""Multi-output GP ops: intrinsic coregionalization (port of
``bayesianinference_tpu.ops.mogp``).

T correlated outputs share one input kernel k(x, x') through a
coregionalization matrix B [T, T] (Bonilla, Chai & Williams 2008):

    cov(y_t(x), y_s(x')) = B_ts k(x, x') + delta_ts delta_xx' sigma_t^2.

The joint covariance over the [n, T] grid is B (x) Kx in output-major
order, assembled by one outer product from Kx (one call of the SE op);
the logML and its gradient are the single-output GP's
(``gp_kernels.gp_log_marginal_likelihood``, its ``_LogML`` rule), so the
nT x nT factorization goes through the ``cholesky`` op.  Missing
observations are gather indices into the flat grid, fixed when the problem
is built.  ``mogp_log_marginal_kronecker`` takes the Saatci
eigendecomposition route for a full grid with scalar noise instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.numerics import as_float, log_zero
from .gp_kernels import Kernel, cholesky, gp_log_marginal_likelihood

__all__ = [
    "coregional_matrix",
    "mogp_covariance",
    "mogp_log_marginal_likelihood",
    "mogp_log_marginal_kronecker",
    "mogp_posterior_moments",
]


def coregional_matrix(a, d=None) -> torch.Tensor:
    """B = a a^T + diag(d): rank-r-plus-diagonal PSD coregionalization.
    ``a`` [T, r] (or [T] for rank 1), ``d`` [T] nonnegative (None: 0)."""
    a = as_float(a)
    if a.dim() == 1:
        a = a[:, None]
    b = a @ a.mT
    if d is not None:
        b = b + torch.diag_embed(torch.as_tensor(d, dtype=b.dtype, device=b.device))
    return b


def _pair(kx: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B (x) Kx as [T n, T m] in output-major order."""
    t, n, m = b.shape[0], kx.shape[0], kx.shape[1]
    return (b[:, None, :, None] * kx[None, :, None, :]).reshape(t * n, t * m)


def mogp_covariance(kernel: Kernel, b, x, noise_variances=None, jitter: float = 1e-6) -> torch.Tensor:
    """Joint covariance of the flat output-major grid
    [y_1(x_1..n), ..., y_T(x_1..n)]:  B (x) Kx + diag(noise (x) 1_n)."""
    x = as_float(x)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    t = b.shape[0]
    kx = kernel.matrix(x, x)
    n = kx.shape[0]
    cov = _pair(kx, b)
    diag = torch.full((t, n), jitter, dtype=cov.dtype, device=cov.device)
    if noise_variances is not None:
        diag = diag + torch.as_tensor(noise_variances, dtype=cov.dtype, device=cov.device)[:, None]
    return cov + torch.diag_embed(diag.reshape(-1))


def mogp_log_marginal_likelihood(kernel: Kernel, b, x, y_flat, noise_variances=None,
                                 observed_idx: Optional[torch.Tensor] = None, jitter: float = 1e-6) -> torch.Tensor:
    """logML of the coregionalized GP.  ``y_flat`` is output-major [T n]
    (or [k] values where ``observed_idx`` [k] selects the observed subset of
    the flat grid); the single-output GP's logML and closed-form gradient."""
    cov = mogp_covariance(kernel, b, x, noise_variances, jitter)
    y_flat = torch.as_tensor(y_flat, dtype=cov.dtype, device=cov.device)
    if observed_idx is not None:
        idx = torch.as_tensor(observed_idx, device=cov.device, dtype=torch.int64)
        cov = cov[idx][:, idx]
    return gp_log_marginal_likelihood(cov, y_flat)


def mogp_log_marginal_kronecker(kernel: Kernel, b, x, y, noise_variance, jitter: float = 1e-6) -> torch.Tensor:
    """logML by the Kronecker structure (Saatci 2011 ch. 5): with a FULL
    observation grid and SCALAR iid noise,

        B (x) Kx + s2 I = (U_B (x) U_K) diag(lamB (x) lamK + s2) (.)^T,

    two small eigendecompositions replace the [nT, nT] Cholesky.  ``y`` is
    [n, T].  Gradients flow through ``torch.linalg.eigh`` (exact for
    distinct eigenvalues)."""
    x = as_float(x)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    n, t = y.shape
    kx = kernel.matrix(x, x)
    eye_n = torch.eye(n, dtype=kx.dtype, device=kx.device)
    kx = 0.5 * (kx + kx.mT) + jitter * eye_n
    b = 0.5 * (b + b.mT)
    # torch's eigh raises on a non-finite matrix where JAX's returns NaN:
    # factor the identity there and give the sentinel
    finite = torch.isfinite(kx).all() & torch.isfinite(b).all()
    lam_b, u_b = torch.linalg.eigh(torch.where(finite, b, torch.eye(t, dtype=b.dtype, device=b.device)))
    lam_k, u_k = torch.linalg.eigh(torch.where(finite, kx, eye_n))
    s2 = torch.as_tensor(noise_variance, dtype=x.dtype, device=x.device)
    lam = lam_b[:, None] * lam_k[None, :] + s2  # eigenvalues of the joint [T, n]
    ok = (lam > 0).all() & finite
    lam_safe = torch.where(ok, lam, torch.ones_like(lam))
    y_rot = u_b.mT @ y.mT @ u_k  # [T, n]
    quad = (y_rot**2 / lam_safe).sum()
    logdet = torch.log(lam_safe).sum()
    out = -0.5 * (n * t * math.log(2.0 * math.pi) + logdet + quad)
    lz = log_zero(out.dtype)
    return torch.where(ok, torch.clamp(out, lz, -lz), torch.full_like(out, lz))


def mogp_posterior_moments(kernel: Kernel, b, x, y_flat, x_query, noise_variances=None,
                           observed_idx: Optional[torch.Tensor] = None, jitter: float = 1e-6):
    """Predictive moments for EVERY output at the query points: (mean
    [m, T], std [m, T]) of the latent (noise-free) outputs; the cross
    covariances with the observed set are B (x) k(X, X*)."""
    x = as_float(x)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    t = b.shape[0]
    x_query = torch.as_tensor(x_query, dtype=x.dtype, device=x.device)
    m = x_query.shape[0]
    cov = mogp_covariance(kernel, b, x, noise_variances, jitter)
    cross = _pair(kernel.matrix(x, x_query), b)  # [T n, T m]
    if observed_idx is not None:
        idx = torch.as_tensor(observed_idx, device=cov.device, dtype=torch.int64)
        cov = cov[idx][:, idx]
        cross = cross[idx]
    kq_diag = kernel.diag(x_query)  # [m]
    prior_var = torch.repeat_interleave(torch.diagonal(b), m) * kq_diag.repeat(t)  # [T m]
    ell = cholesky(cov)
    alpha = torch.cholesky_solve(torch.as_tensor(y_flat, dtype=cov.dtype, device=cov.device)[:, None], ell)[:, 0]
    mean = cross.mT @ alpha  # [T m]
    v = torch.linalg.solve_triangular(ell, cross, upper=False)
    var = torch.clamp(prior_var - (v * v).sum(dim=0), min=0.0)
    return mean.reshape(t, m).mT, torch.sqrt(var).reshape(t, m).mT
