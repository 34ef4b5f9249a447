"""Student-t process regression: marginal likelihood and predictive law
(port of ``bayesianinference_tpu.ops.t_process``).

A Student-t process (Shah, Wilson & Ghahramani 2014) replaces the GP's
Gaussian marginal with a multivariate Student-t,

    y ~ MVT(nu, m(X), K),
    log p = lgamma((nu+n)/2) - lgamma(nu/2) - (n/2) log(nu pi)
            - log|K|/2 - ((nu+n)/2) log(1 + beta/nu),
    beta = (y-m)^T K^-1 (y-m),

heavy-tailed, with nu -> inf recovering the GP.  One Cholesky per
evaluation (the ``cholesky`` op: the hand-written kernel on the card) and
the JAX package's closed-form gradient as a
:class:`torch.autograd.Function`:

    dlogp/dK  = c alpha alpha^T - K^-1/2,   c = (nu+n)/(2(nu+beta)),
    dlogp/dy  = -2c alpha,                  alpha = K^-1 (y-m),
    dlogp/dnu = [psi((nu+n)/2) - psi(nu/2)]/2 - n/(2 nu)
                - log1p(beta/nu)/2 + (nu+n) beta / (2 nu (nu+beta)).

Like ``gp_kernels._LogML`` it takes the factor from the op as an input, so
its backward (differentiable ops on the factor) has a second derivative.
A failed factorization or nu <= 0 gives the finite log-zero sentinel and a
zero gradient.

The predictive is the exact MVT conditional,

    y* | y ~ MVT(nu + n,  k*^T K^-1 y,  s (kappa - k*^T K^-1 k*)),
    s = (nu + beta) / (nu + n).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.numerics import as_float, log_zero
from .gp_kernels import Kernel, _inv_from_chol, _nugget_vector, cholesky, covariance_matrix

__all__ = [
    "tp_log_marginal_likelihood",
    "tp_posterior_moments",
]

_LOGPI = 1.1447298858494002


def _solve_lower(factor, y):
    return torch.linalg.solve_triangular(factor, y.unsqueeze(-1), upper=False).squeeze(-1)


class _TPLogML(torch.autograd.Function):
    """The TP logML from a factor taken with the ``cholesky`` op.

    Inputs (k, y, nu, factor, ok): ``factor`` is the failure-masked factor
    of ``k`` and ``ok`` marks where it factored and nu > 0.  The backward is
    the closed form of the module docstring for (k, y, nu), zero where
    ``ok`` is false, and nothing for ``factor``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(k, y, nu, factor, ok):
        n = y.shape[-1]
        nu_s = torch.where(nu > 0, nu, torch.ones_like(nu))
        w = _solve_lower(factor, y)
        beta = (w * w).sum(dim=-1)
        logdet = 2.0 * torch.log(torch.diagonal(factor, dim1=-2, dim2=-1)).sum(dim=-1)
        out = (torch.lgamma(0.5 * (nu_s + n)) - torch.lgamma(0.5 * nu_s) - 0.5 * n * (torch.log(nu_s) + _LOGPI)
               - 0.5 * logdet - 0.5 * (nu_s + n) * torch.log1p(beta / nu_s))
        lz = log_zero(out.dtype)
        return torch.where(ok, torch.clamp(out, lz, -lz), torch.full_like(out, lz))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, y, nu, factor, ok = inputs
        ctx.save_for_backward(y, nu, factor, ok)

    @staticmethod
    def backward(ctx, g):
        y, nu, factor, ok = ctx.saved_tensors
        n = y.shape[-1]
        nu = torch.where(nu > 0, nu, torch.ones_like(nu))
        w = _solve_lower(factor, y)
        beta = (w * w).sum(dim=-1)
        alpha = torch.linalg.solve_triangular(factor.mT, w.unsqueeze(-1), upper=True).squeeze(-1)  # K^-1 y
        c = 0.5 * (nu + n) / (nu + beta)
        dk = c[..., None, None] * alpha.unsqueeze(-1) * alpha.unsqueeze(-2) - 0.5 * _inv_from_chol(factor)
        dy = -2.0 * c[..., None] * alpha
        dnu = (0.5 * (torch.digamma(0.5 * (nu + n)) - torch.digamma(0.5 * nu)) - 0.5 * n / nu
               - 0.5 * torch.log1p(beta / nu) + 0.5 * (nu + n) * beta / (nu * (nu + beta)))
        dk = torch.where(ok[..., None, None], dk, 0.0)
        dy = torch.where(ok[..., None], dy, 0.0)
        dnu = torch.where(ok, dnu, 0.0)
        return g[..., None, None] * dk, g[..., None] * dy, g * dnu, None, None


def tp_log_marginal_likelihood(k_matrix: torch.Tensor, y, nu, mean=None) -> torch.Tensor:
    """Student-t-process log marginal likelihood (Shah et al. 2014 eq. 6)
    through one factorization by the ``cholesky`` op, with the closed-form
    gradient in (K, y, nu).  Non-PD K or nu <= 0 gives the finite log-zero
    sentinel.  Batched over leading dims of ``k_matrix`` [..., n, n]."""
    y = as_float(y)
    if mean is not None:
        y = y - mean
    n = y.shape[-1]
    nu = torch.as_tensor(nu, dtype=y.dtype, device=y.device)
    factor = cholesky(k_matrix)
    ok = torch.isfinite(torch.diagonal(factor, dim1=-2, dim2=-1)).all(dim=-1) & (nu > 0)
    eye = torch.eye(n, dtype=factor.dtype, device=factor.device)
    safe = torch.where(ok[..., None, None], factor, eye)
    batch = safe.shape[:-2]
    return _TPLogML.apply(k_matrix, y.expand(*batch, n), nu.expand(batch), safe, ok)


def tp_posterior_moments(
    kernel: Kernel,
    x_train,
    y_train,
    x_query,
    nu,
    nugget=None,
    mean_fn: Optional[Callable] = None,
    query_nugget: bool = True,
):
    """Exact MVT conditional at query points (Shah et al. 2014 eq. 7):

        m*     = m(x*) + k*^T K^-1 (y - m(X))
        scale* = sqrt( (nu + beta)/(nu + n) * (kappa - k*^T K^-1 k*) )
        df*    = nu + n

    Returns (mean [m], scale [m], df scalar)."""
    x_train, y_train, x_query = as_float(x_train), as_float(y_train), as_float(x_query)
    nu = torch.as_tensor(nu, dtype=y_train.dtype, device=y_train.device)
    n = y_train.shape[0]
    k_train = covariance_matrix(kernel, x_train, nugget, symmetrize=not kernel.exactly_symmetric)
    k_cross = kernel.matrix(x_train, x_query)  # [n, m]
    kappa = kernel.diag(x_query)
    if query_nugget and nugget is not None:
        kappa = kappa + _nugget_vector(nugget, x_query)
    mean_train = mean_fn(x_train) if mean_fn is not None else 0.0
    mean_query = mean_fn(x_query) if mean_fn is not None else 0.0
    factor = cholesky(k_train)
    w = _solve_lower(factor, y_train - mean_train)
    beta = (w * w).sum()
    alpha = torch.linalg.solve_triangular(factor.mT, w.unsqueeze(-1), upper=True).squeeze(-1)
    mean_star = mean_query + k_cross.mT @ alpha
    v = torch.linalg.solve_triangular(factor, k_cross, upper=False)  # [n, m]
    var_star = torch.clamp(kappa - (v * v).sum(dim=0), min=0.0)
    scale_star = torch.sqrt((nu + beta) / (nu + n) * var_star)
    return mean_star, scale_star, nu + n

