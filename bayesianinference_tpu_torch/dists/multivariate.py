"""Multivariate Gaussian and Student-t families (port of the Gaussian part
of ``bayesianinference_tpu.dists.multivariate``): ``MultivariateNormal``,
``MultivariateNormalPrecision``, ``MultivariateT`` and ``mvgammaln``.

All use Cholesky factors and triangular solves, never explicit inverses.
Every factor goes through the ``cholesky`` op (the hand-written kernel on
the card) on the symmetrized matrix; a non-PD matrix gives a NaN factor,
so the density falls to the log-zero sentinel.
"""

from __future__ import annotations

import math

import torch

from ..core.numerics import LOG2PI, as_float, guard_log_density, log_precise
from ..ops import gp_kernels  # a module reference: gp_kernels imports this package
from .base import Distribution, dist_dataclass

__all__ = [
    "MultivariateNormal",
    "MultivariateNormalPrecision",
    "MultivariateT",
    "mvgammaln",
]


def mvgammaln(a, d: int) -> torch.Tensor:
    """Log multivariate gamma log Gamma_d(a)."""
    a = as_float(a)
    j = torch.arange(1, d + 1, dtype=a.dtype, device=a.device)
    return 0.25 * d * (d - 1) * math.log(math.pi) + torch.sum(torch.lgamma(a[..., None] + 0.5 * (1.0 - j)), dim=-1)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    return gp_kernels.cholesky(0.5 * (a + a.mT))


def _chol_logdet(factor: torch.Tensor) -> torch.Tensor:
    """log|A| from its lower factor."""
    return 2.0 * torch.sum(log_precise(torch.diagonal(factor, dim1=-2, dim2=-1)), dim=-1)


def _solve_tri(factor: torch.Tensor, b: torch.Tensor, trans: int = 0) -> torch.Tensor:
    """Solve L z = b (``trans=0``) or L^T z = b (``trans=1``) for
    L [..., d, d] and b [..., d, k], broadcasting the batch dims."""
    batch = torch.broadcast_shapes(factor.shape[:-2], b.shape[:-2])
    lb = factor.expand(*batch, *factor.shape[-2:])
    bb = b.expand(*batch, *b.shape[-2:])
    if trans:
        return torch.linalg.solve_triangular(lb.mT, bb, upper=True)
    return torch.linalg.solve_triangular(lb, bb, upper=False)


def _whiten(factor: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Solve L z = dx for batched dx [..., d]."""
    return _solve_tri(factor, dx[..., None])[..., 0]


def _param_batch(shape, *specs) -> torch.Size:
    """Draw shape: broadcast of ``shape`` and the parameters' batch shapes;
    ``specs`` are (parameter, number of event dims) pairs."""
    shapes = [tuple(shape)]
    for a, k in specs:
        sh = tuple(torch.as_tensor(a).shape)
        shapes.append(sh[: len(sh) - k] if k else sh)
    return torch.broadcast_shapes(*shapes)


def _standard_gamma(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``alpha``'s shape (Marsaglia and Tsang,
    with the alpha < 1 boost), from ``generator``."""
    dev, dt = generator.device, alpha.dtype
    boost = alpha < 1
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a.shape, generator=generator, dtype=dt, device=dev)
        u = torch.rand(a.shape, generator=generator, dtype=dt, device=dev)
        v = (1.0 + c * z) ** 3
        safe_v = torch.where(v > 0, v, torch.ones_like(v))
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * safe_v + d * torch.log(safe_v))
        take = todo & ok
        out = torch.where(take, d * safe_v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=generator, dtype=dt, device=dev)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


@dist_dataclass
class MultivariateNormal(Distribution):
    """MVN parameterized by mean and covariance."""

    mean_: torch.Tensor  # [d]
    cov: torch.Tensor  # [d, d]

    @property
    def event_shape(self):
        return (self.mean_.shape[-1],)

    def _chol(self):
        return _cholesky(as_float(self.cov))

    def log_prob(self, x):
        x = as_float(x)
        d = x.shape[-1]
        factor = self._chol()
        z = _whiten(factor, x - as_float(self.mean_))
        return guard_log_density(-0.5 * (torch.sum(z * z, dim=-1) + d * LOG2PI + _chol_logdet(factor)))

    def sample(self, generator, shape=()):
        factor = self._chol()
        full = _param_batch(shape, (self.mean_, 1), (self.cov, 2))
        z = torch.randn((*full, self.event_shape[0]), generator=generator, dtype=factor.dtype,
                        device=generator.device)
        return as_float(self.mean_) + torch.einsum("...ij,...j->...i", factor, z)

    def mean(self):
        return as_float(self.mean_)

    def variance(self):
        return torch.diagonal(as_float(self.cov), dim1=-2, dim2=-1)

    def covariance(self):
        return as_float(self.cov)


@dist_dataclass
class MultivariateNormalPrecision(Distribution):
    """MVN parameterized by mean and precision matrix: the natural output
    of a Laplace approximation."""

    mean_: torch.Tensor  # [d]
    precision: torch.Tensor  # [d, d]

    @property
    def event_shape(self):
        return (self.mean_.shape[-1],)

    def log_prob(self, x):
        x = as_float(x)
        d = x.shape[-1]
        lp = _cholesky(as_float(self.precision))
        # z = Lp^T dx, so dx^T P dx = |z|^2
        z = torch.einsum("...ji,...j->...i", lp, x - as_float(self.mean_))
        return guard_log_density(0.5 * (_chol_logdet(lp) - torch.sum(z * z, dim=-1) - d * LOG2PI))

    def sample(self, generator, shape=()):
        lp = _cholesky(as_float(self.precision))
        full = _param_batch(shape, (self.mean_, 1), (self.precision, 2))
        z = torch.randn((*full, self.event_shape[0]), generator=generator, dtype=lp.dtype,
                        device=generator.device)
        return as_float(self.mean_) + _solve_tri(lp, z[..., None], trans=1)[..., 0]  # mean + Lp^-T z

    def mean(self):
        return as_float(self.mean_)

    def covariance(self):
        return torch.linalg.inv(as_float(self.precision))

    def variance(self):
        return torch.diagonal(self.covariance(), dim1=-2, dim2=-1)


@dist_dataclass
class MultivariateT(Distribution):
    """Multivariate Student-t(df, loc, shape matrix Sigma)."""

    df: torch.Tensor
    loc: torch.Tensor  # [d]
    shape_matrix: torch.Tensor  # [d, d]

    @property
    def event_shape(self):
        return (self.loc.shape[-1],)

    def log_prob(self, x):
        x = as_float(x)
        d = x.shape[-1]
        v = torch.as_tensor(self.df, dtype=x.dtype, device=x.device)
        factor = _cholesky(as_float(self.shape_matrix))
        z = _whiten(factor, x - as_float(self.loc))
        q = torch.sum(z * z, dim=-1)
        logp = (
            torch.lgamma(0.5 * (v + d))
            - torch.lgamma(0.5 * v)
            - 0.5 * d * log_precise(v * math.pi)
            - 0.5 * _chol_logdet(factor)
            - 0.5 * (v + d) * torch.log1p(q / v)
        )
        return guard_log_density(logp)

    def sample(self, generator, shape=()):
        d = self.event_shape[0]
        factor = _cholesky(as_float(self.shape_matrix))
        v = torch.as_tensor(self.df, dtype=factor.dtype, device=generator.device)
        full = _param_batch(shape, (self.df, 0), (self.loc, 1), (self.shape_matrix, 2))
        z = torch.randn((*full, d), generator=generator, dtype=factor.dtype, device=generator.device)
        chi2 = 2.0 * _standard_gamma(generator, (0.5 * v).expand(full).contiguous())
        y = torch.einsum("...ij,...j->...i", factor, z)
        return as_float(self.loc) + y * torch.sqrt(v / chi2)[..., None]

    def mean(self):
        return as_float(self.loc)

    def covariance(self):
        v = torch.as_tensor(self.df, dtype=as_float(self.shape_matrix).dtype)
        return as_float(self.shape_matrix) * v / (v - 2.0)
