"""Multivariate and matrix-variate families (port of
``bayesianinference_tpu.dists.multivariate``): ``MultivariateNormal``,
``MultivariateNormalPrecision``, ``MultivariateT``, ``MatrixNormal``,
``MatrixT``, ``Wishart``, ``InverseWishart``, ``Dirichlet``,
``Multinomial`` and ``mvgammaln``.

All use Cholesky factors and triangular solves, never explicit inverses.
Every factor goes through the ``cholesky`` op (the hand-written kernel on
the card) on the symmetrized matrix; a non-PD matrix gives a NaN factor,
so the density falls to the log-zero sentinel.  (The JAX package factors
small matrices through ``ops.metropolis._cholesky``, its 32-row switch
for the TPU; the port has one path.)
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.numerics import LOG2PI, as_float, guard_log_density, log_precise, log_zero, xlogy
from ..ops import gp_kernels  # a module reference: gp_kernels imports this package
from .base import Distribution, dist_dataclass

__all__ = [
    "MultivariateNormal",
    "MultivariateNormalPrecision",
    "MultivariateT",
    "MatrixNormal",
    "MatrixT",
    "Wishart",
    "InverseWishart",
    "Dirichlet",
    "Multinomial",
    "mvgammaln",
]

_LOG2 = math.log(2.0)
_LOGPI = math.log(math.pi)


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


GAMMA_ROUNDS = 16  # candidates per draw without a generator: all rejected with probability below 0.05 ** 16


def _standard_gamma(generator: Optional[torch.Generator], alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``alpha``'s shape (Marsaglia and Tsang,
    with the alpha < 1 boost), from ``generator``.

    With ``generator`` None (a stage of a study mapped by ``torch.func.vmap``,
    drawing from the default generator) the rejection loop, which ends on the
    data, cannot run: each element draws ``GAMMA_ROUNDS`` candidates at once
    and takes its first accepted one, as JAX's vmapped ``while_loop`` does.
    Each candidate is accepted with probability at least 0.95."""
    dt = alpha.dtype
    dev = alpha.device if generator is None else generator.device
    boost = alpha < 1
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    if generator is None:
        z = torch.randn((GAMMA_ROUNDS, *a.shape), dtype=dt, device=dev)
        u = torch.rand((GAMMA_ROUNDS, *a.shape), dtype=dt, device=dev)
        v = (1.0 + c * z) ** 3
        safe_v = torch.where(v > 0, v, torch.ones_like(v))
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * safe_v + d * torch.log(safe_v))
        first = ok & (torch.cumsum(ok.to(torch.int64), dim=0) == 1)
        out = torch.sum(torch.where(first, d * safe_v, torch.zeros_like(safe_v)), dim=0)
        u = torch.rand(a.shape, dtype=dt, device=dev)
        return torch.where(boost, out * u ** (1.0 / alpha), out)
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


def _lu_z_lv(lu: torch.Tensor, z: torch.Tensor, lv: torch.Tensor) -> torch.Tensor:
    """Lu Z Lv^T for Z [..., n, p]."""
    return lu @ z @ lv.mT


def _whitened_residual(lu: torch.Tensor, lv: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Z = Lv^-1 (Lu^-1 dx)^T [..., p, n]: tr(V^-1 dx^T U^-1 dx) = |Z|_F^2."""
    return _solve_tri(lv, _solve_tri(lu, dx).mT)


@dist_dataclass
class MatrixNormal(Distribution):
    """MatrixNormal(M [n, p], row covariance U [n, n], column covariance
    V [p, p]): the coefficients of multivariate conjugate regression."""

    loc: torch.Tensor  # [n, p]
    row_cov: torch.Tensor  # [n, n]
    col_cov: torch.Tensor  # [p, p]

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-2:])

    def log_prob(self, x):
        x = as_float(x)
        n, p = x.shape[-2], x.shape[-1]
        lu, lv = _cholesky(as_float(self.row_cov)), _cholesky(as_float(self.col_cov))
        z = _whitened_residual(lu, lv, x - as_float(self.loc))
        q = torch.sum(z * z, dim=(-2, -1))
        return guard_log_density(-0.5 * (q + n * p * LOG2PI + p * _chol_logdet(lu) + n * _chol_logdet(lv)))

    def sample(self, generator, shape=()):
        n, p = self.event_shape
        lu, lv = _cholesky(as_float(self.row_cov)), _cholesky(as_float(self.col_cov))
        full = _param_batch(shape, (self.loc, 2), (self.row_cov, 2), (self.col_cov, 2))
        z = torch.randn((*full, n, p), generator=generator, dtype=lu.dtype, device=generator.device)
        return as_float(self.loc) + _lu_z_lv(lu, z, lv)

    def mean(self):
        return as_float(self.loc)


@dist_dataclass
class MatrixT(Distribution):
    """Matrix-variate Student-t (Gupta and Nagar): X [n, p] ~ MatrixT(df,
    M, U [n, n], V [p, p]) with density
    Gamma_p((df+n+p-1)/2) / (pi^(np/2) Gamma_p((df+p-1)/2)) |U|^(-p/2)
    |V|^(-n/2) |I_p + V^-1 (X-M)^T U^-1 (X-M)|^(-(df+n+p-1)/2)."""

    df: torch.Tensor
    loc: torch.Tensor  # [n, p]
    row_cov: torch.Tensor  # [n, n]
    col_cov: torch.Tensor  # [p, p]

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-2:])

    def log_prob(self, x):
        x = as_float(x)
        n, p = x.shape[-2], x.shape[-1]
        v = torch.as_tensor(self.df, dtype=x.dtype, device=x.device)
        lu, lv = _cholesky(as_float(self.row_cov)), _cholesky(as_float(self.col_cov))
        z = _whitened_residual(lu, lv, x - as_float(self.loc))
        s = torch.eye(p, dtype=z.dtype, device=z.device) + z @ z.mT
        alpha, beta = 0.5 * (v + n + p - 1.0), 0.5 * (v + p - 1.0)
        logp = (mvgammaln(alpha, p) - mvgammaln(beta, p) - 0.5 * n * p * _LOGPI - 0.5 * p * _chol_logdet(lu)
                - 0.5 * n * _chol_logdet(lv) - alpha * _chol_logdet(_cholesky(s)))
        return guard_log_density(logp)

    def sample(self, generator, shape=()):
        """The inverse-Wishart mixture: S ~ InverseWishart(df + p - 1, V),
        X | S ~ MatrixNormal(M, U, S), one S per draw."""
        n, p = self.event_shape
        full = _param_batch(shape, (self.df, 0), (self.loc, 2), (self.row_cov, 2), (self.col_cov, 2))
        col = as_float(self.col_cov)
        s = InverseWishart(df=torch.as_tensor(self.df, dtype=col.dtype, device=col.device) + p - 1.0,
                           scale=col).sample(generator, full)
        lu, ls = _cholesky(as_float(self.row_cov)), _cholesky(s)
        z = torch.randn((*full, n, p), generator=generator, dtype=lu.dtype, device=generator.device)
        return as_float(self.loc) + _lu_z_lv(lu, z, ls)

    def mean(self):
        return as_float(self.loc)


def _bartlett(generator: torch.Generator, df, d: int, dtype: torch.dtype, batch=()) -> torch.Tensor:
    """Lower-triangular Bartlett factor A with A A^T ~ Wishart(df, I), one
    per ``batch`` element: sqrt(chi2 with df - i degrees) on the diagonal,
    standard normals below."""
    dev = generator.device
    i = torch.arange(d, dtype=dtype, device=dev)
    shape = (*batch, d)
    g = _standard_gamma(generator, (0.5 * (torch.as_tensor(df, dtype=dtype, device=dev)[..., None] - i))
                        .expand(shape).contiguous())
    z = torch.randn((*batch, d, d), generator=generator, dtype=dtype, device=dev)
    return torch.tril(z, -1) + torch.diag_embed(torch.sqrt(2.0 * g))


@dist_dataclass
class Wishart(Distribution):
    """Wishart(df, scale S): E[X] = df S."""

    df: torch.Tensor
    scale: torch.Tensor  # [d, d]

    @property
    def event_shape(self):
        d = self.scale.shape[-1]
        return (d, d)

    def log_prob(self, x):
        x = as_float(x)
        d = x.shape[-1]
        v = torch.as_tensor(self.df, dtype=x.dtype, device=x.device)
        ls, lx = _cholesky(as_float(self.scale)), _cholesky(x)
        a = _solve_tri(ls, lx)  # tr(S^-1 X) = |Ls^-1 Lx|_F^2
        logp = (0.5 * (v - d - 1.0) * _chol_logdet(lx) - 0.5 * torch.sum(a * a, dim=(-2, -1))
                - 0.5 * v * d * _LOG2 - 0.5 * v * _chol_logdet(ls) - mvgammaln(0.5 * v, d))
        return guard_log_density(logp)

    def sample(self, generator, shape=()):
        ls = _cholesky(as_float(self.scale))
        full = _param_batch(shape, (self.df, 0), (self.scale, 2))
        la = ls @ _bartlett(generator, self.df, ls.shape[-1], ls.dtype, full)
        return la @ la.mT

    def mean(self):
        scale = as_float(self.scale)
        return torch.as_tensor(self.df, dtype=scale.dtype, device=scale.device) * scale


@dist_dataclass
class InverseWishart(Distribution):
    """InverseWishart(df, scale Psi): E[X] = Psi / (df - d - 1), the
    covariance of multivariate conjugate models."""

    df: torch.Tensor
    scale: torch.Tensor  # [d, d]

    @property
    def event_shape(self):
        d = self.scale.shape[-1]
        return (d, d)

    def log_prob(self, x):
        x = as_float(x)
        d = x.shape[-1]
        v = torch.as_tensor(self.df, dtype=x.dtype, device=x.device)
        lp, lx = _cholesky(as_float(self.scale)), _cholesky(x)
        a = torch.linalg.solve_triangular(lx, lp.expand(lx.shape), upper=False)  # tr(Psi X^-1) = |Lx^-1 Lp|_F^2
        logp = (0.5 * v * _chol_logdet(lp) - 0.5 * (v + d + 1.0) * _chol_logdet(lx)
                - 0.5 * torch.sum(a * a, dim=(-2, -1)) - 0.5 * v * d * _LOG2 - mvgammaln(0.5 * v, d))
        return guard_log_density(logp)

    def sample(self, generator, shape=()):
        lp = _cholesky(as_float(self.scale))
        d = lp.shape[-1]
        full = _param_batch(shape, (self.df, 0), (self.scale, 2))
        a = _bartlett(generator, self.df, d, lp.dtype, full)
        eye = torch.eye(d, dtype=lp.dtype, device=a.device).expand(a.shape)
        # X^-1 = Lp^-T A A^T Lp^-1, so X = Lp A^-T A^-1 Lp^T
        m = lp @ torch.linalg.solve_triangular(a, eye, upper=False).mT
        return m @ m.mT

    def mean(self):
        scale = as_float(self.scale)
        v = torch.as_tensor(self.df, dtype=scale.dtype, device=scale.device)
        return scale / (v - scale.shape[-1] - 1.0)


@dist_dataclass
class Dirichlet(Distribution):
    """Dirichlet(alpha [k]) on the probability simplex: the conjugate prior
    of ``Categorical`` and ``Multinomial``."""

    alpha: torch.Tensor  # [k]

    @property
    def event_shape(self):
        return (self.alpha.shape[-1],)

    def support(self):
        k = self.event_shape[0]
        return (torch.zeros((k,)), torch.ones((k,)))

    def log_prob(self, x):
        x = as_float(x)
        a = as_float(self.alpha).to(x.device)
        lognorm = torch.lgamma(a.sum(dim=-1)) - torch.lgamma(a).sum(dim=-1)
        logp = guard_log_density(xlogy(a - 1.0, x).sum(dim=-1) + lognorm)
        on_simplex = (x >= 0.0).all(dim=-1) & (torch.abs(x.sum(dim=-1) - 1.0) <= 1e-6)
        return torch.where(on_simplex, logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        a = as_float(self.alpha).to(generator.device)
        full = torch.broadcast_shapes(tuple(shape), a.shape[:-1])
        g = _standard_gamma(generator, a.expand(*full, a.shape[-1]).contiguous())
        return g / g.sum(dim=-1, keepdim=True)

    def mean(self):
        a = as_float(self.alpha)
        return a / a.sum(dim=-1, keepdim=True)

    def variance(self):
        a = as_float(self.alpha)
        a0 = a.sum(dim=-1, keepdim=True)
        m = a / a0
        return m * (1.0 - m) / (a0 + 1.0)


@dist_dataclass
class Multinomial(Distribution):
    """Multinomial(n trials, probabilities p [k]): counts over k categories,
    the log-pmf in lgamma form."""

    n: object  # scalar
    p: torch.Tensor  # [k]

    @property
    def event_shape(self):
        return (self.p.shape[-1],)

    def support(self):
        k = self.event_shape[0]
        return (torch.zeros((k,)), torch.full((k,), float(self.n)))

    def log_prob(self, x):
        x = as_float(x)
        p = as_float(self.p).to(x.device)
        n = torch.as_tensor(self.n, dtype=x.dtype, device=x.device)
        logp = torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0).sum(dim=-1) + xlogy(x, p).sum(dim=-1)
        valid = (x >= 0.0).all(dim=-1) & (x == torch.floor(x)).all(dim=-1) & (x.sum(dim=-1) == n)
        return torch.where(valid & torch.isfinite(logp), logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        """``n`` categorical draws per result row, counted."""
        p = as_float(self.p).to(generator.device)
        k = p.shape[-1]
        full = torch.broadcast_shapes(tuple(shape), p.shape[:-1])
        rows = p.expand(*full, k).reshape(-1, k)
        idx = torch.multinomial(rows, int(self.n), replacement=True, generator=generator)
        counts = torch.zeros((rows.shape[0], k), dtype=p.dtype, device=p.device)
        counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=p.dtype))
        return counts.reshape(*full, k)

    def mean(self):
        p = as_float(self.p)
        return float(self.n) * p

    def variance(self):
        p = as_float(self.p)
        return float(self.n) * p * (1.0 - p)
