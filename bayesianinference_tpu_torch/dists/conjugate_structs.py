"""Normal-inverse-gamma and normal-inverse-Wishart joint distributions (port
of ``bayesianinference_tpu.dists.conjugate_structs``).

They are joints over (mean, variance) and (mean vector, covariance
matrix), so they take two arguments where a :class:`Distribution` takes
one.  Parameters are Python numbers or tensors; densities follow the
device and dtype of the values they are given (Python-number parameters
take the values' dtype), draws the generator's device.
"""

from __future__ import annotations

import torch

from ..core.numerics import as_float
from .base import as_param, dist_dataclass
from .multivariate import InverseWishart, MultivariateNormal, MultivariateT, _cholesky
from .scalar import InverseGamma, Normal, StudentT

__all__ = ["NormalInverseGamma", "NormalInverseWishart"]


@dist_dataclass
class NormalInverseGamma:
    """NIG(mu0, lam, beta, nu): var ~ InverseGamma(nu, beta) and
    mean | var ~ Normal(mu0, sqrt(var / lam))."""

    mu0: object = 0.0
    lam: object = 1.0
    beta: object = 1.0
    nu: object = 1.0

    def marginal_mean(self) -> StudentT:
        """StudentT(2 nu, mu0, sqrt(beta / (nu lam)))."""
        return StudentT(df=2.0 * self.nu, loc=self.mu0, scale=(self.beta / (self.nu * self.lam)) ** 0.5)

    def marginal_variance(self) -> InverseGamma:
        return InverseGamma(a=self.nu, b=self.beta)

    def log_prob(self, mean, var):
        var = as_float(var)
        cond = Normal(loc=as_param(self.mu0, var), scale=torch.sqrt(var / as_param(self.lam, var)))
        ig = InverseGamma(a=as_param(self.nu, var), b=as_param(self.beta, var))
        return cond.log_prob(as_float(mean)) + ig.log_prob(var)

    def sample(self, generator: torch.Generator, shape=()):
        """(mean, var): the variance first, then the mean given it."""
        var = self.marginal_variance().sample(generator, shape).to(generator.device)
        z = torch.randn(var.shape, generator=generator, dtype=var.dtype, device=generator.device)
        return as_param(self.mu0, var) + torch.sqrt(var / as_param(self.lam, var)) * z, var


@dist_dataclass
class NormalInverseWishart:
    """NIW(mu0, lam, psi, nu): Sigma ~ InverseWishart(nu, psi) and
    mu | Sigma ~ MVN(mu0, Sigma / lam)."""

    mu0: torch.Tensor  # [d]
    lam: object
    psi: torch.Tensor  # [d, d]
    nu: object

    @property
    def dim(self) -> int:
        return self.mu0.shape[-1]

    def marginal_mean(self) -> MultivariateT:
        """MultivariateT(nu - d + 1, mu0, psi / (lam (nu - d + 1)))."""
        psi = as_float(self.psi)
        df = as_param(self.nu, psi) - self.dim + 1.0
        return MultivariateT(df=df, loc=as_float(self.mu0), shape_matrix=psi / (as_param(self.lam, psi) * df))

    def marginal_cov(self) -> InverseWishart:
        psi = as_float(self.psi)
        return InverseWishart(df=as_param(self.nu, psi), scale=psi)

    def log_prob(self, mean, cov):
        cov = as_float(cov)
        cond = MultivariateNormal(mean_=as_float(self.mu0), cov=cov / as_param(self.lam, cov))
        return cond.log_prob(as_float(mean)) + self.marginal_cov().log_prob(cov)

    def sample(self, generator: torch.Generator, shape=()):
        """(mean, cov): the covariance first, then the mean given it; the
        factor of cov / lam goes through the ``cholesky`` op."""
        cov = self.marginal_cov().sample(generator, shape)
        factor = _cholesky(cov / as_param(self.lam, cov))
        z = torch.randn((*tuple(shape), self.dim), generator=generator, dtype=factor.dtype, device=generator.device)
        return as_param(self.mu0, cov) + torch.einsum("...ij,...j->...i", factor, z), cov
