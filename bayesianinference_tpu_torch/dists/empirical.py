"""Weighted empirical distribution, Gaussian kernel density estimate and
continuous parameter mixture (port of
``bayesianinference_tpu.dists.empirical``): the posterior object of a
nested-sampling result, its smoothed density, and the predictive of a
Laplace fit."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import LOG2PI, as_float, logsumexp
from .base import Distribution, dist_dataclass

__all__ = ["Empirical", "GaussianKDE", "ParameterMixture", "silverman_bandwidth"]


@dist_dataclass
class Empirical(Distribution):
    """Weighted empirical distribution over points [n, d]."""

    points: torch.Tensor  # [n, d]
    log_weights: torch.Tensor  # [n]

    @property
    def event_shape(self):
        return (self.points.shape[-1],)

    def _weights(self) -> torch.Tensor:
        lw = as_float(self.log_weights)
        return torch.exp(lw - logsumexp(lw))

    def sample(self, generator, shape=()):
        shape = tuple(shape)
        num = 1
        for s in shape:
            num *= s
        idx = torch.multinomial(self._weights(), num, replacement=True, generator=generator)
        return as_float(self.points)[idx].reshape(shape + self.event_shape)

    def mean(self):
        return self._weights() @ as_float(self.points)

    def variance(self):
        p = as_float(self.points)
        w = self._weights()
        return w @ (p - w @ p) ** 2

    def covariance(self):
        p = as_float(self.points)
        w = self._weights()
        c = p - w @ p
        return torch.einsum("n,ni,nj->ij", w, c, c)

    def to_weighted_samples(self) -> WeightedSamples:
        return WeightedSamples(points=self.points, log_weights=as_float(self.log_weights))

    @staticmethod
    def from_weighted_samples(ws: WeightedSamples) -> "Empirical":
        return Empirical(points=ws.points, log_weights=ws.log_weights)

    def cdf(self, x):
        """Marginal-wise empirical CDF at x [d] (or batched [..., d])."""
        p = as_float(self.points)
        le = p <= as_float(x).unsqueeze(-2)  # [..., n, d]
        return torch.einsum("n,...nd->...d", self._weights(), le.to(p.dtype))


def silverman_bandwidth(points, weights=None) -> torch.Tensor:
    """Silverman's rule per dimension for weighted samples [n, d]:
    sd (4 / ((d + 2) n_eff))^(1 / (d + 4)), n_eff = 1 / sum w^2."""
    p = as_float(points)
    n, d = p.shape
    w = torch.full((n,), 1.0 / n, dtype=p.dtype, device=p.device) if weights is None else as_float(weights)
    w = w / torch.sum(w)
    n_eff = 1.0 / torch.sum(w**2)
    mu = w @ p
    sd = torch.sqrt(w @ (p - mu) ** 2)
    return sd * (4.0 / ((d + 2.0) * n_eff)) ** (1.0 / (d + 4.0))


@dist_dataclass
class GaussianKDE(Distribution):
    """Weighted Gaussian kernel density estimate over points [n, d] with a
    diagonal bandwidth [d]."""

    points: torch.Tensor  # [n, d]
    log_weights: torch.Tensor  # [n]
    bandwidth: torch.Tensor  # [d]

    @staticmethod
    def fit(points, log_weights=None) -> "GaussianKDE":
        """Silverman's bandwidth for ``points`` [n, d]; a 1-D [n] input is
        n samples of one dimension ([n, 1]), not one n-dimensional point."""
        p = as_float(points)
        if p.dim() == 1:
            p = p[:, None]
        lw = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device) if log_weights is None else \
            as_float(log_weights).to(p.device)
        return GaussianKDE(points=p, log_weights=lw, bandwidth=silverman_bandwidth(p, torch.exp(lw - logsumexp(lw))))

    @property
    def event_shape(self):
        return (self.points.shape[-1],)

    def _norm_logw(self) -> torch.Tensor:
        lw = as_float(self.log_weights)
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = as_float(x)
        p, h = as_float(self.points), as_float(self.bandwidth)
        z = (x.unsqueeze(-2) - p) / h  # [..., n, d]
        ker = -0.5 * torch.sum(z * z, dim=-1) - 0.5 * p.shape[-1] * LOG2PI - torch.sum(torch.log(h))
        return logsumexp(self._norm_logw() + ker, dim=-1)

    def sample(self, generator, shape=(), *, indices=None, normals=None):
        """``indices`` (``shape``) and ``normals`` (``shape`` + [d])
        replace the generator's choice of points and kernel noise."""
        shape = tuple(shape)
        if indices is None:
            num = math.prod(shape) if shape else 1
            indices = torch.multinomial(torch.exp(self._norm_logw()), num, replacement=True,
                                        generator=generator).reshape(shape)
        p = as_float(self.points)
        base = p[torch.as_tensor(indices, device=p.device)]
        if normals is None:
            normals = torch.randn(base.shape, generator=generator, dtype=base.dtype, device=base.device)
        return base + as_float(normals).to(base) * as_float(self.bandwidth)

    def mean(self):
        return torch.exp(self._norm_logw()) @ as_float(self.points)


@dataclasses.dataclass(frozen=True)
class ParameterMixture(Distribution):
    """Continuous mixture: theta ~ param_dist, x | theta ~ build(theta).

    ``log_prob`` is a Monte-Carlo marginalization over ``num_quadrature``
    fixed draws of ``param_dist``, made by a generator seeded with
    ``seed`` on the device of ``param_dist.mean()``."""

    param_dist: Distribution
    build: Callable  # theta -> Distribution
    num_quadrature: int = 128
    seed: int = 0

    def _thetas(self) -> torch.Tensor:
        dev = torch.as_tensor(self.param_dist.mean()).device
        generator = torch.Generator(device=dev).manual_seed(self.seed)
        return self.param_dist.sample(generator, (self.num_quadrature,))

    def log_prob(self, x):
        lps = torch.func.vmap(lambda th: self.build(th).log_prob(x))(self._thetas())
        return logsumexp(lps, dim=0) - math.log(self.num_quadrature)

    def sample(self, generator, shape=()):
        shape = tuple(shape)
        n = math.prod(shape) if shape else 1
        thetas = self.param_dist.sample(generator, (n,))
        out = torch.stack([self.build(th).sample(generator) for th in thetas])
        # per-draw shape is the built distribution's own
        return out.reshape(shape + out.shape[1:]) if shape else out[0]
