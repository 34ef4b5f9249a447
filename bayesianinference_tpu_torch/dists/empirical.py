"""Weighted empirical distribution and continuous parameter mixture (port
of ``Empirical`` and ``ParameterMixture`` from
``bayesianinference_tpu.dists.empirical``): the posterior object of a
nested-sampling result and the predictive of a Laplace fit."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import as_float, logsumexp
from .base import Distribution, dist_dataclass

__all__ = ["Empirical", "ParameterMixture"]


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
