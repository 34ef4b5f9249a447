"""Weighted empirical distribution (port of ``Empirical`` from
``bayesianinference_tpu.dists.empirical``): the posterior object of a
nested-sampling result."""

from __future__ import annotations

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import as_float, logsumexp
from .base import Distribution, dist_dataclass

__all__ = ["Empirical"]


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
