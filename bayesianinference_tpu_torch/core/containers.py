"""Weighted-sample container (port of ``bayesianinference_tpu.core.containers``)."""

from __future__ import annotations

import dataclasses

import torch

from .numerics import log_zero, logsumexp

__all__ = ["WeightedSamples", "take_posterior_fraction"]


@dataclasses.dataclass(frozen=True)
class WeightedSamples:
    """Points with unnormalised log-weights.

    Attributes:
      points:          [n, d] parameter samples.
      log_weights:     [n] unnormalised log posterior weights.
      log_likelihoods: [n] log-likelihood values (optional).
    """

    points: torch.Tensor
    log_weights: torch.Tensor
    log_likelihoods: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[-1]

    def normalized_weights(self) -> torch.Tensor:
        return torch.exp(self.log_weights - logsumexp(self.log_weights))

    def mean(self) -> torch.Tensor:
        return self.normalized_weights() @ self.points

    def _centered(self):
        w = self.normalized_weights()
        c = self.points - w @ self.points
        denom = torch.clamp(1.0 - torch.sum(w**2), min=1e-12)
        return w, c, denom

    def cov(self) -> torch.Tensor:
        """Unbiased weighted covariance."""
        w, c, denom = self._centered()
        return torch.einsum("n,ni,nj->ij", w, c, c) / denom

    def var(self) -> torch.Tensor:
        w, c, denom = self._centered()
        return (w @ c**2) / denom

    def std_error(self) -> torch.Tensor:
        """Standard error of the weighted mean (effective-sample-size based)."""
        ess = self.effective_sample_size()
        return torch.sqrt(self.var() / torch.clamp(ess, min=1.0))

    def effective_sample_size(self) -> torch.Tensor:
        return 1.0 / torch.sum(self.normalized_weights() ** 2)

    def resample(self, generator: torch.Generator, num: int | None = None) -> torch.Tensor:
        """Multinomial resampling to equal-weight points."""
        num = num or self.n
        idx = torch.multinomial(
            self.normalized_weights(), num, replacement=True, generator=generator
        )
        return self.points[idx]


def take_posterior_fraction(ws: WeightedSamples, fraction: float) -> WeightedSamples:
    """Keep the highest-weight samples holding >= ``fraction`` of the mass;
    the others get log-zero weight (shapes stay fixed)."""
    w = ws.normalized_weights()
    order = torch.argsort(-w, stable=True)
    cum = torch.cumsum(w[order], dim=0)
    keep_sorted = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=w.device), cum[:-1] < fraction]
    )
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    lz = log_zero(ws.log_weights.dtype)
    new_lw = torch.where(keep, ws.log_weights, torch.full_like(ws.log_weights, lz))
    return dataclasses.replace(ws, log_weights=new_lw)
