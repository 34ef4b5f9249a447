"""Pointwise mixture over a batch of prediction points (port of
``bayesianinference_tpu.dists.pointwise``): S mixture components at each
of m query points, vectorized over the point axis.  It is the posterior
predictive that ``predict_from_gaussian_process`` returns."""

from __future__ import annotations

import dataclasses

import torch

from ..core.numerics import as_float, logsumexp
from .base import Distribution, bisect_icdf, dist_dataclass

__all__ = ["PointwiseMixture"]


def _tensor_fields(dist: Distribution):
    return [
        f.name for f in dataclasses.fields(dist)
        if isinstance(getattr(dist, f.name), torch.Tensor)
    ]


@dist_dataclass
class PointwiseMixture(Distribution):
    """Mixture with weights [S] whose component has parameters of shape
    [S, m] (S components at each of m points).  ``log_prob``, ``cdf``,
    ``mean``, ``variance``, ``quantile`` and ``sample`` map over the m
    points."""

    log_weights: torch.Tensor  # [S]
    component: Distribution  # scalar family, params [S, m]

    @property
    def num_points(self) -> int:
        return getattr(self.component, _tensor_fields(self.component)[0]).shape[1]

    @property
    def event_shape(self):
        return self.component.event_shape

    def _norm_logw(self) -> torch.Tensor:
        lw = as_float(self.log_weights)
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = as_float(x)
        ed = len(self.event_shape)
        comp_lp = self.component.log_prob(x.unsqueeze(-(ed + 2)))  # [.., S, m]
        return logsumexp(self._norm_logw()[:, None] + comp_lp, dim=-2)

    def cdf(self, x):
        if self.event_shape:
            raise NotImplementedError("cdf is defined for scalar-output predictives only")
        x = as_float(x)
        comp_cdf = self.component.cdf(x[..., None, :])  # [.., S, m]
        return torch.einsum("s,...sm->...m", torch.exp(self._norm_logw()), comp_cdf)

    def quantile(self, q):
        """Per-point quantiles; ``q`` scalar -> [m], or [k] -> [k, m]."""
        lw = self._norm_logw()
        q = torch.as_tensor(q, dtype=lw.dtype, device=lw.device)
        m = self.num_points
        qq = torch.broadcast_to(q.reshape(-1, 1), (max(1, q.numel()), m))
        out = bisect_icdf(self.cdf, qq, torch.full_like(qq, -1e10), torch.full_like(qq, 1e10))
        return out[0] if q.dim() == 0 else out

    def _wsum(self, arr) -> torch.Tensor:
        """Weighted sum over the leading mixture axis of [S, m, ...]."""
        return torch.tensordot(torch.exp(self._norm_logw()), torch.as_tensor(arr), dims=([0], [0]))

    def mean(self):
        return self._wsum(self.component.mean())

    def variance(self):
        m_ = torch.as_tensor(self.component.mean())
        v_ = torch.as_tensor(self.component.variance())
        return self._wsum(v_ + m_**2) - self._wsum(m_) ** 2

    def sample(self, generator, shape=()):
        shape = tuple(shape)
        m = self.num_points
        num = 1
        for s in shape:
            num *= s
        w = torch.exp(self._norm_logw())
        idx = torch.multinomial(w, num * m, replacement=True, generator=generator)
        idx = idx.reshape(shape + (m,))  # independent component choice per point
        cols = torch.arange(m, device=idx.device)
        comp = dataclasses.replace(
            self.component,
            **{f: getattr(self.component, f)[idx, cols] for f in _tensor_fields(self.component)},
        )
        return comp.sample(generator)
