"""Distribution combinators (port of the part of
``bayesianinference_tpu.dists.combinators`` that ``models/problem.py``
imports: ``Product``, ``Truncated`` and ``ImproperUniform``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.numerics import as_float, log_zero
from .base import Distribution, as_param, dist_dataclass, param_dtype

__all__ = ["Product", "Truncated", "ImproperUniform"]


@dataclasses.dataclass(frozen=True)
class Product(Distribution):
    """Joint of independent scalar components over a parameter vector:
    ``Product((Normal(0, 1), Uniform(0, 5)))`` is a distribution over R^2."""

    components: Tuple[Distribution, ...]

    def __post_init__(self):
        object.__setattr__(self, "components", tuple(self.components))

    @property
    def event_shape(self):
        return (len(self.components),)

    def _runs(self):
        """(start, stop, distribution) per run of neighbouring components:
        a run of one class whose parameters are all 0-d tensors (what
        ``ignorance_prior`` builds) is folded into one instance of that
        class with the parameters stacked, so its ``log_prob`` is a handful
        of vector operations whatever the dimension; any other component is
        a run of its own."""
        cached = getattr(self, "_runs_cache", None)
        if cached is not None:
            return cached

        def foldable(c):
            return dataclasses.is_dataclass(c) and c.event_shape == () and all(
                isinstance(getattr(c, f.name), torch.Tensor) and getattr(c, f.name).dim() == 0
                for f in dataclasses.fields(c))

        runs, i, comps = [], 0, self.components
        while i < len(comps):
            j = i + 1
            if foldable(comps[i]):
                while j < len(comps) and type(comps[j]) is type(comps[i]) and foldable(comps[j]):
                    j += 1
            dist = comps[i]
            if j - i > 1:
                dist = type(dist)(**{f.name: torch.stack([getattr(c, f.name) for c in comps[i:j]])
                                     for f in dataclasses.fields(dist)})
            runs.append((i, j, dist))
            i = j
        object.__setattr__(self, "_runs_cache", runs)
        return runs

    def log_prob(self, x):
        x = as_float(x)
        return sum(dist.log_prob(x[..., i]) if j - i == 1 else dist.log_prob(x[..., i:j]).sum(dim=-1)
                   for i, j, dist in self._runs())

    def sample(self, generator, shape=()):
        shape = tuple(shape)
        cols = [c.sample(generator, shape) for c in self.components]
        return torch.stack([torch.broadcast_to(c, shape) for c in cols], dim=-1)

    def support(self):
        lows, highs = zip(*(c.support() for c in self.components))
        dt = param_dtype(*lows, *highs)
        return (
            torch.stack([torch.as_tensor(lo, dtype=dt) for lo in lows]),
            torch.stack([torch.as_tensor(hi, dtype=dt) for hi in highs]),
        )

    def mean(self):
        return torch.stack([torch.as_tensor(c.mean()) for c in self.components])

    def variance(self):
        return torch.stack([torch.as_tensor(c.variance()) for c in self.components])


@dist_dataclass
class Truncated(Distribution):
    """Scalar distribution truncated to [low, high]; ``log_prob``
    renormalizes by ``cdf(high) - cdf(low)`` and sampling is by inverse CDF."""

    base: Distribution
    low: object = -float("inf")
    high: object = float("inf")

    def support(self):
        blo, bhi = self.base.support()
        dt = param_dtype(self.low, self.high, blo, bhi)
        t = lambda v: torch.as_tensor(v, dtype=dt)  # noqa: E731
        return (torch.maximum(t(self.low), t(blo)), torch.minimum(t(self.high), t(bhi)))

    def _log_z(self, ref):
        lo, hi = (as_param(v, ref).to(ref.dtype) for v in self.support())
        c_lo = torch.where(torch.isfinite(lo), self.base.cdf(lo), torch.zeros_like(lo))
        c_hi = torch.where(torch.isfinite(hi), self.base.cdf(hi), torch.ones_like(hi))
        width = c_hi - c_lo
        safe = torch.where(width > 0, width, torch.ones_like(width))
        log_z = torch.where(width > 0, torch.log(safe), torch.full_like(width, log_zero(width.dtype)))
        return log_z, c_lo, c_hi

    def log_prob(self, x):
        x = as_float(x)
        log_z, _, _ = self._log_z(x)
        return self._mask_support(x, self.base.log_prob(x) - log_z)

    def sample(self, generator, shape=()):
        shape = torch.broadcast_shapes(tuple(shape))
        u = torch.rand(shape, generator=generator, device=generator.device,
                       dtype=param_dtype(self.low, self.high, *self.base.support()))
        u = 1e-7 + (1.0 - 2e-7) * u
        _, c_lo, c_hi = self._log_z(u)
        return self.base.icdf(c_lo + u * (c_hi - c_lo))

    def cdf(self, x):
        x = as_float(x)
        _, c_lo, c_hi = self._log_z(x)
        return torch.clamp((self.base.cdf(x) - c_lo) / (c_hi - c_lo), 0.0, 1.0)

    def icdf(self, q):
        q = as_float(q)
        _, c_lo, c_hi = self._log_z(q)
        return self.base.icdf(c_lo + q * (c_hi - c_lo))


@dist_dataclass
class ImproperUniform(Distribution):
    """Constant-density improper prior over R^d."""

    dim: int = 1

    @property
    def event_shape(self):
        return (self.dim,)

    def log_prob(self, x):
        x = as_float(x)
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def sample(self, generator, shape=()):
        raise NotImplementedError(
            "improper uniform cannot be sampled; nested sampling falls back "
            "to MCMC starting-point generation"
        )
