"""Scalar distribution families (port of the part of
``bayesianinference_tpu.dists.scalar`` that the nested-sampling and GP
path imports: ``Normal``, ``Uniform``, ``LogUniform`` and ``Cauchy``)."""

from __future__ import annotations

import math

import torch

from ..core.numerics import LOG2PI, as_float
from .base import Distribution, as_param, dist_dataclass, param_dtype, param_shape

__all__ = ["Normal", "Uniform", "LogUniform", "Cauchy"]

_LOGPI = 1.1447298858494002


def _draw(fn, generator: torch.Generator, shape, *params) -> torch.Tensor:
    """``fn`` (``torch.rand``/``torch.randn``) at the broadcast of ``shape``
    and the parameter shapes, on the generator's device."""
    shape = torch.broadcast_shapes(tuple(shape), param_shape(*params))
    return fn(shape, generator=generator, dtype=param_dtype(*params),
              device=generator.device)


@dist_dataclass
class Normal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, x):
        x = as_float(x)
        loc, scale = as_param(self.loc, x), as_param(self.scale, x)
        z = (x - loc) / scale
        logp = -0.5 * (z * z + LOG2PI) - torch.log(scale)
        return self._mask_support(x, logp)

    def sample(self, generator, shape=()):
        z = _draw(torch.randn, generator, shape, self.loc, self.scale)
        return as_param(self.loc, z) + as_param(self.scale, z) * z

    def cdf(self, x):
        x = as_float(x)
        return torch.special.ndtr((x - as_param(self.loc, x)) / as_param(self.scale, x))

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.loc, q) + as_param(self.scale, q) * torch.special.ndtri(q)

    def mean(self):
        return torch.as_tensor(self.loc, dtype=param_dtype(self.loc, self.scale))

    def variance(self):
        return torch.as_tensor(self.scale, dtype=param_dtype(self.loc, self.scale)) ** 2

    def entropy(self):
        s = torch.as_tensor(self.scale, dtype=param_dtype(self.loc, self.scale))
        return 0.5 * (1.0 + LOG2PI) + torch.log(s)


@dist_dataclass
class Uniform(Distribution):
    low: object = 0.0
    high: object = 1.0

    def support(self):
        return (self.low, self.high)

    def log_prob(self, x):
        x = as_float(x)
        width = as_param(self.high, x) - as_param(self.low, x)
        logp = torch.broadcast_to(-torch.log(width), x.shape)
        return self._mask_support(x, logp)

    def sample(self, generator, shape=()):
        u = _draw(torch.rand, generator, shape, self.low, self.high)
        lo, hi = as_param(self.low, u), as_param(self.high, u)
        return lo + (hi - lo) * u

    def cdf(self, x):
        x = as_float(x)
        lo, hi = as_param(self.low, x), as_param(self.high, x)
        return torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)

    def icdf(self, q):
        q = as_float(q)
        lo, hi = as_param(self.low, q), as_param(self.high, q)
        return lo + (hi - lo) * q

    def mean(self):
        dt = param_dtype(self.low, self.high)
        return 0.5 * (torch.as_tensor(self.low, dtype=dt) + torch.as_tensor(self.high, dtype=dt))

    def variance(self):
        dt = param_dtype(self.low, self.high)
        return (torch.as_tensor(self.high, dtype=dt) - torch.as_tensor(self.low, dtype=dt)) ** 2 / 12.0


@dist_dataclass
class LogUniform(Distribution):
    """Normalized 1/x density on [low, high]: the "scale" ignorance prior."""

    low: object = 1e-3
    high: object = 1e3

    def support(self):
        return (self.low, self.high)

    def _logs(self, ref):
        return torch.log(as_param(self.low, ref)), torch.log(as_param(self.high, ref))

    def log_prob(self, x):
        x = as_float(x)
        llo, lhi = self._logs(x)
        safe_x = torch.where(x > 0, x, torch.ones_like(x))
        logp = -torch.log(safe_x) - torch.log(lhi - llo)
        return self._mask_support(x, logp)

    def sample(self, generator, shape=()):
        u = _draw(torch.rand, generator, shape, self.low, self.high)
        llo, lhi = self._logs(u)
        return torch.exp(llo + u * (lhi - llo))

    def cdf(self, x):
        x = as_float(x)
        llo, lhi = self._logs(x)
        x = torch.clamp(x, as_param(self.low, x), as_param(self.high, x))
        return (torch.log(x) - llo) / (lhi - llo)

    def icdf(self, q):
        q = as_float(q)
        llo, lhi = self._logs(q)
        return torch.exp(llo + q * (lhi - llo))


@dist_dataclass
class Cauchy(Distribution):
    """Cauchy(loc, scale): the crude domain-sampling distribution."""

    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, x):
        x = as_float(x)
        s = as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / s
        logp = -_LOGPI - torch.log(s) - torch.log1p(z * z)
        return self._mask_support(x, logp)

    def sample(self, generator, shape=()):
        u = _draw(torch.rand, generator, shape, self.loc, self.scale)
        return self.icdf(1e-7 + (1.0 - 2e-7) * u)

    def cdf(self, x):
        x = as_float(x)
        z = (x - as_param(self.loc, x)) / as_param(self.scale, x)
        return 0.5 + torch.atan(z) / math.pi

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.loc, q) + as_param(self.scale, q) * torch.tan(math.pi * (q - 0.5))
