"""Scalar distribution families (port of
``bayesianinference_tpu.dists.scalar``: all 24 families).

Gamma variates come from ``multivariate._standard_gamma`` (Marsaglia and
Tsang on the caller's generator); Poisson and binomial variates from
``torch.poisson`` and ``torch.binomial`` on it.  The families sampled by
their inverse CDF (``Laplace``, ``HalfCauchy``, ``Weibull``, ``Logistic``,
``Pareto``, ``Geometric``) take their U[0, 1) draws as ``uniforms=``,
``Exponential`` and ``Gumbel`` their standard draws as ``exponentials=``
and ``gumbels=``, so that a run can replay another's numbers.  ``Beta``
and ``StudentT`` CDFs go through the port's own ``core.numerics.betainc``."""

from __future__ import annotations

import math

import torch

from ..core.numerics import LOG2PI, as_float, betainc, log_zero, ndtr, xlogy
from .base import Distribution, as_param, dist_dataclass, draw_device, param_dtype, param_shape

__all__ = [
    "Normal", "Uniform", "LogUniform", "Exponential", "Gamma", "InverseGamma", "Beta", "StudentT",
    "Cauchy", "HalfCauchy", "LogNormal", "Laplace", "Poisson", "Bernoulli", "Binomial", "Weibull",
    "Logistic", "ChiSquared", "Gumbel", "Pareto", "NegativeBinomial", "Geometric", "BernoulliLogits",
    "Categorical",
]

_LOGPI = 1.1447298858494002


def _draw(fn, generator: torch.Generator, shape, *params) -> torch.Tensor:
    """``fn`` (``torch.rand``/``torch.randn``) at the broadcast of ``shape``
    and the parameter shapes, on the generator's device (``draw_device``)."""
    shape = torch.broadcast_shapes(tuple(shape), param_shape(*params))
    return fn(shape, generator=generator, dtype=param_dtype(*params),
              device=draw_device(generator, *params))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in full, as ``jax.nn.softplus``: torch's softplus
    returns x itself above 20 (7.6e-10 off at 21)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _given_or_drawn(draws, fn, generator, shape, *params) -> torch.Tensor:
    """``draws`` (given, in the parameters' dtype) or ``_draw(fn, ...)``."""
    if draws is None:
        return _draw(fn, generator, shape, *params)
    return as_float(draws).to(param_dtype(*params))


def _uniform_on(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """U[0, 1) draws mapped onto [low, high) as ``jax.random.uniform``
    maps them (an affine map, then at least ``low``)."""
    return torch.clamp(u * (high - low) + low, min=low)


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
        return ndtr((x - as_param(self.loc, x)) / as_param(self.scale, x))

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


@dist_dataclass
class LogNormal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        mu, s = as_param(self.loc, x), as_param(self.scale, x)
        safe_x = torch.where(x > 0, x, torch.ones_like(x))
        z = (torch.log(safe_x) - mu) / s
        logp = -0.5 * (z * z + LOG2PI) - torch.log(s) - torch.log(safe_x)
        # open support: the density at x = 0 is 0
        logp = self._mask_support(x, logp)
        return torch.where(x > 0, logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        z = _draw(torch.randn, generator, shape, self.loc, self.scale)
        return torch.exp(as_param(self.loc, z) + as_param(self.scale, z) * z)

    def cdf(self, x):
        x = as_float(x)
        safe_x = torch.where(x > 0, x, torch.ones_like(x))
        c = ndtr((torch.log(safe_x) - as_param(self.loc, x)) / as_param(self.scale, x))
        return torch.where(x > 0, c, torch.zeros_like(c))

    def icdf(self, q):
        q = as_float(q)
        return torch.exp(as_param(self.loc, q) + as_param(self.scale, q) * torch.special.ndtri(q))

    def mean(self):
        dt = param_dtype(self.loc, self.scale)
        loc, s = torch.as_tensor(self.loc, dtype=dt), torch.as_tensor(self.scale, dtype=dt)
        return torch.exp(loc + 0.5 * s**2)

    def variance(self):
        dt = param_dtype(self.loc, self.scale)
        loc, s2 = torch.as_tensor(self.loc, dtype=dt), torch.as_tensor(self.scale, dtype=dt) ** 2
        return torch.expm1(s2) * torch.exp(2.0 * loc + s2)


@dist_dataclass
class Bernoulli(Distribution):
    """Bernoulli over {0, 1} with probability ``p``."""

    p: object = 0.5

    def support(self):
        return (0.0, 1.0)

    def log_prob(self, x):
        x = as_float(x)
        p = as_param(self.p, x)
        logp = xlogy(x, p) + xlogy(1.0 - x, 1.0 - p)
        valid = (x == 0) | (x == 1)
        return torch.where(valid & torch.isfinite(logp), logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        u = _draw(torch.rand, generator, shape, self.p)
        return (u < as_param(self.p, u)).to(u.dtype)

    def mean(self):
        return torch.as_tensor(self.p, dtype=param_dtype(self.p))

    def variance(self):
        p = torch.as_tensor(self.p, dtype=param_dtype(self.p))
        return p * (1.0 - p)


@dist_dataclass
class BernoulliLogits(Distribution):
    """Bernoulli parameterized by logits, through the stable log-sigmoid
    forms log sigma(l) = -softplus(-l), log(1 - sigma(l)) = -softplus(l)."""

    logits: object = 0.0

    def support(self):
        return (0.0, 1.0)

    def log_prob(self, x):
        x = as_float(x)
        lg = as_param(self.logits, x)
        logp = -x * _softplus(-lg) - (1.0 - x) * _softplus(lg)
        valid = (x == 0) | (x == 1)
        return torch.where(valid, logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        u = _draw(torch.rand, generator, shape, self.logits)
        return (u < torch.sigmoid(as_param(self.logits, u))).to(u.dtype)

    def mean(self):
        return torch.sigmoid(torch.as_tensor(self.logits, dtype=param_dtype(self.logits)))


def _gamma_draw(generator: torch.Generator, shape, alpha, *params) -> torch.Tensor:
    """Gamma(alpha, 1) draws at the broadcast of ``shape`` and the parameter
    shapes, on the generator's device (``draw_device``)."""
    from .multivariate import _standard_gamma  # multivariate imports this module

    full = torch.broadcast_shapes(tuple(shape), param_shape(alpha, *params))
    a = torch.as_tensor(alpha, dtype=param_dtype(alpha, *params), device=draw_device(generator, alpha, *params))
    return _standard_gamma(generator, a.expand(full).contiguous())


def _open_support(x, logp):
    """The sentinel at and beyond the boundary x = 0 of an open support."""
    return torch.where(x > 0, logp, torch.full_like(logp, log_zero(logp.dtype)))


def _nan_unless(ok, value):
    return torch.where(ok, value, torch.full_like(value, math.nan))


@dist_dataclass
class Gamma(Distribution):
    """Gamma(shape a, rate b): p(x) = b^a x^(a-1) e^(-bx) / Gamma(a)."""

    a: object = 1.0
    rate: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        a, b = as_param(self.a, x), as_param(self.rate, x)
        safe_x = torch.where(x > 0, x, torch.ones_like(x))
        logp = a * torch.log(b) + (a - 1.0) * torch.log(safe_x) - b * x - torch.lgamma(a)
        return _open_support(x, self._mask_support(x, logp))

    def sample(self, generator, shape=()):
        g = _gamma_draw(generator, shape, self.a, self.rate)
        return g / as_param(self.rate, g)

    def cdf(self, x):
        x = as_float(x)
        return torch.special.gammainc(as_param(self.a, x), as_param(self.rate, x) * torch.clamp(x, min=0.0))

    def mean(self):
        dt = param_dtype(self.a, self.rate)
        return torch.as_tensor(self.a, dtype=dt) / torch.as_tensor(self.rate, dtype=dt)

    def variance(self):
        dt = param_dtype(self.a, self.rate)
        return torch.as_tensor(self.a, dtype=dt) / torch.as_tensor(self.rate, dtype=dt) ** 2


@dist_dataclass
class InverseGamma(Distribution):
    """InverseGamma(a, b): p(x) = b^a x^(-a-1) e^(-b/x) / Gamma(a), the
    error variance of conjugate regression."""

    a: object = 1.0
    b: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        a, b = as_param(self.a, x), as_param(self.b, x)
        safe_x = torch.where(x > 0, x, torch.ones_like(x))
        logp = a * torch.log(b) - (a + 1.0) * torch.log(safe_x) - b / safe_x - torch.lgamma(a)
        return _open_support(x, self._mask_support(x, logp))

    def sample(self, generator, shape=()):
        g = _gamma_draw(generator, shape, self.a, self.b)
        return as_param(self.b, g) / g

    def cdf(self, x):
        x = as_float(x)
        safe_x = torch.where(x > 0, x, torch.ones_like(x))
        c = torch.special.gammaincc(as_param(self.a, x), as_param(self.b, x) / safe_x)
        return torch.where(x > 0, c, torch.zeros_like(c))

    def _ab(self):
        dt = param_dtype(self.a, self.b)
        return torch.as_tensor(self.a, dtype=dt), torch.as_tensor(self.b, dtype=dt)

    def mean(self):
        a, b = self._ab()
        return _nan_unless(a > 1, b / (a - 1.0))

    def variance(self):
        a, b = self._ab()
        return _nan_unless(a > 2, b**2 / ((a - 1.0) ** 2 * (a - 2.0)))


@dist_dataclass
class Beta(Distribution):
    a: object = 1.0
    b: object = 1.0

    def support(self):
        return (0.0, 1.0)

    def log_prob(self, x):
        x = as_float(x)
        a, b = as_param(self.a, x), as_param(self.b, x)
        sx = torch.clamp(x, 1e-38, 1.0 - 1e-7)
        logp = (a - 1.0) * torch.log(sx) + (b - 1.0) * torch.log1p(-sx) - (
            torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))
        # open on both ends: the density at 0 and 1 is 0 or infinite
        inside = (x > 0) & (x < 1)
        return torch.where(inside, self._mask_support(x, logp), torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        ga = _gamma_draw(generator, shape, self.a, self.b)
        gb = _gamma_draw(generator, ga.shape, self.b, self.a)
        return ga / (ga + gb)

    def cdf(self, x):
        x = as_float(x)
        return betainc(as_param(self.a, x), as_param(self.b, x), torch.clamp(x, 0.0, 1.0))

    def _ab(self):
        dt = param_dtype(self.a, self.b)
        return torch.as_tensor(self.a, dtype=dt), torch.as_tensor(self.b, dtype=dt)

    def mean(self):
        a, b = self._ab()
        return a / (a + b)

    def variance(self):
        a, b = self._ab()
        return a * b / ((a + b) ** 2 * (a + b + 1.0))


@dist_dataclass
class StudentT(Distribution):
    """StudentT(df, loc, scale): the predictive of conjugate regression."""

    df: object = 1.0
    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, x):
        x = as_float(x)
        v, loc, s = as_param(self.df, x), as_param(self.loc, x), as_param(self.scale, x)
        z = (x - loc) / s
        logp = (torch.lgamma(0.5 * (v + 1.0)) - torch.lgamma(0.5 * v) - 0.5 * torch.log(v) - 0.5 * _LOGPI
                - torch.log(s) - 0.5 * (v + 1.0) * torch.log1p(z * z / v))
        return self._mask_support(x, logp)

    def sample(self, generator, shape=()):
        z = _draw(torch.randn, generator, shape, self.df, self.loc, self.scale)
        v = as_param(self.df, z)
        chi2 = 2.0 * _gamma_draw(generator, z.shape, 0.5 * v)
        return as_param(self.loc, z) + as_param(self.scale, z) * z * torch.sqrt(v / chi2)

    def cdf(self, x):
        """0.5 I_w(v/2, 1/2) with w = v / (v + z^2), mirrored for z >= 0."""
        x = as_float(x)
        v = as_param(self.df, x)
        z = (x - as_param(self.loc, x)) / as_param(self.scale, x)
        tail = 0.5 * betainc(0.5 * v, torch.full_like(v, 0.5), v / (v + z * z))
        return torch.where(z >= 0, 1.0 - tail, tail)

    def _params(self):
        dt = param_dtype(self.df, self.loc, self.scale)
        return (torch.as_tensor(p, dtype=dt) for p in (self.df, self.loc, self.scale))

    def mean(self):
        v, loc, _ = self._params()
        return _nan_unless(v > 1, loc * torch.ones_like(v))

    def variance(self):
        v, _, s = self._params()
        return _nan_unless(v > 2, s**2 * v / (v - 2.0))


def _tensors(*params):
    """The parameters as tensors in their common dtype (for the moments)."""
    dt = param_dtype(*params)
    return [torch.as_tensor(q, dtype=dt) for q in params]


def _exponential(shape, *, generator, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).exponential_(generator=generator)


def _integer_mask(x, logp):
    """The sentinel at non-integer x (the discrete families' support)."""
    return torch.where(x == torch.floor(x), logp, torch.full_like(logp, log_zero(logp.dtype)))


@dist_dataclass
class Exponential(Distribution):
    rate: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        rate = as_param(self.rate, x)
        return self._mask_support(x, torch.log(rate) - rate * x)

    def sample(self, generator, shape=(), *, exponentials=None):
        e = _given_or_drawn(exponentials, _exponential, generator, shape, self.rate)
        return e / as_param(self.rate, e)

    def cdf(self, x):
        x = as_float(x)
        return -torch.expm1(-as_param(self.rate, x) * torch.clamp(x, min=0.0))

    def icdf(self, q):
        q = as_float(q)
        return -torch.log1p(-q) / as_param(self.rate, q)

    def mean(self):
        return 1.0 / _tensors(self.rate)[0]

    def variance(self):
        return 1.0 / _tensors(self.rate)[0] ** 2


@dist_dataclass
class HalfCauchy(Distribution):
    scale: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        s = as_param(self.scale, x)
        z = x / s
        return self._mask_support(x, math.log(2.0) - _LOGPI - torch.log(s) - torch.log1p(z * z))

    def sample(self, generator, shape=(), *, uniforms=None):
        return self.icdf(_given_or_drawn(uniforms, torch.rand, generator, shape, self.scale))

    def cdf(self, x):
        x = as_float(x)
        return 2.0 / math.pi * torch.atan(torch.clamp(x, min=0.0) / as_param(self.scale, x))

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.scale, q) * torch.tan(0.5 * math.pi * q)


@dist_dataclass
class Laplace(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, x):
        x = as_float(x)
        s = as_param(self.scale, x)
        return self._mask_support(x, -torch.abs(x - as_param(self.loc, x)) / s - torch.log(2.0 * s))

    def sample(self, generator, shape=(), *, uniforms=None):
        u = _given_or_drawn(uniforms, torch.rand, generator, shape, self.loc, self.scale)
        u = _uniform_on(u, -0.5 + 1e-7, 0.5 - 1e-7)
        return as_param(self.loc, u) - as_param(self.scale, u) * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))

    def cdf(self, x):
        x = as_float(x)
        z = (x - as_param(self.loc, x)) / as_param(self.scale, x)
        return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    def mean(self):
        return _tensors(self.loc, self.scale)[0]

    def variance(self):
        return 2.0 * _tensors(self.loc, self.scale)[1] ** 2


@dist_dataclass
class Poisson(Distribution):
    rate: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        lam = as_param(self.rate, x)
        logp = torch.special.xlogy(x, lam) - lam - torch.lgamma(x + 1.0)
        ok = (x >= 0) & (x == torch.floor(x)) & torch.isfinite(logp)
        return torch.where(ok, logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        full = torch.broadcast_shapes(tuple(shape), param_shape(self.rate))
        lam = torch.as_tensor(self.rate, dtype=param_dtype(self.rate), device=generator.device)
        return torch.poisson(lam.expand(full).contiguous(), generator=generator)

    def mean(self):
        return _tensors(self.rate)[0]

    def variance(self):
        return _tensors(self.rate)[0]


@dist_dataclass
class Binomial(Distribution):
    n: object = 1.0
    p: object = 0.5

    def support(self):
        return (0.0, self.n)

    def log_prob(self, x):
        x = as_float(x)
        n, p = as_param(self.n, x), as_param(self.p, x)
        logp = (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0) - torch.lgamma(n - x + 1.0)
                + xlogy(x, p) + xlogy(n - x, 1.0 - p))
        ok = (x >= 0) & (x <= n) & (x == torch.floor(x)) & torch.isfinite(logp)
        return torch.where(ok, logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        full = torch.broadcast_shapes(tuple(shape), param_shape(self.n, self.p))
        n, p = (torch.as_tensor(q, dtype=param_dtype(self.n, self.p), device=generator.device).expand(full)
                for q in (self.n, self.p))
        return torch.binomial(n.contiguous(), p.contiguous(), generator=generator)

    def mean(self):
        n, p = _tensors(self.n, self.p)
        return n * p

    def variance(self):
        n, p = _tensors(self.n, self.p)
        return n * p * (1.0 - p)


@dist_dataclass
class Weibull(Distribution):
    """Weibull(shape k, scale lam): p(x) = (k/lam)(x/lam)^(k-1) e^-(x/lam)^k."""

    k: object = 1.0
    scale: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        k, lam = as_param(self.k, x), as_param(self.scale, x)
        z = torch.where(x > 0, x, torch.ones_like(x)) / lam
        logp = torch.log(k / lam) + (k - 1.0) * torch.log(z) - z**k
        # open support: the density at x = 0 is 0 or infinite by k
        return _open_support(x, self._mask_support(x, logp))

    def sample(self, generator, shape=(), *, uniforms=None):
        u = _given_or_drawn(uniforms, torch.rand, generator, shape, self.k, self.scale)
        return self.icdf(_uniform_on(u, 1e-12, 1.0 - 1e-12))

    def cdf(self, x):
        x = as_float(x)
        z = torch.clamp(x, min=0.0) / as_param(self.scale, x)
        return -torch.expm1(-(z ** as_param(self.k, x)))

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.scale, q) * (-torch.log1p(-q)) ** (1.0 / as_param(self.k, q))

    def mean(self):
        k, lam = _tensors(self.k, self.scale)
        return lam * torch.exp(torch.lgamma(1.0 + 1.0 / k))

    def variance(self):
        k, lam = _tensors(self.k, self.scale)
        g1, g2 = torch.exp(torch.lgamma(1.0 + 1.0 / k)), torch.exp(torch.lgamma(1.0 + 2.0 / k))
        return lam**2 * (g2 - g1**2)


@dist_dataclass
class Logistic(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, x):
        x = as_float(x)
        s = as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / s
        return self._mask_support(x, -z - 2.0 * _softplus(-z) - torch.log(s))

    def sample(self, generator, shape=(), *, uniforms=None):
        u = _given_or_drawn(uniforms, torch.rand, generator, shape, self.loc, self.scale)
        return self.icdf(_uniform_on(u, 1e-12, 1.0 - 1e-12))

    def cdf(self, x):
        x = as_float(x)
        return torch.sigmoid((x - as_param(self.loc, x)) / as_param(self.scale, x))

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.loc, q) + as_param(self.scale, q) * (torch.log(q) - torch.log1p(-q))

    def mean(self):
        return _tensors(self.loc, self.scale)[0]

    def variance(self):
        return (_tensors(self.loc, self.scale)[1] * math.pi) ** 2 / 3.0


@dist_dataclass
class ChiSquared(Distribution):
    """Chi-squared with ``df`` degrees of freedom: Gamma(df/2, rate 1/2)."""

    df: object = 1.0

    def support(self):
        return (0.0, math.inf)

    def _gamma(self):
        return Gamma(a=0.5 * self.df, rate=0.5)

    def log_prob(self, x):
        return self._gamma().log_prob(x)

    def sample(self, generator, shape=()):
        return self._gamma().sample(generator, shape)

    def cdf(self, x):
        return self._gamma().cdf(x)

    def mean(self):
        return _tensors(self.df)[0]

    def variance(self):
        return 2.0 * _tensors(self.df)[0]


@dist_dataclass
class Gumbel(Distribution):
    """Gumbel (the maximum's extreme-value law) with ``loc`` and ``scale``."""

    loc: object = 0.0
    scale: object = 1.0

    def log_prob(self, x):
        x = as_float(x)
        s = as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / s
        return self._mask_support(x, -(z + torch.exp(-z)) - torch.log(s))

    def sample(self, generator, shape=(), *, gumbels=None):
        if gumbels is None:
            u = _draw(torch.rand, generator, shape, self.loc, self.scale)
            gumbels = -torch.log(-torch.log(_uniform_on(u, torch.finfo(u.dtype).tiny, 1.0)))
        g = as_float(gumbels).to(param_dtype(self.loc, self.scale))
        return as_param(self.loc, g) + as_param(self.scale, g) * g

    def cdf(self, x):
        x = as_float(x)
        z = (x - as_param(self.loc, x)) / as_param(self.scale, x)
        return torch.exp(-torch.exp(-z))

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.loc, q) - as_param(self.scale, q) * torch.log(-torch.log(q))

    def mean(self):
        loc, s = _tensors(self.loc, self.scale)
        return loc + s * 0.5772156649015329

    def variance(self):
        return (math.pi * _tensors(self.loc, self.scale)[1]) ** 2 / 6.0


@dist_dataclass
class Pareto(Distribution):
    """Pareto(xmin, alpha): p(x) = alpha xmin^alpha / x^(alpha + 1), x >= xmin."""

    xmin: object = 1.0
    alpha: object = 1.0

    def support(self):
        return (self.xmin, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        m, a = as_param(self.xmin, x), as_param(self.alpha, x)
        safe = torch.where(x > 0, x, torch.ones_like(x))
        return self._mask_support(x, torch.log(a) + a * torch.log(m) - (a + 1.0) * torch.log(safe))

    def sample(self, generator, shape=(), *, uniforms=None):
        return self.icdf(_given_or_drawn(uniforms, torch.rand, generator, shape, self.xmin, self.alpha))

    def cdf(self, x):
        x = as_float(x)
        m = as_param(self.xmin, x)
        return 1.0 - (m / torch.maximum(x, m)) ** as_param(self.alpha, x)

    def icdf(self, q):
        q = as_float(q)
        return as_param(self.xmin, q) * (1.0 - q) ** (-1.0 / as_param(self.alpha, q))

    def mean(self):
        m, a = _tensors(self.xmin, self.alpha)
        return torch.where(a > 1, a * m / (a - 1.0), torch.full_like(a, math.inf))

    def variance(self):
        m, a = _tensors(self.xmin, self.alpha)
        return torch.where(a > 2, m**2 * a / ((a - 1.0) ** 2 * (a - 2.0)), torch.full_like(a, math.inf))


@dist_dataclass
class NegativeBinomial(Distribution):
    """Failures before the r-th success: P(x) = C(x+r-1, x) p^r (1-p)^x."""

    r: object = 1.0
    p: object = 0.5

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        r, p = as_param(self.r, x), as_param(self.p, x)
        logp = (torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0) + r * torch.log(p)
                + xlogy(x, 1.0 - p))
        return _integer_mask(x, self._mask_support(x, logp))

    def sample(self, generator, shape=()):
        """The gamma-Poisson mixture: lam ~ Gamma(r) (1 - p) / p, x ~ Poisson(lam)."""
        g = _gamma_draw(generator, shape, self.r, self.p)
        p = as_param(self.p, g)
        return torch.poisson(g * (1.0 - p) / p, generator=generator)

    def mean(self):
        r, p = _tensors(self.r, self.p)
        return r * (1.0 - p) / p

    def variance(self):
        r, p = _tensors(self.r, self.p)
        return r * (1.0 - p) / p**2


@dist_dataclass
class Geometric(Distribution):
    """Failures before the first success: P(x) = p (1-p)^x, x = 0, 1, ..."""

    p: object = 0.5

    def support(self):
        return (0.0, math.inf)

    def log_prob(self, x):
        x = as_float(x)
        p = as_param(self.p, x)
        return _integer_mask(x, self._mask_support(x, torch.log(p) + xlogy(x, 1.0 - p)))

    def sample(self, generator, shape=(), *, uniforms=None):
        u = _uniform_on(_given_or_drawn(uniforms, torch.rand, generator, shape, self.p), 1e-12, 1.0)
        return torch.floor(torch.log(u) / torch.log1p(-as_param(self.p, u)))

    def mean(self):
        p = _tensors(self.p)[0]
        return (1.0 - p) / p

    def variance(self):
        p = _tensors(self.p)[0]
        return (1.0 - p) / p**2


@dist_dataclass
class Categorical(Distribution):
    """Categorical over {0, ..., k-1} parameterized by logits [..., k]
    (unnormalized log-probabilities)."""

    logits: object

    def support(self):
        return (0.0, self.logits.shape[-1] - 1.0)

    def log_prob(self, x):
        x = as_float(x)
        lg = as_param(self.logits, x)
        k = lg.shape[-1]
        logp_all = torch.log_softmax(lg, dim=-1)
        batch = torch.broadcast_shapes(x.shape, logp_all.shape[:-1])
        xi = torch.clamp(x.to(torch.int64), 0, k - 1).expand(batch)
        logp = torch.gather(logp_all.expand(*batch, k), -1, xi[..., None])[..., 0]
        valid = (x >= 0) & (x <= k - 1) & (x == torch.floor(x))
        return torch.where(valid & torch.isfinite(logp), logp, torch.full_like(logp, log_zero(logp.dtype)))

    def sample(self, generator, shape=()):
        """Gumbel-max: the argmax of logits plus standard Gumbel noise."""
        lg = torch.as_tensor(self.logits).to(generator.device)
        lg = lg if lg.is_floating_point() else lg.to(torch.get_default_dtype())
        u = torch.rand((*shape, *lg.shape), generator=generator, dtype=lg.dtype, device=generator.device)
        tiny = torch.finfo(lg.dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        return torch.argmax(lg + gumbel, dim=-1).to(lg.dtype)

    def _probs(self):
        return torch.softmax(as_float(self.logits), dim=-1)

    def mean(self):
        p = self._probs()
        i = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
        return torch.sum(p * i, dim=-1)

    def variance(self):
        p = self._probs()
        i = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
        m = torch.sum(p * i, dim=-1)
        return torch.sum(p * i * i, dim=-1) - m * m
