"""Distribution combinators (port of
``bayesianinference_tpu.dists.combinators``): ``Product``, ``Truncated``,
``Censored``, ``Mixture``, ``HeterogeneousMixture``, ``ImproperUniform``
and ``ConditionalProduct``.

The mixtures' ``sample`` takes its random numbers as inputs where a run
must replay another's: the component indices, and the draws of the picked
components (``Mixture``: keyword draws of the component's own ``sample``;
``HeterogeneousMixture``: every component's draws, which it picks from)."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import torch

from ..core.numerics import as_float, log_zero, logsumexp, safe_log
from .base import Distribution, as_param, dist_dataclass, param_dtype
from .pointwise import _tensor_fields

__all__ = ["Product", "Truncated", "Censored", "Mixture", "HeterogeneousMixture", "ImproperUniform",
           "ConditionalProduct"]


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
class Censored(Distribution):
    """Interval-censored observation of a scalar base distribution:
    Y = clip(X, low, high) with X ~ base (the Tobit observation model).
    The tail mass piles onto the bounds:

        log p(y) = log F(low)          at y == low
                   base.log_prob(y)    for low < y < high
                   log (1 - F(high))   at y == high

    and points outside [low, high] get the sentinel.  Observations at a
    bound must be passed as the bound's value."""

    base: Distribution
    low: object = -float("inf")
    high: object = float("inf")

    def support(self):
        return (self.low, self.high)

    def log_prob(self, x):
        x = as_float(x)
        lo, hi = as_param(self.low, x), as_param(self.high, x)
        interior = self.base.log_prob(x)
        # the CDF probes at infinite bounds would give NaN: probe 0 there
        lo_safe = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
        hi_safe = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
        log_mass_lo = safe_log(self.base.cdf(lo_safe))
        log_mass_hi = safe_log(1.0 - self.base.cdf(hi_safe))
        logp = torch.where(torch.isfinite(lo) & (x <= lo), log_mass_lo,
                           torch.where(torch.isfinite(hi) & (x >= hi), log_mass_hi, interior))
        return self._mask_support(x, logp)

    def sample(self, generator, shape=()):
        s = self.base.sample(generator, shape)
        return torch.minimum(torch.maximum(s, as_param(self.low, s)), as_param(self.high, s))

    def cdf(self, x):
        x = as_float(x)
        c = self.base.cdf(x)
        c = torch.where(x < as_param(self.low, x), torch.zeros_like(c), c)
        return torch.where(x >= as_param(self.high, x), torch.ones_like(c), c)


def _categorical_indices(generator, log_weights, n: int) -> torch.Tensor:
    """``n`` component indices drawn by normalized weight."""
    return torch.multinomial(torch.exp(log_weights), n, replacement=True, generator=generator)


@dist_dataclass
class Mixture(Distribution):
    """Mixture with stacked same-family components: ``component`` is a
    distribution whose tensor parameters carry a leading mixture axis of
    size S, ``log_weights`` has shape [S].  The posterior-predictive object
    of ``results.posterior.predictive_distribution``."""

    log_weights: torch.Tensor  # [S]
    component: Distribution  # parameters [S, ...]

    @property
    def num_components(self) -> int:
        return self.log_weights.shape[-1]

    @property
    def event_shape(self):
        return self.component.event_shape

    def _norm_logw(self) -> torch.Tensor:
        lw = as_float(self.log_weights)
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = as_float(x)
        comp_lp = self.component.log_prob(x.unsqueeze(-1 - len(self.event_shape)))  # [..., S]
        return logsumexp(self._norm_logw() + comp_lp, dim=-1)

    def sample(self, generator, shape=(), *, indices=None, draws=None):
        """``indices`` [n] (n the size of ``shape``, 1 for ``()``) replace
        the weighted choice of components; ``draws`` is a dict of keyword
        draws for the picked components' ``sample`` (one per index, e.g.
        ``{"uniforms": u}`` for a ``Laplace`` component)."""
        shape = tuple(shape)
        n = math.prod(shape) if shape else 1
        if indices is None:
            indices = _categorical_indices(generator, self._norm_logw(), n)
        comp = self.component
        idx = torch.as_tensor(indices, device=getattr(comp, _tensor_fields(comp)[0]).device)
        picked = dataclasses.replace(comp, **{f: getattr(comp, f)[idx] for f in _tensor_fields(comp)
                                             if getattr(comp, f).dim() > 0})
        out = picked.sample(generator, **(draws or {}))
        return out.reshape(shape + tuple(self.event_shape)) if shape else out[0]

    def cdf(self, x):
        x = as_float(x)
        w = torch.exp(self._norm_logw())
        return torch.sum(w * self.component.cdf(x.unsqueeze(-1)), dim=-1)

    def _weights_over_events(self):
        w = torch.exp(self._norm_logw())
        return w.reshape(w.shape + (1,) * len(self.event_shape))

    def mean(self):
        m = torch.as_tensor(self.component.mean())
        if self.event_shape:
            return torch.sum(self._weights_over_events() * m, dim=0)
        return torch.sum(torch.exp(self._norm_logw()) * m, dim=-1)

    def variance(self):
        m = as_float(self.component.mean())
        v = as_float(self.component.variance())
        if self.event_shape:
            w = self._weights_over_events()
            return torch.sum(w * (v + m**2), dim=0) - torch.sum(w * m, dim=0) ** 2
        w = torch.exp(self._norm_logw())
        return torch.sum(w * (v + m**2), dim=-1) - torch.sum(w * m, dim=-1) ** 2


@dist_dataclass
class HeterogeneousMixture(Distribution):
    """Finite mixture over a tuple of components of any families (a
    Student-t and a Normal, say) that share one event shape; ``log_weights``
    [S] match ``len(components)`` and are normalized here.  ``Mixture`` is
    the batched same-family form."""

    log_weights: torch.Tensor  # [S]
    components: Tuple[Distribution, ...]

    def __post_init__(self):
        comps = tuple(self.components)
        object.__setattr__(self, "components", comps)
        if not comps:
            raise ValueError("HeterogeneousMixture needs >= 1 component")
        shapes = {c.event_shape for c in comps}
        if len(shapes) > 1:
            raise ValueError(f"components must share an event shape; got {shapes}")

    @property
    def num_components(self) -> int:
        return len(self.components)

    @property
    def event_shape(self):
        return self.components[0].event_shape

    def _norm_logw(self) -> torch.Tensor:
        lw = as_float(self.log_weights)
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = as_float(x)
        lp = torch.stack([c.log_prob(x) for c in self.components], dim=-1)
        return logsumexp(self._norm_logw() + lp, dim=-1)

    def sample(self, generator, shape=(), *, indices=None, draws=None):
        """Every component draws n points (n the size of ``shape``, 1 for
        ``()``), then each point takes the draw of its picked component:
        ``indices`` [n] and ``draws`` [S, n, *event] replace the generator's."""
        shape = tuple(shape)
        n = math.prod(shape) if shape else 1
        if indices is None:
            indices = _categorical_indices(generator, self._norm_logw(), n)
        if draws is None:
            draws = torch.stack([c.sample(generator, (n,)) for c in self.components])
        draws = as_float(draws)
        idx = torch.as_tensor(indices, device=draws.device)
        out = draws[idx, torch.arange(n, device=draws.device)]
        return out.reshape(shape + tuple(self.event_shape)) if shape else out[0]

    def cdf(self, x):
        x = as_float(x)
        w = torch.exp(self._norm_logw())
        return torch.sum(w * torch.stack([c.cdf(x) for c in self.components], dim=-1), dim=-1)

    def _stacked(self, what, like):
        return torch.stack([as_float(getattr(c, what)()).to(like) for c in self.components])

    def mean(self):
        w = torch.exp(self._norm_logw())
        return torch.tensordot(w, self._stacked("mean", w), dims=([0], [0]))

    def variance(self):
        w = torch.exp(self._norm_logw())
        means, variances = self._stacked("mean", w), self._stacked("variance", w)
        mu = torch.tensordot(w, means, dims=([0], [0]))
        return torch.tensordot(w, variances + means**2, dims=([0], [0])) - mu**2

    def support(self):
        lows, highs = zip(*(c.support() for c in self.components))
        dt = param_dtype(*lows, *highs)
        return (torch.amin(torch.stack([torch.as_tensor(lo, dtype=dt) for lo in lows]), dim=0),
                torch.amax(torch.stack([torch.as_tensor(hi, dtype=dt) for hi in highs]), dim=0))


class ConditionalProduct:
    """Joint distribution over named variables in dependency order.

    Nodes are ``(name, builder)`` pairs in topological order; a builder maps
    the dict of the values drawn or given so far to a
    :class:`Distribution` (or is a distribution itself).  ``log_prob`` sums
    the nodes' densities over a value dict; ``sample`` draws ancestrally, in
    node order, from the one generator."""

    def __init__(self, nodes: Sequence[Tuple[str, Callable]]):
        self.nodes = list(nodes)
        names = [n for n, _ in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate variable names in ConditionalProduct")
        self.names = names

    def log_prob(self, values: dict):
        total, known = 0.0, {}
        for name, builder in self.nodes:
            dist = builder(known) if callable(builder) else builder
            total = total + dist.log_prob(values[name])
            known[name] = values[name]
        return total

    def sample(self, generator: torch.Generator, shape=()) -> dict:
        out = {}
        for name, builder in self.nodes:
            dist = builder(out) if callable(builder) else builder
            out[name] = dist.sample(generator, shape)
        return out

    def graph(self):
        """Edge list (parent -> child), found by recording which values each
        builder reads."""
        edges = []
        for name, builder in self.nodes:
            if not callable(builder):
                continue
            accessed = []

            class _Probe(dict):
                def __getitem__(probe, k):  # noqa: N805
                    accessed.append(k)
                    return torch.zeros(())

            try:
                builder(_Probe({n: torch.zeros(()) for n in self.names}))
            except Exception:  # a builder may reject the probe's zeros after reading what it needs
                pass
            edges.extend((p, name) for p in accessed)
        return edges


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
