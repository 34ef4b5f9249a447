"""Distribution base type (port of ``bayesianinference_tpu.dists.base``).

Conventions
-----------
* Distributions are frozen dataclasses whose parameters are Python numbers
  or tensors.
* ``log_prob(x)``: ``x`` has shape ``batch + event_shape``; the result has
  shape ``batch``, on ``x``'s device.  Out-of-support points return the
  finite log-zero sentinel, never NaN.
* ``sample(generator, shape=())`` returns ``shape + event_shape`` on the
  generator's device, in the parameters' dtype (the default dtype when
  every parameter is a Python number).
* ``support()`` gives box bounds ``(low, high)``.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Tuple

import torch

from ..core.numerics import log_zero

__all__ = ["Distribution", "dist_dataclass", "bisect_icdf", "as_param", "param_dtype", "tensor_leaves",
           "with_leaves"]


def dist_dataclass(cls):
    """Decorator: frozen dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


def as_param(p, ref: torch.Tensor) -> torch.Tensor:
    """A parameter as a tensor on ``ref``'s device, in ``ref``'s dtype when
    it was a Python number.  A number is filled in on the device: copying
    it from the host would wait for the device's queue to drain."""
    if isinstance(p, torch.Tensor):
        return p.to(device=ref.device)
    if isinstance(p, numbers.Number):
        return torch.full((), p, dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(p, dtype=ref.dtype, device=ref.device)


def param_dtype(*params) -> torch.dtype:
    """dtype of the first floating tensor parameter, else the default."""
    for p in params:
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            return p.dtype
    return torch.get_default_dtype()


def draw_device(generator, *params) -> torch.device:
    """Where a draw is made: the generator's device, or with ``generator``
    None (the stages of a study mapped by ``torch.func.vmap``, which draw
    from the default generator) the first tensor parameter's device, else
    the CPU."""
    if generator is not None:
        return generator.device
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def param_shape(*params) -> torch.Size:
    return torch.broadcast_shapes(
        *(p.shape if isinstance(p, torch.Tensor) else () for p in params)
    )


def tensor_leaves(obj, path=()):
    """(path, tensor) of every tensor in a distribution: its dataclass
    fields, nested distributions and tuples of them, in field order.  The
    port's distributions are frozen dataclasses, not pytrees; this walk and
    :func:`with_leaves` stand in for ``jax.tree_util``'s flatten and
    unflatten."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensor_leaves(getattr(obj, f.name), path + (f.name,))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from tensor_leaves(v, path + (i,))


def with_leaves(obj, values: dict):
    """``obj`` with the tensor at each path of ``values`` replaced."""
    if () in values:
        return values[()]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changed = {}
        for f in dataclasses.fields(obj):
            sub = {p[1:]: v for p, v in values.items() if p[0] == f.name}
            if sub:
                changed[f.name] = with_leaves(getattr(obj, f.name), sub)
        return dataclasses.replace(obj, **changed)
    if isinstance(obj, (tuple, list)):
        return type(obj)(with_leaves(v, {p[1:]: w for p, w in values.items() if p[0] == i})
                         if any(p[0] == i for p in values) else v for i, v in enumerate(obj))
    return obj


class Distribution:
    """Abstract base."""

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def event_dim(self) -> int:
        n = 1
        for s in self.event_shape:
            n *= s
        return n

    def log_prob(self, x) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        raise NotImplementedError

    def support(self):
        """Box support (low, high); defaults to all of R^event."""
        inf = float("inf")
        if self.event_shape == ():
            return (-inf, inf)
        return (
            torch.full(self.event_shape, -inf),
            torch.full(self.event_shape, inf),
        )

    def cdf(self, x) -> torch.Tensor:
        raise NotImplementedError(f"cdf not implemented for {type(self).__name__}")

    def icdf(self, q) -> torch.Tensor:
        low, high = self.support()
        return bisect_icdf(self.cdf, q, low, high)

    def quantile(self, q) -> torch.Tensor:
        return self.icdf(q)

    def mean(self) -> torch.Tensor:
        raise NotImplementedError

    def variance(self) -> torch.Tensor:
        raise NotImplementedError

    def std(self) -> torch.Tensor:
        return torch.sqrt(self.variance())

    def _mask_support(self, x: torch.Tensor, logp: torch.Tensor) -> torch.Tensor:
        """Map out-of-support points and non-finite densities to log-zero."""
        low, high = self.support()
        low, high = as_param(low, x), as_param(high, x)
        ok = (x >= low) & (x <= high)
        if self.event_shape:
            ok = ok.reshape(x.shape).all(dim=tuple(range(-len(self.event_shape), 0)))
        lz = log_zero(logp.dtype)
        return torch.where(ok & torch.isfinite(logp), logp, torch.full_like(logp, lz))


def bisect_icdf(cdf_fn, q, low, high, n_iter: int = 80) -> torch.Tensor:
    """Quantile by bisection on a monotone CDF (vmap-safe fixed loop)."""
    q = torch.as_tensor(q)
    if not q.is_floating_point():
        q = q.to(torch.get_default_dtype())
    lo0 = as_param(low, q)
    hi0 = as_param(high, q)
    lo0 = torch.where(torch.isfinite(lo0), lo0, torch.full_like(lo0, -1e10))
    hi0 = torch.where(torch.isfinite(hi0), hi0, torch.full_like(hi0, 1e10))
    lo = torch.broadcast_to(lo0, q.shape).to(q.dtype)
    hi = torch.broadcast_to(hi0, q.shape).to(q.dtype)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        below = cdf_fn(mid) < q
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
