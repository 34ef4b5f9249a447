"""Box-constraint bijections to unconstrained coordinates (port of
``bayesianinference_tpu.core.transforms``).

The samplers that move in unconstrained space (HMC, the ensemble) map a
box onto R^d and add the log-Jacobian to the density:

  two-sided   x = lo + (hi-lo) * sigmoid(z)     log|dx/dz| = log(hi-lo) + log sig(z) + log sig(-z)
  lower only  x = lo + softplus(z)              log|dx/dz| = log sig(z)
  upper only  x = hi - softplus(z)              log|dx/dz| = log sig(z)
  unbounded   x = z                             log|dx/dz| = 0

All three callables work elementwise over [..., d].  ``softplus`` is
``logaddexp(z, 0)``, as ``jax.nn.softplus``; ``torch.nn.functional.softplus``
switches to the identity above z = 20 and would differ in the last digits.
The Laplace engine keeps its own copy of the JAX Laplace's bijection
(``engines/laplace.py::_Box``, a fixed 1e-9 nudge); this one nudges by
``max(eps, 1e-9)`` of its dtype, so a float32 boundary point stays finite.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["BoxBijection", "box_bijection"]


class BoxBijection(NamedTuple):
    """(to_x, to_z, log_jacobian): unconstrained z <-> box-interior x."""

    to_x: Callable  # z -> x strictly inside the box
    to_z: Callable  # x -> z (inverse; boundary values are nudged inward)
    log_jacobian: Callable  # z [..., d] -> [...] sum_i log |dx_i/dz_i|


def _softplus(z: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(z, torch.zeros_like(z))


def box_bijection(lower, upper) -> BoxBijection:
    lower = torch.as_tensor(lower)
    upper = torch.as_tensor(upper, device=lower.device)
    dtype = lower.dtype if lower.is_floating_point() else torch.get_default_dtype()
    lower, upper = lower.to(dtype), upper.to(dtype)
    f_lo = torch.isfinite(lower)
    f_hi = torch.isfinite(upper)
    both = f_lo & f_hi
    lo_s = torch.where(f_lo, lower, torch.zeros_like(lower))
    hi_s = torch.where(f_hi, upper, torch.ones_like(upper))
    pinned = both & (hi_s - lo_s <= 0)  # lo == hi: a fixed parameter
    width = torch.where(both & ~pinned, hi_s - lo_s, torch.ones_like(lower))
    # the clip bound must survive the arithmetic in this dtype: 1 - 1e-9 is
    # 1.0 in float32, which would map a boundary x to z = +-inf
    eps = max(torch.finfo(dtype).eps, 1e-9)

    def to_x(z):
        x_both = lo_s + width * torch.sigmoid(z)
        x_lo = lo_s + _softplus(z)
        x_hi = hi_s - _softplus(z)
        out = torch.where(both, x_both, torch.where(f_lo, x_lo, torch.where(f_hi, x_hi, z)))
        return torch.where(pinned, lo_s, out)

    def _sp_inv(y):
        y = torch.clamp(y, min=eps)
        return y + torch.log1p(-torch.exp(-y))

    def to_z(x):
        x = torch.as_tensor(x, dtype=dtype, device=lower.device)
        frac = torch.clamp((x - lo_s) / width, eps, 1.0 - eps)
        z_both = torch.log(frac) - torch.log1p(-frac)
        z_lo = _sp_inv(torch.clamp(x - lo_s, min=eps))
        z_hi = _sp_inv(torch.clamp(hi_s - x, min=eps))
        return torch.where(both, z_both, torch.where(f_lo, z_lo, torch.where(f_hi, z_hi, x)))

    def log_jacobian(z):
        z = torch.as_tensor(z, dtype=dtype, device=lower.device)
        # log sigmoid(z) = -softplus(-z)
        lj_both = torch.log(width) - _softplus(-z) - _softplus(z)
        lj_one = -_softplus(-z)
        lj = torch.where(both, lj_both, torch.where(f_lo | f_hi, lj_one, torch.zeros_like(z)))
        # a pinned parameter adds no volume; zero keeps the density finite
        lj = torch.where(pinned, torch.zeros_like(z), lj)
        return lj.sum(dim=-1)

    return BoxBijection(to_x=to_x, to_z=to_z, log_jacobian=log_jacobian)
