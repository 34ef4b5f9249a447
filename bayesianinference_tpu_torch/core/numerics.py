"""Stable log-space numerics (port of ``bayesianinference_tpu.core.numerics``).

Everything here is a plain function on tensors: it follows the dtype and
device of its inputs and works under ``torch.func.vmap``.  The JAX
package's ``*_precise`` transcendentals exist to correct the TPU's
approximate float32 ``log``/``exp``; off the TPU its own ``auto`` mode
uses the native ops, so the port exposes those names as the native torch
functions.
"""

from __future__ import annotations

import math

import torch

LOG2PI = 1.8378770664093453
"""log(2 pi), the one shared copy."""

__all__ = [
    "LOG2PI",
    "as_float",
    "exp_neg_precise",
    "gammaln_precise",
    "log1p_precise",
    "log_precise",
    "log_zero",
    "is_log_zero",
    "guard_log_density",
    "logsumexp",
    "logaddexp",
    "log1mexp",
    "logsubexp",
    "logmeanexp",
    "ndtr",
    "safe_log",
    "safe_sqrt",
    "xlogx",
    "xlogy",
]

exp_neg_precise = torch.exp
gammaln_precise = torch.lgamma
log1p_precise = torch.log1p
log_precise = torch.log


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF as erfc(-x / sqrt 2) / 2, accurate in the
    lower tail, as ``jax.scipy.special.ndtr`` is.  ``torch.special.ndtr``
    loses it there (8.9e-12 relative at x = -4.71, 1.3e-10 at -6, and 0 for
    7.6e-24 at -10, in float64 on the CPU)."""
    return 0.5 * torch.special.erfc(x * -0.7071067811865476)


def log_zero(dtype: torch.dtype | None = None) -> float:
    """Finite stand-in for log(0): -1e300 in float64, -1e30 otherwise.

    Kept finite so arithmetic on rejected points never makes NaN, while
    :func:`is_log_zero` still recognises it."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return -1e300 if dtype == torch.float64 else -1e30


def as_float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _pair(x, y):
    """Broadcast two operands (tensors or Python numbers) to float tensors
    on the device of the tensor among them."""
    ref = x if isinstance(x, torch.Tensor) else y if isinstance(y, torch.Tensor) else None
    if ref is None:
        return torch.broadcast_tensors(as_float(x), as_float(y))
    dt = torch.result_type(x, y)
    dt = dt if dt.is_floating_point else torch.get_default_dtype()
    x = torch.as_tensor(x, dtype=dt, device=ref.device)
    y = torch.as_tensor(y, dtype=dt, device=ref.device)
    return torch.broadcast_tensors(x, y)


def is_log_zero(x) -> torch.Tensor:
    """True where a log-density is effectively log(0), -inf or NaN."""
    x = as_float(x)
    return torch.logical_not(x > 0.5 * log_zero(x.dtype))


def guard_log_density(x) -> torch.Tensor:
    """Map NaN, -inf and values below the sentinel to the sentinel."""
    x = as_float(x)
    lz = log_zero(x.dtype)
    return torch.where(torch.isfinite(x) & (x > lz), x, torch.full_like(x, lz))


def logsumexp(a, dim=None, b=None, keepdim: bool = False, return_sign: bool = False):
    """Max-shifted log-sum-exp.  An all-log-zero slice returns the sentinel
    instead of NaN; NaN entries count as log-zero."""
    a = as_float(a)
    lz = log_zero(a.dtype)
    a = torch.where(torch.isnan(a), torch.full_like(a, lz), a)
    dims = tuple(range(a.dim())) if dim is None else dim
    if a.dim() == 0:
        amax = a
    else:
        amax = torch.amax(a, dim=dims, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    shifted = torch.exp(a - amax)
    if b is not None:
        shifted = shifted * b
    s = shifted if a.dim() == 0 else torch.sum(shifted, dim=dims, keepdim=True)
    sign = torch.sign(s)
    safe_s = torch.where(s == 0, torch.ones_like(s), torch.abs(s))
    out = torch.where(s == 0, torch.full_like(s, lz), torch.log(safe_s) + amax)
    if not keepdim and a.dim() > 0:
        out = out.squeeze(dims) if dim is not None else out.reshape(())
        sign = sign.squeeze(dims) if dim is not None else sign.reshape(())
    if return_sign:
        return out, sign
    return out


def logaddexp(x, y) -> torch.Tensor:
    """log(e^x + e^y), log-zero aware."""
    x, y = _pair(x, y)
    lo = torch.minimum(x, y)
    hi = torch.maximum(x, y)
    out = hi + torch.log1p(torch.exp(lo - hi))
    return torch.where(torch.isnan(out), hi, out)


def log1mexp(x) -> torch.Tensor:
    """log(1 - e^x) for x <= 0 (Maechler 2012); log-zero for x >= 0."""
    x = as_float(x)
    lz = log_zero(x.dtype)
    log2 = 0.6931471805599453
    a = torch.log(-torch.expm1(torch.clamp(x, max=-1e-12)))
    b = torch.log1p(-torch.exp(x))
    out = torch.where(x > -log2, a, b)
    return torch.where(x >= 0, torch.full_like(out, lz), out)


def logsubexp(y, x) -> torch.Tensor:
    """log(e^y - e^x) for y >= x; log-zero where x >= y."""
    y, x = _pair(y, x)
    out = y + log1mexp(x - y)
    return torch.where(x >= y, torch.full_like(out, log_zero(out.dtype)), out)


def logmeanexp(a, dim=None, keepdim: bool = False) -> torch.Tensor:
    """log(mean(e^a)) = logsumexp(a) - log(n)."""
    a = as_float(a)
    n = a.numel() if dim is None else a.shape[dim]
    return logsumexp(a, dim=dim, keepdim=keepdim) - math.log(n)


def xlogx(x) -> torch.Tensor:
    """x * log(x) with 0 log 0 = 0."""
    x = as_float(x)
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, x * torch.log(safe), torch.zeros_like(x))


def safe_log(x) -> torch.Tensor:
    """log with non-positive inputs mapped to the log-zero sentinel."""
    x = as_float(x)
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.log(safe), torch.full_like(x, log_zero(x.dtype)))


def safe_sqrt(x) -> torch.Tensor:
    """sqrt clamped at 0, so that a variance negative by rounding gives 0,
    not NaN."""
    return torch.sqrt(torch.clamp(as_float(x), min=0))


def xlogy(x, y) -> torch.Tensor:
    """x * log(y) with x == 0 giving 0."""
    x, y = _pair(x, y)
    safe_y = torch.where(x == 0, torch.ones_like(y), y)
    return torch.where(x == 0, torch.zeros_like(x), x * torch.log(safe_y))
