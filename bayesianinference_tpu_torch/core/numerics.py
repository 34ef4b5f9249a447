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
    "betainc",
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


_HALF_LOG_2PI = 0.9189385332046727
BETAINC_TERMS = 160
"""Continued-fraction depth of :func:`betainc`, read when it runs: the
least multiple of 32 that meets its float64 gate on the grid a, b in
{0.05, ..., 5000} (``tests/test_torch_scalar_families.py``)."""


def _stirling_remainder(z: torch.Tensor) -> torch.Tensor:
    """lgamma(z) - ((z - 1/2) log z - z + log(2 pi) / 2): its asymptotic
    series from z = 10 on (below 1e-17 there after seven terms), the
    difference itself below, where neither side is large."""
    r = 1.0 / torch.clamp(z, min=10.0)
    r2 = r * r
    series = r * (1 / 12 + r2 * (-1 / 360 + r2 * (1 / 1260 + r2 * (-1 / 1680 + r2 * (
        1 / 1188 + r2 * (-691 / 360360 + r2 / 156))))))
    direct = torch.lgamma(z) - ((z - 0.5) * torch.log(z) - z + _HALF_LOG_2PI)
    return torch.where(z >= 10.0, series, direct)


def _log_beta_power(a, b, x, y, log_x, log_y):
    """log(x^a y^b / B(a, b)) with y = 1 - x, written about the mode
    x0 = a / (a + b): a log(x / x0) + b log(y / y0) + log(ab / (2 pi c)) / 2
    less the three Stirling remainders, so that no term of the size of
    lgamma(a + b) cancels (direct lgamma differences lose 1e-11 at
    a = 5000).  Near the mode each log(x / x0) is a log1p of
    (x b - y a) / a; far from it the plain difference of logs."""
    c = a + b
    t = x * b - y * a
    dx, dy = t / a, -t / b
    term_a = torch.where(dx.abs() < 0.5, a * torch.log1p(dx), a * (log_x - torch.log(a / c)))
    term_b = torch.where(dy.abs() < 0.5, b * torch.log1p(dy), b * (log_y - torch.log(b / c)))
    return (term_a + term_b + 0.5 * torch.log(a * b / (2 * math.pi * c))
            - _stirling_remainder(a) - _stirling_remainder(b) + _stirling_remainder(c))


def betainc(a, b, x) -> torch.Tensor:
    """The regularized incomplete beta function I_x(a, b), elementwise over
    the broadcast of its arguments (``jax.scipy.special.betainc``; torch
    has none).

    The continued fraction of Numerical Recipes (6.4) times the power
    term x^a (1 - x)^b / (a B(a, b)), with I_x(a, b) = 1 - I_{1-x}(b, a)
    above x = (a + 1) / (a + b + 2).  The fraction is evaluated from its
    tail, t <- d_n / (1 + t), at the fixed depth of ``BETAINC_TERMS``
    partial numerators (all computed at once): two elementwise operations
    per term and no host read, so the whole batch runs the same launches.
    That depth converges for a, b up to 5000 (both that large need more
    beyond: 256 terms at 2e4, 384 at 5e4); with either of them at most
    1/2, as for the Student-t CDF, it converges at any size.
    Differentiable in x (and a, b) through autograd; x <= 0 gives 0 and
    x >= 1 gives 1."""
    a, b, x = torch.broadcast_tensors(*(as_float(v) for v in (a, b, x)))
    if a.device != x.device or b.device != x.device:
        a, b = a.to(x.device), b.to(x.device)
    given = x
    inside = (x > 0) & (x < 1)
    x = torch.where(inside, x, torch.full_like(x, 0.5))  # the ends are set below, with finite gradients
    swap = x > (a + 1) / (a + b + 2)
    y = 1 - x
    log_x, log_y = torch.log(x), torch.log1p(-x)
    a, b = torch.where(swap, b, a), torch.where(swap, a, b)
    x, y = torch.where(swap, y, x), torch.where(swap, x, y)
    log_x, log_y = torch.where(swap, log_y, log_x), torch.where(swap, log_x, log_y)
    # partial numerators d_1, d_2, ...: d_{2m+1} = -(a+m)(a+b+m)x / ((a+2m)(a+2m+1)),
    # d_{2m} = m(b-m)x / ((a+2m-1)(a+2m))
    m = torch.arange(BETAINC_TERMS // 2, dtype=x.dtype, device=x.device).reshape(-1, *([1] * x.dim()))
    odd = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
    m = m + 1
    even = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
    d = torch.stack([odd, even], dim=1).reshape(-1, *x.shape)
    t = torch.zeros_like(x)
    for n in range(d.shape[0] - 1, -1, -1):
        t = d[n] / (1 + t)
    front = torch.exp(_log_beta_power(a, b, x, y, log_x, log_y)) / a
    value = front / (1 + t)
    value = torch.where(swap, 1 - value, value)
    value = torch.where(given <= 0, torch.zeros_like(value), value)
    return torch.where(given >= 1, torch.ones_like(value), value)
