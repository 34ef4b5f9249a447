"""Information criteria and model weights from weighted posterior samples
(port of ``bayesianinference_tpu.results.information``).

WAIC (Watanabe 2010) and PSIS-LOO (Vehtari, Gelman & Gabry 2017) from any
weighted posterior sample, nested-sampling output included, and
model-averaging weights from their pointwise elpd (Yao, Vehtari, Simpson &
Gelman 2018).  ``pointwise_loglike(theta [d]) -> [n]`` is batched over the
draws by ``torch.func.vmap``.  The Pareto tail fit is host-side numpy, as
in the JAX package (this module keeps its own copy); Pathfinder's
importance weights go through the same :func:`_psis_smooth_tail`.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.numerics import log_zero, logsumexp

__all__ = [
    "LOOResult",
    "WAICResult",
    "model_weights",
    "psis_loo",
    "waic",
]


@dataclasses.dataclass(frozen=True)
class WAICResult:
    """elpd = lppd - p_waic per data point; waic = -2 sum elpd."""

    waic: float
    elpd: float  # sum over data points
    p_waic: float  # effective number of parameters
    se: float  # standard error of waic (sqrt(n var) scaling)
    pointwise_elpd: torch.Tensor  # [n]

    def __repr__(self):
        return f"WAIC {self.waic:.2f} ± {self.se:.2f} (elpd {self.elpd:.2f}, p_waic {self.p_waic:.2f})"


def _samples(result):
    """(points [S, d], normalized weights [S]) of a weighted sample or a
    nested-sampling result."""
    from ..engines.evidence import NestedSamplingResult

    if isinstance(result, NestedSamplingResult):
        result = result.posterior_samples()
    return result.points, result.normalized_weights()


def _pointwise(pointwise_loglike: Callable, thetas: torch.Tensor) -> torch.Tensor:
    ll = torch.func.vmap(pointwise_loglike)(thetas)  # [S, n]
    if ll.dim() != 2:
        raise ValueError("pointwise_loglike(theta) must return the [n] per-observation log-likelihood vector, got "
                         f"shape {tuple(ll.shape[1:])}")
    return ll


def waic(result, pointwise_loglike: Callable) -> WAICResult:
    """WAIC from a weighted posterior sample (a ``NestedSamplingResult`` or
    ``WeightedSamples``); ``pointwise_loglike(theta) -> [n]`` maps one
    parameter vector to the per-observation log-likelihoods (not the sum).

    lppd_i = log sum_s w_s p(y_i | theta_s),  p_i = Var_w[log p(y_i | theta_s)],
    elpd_i = lppd_i - p_i,  WAIC = -2 sum_i elpd_i."""
    thetas, w = _samples(result)
    ll = _pointwise(pointwise_loglike, thetas)
    # zero-weight samples take the dtype's sentinel as their log weight
    log_w = torch.where(w > 0, torch.log(torch.where(w > 0, w, torch.ones_like(w))),
                        torch.full_like(w, log_zero(w.dtype)))[:, None]
    lppd = logsumexp(log_w + ll, dim=0)  # [n]
    mu = torch.sum(w[:, None] * ll, dim=0)
    p_w = torch.sum(w[:, None] * (ll - mu) ** 2, dim=0)
    elpd_i = lppd - p_w
    n = elpd_i.shape[0]
    se = 2.0 * torch.sqrt(n * torch.var(elpd_i, correction=0))
    return WAICResult(waic=float(-2.0 * torch.sum(elpd_i)), elpd=float(torch.sum(elpd_i)), p_waic=float(torch.sum(p_w)),
                      se=float(se), pointwise_elpd=elpd_i)


@dataclasses.dataclass(frozen=True)
class LOOResult:
    """PSIS-LOO: elpd_loo = sum_i log p(y_i | y_-i) estimated by
    Pareto-smoothed importance sampling."""

    elpd_loo: float
    p_loo: float  # effective parameters: lppd - elpd_loo
    se: float
    pointwise_elpd: torch.Tensor  # [n]
    pareto_k: torch.Tensor  # [n] tail-shape diagnostics (flag > 0.7)

    def __repr__(self):
        bad = int(np.sum(self.pareto_k.detach().cpu().numpy() > 0.7))
        return f"LOO elpd {self.elpd_loo:.2f} ± {self.se:.2f} (p_loo {self.p_loo:.2f}; {bad} obs with pareto k > 0.7)"


def _gpd_fit(x):
    """Generalized-Pareto (k, sigma) fit to sorted exceedances x > 0 by the
    Zhang & Stephens (2009) quasi-Bayes profile method, with the
    small-sample shape regularization toward 0.5."""
    n = x.shape[0]
    m = 30 + int(np.sqrt(n))
    b = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    b = b / (3.0 * x[max(int(n / 4 + 0.5) - 1, 0)]) + 1.0 / x[-1]
    k = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)  # = -khat per b
    log_lik = n * (np.log(-b / k) - k - 1.0)
    weights = 1.0 / np.sum(np.exp(log_lik - log_lik[:, None]), axis=1)
    b_post = np.sum(b * weights)
    k_post = np.mean(np.log1p(-b_post * x))
    sigma = -k_post / b_post
    k_post = k_post * n / (n + 10.0) + 0.25 * 10.0 / (n + 10.0) * 2.0
    return k_post, sigma


def _psis_smooth_tail(log_ratios):
    """Smooth the upper tail of one observation's log importance ratios
    (numpy); returns (smoothed log ratios, pareto k)."""
    lr = np.asarray(log_ratios, float).copy()
    s = lr.shape[0]
    tail_len = min(int(0.2 * s), max(int(3.0 * np.sqrt(s)), 5))
    if tail_len < 5:
        return lr, np.inf
    order = np.argsort(lr)
    tail_idx = order[-tail_len:]
    cutoff = lr[order[-tail_len - 1]]
    max_lr = lr[order[-1]]
    exceed = np.exp(lr[tail_idx] - cutoff) - 1.0
    exceed = np.sort(exceed) * np.exp(cutoff)
    if np.allclose(exceed, 0.0) or not np.all(np.isfinite(exceed)):
        return lr, np.inf
    k, sigma = _gpd_fit(exceed)
    if not np.isfinite(k):
        return lr, np.inf
    # the tail becomes the expected GPD order statistics (inverse CDF at the
    # plotting positions), capped at the raw maximum
    p = (np.arange(tail_len) + 0.5) / tail_len
    if abs(k) < 1e-12:
        q = -sigma * np.log1p(-p)
    else:
        q = sigma * np.expm1(-k * np.log1p(-p)) / k
    # back to the log-ratio scale (the exceedances sit above exp(cutoff));
    # the clamp is the dtype's tiny, since 1e-300 underflows in float32
    smoothed = np.log(np.maximum(q + np.exp(cutoff), np.finfo(lr.dtype).tiny))
    smoothed = np.minimum(np.sort(smoothed), max_lr)
    lr[tail_idx[np.argsort(lr[tail_idx])]] = smoothed
    return lr, k


def _np_logsumexp(a):
    m = np.max(a)
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(a - m)))


def _np_is_log_zero(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return ~(x > 0.5 * log_zero(dtype))


def psis_loo(result, pointwise_loglike: Callable) -> LOOResult:
    """Pareto-smoothed importance-sampling leave-one-out cross-validation
    from a weighted posterior sample; ``pointwise_loglike`` as in
    :func:`waic`.

    The importance ratios of observation i are w_s / p(y_i | theta_s); each
    observation's ratio tail is smoothed by a generalized-Pareto fit and its
    shape khat reported (khat > 0.7 flags an unreliable estimate).  An
    observation that some draw gives sentinel-zero likelihood gets
    ``khat = inf`` and still contributes an ``elpd_i`` from the other draws
    to the totals; a warning says so."""
    thetas, w_t = _samples(result)
    w = w_t.detach().cpu().numpy().astype(float)
    ll_t = _pointwise(pointwise_loglike, thetas)
    ll = ll_t.detach().cpu().numpy().astype(float)
    s, n = ll.shape
    log_w = np.where(w > 0, np.log(np.where(w > 0, w, 1.0)), -np.inf)
    # a log-zero likelihood makes the raw ratio w / p astronomically large:
    # the observation's LOO estimate diverges, so it is flagged (khat = inf)
    # and those draws are left out of its smoothing and estimate
    dead = _np_is_log_zero(ll, ll_t.dtype)
    elpd_i = np.empty(n)
    khat = np.empty(n)
    for i in range(n):
        lr = log_w - ll[:, i]
        finite = np.isfinite(lr) & ~dead[:, i]
        lr = np.where(finite, lr, -np.inf)
        lr_s, k = _psis_smooth_tail(lr)
        khat[i] = np.inf if dead[:, i].any() else k
        a = lr_s + ll[:, i]
        amax, lmax = a.max(), lr_s.max()
        elpd_i[i] = amax + np.log(np.sum(np.exp(a - amax))) - (lmax + np.log(np.sum(np.exp(lr_s - lmax))))
    lppd_i = np.asarray([_np_logsumexp(log_w + ll[:, i]) for i in range(n)])
    elpd = float(np.sum(elpd_i))
    n_bad = int(np.sum(~np.isfinite(khat) | (khat > 0.7)))
    if n_bad:
        warnings.warn(f"psis_loo: {n_bad}/{n} observations have Pareto khat > 0.7 or non-finite; their elpd_i terms "
                      "are unreliable but still included in elpd_loo/se — inspect pareto_k", stacklevel=2)
    dev = thetas.device
    return LOOResult(elpd_loo=elpd, p_loo=float(np.sum(lppd_i) - elpd), se=float(np.sqrt(n * np.var(elpd_i))),
                     pointwise_elpd=torch.as_tensor(elpd_i, device=dev), pareto_k=torch.as_tensor(khat, device=dev))


def model_weights(
    results,
    *,
    method: str = "stacking",
    generator: Optional[torch.Generator] = None,
    n_bootstrap: int = 1000,
    num_iters: int = 500,
    dirichlet: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """Model-averaging weights from pointwise elpd estimates.

    ``results``: one :class:`LOOResult` / :class:`WAICResult` (or raw [n]
    pointwise elpd) per model, all on the same n observations.

    * ``"stacking"``: maximize ``sum_i log sum_k w_k exp(elpd_ik)`` over the
      simplex by ``num_iters`` exponentiated-gradient steps (the objective
      is concave in w);
    * ``"pseudo-bma"``: ``w_k ∝ exp(sum_i elpd_ik)``;
    * ``"pseudo-bma+"``: Bayesian-bootstrap regularized, the average softmax
      over ``n_bootstrap`` Dirichlet(1) reweightings of the observations,
      drawn from ``generator`` or given as ``dirichlet`` [n_bootstrap, n].

    Returns a [K] simplex vector, float64, on the device of the first
    tensor among the inputs, else on ``device`` (the card unless the
    caller asks for the CPU)."""
    elpds, dev = [], None
    for r in results:
        e = getattr(r, "pointwise_elpd", r)
        if isinstance(e, torch.Tensor):
            dev = e.device if dev is None else dev
            e = e.detach().cpu().numpy()
        elpds.append(np.asarray(e, float))
    dev = resolve_device(device) if dev is None else dev
    elpd = np.stack(elpds, axis=0)  # [K, n]
    if elpd.ndim != 2:
        raise ValueError(f"pointwise elpds must be [n] vectors, got {elpd.shape}")
    k_models, n = elpd.shape
    if not np.all(np.isfinite(elpd)):
        raise ValueError("non-finite pointwise elpd — inspect pareto_k / refit flagged observations before computing "
                         "model weights")
    f64 = dict(dtype=torch.float64, device=dev)
    if k_models == 1:
        return torch.ones((1,), **f64)
    if method == "pseudo-bma":
        tot = elpd.sum(axis=1)
        w = np.exp(tot - tot.max())
        return torch.as_tensor(w / w.sum(), **f64)
    if method == "pseudo-bma+":
        if dirichlet is None:
            generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
            # Dirichlet(1, ..., 1) as normalized unit exponentials
            e = torch.empty((n_bootstrap, n), **f64).exponential_(1.0, generator=generator)
            dirichlet = e / e.sum(dim=-1, keepdim=True)
        alpha = torch.as_tensor(dirichlet, **f64)  # [B, n]
        rep = torch.as_tensor(elpd, **f64) @ alpha.T * n  # [K, B] replicate sums
        return torch.mean(torch.softmax(rep, dim=0), dim=1)
    if method != "stacking":
        raise ValueError(f"unknown method {method!r}; use 'stacking', 'pseudo-bma' or 'pseudo-bma+'")
    # stacking: exponentiated-gradient (mirror) ascent on the simplex
    le = torch.as_tensor(elpd - elpd.max(axis=0, keepdims=True), **f64)  # [K, n]
    logw = torch.zeros((k_models,), **f64) - math.log(float(k_models))
    for _ in range(num_iters):
        w = torch.softmax(logw, dim=0)
        lmix = logsumexp(torch.log(w)[:, None] + le, dim=0)  # [n] log mixture density
        g = torch.sum(torch.exp(le - lmix[None, :]), dim=1) / n  # d/dw_k
        logw = logw + 0.5 * g
        logw = logw - logsumexp(logw)
    return torch.softmax(logw, dim=0)
