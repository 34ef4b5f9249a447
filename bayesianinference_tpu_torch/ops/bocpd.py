"""Bayesian online changepoint detection, Adams & MacKay (2007) (port of
``bayesianinference_tpu.ops.bocpd``).

The exact run-length posterior p(r_t | y_{1:t}) under a product-partition
model (constant hazard h, a conjugate underlying predictive model per
segment); the per-step normalizers compose to the exact marginal
likelihood p(y_{1:T} | h, UPM hyperparameters).

The run-length distribution lives in a fixed buffer of ``r_max`` slots; a
host loop over time where each step is [r_max]-vector work.  Mass at run
lengths >= r_max is absorbed into the last slot (which adopts the shifted-in
statistics: runs are capped at r_max - 1 points of memory), so the mass
bookkeeping and the evidence stay exact and the truncation error is only in
that slot's statistics; ``r_max = T`` is exact.  Masked steps propagate the
run lengths by the hazard and add no likelihood.

The function is written for one series; the changepoint engine maps it over
a batch of parameter vectors with ``torch.func.vmap``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.numerics import filter_logsumexp, log_zero, logaddexp

__all__ = [
    "UPM",
    "BOCPDResult",
    "gaussian_upm",
    "poisson_upm",
    "bocpd",
    "changepoint_probabilities",
]


class UPM(NamedTuple):
    """Underlying predictive model: ``init_stats(r_max, like)`` builds the
    prior sufficient statistics (a dict of [r_max] tensors in ``like``'s
    dtype and device, every slot at the prior), ``log_pred(stats, y)`` the
    posterior-predictive log-density of one point under each run length
    [r_max], and ``update(stats, y)`` the per-slot conjugate update."""

    init_stats: Callable
    log_pred: Callable
    update: Callable


def _ones(r_max: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones((r_max,), dtype=like.dtype, device=like.device)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """float32 as float64, for the predictives' lgamma terms: they are large
    and cancel (lgamma(0.5 (nu + 1)) - lgamma(0.5 nu) at nu in the hundreds),
    and float32 lgamma on CUDA errs by a few ulp of ~1e3 per slot, which a
    long series sums (PERF.md, phase 19b).  Other dtypes pass through."""
    return x.double() if x.dtype == torch.float32 else x


def gaussian_upm(mu0=0.0, kappa0=1.0, alpha0=1.0, beta0=1.0) -> UPM:
    """Normal-inverse-gamma segments: y ~ N(mu, s2), mu | s2 ~ N(mu0,
    s2 / kappa0), s2 ~ InvGamma(alpha0, beta0); the predictive is a
    Student-t."""

    def init_stats(r_max, like):
        ones = _ones(r_max, like)
        return {"mu": mu0 * ones, "kappa": kappa0 * ones, "alpha": alpha0 * ones, "beta": beta0 * ones}

    def log_pred(s, y):
        # Student-t(2 alpha) with loc mu, scale^2 = beta (kappa + 1) / (alpha kappa)
        nu = 2.0 * s["alpha"]
        sc2 = s["beta"] * (s["kappa"] + 1.0) / (s["alpha"] * s["kappa"])
        z2 = (y - s["mu"]) ** 2 / sc2
        lg = (torch.lgamma(_wide(0.5 * (nu + 1.0))) - torch.lgamma(_wide(0.5 * nu))).to(nu.dtype)
        return lg - 0.5 * torch.log(math.pi * nu * sc2) - 0.5 * (nu + 1.0) * torch.log1p(z2 / nu)

    def update(s, y):
        kn = s["kappa"] + 1.0
        return {
            "mu": (s["kappa"] * s["mu"] + y) / kn,
            "kappa": kn,
            "alpha": s["alpha"] + 0.5,
            "beta": s["beta"] + 0.5 * s["kappa"] * (y - s["mu"]) ** 2 / kn,
        }

    return UPM(init_stats, log_pred, update)


def poisson_upm(alpha0=1.0, beta0=1.0) -> UPM:
    """Gamma-Poisson segments: y ~ Poisson(lam), lam ~ Gamma(alpha0, beta0);
    negative-binomial predictive."""

    def init_stats(r_max, like):
        ones = _ones(r_max, like)
        return {"alpha": alpha0 * ones, "beta": beta0 * ones}

    def log_pred(s, y):
        a, b = s["alpha"], s["beta"]
        lg = (torch.lgamma(_wide(a + y)) - torch.lgamma(_wide(a)) - torch.lgamma(_wide(y + 1.0))).to(a.dtype)
        return lg + a * (torch.log(b) - torch.log1p(b)) - y * torch.log1p(b)

    def update(s, y):
        return {"alpha": s["alpha"] + y, "beta": s["beta"] + 1.0}

    return UPM(init_stats, log_pred, update)


class BOCPDResult(NamedTuple):
    """``log_run_length`` [T, r_max] = log p(r_t | y_{1:t}) (normalized over
    the buffer), ``log_likelihood`` = exact log p(y_{1:T})."""

    log_likelihood: torch.Tensor
    log_run_length: torch.Tensor


def bocpd(y, upm: UPM, hazard, r_max: Optional[int] = None, mask=None) -> BOCPDResult:
    """Run-length filtering over the series ``y`` [T].

    ``hazard``: constant changepoint probability per step in (0, 1) (a
    tensor under autograd for the engines).  ``mask``: [T] bool, True =
    observed."""
    y = torch.as_tensor(y)
    y = y if y.is_floating_point() else y.to(torch.get_default_dtype())
    t_total = y.shape[0]
    r_max = t_total if r_max is None else r_max
    h = torch.as_tensor(hazard, dtype=y.dtype, device=y.device)
    log_h, log_1mh = torch.log(h), torch.log1p(-h)
    lz = log_zero(y.dtype)
    m = None if mask is None else torch.as_tensor(mask, device=y.device).to(torch.bool)

    stats = upm.init_stats(r_max, y)
    prior_slot = {k: v[:1] for k, v in stats.items()}
    log_rl = torch.cat([torch.zeros((1,), dtype=y.dtype, device=y.device),
                        torch.full((r_max - 1,), lz, dtype=y.dtype, device=y.device)])
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    ll = zero
    posts = []
    # without a mask every step is observed and the masked selects drop out
    keep = (lambda t, new, old: new) if mask is None else (lambda t, new, old: torch.where(m[t], new, old))
    for t in range(t_total):
        y_t = y[t]
        # carry slot r: "y_t extends a segment holding r previous points",
        # so after the observation slot r is the run length r_t
        joint = log_rl + keep(t, upm.log_pred(stats, y_t), zero)
        ll_t = filter_logsumexp(joint)
        post = joint - ll_t
        posts.append(post)
        # hazard transition to the next carry; overflow mass joins the last slot
        grow = post + log_1mh
        new_rl = torch.cat([filter_logsumexp(post + log_h)[None], grow[:-1]])
        log_rl = torch.cat([new_rl[:-1], logaddexp(new_rl[-1], grow[-1])[None]])
        upd = upm.update(stats, y_t)
        # slot 0 reverts to the prior; the rest shift up by one
        stats = {k: torch.cat([prior_slot[k], keep(t, upd[k], s)[:-1]]) for k, s in stats.items()}
        ll = ll + keep(t, ll_t, zero)
    return BOCPDResult(log_likelihood=ll, log_run_length=torch.stack(posts))


def changepoint_probabilities(result: BOCPDResult):
    """Per-step posterior probability that a changepoint just occurred,
    p(r_t = 0 | y_{1:t}) [T]."""
    return torch.exp(result.log_run_length[..., 0])
