"""Proper scoring rules and calibration checks for predictive laws (port
of ``bayesianinference_tpu.results.scoring``).

* :func:`crps`: the continuous ranked probability score, in closed form
  for a ``PointwiseMixture`` of Normals (Grimit et al. 2006: the GP, BLR
  and regression predictives), else the energy-form estimator from draws;
* :func:`log_score`: the negative predictive log density;
* :func:`pit`: probability integral transform values (uniform if and only
  if calibrated); :func:`interval_coverage`: central-interval coverage and
  mean width at given levels;
* :func:`dawid_sebastiani_score`: the (mean, variance)-only score.

All scores are "smaller is better" and vectorized over query points.
Observations that are not tensors go to the predictive's device.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.numerics import as_float, ndtr
from ..dists.base import tensor_leaves
from ..dists.pointwise import PointwiseMixture
from ..dists.scalar import Normal

__all__ = [
    "crps",
    "crps_gaussian_mixture",
    "crps_ensemble",
    "log_score",
    "pit",
    "interval_coverage",
    "dawid_sebastiani_score",
]

CRPS_PAIR_ELEMENTS = 2**25
"""The closed form's [S, S, m] pair arrays are built over chunks of query
points holding at most this many elements (256 MiB in float64); each
point's arithmetic is the same whatever the chunk."""

_INV_SQRT_2PI = 0.3989422804014327


def _like(y, ref: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` as a float tensor; one that is not a tensor goes to ``ref``'s
    device and dtype."""
    if isinstance(y, torch.Tensor) or ref is None:
        return as_float(y)
    return torch.as_tensor(y, dtype=ref.dtype, device=ref.device)


def _ref(predictive) -> Optional[torch.Tensor]:
    return next((v for _, v in tensor_leaves(predictive) if v.is_floating_point()), None)


def _abs_normal_mean(m, s):
    """E|X| for X ~ N(m, s^2): m (2 Phi(m/s) - 1) + 2 s phi(m/s)."""
    z = m / s
    return m * (2.0 * ndtr(z) - 1.0) + 2.0 * s * _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def crps_gaussian_mixture(log_weights, locs, scales, y) -> torch.Tensor:
    """Exact CRPS of a Gaussian mixture (Grimit et al. 2006, eq. 5):
    ``log_weights`` [S], ``locs`` and ``scales`` [S, m], ``y`` [m] give the
    per-point CRPS [m],

        sum_i w_i A(y - mu_i, s_i) - 1/2 sum_ij w_i w_j A(mu_i - mu_j, sqrt(s_i^2 + s_j^2)).
    """
    locs = as_float(locs)
    log_weights, scales, y = (_like(v, locs) for v in (log_weights, scales, y))
    w = torch.softmax(log_weights, dim=-1)
    term1 = torch.einsum("s,sm->m", w, _abs_normal_mean(y[None, :] - locs, scales))
    s_count, m = locs.shape
    chunk = max(1, CRPS_PAIR_ELEMENTS // max(s_count * s_count, 1))
    term2 = []
    for j in range(0, m, chunk):
        mu, sd = locs[:, j:j + chunk], scales[:, j:j + chunk]
        dm = mu[:, None, :] - mu[None, :, :]  # [S, S, chunk]
        ds = torch.sqrt(sd[:, None, :] ** 2 + sd[None, :, :] ** 2)
        term2.append(torch.einsum("i,j,ijm->m", w, w, _abs_normal_mean(dm, ds)))
    return term1 - 0.5 * torch.cat(term2)


def crps_ensemble(samples, y) -> torch.Tensor:
    """Energy-form CRPS estimator from draws ``samples`` [k, m] at ``y``
    [m]: E|X - y| - E|X - X'| / 2 with the unbiased k (k - 1) pairing,
    from sorted samples in O(k log k) per point (sum over i < j of
    x_(j) - x_(i) = sum_i (2i - k - 1) x_(i))."""
    samples = as_float(samples)
    y = _like(y, samples)
    k = samples.shape[0]
    t1 = torch.mean(torch.abs(samples - y[None, :]), dim=0)
    s = torch.sort(samples, dim=0).values
    coef = 2.0 * torch.arange(1, k + 1, dtype=s.dtype, device=s.device) - k - 1
    t2 = 2.0 * torch.einsum("k,km->m", coef, s) / (k * (k - 1))
    return t1 - 0.5 * t2


def crps(predictive, y, *, generator: Optional[torch.Generator] = None, num_samples: int = 256) -> torch.Tensor:
    """Per-point CRPS of a predictive law at observations ``y`` [m]: the
    closed form for a ``PointwiseMixture`` with a Normal component, else
    the energy-form estimator on ``num_samples`` draws (pass
    ``generator``)."""
    if isinstance(predictive, PointwiseMixture) and isinstance(predictive.component, Normal):
        c = predictive.component
        return crps_gaussian_mixture(predictive.log_weights, c.loc, c.scale, y)
    if generator is None:
        raise ValueError("no closed form for this predictive; pass generator= for the sample-based "
                         "CRPS estimator")
    samples = predictive.sample(generator, (num_samples,))
    return crps_ensemble(samples, y)


def log_score(predictive, y) -> torch.Tensor:
    """Negative predictive log density per point (strictly proper)."""
    return -predictive.log_prob(_like(y, _ref(predictive)))


def pit(predictive, y) -> torch.Tensor:
    """Probability integral transform F(y) per point: uniform on (0, 1) if
    and only if the predictive is calibrated."""
    return predictive.cdf(_like(y, _ref(predictive)))


def interval_coverage(predictive, y, levels=(0.5, 0.9)) -> dict:
    """Empirical central-interval coverage and mean width:
    ``{level: (coverage, mean_width)}``.  Calibrated forecasts cover about
    ``level``; the width is the sharpness (smaller is better, subject to
    calibration)."""
    y = _like(y, _ref(predictive))
    out = {}
    for level in levels:
        alpha = 0.5 * (1.0 - level)
        lo, hi = predictive.quantile(alpha), predictive.quantile(1.0 - alpha)
        cover = torch.mean(((y >= lo) & (y <= hi)).to(y.dtype))
        out[float(level)] = (cover, torch.mean(hi - lo))
    return out


def dawid_sebastiani_score(predictive, y) -> torch.Tensor:
    """log var + (y - mean)^2 / var per point: the moment-only proper score."""
    y = _like(y, _ref(predictive))
    mu, var = torch.as_tensor(predictive.mean()), torch.as_tensor(predictive.variance())
    return torch.log(var) + (y - mu) ** 2 / var

