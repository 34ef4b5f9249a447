"""Calculation-report diagnostics (port of
``bayesianinference_tpu.results.report``).

Data-side equivalent of ``calculationReport`` (BayesianStatistics.wl:
1485-1608): the five diagnostic panels as plain arrays (plus an optional
matplotlib rendering in :mod:`..viz.plots`).  The reference builds
interactive Manipulate cells; here each panel is a named array bundle a
user can plot with anything.  Host-side numpy: the result's tensors are
copied from their device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..engines.evidence import NestedSamplingResult

__all__ = ["CalculationReport", "calculation_report"]


@dataclasses.dataclass(frozen=True)
class CalculationReport:
    """Diagnostic arrays, all aligned with the result's sample order
    (descending crude posterior weight) except where noted."""

    # Skilling's plot: logL vs mean sampled logX (BS:1503-1526)
    skilling_log_x: np.ndarray
    skilling_log_likelihood: np.ndarray
    # posterior concentration: enclosed posterior mass vs X, sorted by logL
    # ascending (BS:1528-1582)
    concentration_x: np.ndarray
    concentration_enclosed_mass: np.ndarray
    concentration_fit_coefficients: Optional[tuple]  # (intercept, slope) of log-log fit
    # evidence progression (BS:1584-1589)
    evidence_progression: np.ndarray  # log cumulative evidence found
    # logL progression (BS:1591-1596)
    log_likelihood_progression: np.ndarray
    # acceptance rates (NaN for initial/live samples) (BS:1598-1604)
    acceptance_rates: Optional[np.ndarray]

    def panels(self) -> dict:
        return {
            "Skilling's plot": (self.skilling_log_x, self.skilling_log_likelihood),
            "Posterior concentration": (
                self.concentration_x,
                self.concentration_enclosed_mass,
            ),
            "Evidence": self.evidence_progression,
            "LogLikelihood": self.log_likelihood_progression,
            "Acceptance rate": self.acceptance_rates,
        }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def calculation_report(
    result: NestedSamplingResult, fit_fraction: float = 1 / 3
) -> CalculationReport:
    """Assemble the five diagnostic panels from a nested-sampling result
    (``calculationReport``, BayesianStatistics.wl:1485-1608)."""
    ll = _np(result.log_likelihoods)
    crude_w = np.exp(_np(result.crude_log_posterior_weights))
    log_x = _np(
        result.sampled_log_x.mean
        if result.sampled_log_x is not None
        and np.all(np.isfinite(_np(result.sampled_log_x.mean)))
        else result.log_x
    )

    # posterior concentration: sort by logL ascending; enclosed mass =
    # reverse cumulative sum of weights (BS:1536-1542)
    order = np.argsort(ll)
    x_sorted = np.exp(_np(result.log_x))[order]
    w_sorted = crude_w[order]
    enclosed = np.cumsum(w_sorted[::-1])[::-1]

    # log-log linear fit over the top fit_fraction of points (BS:1550-1556)
    k = max(2, int(len(ll) * fit_fraction))
    xs, ys = x_sorted[-k:], enclosed[-k:]
    good = (xs > 0) & (ys > 0)
    fit = None
    if good.sum() >= 2:
        slope, intercept = np.polyfit(np.log(xs[good]), np.log(ys[good]), 1)
        fit = (float(intercept), float(slope))

    # log-space: crude_w sums to 1, so log(cumsum) + crude logZ never
    # under/overflows even for |logZ| beyond float range; the clamp must
    # be dtype-aware (1e-300 underflows to 0 in f32)
    evidence_prog = float(result.crude_log_evidence) + np.log(
        np.maximum(np.cumsum(crude_w), np.finfo(crude_w.dtype).tiny)
    )
    acc = (
        _np(result.acceptance_rates)
        if result.acceptance_rates is not None
        else None
    )
    return CalculationReport(
        skilling_log_x=log_x,
        skilling_log_likelihood=ll,
        concentration_x=x_sorted,
        concentration_enclosed_mass=enclosed,
        concentration_fit_coefficients=fit,
        evidence_progression=evidence_prog,
        log_likelihood_progression=ll,
        acceptance_rates=acc,
    )
