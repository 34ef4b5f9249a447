"""Post-processing of sampler output: the convergence diagnostics, WAIC,
PSIS-LOO and model weights, posterior predictives and their checks,
proper scores, summary tables, the nested-sampling calculation report and
simulation-based calibration."""

from ..core.containers import WeightedSamples, take_posterior_fraction
from .diagnostics import autocorrelation, effective_sample_size, gelman_rubin, weighted_effective_sample_size
from .information import LOOResult, WAICResult, model_weights, psis_loo, waic
from .posterior import posterior_predictive_check, predictive_distribution, regression_predictive_distribution
from .report import CalculationReport, calculation_report
from .scoring import (
    crps,
    crps_ensemble,
    crps_gaussian_mixture,
    dawid_sebastiani_score,
    interval_coverage,
    log_score,
    pit,
)
from .sbc import SBCResult, sbc_ranks, sbc_uniformity_pvalues
from .summary import ParameterSummary, SummaryTable, summary

__all__ = [
    "WeightedSamples",
    "take_posterior_fraction",
    "autocorrelation",
    "effective_sample_size",
    "gelman_rubin",
    "weighted_effective_sample_size",
    "LOOResult",
    "WAICResult",
    "model_weights",
    "psis_loo",
    "waic",
    "crps",
    "crps_ensemble",
    "crps_gaussian_mixture",
    "dawid_sebastiani_score",
    "interval_coverage",
    "log_score",
    "pit",
    "posterior_predictive_check",
    "predictive_distribution",
    "regression_predictive_distribution",
    "CalculationReport",
    "calculation_report",
    "SBCResult",
    "sbc_ranks",
    "sbc_uniformity_pvalues",
    "ParameterSummary",
    "SummaryTable",
    "summary",
]
