"""Post-processing of sampler output: the convergence diagnostics, WAIC,
PSIS-LOO and model weights, summary tables, the nested-sampling calculation
report and simulation-based calibration.  ``posterior``, ``scoring`` and
``viz`` of the JAX package's ``results/`` are not ported yet."""

from .diagnostics import autocorrelation, effective_sample_size, gelman_rubin, weighted_effective_sample_size
from .information import LOOResult, WAICResult, model_weights, psis_loo, waic
from .report import CalculationReport, calculation_report
from .sbc import SBCResult, sbc_ranks, sbc_uniformity_pvalues
from .summary import ParameterSummary, SummaryTable, summary

__all__ = [
    "autocorrelation",
    "effective_sample_size",
    "gelman_rubin",
    "weighted_effective_sample_size",
    "LOOResult",
    "WAICResult",
    "model_weights",
    "psis_loo",
    "waic",
    "CalculationReport",
    "calculation_report",
    "SBCResult",
    "sbc_ranks",
    "sbc_uniformity_pvalues",
    "ParameterSummary",
    "SummaryTable",
    "summary",
]
