"""Posterior visualisations (matplotlib, imported when a function draws);
port of ``bayesianinference_tpu.viz``."""

from .plots import (
    calculation_report_plot,
    calibration_plot,
    covariance_matrix_plot,
    posterior_bubble_chart,
    posterior_marginal_cdf_density_plot_2d,
    posterior_marginal_cdf_plot_1d,
    posterior_marginal_pdf_density_plot_2d,
    posterior_marginal_pdf_plot_1d,
    regression_plot_1d,
    sbc_rank_plot,
    smc_report_plot,
    trace_plot,
)

__all__ = [
    "calculation_report_plot",
    "calibration_plot",
    "covariance_matrix_plot",
    "posterior_bubble_chart",
    "posterior_marginal_cdf_density_plot_2d",
    "posterior_marginal_cdf_plot_1d",
    "posterior_marginal_pdf_density_plot_2d",
    "posterior_marginal_pdf_plot_1d",
    "regression_plot_1d",
    "sbc_rank_plot",
    "smc_report_plot",
    "trace_plot",
]
