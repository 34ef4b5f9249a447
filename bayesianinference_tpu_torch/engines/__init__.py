"""Inference engines: nested sampling, evidence resampling, GP regression
and the Laplace approximation.  ``nested_sampling`` stays in its module
(``engines.nested_sampling``): a package attribute of that name would hide
the module."""

from .gp import coordinate_bounds_grid, define_gaussian_process, predict_from_gaussian_process
from .laplace import (
    LaplaceFit,
    approximate_evidence,
    approximate_evidence_hyper,
    find_mode,
    fit_precision_at_max,
    laplace_log_evidence,
    laplace_posterior_fit,
    mackay_update_1,
    mackay_update_2,
)
