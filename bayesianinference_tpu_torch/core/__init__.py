"""Core numerics and containers."""

from .containers import WeightedSamples, take_posterior_fraction
from .device import resolve_device
from .linalg import inverse_matrix_block_inverse, matrix_block_inverse
from .numerics import (
    LOG2PI,
    betainc,
    exp_neg_precise,
    gammaln_precise,
    guard_log_density,
    is_log_zero,
    log1mexp,
    log1p_precise,
    log_precise,
    log_zero,
    logaddexp,
    logmeanexp,
    logsubexp,
    logsumexp,
    safe_log,
    safe_sqrt,
    xlogx,
    xlogy,
)
from .transforms import BoxBijection, box_bijection
from .standardize import NormalizedData, Standardizer, data_normal_form, normalize_data, standardize
