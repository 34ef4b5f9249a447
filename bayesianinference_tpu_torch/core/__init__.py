"""Core numerics and containers."""

from .containers import WeightedSamples, take_posterior_fraction
from .device import resolve_device
from .linalg import inverse_matrix_block_inverse, matrix_block_inverse
from .numerics import (
    LOG2PI,
    exp_neg_precise,
    guard_log_density,
    is_log_zero,
    log_precise,
    log_zero,
    logaddexp,
    logsubexp,
    logsumexp,
    xlogy,
)
from .standardize import NormalizedData, Standardizer, data_normal_form, normalize_data, standardize
