"""Core numerics and containers."""

from .containers import WeightedSamples, take_posterior_fraction
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
