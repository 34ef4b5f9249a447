"""Quasi-Bayesian neural networks (MC dropout and the alpha-divergence
loss); port of ``bayesianinference_tpu.bnn``."""

from .losses import (
    alpha_divergence_loss,
    gaussian_loss,
    net_regularization_loss,
    network_log_evidence,
    regression_loss,
)
from .nets import RegressionNet, regression_net
from .predict import BNNStepDraws, TrainedRegressionNet, sample_trained_net, train_regression_net

__all__ = [
    "alpha_divergence_loss",
    "gaussian_loss",
    "net_regularization_loss",
    "network_log_evidence",
    "regression_loss",
    "RegressionNet",
    "regression_net",
    "TrainedRegressionNet",
    "BNNStepDraws",
    "sample_trained_net",
    "train_regression_net",
]
