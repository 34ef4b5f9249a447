"""Losses for quasi-Bayesian networks: Gaussian NLL and alpha-divergence;
port of ``bayesianinference_tpu.bnn.losses``.

``gaussianLossLayer`` (NN:28-56), ``alphaDivergenceLoss`` (NN:245-264),
``netRegularizationLoss`` (NN:323-347) and ``networkLogEvidence``
(NN:349-387).  The stochastic losses take the dropout masks as an input
(``masks=``: :meth:`~.nets.RegressionNet.draw_masks`'s list, with a
leading ``sample_number`` axis for the alpha-divergence) or draw them from
``generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..core.numerics import logmeanexp

__all__ = [
    "gaussian_loss",
    "alpha_divergence_loss",
    "regression_loss",
    "net_regularization_loss",
    "network_log_evidence",
]


def gaussian_loss(y, y_pred, scale_param, parameterization="LogPrecision"):
    """Gaussian negative log-likelihood up to constants (NN:28-56):
    * LogPrecision: (yhat-y)^2 e^rho - rho
    * Variance:     (yhat-y)^2 / v + log v
    * StandardDeviation: ((yhat-y)/s)^2 + 2 log s
    """
    y, y_pred, s = (torch.as_tensor(a, dtype=torch.float64) if not isinstance(a, torch.Tensor) else a
                    for a in (y, y_pred, scale_param))
    sq = (y_pred - y) ** 2
    if parameterization == "LogPrecision":
        return sq * torch.exp(s) - s
    if parameterization == "Variance":
        return sq / s + torch.log(s)
    if parameterization == "StandardDeviation":
        return sq / s**2 + 2.0 * torch.log(s)
    raise ValueError(f"unknown parameterization {parameterization!r}")


def alpha_divergence_loss(losses, alpha, dim=-1):
    """-(1/alpha) logMeanExp(-alpha * L) over the MC-sample axis
    (NN:245-264); alpha -> 0 gives the mean, +inf the min, -inf the max."""
    losses = torch.as_tensor(losses)
    alpha = float(alpha)
    if alpha == 0:
        return torch.mean(losses, dim=dim)
    if math.isinf(alpha):
        return torch.amin(losses, dim=dim) if alpha > 0 else torch.amax(losses, dim=dim)
    return -logmeanexp(-alpha * losses, dim=dim) / alpha


def regression_loss(net, params, generator, x, y, *, alpha: Optional[float] = None, sample_number: int = 10,
                    masks: Optional[Sequence[torch.Tensor]] = None):
    """Training loss of ``regressionLossNet`` (NN:121-195), the scalar mean
    over examples.  Without ``alpha``: one stochastic pass (NN:178-195),
    masks [n, width]; with ``alpha``: ``sample_number`` stochastic passes as
    one batch (masks [sample_number, n, width]) and the per-example
    alpha-divergence over them (NN:139-176)."""
    x = torch.as_tensor(x)
    x = x.reshape(1, -1) if x.dim() < 2 else x
    y = torch.as_tensor(y).reshape(-1)
    if masks is None:
        masks = net.draw_masks(generator, x.shape[0], None if alpha is None else sample_number,
                               dtype=net.compute_dtype(x, params), device=x.device)
    out = net(x, masks, params=params)
    losses = gaussian_loss(y.to(out.dtype), out[..., 0], out[..., 1])  # [n] or [k, n]
    if alpha is None:
        return torch.mean(losses)
    return torch.mean(alpha_divergence_loss(losses, alpha, dim=0))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [torch.as_tensor(tree)]


def net_regularization_loss(params, lam=1.0, p: float = 2):
    """lambda * sum_w |w|^p over every tensor of the state dict (NN:323-347),
    batch-norm running averages included as the JAX package's sum over its
    variables dict includes them; p = 0 counts parameters.  ``lam``/``p``
    may be lists for summed terms."""
    if isinstance(lam, (list, tuple)):
        return sum(net_regularization_loss(params, l_, p_) for l_, p_ in zip(lam, p))
    leaves = _leaves(params)
    if p == 0:
        return lam * sum(leaf.numel() for leaf in leaves)
    return lam * sum(torch.sum(torch.abs(leaf) ** p) for leaf in leaves)


def network_log_evidence(net, params_or_generator, generator_or_x=None, x_or_y=None, y=None, lambda2=None, *,
                         alpha=None, sample_number=None, masks: Optional[Sequence[torch.Tensor]] = None):
    """Quasi log-evidence -(mean alpha-div NLL + L2 regularization)
    (``networkLogEvidence``, NN:349-387).

    Two call forms:

    * ``network_log_evidence(trained, generator, x, y)`` with a
      :class:`~.predict.TrainedRegressionNet`: alpha, the MC sample count
      and the L2 weight are read back from the bundle (NN:361-374);
      keyword overrides still win.
    * ``network_log_evidence(net, params, generator, x, y, lambda2=0.0,
      alpha=0.5, sample_number=100)``: the explicit form.
    """
    from .predict import TrainedRegressionNet

    if isinstance(net, TrainedRegressionNet):
        if y is not None:
            raise TypeError("bundle form is network_log_evidence(trained, generator, x, y); "
                            "pass lambda2/alpha/sample_number by keyword")
        trained = net
        net, params = trained.net, trained.params
        generator, x, y = params_or_generator, generator_or_x, x_or_y
        alpha = trained.alpha if alpha is None else alpha
        sample_number = trained.sample_number if sample_number is None else sample_number
        lambda2 = trained.weight_decay if lambda2 is None else lambda2
    else:
        params, generator, x = params_or_generator, generator_or_x, x_or_y
        alpha = 0.5 if alpha is None else alpha
        sample_number = 100 if sample_number is None else sample_number
        lambda2 = 0.0 if lambda2 is None else lambda2
    nll = regression_loss(net, params, generator, x, y, alpha=alpha, sample_number=sample_number, masks=masks)
    reg = net_regularization_loss(params, lambda2, 2)
    return -(nll + reg)
