"""Training and MC-dropout prediction for quasi-Bayesian networks; port of
``bayesianinference_tpu.bnn.predict``.

``sample_trained_net`` is the analogue of NN:291-321: S stochastic forward
passes with dropout active (one batched pass over a leading S axis);
predictive mean = mean of the mean-head, predictive sd =
sqrt(Var(mean-head) + mean(exp(-log-precision))), epistemic plus aliased
aleatoric variance, one Normal per input.  ``train_regression_net``
replaces ``NetTrain``: optax's Adam through :mod:`..core.optim`, a host loop
of eager steps where the JAX package scans.  The random numbers of a step
(the minibatch indices and the dropout masks) come from ``generator`` or
are given as ``draws=``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..core.optim import adam_init, adam_step
from ..dists.scalar import Normal
from .losses import net_regularization_loss, regression_loss
from .nets import RegressionNet

__all__ = ["TrainedRegressionNet", "BNNStepDraws", "train_regression_net", "sample_trained_net"]


class TrainedRegressionNet(NamedTuple):
    """A trained net bundled with its loss configuration, so consumers can
    read the training hyperparameters back the way the reference reads
    alpha out of the trained NetGraph (NN:361-374)."""

    params: dict
    history: torch.Tensor
    net: RegressionNet
    alpha: Optional[float]
    sample_number: int
    weight_decay: float


class BNNStepDraws(NamedTuple):
    """The random numbers of one training step: the minibatch ``indices``
    [batch_size] (None for the full batch) and the dropout ``masks``
    (:meth:`~.nets.RegressionNet.draw_masks` at the batch's size, with a
    leading ``sample_number`` axis when alpha is set)."""

    indices: Optional[torch.Tensor]
    masks: List[torch.Tensor]


def train_regression_net(
    net: RegressionNet,
    generator: Optional[torch.Generator],
    x,
    y,
    *,
    alpha: Optional[float] = 0.5,
    sample_number: int = 10,
    weight_decay: float = 0.0,
    learning_rate: float = 1e-3,
    num_steps: int = 2000,
    batch_size: Optional[int] = None,
    initial_params: Optional[dict] = None,
    draws: Optional[Sequence[BNNStepDraws]] = None,
) -> TrainedRegressionNet:
    """Train with Adam on the (alpha-divergence) Gaussian loss, from
    ``initial_params`` or a fresh :meth:`~.nets.RegressionNet.init` by
    ``generator`` (None: one seeded 0 on ``x``'s device).  Returns a
    :class:`TrainedRegressionNet`; pass it whole to
    :func:`~.losses.network_log_evidence` to read alpha back.

    A batch-normalized net raises ``ValueError``: the JAX trainer cannot
    train one (its loss applies the net without a mutable ``batch_stats``
    collection, and flax refuses), and the port adds no training mode that
    the reference lacks."""
    if net.batch_normalization:
        raise ValueError("train_regression_net cannot train a batch-normalized net: the JAX trainer applies it "
                         "without mutable batch_stats and flax raises (ROADMAP.md, issues of the reference)")
    x = torch.as_tensor(x)
    x = x.reshape(1, -1) if x.dim() < 2 else x
    y = torch.as_tensor(y).reshape(-1)
    generator = torch.Generator(device=x.device).manual_seed(0) if generator is None else generator
    params = net.init(generator, x[:1]) if initial_params is None else dict(initial_params)
    n = x.shape[0]
    bs = batch_size or n
    if draws is not None and len(draws) != num_steps:
        raise ValueError(f"draws must hold {num_steps} steps, got {len(draws)}")
    state = adam_init(params)
    history = []
    for t in range(num_steps):
        if draws is not None:
            idx, masks = draws[t]
        else:
            idx = torch.randint(0, n, (bs,), generator=generator, device=x.device) if bs < n else None
            masks = net.draw_masks(generator, bs, None if alpha is None else sample_number,
                                   dtype=net.compute_dtype(x, params), device=x.device)
        xb, yb = (x, y) if idx is None else (x[idx], y[idx])
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = regression_loss(net, p, None, xb, yb, alpha=alpha, sample_number=sample_number, masks=masks)
            if weight_decay:
                loss = loss + net_regularization_loss(p, weight_decay, 2)
            grads = torch.autograd.grad(loss, list(p.values()))
        params, state = adam_step(params, dict(zip(p, grads)), state, learning_rate)
        history.append(loss.detach())
    return TrainedRegressionNet(
        params=params,
        history=torch.stack(history) if history else torch.zeros((0,), dtype=x.dtype, device=x.device),
        net=net, alpha=alpha, sample_number=sample_number, weight_decay=weight_decay,
    )


def sample_trained_net(net: RegressionNet, params, generator: Optional[torch.Generator], x, num_samples: int = 100,
                       *, masks: Optional[Sequence[torch.Tensor]] = None) -> Normal:
    """MC-dropout predictive (NN:291-321): a batched Normal over the input
    points with mean = E_s[mu_s], sd = sqrt(Var_s[mu_s] + E_s[exp(-rho_s)]),
    from ``num_samples`` passes (``masks`` [num_samples, n, width] or drawn
    from ``generator``)."""
    x = torch.as_tensor(x)
    x = x.reshape(1, -1) if x.dim() < 2 else x
    if masks is None:
        masks = net.draw_masks(generator, x.shape[0], num_samples, dtype=net.compute_dtype(x, params),
                               device=x.device)
    outs = net(x, masks, params=params)  # [S, n, 2]
    mu, log_prec = outs[..., 0], outs[..., 1]
    var = torch.var(mu, dim=0, correction=1) + torch.mean(torch.exp(-log_prec), dim=0)
    return Normal(loc=torch.mean(mu, dim=0), scale=torch.sqrt(var))
