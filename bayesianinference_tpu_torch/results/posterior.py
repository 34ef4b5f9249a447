"""Posterior-predictive distributions from sampled results (port of
``bayesianinference_tpu.results.posterior``): mixtures of the generating
distribution over the posterior samples, with ``"MAP"`` and
``"MaximumLikelihood"`` single-point variants, for i.i.d. and regression
models, and the posterior predictive check.

The distribution builder is mapped over the samples with
``torch.func.vmap``.  The port's distributions are frozen dataclasses, not
pytrees, so the mapped function returns the builder's tensor fields
(``dists.base.tensor_leaves``) and the batched component is rebuilt from
them; a Python-number field is the same for every sample and stays as it
is.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import logsumexp
from ..dists.base import tensor_leaves, with_leaves
from ..dists.combinators import Mixture
from ..dists.pointwise import PointwiseMixture

__all__ = [
    "predictive_distribution",
    "regression_predictive_distribution",
    "posterior_predictive_check",
]


def _select_samples(result, mode: Optional[str]):
    """Weighted posterior draws from any engine's output: a
    ``NestedSamplingResult`` (its crude posterior weights), a
    ``WeightedSamples``, or any result whose ``posterior_samples()`` takes
    no argument (HMC, SMC, the ensemble).  VI and Pathfinder results need a
    generator: pass ``result.posterior_samples(generator)``."""
    if hasattr(result, "crude_log_posterior_weights"):
        thetas, log_w = result.points, result.crude_log_posterior_weights
        log_l = result.log_likelihoods
        log_post = result.log_likelihoods + result.log_priors
    else:
        if not isinstance(result, WeightedSamples):
            if not hasattr(result, "posterior_samples"):
                raise TypeError("expected a NestedSamplingResult, WeightedSamples, or a result with "
                                f".posterior_samples(); got {type(result)}")
            try:
                result = result.posterior_samples()
            except TypeError as e:
                raise TypeError(
                    "this result's posterior_samples() needs arguments (a VI or Pathfinder posterior "
                    "needs a generator): call it yourself and pass the WeightedSamples, e.g. "
                    "predictive_distribution(res.posterior_samples(generator), ...)") from e
        thetas, log_w, log_l, log_post = result.points, result.log_weights, result.log_likelihoods, None
    if mode is None:
        return thetas, log_w
    if mode == "MaximumLikelihood":
        if log_l is None:
            raise ValueError("mode='MaximumLikelihood' needs per-sample log-likelihoods; this result does "
                             "not carry them")
        i = int(torch.argmax(log_l))
    elif mode == "MAP":
        if log_post is None:
            raise ValueError("mode='MAP' needs per-sample log posterior densities; only nested-sampling "
                             "results carry (log_likelihoods, log_priors)")
        if bool(torch.isnan(log_post).all()):
            # evidence_sampling results built without log_priors carry a NaN
            # fill: argmax over it would pick sample 0 without a word
            raise ValueError("mode='MAP' needs log_priors; this result was built without them (NaN-filled)")
        i = int(torch.argmax(log_post))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return thetas[i:i + 1], torch.zeros((1,), dtype=log_w.dtype, device=log_w.device)


def _map_builder(build: Callable, thetas: torch.Tensor):
    """``build(theta)`` for every row of ``thetas`` as one distribution
    whose tensor fields carry a leading sample axis."""
    box = {}

    def one(theta):
        dist = build(theta)
        leaves = list(tensor_leaves(dist))
        box["template"], box["paths"] = dist, [p for p, _ in leaves]
        return tuple(v for _, v in leaves)

    values = torch.func.vmap(one)(thetas)
    # the template's tensors are the mapped call's; every one is replaced
    return with_leaves(box["template"], dict(zip(box["paths"], values)))


def predictive_distribution(result, dist_builder: Callable, mode: Optional[str] = None) -> Mixture:
    """Posterior predictive of an i.i.d. model: the mixture of
    ``dist_builder(theta_s)`` over the posterior samples, weighted by
    their posterior weights.  ``result`` is any engine output carrying
    weighted draws (see ``_select_samples``); ``dist_builder`` is mapped
    over the sample axis, so the component is one batched distribution."""
    thetas, log_w = _select_samples(result, mode)
    return Mixture(log_weights=log_w, component=_map_builder(dist_builder, thetas))


def regression_predictive_distribution(result, dist_builder: Callable, inputs,
                                       mode: Optional[str] = None) -> PointwiseMixture:
    """Posterior predictive of a regression model at ``inputs`` [m, d_in]
    (a 1-D [m] is m points of one input): per input point a mixture over
    the posterior samples, as one [S, m, ...] component.

    ``dist_builder(theta, x)`` returns the output distribution at inputs
    ``x``: scalar families map [m, d_in] to parameters [m]; vector outputs
    to event-shaped parameters [m, k], [m, k, k], ...  A parameter that is
    the same at every point (a noise level, a shared output covariance)
    may come back without the point axis; it is broadcast to [S, m, ...]
    here.  A per-theta vector parameter whose length happens to equal m is
    read as per-point: return it broadcast to [m, k] in that case."""
    thetas, log_w = _select_samples(result, mode)
    inputs = torch.as_tensor(inputs, device=thetas.device)
    inputs = inputs if inputs.is_floating_point() else inputs.to(thetas.dtype)
    if inputs.dim() == 1:
        inputs = inputs[:, None]
    component = _map_builder(lambda th: dist_builder(th, inputs), thetas)
    s, m = thetas.shape[0], inputs.shape[0]

    def norm(p):
        if p.dim() == 1:  # one scalar per theta
            p = p[:, None]
        elif p.shape[1] != m:  # event-shaped, one per theta
            p = p[:, None, ...]
        return torch.broadcast_to(p, (s, m) + tuple(p.shape[2:]))

    component = with_leaves(component, {path: norm(v) for path, v in tensor_leaves(component)})
    return PointwiseMixture(log_weights=log_w, component=component)


def posterior_predictive_check(result, dist_builder: Callable, data, statistic: Callable,
                               generator: Optional[torch.Generator] = None, num_replicates: int = 500,
                               mode: Optional[str] = None, *, indices=None, replicates=None):
    """Posterior predictive check: ``num_replicates`` replicated datasets
    (theta_s picked by posterior weight, then ``len(data)`` i.i.d. draws of
    ``dist_builder(theta_s)``), ``statistic`` of each against the observed
    one.  Returns ``(observed, replicated [R], p_value)`` with
    p = P(T(y_rep) >= T(y_obs)); values near 0 or 1 flag misfit in the
    direction ``statistic`` measures.  ``statistic`` maps a [n] dataset to
    a scalar and is mapped over the replicates with ``torch.func.vmap``.

    ``indices`` [R] (the picked samples) and ``replicates`` [R, n, ...]
    replace the generator's draws; a sample of log weight -inf is never
    picked."""
    thetas, log_w = _select_samples(result, mode)
    data = torch.as_tensor(data, device=thetas.device)
    data = data.to(thetas.dtype) if not data.is_floating_point() else data
    n = data.shape[0]
    if replicates is None:
        if generator is None:
            raise ValueError("posterior_predictive_check needs a generator, or indices= and replicates=")
        if indices is None:
            weights = torch.exp(log_w - logsumexp(log_w))
            indices = torch.multinomial(weights, num_replicates, replacement=True, generator=generator)
        picked = thetas[torch.as_tensor(indices, device=thetas.device)]  # [R, d]
        component = _map_builder(dist_builder, picked)
        # [n, R, ...] draws, each column from its own theta, then [R, n, ...]
        replicates = component.sample(generator, (n, picked.shape[0])).movedim(0, 1)
    replicates = torch.as_tensor(replicates, device=thetas.device)
    t_rep = torch.func.vmap(statistic)(replicates)
    t_obs = statistic(data)
    return t_obs, t_rep, torch.mean((t_rep >= t_obs).to(t_rep.dtype))
