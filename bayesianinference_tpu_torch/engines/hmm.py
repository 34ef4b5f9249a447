"""Hidden-Markov-model front end: exact discrete-latent inference (port of
``bayesianinference_tpu.engines.hmm``).

``define_hidden_markov_model`` builds an :class:`InferenceProblem` whose
likelihood is the exact HMM marginal p(y | theta) (:mod:`..ops.hmm`).  The
builder contract is the JAX package's, per point:

    model_builder(theta) -> (HMM, log_obs [T, K])

The problem is built with ``batched_likelihood``: a density call maps the
builder over the batch [B, d] once with ``torch.func.vmap`` and runs one
forward pass over the batched chain, each step one [B, K, K] log-sum-exp.

Consumers mirror :mod:`.ssm`: smoothed regime probabilities, the Viterbi
path, forecasts, and joint hidden-path draws over parameter draws
(Gumbel noise as an input, :func:`..ops.hmm.hmm_gumbels`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.device import resolve_device
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.hmm import HMM, hmm_filter, hmm_forecast, hmm_log_likelihood, hmm_posterior_sample, hmm_smoother, hmm_viterbi

__all__ = [
    "define_hidden_markov_model",
    "regime_probabilities",
    "most_likely_states",
    "sample_hidden_paths",
    "forecast_regime_probabilities",
]


def _batched(builder: Callable, theta: torch.Tensor):
    """``builder`` mapped over theta [B, d]: (HMM of [B, ...], log_obs [B, T, K])."""
    def one(th):
        hmm, log_obs = builder(th)
        return hmm.initial_log_probs, hmm.transition_log_probs, log_obs

    pi, log_a, log_obs = torch.func.vmap(one)(theta)
    return HMM(pi, log_a), log_obs


def define_hidden_markov_model(
    model_builder: Callable,
    parameters,
    *,
    mask=None,
    method: str = "sequential",
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> InferenceProblem:
    """Parameter-inference problem for a discrete-state HMM.

    ``model_builder(theta) -> (HMM, log_obs [T, K])`` for one theta [d]
    (close over the data; rows from :func:`..ops.hmm.row_stochastic`;
    operations that batch under ``torch.func.vmap``).  NaN from
    out-of-support emission parameters becomes the log-zero sentinel in the
    problem's guard.  The problem's ``log_likelihood`` takes the batch [B,
    d] (or one theta [d]).  ``mask``: [T] bool, True = observed.
    ``method``: ``"sequential"`` or ``"parallel"``.  The problem lives on
    ``device`` (the card when ``None``) in ``dtype``."""
    device = resolve_device(device)
    mask_arr = None if mask is None else torch.as_tensor(mask, device=device)

    def log_likelihood(theta):
        one = theta.dim() == 1  # a single theta [d] runs as a batch of one
        hmm, log_obs = _batched(model_builder, torch.atleast_2d(theta))
        ll = hmm_log_likelihood(hmm, log_obs, mask=mask_arr, method=method)
        return ll[0] if one else ll

    return define_inference_problem(
        parameters=parameters,
        log_likelihood=log_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=device,
        dtype=dtype,
        batched_likelihood=True,
        hidden_markov={"model_builder": model_builder, "mask": mask_arr, "method": method},
    )


def _hmm_meta(problem: InferenceProblem) -> dict:
    meta = (problem.metadata or {}).get("hidden_markov")
    if meta is None:
        raise ValueError("problem was not built by define_hidden_markov_model")
    return meta


def _build(problem: InferenceProblem, theta):
    meta = _hmm_meta(problem)
    return meta, meta["model_builder"](torch.as_tensor(theta, dtype=problem.dtype, device=problem.device))


def regime_probabilities(problem: InferenceProblem, theta):
    """Smoothed regime probabilities p(z_t = k | y, theta) [T, K] for one
    theta [d]."""
    meta, (hmm, log_obs) = _build(problem, theta)
    return torch.exp(hmm_smoother(hmm, log_obs, mask=meta["mask"], method=meta["method"]))


def most_likely_states(problem: InferenceProblem, theta):
    """Viterbi path argmax_z p(z_{1:T} | y, theta) [T] (int64)."""
    meta, (hmm, log_obs) = _build(problem, theta)
    return hmm_viterbi(hmm, log_obs, mask=meta["mask"])


def forecast_regime_probabilities(problem: InferenceProblem, theta, steps: int):
    """h-step-ahead regime probabilities p(z_{T+h} = k | y, theta) [steps, K]."""
    meta, (hmm, log_obs) = _build(problem, theta)
    fr = hmm_filter(hmm, log_obs, mask=meta["mask"], method=meta["method"])
    return torch.exp(hmm_forecast(hmm, fr, steps))


def sample_hidden_paths(
    problem: InferenceProblem,
    generator: Optional[torch.Generator],
    theta,
    paths_per_theta: int = 1,
    gumbels: Optional[torch.Tensor] = None,
):
    """Joint posterior draws of the hidden path over parameter draws: for each
    theta_s, ``paths_per_theta`` draws of z ~ p(z | y, theta_s) by forward
    filtering and backward sampling, all as one batch.  ``theta`` [d] or [S,
    d]; returns [S, paths_per_theta, T] (int64).  ``gumbels`` [S,
    paths_per_theta, T, K] replace the generator's noise."""
    meta = _hmm_meta(problem)
    theta = torch.atleast_2d(torch.as_tensor(theta, dtype=problem.dtype, device=problem.device))
    hmm, log_obs = _batched(meta["model_builder"], theta)
    return hmm_posterior_sample(generator, hmm, log_obs, paths_per_theta, mask=meta["mask"], method=meta["method"],
                                gumbels=gumbels)
