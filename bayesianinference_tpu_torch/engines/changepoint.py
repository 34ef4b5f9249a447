"""Changepoint-model front end: streaming segmentation and hazard inference
(port of ``bayesianinference_tpu.engines.changepoint``).

Built on :mod:`..ops.bocpd`: the per-step normalizers compose to the exact
marginal likelihood p(y | hazard, segment hyperparameters), so
``define_changepoint_model`` hands every engine an exact, differentiable
likelihood.  ``model_builder(theta) -> (UPM, hazard)`` returns closures, so
the likelihood stays per point and the problem maps it over the batch with
``torch.func.vmap``: the host loop over time runs once, on [B, r_max]
tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.device import resolve_device
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.bocpd import BOCPDResult, bocpd

__all__ = [
    "define_changepoint_model",
    "run_length_posterior",
    "changepoint_probability",
]


def define_changepoint_model(
    y,
    model_builder: Callable,
    parameters,
    *,
    r_max: Optional[int] = None,
    mask=None,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> InferenceProblem:
    """Inference problem over changepoint-model parameters.

    ``model_builder(theta) -> (UPM, hazard)`` (:func:`..ops.bocpd.gaussian_upm`,
    :func:`..ops.bocpd.poisson_upm` or any conjugate UPM triple).  ``r_max``
    caps the run-length buffer (default the series length: exact).  NaN from
    out-of-support parameters becomes the log-zero sentinel in the problem's
    guard.  The problem lives on ``y``'s device (a tensor) or on ``device``
    (the card when ``None``)."""
    if isinstance(y, torch.Tensor):
        y = y if device is None else y.to(torch.device(device))
    else:
        y = torch.as_tensor(y, device=resolve_device(device))
    y = y if y.is_floating_point() else y.to(torch.get_default_dtype())
    mask_arr = None if mask is None else torch.as_tensor(mask, device=y.device)

    def log_likelihood(theta):
        upm, hazard = model_builder(theta)
        return bocpd(y, upm, hazard, r_max=r_max, mask=mask_arr).log_likelihood

    return define_inference_problem(
        parameters=parameters,
        log_likelihood=log_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=y.device,
        dtype=y.dtype,
        changepoint={"y": y, "mask": mask_arr, "r_max": r_max, "model_builder": model_builder},
    )


def _cp_meta(problem: InferenceProblem) -> dict:
    meta = (problem.metadata or {}).get("changepoint")
    if meta is None:
        raise ValueError("problem was not built by define_changepoint_model")
    return meta


def run_length_posterior(problem: InferenceProblem, theta) -> BOCPDResult:
    """Run-length filter at one theta [d]: log p(r_t | y_{1:t}, theta)
    [T, r_max] and the exact marginal log-likelihood."""
    meta = _cp_meta(problem)
    upm, hazard = meta["model_builder"](torch.as_tensor(theta, dtype=problem.dtype, device=problem.device))
    return bocpd(meta["y"], upm, hazard, r_max=meta["r_max"], mask=meta["mask"])


def changepoint_probability(problem: InferenceProblem, theta):
    """p(r_t = 0 | y_{1:t}) [T].  ``theta`` [d] gives the filter at one
    vector; [S, d] (posterior draws) averages the S filters, run as one
    ``vmap`` batch.  Draws outside the model's support (hazard not in
    (0, 1), a non-finite likelihood or probability) are dropped from the
    average: the guarded log-sum-exp makes an invalid hazard's filter
    finite but meaningless, so the hazard itself is tested."""
    meta = _cp_meta(problem)
    theta = torch.atleast_2d(torch.as_tensor(theta, dtype=problem.dtype, device=problem.device))

    def one(th):
        upm, hazard = meta["model_builder"](th)
        res = bocpd(meta["y"], upm, hazard, r_max=meta["r_max"], mask=meta["mask"])
        h = torch.as_tensor(hazard, dtype=th.dtype, device=th.device)
        valid = (h > 0.0) & (h < 1.0) & torch.isfinite(res.log_likelihood)
        return torch.exp(res.log_run_length[:, 0]), valid

    cps, ok = torch.func.vmap(one)(theta)  # [S, T], [S]
    ok = ok & torch.isfinite(cps).all(dim=1)
    denom = torch.clamp(ok.to(cps.dtype).sum(), min=1.0)
    return torch.where(ok[:, None], cps, torch.zeros((), dtype=cps.dtype, device=cps.device)).sum(dim=0) / denom
