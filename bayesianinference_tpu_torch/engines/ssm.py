"""State-space model front end: exact-likelihood time-series inference
(port of ``bayesianinference_tpu.engines.ssm``).

``define_state_space_model`` builds an :class:`InferenceProblem` whose
likelihood is the exact Kalman marginal p(y | theta) (:mod:`..ops.kalman`),
so every engine does hyperparameter inference with no approximation.
Structural components (local level, local linear trend, seasonal dummies,
AR(p) in companion form) combine block-diagonally into one LGSSM, the
Bayesian-structural-time-series construction.

The user's ``model_builder(theta) -> LGSSM`` stays per point, as in the
JAX package.  The problem is built with ``batched_likelihood``: a density
call maps the builder over the batch [B, d] once with ``torch.func.vmap``
(the component builders below are written to batch) and runs one filter
over the batched model, so each time step is one set of [B, ds, ds]
products instead of B.

The JAX package builds components with ``.at[...].set``; here blocks and
one-hot entries are assembled with ``torch.cat`` and ``torch.where``, which
leave the other entries exactly zero under ``vmap`` too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.kalman import (
    LGSSM,
    KalmanSampleDraws,
    kalman_filter,
    kalman_forecast,
    kalman_log_likelihood,
    kalman_smoother,
    simulation_smoother,
)

__all__ = [
    "SSMComponent",
    "level_component",
    "trend_component",
    "seasonal_component",
    "ar_component",
    "structural_lgssm",
    "define_state_space_model",
    "smoothed_states",
    "forecast_observations",
    "sample_state_paths",
]


class SSMComponent(NamedTuple):
    """One additive structural block: state transition, process noise, the
    observation row that reads it, and the initial moments.  Combine with
    :func:`structural_lgssm`."""

    transition: torch.Tensor  # [k, k]
    transition_noise: torch.Tensor  # [k, k]
    observation_row: torch.Tensor  # [k]
    initial_mean: torch.Tensor  # [k]
    initial_cov: torch.Tensor  # [k, k]


def _f(x, ref: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """``x`` as a floating tensor: a tensor keeps its device; a number takes
    ``ref``'s dtype and device, else ``device`` (the card when ``None``)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.get_default_dtype())
    if ref is not None:
        return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(x, dtype=torch.get_default_dtype(), device=resolve_device(device))


def _one_hot(k: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.arange(k * k, device=ref.device).reshape(k, k) == 0


def _shift(k: int, ref: torch.Tensor) -> torch.Tensor:
    """[k - 1, k]: rows 1..k-1 of a companion matrix (the subdiagonal ones)."""
    return torch.cat([torch.eye(k - 1, dtype=ref.dtype, device=ref.device),
                      torch.zeros((k - 1, 1), dtype=ref.dtype, device=ref.device)], dim=1)


def level_component(level_var, initial_level=0.0, initial_var=1e2, *, device=None) -> SSMComponent:
    """Local level (random walk): mu_t = mu_{t-1} + eps, eps ~ N(0, level_var)."""
    lv = _f(level_var, device=device)
    one = torch.ones((1, 1), dtype=lv.dtype, device=lv.device)
    return SSMComponent(
        transition=one,
        transition_noise=lv * one,
        observation_row=torch.ones((1,), dtype=lv.dtype, device=lv.device),
        initial_mean=_f(initial_level, lv).reshape(1),
        initial_cov=_f(initial_var, lv) * one,
    )


def trend_component(level_var, slope_var, initial_level=0.0, initial_var=1e2, *, device=None) -> SSMComponent:
    """Local linear trend: the level integrates a random-walk slope."""
    lv = _f(level_var, device=device)
    kw = dict(dtype=lv.dtype, device=lv.device)
    return SSMComponent(
        transition=torch.tensor([[1.0, 1.0], [0.0, 1.0]], **kw),
        transition_noise=torch.diag_embed(torch.stack([lv, _f(slope_var, lv)])),
        observation_row=torch.tensor([1.0, 0.0], **kw),
        initial_mean=torch.stack([_f(initial_level, lv), torch.zeros((), **kw)]),
        initial_cov=_f(initial_var, lv) * torch.eye(2, **kw),
    )


def seasonal_component(period: int, seasonal_var, initial_var=1e2, *, device=None) -> SSMComponent:
    """Dummy-variable seasonality: s_t = -(s_{t-1} + ... + s_{t-period+1})
    + eps; the state carries the period - 1 most recent effects."""
    sv = _f(seasonal_var, device=device)
    kw = dict(dtype=sv.dtype, device=sv.device)
    k = period - 1
    f = torch.cat([torch.full((1, k), -1.0, **kw), _shift(k, sv)], dim=0)
    return SSMComponent(
        transition=f,
        transition_noise=torch.where(_one_hot(k, sv), sv, torch.zeros((), **kw)),
        observation_row=(torch.arange(k, device=sv.device) == 0).to(sv.dtype),
        initial_mean=torch.zeros((k,), **kw),
        initial_cov=_f(initial_var, sv) * torch.eye(k, **kw),
    )


def ar_component(coefficients, noise_var, initial_var=None, *, device=None) -> SSMComponent:
    """Stationary AR(p) in companion form; ``initial_var`` defaults to a
    diffuse diagonal (1e2)."""
    phi = torch.atleast_1d(_f(coefficients, device=device))
    nv = _f(noise_var, phi)
    kw = dict(dtype=phi.dtype, device=phi.device)
    p = phi.shape[0]
    f = phi[None, :] if p == 1 else torch.cat([phi[None, :], _shift(p, phi)], dim=0)
    iv = _f(1e2 if initial_var is None else initial_var, phi)
    return SSMComponent(
        transition=f,
        transition_noise=torch.where(_one_hot(p, phi), nv, torch.zeros((), **kw)),
        observation_row=(torch.arange(p, device=phi.device) == 0).to(phi.dtype),
        initial_mean=torch.zeros((p,), **kw),
        initial_cov=iv * torch.eye(p, **kw),
    )


def _block_diag(blocks, dtype, device) -> torch.Tensor:
    dims = [b.shape[-1] for b in blocks]
    total = sum(dims)
    rows, off = [], 0
    for b, k in zip(blocks, dims):
        rows.append(torch.cat([torch.zeros((k, off), dtype=dtype, device=device), b.to(dtype),
                               torch.zeros((k, total - off - k), dtype=dtype, device=device)], dim=1))
        off += k
    return torch.cat(rows, dim=0)


def structural_lgssm(components: Sequence[SSMComponent], obs_var, *, device=None) -> LGSSM:
    """Block-diagonal combination of additive components observing
    y_t = sum_i (h_i . x_i,t) + N(0, obs_var): the BSTS assembly."""
    if not components:
        raise ValueError("need at least one SSMComponent")
    ref = next((x for c in components for x in c if isinstance(x, torch.Tensor)), None)
    ov = _f(obs_var, None if isinstance(obs_var, torch.Tensor) else ref, device=device)
    dtype, dev = ov.dtype, ov.device
    return LGSSM(
        transition=_block_diag([c.transition for c in components], dtype, dev),
        transition_noise=_block_diag([c.transition_noise for c in components], dtype, dev),
        observation=torch.cat([c.observation_row.to(dtype) for c in components])[None, :],
        observation_noise=torch.reshape(ov, (1, 1)),
        initial_mean=torch.cat([c.initial_mean.to(dtype) for c in components]),
        initial_cov=_block_diag([c.initial_cov for c in components], dtype, dev),
    )


def _batched_models(builder: Callable, theta: torch.Tensor) -> LGSSM:
    """``builder`` mapped over theta [B, d]: one LGSSM of [B, ...] tensors
    (absent offsets as zeros)."""
    def one(th):
        m = builder(th)
        c, d = m.offsets()
        return tuple(m[:6]) + (c, d)

    return LGSSM(*torch.func.vmap(one)(theta))


def define_state_space_model(
    y,
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
    """Hyperparameter-inference problem for a linear-Gaussian SSM.

    ``model_builder(theta) -> LGSSM`` for one theta [d] (use
    :func:`structural_lgssm` and the component constructors, or build it by
    hand with operations that batch under ``torch.func.vmap``).  The
    likelihood is the exact Kalman marginal; a non-PD innovation covariance
    yields NaN, which the problem's guard maps to the log-zero sentinel.

    The problem's ``log_likelihood`` takes the batch [B, d] (or one theta
    [d]) itself.  ``mask``: [T] bool, True = observed.  ``method``: ``"sequential"`` or
    ``"parallel"`` (log-depth in T: the form for long series and for the
    gradient-hungry engines on the card).  The problem lives on ``y``'s
    device (a tensor) or on ``device`` (the card when ``None``)."""
    if isinstance(y, torch.Tensor):
        y = y if device is None else y.to(torch.device(device))
    else:
        y = torch.as_tensor(y, device=resolve_device(device))
    y = y.to(dtype or (y.dtype if y.is_floating_point() else torch.get_default_dtype()))
    mask_arr = None if mask is None else torch.as_tensor(mask, device=y.device)

    def log_likelihood(theta):
        one = theta.dim() == 1  # a single theta [d] runs as a batch of one
        ll = kalman_log_likelihood(_batched_models(model_builder, torch.atleast_2d(theta)), y, mask=mask_arr,
                                   method=method)
        return ll[0] if one else ll

    return define_inference_problem(
        parameters=parameters,
        log_likelihood=log_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=y.device,
        dtype=y.dtype,
        batched_likelihood=True,
        state_space={"y": y, "mask": mask_arr, "model_builder": model_builder, "method": method},
    )


def _ssm_meta(problem: InferenceProblem) -> dict:
    meta = (problem.metadata or {}).get("state_space")
    if meta is None:
        raise ValueError("problem was not built by define_state_space_model")
    return meta


def _theta(problem: InferenceProblem, theta) -> torch.Tensor:
    return torch.as_tensor(theta, dtype=problem.dtype, device=problem.device)


def smoothed_states(problem: InferenceProblem, theta):
    """RTS-smoothed state marginals p(x_t | y, theta) for one theta [d]."""
    meta = _ssm_meta(problem)
    model = meta["model_builder"](_theta(problem, theta))
    return kalman_smoother(model, meta["y"], mask=meta["mask"], method=meta["method"])


def sample_state_paths(
    problem: InferenceProblem,
    generator: Optional[torch.Generator],
    theta,
    paths_per_theta: int = 1,
    draws: Optional[KalmanSampleDraws] = None,
):
    """Joint posterior draws of the latent state path, integrating the
    hyperparameter uncertainty: for each theta_s (any engine's draws),
    ``paths_per_theta`` draws of x ~ p(x | y, theta_s) by the simulation
    smoother.  ``theta`` [d] or [S, d]; returns [S, paths_per_theta, T, ds].
    All S x paths_per_theta smoother passes run as one batch.  ``draws``
    (leading axes [S, paths_per_theta]) replace the generator's normals."""
    meta = _ssm_meta(problem)
    theta = torch.atleast_2d(_theta(problem, theta))
    models = _batched_models(meta["model_builder"], theta)
    return simulation_smoother(generator, models, meta["y"], paths_per_theta, mask=meta["mask"],
                               method=meta["method"], draws=draws)


def forecast_observations(problem: InferenceProblem, theta, steps: int):
    """h-step-ahead observation forecast (means [steps, do], covs [steps, do,
    do]) from the filtered state at T."""
    meta = _ssm_meta(problem)
    model = meta["model_builder"](_theta(problem, theta))
    fr = kalman_filter(model, meta["y"], mask=meta["mask"], method=meta["method"])
    return kalman_forecast(model, fr, steps)
