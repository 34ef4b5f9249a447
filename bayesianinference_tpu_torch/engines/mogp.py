"""Multi-output (coregionalized) GP regression with hyperparameter
posteriors (port of ``bayesianinference_tpu.engines.mogp``).

``define_multi_output_gp`` mirrors ``define_gaussian_process`` for T
correlated outputs through the intrinsic coregionalization model
(:mod:`..ops.mogp`): one input kernel, a learned B = a a^T + diag(d),
per-output noise.  Missing observations (NaN in y, or an ``observed``
mask) become gather indices into the flat grid when the problem is built.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import as_float_on
from ..dists.pointwise import PointwiseMixture
from ..dists.scalar import Normal
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.mogp import mogp_log_marginal_kronecker, mogp_log_marginal_likelihood, mogp_posterior_moments
from .gp_classify import _samples_and_weights

__all__ = [
    "MOGPModel",
    "define_multi_output_gp",
    "predict_from_multi_output_gp",
]


@dataclasses.dataclass(frozen=True)
class MOGPModel:
    """Model functions attached to a multi-output GP problem.

    ``b_builder(theta) -> [T, T]`` (use :func:`..ops.mogp.coregional_matrix`),
    ``noise_builder(theta) -> [T] | scalar`` (optional)."""

    x: torch.Tensor  # [n, d]
    y_obs: torch.Tensor  # [k] observed flat values (output-major gather)
    num_outputs: int
    kernel_builder: Callable
    b_builder: Callable
    noise_builder: Optional[Callable] = None
    observed_idx: Optional[torch.Tensor] = None  # [k] or None (= all)
    jitter: float = 1e-6
    method: str = "dense"  # "dense" | "kronecker"
    y_grid: Optional[torch.Tensor] = None  # [n, T] when fully observed

    def _noise(self, theta):
        if self.noise_builder is None:
            return None
        nv = torch.as_tensor(self.noise_builder(theta), dtype=self.x.dtype, device=self.x.device)
        return torch.broadcast_to(nv, (self.num_outputs,))

    def log_marginal_likelihood(self, theta) -> torch.Tensor:
        if self.method == "kronecker":
            nv = self._noise(theta)
            return mogp_log_marginal_kronecker(self.kernel_builder(theta), self.b_builder(theta), self.x,
                                               self.y_grid, nv[0] if nv is not None else 0.0, jitter=self.jitter)
        return mogp_log_marginal_likelihood(self.kernel_builder(theta), self.b_builder(theta), self.x, self.y_obs,
                                            noise_variances=self._noise(theta), observed_idx=self.observed_idx,
                                            jitter=self.jitter)

    def posterior_moments(self, theta, x_query):
        return mogp_posterior_moments(self.kernel_builder(theta), self.b_builder(theta), self.x, self.y_obs,
                                      x_query, noise_variances=self._noise(theta), observed_idx=self.observed_idx,
                                      jitter=self.jitter)

    def predict_bytes_per_sample(self) -> int:
        k = self.y_obs.shape[0]
        return 4 * k * k


def define_multi_output_gp(
    x,
    y,
    kernel_builder: Callable,
    b_builder: Callable,
    parameters,
    *,
    noise_builder: Optional[Callable] = None,
    observed=None,
    jitter: float = 1e-6,
    method: str = "dense",
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> InferenceProblem:
    """Inference problem for coregionalized-GP hyperparameters.

    ``y``: [n, T] outputs (NaN entries are missing); ``observed``: an
    optional [n, T] boolean mask overriding the NaN rule.  The mask becomes
    gather indices on the host, when the problem is built.
    ``method="kronecker"`` takes the Saatci eigendecomposition identity,
    valid only for a FULL grid with a SCALAR noise builder.  The problem
    lives on ``x``'s device and dtype; data that is not a tensor goes to
    ``device`` (the card when ``None``)."""
    if method not in ("dense", "kronecker"):
        raise ValueError(f"method must be dense or kronecker, got {method!r}")
    x = torch.atleast_2d(as_float_on(x, device))
    y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y, float)
    if y.ndim != 2 or y.shape[0] != x.shape[0]:
        raise ValueError(f"need x [n, d] and y [n, T]; got {tuple(x.shape)} and {y.shape}")
    n, t = y.shape
    if t < 2:
        raise ValueError("multi-output GP needs T >= 2 outputs; use define_gaussian_process for one")
    observed = ~np.isnan(y) if observed is None else np.asarray(observed, bool)
    if observed.shape != y.shape:
        raise ValueError(f"observed mask {observed.shape} must match y {y.shape}")
    if not observed.any():
        raise ValueError("no observed entries")
    if np.isnan(y[observed]).any():
        raise ValueError("NaN y entries flagged observed")
    # output-major flat order, as ops.mogp_covariance lays the grid out
    idx = np.nonzero(observed.T.reshape(-1))[0]
    on = dict(dtype=x.dtype, device=x.device)
    y_obs = torch.as_tensor(y.T.reshape(-1)[idx], **on)
    all_observed = bool(observed.all())
    if method == "kronecker" and not all_observed:
        raise ValueError("method='kronecker' needs every output observed at every input (use the dense default "
                         "for missing data)")
    model = MOGPModel(
        x=x, y_obs=y_obs, num_outputs=t, kernel_builder=kernel_builder, b_builder=b_builder,
        noise_builder=noise_builder,
        observed_idx=None if all_observed else torch.as_tensor(idx, dtype=torch.int64, device=x.device),
        jitter=float(jitter), method=method, y_grid=torch.as_tensor(y, **on) if all_observed else None,
    )
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=model.log_marginal_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=x.device,
        dtype=x.dtype,
        multi_output_gp=model,
    )


def predict_from_multi_output_gp(
    result,
    problem: InferenceProblem,
    points,
    *,
    max_samples: Optional[int] = 256,
    sample_chunk: Optional[int] = None,
) -> PointwiseMixture:
    """Posterior-averaged predictions of EVERY output at query points: a
    :class:`PointwiseMixture` whose point axis is the flattened (query,
    output) grid in output-major order (reshape ``mean()`` etc. with
    ``.reshape(T, m).mT``)."""
    model: MOGPModel = (problem.metadata or {}).get("multi_output_gp")
    if model is None:
        raise ValueError("problem has no attached MOGPModel metadata")
    points = torch.atleast_2d(torch.as_tensor(points, dtype=model.x.dtype, device=model.x.device))
    thetas, log_w = _samples_and_weights(result, model.x, max_samples)

    def one(theta):
        mean, std = model.posterior_moments(theta, points)  # [m, T]
        return mean.mT.reshape(-1), std.mT.reshape(-1)  # output-major flat

    batched = torch.func.vmap(one)
    n_samp = thetas.shape[0]
    if sample_chunk is None:
        sample_chunk = max(1, min(n_samp, int(4e9) // max(model.predict_bytes_per_sample(), 1)))
    parts = [batched(thetas[i:i + sample_chunk]) for i in range(0, n_samp, sample_chunk)]
    means, stds = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return PointwiseMixture(log_weights=log_w, component=Normal(loc=means, scale=torch.clamp(stds, min=1e-12)))
