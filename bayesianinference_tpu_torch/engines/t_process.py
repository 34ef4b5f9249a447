"""Student-t process regression with hyperparameter posteriors (port of
``bayesianinference_tpu.engines.t_process``).

``define_t_process`` mirrors ``define_gaussian_process`` with the Gaussian
marginal replaced by the heavy-tailed multivariate Student-t
(:mod:`..ops.t_process`, Shah et al. 2014).  The degrees of freedom are
fixed (``nu=4.0``) or inferred (``nu=callable(theta)``) like any other
hyperparameter.  ``predict_from_t_process`` maps the exact MVT conditional
over the posterior samples with ``torch.func.vmap`` (one batched Cholesky
launch per chunk) and returns a pointwise mixture of StudentT components.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Callable, Optional, Union

import torch

from ..core.device import as_float_on
from ..core.standardize import NormalizedData, normalize_data
from ..dists.pointwise import PointwiseMixture
from ..dists.scalar import StudentT
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.gp_kernels import covariance_matrix
from ..ops.t_process import tp_log_marginal_likelihood, tp_posterior_moments
from .gp import coordinate_bounds_grid
from .gp_classify import _samples_and_weights

__all__ = [
    "TPModel",
    "define_t_process",
    "predict_from_t_process",
]


@dataclasses.dataclass(frozen=True)
class TPModel:
    """Model functions attached to a Student-t-process problem.
    ``nu_builder(theta) -> scalar`` supplies the degrees of freedom."""

    x: torch.Tensor  # [n, d]
    y: torch.Tensor  # [n]
    kernel_builder: Callable
    nu_builder: Callable
    nugget_builder: Optional[Callable] = None
    mean_builder: Optional[Callable] = None

    def _pieces(self, theta):
        kernel = self.kernel_builder(theta)
        nugget = self.nugget_builder(theta) if self.nugget_builder else None
        mean_fn = self.mean_builder(theta) if self.mean_builder else None
        return kernel, nugget, mean_fn, self.nu_builder(theta)

    def log_marginal_likelihood(self, theta) -> torch.Tensor:
        kernel, nugget, mean_fn, nu = self._pieces(theta)
        mean = mean_fn(self.x) if mean_fn is not None else None
        k = covariance_matrix(kernel, self.x, nugget, symmetrize=not kernel.exactly_symmetric)
        return tp_log_marginal_likelihood(k, self.y, nu, mean=mean)

    def posterior_moments(self, theta, x_query, query_nugget: bool = True):
        kernel, nugget, mean_fn, nu = self._pieces(theta)
        return tp_posterior_moments(kernel, self.x, self.y, x_query, nu, nugget=nugget, mean_fn=mean_fn,
                                    query_nugget=query_nugget)

    def predict_bytes_per_sample(self) -> int:
        return 4 * self.x.shape[0] * self.x.shape[0]


def define_t_process(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    nu: Union[float, Callable] = 4.0,
    nugget_builder: Optional[Callable] = None,
    mean_builder: Optional[Callable] = None,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    normalize: bool = False,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> InferenceProblem:
    """The inference problem of Student-t-process hyperparameters.

    ``nu``: a fixed float (> 0), or a callable ``theta -> scalar`` to infer
    the degrees of freedom.  The problem lives on ``x``'s device and dtype;
    data that is not a tensor goes to ``device`` (the card when ``None``)."""
    if kernel_builder is None:
        raise ValueError(
            "define_t_process requires a kernel (the pure-nugget model has no Student-t analogue: a diagonal "
            "MVT is not an independent product)"
        )
    if callable(nu):
        nu_builder = nu
    else:
        if float(nu) <= 0:
            raise ValueError(f"nu must be positive, got {nu}")
        nu_const = float(nu)

        def nu_builder(theta, _v=nu_const):
            return torch.full((), _v, dtype=theta.dtype, device=theta.device)

    x = torch.atleast_2d(as_float_on(x, device))
    y = torch.as_tensor(y, device=x.device, dtype=x.dtype)
    if y.dim() == 2:
        if y.shape[1] != 1:
            raise ValueError(f"only 1-D output supported for TP regression, got {tuple(y.shape)}")
        y = y[:, 0]
    if x.shape[0] != y.shape[0]:
        raise ValueError("input and output data are not of the same length")
    norm: Optional[NormalizedData] = None
    if normalize:
        norm = normalize_data(x, y[:, None])
        x, y = norm.x, norm.y[:, 0]
    model = TPModel(x=x, y=y, kernel_builder=kernel_builder, nu_builder=nu_builder, nugget_builder=nugget_builder,
                    mean_builder=mean_builder)
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=model.log_marginal_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=x.device,
        dtype=x.dtype,
        t_process=model,
        data_preprocessors=norm,
    )


def predict_from_t_process(
    result,
    problem: InferenceProblem,
    points,
    *,
    query_nugget: bool = True,
    max_samples: Optional[int] = 512,
    sample_chunk: Optional[int] = None,
) -> PointwiseMixture:
    """Posterior-predictive TP at query points: for each posterior sample
    the exact MVT conditional StudentT(df*, m*, s*), mixed with the crude
    posterior weights.  ``points`` is [m, d] or an integer (a grid with
    that many points per dimension over the training inputs' bounds)."""
    model: TPModel = (problem.metadata or {}).get("t_process")
    if model is None:
        raise ValueError("problem has no attached TPModel metadata")
    if isinstance(points, numbers.Integral) and not isinstance(points, bool):
        points = coordinate_bounds_grid(model.x, int(points))
    points = torch.atleast_2d(torch.as_tensor(points, dtype=model.x.dtype, device=model.x.device))
    thetas, log_w = _samples_and_weights(result, model.x, max_samples)
    one = torch.func.vmap(lambda th: model.posterior_moments(th, points, query_nugget))
    n_samp = thetas.shape[0]
    if sample_chunk is None:
        sample_chunk = max(1, min(n_samp, int(4e9) // max(model.predict_bytes_per_sample(), 1)))
    parts = [one(thetas[i:i + sample_chunk]) for i in range(0, n_samp, sample_chunk)]
    means, scales, dfs = (torch.cat([p[j] for p in parts]) for j in range(3))
    return PointwiseMixture(
        log_weights=log_w,
        component=StudentT(df=torch.broadcast_to(dfs[:, None], means.shape), loc=means,
                           scale=torch.clamp(scales, min=1e-12)),
    )
