"""Gaussian-process regression with full hyperparameter posteriors (port of
``bayesianinference_tpu.engines.gp``).

:func:`define_gaussian_process` builds an :class:`InferenceProblem` whose
per-point likelihood is the GP log marginal likelihood; the problem
batches it with ``torch.func.vmap``, so one nested-sampling chain step
assembles and factors the covariances of all its chains in one call of
each custom op.  :func:`predict_from_gaussian_process` maps the posterior
moments over the posterior samples the same way.
"""

from __future__ import annotations

import dataclasses
import numbers
import warnings
from typing import Callable, Optional

import torch

from ..core.device import as_float_on
from ..core.numerics import as_float
from ..core.standardize import NormalizedData, normalize_data
from ..dists.base import as_param
from ..dists.multivariate import MultivariateNormal
from ..dists.pointwise import PointwiseMixture
from ..dists.scalar import Normal
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.gp_kernels import covariance_matrix, gp_log_marginal_likelihood, gp_posterior_moments
from .evidence import NestedSamplingResult

__all__ = [
    "GPModel",
    "coordinate_bounds_grid",
    "define_gaussian_process",
    "predict_from_gaussian_process",
]


def coordinate_bounds_grid(x, num: int) -> torch.Tensor:
    """Cartesian grid [num^d, d] with ``num`` points per dimension spanning
    the coordinate bounds of the training inputs."""
    if num < 2:
        raise ValueError("need at least 2 grid points per dimension")
    x = as_float(x)
    if x.dim() == 1:
        x = x[:, None]  # n points in 1-D, not one point in n-D
    lo, hi = x.amin(dim=0), x.amax(dim=0)
    axes = [torch.linspace(float(lo[j]), float(hi[j]), num, dtype=x.dtype, device=x.device)
            for j in range(x.shape[1])]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


@dataclasses.dataclass(frozen=True)
class GPModel:
    """The model functions of a GP problem:

    * ``kernel_builder(theta) -> Kernel`` (None: pure-nugget model);
    * ``nugget_builder(theta) -> scalar | [n] | callable`` (optional);
    * ``mean_builder(theta) -> callable x -> [n]`` (optional).

    ``logml_method``: "direct" (the Cholesky logML) or "automatic" (the
    multivariate-normal log-density of y).
    """

    x: torch.Tensor  # [n, d]
    y: torch.Tensor  # [n]
    kernel_builder: Optional[Callable]
    nugget_builder: Optional[Callable] = None
    mean_builder: Optional[Callable] = None
    logml_method: str = "direct"

    def _pieces(self, theta):
        kernel = self.kernel_builder(theta) if self.kernel_builder else None
        nugget = self.nugget_builder(theta) if self.nugget_builder else None
        mean_fn = self.mean_builder(theta) if self.mean_builder else None
        return kernel, nugget, mean_fn

    def _nugget_at(self, nugget, x) -> torch.Tensor:
        return nugget(x) if callable(nugget) else torch.broadcast_to(as_param(nugget, x), (x.shape[0],))

    def log_marginal_likelihood(self, theta) -> torch.Tensor:
        """logML(theta) for one parameter vector; the null-kernel model is
        an independent heteroscedastic Gaussian likelihood."""
        kernel, nugget, mean_fn = self._pieces(theta)
        y = self.y - (mean_fn(self.x) if mean_fn is not None else 0.0)
        if kernel is None:
            scale = torch.sqrt(self._nugget_at(nugget, self.x))
            return torch.sum(Normal(loc=0.0, scale=scale).log_prob(y))
        # the factorization reads one triangle; built-in kernels are
        # exactly symmetric and skip the symmetrization pass
        k = covariance_matrix(kernel, self.x, nugget, symmetrize=not kernel.exactly_symmetric)
        if self.logml_method == "automatic":
            return torch.sum(MultivariateNormal(mean_=torch.zeros_like(y), cov=k).log_prob(y))
        return gp_log_marginal_likelihood(k, y)

    def posterior_moments(self, theta, x_query, query_nugget: bool = True):
        kernel, nugget, mean_fn = self._pieces(theta)
        if kernel is None:
            m = mean_fn(x_query) if mean_fn is not None else torch.zeros(
                x_query.shape[0], dtype=x_query.dtype, device=x_query.device)
            return m, torch.sqrt(self._nugget_at(nugget, x_query))
        return gp_posterior_moments(
            kernel, self.x, self.y, x_query,
            nugget=nugget, mean_fn=mean_fn, query_nugget=query_nugget,
        )

    def predict_bytes_per_sample(self) -> int:
        """Bytes of the [n, n] covariance per vmapped posterior sample."""
        return self.x.element_size() * self.x.shape[0] ** 2


def define_gaussian_process(
    x,
    y,
    kernel_builder: Optional[Callable],
    parameters,
    *,
    nugget_builder: Optional[Callable] = None,
    mean_builder: Optional[Callable] = None,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    normalize: bool = False,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    log_likelihood_method: str = "direct",
    device=None,
) -> InferenceProblem:
    """The inference problem of GP hyperparameters given data ``x`` [n, d]
    and ``y`` [n] (or [n, 1]); it lives on ``x``'s device, in its dtype.
    Data that is not a tensor (numpy arrays, lists) goes to ``device``:
    the CUDA card when that is ``None``, never the CPU unasked.

    ``normalize=True`` standardizes x and y and keeps the transforms as
    the problem's ``data_preprocessors`` metadata.
    ``log_likelihood_method``: "direct" (Cholesky logML) or "automatic"
    (multivariate-normal log-density); both agree to numerical precision."""
    if log_likelihood_method not in ("direct", "automatic"):
        raise ValueError(f"bad log_likelihood_method {log_likelihood_method!r}")
    x = torch.atleast_2d(as_float_on(x, device))
    y = torch.as_tensor(y, device=x.device, dtype=x.dtype)  # a list straight to x's dtype, not via float32
    if y.dim() == 2:
        if y.shape[1] != 1:
            raise ValueError(f"only 1-D output supported for GP regression, got {tuple(y.shape)}")
        y = y[:, 0]
    if x.shape[0] != y.shape[0]:
        raise ValueError("input and output data are not of the same length")
    norm: Optional[NormalizedData] = None
    if normalize:
        norm = normalize_data(x, y[:, None])
        x, y = norm.x, norm.y[:, 0]
    model = GPModel(x=x, y=y, kernel_builder=kernel_builder, nugget_builder=nugget_builder,
                    mean_builder=mean_builder, logml_method=log_likelihood_method)
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=model.log_marginal_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=x.device,
        dtype=x.dtype,
        gaussian_process=model,
        data_preprocessors=norm,
    )


def predict_from_gaussian_process(
    result,
    problem: InferenceProblem,
    points,
    *,
    query_nugget: bool = True,
    max_samples: Optional[int] = 512,
    sample_chunk: Optional[int] = None,
) -> PointwiseMixture:
    """Posterior predictive at query points: for each posterior sample a
    Gaussian N(m*, s*), mixed with the crude posterior weights.  ``points``
    is [m, d], or an integer (a Python or numpy integer, not a bool) for a
    grid with that many points per dimension over the training inputs'
    bounds.
    Samples are mapped with ``torch.func.vmap`` in chunks of
    ``sample_chunk`` (default: keep the covariance stack under ~4 GB)."""
    model: GPModel = (problem.metadata or {}).get("gaussian_process")
    if model is None:
        raise ValueError("problem has no attached GPModel metadata")
    if isinstance(points, numbers.Integral) and not isinstance(points, bool):
        points = coordinate_bounds_grid(model.x, int(points))
    points = torch.atleast_2d(torch.as_tensor(points, dtype=model.x.dtype, device=model.x.device))

    if isinstance(result, NestedSamplingResult):
        log_w, thetas = result.crude_log_posterior_weights, result.points
    else:
        # samples from elsewhere (numpy, lists, CPU tensors) go where the model is
        on_model = dict(dtype=model.x.dtype, device=model.x.device)
        thetas, lw = getattr(result, "points", result), getattr(result, "log_weights", None)
        thetas = torch.as_tensor(thetas, **on_model)
        log_w = torch.as_tensor(lw, **on_model) if lw is not None else torch.zeros(thetas.shape[0], **on_model)
    if max_samples is not None and thetas.shape[0] > max_samples:
        warnings.warn(
            f"predict_from_gaussian_process: truncating to the {max_samples} "
            f"highest-weight posterior samples of {thetas.shape[0]} "
            "(pass max_samples=None to keep all)",
            stacklevel=2,
        )
        order = torch.argsort(-log_w, stable=True)[:max_samples]
        thetas, log_w = thetas[order], log_w[order]

    one = torch.func.vmap(lambda th: model.posterior_moments(th, points, query_nugget))
    n_samp = thetas.shape[0]
    if sample_chunk is None:
        sample_chunk = max(1, min(n_samp, int(4e9) // max(model.predict_bytes_per_sample(), 1)))
    parts = [one(thetas[i:i + sample_chunk]) for i in range(0, n_samp, sample_chunk)]
    means = torch.cat([p[0] for p in parts])
    stds = torch.cat([p[1] for p in parts])
    return PointwiseMixture(log_weights=log_w, component=Normal(loc=means, scale=torch.clamp(stds, min=1e-12)))
