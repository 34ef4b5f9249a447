"""Direct (quadrature) posterior of a low-dimensional problem (port of
``bayesianinference_tpu.engines.direct``).

Posterior density = prior x likelihood, with the evidence by a
tensor-product Gauss-Legendre rule over the parameter box: the
``num_points ** d`` node densities are one batched call of the problem's
densities.  The nodes and weights are numpy's ``leggauss``, as in the JAX
package, so both packages integrate on the same grid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.numerics import logsumexp
from ..models.problem import InferenceProblem, define_inference_problem

__all__ = ["DirectPosterior", "direct_posterior_distribution", "gauss_legendre_grid"]


def gauss_legendre_grid(lower, upper, num_points: int, *, dtype=torch.float64, device=None):
    """Tensor-product Gauss-Legendre nodes and log-weights over a box:
    (nodes [N, d], log_weights [N]) with N = num_points^d, built in numpy
    float64 and then cast to ``dtype`` on ``device``.  Without ``device``
    the grid goes where a tensor ``lower`` lies, and otherwise to the card
    (:func:`~..core.device.resolve_device`): ``device="cpu"`` asks for the
    host."""
    if device is None:
        device = lower.device if isinstance(lower, torch.Tensor) else resolve_device()
    to_np = lambda v: np.atleast_1d(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))  # noqa: E731
    lower, upper = to_np(lower).astype(float), to_np(upper).astype(float)
    x, w = np.polynomial.legendre.leggauss(num_points)
    half, mid = 0.5 * (upper - lower), 0.5 * (upper + lower)
    grids = np.meshgrid(*(mid[i] + half[i] * x for i in range(lower.shape[0])), indexing="ij")
    wgrids = np.meshgrid(*(np.log(w * half[i]) for i in range(lower.shape[0])), indexing="ij")
    nodes = np.stack([g.ravel() for g in grids], axis=-1)
    log_weights = sum(g.ravel() for g in wgrids)
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
    return t(nodes), t(log_weights)


@dataclasses.dataclass(frozen=True)
class DirectPosterior:
    """The normalized posterior on a quadrature grid: ``log_pdf(theta)``
    anywhere, moments and draws from the grid."""

    nodes: torch.Tensor  # [N, d]
    log_quad_weights: torch.Tensor  # [N]
    node_log_density: torch.Tensor  # [N] unnormalized log density at the nodes
    log_evidence: torch.Tensor
    log_density: Optional[Callable] = dataclasses.field(default=None, repr=False)

    def log_pdf(self, theta):
        return self.log_density(theta) - self.log_evidence

    def _node_log_mass(self) -> torch.Tensor:
        lw = self.log_quad_weights + self.node_log_density - self.log_evidence
        return lw - logsumexp(lw)

    def mean(self) -> torch.Tensor:
        return torch.exp(self._node_log_mass()) @ self.nodes

    def covariance(self) -> torch.Tensor:
        w = torch.exp(self._node_log_mass())
        c = self.nodes - w @ self.nodes
        return torch.einsum("n,ni,nj->ij", w, c, c)

    def variance(self) -> torch.Tensor:
        return torch.diagonal(self.covariance())

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """Grid nodes drawn by inverse CDF of the node masses."""
        cdf = torch.cumsum(torch.exp(self._node_log_mass()), dim=0)
        u = torch.rand(tuple(shape), generator=generator, dtype=cdf.dtype, device=generator.device) * cdf[-1]
        idx = torch.clamp(torch.searchsorted(cdf, u.to(cdf.device)), 0, cdf.shape[0] - 1)
        return self.nodes[idx]


def direct_posterior_distribution(
    *,
    problem: Optional[InferenceProblem] = None,
    log_likelihood: Optional[Callable] = None,
    likelihood: Optional[Callable] = None,
    data=None,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    parameters: Optional[Sequence] = None,
    num_points: int = 64,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> DirectPosterior:
    """Quadrature posterior and log evidence.

    Pass a ``problem``, or the likelihood and prior specs that
    :func:`~..models.problem.define_inference_problem` takes (with its
    ``device``, the card by default, and ``dtype``).  Every parameter needs
    finite bounds.  The cost is ``num_points ** d`` density evaluations in
    one batched call: meant for d <= 3."""
    if problem is None:
        problem = define_inference_problem(
            parameters=parameters, log_likelihood=log_likelihood, likelihood=likelihood, data=data,
            prior_distribution=prior_distribution, log_prior=log_prior, validate=False, device=device, dtype=dtype,
        )
    if not bool(torch.isfinite(problem.lower).all() & torch.isfinite(problem.upper).all()):
        raise ValueError("direct quadrature needs finite parameter bounds")
    nodes, log_w = gauss_legendre_grid(problem.lower, problem.upper, num_points, dtype=problem.dtype,
                                       device=problem.device)

    def log_density(theta):
        return problem.guarded_log_likelihood(theta) + problem.guarded_log_prior(theta)

    node_ld = log_density(nodes)
    return DirectPosterior(nodes=nodes, log_quad_weights=log_w, node_log_density=node_ld,
                           log_evidence=logsumexp(log_w + node_ld), log_density=log_density)
