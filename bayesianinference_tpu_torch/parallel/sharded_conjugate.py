"""Data-sharded conjugate models (port of
``bayesianinference_tpu.parallel.sharded_conjugate``): BLR and the Normal,
Multinormal and categorical updates with the observation axis split over a
mesh axis.

Every model here is a function of O(k^2) sufficient statistics: (X^T X,
X^T Y, Y^T Y, n) for regression, (n, sum x, scatter) for the mean and
covariance models, the k counts for the categorical.  Each shard computes
its statistics on its device, one ``psum`` per statistic reduces them, and
the small conjugate update and the exact log evidence run once, on the
mesh's first device, through the dense engine's helpers
(``engines/conjugate.py``'s ``*_from_stats``).  Row counts need not divide
the mesh: the rows are zero-padded to a multiple of the axis size and a 0/1
weight column masks the padding out of every statistic.

Data that are not tensors go to the mesh's first device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.device import as_float_on
from ..dists.base import as_param
from ..dists.conjugate_structs import NormalInverseGamma, NormalInverseWishart
from ..engines.conjugate import (
    BLRParameters,
    BLRResult,
    ConjugateModelResult,
    _blr_log_evidence_from_stats,
    _blr_update_from_stats,
    _categorical_model_from_counts,
    _default_prior,
    _identity_basis,
    _multinormal_model_from_stats,
    _normal_model_from_stats,
    design_matrix,
    polynomial_basis,
)
from .sharding import Mesh, axis_blocks, sum_to

__all__ = [
    "sharded_bayesian_linear_regression",
    "sharded_categorical_conjugate_model",
    "sharded_normal_conjugate_model",
    "sharded_multinormal_conjugate_model",
]


def _on_mesh(a, mesh: Mesh) -> torch.Tensor:
    return as_float_on(a, None if isinstance(a, torch.Tensor) else mesh.first_device)


def _require_nonempty(arr, name: str) -> None:
    """Empty data would reduce to n = 0 and divide the mean statistics into
    NaN; fail instead."""
    if arr.shape[0] == 0:
        raise ValueError(f"{name}: data must contain at least one row")


def sharded_bayesian_linear_regression(
    x,
    y,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    basis: Optional[Sequence[Callable]] = None,
    include_constant: bool = True,
    prior: Optional[BLRParameters] = None,
    degree: Optional[int] = None,
) -> BLRResult:
    """Conjugate BLR with the observation axis sharded over
    ``mesh[axis_name]``, the long-data form of
    :func:`~..engines.conjugate.bayesian_linear_regression`: each shard
    builds its design-matrix block and reduces X^T X, X^T Y and Y^T Y with
    one ``psum`` each; the k x k update (through the ``cholesky`` op) and
    the exact log evidence come from the statistics alone."""
    x = _on_mesh(x, mesh)
    if x.dim() == 1:
        x = x[:, None]
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    if basis is None:
        basis = polynomial_basis(degree) if degree is not None else _identity_basis(x.shape[1])
    _require_nonempty(y, "sharded_bayesian_linear_regression")
    univariate = y.dim() == 1 or y.shape[-1] == 1
    ymat = y.reshape(y.shape[0], -1)
    m = 1 if univariate else ymat.shape[-1]
    xs, ys, ws = axis_blocks(mesh, axis_name, x, ymat)

    def local(i):
        dm = design_matrix(xs[i], basis, include_constant)
        # mask padded rows with where, not a product: a basis function that is
        # not finite at the zero padding (log, 1/x) would give 0 * inf = NaN
        keep = ws[i][:, None] > 0
        dm = torch.where(keep, dm, torch.zeros((), dtype=dm.dtype, device=dm.device))
        ysm = torch.where(keep, ys[i], torch.zeros((), dtype=dm.dtype, device=dm.device))
        return dm.mT @ dm, dm.mT @ ysm, ysm.mT @ ysm, torch.sum(ws[i])

    xtx, xty, yty, n = sum_to([local(i) for i in range(len(xs))], x.device)
    p = prior if prior is not None else _default_prior(xtx.shape[0], m, xtx.dtype, xtx.device)
    if m == 1 and p.b.dim() != 1:
        raise ValueError("prior.b must be 1-D for univariate outputs")
    post = _blr_update_from_stats(p, xtx, xty, yty, n)
    log_z = _blr_log_evidence_from_stats(p, post, xtx, xty, yty, n)
    return BLRResult(log_evidence=log_z, prior_parameters=p, posterior_parameters=post, basis=tuple(basis),
                     include_constant=include_constant, output_dim=m)


def _sharded_mean_scatter(data: torch.Tensor, mesh: Mesh, axis_name: str):
    """(n, mean, scatter) of a row-sharded data matrix by two rounds of
    ``psum``: the sums, then the centred scatter."""
    ds, ws = axis_blocks(mesh, axis_name, data)
    n, total = sum_to([(torch.sum(w), torch.sum(d * w[:, None], dim=0)) for d, w in zip(ds, ws)], data.device)
    mean = total / n

    def scatter(d, w):
        c = (d - mean.to(d.device)) * w[:, None]
        return c.mT @ c

    sc = sum_to([scatter(d, w) for d, w in zip(ds, ws)], data.device)
    return n, mean, sc


def sharded_normal_conjugate_model(data, mesh: Mesh, *, axis_name: str = "data",
                                   prior: Optional[NormalInverseGamma] = None) -> ConjugateModelResult:
    """:func:`~..engines.conjugate.normal_conjugate_model` with the sample
    axis sharded over the mesh: ``psum``-reduced (n, mean, variance), one
    update."""
    data = _on_mesh(data, mesh).reshape(-1)
    _require_nonempty(data, "sharded_normal_conjugate_model")
    if prior is None:
        prior = NormalInverseGamma(mu0=0.0, lam=1 / 100, beta=1 / 200, nu=1 / 200)
    n, mean, scatter = _sharded_mean_scatter(data[:, None], mesh, axis_name)
    var = torch.where(n > 1, scatter[0, 0] / torch.clamp(n - 1.0, min=1.0), torch.ones_like(n))
    return _normal_model_from_stats(n, mean[0], var, prior)


def sharded_multinormal_conjugate_model(data, mesh: Mesh, *, axis_name: str = "data",
                                        prior: Optional[NormalInverseWishart] = None) -> ConjugateModelResult:
    """:func:`~..engines.conjugate.multinormal_conjugate_model` with the
    sample axis sharded over the mesh."""
    data = _on_mesh(data, mesh)
    data = data.reshape(1, -1) if data.dim() < 2 else data
    _require_nonempty(data, "sharded_multinormal_conjugate_model")
    d = data.shape[1]
    eye = torch.eye(d, dtype=data.dtype, device=data.device)
    if prior is None:
        prior = NormalInverseWishart(mu0=torch.zeros((d,), dtype=data.dtype, device=data.device), lam=1 / 100,
                                     psi=eye / 100.0, nu=d - 1 + 1 / 100)
    n, mean, scatter = _sharded_mean_scatter(data, mesh, axis_name)
    cov = torch.where(n > 1, scatter / torch.clamp(n - 1.0, min=1.0), eye.to(mean.device))
    return _multinormal_model_from_stats(n, mean, cov, prior)


def sharded_categorical_conjugate_model(data, num_categories: int, mesh: Mesh, *, axis_name: str = "data",
                                        prior=None) -> ConjugateModelResult:
    """:func:`~..engines.conjugate.categorical_conjugate_model` with the
    sample axis sharded over the mesh: each shard counts its block
    (padding rows carry weight 0) and one ``psum`` of the k counts reduces
    the sufficient statistic; the Dirichlet update and exact logZ run once.
    The range check reads the data on the host."""
    data = _on_mesh(data, mesh).reshape(-1)
    k = int(num_categories)
    host = data.detach().cpu().numpy()
    if host.size and (np.any(host < 0) or np.any(host > k - 1) or np.any(host != np.floor(host))):
        raise ValueError(f"categorical data must be integers in [0, {k - 1}]; got values outside that range "
                         f"(min {host.min()}, max {host.max()})")
    xs, ws = axis_blocks(mesh, axis_name, data)

    counts = sum_to([torch.zeros((k,), dtype=w.dtype, device=w.device).index_add_(0, x.to(torch.int64), w)
                     for x, w in zip(xs, ws)], data.device)
    alpha0 = torch.ones((k,), dtype=counts.dtype, device=counts.device) if prior is None \
        else as_param(prior.alpha, counts).to(counts.dtype)
    return _categorical_model_from_counts(counts, alpha0)
