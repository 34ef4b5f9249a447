"""Conjugate models with exact log evidence (port of
``bayesianinference_tpu.engines.conjugate``): Bayesian linear regression
(normal-inverse-gamma, or matrix-normal inverse-Wishart for a vector
output), the Normal and Multinormal mean-covariance models and the
Dirichlet-categorical model.

Dense linear algebra and no iteration: a design matrix, Gram products, one
factorization of the k x k posterior precision (the ``cholesky`` op, so
the hand-written kernel on the card) and solves against that factor
(``torch.cholesky_solve``).  Float32 products stay out of TF32 (the
package turns it off at import), as the JAX package pins
``Precision.HIGHEST`` for them.

Not ported: ``_blr_program``'s compiled-program cache and the hashable
basis wrappers it keys on, which exist for XLA's compile cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import as_float_on, resolve_device
from ..core.numerics import LOG2PI, log_zero
from ..dists.base import as_param
from ..dists.combinators import ConditionalProduct
from ..dists.conjugate_structs import NormalInverseGamma, NormalInverseWishart
from ..dists.multivariate import Dirichlet, InverseWishart, MatrixNormal, MatrixT, MultivariateNormal, MultivariateT
from ..dists.scalar import Categorical, InverseGamma, Normal, StudentT
from ..ops import gp_kernels

__all__ = [
    "design_matrix",
    "polynomial_basis",
    "BLRParameters",
    "BLRResult",
    "bayesian_linear_regression",
    "ConjugateModelResult",
    "normal_conjugate_model",
    "multinormal_conjugate_model",
    "categorical_conjugate_model",
    "categorical_conjugate_model_from_counts",
    "update_conjugate_model",
]


@functools.lru_cache(maxsize=64)
def polynomial_basis(degree: int) -> Tuple[Callable, ...]:
    """Basis functions x, x^2, ..., x^degree of a 1-D input (the constant
    comes from ``include_constant``); one tuple per degree."""
    return tuple((lambda x, p=p: x[..., 0] ** p) for p in range(1, degree + 1))


@functools.lru_cache(maxsize=64)
def _identity_basis(d_in: int) -> Tuple[Callable, ...]:
    return tuple((lambda xv, j=j: xv[..., j]) for j in range(d_in))


def design_matrix(x, basis: Sequence[Callable], include_constant: bool = True) -> torch.Tensor:
    """The design matrix [n, k] of inputs [n, d_in] (or [n]): a column of
    ones, then one column per basis callable, each mapping one input [d_in]
    to a scalar and batched with ``torch.func.vmap``."""
    x = as_float_on(x)
    if x.dim() == 1:
        x = x[:, None]
    n = x.shape[0]
    cols = [torch.ones((n,), dtype=x.dtype, device=x.device)] if include_constant else []
    cols += [torch.func.vmap(f)(x).to(x.dtype).reshape(n) for f in basis]
    return torch.stack(cols, dim=-1)


@dataclasses.dataclass(frozen=True)
class BLRParameters:
    """The (B, Lambda, Lambda^-1, V, Nu) parameters of the prior or the
    posterior."""

    b: torch.Tensor  # [k] or [k, m]
    lam: torch.Tensor  # [k, k]
    lam_inv: torch.Tensor  # [k, k]
    v: torch.Tensor  # scalar or [m, m]
    nu: torch.Tensor  # scalar


def _default_prior(k: int, m: int, dtype, device) -> BLRParameters:
    """The ignorant but normalized default prior."""
    eye_k = torch.eye(k, dtype=dtype, device=device)
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    if m == 1:
        return BLRParameters(b=torch.zeros((k,), dtype=dtype, device=device), lam=eye_k / 100.0,
                             lam_inv=eye_k * 100.0, v=t(1.0 / 100.0), nu=t(1.0 / 100.0))
    return BLRParameters(b=torch.zeros((k, m), dtype=dtype, device=device), lam=eye_k / 100.0,
                         lam_inv=eye_k * 100.0, v=torch.eye(m, dtype=dtype, device=device) / 100.0,
                         nu=t(1.0 / 100.0 + m - 1.0))


def _solve_and_inverse(lam_n: torch.Tensor, rhs: torch.Tensor):
    """(Lambda_n^-1 rhs, Lambda_n^-1), both through one factor of Lambda_n
    from the ``cholesky`` op."""
    factor = gp_kernels.cholesky(lam_n)
    eye = torch.eye(lam_n.shape[0], dtype=lam_n.dtype, device=lam_n.device)
    inv = torch.cholesky_solve(eye, factor)
    return torch.cholesky_solve(rhs, factor), 0.5 * (inv + inv.T)


def _posterior(prior: BLRParameters, lam_n, xty, rtr_of, n) -> BLRParameters:
    """The conjugate update given Lambda_n = X^T X + Lambda_0, X^T Y and
    the residual scatter R^T R as a function of B_n:
    B_n = Lambda_n^-1 (X^T Y + Lambda_0 B_0),
    V_n = V_0 + R^T R + dB^T Lambda_0 dB, Nu_n = Nu_0 + n."""
    univariate = prior.b.dim() == 1
    b0 = prior.b[:, None] if univariate else prior.b
    lam_n = 0.5 * (lam_n + lam_n.T)
    bn, lam_inv_n = _solve_and_inverse(lam_n, xty + prior.lam @ b0)
    bdiff = bn - b0
    v_inc = rtr_of(bn) + bdiff.T @ prior.lam @ bdiff
    return BLRParameters(
        b=bn[:, 0] if univariate else bn,
        lam=lam_n,
        lam_inv=lam_inv_n,
        v=prior.v + (v_inc[0, 0] if univariate else v_inc),
        nu=prior.nu + n,
    )


def _update_parameters(prior: BLRParameters, dmat: torch.Tensor, y: torch.Tensor) -> BLRParameters:
    """The conjugate update from the design matrix and the data."""
    ymat = y[:, None] if y.dim() == 1 else y

    def rtr_of(bn):
        resid = ymat - dmat @ bn
        return resid.T @ resid

    return _posterior(prior, dmat.T @ dmat + prior.lam, dmat.T @ ymat, rtr_of, ymat.shape[0])


def _joint_lp_univariate(p: BLRParameters, var_hat, b_hat):
    """log p(b_hat, var_hat): variance ~ InverseGamma(Nu/2, V/2),
    coefficients | variance ~ MVN(B, variance Lambda^-1)."""
    return (InverseGamma(a=0.5 * p.nu, b=0.5 * p.v).log_prob(var_hat)
            + MultivariateNormal(mean_=p.b, cov=var_hat * p.lam_inv).log_prob(b_hat))


def _joint_lp_multivariate(p: BLRParameters, cov_hat, b_hat):
    """log p(b_hat, cov_hat): covariance ~ InverseWishart(Nu, V),
    coefficients | covariance ~ MatrixNormal(B, Lambda^-1, covariance)."""
    return (InverseWishart(df=p.nu, scale=p.v).log_prob(cov_hat)
            + MatrixNormal(loc=p.b, row_cov=p.lam_inv, col_cov=cov_hat).log_prob(b_hat))


def _log_evidence_univariate(prior, post, dmat, y):
    """The candidate-point identity at (B_n, V_n / Nu_n):
    logZ = logL(D | theta) + log prior(theta) - log posterior(theta)."""
    var_hat = post.v / post.nu
    loglike = Normal(loc=dmat @ post.b, scale=torch.sqrt(var_hat)).log_prob(y).sum()
    return loglike + _joint_lp_univariate(prior, var_hat, post.b) - _joint_lp_univariate(post, var_hat, post.b)


def _log_evidence_multivariate(prior, post, dmat, y):
    cov_hat = post.v / post.nu
    cov_hat = 0.5 * (cov_hat + cov_hat.T)
    loglike = MultivariateNormal(mean_=dmat @ post.b, cov=cov_hat).log_prob(y).sum()
    return loglike + _joint_lp_multivariate(prior, cov_hat, post.b) - _joint_lp_multivariate(post, cov_hat, post.b)


def _residual_scatter(xtx, xty, yty, bn):
    """R^T R at B_n from the sufficient statistics:
    Y^T Y - B_n^T X^T Y - (X^T Y)^T B_n + B_n^T X^T X B_n."""
    cross = bn.T @ xty
    return yty - cross - cross.T + bn.T @ (xtx @ bn)


def _blr_update_from_stats(prior: BLRParameters, xtx, xty, yty, n) -> BLRParameters:
    """The conjugate update from the sufficient statistics alone (X^T X
    [k, k], X^T Y [k, m], Y^T Y [m, m], n).  The residual scatter by the
    normal-equation identity is exact in float64 and adequate in float32
    unless Y^T Y exceeds the residual by about 1e6."""
    return _posterior(prior, xtx + prior.lam, xty, lambda bn: _residual_scatter(xtx, xty, yty, bn), n)


def _blr_log_evidence_from_stats(prior, post, xtx, xty, yty, n):
    """The candidate-point log evidence from the sufficient statistics: the
    data enter only through n and the residual scatter at B_n."""
    univariate = post.b.dim() == 1
    bn = post.b[:, None] if univariate else post.b
    rtr = _residual_scatter(xtx, xty, yty, bn)
    if univariate:
        var_hat = post.v / post.nu
        loglike = -0.5 * (n * (LOG2PI + torch.log(var_hat)) + rtr[0, 0] / var_hat)
        return loglike + _joint_lp_univariate(prior, var_hat, post.b) - _joint_lp_univariate(post, var_hat, post.b)
    m = post.b.shape[-1]
    cov_hat = post.v / post.nu
    cov_hat = 0.5 * (cov_hat + cov_hat.T)
    factor = gp_kernels.cholesky(cov_hat)
    logdet = 2.0 * torch.log(torch.diagonal(factor)).sum()
    loglike = -0.5 * (n * (m * LOG2PI + logdet) + torch.trace(torch.cholesky_solve(rtr, factor)))
    return loglike + _joint_lp_multivariate(prior, cov_hat, post.b) - _joint_lp_multivariate(post, cov_hat, post.b)


@dataclasses.dataclass(frozen=True)
class BLRResult:
    """Output of :func:`bayesian_linear_regression`."""

    log_evidence: torch.Tensor
    prior_parameters: BLRParameters
    posterior_parameters: BLRParameters
    basis: Tuple[Callable, ...]
    include_constant: bool
    output_dim: int

    def _coeff_dist(self, p: BLRParameters):
        li = 0.5 * (p.lam_inv + p.lam_inv.T)
        if self.output_dim == 1:
            return MultivariateT(df=p.nu, loc=p.b, shape_matrix=li * (p.v / p.nu))
        return MatrixT(df=p.nu - self.output_dim + 1.0, loc=p.b, row_cov=li, col_cov=p.v)

    def _error_dist(self, p: BLRParameters):
        if self.output_dim == 1:
            return InverseGamma(a=0.5 * p.nu, b=0.5 * p.v)
        return InverseWishart(df=p.nu, scale=p.v)

    def _full_posterior(self, p: BLRParameters) -> ConditionalProduct:
        """error ~ InverseGamma (InverseWishart), then coefficients | error
        ~ MVN (MatrixNormal)."""
        if self.output_dim == 1:
            return ConditionalProduct([
                ("variance", lambda _: self._error_dist(p)),
                ("coefficients", lambda v: MultivariateNormal(
                    mean_=p.b, cov=p.lam_inv * torch.as_tensor(v["variance"])[..., None, None])),
            ])
        return ConditionalProduct([
            ("covariance", lambda _: self._error_dist(p)),
            ("coefficients", lambda v: MatrixNormal(loc=p.b, row_cov=p.lam_inv, col_cov=v["covariance"])),
        ])

    def _dists(self, p: BLRParameters) -> dict:
        return {
            "RegressionCoefficientDistribution": self._coeff_dist(p),
            "ErrorDistribution": self._error_dist(p),
            "FullPosterior": self._full_posterior(p),
        }

    @property
    def posterior(self) -> dict:
        return self._dists(self.posterior_parameters)

    @property
    def prior(self) -> dict:
        return self._dists(self.prior_parameters)

    def _pred(self, p: BLRParameters, x, extra: float):
        """Student-t predictive: loc = phi(x) B, scale^2 = (V / Nu)
        (phi Lambda^-1 phi^T + extra), df = Nu; the vector-output form is
        the matching multivariate t."""
        phi = design_matrix(as_float_on(x, p.b.device).to(p.b.dtype), self.basis, self.include_constant)
        li = 0.5 * (p.lam_inv + p.lam_inv.T)
        quad = torch.einsum("nk,kl,nl->n", phi, li, phi) + extra
        if self.output_dim == 1:
            return StudentT(df=p.nu, loc=phi @ p.b, scale=torch.sqrt((p.v / p.nu) * quad))
        dof = p.nu - self.output_dim + 1.0
        return MultivariateT(df=dof, loc=phi @ p.b, shape_matrix=(p.v / dof) * quad[:, None, None])

    def predictive_distribution(self, x, *, posterior: bool = True):
        """Distribution of new observations at inputs ``x`` (the error
        variance included)."""
        return self._pred(self.posterior_parameters if posterior else self.prior_parameters, x, 1.0)

    def underlying_value_distribution(self, x, *, posterior: bool = True):
        """Distribution of the noiseless regression value at ``x``."""
        return self._pred(self.posterior_parameters if posterior else self.prior_parameters, x, 0.0)


def bayesian_linear_regression(
    x,
    y,
    basis: Optional[Sequence[Callable]] = None,
    *,
    include_constant: bool = True,
    prior: Optional[BLRParameters] = None,
    degree: Optional[int] = None,
    device=None,
) -> BLRResult:
    """Conjugate Bayesian linear regression with exact log evidence.

    ``basis`` is a sequence of callables phi_j([d_in]) -> scalar (default:
    the inputs themselves); for a 1-D polynomial pass ``degree=p``.  ``y``
    [n] or [n, m]: a vector output takes the matrix-normal inverse-Wishart
    model.  Runs on the device of ``x`` when it is a tensor, else on
    ``device`` (the card unless ``device="cpu"``); ``y`` follows ``x``."""
    x = as_float_on(x, device)
    if x.dim() == 1:
        x = x[:, None]
    y = torch.as_tensor(y, device=x.device, dtype=x.dtype)  # a list straight to x's dtype, not via float32
    if basis is None:
        basis = polynomial_basis(degree) if degree is not None else _identity_basis(x.shape[1])
    univariate = y.dim() == 1 or y.shape[-1] == 1
    if y.dim() == 2 and y.shape[-1] == 1:
        y = y[:, 0]
    dmat = design_matrix(x, basis, include_constant)
    if prior is None:
        prior = _default_prior(dmat.shape[1], 1 if univariate else y.shape[-1], dmat.dtype, dmat.device)
    post = _update_parameters(prior, dmat, y)
    log_z = (_log_evidence_univariate if univariate else _log_evidence_multivariate)(prior, post, dmat, y)
    return BLRResult(log_evidence=log_z, prior_parameters=prior, posterior_parameters=post, basis=tuple(basis),
                     include_constant=include_constant, output_dim=1 if univariate else y.shape[-1])


# ---------------------------------------------------------------------------
# Normal, Multinormal and categorical models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConjugateModelResult:
    """Prior, posterior, exact log evidence and the closed-form prior and
    posterior predictive distributions of a conjugate model update."""

    model: str  # "Normal", "Multinormal" or "Categorical"
    prior: Union[NormalInverseGamma, NormalInverseWishart, Dirichlet]
    posterior: Union[NormalInverseGamma, NormalInverseWishart, Dirichlet]
    log_evidence: torch.Tensor
    prior_predictive: Union[StudentT, MultivariateT, Categorical]
    posterior_predictive: Union[StudentT, MultivariateT, Categorical]


def _nig_predictive(p: NormalInverseGamma, ref: torch.Tensor) -> StudentT:
    """StudentT(2 nu, mu0, sqrt(beta (lam + 1) / (lam nu)))."""
    mu0, lam, beta, nu = (as_param(v, ref) for v in (p.mu0, p.lam, p.beta, p.nu))
    return StudentT(df=2.0 * nu, loc=mu0, scale=torch.sqrt(beta * (lam + 1.0) / (lam * nu)))


def _invalid_to_log_zero(log_z: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok & torch.isfinite(log_z), log_z, torch.full_like(log_z, log_zero(log_z.dtype)))


def _normal_model_from_stats(n: int, mean, var, prior: NormalInverseGamma) -> ConjugateModelResult:
    """The NIG update and exact logZ from (n, sample mean, ddof-1 sample
    variance): the data enter the candidate-point likelihood only through
    sum (x_i - mean)^2 = (n - 1) var, so logL(D | mean, var) =
    -n/2 log(2 pi var) - (n - 1)/2.  Data of variance 0 give the log-zero
    sentinel."""
    lam0, mu0, b0, nu0 = (as_param(v, mean) for v in (prior.lam, prior.mu0, prior.beta, prior.nu))
    post = NormalInverseGamma(
        mu0=(lam0 * mu0 + n * mean) / (lam0 + n),
        lam=lam0 + n,
        beta=b0 + 0.5 * (n - 1) * var + 0.5 * lam0 * n / (lam0 + n) * (mean - mu0) ** 2,
        nu=nu0 + 0.5 * n,
    )
    safe_var = torch.where(var > 0, var, torch.ones_like(var))
    loglike = -0.5 * (n * (LOG2PI + torch.log(safe_var)) + (n - 1.0))
    log_z = loglike + prior.log_prob(mean, var) - post.log_prob(mean, var)
    return ConjugateModelResult(
        model="Normal", prior=prior, posterior=post, log_evidence=_invalid_to_log_zero(log_z, var > 0),
        prior_predictive=_nig_predictive(prior, mean), posterior_predictive=_nig_predictive(post, mean),
    )


def normal_conjugate_model(data, prior: Optional[NormalInverseGamma] = None, *, device=None) -> ConjugateModelResult:
    """Closed-form NIG update for i.i.d. Normal data (default prior
    NIG(0, 1/100, 1/200, 1/200)).  Runs on the device of ``data`` when it
    is a tensor, else on ``device`` (the card unless ``device="cpu"``)."""
    data = as_float_on(data, device).reshape(-1)
    n = data.shape[0]
    if prior is None:
        prior = NormalInverseGamma(mu0=0.0, lam=1 / 100, beta=1 / 200, nu=1 / 200)
    var = data.var(correction=1) if n > 1 else torch.ones((), dtype=data.dtype, device=data.device)
    return _normal_model_from_stats(n, data.mean(), var, prior)


def _niw_predictive(p: NormalInverseWishart, ref: torch.Tensor) -> MultivariateT:
    """MultivariateT(nu - d + 1, mu0, (lam + 1) psi / (lam (nu - d + 1)))."""
    mu0, lam, psi, nu = (as_param(v, ref) for v in (p.mu0, p.lam, p.psi, p.nu))
    df = nu - p.dim + 1.0
    return MultivariateT(df=df, loc=mu0, shape_matrix=(lam + 1.0) * psi / (lam * df))


def _multinormal_model_from_stats(n: int, mean, cov, prior: NormalInverseWishart) -> ConjugateModelResult:
    """The NIW update and exact logZ from (n, sample mean, ddof-1 sample
    covariance): at S = cov the candidate-point likelihood is
    -n/2 (d log 2 pi + log|cov|) - (n - 1) d / 2.  A singular or non-PD
    sample covariance gives the log-zero sentinel."""
    d = mean.shape[-1]
    lam0, mu0, psi0, nu0 = (as_param(v, mean) for v in (prior.lam, prior.mu0, prior.psi, prior.nu))
    diff = mean - mu0
    post = NormalInverseWishart(
        mu0=(lam0 * mu0 + n * mean) / (lam0 + n),
        lam=lam0 + n,
        psi=psi0 + (n - 1) * cov + lam0 * n / (lam0 + n) * torch.outer(diff, diff),
        nu=nu0 + n,
    )
    sign, logdet = torch.linalg.slogdet(cov)
    loglike = -0.5 * (n * (d * LOG2PI + logdet) + (n - 1.0) * d)
    log_z = loglike + prior.log_prob(mean, cov) - post.log_prob(mean, cov)
    return ConjugateModelResult(
        model="Multinormal", prior=prior, posterior=post, log_evidence=_invalid_to_log_zero(log_z, sign > 0),
        prior_predictive=_niw_predictive(prior, mean), posterior_predictive=_niw_predictive(post, mean),
    )


def multinormal_conjugate_model(data, prior: Optional[NormalInverseWishart] = None, *,
                                device=None) -> ConjugateModelResult:
    """Closed-form NIW update for i.i.d. multivariate Normal data [n, d]
    (default prior NIW(0, 1/100, I/100, d - 1 + 1/100)).  Devices as for
    :func:`normal_conjugate_model`."""
    data = as_float_on(data, device)
    data = data.reshape(1, -1) if data.dim() < 2 else data
    n, d = data.shape
    eye = torch.eye(d, dtype=data.dtype, device=data.device)
    if prior is None:
        prior = NormalInverseWishart(mu0=torch.zeros((d,), dtype=data.dtype, device=data.device), lam=1 / 100,
                                     psi=eye / 100.0, nu=d - 1 + 1 / 100)
    cov = torch.cov(data.T, correction=1).reshape(d, d) if n > 1 else eye
    return _multinormal_model_from_stats(n, data.mean(dim=0), cov, prior)


def update_conjugate_model(result: ConjugateModelResult, new_data) -> ConjugateModelResult:
    """Sequential updating: the posterior becomes the prior and the log
    evidence accumulates.  New data that are not a tensor go to the
    device of ``result``."""
    dev = result.log_evidence.device
    if result.model == "Normal":
        updated = normal_conjugate_model(new_data, prior=result.posterior, device=dev)
    elif result.model == "Categorical":
        updated = categorical_conjugate_model(new_data, prior=result.posterior, device=dev)
    else:
        updated = multinormal_conjugate_model(new_data, prior=result.posterior, device=dev)
    return dataclasses.replace(updated, prior=result.prior, prior_predictive=result.prior_predictive,
                               log_evidence=updated.log_evidence + result.log_evidence)


def _categorical_model_from_counts(counts: torch.Tensor, alpha0: torch.Tensor) -> ConjugateModelResult:
    """The Dirichlet-categorical update and exact logZ from category counts:
    alpha_n = alpha_0 + c and logZ = log B(alpha_n) - log B(alpha_0), with
    log B(a) = sum lgamma(a) - lgamma(sum a)."""
    post_a = alpha0 + counts

    def log_beta(a):
        return torch.lgamma(a).sum() - torch.lgamma(a.sum())

    def predictive(a):
        return Categorical(logits=torch.log(a / a.sum()))

    return ConjugateModelResult(
        model="Categorical", prior=Dirichlet(alpha=alpha0), posterior=Dirichlet(alpha=post_a),
        log_evidence=log_beta(post_a) - log_beta(alpha0),
        prior_predictive=predictive(alpha0), posterior_predictive=predictive(post_a),
    )


def _float_dtype(*ts) -> torch.dtype:
    for t in ts:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.dtype
    return torch.get_default_dtype()


def categorical_conjugate_model(data, num_categories: Optional[int] = None, prior: Optional[Dirichlet] = None, *,
                                device=None) -> ConjugateModelResult:
    """Closed-form Dirichlet update for i.i.d. categorical data, a vector of
    integer values in {0, ..., k - 1} (default prior: the uniform
    Dirichlet(1, ..., 1)).  The counts take the data's float dtype, else
    the prior's, else PyTorch's default.  Devices as for
    :func:`normal_conjugate_model`; the range check reads the data on the
    host."""
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data), device=resolve_device(device))
    elif device is not None:
        data = data.to(torch.device(device))
    data = data.reshape(-1)
    alpha = None if prior is None else prior.alpha
    dtype = _float_dtype(data, alpha)
    host = data.detach().cpu().numpy()
    if num_categories is None:
        if prior is not None:
            num_categories = int(prior.alpha.shape[-1])
        elif host.size == 0:
            raise ValueError("cannot infer the number of categories from empty data; "
                             "pass num_categories (or a Dirichlet prior) explicitly")
        else:
            num_categories = int(host.max()) + 1
    k = num_categories
    if host.size and (np.any(host < 0) or np.any(host > k - 1) or np.any(host != np.floor(host))):
        raise ValueError(f"categorical data must be integers in [0, {k - 1}]; got values outside that range "
                         f"(min {host.min()}, max {host.max()})")
    counts = torch.bincount(data.to(torch.int64), minlength=k).to(dtype)
    alpha0 = torch.ones((k,), dtype=dtype, device=counts.device) if alpha is None else as_param(alpha, counts)
    return _categorical_model_from_counts(counts, alpha0)


def categorical_conjugate_model_from_counts(counts, prior: Optional[Dirichlet] = None, *,
                                            device=None) -> ConjugateModelResult:
    """The Dirichlet update from a count vector [k], the sufficient
    statistic.  Devices as for :func:`normal_conjugate_model`."""
    counts = as_float_on(counts, device).reshape(-1)
    alpha0 = torch.ones(counts.shape, dtype=counts.dtype, device=counts.device) if prior is None \
        else as_param(prior.alpha, counts)
    return _categorical_model_from_counts(counts, alpha0)

