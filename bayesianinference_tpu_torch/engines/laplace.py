"""Laplace approximation with MacKay evidence-framework hyperparameter
optimization (port of ``bayesianinference_tpu.engines.laplace``).

* The mode comes from multi-start bounded L-BFGS: each start runs its own
  ``torch.optim.LBFGS`` (own memory, own strong-Wolfe line search) in a
  host loop, on a smooth bijection of the box to unconstrained
  coordinates; the best finite end point wins.
* The precision matrix is the exact Hessian at the mode, taken reverse
  over reverse (``torch.autograd.functional.hessian``): forward-mode AD
  does not reach the port's custom ops, whose reverse rules are
  themselves differentiable.
* The MacKay fixed point and the Nelder-Mead hyperparameter search drive
  the inner fit from the host, as in the JAX package.

The JAX package caches its jitted programs (``_mode_solver``,
``_sum_densities``, ``_evidence_program*``) to avoid retracing; PyTorch
runs eagerly and has nothing to retrace, so those caches are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import as_float_on
from ..core.numerics import as_float
from ..dists.base import Distribution
from ..dists.empirical import ParameterMixture
from ..dists.multivariate import MultivariateNormal
from ..dists.scalar import Cauchy
from ..models.problem import InferenceProblem, random_domain_points
from ..ops.metropolis import small_cholesky

__all__ = [
    "LaplaceFit",
    "laplace_log_evidence",
    "find_mode",
    "approximate_evidence",
    "mackay_update_1",
    "mackay_update_2",
    "approximate_evidence_hyper",
    "laplace_posterior_fit",
    "fit_precision_at_max",
]


def laplace_log_evidence(max_log_density, precision_matrix) -> torch.Tensor:
    """logZ = max + (k log(2 pi) - log det A)/2.  NaN when the precision
    matrix is not positive definite (its factor is NaN)."""
    p = torch.atleast_2d(as_float(precision_matrix))
    k = p.shape[-1]
    diag = torch.diagonal(small_cholesky(p), dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(diag), dim=-1)
    out = torch.as_tensor(max_log_density, dtype=p.dtype, device=p.device) + 0.5 * (k * math.log(2.0 * math.pi) - logdet)
    return torch.where(torch.isfinite(logdet), out, torch.full_like(out, math.nan))


def _default_tol(dtype: torch.dtype) -> float:
    """Gradient stopping tolerance of the mode search: 1e-10 in
    float64, 1e-4 in float32 (the gradient's own noise floor is near
    1e-5 relative there)."""
    return 1e-10 if dtype == torch.float64 else 1e-4


def _bounds_and_tol(x0: torch.Tensor, lower, upper, tol):
    """The box bounds as [d] tensors in the start points' dtype and device
    (infinite where absent) and the per-dtype default tolerance."""
    d = x0.shape[-1]

    def bound(b, inf):
        b = inf if b is None else b
        return torch.broadcast_to(torch.as_tensor(b, dtype=x0.dtype, device=x0.device), (d,))

    return bound(lower, -math.inf), bound(upper, math.inf), (_default_tol(x0.dtype) if tol is None else tol)


class _Box:
    """Smooth bijection between the box [lo, hi] and R^d: sigmoid for a
    two-sided bound, softplus for a one-sided one, identity for none, and
    a constant for a pinned parameter (lo == hi).  A clip inside the
    objective would zero the gradient beyond the box and stall L-BFGS at
    the boundary; the bijection lets it slide along it."""

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor):
        f_lo, f_hi = torch.isfinite(lo), torch.isfinite(hi)
        self.f_lo, self.f_hi = f_lo, f_hi
        self.both = f_lo & f_hi
        # sanitized operands so that no branch makes NaN
        self.lo = torch.where(f_lo, lo, torch.zeros_like(lo))
        self.hi = torch.where(f_hi, hi, torch.ones_like(hi))
        self.pinned = self.both & (self.hi - self.lo <= 0)
        self.width = torch.where(self.both & ~self.pinned, self.hi - self.lo, torch.ones_like(lo))

    def to_x(self, z: torch.Tensor) -> torch.Tensor:
        softplus = torch.logaddexp(z, torch.zeros_like(z))
        x_both = self.lo + self.width * torch.sigmoid(z)
        out = torch.where(self.both, x_both,
                          torch.where(self.f_lo, self.lo + softplus, torch.where(self.f_hi, self.hi - softplus, z)))
        return torch.where(self.pinned, self.lo, out)

    def to_z(self, x: torch.Tensor) -> torch.Tensor:
        def softplus_inv(y):
            y = torch.clamp(y, min=1e-12)
            return y + torch.log1p(-torch.exp(-y))

        frac = torch.clamp((x - self.lo) / self.width, 1e-9, 1.0 - 1e-9)
        z_both = torch.log(frac) - torch.log1p(-frac)
        z_lo = softplus_inv(torch.clamp(x - self.lo, min=1e-9))
        z_hi = softplus_inv(torch.clamp(self.hi - x, min=1e-9))
        return torch.where(self.both, z_both, torch.where(self.f_lo, z_lo, torch.where(self.f_hi, z_hi, x)))


def _lbfgs(fn: Callable, z: torch.Tensor, tol: float, maxiter: int) -> torch.Tensor:
    """Minimize ``fn`` from ``z`` by ``torch.optim.LBFGS`` (memory 10,
    strong-Wolfe line search); stops when the gradient's largest component
    is at most ``tol`` or after ``maxiter`` iterations."""
    z = z.detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([z], lr=1.0, max_iter=maxiter, tolerance_grad=tol, tolerance_change=0.0,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        value = fn(z)
        value.backward()
        return value

    opt.step(closure)
    return z.detach()


def find_mode(
    log_density: Callable,
    x0,
    *,
    maxiter: int = 500,
    tol: Optional[float] = None,
    lower=None,
    upper=None,
    device=None,
):
    """Bounded L-BFGS maximization of a log density from each row of
    ``x0``; the best finite end point wins.  Returns (mode [d], max value).
    Tensor starts keep their device; starts that are not tensors go to
    ``device`` (``None``: the CUDA card), and the bounds follow the starts.

    Each start runs its own L-BFGS: summing the starts into one objective
    would couple their line searches."""
    x0 = torch.atleast_2d(as_float_on(x0, device))
    lo, hi, tol = _bounds_and_tol(x0, lower, upper, tol)
    box = _Box(lo, hi)

    def neg(z):
        return -log_density(box.to_x(z))

    xs, vals = [], []
    for x_init in x0:
        x = box.to_x(_lbfgs(neg, box.to_z(x_init), tol, maxiter))
        with torch.no_grad():
            xs.append(x)
            vals.append(torch.as_tensor(log_density(x), dtype=x.dtype, device=x.device))
    vals = torch.stack(vals)
    vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, -math.inf))
    best = int(torch.argmax(vals))
    # to_x keeps every iterate strictly inside the box
    return xs[best], vals[best]


@dataclasses.dataclass(frozen=True)
class LaplaceFit:
    """Result of a Laplace fit."""

    log_evidence: torch.Tensor
    maximum: torch.Tensor  # log posterior density at the mode
    mean: torch.Tensor  # [d] the mode
    precision_matrix: torch.Tensor  # [d, d]
    log_likelihood_at_mode: Optional[torch.Tensor] = None
    param_names: Tuple[str, ...] = ()
    # hyperparameter block (MacKay path)
    conditional_log_evidence: Optional[torch.Tensor] = None
    hyper_mean: Optional[torch.Tensor] = None
    hyper_precision: Optional[torch.Tensor] = None
    hyper_path: Optional[tuple] = None
    predictive_builder: Optional[Callable] = dataclasses.field(default=None, repr=False)

    @property
    def posterior_distribution(self) -> MultivariateNormal:
        """N(mode, inverse precision)."""
        cov = torch.linalg.inv(self.precision_matrix)
        return MultivariateNormal(mean_=self.mean, cov=0.5 * (cov + cov.mT))

    @property
    def hyper_distribution(self) -> Optional[MultivariateNormal]:
        """Gaussian posterior over the hyperparameters."""
        if self.hyper_precision is None:
            return None
        cov = torch.linalg.inv(torch.atleast_2d(self.hyper_precision))
        return MultivariateNormal(mean_=torch.atleast_1d(self.hyper_mean), cov=0.5 * (cov + cov.mT))

    def predictive_distribution(self, num_quadrature: int = 256) -> ParameterMixture:
        """The predictive mixed over the Gaussian posterior; needs a
        ``predictive_builder`` (theta -> distribution)."""
        if self.predictive_builder is None:
            raise ValueError("no predictive builder attached to this fit")
        return ParameterMixture(param_dist=self.posterior_distribution, build=self.predictive_builder,
                                num_quadrature=num_quadrature)


def _precision(dens: Callable, x: torch.Tensor) -> torch.Tensor:
    p = -torch.autograd.functional.hessian(dens, x)
    return 0.5 * (p + p.mT)


def _fit_at_mode(dens: Callable, loglike: Optional[Callable], starts, lower, upper, tol, maxiter):
    """Mode search, exact Hessian, evidence and the likelihood at the mode:
    (mode, max, precision, logZ, loglike at mode or NaN).

    torch's strong-Wolfe search stops where the value no longer resolves a
    decrease, which at n = 512 leaves a GP mode up to 1e-6 relative short;
    optax's approximate-Wolfe search in the JAX package goes on to the
    gradient's floor.  One Newton step with the exact Hessian closes that
    gap: it is taken where the Hessian is negative definite, the step is
    within 1e-4 of the mode's scale and it ends strictly inside the box
    (a mode on the boundary keeps the L-BFGS end point)."""
    mode, max_val = find_mode(dens, starts, maxiter=maxiter, tol=tol, lower=lower, upper=upper)
    precision = _precision(dens, mode)
    with torch.enable_grad():
        x = mode.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(dens(x), x)
    factor, info = torch.linalg.cholesky_ex(precision)
    step = torch.cholesky_solve(grad[:, None], factor)[:, 0]
    lo, hi, _ = _bounds_and_tol(mode, lower, upper, None)
    new = mode + step
    if (int(info) == 0 and bool((step.abs() <= 1e-4 * mode.abs().clamp(min=1.0)).all())
            and bool(((new > lo) & (new < hi)).all())):
        mode, precision = new.detach(), _precision(dens, new.detach())
        with torch.no_grad():
            max_val = torch.as_tensor(dens(mode), dtype=mode.dtype, device=mode.device)
    log_ev = laplace_log_evidence(max_val, precision)
    with torch.no_grad():
        ll = loglike(mode) if loglike is not None else torch.tensor(math.nan, dtype=mode.dtype, device=mode.device)
    return mode, max_val, precision, log_ev, ll


def approximate_evidence(
    log_density: Union[Callable, Tuple[Callable, Callable]],
    x0,
    *,
    initial_guess=None,
    maxiter: int = 500,
    tol: Optional[float] = None,
    lower=None,
    upper=None,
    param_names: Tuple[str, ...] = (),
    data=None,
    device=None,
) -> LaplaceFit:
    """Laplace evidence for a fixed model.  ``log_density`` is the joint
    log posterior density or a (log_likelihood, log_prior) pair; with
    ``data`` the likelihood is ``f(theta, data)``.  Starts that are not
    tensors go to ``device`` (``None``: the CUDA card)."""
    starts = torch.atleast_2d(as_float_on(initial_guess if initial_guess is not None else x0, device))
    if data is not None:
        if not isinstance(log_density, tuple):
            raise ValueError("data= needs the (log_likelihood, log_prior) pair form")
        ll_data, logprior_fn = log_density

        def loglike_fn(x):
            return ll_data(x, data)
    elif isinstance(log_density, tuple):
        loglike_fn, logprior_fn = log_density
    else:
        loglike_fn = None
    if loglike_fn is None:
        dens = log_density
    else:
        def dens(x):
            return loglike_fn(x) + logprior_fn(x)

    mode, max_val, precision, log_ev, ll = _fit_at_mode(dens, loglike_fn, starts, lower, upper, tol, maxiter)
    return LaplaceFit(
        log_evidence=log_ev,
        maximum=max_val,
        mean=mode,
        precision_matrix=precision,
        log_likelihood_at_mode=ll if loglike_fn is not None else None,
        param_names=tuple(param_names),
    )


def fit_precision_at_max(points, log_densities) -> torch.Tensor:
    """Precision matrix from a least-squares quadratic fit
    logdens ~ max - dx^T P dx / 2 to (point, log-density) pairs around
    the maximum: the manual fallback when the Hessian at the mode is not
    positive definite.  Returns P [d, d]."""
    points = torch.atleast_2d(as_float(points))
    log_densities = torch.as_tensor(log_densities, dtype=points.dtype, device=points.device).reshape(-1)
    n, d = points.shape
    n_coeff = d * (d + 1) // 2
    if n <= n_coeff + 1:
        raise ValueError(
            f"{n} points is insufficient for computing the precision matrix; requires at least {n_coeff + 2}"
        )
    imax = int(torch.argmax(log_densities))
    dx = points - points[imax]
    de = log_densities - log_densities[imax]

    sv = np.linalg.svd(np.cov(dx.detach().cpu().numpy().T).reshape(d, d), compute_uv=False)
    if sv.max() < 1e-10 or sv.min() / max(sv.max(), 1e-300) < 1e-4:
        warnings.warn("test points are highly correlated or localized; expect a poor precision-matrix fit",
                      stacklevel=2)
    if float(torch.max(torch.abs(de))) < 1e-5:
        warnings.warn("log-density range in the path is tiny; expect a poor precision-matrix fit", stacklevel=2)

    index_pairs = [(i, j) for i in range(d) for j in range(i, d)]
    m = torch.stack([(1.0 if i == j else 2.0) * dx[:, i] * dx[:, j] for i, j in index_pairs], dim=-1)
    coeffs = torch.linalg.lstsq(m, de[:, None]).solution[:, 0]
    p = torch.zeros((d, d), dtype=points.dtype, device=points.device)
    for (i, j), c in zip(index_pairs, -2.0 * coeffs):
        p[i, j] = c
        p[j, i] = c
    return p


def mackay_update_1(prior_deriv: Callable = lambda la: 0.0) -> Callable:
    """One-hyperparameter (log alpha) MacKay update:
    alpha_new = k / (|w|^2 + tr(A^-1) - 2 d/dlogalpha logprior)."""

    def update(log_params, fit: LaplaceFit):
        la = log_params[0]
        tr_ainv = torch.trace(torch.linalg.inv(fit.precision_matrix))
        ew2 = torch.sum(fit.mean**2)
        k = fit.mean.shape[0]
        return torch.log(torch.stack([k / (ew2 + tr_ainv - 2.0 * prior_deriv(la))]))

    return update


def mackay_update_2(
    n_data: int,
    derivs: Tuple[Callable, Callable] = (lambda la: 0.0, lambda lb: 0.0),
) -> Callable:
    """(log alpha, log beta) MacKay update for weight decay and noise
    precision."""

    def update(log_params, fit: LaplaceFit):
        la, lb = log_params[0], log_params[1]
        alpha, beta = torch.exp(la), torch.exp(lb)
        k = fit.mean.shape[0]
        tr_ainv = torch.trace(torch.linalg.inv(fit.precision_matrix))
        ew2 = torch.sum(fit.mean**2)
        # sum of squared errors from the stored log-likelihood
        ed2 = -(2.0 / beta) * (fit.log_likelihood_at_mode + 0.5 * n_data * torch.log(2.0 * math.pi / beta))
        new_alpha = k / (ew2 + tr_ainv - 2.0 * derivs[0](la))
        new_beta = (n_data - k + alpha * tr_ainv) / (ed2 - 2.0 * derivs[1](lb))
        return torch.log(torch.stack([new_alpha, new_beta]))

    return update


def approximate_evidence_hyper(
    density_builder: Callable,  # eta [h] -> (loglike_fn, logprior_fn) or fn
    x0,
    hyper_prior: Optional[Distribution] = None,
    *,
    n_hyper: Optional[int] = None,
    method: str = "nelder-mead",  # or "fixed_point"
    initial_hyper=None,
    update_function: Optional[Callable] = None,
    max_hyper_iterations: int = 1000,
    tolerance: float = 1e-6,
    search_radius: float = 0.25,
    maxiter: int = 500,
    lower=None,
    upper=None,
    param_names: Tuple[str, ...] = (),
    finite_diff_eps: float = 1e-3,
    device=None,
) -> LaplaceFit:
    """Hyperparameter-level evidence maximization.

    ``density_builder(eta)`` returns the inner model density for
    hyperparameters ``eta`` (a tensor on the start points' device; starts
    that are not tensors go to ``device``, the CUDA card when ``None``).  The
    outer objective logZ(eta) + logprior(eta) is maximized by Nelder-Mead
    or by the MacKay fixed point (``method="fixed_point"`` with an
    ``update_function`` from :func:`mackay_update_1` /
    :func:`mackay_update_2`).  Inner fits are warm-started from the mode
    of the nearest evaluated eta within ``search_radius``."""
    if initial_hyper is None:
        if n_hyper is None:
            raise ValueError("give initial_hyper or n_hyper")
        initial_hyper = np.full((n_hyper,), 0.1)
    eta0 = np.atleast_1d(np.asarray(initial_hyper, float))
    h = eta0.shape[0]
    starts0 = torch.atleast_2d(as_float_on(x0, device))
    as_eta = lambda e: torch.as_tensor(np.asarray(e, float), dtype=starts0.dtype, device=starts0.device)  # noqa: E731
    if hyper_prior is None:
        # Cauchy(0, 2) on each hyperparameter
        cauchy = Cauchy(loc=0.0, scale=2.0)
        hyper_log_prior = lambda e: float(torch.sum(cauchy.log_prob(as_eta(e))))  # noqa: E731
    else:
        hyper_log_prior = lambda e: float(hyper_prior.log_prob(as_eta(e)))  # noqa: E731

    stored: dict = {}
    last = {"fit": None}  # the fit at the most recently evaluated eta

    def inner(eta, starts) -> LaplaceFit:
        built = density_builder(eta)
        if isinstance(built, tuple):
            loglike_fn, logprior_fn = built

            def dens(x):
                return loglike_fn(x) + logprior_fn(x)
        else:
            loglike_fn, dens = None, built
        mode, max_val, precision, log_ev, ll = _fit_at_mode(dens, loglike_fn, starts, lower, upper, None, maxiter)
        return LaplaceFit(log_evidence=log_ev, maximum=max_val, mean=mode, precision_matrix=precision,
                          log_likelihood_at_mode=ll, param_names=tuple(param_names))

    def num_fun(eta_np) -> float:
        eta_np = np.atleast_1d(np.asarray(eta_np, float))
        key_ = tuple(np.round(eta_np, 12))
        if key_ in stored:
            last["fit"] = stored[key_][2]
            return stored[key_][0]
        starts = starts0
        if stored:
            etas = np.asarray([list(k) for k in stored])
            dists = np.linalg.norm(etas - eta_np, axis=1)
            i = int(np.argmin(dists))
            if dists[i] <= search_radius:
                # warm start: prepend the nearest stored mode
                starts = torch.cat([stored[tuple(etas[i])][1][None, :], starts0])
        else:
            starts = torch.cat([starts0[:1], starts0])
        fit = inner(as_eta(eta_np), starts)
        hyper_post = float(fit.log_evidence) + hyper_log_prior(eta_np)
        if np.isnan(hyper_post):
            hyper_post = -np.inf
        last["fit"] = fit
        stored[key_] = (hyper_post, fit.mean, fit)
        return hyper_post

    if method == "fixed_point":
        if update_function is None:
            update_function = mackay_update_1()
        num_fun(eta0)
        eta = eta0
        for _ in range(max_hyper_iterations):
            # the update needs the fit AT THE CURRENT eta
            new_eta = np.asarray(update_function(as_eta(eta), last["fit"]).detach().cpu(), float)
            if not np.all(np.isfinite(new_eta)):
                raise RuntimeError(f"MacKay update returned non-numeric hypers at {eta}")
            num_fun(new_eta)
            if np.max(np.abs(new_eta - eta)) < tolerance:
                eta = new_eta
                break
            eta = new_eta
        eta_max = eta
    else:
        eta_max = _nelder_mead(num_fun, eta0, max_hyper_iterations, tolerance)

    hyper_post_max = num_fun(eta_max)
    best_fit = stored[tuple(np.round(np.atleast_1d(np.asarray(eta_max, float)), 12))][2]
    # finite-difference Hessian over the hyper axis (the outer objective is
    # host-driven)
    hess = np.zeros((h, h))
    e = finite_diff_eps
    for i in range(h):
        for j in range(i, h):
            ei, ej = np.zeros(h), np.zeros(h)
            ei[i], ej[j] = e, e
            fpp = num_fun(eta_max + ei + ej)
            fpm = num_fun(eta_max + ei - ej)
            fmp = num_fun(eta_max - ei + ej)
            fmm = num_fun(eta_max - ei - ej)
            hess[i, j] = hess[j, i] = (fpp - fpm - fmp + fmm) / (4 * e * e)
    hyper_precision = -hess
    try:
        pos_def = bool(np.all(np.linalg.eigvalsh(hyper_precision) > 0))
    except np.linalg.LinAlgError:
        pos_def = False

    log_ev = (laplace_log_evidence(hyper_post_max, as_eta(hyper_precision)) if pos_def
              else torch.tensor(math.nan, dtype=starts0.dtype, device=starts0.device))
    return dataclasses.replace(
        best_fit,
        log_evidence=log_ev,
        conditional_log_evidence=best_fit.log_evidence,
        hyper_mean=as_eta(eta_max),
        hyper_precision=as_eta(hyper_precision) if pos_def else None,
        hyper_path=tuple((np.asarray(k), v[0]) for k, v in stored.items()),
    )


def _nelder_mead(f, x0, maxiter, tol):
    """Minimal Nelder-Mead ascent (maximizes ``f``) on the host."""
    n = x0.shape[0]
    pts = [np.asarray(x0, float)]
    for i in range(n):
        p = np.array(x0, float)
        p[i] += 0.25 if p[i] == 0 else 0.25 * abs(p[i]) + 0.05
        pts.append(p)
    simplex = np.asarray(pts)
    vals = np.asarray([f(p) for p in simplex])
    for _ in range(maxiter):
        order = np.argsort(-vals)  # descending: best first
        simplex, vals = simplex[order], vals[order]
        if np.max(np.abs(vals[0] - vals[-1])) < tol and np.max(np.abs(simplex[0] - simplex[-1])) < tol:
            break
        centroid = simplex[:-1].mean(axis=0)
        worst = simplex[-1]
        xr = centroid + (centroid - worst)
        fr = f(xr)
        if fr > vals[0]:
            xe = centroid + 2.0 * (centroid - worst)
            fe = f(xe)
            simplex[-1], vals[-1] = (xe, fe) if fe > fr else (xr, fr)
        elif fr > vals[-2]:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (worst - centroid)
            fc = f(xc)
            if fc > vals[-1]:
                simplex[-1], vals[-1] = xc, fc
            else:  # shrink
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i])
    return simplex[np.argmax(vals)]


def laplace_posterior_fit(
    *,
    log_likelihood: Optional[Callable] = None,
    log_prior: Optional[Callable] = None,
    problem: Optional[InferenceProblem] = None,
    model=None,
    data: Optional[dict] = None,
    parameters=None,
    model_inputs: Optional[dict] = None,
    hyper_density_builder: Optional[Callable] = None,
    hyper_prior: Optional[Distribution] = None,
    n_hyper: Optional[int] = None,
    initial_guess=None,
    num_starts: int = 8,
    generator: Optional[torch.Generator] = None,
    predictive_builder: Optional[Callable] = None,
    param_names: Tuple[str, ...] = (),
    lower=None,
    upper=None,
    device=None,
    **hyper_kwargs,
) -> LaplaceFit:
    """High-level Laplace fit of one of:

    * ``problem``, an :class:`InferenceProblem` (its per-point likelihood,
      data-aware, and prior; its box);
    * ``log_likelihood`` + ``log_prior`` per-point callables with box
      bounds;
    * ``model`` (a :class:`~..dists.combinators.ConditionalProduct`
      generative model) + ``data`` (observed variables) + ``parameters``
      (free-variable specs) [+ ``model_inputs``]: the problem of
      :func:`~..models.generative.generative_model_problem`, with its
      graph validation (LaplaceApproximation.wl:485-518).

    Without ``initial_guess`` the ``num_starts`` starts are drawn from the
    truncated Cauchy domain distribution by ``generator`` (default: seed 0
    on the bounds' device).  Bounds, starts and model data that are not
    tensors (lists, numpy arrays) go to ``device``: the CUDA card when that
    is ``None``, never the CPU unasked.  With ``hyper_density_builder``
    (eta -> (loglike, logprior)) the MacKay / search hyperparameter
    machinery is engaged."""
    if model is not None:
        if problem is not None:
            raise ValueError("pass either model=... or problem=..., not both")
        from ..models.generative import generative_model_problem

        problem = generative_model_problem(model, data or {}, parameters or (), inputs=model_inputs, device=device)
    problem_data = None
    if problem is not None:
        if problem.data is not None:
            problem_data = problem.data
        log_likelihood = problem.log_likelihood
        log_prior = problem.log_prior
        lower = problem.lower if lower is None else lower
        upper = problem.upper if upper is None else upper
        param_names = param_names or problem.param_names
    if (log_likelihood is None or log_prior is None) and hyper_density_builder is None:
        raise ValueError("need log_likelihood+log_prior or a problem")

    if initial_guess is None:
        if lower is None:
            raise ValueError("need bounds or an initial guess")
        lo = as_float_on(lower, device)
        hi = torch.as_tensor(upper, dtype=lo.dtype, device=lo.device)
        if generator is None:
            generator = torch.Generator(device=lo.device).manual_seed(0)
        starts = random_domain_points(generator, lo, hi, num_starts, scale=5.0)
    elif isinstance(lower, torch.Tensor):  # a problem's box: its device and dtype
        starts = torch.atleast_2d(torch.as_tensor(initial_guess, dtype=lower.dtype, device=lower.device))
    else:
        starts = torch.atleast_2d(as_float_on(initial_guess, device))

    if hyper_density_builder is not None:
        fit = approximate_evidence_hyper(hyper_density_builder, starts, hyper_prior, n_hyper=n_hyper, lower=lower,
                                         upper=upper, param_names=param_names, **hyper_kwargs)
    else:
        fit = approximate_evidence((log_likelihood, log_prior), starts, lower=lower, upper=upper,
                                   param_names=param_names, data=problem_data)
    if predictive_builder is not None:
        fit = dataclasses.replace(fit, predictive_builder=predictive_builder)
    return fit
