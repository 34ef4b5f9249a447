"""GP classification and count regression via the latent-GP Laplace or EP
bridge (port of ``bayesianinference_tpu.engines.gp_classify``).

``define_gp_classifier`` builds an :class:`InferenceProblem` whose
likelihood is the Laplace (or EP) approximate log marginal of a latent GP
(:mod:`..ops.gp_laplace`, :mod:`..ops.gp_ep`), so Bernoulli (logit,
probit), binomial and Poisson models get hyperparameter posteriors from
any engine.

The Newton and EP loops are host loops over a batch and cannot run under
``torch.func.vmap``, so the problem is built with ``batched_likelihood``:
the model's likelihood takes the whole batch of hyperparameters [B, d],
assembles the B covariances in one call of the SE op (``torch.func.vmap``
of the per-point kernel builder, which the op folds into its batch) and
runs one batched Newton loop, every step one Cholesky launch at B.  A
single theta [d] (the Laplace engine's Hessian) takes the same path at
B = 1.

Prediction maps the latent moments over the posterior samples the same
way, then averages the link under each latent Gaussian by Gauss-Hermite
quadrature.  ``sample_gp_latents`` draws the exact latent posterior by
elliptical slice sampling (:mod:`..ops.ess`) with its random numbers as
tensor inputs.

The JAX package's ``jax.jit`` of the Adam loop and its ``lax.scan`` are
not ported: the loop is a host loop over eager steps, with optax's update
(:mod:`..core.optim`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..core.device import as_float_on
from ..core.optim import adam_init, adam_step
from ..core.transforms import box_bijection
from ..dists.pointwise import PointwiseMixture
from ..dists.scalar import Normal
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.ess import ESSDraws, ess_draws, ess_sample
from ..ops.gp_ep import gp_ep_latent_moments, gp_ep_log_marginal
from ..ops.gp_kernels import cholesky, covariance_matrix
from ..ops.gp_laplace import (
    LatentLikelihood,
    bernoulli_logit_likelihood,
    bernoulli_probit_likelihood,
    binomial_logit_likelihood,
    gauss_hermite_expectation,
    gp_laplace_latent_moments,
    gp_laplace_log_marginal,
    gp_laplace_mode,
    poisson_log_likelihood,
)
from .evidence import NestedSamplingResult

__all__ = [
    "GPClassifierModel",
    "GPClassPrediction",
    "GPClassifierOptimization",
    "GPLatentDraws",
    "GPLatentSamples",
    "define_gp_classifier",
    "gp_latent_draws",
    "latent_draws_at",
    "optimize_gp_classifier",
    "predict_from_gp_classifier",
    "sample_gp_latents",
]

_NAMED_LIKELIHOODS = {
    "bernoulli_logit": bernoulli_logit_likelihood,
    "bernoulli_probit": bernoulli_probit_likelihood,
    "binomial_logit": binomial_logit_likelihood,
    "poisson_log": poisson_log_likelihood,
}


def _per_theta(fn: Callable, theta: torch.Tensor):
    """``fn`` of each row of ``theta`` [B, d], stacked: ``torch.func.vmap``,
    which the custom ops fold into one batched launch."""
    return torch.func.vmap(fn)(theta)


@dataclasses.dataclass(frozen=True)
class GPClassifierModel:
    """Model functions attached to a latent-GP problem, the classification
    analogue of :class:`.gp.GPModel`.  ``kernel_builder(theta)`` takes one
    parameter vector [d]."""

    x: torch.Tensor  # [n, d]
    y: torch.Tensor  # [n] (or [n, k]) targets on the likelihood's scale
    kernel_builder: Callable
    likelihood: LatentLikelihood
    jitter: float = 1e-6
    maxiter: int = 50
    method: str = "laplace"  # "laplace" | "ep"

    def _k(self, theta):
        """K(theta) + jitter I for one theta [d]."""
        kernel = self.kernel_builder(theta)
        return covariance_matrix(kernel, self.x, self.jitter, symmetrize=not kernel.exactly_symmetric)

    def _k_batch(self, theta: torch.Tensor) -> torch.Tensor:
        """K for theta [d] ([n, n]) or [B, d] ([B, n, n])."""
        return self._k(theta) if theta.dim() == 1 else _per_theta(self._k, theta)

    def log_marginal_likelihood(self, theta) -> torch.Tensor:
        """Approximate log q(y | X, theta), Laplace (GPML eq. 3.32) or
        parallel EP (GPML eq. 3.65) by ``method``, for theta [d] or a batch
        [B, d] (one Newton or EP loop for the whole batch)."""
        theta = torch.as_tensor(theta, dtype=self.x.dtype, device=self.x.device)
        fn = gp_ep_log_marginal if self.method == "ep" else gp_laplace_log_marginal
        return fn(self._k_batch(theta), self.y, self.likelihood, maxiter=self.maxiter)

    def latent_moments(self, theta, x_query):
        """Latent predictive (mu*, var*) at query points for theta [d] ([q]
        each) or [S, d] ([S, q] each)."""
        theta = torch.as_tensor(theta, dtype=self.x.dtype, device=self.x.device)

        def pieces(th):
            kernel = self.kernel_builder(th)
            return kernel.matrix(self.x, x_query), kernel.diag(x_query) + self.jitter

        k_cross, k_qdiag = pieces(theta) if theta.dim() == 1 else _per_theta(pieces, theta)
        fn = gp_ep_latent_moments if self.method == "ep" else gp_laplace_latent_moments
        return fn(self._k_batch(theta), self.y, self.likelihood, k_cross, k_qdiag, maxiter=self.maxiter)

    def predict_bytes_per_sample(self) -> int:
        return 4 * self.x.shape[0] * self.x.shape[0]


class GPClassPrediction(NamedTuple):
    """Posterior-averaged latent-GP predictions at m query points.

    ``mean`` is the posterior expectation of the link (class probability
    for Bernoulli, rate for Poisson); ``latent`` a
    :class:`~..dists.pointwise.PointwiseMixture` over the latent f*."""

    mean: torch.Tensor  # [m]
    latent: PointwiseMixture


def define_gp_classifier(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    likelihood="bernoulli_logit",
    method: str = "laplace",
    jitter: float = 1e-6,
    maxiter: int = 50,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> InferenceProblem:
    """Hyperparameter-inference problem for a latent (non-Gaussian
    likelihood) GP, the classification and count counterpart of
    :func:`.gp.define_gaussian_process`.

    ``likelihood``: "bernoulli_logit" (y in {0,1}), "bernoulli_probit",
    "binomial_logit" (y rows [successes, trials]), "poisson_log" (counts),
    or a :class:`..ops.gp_laplace.LatentLikelihood` (log-concave in f).
    ``method``: "laplace" (one Newton solve per evaluation) or "ep" (damped
    parallel EP).  The problem lives on ``x``'s device and dtype; data that
    is not a tensor goes to ``device`` (the card when ``None``)."""
    if method not in ("laplace", "ep"):
        raise ValueError(f"method must be 'laplace' or 'ep', got {method!r}")
    if isinstance(likelihood, str):
        try:
            likelihood = _NAMED_LIKELIHOODS[likelihood]()
        except KeyError:
            raise ValueError(
                f"unknown likelihood {likelihood!r}; expected one of "
                f"{sorted(_NAMED_LIKELIHOODS)} or a LatentLikelihood"
            ) from None
    x = torch.atleast_2d(as_float_on(x, device))
    y = torch.as_tensor(y, device=x.device, dtype=x.dtype)
    if y.dim() not in (1, 2) or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"need x [n, d] and y [n] (or [n, k] for row-valued targets like binomial "
            f"[successes, trials]); got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    if likelihood.name.startswith("bernoulli") and (y.dim() != 1 or bool(((y != 0) & (y != 1)).any())):
        raise ValueError("Bernoulli likelihoods need y in {0, 1}")
    if likelihood.name == "binomial_logit" and (
        y.dim() != 2 or y.shape[1] != 2 or bool((y[:, 0] > y[:, 1]).any()) or bool((y < 0).any())
    ):
        raise ValueError("binomial_logit needs y as [n, 2] rows of [successes, trials] with 0 <= successes <= trials")

    model = GPClassifierModel(x=x, y=y, kernel_builder=kernel_builder, likelihood=likelihood, jitter=float(jitter),
                              maxiter=int(maxiter), method=method)
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=model.log_marginal_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=x.device,
        dtype=x.dtype,
        batched_likelihood=True,
        gp_classifier=model,
    )


@dataclasses.dataclass(frozen=True)
class GPClassifierOptimization:
    """Result of a type-II maximum-likelihood latent-GP fit: ``theta`` at
    the optimum, the final ``log_marginal`` there and the per-step trace."""

    theta: torch.Tensor  # [d] hyperparameters at the optimum
    log_marginal: torch.Tensor  # scalar logML at theta
    trace: torch.Tensor  # [steps] logML before each Adam step


def _model_of(problem: InferenceProblem) -> GPClassifierModel:
    model = (problem.metadata or {}).get("gp_classifier")
    if not isinstance(model, GPClassifierModel):
        raise ValueError("optimize_gp_classifier needs a problem built by define_gp_classifier")
    return model


def optimize_gp_classifier(
    problem: InferenceProblem,
    *,
    steps: int = 200,
    learning_rate: float = 0.05,
    initial_theta=None,
    include_prior: bool = False,
) -> GPClassifierOptimization:
    """Type-II maximum likelihood for a latent GP: maximize the approximate
    log marginal (GPML sec. 5.5) over the hyperparameters with Adam, in the
    problem's unconstrained bijection space (box constraints honored).
    ``include_prior=True`` maximizes logML + log prior (MAP-II)."""
    model = _model_of(problem)
    bij = box_bijection(problem.lower, problem.upper)
    if initial_theta is not None:
        u0 = bij.to_z(torch.as_tensor(initial_theta, dtype=problem.dtype, device=problem.device))
    else:
        u0 = torch.zeros((problem.dim,), dtype=problem.dtype, device=problem.device)  # box midpoint

    def value_and_grad(u):
        with torch.enable_grad():
            u = u.detach().requires_grad_(True)
            theta = bij.to_x(u)
            logml = model.log_marginal_likelihood(theta)
            total = logml + problem.log_prior(theta) if include_prior else logml
            (g,) = torch.autograd.grad(-total, u)
        return logml.detach(), g

    params, state, trace = {"u": u0}, adam_init({"u": u0}), []
    for _ in range(steps):
        logml, g = value_and_grad(params["u"])
        trace.append(logml)
        params, state = adam_step(params, {"u": g}, state, learning_rate)
    with torch.no_grad():
        theta = bij.to_x(params["u"])
        final = model.log_marginal_likelihood(theta)
    trace = torch.stack(trace) if trace else torch.zeros((0,), dtype=problem.dtype, device=problem.device)
    return GPClassifierOptimization(theta=theta, log_marginal=final, trace=trace)


def _samples_and_weights(result, like: torch.Tensor, max_samples: Optional[int]):
    """(thetas [S, d], log weights [S]) of an NS result, a weighted-sample
    carrier, draws [S, d] or one theta [d], on ``like``'s device and dtype,
    cut to the ``max_samples`` highest weights."""
    if isinstance(result, NestedSamplingResult):
        thetas, log_w = result.points, result.crude_log_posterior_weights
    else:
        on = dict(dtype=like.dtype, device=like.device)
        thetas = torch.as_tensor(getattr(result, "points", result), **on)
        if thetas.dim() == 1:
            thetas = thetas[None, :]
        lw = getattr(result, "log_weights", None)
        log_w = torch.as_tensor(lw, **on) if lw is not None else torch.zeros(thetas.shape[0], **on)
    if max_samples is not None and thetas.shape[0] > max_samples:
        order = torch.argsort(-log_w, stable=True)[:max_samples]
        thetas, log_w = thetas[order], log_w[order]
    return thetas, log_w


def predict_from_gp_classifier(
    result,
    problem: InferenceProblem,
    points,
    *,
    num_quad_points: int = 32,
    max_samples: Optional[int] = 256,
    sample_chunk: Optional[int] = None,
) -> GPClassPrediction:
    """Posterior-averaged predictions at query points.

    ``result``: a NestedSamplingResult (crude posterior weights), any
    weighted-sample carrier, draws [S, d], or one theta [d].  The latent
    moments of a chunk of samples come from one batched Newton (or EP)
    loop, the link's expectation from Gauss-Hermite quadrature (GPML eq.
    3.25)."""
    model = (problem.metadata or {}).get("gp_classifier")
    if model is None:
        raise ValueError("problem has no attached GPClassifierModel metadata")
    points = torch.atleast_2d(torch.as_tensor(points, dtype=model.x.dtype, device=model.x.device))
    thetas, log_w = _samples_and_weights(result, model.x, max_samples)
    n_samp = thetas.shape[0]
    if sample_chunk is None:
        sample_chunk = max(1, min(n_samp, int(4e9) // max(model.predict_bytes_per_sample(), 1)))
    mus, stds, probs = [], [], []
    for i in range(0, n_samp, sample_chunk):
        mu, var = model.latent_moments(thetas[i:i + sample_chunk], points)
        mus.append(mu)
        stds.append(torch.sqrt(var))
        probs.append(gauss_hermite_expectation(model.likelihood.link, mu, var, num_quad_points))
    mus, stds, probs = torch.cat(mus), torch.cat(stds), torch.cat(probs)
    w = torch.softmax(log_w, dim=0)
    latent = PointwiseMixture(log_weights=log_w, component=Normal(loc=mus, scale=torch.clamp(stds, min=1e-12)))
    return GPClassPrediction(mean=(w[:, None] * probs).sum(dim=0), latent=latent)


class GPLatentSamples(NamedTuple):
    """Exact latent-posterior draws at the training inputs.

    ``draws`` is [num_chains, num_samples, n]; ``moved``/``evals`` diagnose
    the ESS shrinkage loop (ESS always moves unless ``max_shrink`` was hit)."""

    draws: torch.Tensor  # [C, S, n]
    log_lik: torch.Tensor  # [C] final per-chain log L(f)
    evals: torch.Tensor  # [C] likelihood evaluations per chain
    moved: torch.Tensor  # [C] completed moves per chain


class GPLatentDraws(NamedTuple):
    """The random inputs of :func:`sample_gp_latents`: the chains' starting
    perturbations and every update's ESS draws (leading axis
    burn_in + num_samples * thin)."""

    init: torch.Tensor  # [C, n] standard normal
    updates: ESSDraws


def gp_latent_draws(generator: torch.Generator, num_chains: int, n: int, num_updates: int, *,
                    max_shrink: int = 64, dtype: Optional[torch.dtype] = None) -> GPLatentDraws:
    """Draws for :func:`sample_gp_latents` from ``generator``."""
    kw = dict(generator=generator, dtype=dtype or torch.get_default_dtype(), device=generator.device)
    init = torch.randn((num_chains, n), **kw)
    return GPLatentDraws(init, ess_draws(generator, num_chains, n, num_updates=num_updates, max_shrink=max_shrink,
                                         dtype=dtype))


def _classifier_model(problem_or_model) -> GPClassifierModel:
    if isinstance(problem_or_model, GPClassifierModel):
        return problem_or_model
    model = (getattr(problem_or_model, "metadata", None) or {}).get("gp_classifier")
    if model is None:
        raise ValueError("expected a GPClassifierModel or a problem built by define_gp_classifier")
    return model


def sample_gp_latents(
    generator: Optional[torch.Generator],
    problem_or_model,
    theta,
    num_samples: int,
    *,
    num_chains: int = 8,
    burn_in: int = 128,
    thin: int = 2,
    max_shrink: int = 64,
    draws: Optional[GPLatentDraws] = None,
) -> GPLatentSamples:
    """Asymptotically exact draws from p(f | y, theta) by elliptical slice
    sampling (Murray et al. 2010), where ``latent_moments`` gives the
    Laplace or EP Gaussian approximation.  The chains start at the Laplace
    mode plus 0.1 of a prior draw and run ``burn_in`` updates, then
    ``num_samples`` of ``thin`` updates each, all chains as one batch.

    The random numbers come from ``generator`` (``None``: one on the
    model's device seeded 0), or from ``draws`` (:func:`gp_latent_draws`'s
    layout) to replay another run's."""
    model = _classifier_model(problem_or_model)
    theta = torch.as_tensor(theta, dtype=model.x.dtype, device=model.x.device)
    y, lik = model.y, model.likelihood
    with torch.no_grad():
        k = model._k(theta)
        n = k.shape[-1]
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=model.x.device).manual_seed(0)
            draws = gp_latent_draws(generator, num_chains, n, burn_in + num_samples * thin, max_shrink=max_shrink,
                                    dtype=k.dtype)
        chol = cholesky(k)
        f_hat, _ = gp_laplace_mode(k, y, lik, model.maxiter)
        lpf = lik._derivs()[0]

        def log_lik_fn(f):
            return lpf(f, y).sum(dim=-1)

        # overdispersed starts: the mode plus a damped prior-scaled perturbation
        f0 = f_hat + 0.1 * (draws.init.to(k) @ chol.mT)
        samples, final = ess_sample(draws.updates, f0, log_lik_fn, chol, num_samples, burn_in=burn_in, thin=thin,
                                    max_shrink=max_shrink)
    return GPLatentSamples(draws=samples, log_lik=final.log_lik, evals=final.evals, moved=final.moved)


def latent_draws_at(problem_or_model, theta, draws, points, *, generator: Optional[torch.Generator] = None):
    """Project training-input latent draws to query points.

    For each draw f the conditional latent at the queries is
    f* | f ~ N(k*^T K^-1 f, k** - k*^T K^-1 k*).  Without ``generator``
    returns the conditional means [..., q]; with it, joint draws (means +
    Cholesky-colored standard normals drawn from ``generator``)."""
    model = _classifier_model(problem_or_model)
    theta = torch.as_tensor(theta, dtype=model.x.dtype, device=model.x.device)
    with torch.no_grad():
        kernel = model.kernel_builder(theta)
        k = model._k(theta)
        points = torch.atleast_2d(torch.as_tensor(points, dtype=k.dtype, device=k.device))
        k_cross = kernel.matrix(model.x, points)  # [n, q]
        k_qq = covariance_matrix(kernel, points, model.jitter, symmetrize=not kernel.exactly_symmetric)
        a = torch.cholesky_solve(k_cross, cholesky(k))  # K^-1 k*
        mu = torch.as_tensor(draws, dtype=k.dtype, device=k.device) @ a  # [..., q]
        if generator is None:
            return mu
        cov = k_qq - k_cross.mT @ a
        chol_q = cholesky(cov + model.jitter * torch.eye(cov.shape[0], dtype=k.dtype, device=k.device))
        noise = torch.randn(mu.shape, generator=generator, dtype=k.dtype, device=generator.device)
        return mu + noise.to(k.device) @ chol_q.mT
