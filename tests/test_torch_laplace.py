"""The port's Laplace engine against the JAX package's, on the CPU, float64.

Both packages get the same explicit start points and the same
numpy-seeded data; their optimizers differ (the port runs
``torch.optim.LBFGS`` per start and one Newton step at the end, the JAX
package optax's L-BFGS vmapped over starts), so they are held to the
same best mode, not the same path.  Tolerances:

* mode: rtol 1e-6 (atol 1e-8 for components near 0);
* log-evidence and maximum: atol 1e-6;
* precision matrix (the exact Hessian at the mode): rtol 1e-5 of its
  largest entry;
* the exact Gaussian case against its closed form: rtol 1e-8 (logZ) and
  1e-6 (mode, precision), the bounds of ``tests/test_laplace.py``;
* MacKay fixed point (hyperparameters, conditional evidence): rtol 1e-6;
* Nelder-Mead hyperparameter search: atol 1e-4 on the hyperparameter and
  the hyper-level and conditional logZ (the search stops at tolerance
  1e-7 on a simplex that may take other branches on last-bit
  differences);
* ``fit_precision_at_max`` on a quadratic: rtol 1e-6.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines import laplace as jl
from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
from bayesianinference_tpu.models import define_inference_problem as j_define_problem
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops import gp_kernels as tgk

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def assert_same_fit(got, want):
    close(got.mean, want.mean, rtol=1e-6, atol=1e-8)
    close(got.maximum, want.maximum, rtol=0, atol=1e-6)
    close(got.log_evidence, want.log_evidence, rtol=0, atol=1e-6)
    p_want = np.asarray(want.precision_matrix)
    close(got.precision_matrix, p_want, rtol=0, atol=1e-5 * np.abs(p_want).max())


def test_exact_for_gaussian():
    """The Laplace approximation is exact for a Gaussian model."""
    rng = np.random.default_rng(0)
    y = rng.normal(size=20) + 1.0
    yt, yj = T(y), jnp.asarray(y)
    got = tl.approximate_evidence(
        (lambda th: torch.sum(td.Normal(th[0], 1.0).log_prob(yt)), lambda th: td.Normal(0.0, 10.0).log_prob(th[0])),
        T([[0.0]]))
    want = jl.approximate_evidence(
        (lambda th: jnp.sum(jd.Normal(th[0], 1.0).log_prob(yj)), lambda th: jd.Normal(0.0, 10.0).log_prob(th[0])),
        jnp.asarray([[0.0]]))
    assert_same_fit(got, want)
    n = len(y)
    exact = st.multivariate_normal(np.zeros(n), np.eye(n) + 100.0 * np.ones((n, n))).logpdf(y)
    close(got.log_evidence, exact, rtol=1e-8)
    post_prec = n + 1 / 100.0
    close(got.mean[0], np.sum(y) / post_prec, rtol=1e-6)
    close(got.precision_matrix[0, 0], post_prec, rtol=1e-6)
    close(got.log_likelihood_at_mode, want.log_likelihood_at_mode, rtol=1e-10)
    # posterior and predictive objects
    post = got.posterior_distribution
    assert isinstance(post, td.MultivariateNormal)
    close(post.covariance(), 1.0 / post_prec, rtol=1e-6)
    fit = tl.laplace_posterior_fit(log_likelihood=lambda th: torch.sum(td.Normal(th[0], 1.0).log_prob(yt)),
                                   log_prior=lambda th: td.Normal(0.0, 10.0).log_prob(th[0]),
                                   initial_guess=T([[0.5]]), predictive_builder=lambda th: td.Normal(th[0], 1.0))
    pred = fit.predictive_distribution(num_quadrature=2048)
    marginal = -0.5 * (1.0 / (1.0 + 1.0 / post_prec)) * (0.4 - fit.mean[0]) ** 2 - 0.5 * math.log(
        2 * math.pi * (1.0 + 1.0 / post_prec))
    close(pred.log_prob(T(0.4)), marginal, rtol=0, atol=0.01)


_GP_PARAMS = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]
_GP_STARTS = np.array([[1.0, 1.0, 0.3], [0.3, 2.5, 0.05], [2.0, 0.2, 0.5]])


def test_gp_problem_matches_jax():
    """The slice's main path at n = 64: laplace_posterior_fit on a GP
    problem, gradients through the closed-form logML backward and the op
    rules, the Hessian reverse over reverse."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=64)
    kwargs = dict(nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3)
    jp = j_define_gp(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]), _GP_PARAMS,
                     validate=False, **kwargs)
    tp = define_gaussian_process(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _GP_PARAMS, **kwargs)
    want = jl.laplace_posterior_fit(problem=jp, initial_guess=jnp.asarray(_GP_STARTS))
    got = tl.laplace_posterior_fit(problem=tp, initial_guess=T(_GP_STARTS))
    assert_same_fit(got, want)
    assert got.param_names == ("amp", "length", "noise")
    assert bool((got.mean > tp.lower).all()) and bool((got.mean < tp.upper).all())
    assert bool(torch.isfinite(torch.linalg.cholesky(got.precision_matrix)).all())


def test_iris_logistic_matches_jax():
    """BASELINE config 3: logistic regression on Fisher Iris (setosa vs
    rest), 5 parameters in [-50, 50]."""
    from sklearn.datasets import load_iris

    iris = load_iris()
    x = (iris.data - iris.data.mean(0)) / iris.data.std(0)
    y = (iris.target == 0).astype(float)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), T(x), T(y)
    params = [(f"b{i}", -50.0, 50.0) for i in range(5)]
    jp = j_define_problem(
        parameters=params,
        log_likelihood=lambda th: jnp.sum(jd.BernoulliLogits(logits=th[0] + xj @ th[1:]).log_prob(yj)),
        log_prior=lambda th: jnp.sum(jd.Normal(0.0, 10.0).log_prob(th)), validate=False)
    tp = define_inference_problem(
        parameters=params,
        log_likelihood=lambda th: torch.sum(td.BernoulliLogits(logits=th[0] + xt @ th[1:]).log_prob(yt)),
        log_prior=lambda th: torch.sum(td.Normal(0.0, 10.0).log_prob(th)), device="cpu",
        dtype=torch.float64)
    starts = np.array([[0.0] * 5, [1.0, -1.0, 2.0, -3.0, -2.0], [-2.0, 0.5, 0.5, 0.5, 0.5]])
    want = jl.laplace_posterior_fit(problem=jp, initial_guess=jnp.asarray(starts))
    got = tl.laplace_posterior_fit(problem=tp, initial_guess=T(starts))
    assert_same_fit(got, want)
    logits = xt @ got.mean[1:] + got.mean[0]
    assert float(((logits > 0).double() == yt).double().mean()) > 0.95


def test_find_mode_slides_along_boundary_and_picks_best_start():
    f_t = lambda x: -((x[0] - 3.0) ** 2) - (x[1] - 3.0) ** 2  # noqa: E731
    f_j = lambda x: -((x[0] - 3.0) ** 2) - (x[1] - 3.0) ** 2  # noqa: E731
    starts = np.array([[0.0, 0.0], [-1.5, 0.5]])
    # unconstrained max at (3, 3); the box caps x0 at 1: optimum (1, 3)
    for lower, upper in (([-5.0, -5.0], [1.0, 5.0]), ([4.0, -np.inf], None), (None, [2.0, np.inf]),
                         ([-5.0, 2.0], [5.0, 2.0])):  # the last one pins x1 at 2
        got = tl.find_mode(f_t, T(starts), lower=None if lower is None else T(lower),
                           upper=None if upper is None else T(upper))
        want = jl.find_mode(f_j, jnp.asarray(starts), lower=None if lower is None else jnp.asarray(lower),
                            upper=None if upper is None else jnp.asarray(upper))
        close(got[0], want[0], rtol=1e-6, atol=1e-8)
        close(got[1], want[1], rtol=0, atol=1e-6)
    # multi-start: the global maximum at x = 2 wins over the local one
    g_t = lambda x: -0.1 * (x[0] ** 2 - 4.0) ** 2 - (x[0] - 2.0) ** 2 * 0.05  # noqa: E731
    mode, _ = tl.find_mode(g_t, T([[-3.0], [0.5], [3.0]]))
    close(mode[0], 2.0, rtol=0, atol=1e-6)


def test_fit_with_mode_on_the_boundary_matches_jax():
    """A mode on the box's edge keeps the L-BFGS end point (no Newton step
    out of the box) and its Hessian, as in the JAX package."""
    f_t = lambda x: -((x[0] - 3.0) ** 2) - 2.0 * (x[1] - 3.0) ** 2 - 0.5 * x[0] * x[1]  # noqa: E731
    f_j = lambda x: -((x[0] - 3.0) ** 2) - 2.0 * (x[1] - 3.0) ** 2 - 0.5 * x[0] * x[1]  # noqa: E731
    starts, lower, upper = [[0.0, 0.0], [-1.5, 0.5]], [-5.0, -5.0], [1.0, 5.0]
    got = tl.approximate_evidence(f_t, T(starts), lower=T(lower), upper=T(upper))
    want = jl.approximate_evidence(f_j, jnp.asarray(starts), lower=jnp.asarray(lower), upper=jnp.asarray(upper))
    assert_same_fit(got, want)
    assert float(got.mean[0]) < 1.0


def test_mackay_fixed_point_and_precision_fit_match_jax():
    rng = np.random.default_rng(2)
    n, k = 40, 4
    phi = rng.normal(size=(n, k))
    y = phi @ rng.normal(size=k) + rng.normal(size=n) / 5.0

    def builder(lib, phi_, y_):
        def density_builder(eta):
            log_alpha, log_beta = eta[0], eta[1]

            def loglike(w):
                r = y_ - phi_ @ w
                return 0.5 * n * (log_beta - math.log(2 * math.pi)) - 0.5 * lib.exp(log_beta) * lib.sum(r * r)

            def logprior(w):
                return 0.5 * k * (log_alpha - math.log(2 * math.pi)) - 0.5 * lib.exp(log_alpha) * lib.sum(w * w)

            return loglike, logprior

        return density_builder

    kw = dict(n_hyper=2, method="fixed_point", initial_hyper=[0.0, 0.0], tolerance=1e-8)
    got = tl.approximate_evidence_hyper(builder(torch, T(phi), T(y)), T(np.zeros((1, k))),
                                        update_function=tl.mackay_update_2(n), **kw)
    want = jl.approximate_evidence_hyper(builder(jnp, jnp.asarray(phi), jnp.asarray(y)), jnp.zeros((1, k)),
                                         update_function=jl.mackay_update_2(n), **kw)
    close(got.hyper_mean, want.hyper_mean, rtol=1e-6)
    close(got.conditional_log_evidence, want.conditional_log_evidence, rtol=1e-6)
    close(got.mean, want.mean, rtol=1e-6, atol=1e-8)
    assert (got.hyper_precision is None) == (want.hyper_precision is None)
    if got.hyper_precision is not None:
        close(got.log_evidence, want.log_evidence, rtol=1e-6)
        assert got.hyper_distribution.event_shape == (2,)

    # the path-based precision fit on a quadratic is exact
    p_true = np.array([[2.0, 0.5], [0.5, 1.5]])
    mode = np.array([1.0, -0.5])
    pts = np.concatenate([[mode], mode + 0.3 * rng.normal(size=(40, 2))])
    dx = pts - mode
    logd = 3.0 - 0.5 * np.einsum("ni,ij,nj->n", dx, p_true, dx)
    close(tl.fit_precision_at_max(T(pts), T(logd)), jl.fit_precision_at_max(jnp.asarray(pts), jnp.asarray(logd)),
          rtol=1e-6)
    close(tl.fit_precision_at_max(T(pts), T(logd)), p_true, rtol=1e-6)
    with pytest.raises(ValueError, match="insufficient"):
        tl.fit_precision_at_max(T(pts[:3]), T(logd[:3]))


def test_nelder_mead_hyper_search_matches_jax():
    """One hyperparameter (log alpha of a ridge prior, known noise): the
    host Nelder-Mead search of logZ + Cauchy hyperprior, driving the inner
    fits of each package, ends at the same hyperparameter and gives the
    same Gaussian hyper posterior."""
    rng = np.random.default_rng(3)
    n, k = 30, 3
    phi = rng.normal(size=(n, k))
    y = phi @ np.array([0.8, -0.5, 0.3]) + rng.normal(size=n)

    def builder(lib, phi_, y_):
        def density_builder(eta):
            return (lambda w: -0.5 * lib.sum((y_ - phi_ @ w) ** 2),
                    lambda w: 0.5 * k * (eta[0] - math.log(2 * math.pi)) - 0.5 * lib.exp(eta[0]) * lib.sum(w * w))

        return density_builder

    kw = dict(initial_hyper=[0.0], tolerance=1e-7)
    got = tl.approximate_evidence_hyper(builder(torch, T(phi), T(y)), T(np.zeros((1, k))), **kw)
    want = jl.approximate_evidence_hyper(builder(jnp, jnp.asarray(phi), jnp.asarray(y)), jnp.zeros((1, k)), **kw)
    close(got.hyper_mean, want.hyper_mean, rtol=0, atol=1e-4)
    close(got.conditional_log_evidence, want.conditional_log_evidence, rtol=0, atol=1e-4)
    close(got.log_evidence, want.log_evidence, rtol=0, atol=1e-4)
    assert got.hyper_distribution is not None


def test_log_evidence_non_pd_and_unported_front_end():
    assert math.isnan(float(tl.laplace_log_evidence(0.0, T([[-1.0]]))))
    close(tl.laplace_log_evidence(1.0, T([[4.0]])), jl.laplace_log_evidence(1.0, jnp.asarray([[4.0]])), rtol=1e-12)
    assert tl._default_tol(torch.float64) == jl._default_tol(jnp.float64)
    assert tl._default_tol(torch.float32) == jl._default_tol(jnp.float32)
    # the model= front end is ported (tests/test_torch_generative.py); it
    # refuses a problem beside a model, as the JAX function does
    problem = define_inference_problem(parameters=[("mu", -1.0, 1.0)], log_likelihood=lambda th: -th[0] ** 2,
                                       device="cpu", dtype=torch.float64, validate=False)
    with pytest.raises(ValueError, match="either model"):
        tl.laplace_posterior_fit(model=object(), problem=problem, data={"y": T([0.0])}, parameters=["mu"])


def test_random_starts_from_generator():
    """Without an initial guess the starts come from the problem's box and
    the caller's generator: the same seed gives the same fit."""
    tp = define_inference_problem(parameters=[("a", -3.0, 3.0), ("b", 0.1, 4.0)],
                                  log_likelihood=lambda th: -((th[0] - 1.0) ** 2) - (th[1] - 2.0) ** 2,
                                  prior_distribution=["location", "location"], device="cpu",
                                  dtype=torch.float64)
    fits = [tl.laplace_posterior_fit(problem=tp, generator=torch.Generator().manual_seed(7), num_starts=4)
            for _ in range(2)]
    assert torch.equal(fits[0].mean, fits[1].mean)
    close(fits[0].mean, [1.0, 2.0], rtol=1e-8)
    close(fits[0].log_evidence, math.log(math.pi) - math.log(6.0 * 3.9), rtol=1e-3)
