"""The port's Student-t process (``ops/t_process.py``,
``engines/t_process.py``) against the JAX package, on the CPU, float64.

Parity tests put the same numpy-seeded inputs through both packages;
oracle tests hold the port to the oracles of ``tests/test_t_process.py``,
one counterpart each.  Parity tolerances:

* logML, its gradient in (K, y, nu) and the predictive (mean, scale, df):
  rtol 1e-10 (gradients: of their largest entry);
* the problem's Hessian in theta against ``jax.hessian``: 1e-8 of its
  largest entry;
* the Laplace fit of a TP problem: ``test_torch_laplace.py``'s bounds;
* the predictive mixture's quantiles (the bisection on ``StudentT.cdf``,
  through the port's own ``betainc``): 1e-12 relative, 1e-13 absolute.

The end-to-end test reads the predictive's 0.95 quantile, as the JAX test
does, and its spread through ``variance`` as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_t
from scipy.stats import t as student_t

from bayesianinference_tpu.engines import laplace as jl
from bayesianinference_tpu.engines import t_process as jtp
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.ops import t_process as jtpo
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.engines import t_process as ttp
from bayesianinference_tpu_torch.ops import gp_kernels as tgk
from bayesianinference_tpu_torch.ops import t_process as ttpo

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _toy(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    k = np.asarray(jgk.covariance_matrix(jgk.se_kernel(2.0, 1.0), jnp.asarray(x), 0.05))
    y = np.linalg.cholesky(k) @ rng.standard_t(df=4, size=n)
    return x, y, k


_PARAMS = [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)]


def _problems(x, y, nu=3.0, params=_PARAMS, priors=("scale", "scale")):
    kw = dict(nu=nu, nugget_builder=lambda th: 0.02, prior_distribution=list(priors), validate=False)
    jp = jtp.define_t_process(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]), params,
                              **kw)
    tp = ttp.define_t_process(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), params, **kw)
    return jp, tp


def _e2e_data(n=30, seed=4):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    return x, np.sin(1.3 * x[:, 0]) + 0.1 * rng.standard_t(df=3, size=n)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nu", [1.5, 4.0, 25.0])
def test_logml_and_gradient_in_k_y_nu_match_jax(nu):
    _, y, k = _toy(seed=2)
    args = (T(k).requires_grad_(True), T(y).requires_grad_(True), T(nu).requires_grad_(True))
    value = ttpo.tp_log_marginal_likelihood(*args)
    grads = torch.autograd.grad(value, args)
    want, want_grads = jax.value_and_grad(jtpo.tp_log_marginal_likelihood, argnums=(0, 1, 2))(
        jnp.asarray(k), jnp.asarray(y), jnp.asarray(nu))
    close(value.detach(), want, rtol=1e-10)
    for g, w in zip(grads, want_grads):
        close_rel(g, w, 1e-10)


def test_problem_batch_hessian_and_predictive_match_jax():
    x, y = _e2e_data()
    params = _PARAMS + [("nu", 1.0, 50.0)]
    jp, tp = _problems(x, y, nu=lambda th: th[2], params=params, priors=("scale", "scale", "location"))
    thetas = np.array([[1.5, 1.0, 4.0], [np.nan, 1.0, 3.0], [0.7, 0.5, -1.0], [0.9, 2.0, 20.0]])
    got = tp.guarded_log_likelihood(T(thetas))
    assert bool(is_log_zero(got[1])) and bool(is_log_zero(got[2]))
    close(got[[0, 3]], np.asarray(jax.vmap(jp.log_likelihood)(jnp.asarray(thetas)))[[0, 3]], rtol=1e-10)
    th = np.array([1.5, 0.8, 4.0])
    want = np.asarray(jax.hessian(jp.log_likelihood)(jnp.asarray(th)))
    close_rel(torch.autograd.functional.hessian(tp.log_likelihood, T(th)), want, 1e-8)
    xq = np.linspace(-3, 3, 7)[:, None]
    got_p = ttp.predict_from_t_process(T(thetas[[0, 3]]), tp, T(xq))
    want_p = jtp.predict_from_t_process(jnp.asarray(thetas[[0, 3]]), jp, jnp.asarray(xq))
    for f in ("df", "loc", "scale"):
        close(getattr(got_p.component, f), getattr(want_p.component, f), rtol=1e-10, atol=1e-13)


def test_laplace_fit_matches_jax():
    x, y = _e2e_data()
    jp, tp = _problems(x, y)
    starts = np.array([[1.0, 1.0], [2.0, 0.5]])
    want = jl.laplace_posterior_fit(problem=jp, initial_guess=jnp.asarray(starts))
    got = tl.laplace_posterior_fit(problem=tp, initial_guess=T(starts))
    close(got.mean, want.mean, rtol=1e-6, atol=1e-8)
    close(got.log_evidence, want.log_evidence, rtol=0, atol=1e-6)
    p_want = np.asarray(want.precision_matrix)
    close(got.precision_matrix, p_want, rtol=0, atol=1e-5 * np.abs(p_want).max())


# ---------------------------------------------------------------------------
# oracles of tests/test_t_process.py
# ---------------------------------------------------------------------------


def test_logml_matches_scipy_multivariate_t():
    _, y, k = _toy()
    for nu in (1.5, 4.0, 25.0):
        ref = multivariate_t(loc=np.zeros(y.shape[0]), shape=k, df=nu).logpdf(y)
        close(float(ttpo.tp_log_marginal_likelihood(T(k), T(y), nu)), ref, rtol=1e-12)
    ours = float(ttpo.tp_log_marginal_likelihood(T(k), T(y), 4.0, mean=torch.full((y.shape[0],), 0.7,
                                                                                   dtype=torch.float64)))
    ref = multivariate_t(loc=np.full(y.shape[0], 0.7), shape=k, df=4.0).logpdf(y)
    close(ours, ref, rtol=1e-12)


def test_large_nu_recovers_gp():
    x, y, k = _toy(seed=1)
    x, y, k = T(x), T(y), T(k)
    close(float(ttpo.tp_log_marginal_likelihood(k, y, 1e7)), float(tgk.gp_log_marginal_likelihood(k, y)), rtol=1e-5)
    kern = tgk.se_kernel(2.0, 1.0)
    xq = T([[-2.0], [0.3], [2.5]])
    m_tp, s_tp, df = ttpo.tp_posterior_moments(kern, x, y, xq, 1e7, nugget=0.05)
    m_gp, s_gp = tgk.gp_posterior_moments(kern, x, y, xq, nugget=0.05)
    close(m_tp, m_gp, rtol=1e-6)
    close(s_tp, s_gp, rtol=1e-4)
    assert float(df) == pytest.approx(1e7 + y.shape[0])


def test_gradient_matches_finite_differences():
    x, y, _ = _toy(seed=2)
    x, y = T(x), T(y)

    def logml(theta):
        k = tgk.covariance_matrix(tgk.se_kernel(torch.exp(theta[0]), torch.exp(theta[1])), x, 0.05)
        return ttpo.tp_log_marginal_likelihood(k, y, torch.exp(theta[2]))

    theta0 = T([0.4, -0.3, 1.2]).requires_grad_(True)
    (g,) = torch.autograd.grad(logml(theta0), theta0)
    eps = 1e-6
    with torch.no_grad():
        for i in range(3):
            e = torch.zeros(3, dtype=torch.float64)
            e[i] = eps
            fd = (float(logml(theta0 + e)) - float(logml(theta0 - e))) / (2 * eps)
            close(float(g[i]), fd, rtol=2e-5, atol=1e-9)
    k = tgk.covariance_matrix(tgk.se_kernel(2.0, 1.0), x, 0.05)
    yy = y.clone().requires_grad_(True)
    (gy,) = torch.autograd.grad(ttpo.tp_log_marginal_likelihood(k, yy, 4.0), yy)
    with torch.no_grad():
        for i in (0, 5):
            e = torch.zeros_like(y)
            e[i] = eps
            fd = (float(ttpo.tp_log_marginal_likelihood(k, y + e, 4.0))
                  - float(ttpo.tp_log_marginal_likelihood(k, y - e, 4.0))) / (2 * eps)
            close(float(gy[i]), fd, rtol=1e-5, atol=1e-9)


def test_predictive_conditional_consistency():
    nu = 4.0
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(-2, 2, size=(8, 1)), axis=0)
    xq = np.array([[0.55]])
    kern = tgk.se_kernel(1.7, 0.9)
    k_all = tgk.covariance_matrix(kern, T(np.concatenate([x, xq], axis=0)), 0.05).numpy()
    y = np.linalg.cholesky(k_all)[:8, :8] @ rng.normal(size=8)
    m, s, df = ttpo.tp_posterior_moments(kern, T(x), T(y), T(xq), nu, nugget=0.05)
    y_star = 0.8
    cond = student_t(df=float(df), loc=float(m[0]), scale=float(s[0])).logpdf(y_star)
    joint = multivariate_t(loc=np.zeros(9), shape=k_all, df=nu).logpdf(np.concatenate([y, [y_star]]))
    marg = multivariate_t(loc=np.zeros(8), shape=k_all[:8, :8], df=nu).logpdf(y)
    close(cond, joint - marg, rtol=1e-10)


def test_end_to_end_problem_and_prediction():
    x, y = _e2e_data()
    _, problem = _problems(x, y)
    assert bool(is_log_zero(problem.guarded_log_likelihood(T([np.nan, 1.0]))))
    vals = problem.guarded_log_likelihood(T([[1.5, 1.0], [0.7, 0.5]]))
    assert bool(torch.isfinite(vals).all())
    fit = tl.laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    xq = np.linspace(-3, 3, 25)[:, None]
    pred = ttp.predict_from_t_process(fit.mean, problem, T(xq))
    mu = pred.mean().numpy()
    assert mu.shape == (25,)
    assert np.corrcoef(mu, np.sin(1.3 * xq[:, 0]))[0, 1] > 0.95
    # quantiles available (StudentT mixture), and the spread is there
    q = pred.quantile(0.95).numpy()
    assert q.shape == (25,) and np.all(q > mu)
    var = pred.variance().numpy()
    assert var.shape == (25,) and np.all(np.isfinite(var)) and np.all(var > 0)
    pred2 = ttp.predict_from_t_process(fit.mean[None, :].repeat(3, 1), problem, 11)
    assert pred2.mean().shape == (11,)


def test_predictive_quantiles_match_jax():
    x, y = _e2e_data()
    jp, tp = _problems(x, y)
    thetas = np.array([[1.5, 1.0], [0.7, 0.5], [1.1, 1.4]])
    xq = np.linspace(-3, 3, 7)[:, None]
    want = jtp.predict_from_t_process(jnp.asarray(thetas), jp, jnp.asarray(xq))
    got = ttp.predict_from_t_process(T(thetas), tp, T(xq))
    q = np.array([0.05, 0.5, 0.95])
    close(got.quantile(T(q)).numpy(), np.asarray(want.quantile(jnp.asarray(q))), rtol=1e-12, atol=1e-13)
    close(got.cdf(T(np.linspace(-2, 2, 7))).numpy(), np.asarray(want.cdf(jnp.asarray(np.linspace(-2, 2, 7)))),
          rtol=1e-12, atol=1e-15)


def test_variance_inflation_tracks_surprise():
    nu = 3.0
    rng = np.random.default_rng(7)
    x = T(np.sort(rng.uniform(-2, 2, size=(12, 1)), axis=0))
    kern = tgk.se_kernel(2.0, 1.0)
    k = tgk.covariance_matrix(kern, x, 0.05)
    xq = T([[0.3], [1.1]])
    ell = np.linalg.cholesky(k.numpy())
    z = rng.normal(size=12)
    _, s_gp = tgk.gp_posterior_moments(kern, x, T(ell @ z), xq, nugget=0.05)
    for scale, expect_wider in [(4.0, True), (0.1, False)]:
        y = T(ell @ (scale * z))
        beta = float(z @ z) * scale**2
        _, s_tp, _ = ttpo.tp_posterior_moments(kern, x, y, xq, nu, nugget=0.05)
        close(s_tp, np.sqrt((nu + beta) / (nu + 12)) * s_gp.numpy(), rtol=1e-10)
        assert bool((s_tp > s_gp).all()) == expect_wider


def test_inferred_nu_end_to_end():
    rng = np.random.default_rng(6)
    n = 25
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    y = np.sin(1.5 * x[:, 0]) + 0.15 * rng.standard_t(df=3, size=n)
    problem = ttp.define_t_process(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]),
                                   _PARAMS + [("nu", 1.0, 50.0)], nu=lambda th: th[2],
                                   nugget_builder=lambda th: 0.02, prior_distribution=["scale", "scale", "location"],
                                   validate=False)
    th = T([1.5, 0.8, 4.0]).requires_grad_(True)
    (g,) = torch.autograd.grad(problem.log_likelihood(th), th)
    assert bool(torch.isfinite(g).all())
    assert bool(is_log_zero(problem.log_likelihood(T([1.5, 0.8, -1.0]))))


def test_validation_errors():
    with pytest.raises(ValueError, match="kernel"):
        ttp.define_t_process(np.zeros((3, 1)), np.zeros(3), None, parameters=[("a", 0.0, 1.0)], validate=False,
                             device="cpu")
    with pytest.raises(ValueError, match="nu must be positive"):
        ttp.define_t_process(np.zeros((3, 1)), np.zeros(3), lambda th: tgk.se_kernel(1.0, th[0]),
                             parameters=[("ls", 0.1, 5.0)], nu=-2.0, validate=False, device="cpu")
