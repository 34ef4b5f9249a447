"""The port's multi-output GP (``ops/mogp.py``, ``engines/mogp.py``) against
the JAX package, on the CPU, float64.

Parity tests put the same numpy-seeded inputs through both packages;
oracle tests hold the port to the oracles of ``tests/test_mogp.py``, one
counterpart each.  Parity tolerances:

* covariance, dense and Kronecker logML, predictive moments: rtol 1e-10;
* gradients in the kernel's and the coregionalization's parameters and the
  noise: 1e-10 of the largest entry (the Kronecker path's through
  ``eigh``: 1e-8);
* the problem's Hessian in theta against ``jax.hessian``: 1e-8 of its
  largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

from bayesianinference_tpu.engines import mogp as jmg
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.ops import mogp as jmo
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import laplace as tl
from bayesianinference_tpu_torch.engines import mogp as tmg
from bayesianinference_tpu_torch.interop import coregional_parameters_from_numpy
from bayesianinference_tpu_torch.ops import gp_kernels as tgk
from bayesianinference_tpu_torch.ops import mogp as tmo

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _data(n=12, t=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0), rng.normal(size=(n, t)), rng


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_dense_logml_and_gradient_match_jax(masked):
    x, y, rng = _data(n=14, t=3, seed=5)
    a0, d0, noise0 = rng.normal(size=(3, 2)), np.array([0.3, 0.2, 0.4]), np.array([0.05, 0.1, 0.07])
    keep = np.sort(rng.choice(42, size=33, replace=False)) if masked else None
    y_flat = y.T.reshape(-1)[keep] if masked else y.T.reshape(-1)

    def jf(ls, a, d, noise):
        return jmo.mogp_log_marginal_likelihood(jgk.se_kernel(1.3, ls), jmo.coregional_matrix(a, d), jnp.asarray(x),
                                                jnp.asarray(y_flat), noise,
                                                observed_idx=None if keep is None else jnp.asarray(keep), jitter=1e-8)

    args = [T(0.8), T(a0), T(d0), T(noise0)]
    for t in args:
        t.requires_grad_(True)
    value = tmo.mogp_log_marginal_likelihood(tgk.se_kernel(1.3, args[0]), tmo.coregional_matrix(args[1], args[2]),
                                             T(x), T(y_flat), args[3], observed_idx=None if keep is None else
                                             torch.as_tensor(keep), jitter=1e-8)
    grads = torch.autograd.grad(value, args)
    want, want_grads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(0.8, jnp.asarray(a0), jnp.asarray(d0),
                                                                    jnp.asarray(noise0))
    close(value.detach(), want, rtol=1e-10)
    for g, w in zip(grads, want_grads):
        close_rel(g, w, 1e-10)
    kern = tgk.se_kernel(1.3, 0.8)
    close(tmo.mogp_covariance(kern, tmo.coregional_matrix(T(a0), T(d0)), T(x), T(noise0), jitter=1e-8),
          jmo.mogp_covariance(jgk.se_kernel(1.3, 0.8), jmo.coregional_matrix(jnp.asarray(a0), jnp.asarray(d0)),
                              jnp.asarray(x), jnp.asarray(noise0), jitter=1e-8), rtol=1e-12)
    xq = np.array([[-1.2], [0.4], [1.7]])
    got = tmo.mogp_posterior_moments(kern, tmo.coregional_matrix(T(a0), T(d0)), T(x), T(y_flat), T(xq), T(noise0),
                                     observed_idx=None if keep is None else torch.as_tensor(keep), jitter=1e-8)
    ref = jmo.mogp_posterior_moments(jgk.se_kernel(1.3, 0.8), jmo.coregional_matrix(jnp.asarray(a0), jnp.asarray(d0)),
                                     jnp.asarray(x), jnp.asarray(y_flat), jnp.asarray(xq), jnp.asarray(noise0),
                                     observed_idx=None if keep is None else jnp.asarray(keep), jitter=1e-8)
    for g, w in zip(got, ref):
        close(g, w, rtol=1e-10, atol=1e-12)


def test_kronecker_logml_and_gradient_match_jax():
    x, y, rng = _data(n=11, t=3, seed=7)
    a0, d = rng.normal(size=(3, 2)), np.array([0.3, 0.2, 0.4])

    def jf(a):
        return jmo.mogp_log_marginal_kronecker(jgk.se_kernel(1.3, 0.8), jmo.coregional_matrix(a, jnp.asarray(d)),
                                               jnp.asarray(x), jnp.asarray(y), 0.07, jitter=1e-8)

    a = T(a0).requires_grad_(True)
    value = tmo.mogp_log_marginal_kronecker(tgk.se_kernel(1.3, 0.8), tmo.coregional_matrix(a, T(d)), T(x), T(y), 0.07,
                                            jitter=1e-8)
    (g,) = torch.autograd.grad(value, a)
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(a0))
    close(value.detach(), want, rtol=1e-10)
    close_rel(g, want_g, 1e-8)


def _engine_data(seed=4, n=25):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    f = np.sin(1.5 * x[:, 0])
    y = np.stack([f + 0.1 * rng.normal(size=n), 0.7 * f + 0.1 * rng.normal(size=n)], axis=-1)
    y[rng.choice(n, 5, replace=False), 1] = np.nan
    return x, y


_ENGINE_PARAMS = [("amp", 0.05, 5.0), ("ls", 0.1, 5.0), ("b1", -3.0, 3.0), ("b2", -3.0, 3.0), ("sig", 0.02, 2.0)]
_ENGINE_PRIORS = ["scale", "scale", "location", "location", "scale"]


def _engine_problems(x, y):
    kw = dict(noise_builder=lambda th: th[4] ** 2, prior_distribution=_ENGINE_PRIORS, validate=False)
    jp = jmg.define_multi_output_gp(jnp.asarray(x), y, lambda th: jgk.se_kernel(th[0] ** 2, th[1]),
                                    lambda th: jmo.coregional_matrix(th[2:4], jnp.asarray([0.01, 0.01])),
                                    _ENGINE_PARAMS, **kw)
    tp = tmg.define_multi_output_gp(T(x), y, lambda th: tgk.se_kernel(th[0] ** 2, th[1]),
                                    lambda th: tmo.coregional_matrix(th[2:4], T([0.01, 0.01])), _ENGINE_PARAMS, **kw)
    return jp, tp


def test_problem_batch_hessian_and_prediction_match_jax():
    x, y = _engine_data()
    jp, tp = _engine_problems(x, y)
    thetas = np.array([[1.0, 0.8, 1.0, 0.7, 0.1], [np.nan, 0.8, 1.0, 0.7, 0.1], [0.6, 1.4, -0.5, 0.9, 0.3]])
    got = tp.guarded_log_likelihood(T(thetas))
    assert bool(is_log_zero(got[1])) and not bool(is_log_zero(got[[0, 2]]).any())
    close(got[[0, 2]], np.asarray(jax.vmap(jp.log_likelihood)(jnp.asarray(thetas)))[[0, 2]], rtol=1e-10)
    want_h = np.asarray(jax.hessian(jp.log_likelihood)(jnp.asarray(thetas[0])))
    close_rel(torch.autograd.functional.hessian(tp.log_likelihood, T(thetas[0])), want_h, 1e-8)
    xq = np.linspace(-2, 2, 7)[:, None]
    got_p = tmg.predict_from_multi_output_gp(T(thetas[[0, 2]]), tp, T(xq))
    want_p = jmg.predict_from_multi_output_gp(jnp.asarray(thetas[[0, 2]]), jp, jnp.asarray(xq))
    close(got_p.component.loc, want_p.component.loc, rtol=1e-10, atol=1e-12)
    close(got_p.component.scale, want_p.component.scale, rtol=1e-10)


def test_coregional_parameters_from_numpy():
    a, d = coregional_parameters_from_numpy(np.array([[1.0], [0.7]]), np.array([0.1, 0.2]), device="cpu")
    close(tmo.coregional_matrix(a, d), jmo.coregional_matrix(jnp.asarray([[1.0], [0.7]]), jnp.asarray([0.1, 0.2])),
          rtol=1e-15)
    a1, d1 = coregional_parameters_from_numpy([1.0, 0.7], device="cpu")
    assert d1 is None and a1.shape == (2,)


# ---------------------------------------------------------------------------
# oracles of tests/test_mogp.py
# ---------------------------------------------------------------------------


def test_identity_b_reduces_to_independent_gps():
    x, y, _ = _data(n=10, t=3)
    kern = tgk.se_kernel(1.5, 0.9)
    joint = float(tmo.mogp_log_marginal_likelihood(kern, torch.eye(3, dtype=torch.float64), T(x), T(y.T.reshape(-1)),
                                                   torch.full((3,), 0.1, dtype=torch.float64), jitter=1e-10))
    indep = sum(float(tgk.gp_log_marginal_likelihood(tgk.covariance_matrix(kern, T(x), 0.1 + 1e-10), T(y[:, t])))
                for t in range(3))
    close(joint, indep, rtol=1e-10)


def test_logml_matches_scipy_dense_and_masked():
    x, y, rng = _data(n=9, t=2, seed=1)
    kern = tgk.se_kernel(1.2, 0.7)
    b = tmo.coregional_matrix(T([1.0, 0.8]), T([0.2, 0.3]))
    noise = T([0.05, 0.15])
    cov = tmo.mogp_covariance(kern, b, T(x), noise, jitter=1e-8).numpy()
    y_flat = y.T.reshape(-1)
    ref = multivariate_normal(mean=np.zeros(18), cov=cov).logpdf(y_flat)
    close(float(tmo.mogp_log_marginal_likelihood(kern, b, T(x), T(y_flat), noise, jitter=1e-8)), ref, rtol=1e-9)
    keep = np.sort(rng.choice(18, size=13, replace=False))
    ref_m = multivariate_normal(mean=np.zeros(13), cov=cov[np.ix_(keep, keep)]).logpdf(y_flat[keep])
    got_m = float(tmo.mogp_log_marginal_likelihood(kern, b, T(x), T(y_flat[keep]), noise,
                                                   observed_idx=torch.as_tensor(keep), jitter=1e-8))
    close(got_m, ref_m, rtol=1e-9)


def test_posterior_moments_match_dense_formulas():
    x, y, _ = _data(n=8, t=2, seed=2)
    kern = tgk.se_kernel(1.4, 0.8)
    b = tmo.coregional_matrix(T([[1.0], [0.7]]), T([0.1, 0.2]))
    noise = T([0.05, 0.05])
    xq = T([[-1.2], [0.4]])
    mean, std = tmo.mogp_posterior_moments(kern, b, T(x), T(y.T.reshape(-1)), xq, noise, jitter=1e-8)
    cov = tmo.mogp_covariance(kern, b, T(x), noise, jitter=1e-8).numpy()
    bn = b.numpy()
    cross = np.einsum("ts,ij->tisj", bn, kern.matrix(T(x), xq).numpy()).reshape(16, 4)
    prior = np.kron(np.diag(bn), kern.diag(xq).numpy())
    mean_ref = (cross.T @ np.linalg.solve(cov, y.T.reshape(-1))).reshape(2, 2).T
    var_ref = prior - np.einsum("if,ij,jg->fg", cross, np.linalg.inv(cov), cross).diagonal()
    close(mean, mean_ref, rtol=0, atol=1e-9)
    close(std.numpy() ** 2, var_ref.reshape(2, 2).T, rtol=0, atol=1e-9)


def test_cross_output_transfer_fills_the_gap():
    rng = np.random.default_rng(3)
    n = 40
    x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
    f = np.sin(1.7 * x[:, 0])
    y1, y2 = f + 0.05 * rng.normal(size=n), 0.9 * f + 0.05 * rng.normal(size=n)
    y = np.stack([y1, y2], axis=-1)
    observed = np.ones((n, 2), bool)
    observed[x[:, 0] > 0, 1] = False
    kern = tgk.se_kernel(1.0, 0.8)
    b = tmo.coregional_matrix(T([[1.0], [0.9]]), T([0.01, 0.01]))
    flat_mask = observed.T.reshape(-1)
    idx = torch.as_tensor(np.nonzero(flat_mask)[0])
    xq = T(x[x[:, 0] > 0])
    mean, _ = tmo.mogp_posterior_moments(kern, b, T(x), T(y.T.reshape(-1)[flat_mask]), xq,
                                         T([0.05**2, 0.05**2]), observed_idx=idx)
    truth = 0.9 * np.sin(1.7 * xq[:, 0].numpy())
    err_mogp = float(np.sqrt(np.mean((mean[:, 1].numpy() - truth) ** 2)))
    m1, _ = tgk.gp_posterior_moments(kern, T(x[x[:, 0] <= 0]), T(y2[x[:, 0] <= 0]), xq, nugget=0.05**2)
    err_single = float(np.sqrt(np.mean((m1.numpy() - truth) ** 2)))
    assert err_mogp < 0.15 and err_mogp < 0.5 * err_single, (err_mogp, err_single)


def test_engine_end_to_end_with_missing_data():
    x, y = _engine_data()
    _, problem = _engine_problems(x, y)
    theta0 = T([1.0, 0.8, 1.0, 0.7, 0.1])
    assert np.isfinite(float(problem.log_likelihood(theta0)))
    bad = theta0.clone()
    bad[0] = np.nan
    assert bool(is_log_zero(problem.guarded_log_likelihood(bad)))
    th = theta0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(problem.log_likelihood(th), th)
    assert bool(torch.isfinite(g).all())
    fit = tl.laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(fit.log_evidence))
    xq = np.linspace(-2, 2, 7)[:, None]
    mu = tmg.predict_from_multi_output_gp(fit.mean, problem, T(xq)).mean().numpy().reshape(2, 7).T
    assert mu.shape == (7, 2)
    assert np.corrcoef(mu[:, 1], 0.7 * np.sin(1.5 * xq[:, 0]))[0, 1] > 0.9


def test_validation_errors():
    x = np.zeros((4, 1))
    kw = dict(parameters=[("ls", 0.1, 5.0)], validate=False, device="cpu")
    with pytest.raises(ValueError, match="T >= 2"):
        tmg.define_multi_output_gp(x, np.zeros((4, 1)), lambda th: tgk.se_kernel(1.0, th[0]),
                                   lambda th: torch.eye(1), **kw)
    with pytest.raises(ValueError, match="no observed"):
        tmg.define_multi_output_gp(x, np.full((4, 2), np.nan), lambda th: tgk.se_kernel(1.0, th[0]),
                                   lambda th: torch.eye(2), **kw)
    with pytest.raises(ValueError, match="flagged observed"):
        tmg.define_multi_output_gp(x, np.full((4, 2), np.nan), lambda th: tgk.se_kernel(1.0, th[0]),
                                   lambda th: torch.eye(2), observed=np.ones((4, 2), bool), **kw)


def test_kronecker_path_matches_dense():
    x, y, rng = _data(n=11, t=3, seed=7)
    kern = tgk.se_kernel(1.3, 0.8)
    a0 = rng.normal(size=(3, 2))
    d = T([0.3, 0.2, 0.4])
    s2 = 0.07

    def dense(av):
        return tmo.mogp_log_marginal_likelihood(kern, tmo.coregional_matrix(av, d), T(x), T(y.T.reshape(-1)),
                                                torch.full((3,), s2, dtype=torch.float64), jitter=1e-8)

    def kron(av):
        return tmo.mogp_log_marginal_kronecker(kern, tmo.coregional_matrix(av, d), T(x), T(y), s2, jitter=1e-8)

    close(float(kron(T(a0))), float(dense(T(a0))), rtol=1e-6)
    a_d, a_k = T(a0).requires_grad_(True), T(a0).requires_grad_(True)
    (g_d,) = torch.autograd.grad(dense(a_d), a_d)
    (g_k,) = torch.autograd.grad(kron(a_k), a_k)
    close(g_k, g_d, rtol=1e-4, atol=1e-7)
    common = dict(parameters=[("amp", 0.05, 5.0), ("ls", 0.1, 5.0), ("b1", -3.0, 3.0), ("b2", -3.0, 3.0),
                              ("b3", -3.0, 3.0)], noise_builder=lambda th: s2,
                  prior_distribution=["scale"] * 2 + ["location"] * 3, validate=False, jitter=1e-8)
    kb = (lambda th: tgk.se_kernel(th[0] ** 2, th[1]), lambda th: tmo.coregional_matrix(th[2:5].reshape(3, 1), d))
    problem = tmg.define_multi_output_gp(T(x), y, *kb, method="kronecker", **common)
    problem_d = tmg.define_multi_output_gp(T(x), y, *kb, **common)
    th0 = T([1.1, 0.8, 1.0, 0.5, -0.4])
    close(float(problem.log_likelihood(th0)), float(problem_d.log_likelihood(th0)), rtol=1e-6)
    bad = th0.clone()
    bad[0] = np.nan
    assert bool(is_log_zero(problem.guarded_log_likelihood(bad)))
    y_miss = y.copy()
    y_miss[0, 0] = np.nan
    with pytest.raises(ValueError, match="kronecker"):
        tmg.define_multi_output_gp(T(x), y_miss, lambda th: tgk.se_kernel(1.0, th[0]), lambda th: torch.eye(3),
                                   parameters=[("ls", 0.1, 5.0)], method="kronecker", validate=False)
