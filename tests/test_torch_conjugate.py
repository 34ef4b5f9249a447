"""The port's conjugate engines (Bayesian linear regression, the Normal,
Multinormal and categorical models) against the JAX package, on the CPU in
float64 with numpy-seeded data.

Every comparison is at rtol 1e-12: both packages evaluate the same closed
forms, and only the order of a few operations (and the factorization's
summation order) separates them.  ``precision.py::check_blr``'s textbook
NIG marginal likelihood is held at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle_utils import normal_nig_log_evidence_quadrature
from scipy.special import gammaln

from bayesianinference_tpu.dists.conjugate_structs import NormalInverseGamma as JNIG
from bayesianinference_tpu.dists.conjugate_structs import NormalInverseWishart as JNIW
from bayesianinference_tpu.engines import conjugate as jc
from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
from bayesianinference_tpu_torch.engines import conjugate as tc
from bayesianinference_tpu_torch.interop import (
    blr_parameters_from_numpy,
    normal_inverse_gamma_from_numpy,
    normal_inverse_wishart_from_numpy,
)

torch.set_num_threads(1)
RTOL = 1e-12


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _params_close(t, j):
    for f in ("b", "lam", "lam_inv", "v", "nu"):
        close(getattr(t, f), getattr(j, f), atol=1e-13)


def _blr_data(seed, n=64, outputs=1):
    """precision.py::check_blr's law (a cubic plus noise on [-2, 2]), with a
    second output column sin(x) + noise when ``outputs`` is 2."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 1))
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.3 * rng.standard_normal(n)
    if outputs == 2:
        y = np.stack([y, np.sin(x[:, 0]) + 0.2 * rng.standard_normal(n)], axis=-1)
    return x, y, rng.uniform(-2.5, 2.5, (16, 1))


def _fits(x, y, **kw):
    return (jc.bayesian_linear_regression(jnp.asarray(x), jnp.asarray(y), **kw),
            tc.bayesian_linear_regression(T(x), T(y), **kw))


@pytest.mark.parametrize("include_constant", [True, False])
@pytest.mark.parametrize("basis", ["poly3", "identity", "custom"])
def test_design_matrix_matches_jax(basis, include_constant):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(20, 2))
    fns = {
        "poly3": tc.polynomial_basis(3),
        "identity": tc._identity_basis(2),
        "custom": (lambda v: torch.sin(v[0]) * v[1], lambda v: torch.exp(-v[0] ** 2)),
    }[basis]
    jfns = {
        "poly3": jc.polynomial_basis(3),
        "identity": jc._identity_basis(2),
        "custom": (lambda v: jnp.sin(v[0]) * v[1], lambda v: jnp.exp(-v[0] ** 2)),
    }[basis]
    close(tc.design_matrix(T(x), fns, include_constant), jc.design_matrix(jnp.asarray(x), jfns, include_constant))
    assert tc.polynomial_basis(3) is tc.polynomial_basis(3)


@pytest.mark.parametrize("outputs", [1, 2])
def test_blr_evidence_posterior_and_predictive_match_jax(outputs):
    x, y, xq = _blr_data(outputs, outputs=outputs)
    jfit, tfit = _fits(x, y, degree=3)
    assert tfit.output_dim == jfit.output_dim == outputs
    close(tfit.log_evidence, jfit.log_evidence)
    _params_close(tfit.prior_parameters, jfit.prior_parameters)
    _params_close(tfit.posterior_parameters, jfit.posterior_parameters)
    yq = np.asarray(jfit.predictive_distribution(jnp.asarray(xq)).mean())
    for posterior in (True, False):
        for name in ("predictive_distribution", "underlying_value_distribution"):
            jd = getattr(jfit, name)(jnp.asarray(xq), posterior=posterior)
            td = getattr(tfit, name)(T(xq), posterior=posterior)
            close(td.log_prob(T(yq + 0.1)), jd.log_prob(jnp.asarray(yq + 0.1)))


@pytest.mark.parametrize("outputs", [1, 2])
def test_blr_posterior_and_prior_distributions_match_jax(outputs):
    x, y, _ = _blr_data(10 + outputs, outputs=outputs)
    jfit, tfit = _fits(x, y, degree=2)
    for which in ("posterior", "prior"):
        jd, td = getattr(jfit, which), getattr(tfit, which)
        p = jfit.posterior_parameters
        b = np.asarray(p.b) + 0.05
        err = (np.asarray(p.v) / np.asarray(p.nu)) * (1.2 if outputs == 1 else 1.0)
        if outputs == 2:
            err = err + 0.01 * np.eye(2)
        close(td["RegressionCoefficientDistribution"].log_prob(T(b)),
              jd["RegressionCoefficientDistribution"].log_prob(jnp.asarray(b)))
        close(td["ErrorDistribution"].log_prob(T(err)), jd["ErrorDistribution"].log_prob(jnp.asarray(err)))
        name = "variance" if outputs == 1 else "covariance"
        close(td["FullPosterior"].log_prob({name: T(err), "coefficients": T(b)}),
              jd["FullPosterior"].log_prob({name: jnp.asarray(err), "coefficients": jnp.asarray(b)}))


def test_blr_matches_the_textbook_nig_evidence():
    """precision.py::check_blr: Z = pi^(-n/2) sqrt(|L0| / |Ln|)
    G(nun/2) / G(nu0/2) (v0/2)^(nu0/2) / (vn/2)^(nun/2), in numpy."""
    x, y, _ = _blr_data(0)
    n = x.shape[0]
    fit = tc.bayesian_linear_regression(T(x), T(y), degree=3)
    p0, p1 = fit.prior_parameters, fit.posterior_parameters
    v0, nu0, v1, nu1 = (float(t) for t in (p0.v, p0.nu, p1.v, p1.nu))
    ref = (-0.5 * n * np.log(2.0 * np.pi)
           + 0.5 * (np.linalg.slogdet(p0.lam.numpy())[1] - np.linalg.slogdet(p1.lam.numpy())[1])
           + gammaln(nu1 / 2.0) - gammaln(nu0 / 2.0) + (nu0 / 2.0) * np.log(v0 / 2.0) - (nu1 / 2.0) * np.log(v1 / 2.0))
    close(fit.log_evidence, ref)


@pytest.mark.parametrize("outputs", [1, 2])
def test_sufficient_statistics_cores_match_the_dense_path(outputs):
    x, y, _ = _blr_data(20 + outputs, n=200, outputs=outputs)
    fit = tc.bayesian_linear_regression(T(x), T(y), degree=3)
    dmat = tc.design_matrix(T(x), tc.polynomial_basis(3))
    ymat = T(y)[:, None] if outputs == 1 else T(y)
    xtx, xty, yty = dmat.T @ dmat, dmat.T @ ymat, ymat.T @ ymat
    post = tc._blr_update_from_stats(fit.prior_parameters, xtx, xty, yty, x.shape[0])
    for f in ("b", "lam", "lam_inv", "v", "nu"):
        close(getattr(post, f), getattr(fit.posterior_parameters, f), rtol=1e-10, atol=1e-12)
    log_z = tc._blr_log_evidence_from_stats(fit.prior_parameters, post, xtx, xty, yty, x.shape[0])
    close(log_z, fit.log_evidence, rtol=1e-10)
    # and against the JAX package's own stats cores
    jprior = jc._default_prior(4, outputs, jnp.float64)
    jpost = jc._blr_update_from_stats(jprior, *(jnp.asarray(a.numpy()) for a in (xtx, xty, yty)), x.shape[0])
    _params_close(post, jpost)
    close(log_z, jc._blr_log_evidence_from_stats(jprior, jpost, *(jnp.asarray(a.numpy()) for a in (xtx, xty, yty)),
                                                 x.shape[0]))


@pytest.mark.parametrize("outputs", [1, 2])
def test_jax_posterior_seeds_the_port_through_interop(outputs):
    """A JAX posterior, carried across, as the prior of a second fit on new
    data: the port's sequential fit equals the JAX one."""
    x, y, _ = _blr_data(30 + outputs, outputs=outputs)
    x2, y2, _ = _blr_data(40 + outputs, outputs=outputs)
    jfit = jc.bayesian_linear_regression(jnp.asarray(x), jnp.asarray(y), degree=2)
    prior = blr_parameters_from_numpy(jfit.posterior_parameters, device="cpu")
    jsecond = jc.bayesian_linear_regression(jnp.asarray(x2), jnp.asarray(y2), degree=2,
                                            prior=jfit.posterior_parameters)
    tsecond = tc.bayesian_linear_regression(T(x2), T(y2), degree=2, prior=prior)
    assert prior.b.dtype == torch.float64 and prior.b.device.type == "cpu"
    close(tsecond.log_evidence, jsecond.log_evidence)
    _params_close(tsecond.posterior_parameters, jsecond.posterior_parameters)


@pytest.mark.parametrize("with_prior", [False, True])
def test_normal_model_and_update_match_jax(with_prior):
    rng = np.random.default_rng(1)
    y = rng.normal(0.4, 1.3, 40)
    more = rng.normal(0.4, 1.3, 25)
    jprior = JNIG(mu0=0.0, lam=0.5, beta=1.0, nu=2.0) if with_prior else None
    tprior = normal_inverse_gamma_from_numpy(jprior, device="cpu") if with_prior else None
    jres = jc.normal_conjugate_model(jnp.asarray(y), prior=jprior)
    tres = tc.normal_conjugate_model(T(y), prior=tprior)
    close(tres.log_evidence, jres.log_evidence)
    for f in ("mu0", "lam", "beta", "nu"):
        close(getattr(tres.posterior, f), getattr(jres.posterior, f))
    q = np.linspace(-3, 3, 16)
    close(tres.posterior_predictive.log_prob(T(q)), jres.posterior_predictive.log_prob(jnp.asarray(q)))
    close(tres.prior_predictive.log_prob(T(q)), jres.prior_predictive.log_prob(jnp.asarray(q)))
    close(tres.posterior.log_prob(T(0.3), T(1.5)), jres.posterior.log_prob(0.3, 1.5))
    jup, tup = jc.update_conjugate_model(jres, jnp.asarray(more)), tc.update_conjugate_model(tres, T(more))
    close(tup.log_evidence, jup.log_evidence)
    # sequential updating is the batch fit on all the data
    close(tup.log_evidence, tc.normal_conjugate_model(T(np.concatenate([y, more])), prior=tprior).log_evidence,
          rtol=1e-10)


def test_normal_model_closed_form_is_the_quadrature_evidence():
    """precision.py::check_conjugate_normal: the closed form against a
    (mu, log var) Gauss-Legendre quadrature in numpy."""
    rng = np.random.default_rng(1)
    y = rng.normal(0.4, 1.3, 40)
    res = tc.normal_conjugate_model(T(y), prior=NormalInverseGamma(mu0=0.0, lam=0.5, beta=1.0, nu=2.0))
    ref = normal_nig_log_evidence_quadrature(y, mu0=0.0, lam=0.5, a_ig=2.0, scale_ig=1.0, mu_lo=-30.0, mu_hi=30.0,
                                             v_lo=1e-5, v_hi=1e4, n=2000)
    close(res.log_evidence, ref, rtol=1e-12)


@pytest.mark.parametrize("with_prior", [False, True])
def test_multinormal_model_and_update_match_jax(with_prior):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 3))
    data = rng.normal(size=(30, 3)) @ (a @ a.T / 3 + np.eye(3)) + 0.5
    more = rng.normal(size=(12, 3)) + 0.5
    jprior = JNIW(mu0=jnp.asarray([0.1, 0.0, -0.1]), lam=0.5, psi=jnp.eye(3) * 2.0, nu=5.0) if with_prior else None
    tprior = normal_inverse_wishart_from_numpy(jprior, device="cpu") if with_prior else None
    jres = jc.multinormal_conjugate_model(jnp.asarray(data), prior=jprior)
    tres = tc.multinormal_conjugate_model(T(data), prior=tprior)
    close(tres.log_evidence, jres.log_evidence)
    for f in ("mu0", "lam", "psi", "nu"):
        close(getattr(tres.posterior, f), getattr(jres.posterior, f), atol=1e-13)
    q = rng.normal(size=(16, 3))
    close(tres.posterior_predictive.log_prob(T(q)), jres.posterior_predictive.log_prob(jnp.asarray(q)))
    close(tres.prior_predictive.log_prob(T(q)), jres.prior_predictive.log_prob(jnp.asarray(q)))
    jup, tup = jc.update_conjugate_model(jres, jnp.asarray(more)), tc.update_conjugate_model(tres, T(more))
    close(tup.log_evidence, jup.log_evidence)


def test_degenerate_data_give_the_sentinel():
    assert float(tc.normal_conjugate_model(T(np.full(5, 2.0))).log_evidence) == -1e300
    flat = np.zeros((6, 2))
    flat[:, 0] = np.arange(6.0)
    assert float(tc.multinormal_conjugate_model(T(flat)).log_evidence) == -1e300


def test_categorical_models_match_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 4, 50).astype(float)
    more = rng.integers(0, 4, 20).astype(float)
    jres, tres = jc.categorical_conjugate_model(jnp.asarray(data)), tc.categorical_conjugate_model(T(data))
    close(tres.log_evidence, jres.log_evidence)
    close(tres.posterior.alpha, jres.posterior.alpha)
    close(tres.posterior_predictive.log_prob(T(np.arange(4.0))),
          jres.posterior_predictive.log_prob(jnp.arange(4.0)))
    counts = np.bincount(data.astype(int), minlength=4).astype(float)
    close(tc.categorical_conjugate_model_from_counts(T(counts)).log_evidence,
          jc.categorical_conjugate_model_from_counts(jnp.asarray(counts)).log_evidence)
    close(tc.update_conjugate_model(tres, T(more)).log_evidence,
          jc.update_conjugate_model(jres, jnp.asarray(more)).log_evidence)
    with pytest.raises(ValueError):
        tc.categorical_conjugate_model(T([0.0, 1.5]), num_categories=3)
    with pytest.raises(ValueError):
        tc.categorical_conjugate_model(T([0.0, 5.0]), num_categories=3)


def test_entry_points_take_numpy_on_the_cpu_when_asked():
    x, y, _ = _blr_data(0)
    fit = tc.bayesian_linear_regression(x, y, degree=3, device="cpu")
    assert fit.log_evidence.device.type == "cpu" and fit.log_evidence.dtype == torch.float64
    assert tc.normal_conjugate_model(y, device="cpu").log_evidence.device.type == "cpu"
    assert tc.multinormal_conjugate_model(np.stack([x[:, 0], y], -1), device="cpu").log_evidence.device.type == "cpu"


def test_blr_list_targets_keep_float64():
    """``bayesian_linear_regression`` with y as a Python list equals the
    same y as a float64 array: the list goes to x's dtype directly, not
    through a float32 tensor."""
    x = np.linspace(-1.0, 1.0, 12)
    y = [0.1 * i + 0.01 * i * i for i in range(12)]
    a = tc.bayesian_linear_regression(T(x), y, degree=2)
    b = tc.bayesian_linear_regression(T(x), T(np.asarray(y)), degree=2)
    assert float(a.log_evidence) == float(b.log_evidence)
