"""The port's multivariate Gaussian and Student-t families, the scalar
families of the Laplace path, standardization and the GP logML methods,
against the JAX package on the CPU, float64, numpy-seeded inputs.

Tolerances:

* log-densities through a Cholesky (MVN, MVN-precision, MVT, the
  "automatic" GP logML): rtol 1e-10 (different factorization order);
* closed forms without a factorization (mvgammaln, scalar families,
  standardization, Schur complements): rtol 1e-12;
* ``normalize=True`` logML: rtol 1e-10;
* the Monte-Carlo ``ParameterMixture`` against its analytic marginal:
  atol 0.02 (4096 draws);
* sample moments of 20000 MVN / MVN-precision / MVT draws: atol 0.06 of
  unit-scale moments.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.core import linalg as jla
from bayesianinference_tpu.core.standardize import normalize_data as j_normalize_data
from bayesianinference_tpu.core.standardize import standardize as j_standardize
from bayesianinference_tpu.dists import multivariate as jmv
from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.core import linalg as tla
from bayesianinference_tpu_torch.core.standardize import data_normal_form, normalize_data, standardize
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
from bayesianinference_tpu_torch.ops import gp_kernels as tgk

torch.set_num_threads(1)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T / d + np.eye(d)


@pytest.mark.parametrize("d", [3, 40])  # either side of the JAX package's 32-row Cholesky switch
def test_gaussian_and_t_log_prob_match_jax(d):
    rng = np.random.default_rng(d)
    mean, cov = rng.normal(size=d), _spd(rng, d)
    x = rng.normal(size=(5, d))
    pairs = [
        (jmv.MultivariateNormal(jnp.asarray(mean), jnp.asarray(cov)), td.MultivariateNormal(T(mean), T(cov))),
        (jmv.MultivariateNormalPrecision(jnp.asarray(mean), jnp.asarray(cov)),
         td.MultivariateNormalPrecision(T(mean), T(cov))),
        (jmv.MultivariateT(jnp.asarray(4.5), jnp.asarray(mean), jnp.asarray(cov)),
         td.MultivariateT(T(4.5), T(mean), T(cov))),
    ]
    for jdist, tdist in pairs:
        close(tdist.log_prob(T(x)), jdist.log_prob(jnp.asarray(x)), rtol=1e-10)
        close(tdist.log_prob(T(x[0])), jdist.log_prob(jnp.asarray(x[0])), rtol=1e-10)
        close(tdist.mean(), jdist.mean(), rtol=1e-12)
        close(tdist.covariance(), jdist.covariance(), rtol=1e-10, atol=1e-14)
    # a non-PD covariance gives the sentinel, not NaN
    bad = td.MultivariateNormal(T(mean), T(-np.eye(d))).log_prob(T(x))
    assert bool((bad == -1e300).all())


def test_multivariate_samples_have_the_right_moments():
    rng = np.random.default_rng(1)
    mean, cov = rng.normal(size=3), _spd(rng, 3)
    g = torch.Generator().manual_seed(0)
    for dist, want_cov in (
        (td.MultivariateNormal(T(mean), T(cov)), cov),
        (td.MultivariateNormalPrecision(T(mean), T(np.linalg.inv(cov))), cov),
        (td.MultivariateT(T(7.0), T(mean), T(cov)), cov * 7.0 / 5.0),
    ):
        s = dist.sample(g, (20000,))
        assert s.shape == (20000, 3)
        close(s.mean(0), mean, rtol=0, atol=0.06)
        close(torch.cov(s.T), want_cov, rtol=0, atol=0.06 * np.abs(want_cov).max())


def test_mvgammaln_and_scalar_families_match_jax():
    a = np.array([2.5, 4.0, 7.25])
    close(td.mvgammaln(T(a), 3), jmv.mvgammaln(jnp.asarray(a), 3), rtol=1e-12)
    x = np.array([-1.0, 0.0, 0.3, 1.0, 2.5])
    b = np.array([0.0, 1.0, 1.0, 0.0, 0.5])
    for jdist, tdist, pts in (
        (jd.LogNormal(0.2, 0.7), td.LogNormal(T(0.2), T(0.7)), x),
        (jd.Bernoulli(0.3), td.Bernoulli(T(0.3)), b),
        (jd.BernoulliLogits(jnp.asarray([0.4, -2.0, 3.0, 0.1, 0.0])),
         td.BernoulliLogits(T([0.4, -2.0, 3.0, 0.1, 0.0])), b),
    ):
        close(tdist.log_prob(T(pts)), jdist.log_prob(jnp.asarray(pts)), rtol=1e-12)
        close(tdist.mean(), jdist.mean(), rtol=1e-12)
    close(td.LogNormal(0.2, 0.7).cdf(T(x)), jd.LogNormal(0.2, 0.7).cdf(jnp.asarray(x)), rtol=1e-12)
    close(td.LogNormal(T(0.2), T(0.7)).variance(), jd.LogNormal(0.2, 0.7).variance(), rtol=1e-12)
    draws = td.LogNormal(0.2, 0.7).sample(torch.Generator().manual_seed(0), (20000,))
    close(torch.log(draws).mean(), 0.2, rtol=0, atol=0.02)


def test_standardize_and_block_inverse_match_jax():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(30, 3)) * [1.0, 5.0, 0.0] + [0.0, 2.0, 4.0]  # a constant column keeps scale 1
    z_t, tf_t = standardize(T(data))
    z_j, tf_j = j_standardize(jnp.asarray(data))
    close(z_t, z_j, rtol=1e-12, atol=1e-15)
    close(tf_t.scale, tf_j.scale, rtol=1e-12)
    close(tf_t.inverse(z_t), data, rtol=1e-12, atol=1e-14)
    nd_t, nd_j = normalize_data(T(data[:, 0]), T(data[:, 1])), j_normalize_data(data[:, 0], data[:, 1])
    close(nd_t.x, nd_j.x, rtol=1e-12)
    close(nd_t.y, nd_j.y, rtol=1e-12)
    assert data_normal_form(T(data[:, 0])).shape == (30, 1)
    m = _spd(rng, 5)
    for cols in ([1], [0, 3]):
        close(tla.matrix_block_inverse(T(m), cols), jla.matrix_block_inverse(jnp.asarray(m), jnp.asarray(cols)),
              rtol=1e-12)
        close(tla.inverse_matrix_block_inverse(T(m), cols),
              jla.inverse_matrix_block_inverse(jnp.asarray(m), jnp.asarray(cols)), rtol=1e-12)


_PARAMS = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]


@pytest.mark.parametrize("method,normalize", [("direct", True), ("automatic", False), ("automatic", True)])
def test_gp_logml_methods_match_jax(method, normalize):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 2)) * 3.0 + 1.0
    y = 5.0 * np.sin(x[:, 0]) + 0.1 * rng.normal(size=40) + 10.0
    kwargs = dict(nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3, normalize=normalize,
                  log_likelihood_method=method)
    jp = j_define_gp(jnp.asarray(x), jnp.asarray(y), lambda th: jgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                     validate=False, **kwargs)
    tp = define_gaussian_process(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS, **kwargs)
    direct = define_gaussian_process(T(x), T(y), lambda th: tgk.se_kernel(th[0] ** 2, th[1]), _PARAMS,
                                     **{**kwargs, "log_likelihood_method": "direct"})
    thetas = np.array([[1.0, 0.8, 0.1], [0.5, 2.0, 0.3], [2.0, 0.3, 0.05]])
    want = np.array([float(jp.raw_log_likelihood(jnp.asarray(t))) for t in thetas])
    close(tp.raw_log_likelihood(T(thetas)), want, rtol=1e-10)
    close(direct.raw_log_likelihood(T(thetas)), want, rtol=1e-10)
    pre_t, pre_j = tp.metadata["data_preprocessors"], jp.metadata["data_preprocessors"]
    assert (pre_t is None) == (pre_j is None) == (not normalize)
    if normalize:
        close(pre_t.y_tf.scale, pre_j.y_tf.scale, rtol=1e-12)
        close(pre_t.x_tf.mean, pre_j.x_tf.mean, rtol=1e-12)
    with pytest.raises(ValueError, match="log_likelihood_method"):
        define_gaussian_process(T(x), T(y), None, _PARAMS, log_likelihood_method="exact")


def test_parameter_mixture_marginal():
    """theta ~ N(0, 0.5^2), x | theta ~ N(theta, 1): the marginal of x is
    N(0, 1.25)."""
    mix = td.ParameterMixture(param_dist=td.MultivariateNormal(T([0.0]), T([[0.25]])),
                              build=lambda th: td.Normal(th[0], 1.0), num_quadrature=4096)
    x = T([-1.0, 0.0, 0.7, 2.0])
    want = -0.5 * (x.numpy() ** 2 / 1.25 + math.log(2 * math.pi * 1.25))
    close(mix.log_prob(x), want, rtol=0, atol=0.02)
    s = mix.sample(torch.Generator().manual_seed(1), (500,))
    assert s.shape == (500,) and abs(float(s.var()) - 1.25) < 0.25


# --- the matrix-variate and simplex families of the conjugate engines (rtol 1e-12)


def _matrix_pairs(rng):
    n, p = 4, 2
    loc, row, col = rng.normal(size=(n, p)), _spd(rng, n), _spd(rng, p)
    scale = _spd(rng, 3)
    alpha, probs = np.array([1.5, 2.0, 0.7, 3.0]), np.array([0.1, 0.2, 0.3, 0.4])
    return {
        "matrix_normal": (td.MatrixNormal(T(loc), T(row), T(col)),
                          jmv.MatrixNormal(jnp.asarray(loc), jnp.asarray(row), jnp.asarray(col))),
        "matrix_t": (td.MatrixT(T(6.0), T(loc), T(row), T(col)),
                     jmv.MatrixT(jnp.asarray(6.0), jnp.asarray(loc), jnp.asarray(row), jnp.asarray(col))),
        "wishart": (td.Wishart(T(7.0), T(scale)), jmv.Wishart(jnp.asarray(7.0), jnp.asarray(scale))),
        "inverse_wishart": (td.InverseWishart(T(8.0), T(scale)),
                            jmv.InverseWishart(jnp.asarray(8.0), jnp.asarray(scale))),
        "dirichlet": (td.Dirichlet(T(alpha)), jmv.Dirichlet(jnp.asarray(alpha))),
        "multinomial": (td.Multinomial(10, T(probs)), jmv.Multinomial(10, jnp.asarray(probs))),
    }


def _points(name, rng):
    """Points of each family's support, and (after them) points outside it."""
    if name in ("matrix_normal", "matrix_t"):
        return rng.normal(size=(5, 4, 2)), None
    if name in ("wishart", "inverse_wishart"):
        good = np.stack([_spd(rng, 3) * s for s in (0.5, 1.0, 3.0)])
        return good, np.stack([-np.eye(3), np.diag([1.0, -1.0, 1.0])])
    if name == "dirichlet":
        good = rng.dirichlet([1.0, 1.0, 1.0, 1.0], size=5)
        return good, np.array([[0.5, 0.5, 0.5, -0.5], [0.2, 0.2, 0.2, 0.2]])
    good = np.array([[1.0, 2.0, 3.0, 4.0], [0.0, 0.0, 10.0, 0.0], [2.0, 2.0, 2.0, 4.0]])
    return good, np.array([[1.0, 2.0, 3.0, 3.0], [1.5, 2.0, 3.0, 3.5], [-1.0, 2.0, 5.0, 4.0]])


@pytest.mark.parametrize("name", ["matrix_normal", "matrix_t", "wishart", "inverse_wishart", "dirichlet",
                                  "multinomial"])
def test_matrix_and_simplex_families_match_jax(name):
    rng = np.random.default_rng(21)
    tdist, jdist = _matrix_pairs(rng)[name]
    good, bad = _points(name, rng)
    close(tdist.log_prob(T(good)), jdist.log_prob(jnp.asarray(good)), rtol=1e-12)
    close(tdist.log_prob(T(good[0])), jdist.log_prob(jnp.asarray(good[0])), rtol=1e-12)
    close(tdist.mean(), jdist.mean(), rtol=1e-12)
    if bad is not None:
        got = tdist.log_prob(T(bad))
        assert bool((got == -1e300).all()), got
        close(got, jdist.log_prob(jnp.asarray(bad)), rtol=0)
    if name in ("dirichlet", "multinomial"):
        close(tdist.variance(), jdist.variance(), rtol=1e-12)


@pytest.mark.parametrize("name", ["matrix_normal", "matrix_t", "wishart", "inverse_wishart", "dirichlet",
                                  "multinomial"])
def test_matrix_and_simplex_samples_have_their_means(name):
    """The sample mean of 20000 draws within 4 standard errors (the draws'
    own) of the closed-form mean, elementwise; every draw in the support."""
    rng = np.random.default_rng(22)
    tdist, _ = _matrix_pairs(rng)[name]
    n = 20000
    s = tdist.sample(torch.Generator().manual_seed(5), (n,))
    assert s.shape == (n, *tdist.event_shape)
    assert bool((tdist.log_prob(s) > -1e299).all())
    se = s.std(dim=0) / np.sqrt(n)
    assert bool((torch.abs(s.mean(dim=0) - tdist.mean()) <= 4 * se + 1e-12).all())


def test_bartlett_factor_gives_wishart_draws():
    """A A^T of the lower-triangular Bartlett factor has the Wishart(df, I)
    mean df I, and its diagonal is positive."""
    from bayesianinference_tpu_torch.dists.multivariate import _bartlett

    a = _bartlett(torch.Generator().manual_seed(1), 6.0, 3, torch.float64, (20000,))
    assert a.shape == (20000, 3, 3) and bool((torch.triu(a, 1) == 0).all())
    assert bool((torch.diagonal(a, dim1=-2, dim2=-1) > 0).all())
    w = a @ a.mT
    # Var(W_ii) = 2 df, Var(W_ij) = df for the identity scale
    se = torch.sqrt(torch.tensor([[12.0, 6.0, 6.0], [6.0, 12.0, 6.0], [6.0, 6.0, 12.0]]) / 20000)
    assert bool((torch.abs(w.mean(dim=0) - 6.0 * torch.eye(3, dtype=torch.float64)) < 4 * se).all())


def test_normal_inverse_gamma_and_wishart_match_jax():
    from bayesianinference_tpu.dists import conjugate_structs as jcs
    from bayesianinference_tpu_torch.dists import conjugate_structs as tcs

    tnig, jnig = tcs.NormalInverseGamma(0.3, 2.0, 1.5, 3.0), jcs.NormalInverseGamma(0.3, 2.0, 1.5, 3.0)
    mean, var = np.array([0.1, -0.5, 1.0]), np.array([0.4, 1.0, 2.5])
    close(tnig.log_prob(T(mean), T(var)), jnig.log_prob(jnp.asarray(mean), jnp.asarray(var)), rtol=1e-12)
    close(tnig.marginal_mean().log_prob(T(mean)), jnig.marginal_mean().log_prob(jnp.asarray(mean)), rtol=1e-12)
    close(tnig.marginal_variance().log_prob(T(var)), jnig.marginal_variance().log_prob(jnp.asarray(var)), rtol=1e-12)
    m, v = tnig.sample(torch.Generator().manual_seed(0), (20000,))
    # E[var] = beta / (nu - 1); the mean's marginal is StudentT(2 nu, mu0, sqrt(beta / (nu lam)))
    assert abs(float(v.mean()) - 0.75) < 4 * float(v.std()) / np.sqrt(20000)
    assert abs(float(m.mean()) - 0.3) < 4 * float(m.std()) / np.sqrt(20000)

    rng = np.random.default_rng(3)
    mu0, psi = rng.normal(size=3), _spd(rng, 3)
    tniw = tcs.NormalInverseWishart(T(mu0), T(0.5), T(psi), T(6.0))
    jniw = jcs.NormalInverseWishart(jnp.asarray(mu0), 0.5, jnp.asarray(psi), 6.0)
    x, cov = rng.normal(size=(4, 3)), _spd(rng, 3)
    close(tniw.log_prob(T(x), T(cov)), jniw.log_prob(jnp.asarray(x), jnp.asarray(cov)), rtol=1e-12)
    close(tniw.marginal_mean().log_prob(T(x)), jniw.marginal_mean().log_prob(jnp.asarray(x)), rtol=1e-12)
    close(tniw.marginal_cov().log_prob(T(cov)), jniw.marginal_cov().log_prob(jnp.asarray(cov)), rtol=1e-12)
    m, c = tniw.sample(torch.Generator().manual_seed(1), (20000,))
    assert m.shape == (20000, 3) and c.shape == (20000, 3, 3)
    assert bool((torch.abs(c.mean(dim=0) - T(psi) / 2.0) < 4 * c.std(dim=0) / np.sqrt(20000)).all())
    assert bool((torch.abs(m.mean(dim=0) - T(mu0)) < 4 * m.std(dim=0) / np.sqrt(20000)).all())
