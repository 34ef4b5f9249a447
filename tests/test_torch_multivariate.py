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
