"""The port's first slice end to end on the CPU: GP hyperparameter posterior
by nested sampling (``define_gaussian_process -> nested_sampling ->
predict_from_gaussian_process``), float64, n = 20.

Oracles:

* logZ against grid quadrature over the three log-uniform hyperparameters,
  computed with the JAX package's ``gp_log_marginal_likelihood`` in one
  jitted vmap (midpoint rule in log space, 30^3 points; its error is taken
  as the difference to a 20^3 grid).  The port's logZ must lie within 3 of
  its own standard errors plus that grid error.
* the logML at posterior points and the posterior predictive against the
  JAX package fed the port's posterior points and weights: rtol 1e-10 for
  the logML, 1e-8 for the predictive moments (a mixture over hundreds of
  Cholesky solves).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.core.containers import WeightedSamples as JWeightedSamples
from bayesianinference_tpu.core.numerics import logsumexp as j_logsumexp
from bayesianinference_tpu.engines.gp import define_gaussian_process as j_define_gp
from bayesianinference_tpu.engines.gp import predict_from_gaussian_process as j_predict
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu_torch.engines.gp import define_gaussian_process, predict_from_gaussian_process
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.interop import problem_data_from_numpy
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

torch.set_num_threads(1)
PARAMS = [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)]


def _data(n=20, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def _grid_log_z(x, y, num):
    lo = np.log([p[1] for p in PARAMS])
    hi = np.log([p[2] for p in PARAMS])
    axes = [lo[i] + (np.arange(num) + 0.5) * (hi[i] - lo[i]) / num for i in range(3)]
    th = np.exp(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3))
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    @jax.jit
    def logml(t):
        k = jgk.covariance_matrix(jgk.se_kernel(t[0] ** 2, t[1]), xj, nugget=t[2] ** 2, symmetrize=False)
        return jgk.gp_log_marginal_likelihood(k, yj)

    ll = jax.vmap(logml)(jnp.asarray(th))
    return float(j_logsumexp(ll)) - 3 * math.log(num)


@pytest.fixture(scope="module")
def slice_run():
    x, y = _data()
    xt, yt = problem_data_from_numpy(x, y, device="cpu", dtype=torch.float64)
    problem = define_gaussian_process(
        xt, yt,
        kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
        nugget_builder=lambda th: th[2] ** 2,
        parameters=PARAMS,
        prior_distribution=["scale", "scale", "scale"],
    )
    result = nested_sampling(problem, torch.Generator().manual_seed(0), sample_pool_size=40,
                             num_delete=4, monte_carlo_steps=20)
    return x, y, problem, result


def test_slice_log_evidence_matches_grid_quadrature(slice_run):
    x, y, problem, result = slice_run
    logz = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert math.isfinite(logz) and math.isfinite(err) and err > 0
    z30, z20 = _grid_log_z(x, y, 30), _grid_log_z(x, y, 20)
    grid_err = abs(z30 - z20)
    assert grid_err < 0.05
    assert abs(logz - z30) <= 3 * err + grid_err, (logz, err, z30, grid_err)
    assert result.iterations >= 100
    assert result.points.dtype == torch.float64 and result.points.shape[1] == 3


def test_slice_logml_and_prediction_match_jax(slice_run):
    x, y, problem, result = slice_run
    jproblem = j_define_gp(
        jnp.asarray(x), jnp.asarray(y),
        kernel_builder=lambda th: jgk.se_kernel(th[0] ** 2, th[1]),
        nugget_builder=lambda th: th[2] ** 2,
        parameters=PARAMS,
        prior_distribution=["scale", "scale", "scale"],
    )
    pts = result.points[:64]
    got = problem.guarded_log_likelihood(pts).numpy()
    want = np.asarray(jax.vmap(jproblem.guarded_log_likelihood)(jnp.asarray(pts.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-10)

    xq = np.random.default_rng(1).normal(size=(7, 3))
    pred = predict_from_gaussian_process(result, problem, torch.as_tensor(xq), max_samples=None)
    jpred = j_predict(
        JWeightedSamples(points=jnp.asarray(result.points.numpy()),
                         log_weights=jnp.asarray(result.crude_log_posterior_weights.numpy())),
        jproblem, jnp.asarray(xq), max_samples=None,
    )
    np.testing.assert_allclose(pred.mean().numpy(), np.asarray(jpred.mean()), rtol=1e-8)
    np.testing.assert_allclose(pred.variance().numpy(), np.asarray(jpred.variance()), rtol=1e-8)
    assert np.isfinite(pred.mean().numpy()).all() and (pred.variance().numpy() > 0).all()
