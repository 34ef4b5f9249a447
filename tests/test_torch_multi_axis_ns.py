"""The port's runs x live x data nested sampler (``parallel/multi_axis_ns.py``)
and the slice branch of the pool-sharded loop, on the port's own draws,
against the oracles of ``tests/test_parallel.py:305-437``, float64.

* ``multi_axis_nested_sampling`` on a (2, 2, 2) mesh of CPU shards (two
  runs, each pool over two live shards, the 64 observations over two data
  shards) against the Gauss-Legendre quadrature logZ within 4 sigma + 0.1,
  and its validation errors, word for word the JAX ones;
* the pool-sharded loop's slice chains on an 8-shard mesh against the
  analytic -2 log 10 within 4 sigma.
"""

import numpy as np
import pytest
import torch
from numpy.polynomial.legendre import leggauss

from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.parallel import (
    make_mesh,
    make_multi_axis_mesh,
    multi_axis_nested_sampling,
    sharded_pool_nested_sampling,
)

torch.set_num_threads(1)


def _quadrature_log_z(y):
    """Z = (1 / (V_mu V_ls)) int int N(y | mu, e^ls) dmu dls: the mu integral
    in closed form, ls by 400-point Gauss-Legendre (the JAX test's oracle)."""
    n_obs = y.shape[0]
    xb, wb = leggauss(400)
    ls, wls = 2.0 * xb, 2.0 * wb
    sig2 = np.exp(2.0 * ls)
    ss = np.sum((y - y.mean()) ** 2)
    log_inner = -0.5 * (n_obs - 1) * np.log(2 * np.pi * sig2) - 0.5 * ss / sig2 - 0.5 * np.log(n_obs)
    m = log_inner.max()
    return m + np.log(np.sum(wls * np.exp(log_inner - m))) - np.log(10.0) - np.log(4.0)


def test_multi_axis_nested_sampling_against_quadrature():
    data = torch.tensor(np.random.default_rng(0).normal(0.5, 1.3, 64))
    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0), ("log_sigma", -2.0, 2.0)],
        log_likelihood=lambda th: Normal(th[0], torch.exp(th[1])).log_prob(data).sum(),
        prior_distribution=["location", "location"], validate=False, device="cpu", dtype=torch.float64)
    mesh = make_multi_axis_mesh(2, 2, 2, devices=["cpu"] * 8)
    assert dict(mesh.shape) == {"runs": 2, "live": 2, "data": 2}
    r = multi_axis_nested_sampling(
        problem, torch.Generator().manual_seed(0), mesh=mesh, sample_pool_size=64, num_delete=8, data=data,
        local_log_likelihood=lambda th, shard: Normal(th[0], torch.exp(th[1])).log_prob(shard).sum(),
        max_iterations=600, min_iterations=50, monte_carlo_steps=40)
    assert r.num_likelihood_evals > 0 and r.iterations > 10 and r.sample_pool_size == 128
    diff = float(r.log_evidence.mean) - _quadrature_log_z(data.numpy())
    assert abs(diff) < 4.0 * float(r.log_evidence.standard_error) + 0.1, diff


def test_multi_axis_validation():
    problem = define_inference_problem(parameters=[("x", -1.0, 1.0)], log_likelihood=lambda th: th.sum() * 0.0,
                                       prior_distribution=["location"], validate=False, device="cpu",
                                       dtype=torch.float64)
    mesh = make_multi_axis_mesh(2, 2, 2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="pass data and local_log_likelihood together"):
        multi_axis_nested_sampling(problem, None, mesh=mesh, sample_pool_size=64, data=torch.zeros(8))
    with pytest.raises(ValueError, match="a data axis of size > 1 needs data"):
        multi_axis_nested_sampling(problem, None, mesh=mesh, sample_pool_size=64)
    with pytest.raises(ValueError, match="per-run pool 63 and num_delete 2 must be multiples of the 'live' axis"):
        multi_axis_nested_sampling(problem, None, mesh=mesh, sample_pool_size=63, data=torch.zeros(8),
                                   local_log_likelihood=lambda th, s: s.sum() * 0.0)
    with pytest.raises(ValueError, match="data length 7 must be a multiple of the 'data' axis size 2"):
        multi_axis_nested_sampling(problem, None, mesh=mesh, sample_pool_size=64, data=torch.zeros(7),
                                   local_log_likelihood=lambda th, s: s.sum() * 0.0)
    with pytest.raises(ValueError, match="missing 'runs'"):
        multi_axis_nested_sampling(problem, None, mesh=make_mesh(("live", "data"), devices=["cpu"] * 2),
                                   sample_pool_size=64)
    with pytest.raises(ValueError, match="needs 8 devices, found 4"):
        make_multi_axis_mesh(2, 2, 2, devices=["cpu"] * 4)


def test_sharded_pool_ns_slice_branch():
    """tests/test_parallel.py::test_sharded_pool_ns_slice_kernel's
    configuration (12 slice updates a chain) on an 8-shard CPU mesh."""
    a = 5.0
    problem = define_inference_problem(parameters=[("x", -a, a), ("y", -a, a)],
                                       log_likelihood=lambda th: Normal(0.0, 1.0).log_prob(th).sum(),
                                       prior_distribution=["location", "location"], validate=False, device="cpu",
                                       dtype=torch.float64)
    r = sharded_pool_nested_sampling(problem, torch.Generator().manual_seed(0),
                                     mesh=make_mesh(("live",), devices=["cpu"] * 8), sample_pool_size=128,
                                     num_delete=8, max_iterations=900, min_iterations=50, monte_carlo_steps=12,
                                     monte_carlo_method="slice")
    z = (float(r.log_evidence.mean) + 2 * np.log(2 * a)) / float(r.log_evidence.standard_error)
    assert abs(z) < 4.0, (float(r.log_evidence.mean), z)
