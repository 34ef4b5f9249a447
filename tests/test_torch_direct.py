"""The port's direct (quadrature) posterior against the JAX package, on the
CPU in float64: the Gauss-Legendre grid bit for bit (both build it in
numpy), and on ``precision.py::check_direct``'s problem (a Normal mean and
variance under a normal-inverse-gamma prior) at 100 x 100 nodes the log
evidence, mean and covariance at rtol 1e-10, beside the closed-form
quadrature oracle of ``tests/oracle_utils.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle_utils import normal_nig_log_evidence_quadrature

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines import direct as jdirect
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.engines import direct as tdirect
from bayesianinference_tpu_torch.models.problem import define_inference_problem as t_define

torch.set_num_threads(1)
MU_B, V_LO, V_HI = 8.0, 0.05, 20.0


def close(got, want, rtol=1e-10, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(2).normal(0.2, 1.1, 25)


@pytest.fixture(scope="module")
def posteriors(data):
    params = [("mu", -MU_B, MU_B), ("var", V_LO, V_HI)]
    jprob = j_define(
        parameters=params,
        log_likelihood=lambda th: jnp.sum(jd.Normal(th[0], jnp.sqrt(th[1])).log_prob(jnp.asarray(data))),
        log_prior=lambda th: jd.Normal(0.0, jnp.sqrt(th[1] / 0.5)).log_prob(th[0]) + jd.InverseGamma(2.0, 1.0).log_prob(
            th[1]),
        validate=False,
    )
    y = torch.tensor(data)
    tprob = t_define(
        parameters=params,
        log_likelihood=lambda th: torch.sum(td.Normal(th[0], torch.sqrt(th[1])).log_prob(y)),
        log_prior=lambda th: td.Normal(0.0, torch.sqrt(th[1] / 0.5)).log_prob(th[0]) + td.InverseGamma(2.0, 1.0).log_prob(
            th[1]),
        validate=False, device="cpu", dtype=torch.float64,
    )
    return (jdirect.direct_posterior_distribution(problem=jprob, num_points=100),
            tdirect.direct_posterior_distribution(problem=tprob, num_points=100))


@pytest.mark.parametrize("num_points,lower,upper", [(7, [-1.0], [2.0]), (12, [-8.0, 0.05], [8.0, 20.0]),
                                                    (5, [0.0, -1.0, 2.0], [1.0, 1.0, 3.0])])
def test_gauss_legendre_grid_is_the_jax_grid(num_points, lower, upper):
    jn, jw = jdirect.gauss_legendre_grid(np.asarray(lower), np.asarray(upper), num_points)
    tn, tw = tdirect.gauss_legendre_grid(torch.tensor(lower, dtype=torch.float64), upper, num_points)
    assert tn.shape == (num_points ** len(lower), len(lower))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_direct_posterior_matches_jax(posteriors):
    jpost, tpost = posteriors
    close(tpost.log_evidence, jpost.log_evidence)
    close(tpost.node_log_density, jpost.node_log_density, rtol=1e-12)
    close(tpost.mean(), jpost.mean())
    close(tpost.covariance(), jpost.covariance())
    close(tpost.variance(), jpost.variance())
    theta = np.array([[0.1, 1.0], [0.5, 2.0], [-1.0, 0.3]])
    close(tpost.log_pdf(torch.tensor(theta)), jax.vmap(jpost.log_pdf)(jnp.asarray(theta)))


def test_direct_evidence_is_the_quadrature_oracle(posteriors, data):
    _, tpost = posteriors
    ref = normal_nig_log_evidence_quadrature(data, mu0=0.0, lam=0.5, a_ig=2.0, scale_ig=1.0, mu_lo=-MU_B, mu_hi=MU_B,
                                             v_lo=V_LO, v_hi=V_HI)
    close(tpost.log_evidence, ref, rtol=1e-6)


def test_direct_samples_follow_the_grid_moments(posteriors):
    _, tpost = posteriors
    draws = tpost.sample(torch.Generator().manual_seed(0), (20000,))
    assert draws.shape == (20000, 2)
    sd = torch.sqrt(tpost.variance())
    assert bool((torch.abs(draws.mean(dim=0) - tpost.mean()) < 4 * sd / np.sqrt(20000)).all())


def test_direct_needs_finite_bounds():
    with pytest.raises(ValueError):
        tdirect.direct_posterior_distribution(parameters=[("a", 0.0, float("inf"))],
                                              log_likelihood=lambda th: -th[0] ** 2,
                                              log_prior=lambda th: torch.zeros(()), device="cpu",
                                              dtype=torch.float64)


def test_gauss_legendre_grid_stays_on_the_host_when_asked():
    """The grid goes where a tensor ``lower`` lies, or to ``device``; numpy
    bounds without ``device`` go to the card (``test_torch_cuda.py``), and
    raise where there is none."""
    nodes, log_w = tdirect.gauss_legendre_grid(torch.tensor([0.0, -1.0], dtype=torch.float64), [1.0, 1.0], 4)
    assert nodes.device.type == "cpu" and log_w.device.type == "cpu" and nodes.shape == (16, 2)
    nodes, log_w = tdirect.gauss_legendre_grid(np.array([0.0]), np.array([1.0]), 4, device="cpu",
                                               dtype=torch.float32)
    assert nodes.device.type == "cpu" and nodes.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdirect.gauss_legendre_grid(np.array([0.0]), np.array([1.0]), 4)
