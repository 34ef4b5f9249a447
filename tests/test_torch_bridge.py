"""The port's bridge-sampling evidence (``engines/bridge.py``) against the
JAX package, on the CPU in float64.

Parity tests put the same draws through both packages, with the proposal's
normals of the JAX key tree (``split(key)[1]``) and, for weighted draws,
the indices of its ``jax.random.choice`` (``split(key)[0]``): the log
evidence and relative error at rtol 1e-10 and the same iteration count.
The evaluation halves have an even count, where the median is the mean of
the two middle values (``torch.median`` would take the lower one), and the
relative error's variances are the population ones (ddof 0: the sample
ones differ by n / (n - 1), 5e-4 here).  Oracle tests hold the port to
``tests/test_bridge.py``'s gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.core.containers import WeightedSamples as JWS
from bayesianinference_tpu.engines import bridge as jbr
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch.core.containers import WeightedSamples
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import bridge as tbr
from bayesianinference_tpu_torch.models.problem import define_inference_problem

torch.set_num_threads(1)
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _conjugate(n_obs=40, seed=1, tau0=3.0):
    rng = np.random.default_rng(seed)
    data = rng.normal(1.2, 1.0, n_obs)
    jp = j_define(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: jd.Normal(th[0], 1.0),
                  data=jnp.asarray(data), prior_distribution=[jd.Normal(0.0, tau0)], validate=False)
    tp = define_inference_problem(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: Normal(th[0], 1.0),
                                  data=T(data), prior_distribution=[Normal(0.0, tau0)], validate=False)
    cov = tau0**2 * np.ones((n_obs, n_obs)) + np.eye(n_obs)
    log_z = st.multivariate_normal(np.zeros(n_obs), cov).logpdf(data)
    post_prec = 1 / tau0**2 + n_obs
    return jp, tp, log_z, (data.sum() / post_prec, post_prec**-0.5)


def _proposal_normals(key, n, d):
    return T(np.asarray(jax.random.normal(jax.random.split(key)[1], (n, d), F64)))


def test_median_is_the_midpoint_of_an_even_count():
    x = np.random.default_rng(0).normal(size=10)
    assert float(tbr._median(T(x))) == float(jnp.median(jnp.asarray(x)))
    assert float(tbr._median(T(x[:9]))) == float(jnp.median(jnp.asarray(x[:9])))
    assert float(tbr._median(T(x))) != float(torch.median(T(x)))


@pytest.mark.parametrize("n, num_proposal", [(4000, 0), (4002, 0), (1000, 1500)])
def test_bridge_matches_jax_on_the_same_draws(n, num_proposal):
    """2000 and 2001 evaluation draws (an even and an odd median), and more
    proposal draws than posterior draws."""
    jp, tp, _, (pm, ps) = _conjugate()
    draws = (pm + ps * np.random.default_rng(7).normal(size=n))[:, None]
    key = jax.random.PRNGKey(3)
    want = jbr.bridge_sampling_evidence(jp, jnp.asarray(draws), key, num_proposal_draws=num_proposal)
    n2 = num_proposal or n // 2
    got = tbr.bridge_sampling_evidence(tp, T(draws), None, num_proposal_draws=num_proposal,
                                       proposal_normals=_proposal_normals(key, n2, 1))
    close(float(got.log_evidence), float(want.log_evidence), rtol=1e-10)
    close(float(got.relative_error), float(want.relative_error), rtol=1e-10)
    assert got.num_iterations == int(want.num_iterations) and got.converged == bool(want.converged)
    assert (got.num_posterior_draws, got.num_proposal_draws) == (want.num_posterior_draws, want.num_proposal_draws)


def test_bridge_matches_jax_on_weighted_draws_and_chain_stacks():
    """A ``WeightedSamples`` with non-uniform weights is resampled by the
    JAX choice's indices; a [chains, samples, d] stack is flattened."""
    jp, tp, _, (pm, ps) = _conjugate()
    rng = np.random.default_rng(11)
    pts = (pm + 1.5 * ps * rng.normal(size=3000))[:, None]
    lw = st.norm(pm, ps).logpdf(pts[:, 0]) - st.norm(pm, 1.5 * ps).logpdf(pts[:, 0])
    key = jax.random.PRNGKey(8)
    want = jbr.bridge_sampling_evidence(jp, JWS(points=jnp.asarray(pts), log_weights=jnp.asarray(lw)), key)
    w = np.exp(lw - lw.max())
    idx = jax.random.choice(jax.random.split(key)[0], 3000, (3000,), replace=True, p=jnp.asarray(w / w.sum()))
    got = tbr.bridge_sampling_evidence(tp, WeightedSamples(points=T(pts), log_weights=T(lw)), None,
                                       indices=T(np.asarray(idx)), proposal_normals=_proposal_normals(key, 1500, 1))
    close(float(got.log_evidence), float(want.log_evidence), rtol=1e-10)
    close(float(got.relative_error), float(want.relative_error), rtol=1e-10)
    stack = pts[:2400].reshape(4, 600, 1)
    want = jbr.bridge_sampling_evidence(jp, jnp.asarray(stack), key)
    got = tbr.bridge_sampling_evidence(tp, T(stack), None, proposal_normals=_proposal_normals(key, 1200, 1))
    close(float(got.log_evidence), float(want.log_evidence), rtol=1e-10)


# ---------------------------------------------------------------------------
# the JAX tests' oracles, on CPU tensors
# ---------------------------------------------------------------------------


def test_bridge_conjugate_oracle():
    _, problem, log_z, (pm, ps) = _conjugate()
    draws = (pm + ps * np.random.default_rng(7).normal(size=4000))[:, None]
    r = tbr.bridge_sampling_evidence(problem, T(draws), torch.Generator().manual_seed(0))
    assert r.converged and r.num_iterations < 20
    np.testing.assert_allclose(float(r.log_evidence), log_z, atol=5e-3)
    assert 0.0 < float(r.relative_error) < 0.01
    assert float(r.standard_error) == float(r.relative_error)


def test_bridge_from_hmc_and_pathfinder():
    from bayesianinference_tpu_torch.engines import hmc_sample, pathfinder_fit

    _, problem, log_z, _ = _conjugate()
    h = hmc_sample(problem, torch.Generator().manual_seed(0), num_chains=4, num_samples=400, num_warmup=200,
                   num_leapfrog=8)
    r_arr = tbr.bridge_sampling_evidence(problem, h.samples, torch.Generator().manual_seed(1))
    r_res = tbr.bridge_sampling_evidence(problem, h, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(r_arr.log_evidence), float(r_res.log_evidence), atol=1e-9)
    np.testing.assert_allclose(float(r_res.log_evidence), log_z, atol=0.05)
    pf = pathfinder_fit(problem, torch.Generator().manual_seed(0), num_paths=4)
    r_pf = tbr.bridge_sampling_evidence(problem, pf, torch.Generator().manual_seed(2))
    np.testing.assert_allclose(float(r_pf.log_evidence), log_z, atol=0.05)


def test_bridge_from_weighted_ns_result():
    """Bridge on resampled NS output agrees with NS's own logZ (the JAX
    test's shared_ns problem, run by the port)."""
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    data = T(np.random.default_rng(3).normal(1.2, 1.0, size=40))
    problem = define_inference_problem(parameters=[("mu", -5.0, 5.0)],
                                       log_likelihood=lambda th: torch.sum(Normal(th[0], 1.0).log_prob(data)),
                                       prior_distribution=["location"], validate=False, device="cpu",
                                       dtype=torch.float64)
    res = nested_sampling(problem, torch.Generator().manual_seed(42), sample_pool_size=100, max_iterations=800,
                          monte_carlo_steps=20)
    r = tbr.bridge_sampling_evidence(problem, res, torch.Generator().manual_seed(0))
    ns_log_z, ns_se = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    assert abs(float(r.log_evidence) - ns_log_z) < 3 * ns_se + 0.05


def test_bridge_bounded_scale_parameter():
    """A posterior pressed against a box edge rides the bijection; oracle:
    1-D Gauss-Legendre quadrature, exact draws by inverse CDF on its grid."""
    rng = np.random.default_rng(3)
    data = rng.normal(0.0, 0.7, 50)
    problem = define_inference_problem(parameters=[("sigma", 0.05, 4.0)], likelihood=lambda th: Normal(0.0, th[0]),
                                       data=T(data), prior_distribution=["scale"], validate=False)
    xg, wg = np.polynomial.legendre.leggauss(400)
    sig = 0.5 * (xg + 1) * (4.0 - 0.05) + 0.05
    wq = wg * 0.5 * (4.0 - 0.05)
    loglike = np.array([st.norm(0, s).logpdf(data).sum() for s in sig])
    logprior = -np.log(sig) - np.log(np.log(4.0 / 0.05))
    log_z = np.log(np.sum(wq * np.exp(loglike + logprior - loglike.max()))) + loglike.max()
    dens = np.exp(loglike + logprior - (loglike + logprior).max()) * wq
    cdf = np.cumsum(dens) / dens.sum()
    draws = np.interp(rng.uniform(size=3000), cdf, sig)[:, None]
    r = tbr.bridge_sampling_evidence(problem, T(draws), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(r.log_evidence), log_z, atol=0.02)


def test_bridge_validation():
    _, problem, *_ = _conjugate()
    with pytest.raises(ValueError):
        tbr.bridge_sampling_evidence(problem, torch.zeros((4, 1), dtype=torch.float64))
    with pytest.raises(ValueError):
        tbr.bridge_sampling_evidence(problem, torch.zeros((100,), dtype=torch.float64))
    draws = torch.linspace(0.5, 2.0, 100, dtype=torch.float64)[:, None]
    with pytest.raises(ValueError, match="proposal_normals"):
        tbr.bridge_sampling_evidence(problem, draws, proposal_normals=torch.zeros((3, 1), dtype=torch.float64))
    # identical draws: the proposal's covariance is singular and the
    # estimate is NaN, as in JAX, rather than an exception
    r = tbr.bridge_sampling_evidence(problem, torch.ones((100, 1), dtype=torch.float64))
    assert not np.isfinite(float(r.log_evidence)) and not r.converged
