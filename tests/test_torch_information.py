"""The port's information criteria and model weights
(``results/information.py``) against the JAX package, on the CPU in
float64.

Parity tests put the same samples, weights and pointwise log-likelihoods
through both packages: the generalized-Pareto fit and the PSIS tail, WAIC,
PSIS-LOO (with a sentinel-flagged observation) and all three model-weight
methods (pseudo-BMA+ on the JAX Dirichlet draws), at rtol 1e-12.  Oracle
tests hold the port to the information tests of
``tests/test_diagnostics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.core.containers import WeightedSamples as JWS
from bayesianinference_tpu.results import information as jinf
from bayesianinference_tpu_torch.core.containers import WeightedSamples
from bayesianinference_tpu_torch.dists.scalar import Normal, Uniform
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.results import information as tinf

torch.set_num_threads(1)
RTOL = 1e-12


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


@pytest.mark.parametrize("s, seed", [(50, 0), (400, 1), (4000, 2), (4, 3)])
def test_psis_tail_and_gpd_fit_match_jax(s, seed):
    lr = np.random.default_rng(seed).standard_t(3, size=s)
    got, k = tinf._psis_smooth_tail(lr)
    want, kj = jinf._psis_smooth_tail(lr)
    close(got, want)
    assert (k == kj) if not np.isfinite(kj) else abs(k - kj) <= RTOL * abs(kj)
    x = np.sort(np.random.default_rng(seed).exponential(size=max(s // 5, 5)))
    close(tinf._gpd_fit(x), jinf._gpd_fit(x))


def _normal_sample(n_draws=600, n_obs=25, seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    y = rng.normal(0.8, 1.3, size=n_obs)
    pts = np.stack([rng.normal(0.8, 0.3, n_draws), rng.normal(0.3, 0.2, n_draws)], axis=1)
    lw = rng.normal(size=n_draws) if weighted else np.zeros(n_draws)
    lw[:5] = -np.inf if weighted else 0.0  # zero-weight draws take the sentinel
    return y, pts, lw


@pytest.mark.parametrize("weighted", [True, False])
def test_waic_and_psis_loo_match_jax(weighted):
    y, pts, lw = _normal_sample(weighted=weighted)
    jws = JWS(points=jnp.asarray(pts), log_weights=jnp.asarray(lw))
    tws = WeightedSamples(points=T(pts), log_weights=T(lw))

    def jpw(th):
        return jd.Normal(th[0], jnp.exp(th[1])).log_prob(jnp.asarray(y))

    def tpw(th):
        return Normal(th[0], torch.exp(th[1])).log_prob(T(y))

    want, got = jinf.waic(jws, jpw), tinf.waic(tws, tpw)
    for f in ("waic", "elpd", "p_waic", "se"):
        close(getattr(got, f), getattr(want, f))
    close(got.pointwise_elpd.numpy(), np.asarray(want.pointwise_elpd))
    want, got = jinf.psis_loo(jws, jpw), tinf.psis_loo(tws, tpw)
    for f in ("elpd_loo", "p_loo", "se"):
        close(getattr(got, f), getattr(want, f))
    close(got.pointwise_elpd.numpy(), np.asarray(want.pointwise_elpd))
    close(got.pareto_k.numpy(), np.asarray(want.pareto_k))
    assert "LOO" in repr(got) and "WAIC" in repr(tinf.waic(tws, tpw))


def test_psis_loo_sentinel_flags_match_jax():
    y = [0.5, 0.9, 2.5]
    thetas = [[1.0], [2.0], [3.0], [2.8]]
    with pytest.warns(UserWarning):
        want = jinf.psis_loo(JWS(points=jnp.asarray(thetas), log_weights=jnp.zeros(4)),
                             lambda th: jd.Uniform(0.0, th[0]).log_prob(jnp.asarray(y)))
    with pytest.warns(UserWarning):
        got = tinf.psis_loo(WeightedSamples(points=T(thetas), log_weights=torch.zeros(4, dtype=torch.float64)),
                            lambda th: Uniform(0.0, th[0]).log_prob(T(y)))
    close(got.pointwise_elpd.numpy(), np.asarray(want.pointwise_elpd))
    np.testing.assert_array_equal(np.isinf(got.pareto_k.numpy()), np.isinf(np.asarray(want.pareto_k)))
    assert np.isinf(got.pareto_k.numpy()[2])


def _elpds(seed=0, n=200):
    rng = np.random.default_rng(seed)
    e1 = rng.normal(-1.0, 0.8, size=n)
    e2 = np.where(rng.uniform(size=n) < 0.4, e1 + 1.2, e1 - 0.9)
    e3 = e1 + rng.normal(0.0, 0.3, size=n)
    return [e1, e2, e3]


@pytest.mark.parametrize("k", [2, 3])
def test_model_weights_match_jax(k):
    elpds = _elpds()[:k]
    for method in ("stacking", "pseudo-bma"):
        close(tinf.model_weights(elpds, method=method, device="cpu").numpy(),
              np.asarray(jinf.model_weights(elpds, method=method)))
    key = jax.random.PRNGKey(5)
    want = jinf.model_weights(elpds, method="pseudo-bma+", key=key, n_bootstrap=300)
    alpha = jax.random.dirichlet(key, jnp.ones((200,), jnp.float64), shape=(300,))
    got = tinf.model_weights([T(e) for e in elpds], method="pseudo-bma+", dirichlet=T(np.asarray(alpha)))
    close(got.numpy(), np.asarray(want))
    assert got.device.type == "cpu" and got.dtype == torch.float64


# ---------------------------------------------------------------------------
# the JAX tests' oracles, on CPU tensors
# ---------------------------------------------------------------------------


def test_waic_cross_engine_and_pwaic():
    """WAIC from an NS run agrees with WAIC from the direct-quadrature
    grid of the same problem; p_waic is near 1 for one parameter."""
    from bayesianinference_tpu_torch.engines.direct import direct_posterior_distribution
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    data = T(np.random.default_rng(3).normal(1.2, 1.0, size=40))

    def pointwise(th):
        return Normal(th[0], 1.0).log_prob(data)

    problem = define_inference_problem(parameters=[("mu", -5.0, 5.0)],
                                       log_likelihood=lambda th: torch.sum(pointwise(th)),
                                       prior_distribution=["location"], validate=False, device="cpu",
                                       dtype=torch.float64)
    res = nested_sampling(problem, torch.Generator().manual_seed(42), sample_pool_size=100, max_iterations=800,
                          monte_carlo_steps=20)
    w_ns = tinf.waic(res, pointwise)
    dp = direct_posterior_distribution(problem=problem, num_points=512)
    grid = WeightedSamples(points=dp.nodes, log_weights=dp.log_quad_weights + dp.node_log_density)
    w_grid = tinf.waic(grid, pointwise)
    assert abs(w_ns.waic - w_grid.waic) < 1.5, (w_ns, w_grid)
    assert 0.5 < w_grid.p_waic < 2.0
    assert w_ns.pointwise_elpd.shape == (40,)


def test_psis_loo_matches_exact_refit_loo():
    """PSIS-LOO against the exact leave-one-out predictive of the conjugate
    Normal model (n refits of the NIG posterior predictive)."""
    from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu_torch.engines.conjugate import normal_conjugate_model
    from bayesianinference_tpu_torch.engines.direct import direct_posterior_distribution

    y = np.random.default_rng(7).normal(0.8, 1.3, size=20)
    prior = NormalInverseGamma(mu0=0.0, lam=0.5, beta=1.0, nu=1.0)
    exact = sum(float(normal_conjugate_model(T(np.delete(y, i)), prior=prior).posterior_predictive.log_prob(
        T(y[i]))) for i in range(len(y)))

    def pointwise(th):
        return Normal(th[0], torch.sqrt(torch.exp(th[1]))).log_prob(T(y))

    problem = define_inference_problem(
        parameters=[("mu", -4.0, 5.0), ("logv", -4.0, 4.0)], log_likelihood=lambda th: torch.sum(pointwise(th)),
        log_prior=lambda th: prior.log_prob(th[0], torch.exp(th[1])) + th[1], validate=False, device="cpu",
        dtype=torch.float64)
    dp = direct_posterior_distribution(problem=problem, num_points=160)
    grid = WeightedSamples(points=dp.nodes, log_weights=dp.log_quad_weights + dp.node_log_density)
    draws = grid.resample(torch.Generator().manual_seed(0), 4000)
    ws = WeightedSamples(points=draws, log_weights=torch.zeros(4000, dtype=torch.float64))
    loo = tinf.psis_loo(ws, pointwise)
    assert abs(loo.elpd_loo - exact) < 0.2, (loo.elpd_loo, exact)
    assert bool((loo.pareto_k < 0.7).all())
    assert 0.5 < loo.p_loo < 4.0
    assert abs(tinf.waic(ws, pointwise).elpd - loo.elpd_loo) < 0.3


def test_model_weights_stacking_matches_grid_oracle():
    rng = np.random.default_rng(0)
    n = 200
    e1 = rng.normal(-1.0, 0.8, size=n)
    e2 = np.where(rng.uniform(size=n) < 0.4, e1 + 1.2, e1 - 0.9)
    w = tinf.model_weights([e1, e2], method="stacking", device="cpu").numpy()
    assert w.shape == (2,)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-6)
    grid = np.linspace(1e-6, 1 - 1e-6, 20001)
    le = np.stack([e1, e2])
    mx = le.max(axis=0)
    p1, p2 = np.exp(le[0] - mx), np.exp(le[1] - mx)
    vals = np.array([np.sum(np.log(a * p1 + (1 - a) * p2)) for a in grid])
    assert abs(w[0] - grid[np.argmax(vals)]) < 1e-3


def test_model_weights_dominant_symmetric_pseudo_bma_and_validation():
    rng = np.random.default_rng(0)
    base = rng.normal(size=100)
    assert tinf.model_weights([base, base - 2.0], device="cpu").numpy()[0] > 0.99
    np.testing.assert_allclose(tinf.model_weights([base, base, base], device="cpu").numpy(), 1.0 / 3.0, atol=1e-6)
    e1 = rng.normal(-1.0, 0.1, size=50)
    e2 = e1 - 0.02
    w = tinf.model_weights([e1, e2], method="pseudo-bma", device="cpu").numpy()
    expect = np.exp([0.0, e2.sum() - e1.sum()])
    np.testing.assert_allclose(w, expect / expect.sum(), rtol=1e-6)
    wp = tinf.model_weights([e1, e2], method="pseudo-bma+", generator=torch.Generator().manual_seed(0),
                            device="cpu").numpy()
    np.testing.assert_allclose(wp.sum(), 1.0, atol=1e-6)
    assert 0.5 < wp[0] <= w[0] + 1e-9
    assert tinf.model_weights([rng.normal(size=10)], device="cpu").tolist() == [1.0]
    with pytest.raises(ValueError, match="non-finite"):
        tinf.model_weights([np.array([0.0, np.inf]), np.zeros(2)], device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tinf.model_weights([np.zeros(3), np.zeros(3)], method="bma", device="cpu")
