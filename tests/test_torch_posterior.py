"""The port's posterior predictives (``results/posterior.py``) against the
JAX package, on the CPU in float64.

Parity tests put the same weighted draws through both packages (a
nested-sampling-like result of numpy arrays, and the draws of the port's
own NS, SMC, HMC and ensemble runs): the mixtures' densities, CDFs,
moments and quantiles at rtol 1e-12, in every mode; the posterior
predictive check on the JAX check's own picks and replicates.  Oracle
tests hold the port to ``tests/test_results_direct.py:98-358`` (the
predictive and report of an NS run, the vector-output regression
predictive against scipy, the predictive check's verdicts, the predictives
of SMC and HMC results and their ``ValueError``/``TypeError`` cases), one
counterpart each; and the GP predictive built by
``regression_predictive_distribution`` to ``predict_from_gaussian_process``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.core.containers import WeightedSamples as JWS
from bayesianinference_tpu.results import posterior as jp
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.core.containers import WeightedSamples
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.results import posterior as tp
from bayesianinference_tpu_torch.results import posterior_predictive_check

torch.set_num_threads(1)
RTOL = 1e-12
MODES = [None, "MaximumLikelihood", "MAP"]


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=1e-300):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _arrays(seed=0, s=12):
    rng = np.random.default_rng(seed)
    return dict(points=rng.normal(size=(s, 3)) * [0.5, 0.5, 0.1] + [1.0, -1.0, 1.0],
                crude_log_posterior_weights=rng.normal(size=s), log_likelihoods=rng.normal(size=s),
                log_priors=rng.normal(size=s))


def _results(arrays):
    """The same NS-like result for both packages (duck-typed as both take it)."""
    return (SimpleNamespace(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            SimpleNamespace(**{k: T(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("mode", MODES, ids=["weighted", "ML", "MAP"])
def test_predictive_distribution_matches_jax(mode):
    jr, tr = _results(_arrays())
    jpred = jp.predictive_distribution(jr, lambda th: jd.Normal(th[0], th[2]), mode=mode)
    tpred = tp.predictive_distribution(tr, lambda th: td.Normal(th[0], th[2]), mode=mode)
    x = np.linspace(-3, 4, 11)
    close(tpred.log_prob(T(x)).numpy(), np.asarray(jpred.log_prob(jnp.asarray(x))))
    close(tpred.cdf(T(x)).numpy(), np.asarray(jpred.cdf(jnp.asarray(x))), atol=1e-16)
    close(float(tpred.mean()), float(jpred.mean()))
    close(float(tpred.variance()), float(jpred.variance()))
    close(tpred.quantile(T([0.1, 0.5, 0.9])).numpy(), np.asarray(jpred.quantile(jnp.asarray([0.1, 0.5, 0.9]))),
          atol=1e-13)
    assert tpred.num_components == jpred.num_components


def test_predictive_with_a_constant_parameter_keeps_it():
    jr, tr = _results(_arrays())
    jpred = jp.predictive_distribution(jr, lambda th: jd.StudentT(5.0, th[0], 1.5 * th[2]))
    tpred = tp.predictive_distribution(tr, lambda th: td.StudentT(5.0, th[0], 1.5 * th[2]))
    assert tpred.component.df == 5.0 and tpred.component.loc.shape == (12,)
    x = np.linspace(-3, 4, 11)
    close(tpred.log_prob(T(x)).numpy(), np.asarray(jpred.log_prob(jnp.asarray(x))))
    close(tpred.cdf(T(x)).numpy(), np.asarray(jpred.cdf(jnp.asarray(x))), atol=1e-16)


@pytest.mark.parametrize("mode", MODES, ids=["weighted", "ML", "MAP"])
def test_regression_predictive_matches_jax(mode):
    jr, tr = _results(_arrays(1))
    xq = np.linspace(-1, 1, 5)
    jpred = jp.regression_predictive_distribution(jr, lambda th, x: jd.Normal(th[0] + th[1] * x[:, 0], th[2]), xq,
                                                  mode=mode)
    tpred = tp.regression_predictive_distribution(tr, lambda th, x: td.Normal(th[0] + th[1] * x[:, 0], th[2]), T(xq),
                                                  mode=mode)
    assert tpred.component.scale.shape == tuple(jpred.component.scale.shape)
    y = np.linspace(-2, 2, 5)
    close(tpred.log_prob(T(y)).numpy(), np.asarray(jpred.log_prob(jnp.asarray(y))))
    close(tpred.mean().numpy(), np.asarray(jpred.mean()))
    close(tpred.variance().numpy(), np.asarray(jpred.variance()))
    close(tpred.quantile(0.9).numpy(), np.asarray(jpred.quantile(0.9)), atol=1e-13)


def test_vector_output_regression_predictive_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    s, m = 6, 4
    arrays = dict(points=rng.normal(size=(s, 3)) * [0.5, 0.5, 0.1] + [1.0, -1.0, 1.0],
                  crude_log_posterior_weights=rng.normal(size=s), log_likelihoods=np.arange(s, dtype=float),
                  log_priors=np.zeros(s))
    jr, tr = _results(arrays)
    xq = np.linspace(-1.0, 1.0, m)[:, None]

    def builder(pkg, eye):
        return lambda th, xx: pkg.MultivariateNormal(
            pkg_stack(pkg)([th[0] * xx[:, 0], th[1] * xx[:, 0] ** 2]), th[2] ** 2 * eye)

    def pkg_stack(pkg):
        return (lambda cols: jnp.stack(cols, axis=-1)) if pkg is jd else (lambda cols: torch.stack(cols, dim=-1))

    jpred = jp.regression_predictive_distribution(jr, builder(jd, jnp.eye(2)), jnp.asarray(xq))
    tpred = tp.regression_predictive_distribution(tr, builder(td, torch.eye(2, dtype=torch.float64)), T(xq))
    assert tpred.event_shape == (2,) and tpred.num_points == m
    y = rng.normal(size=(m, 2))
    got_lp, got_mean = tpred.log_prob(T(y)).numpy(), tpred.mean().numpy()
    close(got_lp, np.asarray(jpred.log_prob(jnp.asarray(y))))
    close(got_mean, np.asarray(jpred.mean()))
    w = np.exp(arrays["crude_log_posterior_weights"] - np.logaddexp.reduce(arrays["crude_log_posterior_weights"]))
    th, x = arrays["points"], xq[:, 0]
    for j in range(m):
        dens = sum(w[k] * st.multivariate_normal.pdf(y[j], [th[k, 0] * x[j], th[k, 1] * x[j] ** 2],
                                                     th[k, 2] ** 2 * np.eye(2)) for k in range(s))
        close(got_lp[j], np.log(dens), rtol=1e-9)
    samp = tpred.sample(torch.Generator().manual_seed(0), (20000,))
    assert samp.shape == (20000, m, 2)
    close(samp.numpy().mean(axis=0), got_mean, rtol=0, atol=0.05)
    with pytest.raises(NotImplementedError):
        tpred.cdf(T(y))


def test_one_dimensional_inputs_are_points_of_one_input():
    _, tr = _results(_arrays(2))
    pred = tp.regression_predictive_distribution(tr, lambda th, x: td.Normal(th[0] * x[:, 0], th[2]), T([0.0, 0.5, 1.0]))
    assert pred.num_points == 3


def test_mode_errors_match_jax():
    arrays = _arrays(3)
    arrays["log_priors"] = np.full(12, np.nan)
    jr, tr = _results(arrays)
    for mod, res, pkg in ((jp, jr, jd), (tp, tr, td)):
        with pytest.raises(ValueError, match="NaN"):
            mod.predictive_distribution(res, lambda th: pkg.Normal(th[0], th[2]), mode="MAP")
        with pytest.raises(ValueError, match="unknown mode"):
            mod.predictive_distribution(res, lambda th: pkg.Normal(th[0], th[2]), mode="median")
    with pytest.raises(TypeError, match="posterior_samples"):
        tp.predictive_distribution(3.0, lambda th: td.Normal(th[0], th[1]))


def test_vi_and_pathfinder_results_need_their_draws_passed():
    from bayesianinference_tpu_torch.engines.pathfinder import PathfinderResult
    from bayesianinference_tpu_torch.engines.vi import VIResult

    z = torch.zeros(2, dtype=torch.float64)
    vi = VIResult(loc=z, scale_tril=torch.eye(2, dtype=torch.float64), elbo=z[0], elbo_history=z, lower=z - 1,
                  upper=z + 1)
    pool = WeightedSamples(points=torch.zeros((4, 2), dtype=torch.float64), log_weights=torch.zeros(4, dtype=torch.float64))
    pf = PathfinderResult(samples=pool, elbo_per_path=z, best_iteration=z.long(), log_evidence_is=z[0],
                          pareto_k=z[0], path_loc=z[None], lower=z - 1, upper=z + 1)
    for res in (vi, pf):
        with pytest.raises(TypeError, match="generator"):
            tp.predictive_distribution(res, lambda th: td.Normal(th[0], 1.0))
    pred = tp.predictive_distribution(vi.posterior_samples(torch.Generator().manual_seed(0), 50),
                                      lambda th: td.Normal(th[0], 1.0))
    assert pred.num_components == 50


# ---------------------------------------------------------------------------
# the engines' results
# ---------------------------------------------------------------------------

DATA = [0.4, 0.6, 0.5, 0.7]


def _problem():
    y = T(DATA)
    return define_inference_problem(
        parameters=[("mu", -5.0, 5.0), ("sigma", 0.1, 5.0)],
        log_likelihood=lambda th: torch.sum(td.Normal(th[0], th[1]).log_prob(y)),
        prior_distribution=["location", "scale"], validate=False, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def engine_results():
    from bayesianinference_tpu_torch.engines import ensemble_sample, hmc_sample, smc_sampler
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    problem = _problem()
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    return {
        "ns": nested_sampling(problem, g(0), sample_pool_size=60, monte_carlo_steps=20, max_iterations=300),
        "smc": smc_sampler(problem, g(1), n_particles=200, num_runs=2, mcmc_steps=8),
        "hmc": hmc_sample(problem, g(2), num_chains=4, num_samples=50, num_warmup=60, num_leapfrog=8),
        "ensemble": ensemble_sample(problem, g(3), num_walkers=16, num_samples=40, num_warmup=40),
    }


def _jax_twin(result):
    """The JAX-side object holding the same draws as a port result."""
    if hasattr(result, "crude_log_posterior_weights"):
        return SimpleNamespace(**{k: jnp.asarray(getattr(result, k).numpy()) for k in
                                  ("points", "crude_log_posterior_weights", "log_likelihoods", "log_priors")})
    ws = result.posterior_samples()
    ll = None if ws.log_likelihoods is None else jnp.asarray(ws.log_likelihoods.numpy())
    return JWS(points=jnp.asarray(ws.points.numpy()), log_weights=jnp.asarray(ws.log_weights.numpy()),
               log_likelihoods=ll)


@pytest.mark.parametrize("engine", ["ns", "smc", "hmc", "ensemble"])
def test_predictive_from_each_engines_result_matches_jax_on_its_draws(engine, engine_results):
    res = engine_results[engine]
    tpred = tp.predictive_distribution(res, lambda th: td.Normal(th[0], th[1]))
    jpred = jp.predictive_distribution(_jax_twin(res), lambda th: jd.Normal(th[0], th[1]))
    x = np.linspace(-1, 2, 7)
    close(tpred.log_prob(T(x)).numpy(), np.asarray(jpred.log_prob(jnp.asarray(x))))
    close(float(tpred.mean()), float(jpred.mean()))
    close(float(tpred.mean()), float(res.posterior_samples().mean()[0]), rtol=1e-9)
    for mode in ("MaximumLikelihood", "MAP"):
        ok = engine == "ns" or (engine == "smc" and mode == "MaximumLikelihood")
        if ok:
            t1 = tp.predictive_distribution(res, lambda th: td.Normal(th[0], th[1]), mode=mode)
            j1 = jp.predictive_distribution(_jax_twin(res), lambda th: jd.Normal(th[0], th[1]), mode=mode)
            assert t1.num_components == 1
            close(float(t1.mean()), float(j1.mean()))
        else:
            with pytest.raises(ValueError, match="log-likelihood" if mode == "MaximumLikelihood" else "MAP"):
                tp.predictive_distribution(res, lambda th: td.Normal(th[0], th[1]), mode=mode)


def test_predictive_and_regression_from_a_nested_sampling_run(engine_results):
    """tests/test_results_direct.py::test_predictive_and_report's predictive part."""
    res = engine_results["ns"]
    pred = tp.predictive_distribution(res, lambda th: td.Normal(th[0], th[1]))
    assert np.all(np.isfinite(pred.log_prob(T(np.linspace(-3, 4, 11))).numpy()))
    close(float(pred.mean()), float(res.posterior_samples().mean()[0]), rtol=0, atol=1e-9)
    rpred = tp.regression_predictive_distribution(res, lambda th, xx: td.Normal(th[0] + 0.0 * xx[:, 0], th[1]),
                                                  torch.linspace(-1, 1, 5, dtype=torch.float64)[:, None])
    assert rpred.mean().shape == (5,)


# ---------------------------------------------------------------------------
# posterior predictive check
# ---------------------------------------------------------------------------


def test_posterior_predictive_check_matches_jax_on_its_picks_and_replicates():
    arrays = _arrays(4, s=20)
    jr, tr = _results(arrays)
    data = np.random.default_rng(5).normal(1.0, 0.3, size=15)
    key, r = jax.random.PRNGKey(1), 300
    t_obs_j, t_rep_j, p_j = jp.posterior_predictive_check(jr, lambda th: jd.Normal(th[0], th[2]), jnp.asarray(data),
                                                          jnp.mean, key, num_replicates=r)
    k_pick, k_sim = jax.random.split(key)
    idx = jax.random.categorical(k_pick, jnp.asarray(arrays["crude_log_posterior_weights"]), shape=(r,))
    picked = jnp.asarray(arrays["points"])[idx]
    reps = jax.vmap(lambda k, th: jd.Normal(th[0], th[2]).sample(k, (15,)))(jax.random.split(k_sim, r), picked)
    t_obs, t_rep, p = posterior_predictive_check(tr, lambda th: td.Normal(th[0], th[2]), T(data),
                                                 lambda y: torch.mean(y), indices=torch.tensor(np.asarray(idx)),
                                                 replicates=T(reps))
    close(float(t_obs), float(t_obs_j))
    close(t_rep.numpy(), np.asarray(t_rep_j))
    close(float(p), float(p_j))


def test_posterior_predictive_check_never_picks_a_sample_of_log_weight_minus_inf():
    lw = torch.zeros(6, dtype=torch.float64)
    lw[[1, 4]] = -torch.inf
    ws = WeightedSamples(points=T(np.arange(6.0)[:, None]), log_weights=lw)
    _, t_rep, _ = posterior_predictive_check(ws, lambda th: td.Normal(th[0], 1e-9), T(np.zeros(3)),
                                             lambda y: torch.mean(y), torch.Generator().manual_seed(0),
                                             num_replicates=2000)
    picked = torch.round(t_rep)
    assert not bool(((picked == 1) | (picked == 4)).any()) and set(picked.tolist()) == {0.0, 2.0, 3.0, 5.0}
    with pytest.raises(ValueError, match="generator"):
        posterior_predictive_check(ws, lambda th: td.Normal(th[0], 1.0), T(np.zeros(3)), torch.mean)


def test_posterior_predictive_check_verdicts():
    """tests/test_results_direct.py::test_posterior_predictive_check: a
    central p-value where the model holds, p < 0.01 for the variance of
    overdispersed data under a fixed-variance model."""
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    rng = np.random.default_rng(0)

    def fit(data):
        d = T(data)
        problem = define_inference_problem(parameters=[("mu", -5.0, 5.0)],
                                           log_likelihood=lambda th: torch.sum(td.Normal(th[0], 1.0).log_prob(d)),
                                           prior_distribution=["location"], validate=False, device="cpu",
                                           dtype=torch.float64)
        return nested_sampling(problem, torch.Generator().manual_seed(0), sample_pool_size=80, max_iterations=600,
                               monte_carlo_steps=20, post_process_sampling_runs=8)

    builder = lambda th: td.Normal(th[0], 1.0)  # noqa: E731
    good = rng.normal(1.2, 1.0, size=40)
    _, t_rep, p = posterior_predictive_check(fit(good), builder, T(good), torch.mean, torch.Generator().manual_seed(1),
                                             num_replicates=400)
    assert t_rep.shape == (400,) and 0.05 < float(p) < 0.95
    bad = rng.normal(0.7, 2.5, size=60)
    _, _, p2 = posterior_predictive_check(fit(bad), builder, T(bad), lambda y: torch.var(y, correction=0),
                                          torch.Generator().manual_seed(2), num_replicates=400)
    assert float(p2) < 0.01, float(p2)


# ---------------------------------------------------------------------------
# the GP predictive by both routes
# ---------------------------------------------------------------------------


def test_regression_predictive_of_the_gp_moments_is_predict_from_gaussian_process():
    from bayesianinference_tpu_torch.engines.gp import define_gaussian_process, predict_from_gaussian_process
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    rng = np.random.default_rng(6)
    x, y = rng.normal(size=(40, 2)), rng.normal(size=40)
    problem = define_gaussian_process(T(x), T(y), kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
                                      nugget_builder=lambda th: th[2] ** 2,
                                      parameters=[("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)])
    model = problem.metadata["gaussian_process"]
    draws = WeightedSamples(points=T(np.abs(rng.normal(1.0, 0.2, size=(30, 3))) * [1, 1, 0.2]),
                            log_weights=T(rng.normal(size=30)))
    xq = T(rng.normal(size=(11, 2)))
    want = predict_from_gaussian_process(draws, problem, xq, max_samples=None)
    got = tp.regression_predictive_distribution(
        draws, lambda th, xx: td.Normal(*(lambda m, s: (m, torch.clamp(s, min=1e-12)))(*model.posterior_moments(th, xx))),
        xq)
    close(got.mean().numpy(), want.mean().numpy(), rtol=1e-10)
    close(got.variance().numpy(), want.variance().numpy(), rtol=1e-10)
