"""The port's summary tables, calculation report and simulation-based
calibration (``results/summary.py``, ``report.py``, ``sbc.py``) against
the JAX package, on the CPU in float64.

Parity tests put the same results through both packages: a port NS run and
Laplace fit carried into the JAX package by their result files
(``save_result``/``load_result``), weighted samples and chain stacks, at
rtol 1e-12; ``sbc_ranks``' host loop on the JAX study's own draws (each
replication's ``split(k, 3)`` into prior, data and fit keys): the same
ranks and truths, and the uniformity p-values at 1e-12.  Oracle tests hold
the port to ``tests/test_sbc.py``'s and the summary and report tests of
``tests/test_diagnostics.py`` and ``tests/test_results_direct.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.core.containers import WeightedSamples as JWS
from bayesianinference_tpu.engines import checkpoint as jck
from bayesianinference_tpu.results import report as jrep
from bayesianinference_tpu.results import sbc as jsbc
from bayesianinference_tpu_torch.core.containers import WeightedSamples
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import checkpoint as tck
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.results import calculation_report, sbc_ranks, sbc_uniformity_pvalues, summary

jsum = importlib.import_module("bayesianinference_tpu.results.summary")  # the package's summary() hides it
torch.set_num_threads(1)
RTOL = 1e-12
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _rows_close(got, want):
    assert got.quantile_levels == want.quantile_levels and len(got.rows) == len(want.rows)
    for a, b in zip(got.rows, want.rows):
        assert a.name == b.name
        close([a.mean, a.std, *a.quantiles], [b.mean, b.std, *b.quantiles])
        for f in ("ess", "r_hat"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None)
            if va is not None:
                close(va, vb)
    assert str(got) == str(want)


@pytest.fixture(scope="module")
def ns_pair(tmp_path_factory):
    """A port NS run of a 2-parameter regression, and the same result in
    the JAX package (through its result file)."""
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    rng = np.random.default_rng(0)
    x = np.linspace(-2, 2, 25)
    y = 1.5 * x + 0.5 + 0.3 * rng.normal(size=25)
    problem = define_inference_problem(
        parameters=[("a", -5.0, 5.0), ("b", -5.0, 5.0)],
        log_likelihood=lambda th: torch.sum(Normal(th[0] * T(x) + th[1], 0.3).log_prob(T(y))),
        prior_distribution=["location", "location"], validate=False, device="cpu", dtype=torch.float64)
    res = nested_sampling(problem, torch.Generator().manual_seed(0), sample_pool_size=50, max_iterations=500,
                          min_iterations=50, monte_carlo_steps=20)
    path = tmp_path_factory.mktemp("ns") / "ns.npz"
    tck.save_result(path, res)
    return res, jck.load_result(path)


def test_summary_of_ns_and_weighted_samples_matches_jax(ns_pair):
    res, jres = ns_pair
    _rows_close(summary(res), jsum.summary(jres))
    _rows_close(summary(res, param_names=("slope", "icept"), quantiles=(0.1, 0.9)),
                jsum.summary(jres, param_names=("slope", "icept"), quantiles=(0.1, 0.9)))
    rng = np.random.default_rng(1)
    pts, lw = rng.normal(size=(300, 3)), rng.normal(size=300)
    _rows_close(summary(WeightedSamples(points=T(pts), log_weights=T(lw))),
                jsum.summary(JWS(points=jnp.asarray(pts), log_weights=jnp.asarray(lw))))


def test_summary_of_chains_and_laplace_matches_jax(tmp_path):
    chains = np.random.default_rng(2).normal(1.0, 2.0, size=(4, 500, 2))
    _rows_close(summary(T(chains), param_names=("x", "y")), jsum.summary(chains, param_names=("x", "y")))
    _rows_close(summary(T(chains[..., 0])), jsum.summary(chains[..., 0]))
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit

    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)],
        log_likelihood=lambda th: torch.sum(Normal(th[0], 1.0).log_prob(T([0.2, 0.4, 0.3]))),
        log_prior=lambda th: torch.sum(Normal(0.0, 10.0).log_prob(th)), validate=False, device="cpu",
        dtype=torch.float64)
    fit = laplace_posterior_fit(problem=problem, generator=torch.Generator().manual_seed(0))
    tck.save_result(tmp_path / "fit.npz", fit)
    _rows_close(summary(fit), jsum.summary(jck.load_result(tmp_path / "fit.npz")))
    with pytest.raises(TypeError):
        summary(T(np.zeros(3)))


def test_calculation_report_matches_jax(ns_pair):
    res, jres = ns_pair
    got, want = calculation_report(res), jrep.calculation_report(jres)
    for f in ("skilling_log_x", "skilling_log_likelihood", "concentration_x", "concentration_enclosed_mass",
              "evidence_progression", "log_likelihood_progression", "acceptance_rates"):
        close(getattr(got, f), getattr(want, f))
    close(got.concentration_fit_coefficients, want.concentration_fit_coefficients)
    n = res.total_samples
    assert got.skilling_log_x.shape == (n,) and np.all(np.diff(got.evidence_progression) >= -1e-12)
    assert set(got.panels()) == {"Skilling's plot", "Posterior concentration", "Evidence", "LogLikelihood",
                                 "Acceptance rate"}


N_DATA, L = 8, 9  # tests/test_sbc.py


def _jax_study(key, n, scale=1.0):
    """The draws of ``tests/test_sbc.py``'s calibrated pipeline, per
    replication: (theta [1], data [N_DATA], posterior draws [L, 1])."""
    out = []
    for k in jax.random.split(key, n):
        k_th, k_data, k_fit = jax.random.split(k, 3)
        theta = jax.random.normal(k_th, (1,), F64)
        data = theta[0] + jax.random.normal(k_data, (N_DATA,), F64)
        draws = jnp.sum(data) / (N_DATA + 1.0) + scale / jnp.sqrt(N_DATA + 1.0) * jax.random.normal(
            k_fit, (L, 1), F64)
        out.append((np.asarray(theta), np.asarray(data), np.asarray(draws)))
    return out


def _replay(study):
    """Host-loop stages that hand out the JAX study's numbers in turn."""
    it = iter(study)
    state = {}

    def prior_sample(g):
        state["rep"] = next(it)
        return T(state["rep"][0])

    return dict(prior_sample=prior_sample, simulate=lambda g, th: T(state["rep"][1]),
                posterior_draws=lambda g, data: T(state["rep"][2]))


def test_sbc_host_loop_matches_jax_study():
    key = jax.random.PRNGKey(7)
    want = jsbc.sbc_ranks(key, prior_sample=lambda k: jax.random.normal(k, (1,), F64),
                          simulate=lambda k, th: th[0] + jax.random.normal(k, (N_DATA,), F64),
                          posterior_draws=lambda k, data: jnp.sum(data) / (N_DATA + 1.0) + 1.0 / jnp.sqrt(
                              N_DATA + 1.0) * jax.random.normal(k, (L, 1), F64),
                          num_replications=64)
    got = sbc_ranks(torch.Generator(), num_replications=64, **_replay(_jax_study(key, 64)))
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    close(got.thetas.numpy(), np.asarray(want.thetas))
    assert got.num_draws == want.num_draws == L and got.param_names == want.param_names
    for bins in (0, 4):
        close(got.uniformity_pvalues(bins).numpy(), np.asarray(want.uniformity_pvalues(bins)))
    edges, counts = got.histogram(0)
    we, wc = want.histogram(0)
    close(edges, we)
    np.testing.assert_array_equal(counts, wc)


# ---------------------------------------------------------------------------
# the JAX tests' oracles, on CPU tensors
# ---------------------------------------------------------------------------


def _prior_sample(g):
    return torch.randn((1,), generator=g, dtype=torch.float64)


def _simulate(g, theta):
    return theta[0] + torch.randn((N_DATA,), generator=g, dtype=torch.float64)


def _exact_posterior_draws(scale_factor):
    def draws(g, data):
        post_mean = torch.sum(data) / (N_DATA + 1.0)
        return post_mean + scale_factor / np.sqrt(N_DATA + 1.0) * torch.randn((L, 1), generator=g,
                                                                             dtype=torch.float64)

    return draws


@pytest.mark.parametrize("vectorized", [True, False])
def test_calibrated_pipeline_uniform_ranks(vectorized):
    res = sbc_ranks(torch.Generator().manual_seed(0), prior_sample=_prior_sample, simulate=_simulate,
                    posterior_draws=_exact_posterior_draws(1.0), num_replications=256, vectorized=vectorized,
                    param_names=("mu",))
    assert res.ranks.shape == (256, 1) and res.num_draws == L
    assert int(res.ranks.min()) >= 0 and int(res.ranks.max()) <= L
    p = res.uniformity_pvalues()
    assert p.shape == (1,) and float(p[0]) > 0.005


def test_underdispersed_pipeline_flagged_and_vectorized_reproducible():
    kw = dict(prior_sample=_prior_sample, simulate=_simulate, posterior_draws=_exact_posterior_draws(0.35),
              num_replications=256, vectorized=True)
    a = sbc_ranks(torch.Generator().manual_seed(0), **kw)
    assert float(a.uniformity_pvalues()[0]) < 1e-3
    b = sbc_ranks(torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a.ranks, b.ranks) and torch.equal(a.thetas, b.thetas)


def test_conjugate_engine_end_to_end():
    """The conjugate Normal engine is calibrated: theta = (mean, var) from
    the NIG prior, data from it, the fitted NIG posterior's draws ranked."""
    from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu_torch.engines.conjugate import normal_conjugate_model

    prior = NormalInverseGamma(mu0=0.5, lam=2.0, beta=1.5, nu=3.0)
    n = 10

    def prior_sample(g):
        return torch.stack(prior.sample(g))

    def simulate(g, theta):
        return theta[0] + torch.sqrt(theta[1]) * torch.randn((n,), generator=g, dtype=theta.dtype)

    def posterior_draws(g, data):
        m, v = normal_conjugate_model(data, prior=prior).posterior.sample(g, (L,))
        return torch.stack([m, v], dim=-1)

    res = sbc_ranks(torch.Generator().manual_seed(3), prior_sample=prior_sample, simulate=simulate,
                    posterior_draws=posterior_draws, num_replications=200, param_names=("mean", "var"))
    p = res.uniformity_pvalues()
    assert p.shape == (2,) and float(p.min()) > 0.005, p


def test_uniformity_pvalue_exact_uniform_and_matches_jax():
    ranks = torch.arange(10).repeat(30)[:, None]
    assert float(sbc_uniformity_pvalues(ranks, num_draws=9)[0]) > 0.999
    r = np.random.default_rng(0).integers(0, 10, size=(150, 3))
    close(sbc_uniformity_pvalues(T(r), 9).numpy(), np.asarray(jsbc.sbc_uniformity_pvalues(jnp.asarray(r), 9)))


def test_theta_from_draws_validation_and_histogram():
    with pytest.raises(ValueError):
        sbc_ranks(torch.Generator(), prior_sample=_prior_sample, simulate=_simulate,
                  posterior_draws=_exact_posterior_draws(1.0), num_replications=0)

    def draws_padded(g, data):
        d = _exact_posterior_draws(1.0)(g, data)
        return torch.cat([torch.zeros_like(d), d], dim=-1)

    res = sbc_ranks(torch.Generator().manual_seed(5), prior_sample=_prior_sample, simulate=_simulate,
                    posterior_draws=draws_padded, num_replications=64, vectorized=True,
                    theta_from_draws=lambda row: row[1:])
    assert res.ranks.shape == (64, 1) and float(res.uniformity_pvalues()[0]) > 0.005
    res = sbc_ranks(torch.Generator().manual_seed(2), prior_sample=_prior_sample, simulate=_simulate,
                    posterior_draws=_exact_posterior_draws(1.0), num_replications=80, vectorized=True)
    edges, counts = res.histogram(0)
    assert counts.sum() == 80


def test_summary_oracles(ns_pair):
    """tests/test_diagnostics.py's summary gates and the distinct-header
    regression of tests/test_review_regressions.py."""
    ws = WeightedSamples(points=T([[0.0], [1.0]]), log_weights=torch.log(T([0.25, 0.75])))
    row = summary(ws, param_names=("a",), quantiles=(0.2, 0.5, 0.9)).to_dict()["a"]
    assert row.mean == pytest.approx(0.75) and row.std == pytest.approx(np.sqrt(0.25 * 0.75))
    assert row.quantiles == (0.0, 1.0, 1.0) and row.ess == pytest.approx(1.0 / (0.25**2 + 0.75**2))
    chains = torch.as_tensor(np.random.default_rng(0).normal(1.0, 2.0, size=(4, 2000, 2)))
    for r in summary(chains, param_names=("x", "y")).rows:
        assert abs(r.mean - 1.0) < 0.15 and abs(r.std - 2.0) < 0.15 and r.r_hat < 1.02 and r.ess > 1000
        assert abs(r.quantiles[1] - 1.0) < 0.2
    res, _ = ns_pair
    a = summary(res).rows[0]
    assert a.name == "a" and abs(a.mean - 1.5) < 0.2 and a.ess > 10
    flat = WeightedSamples(points=torch.linspace(0, 1, 50, dtype=torch.float64)[:, None],
                           log_weights=torch.zeros(50, dtype=torch.float64))
    header = str(summary(flat, quantiles=(0.975, 0.98))).splitlines()[0]
    assert "q97.5" in header and "q98" in header


def test_report_evidence_progression_log_space():
    """The evidence progression survives |logZ| beyond float range."""
    from bayesianinference_tpu_torch.engines.evidence import evidence_sampling

    g = torch.Generator().manual_seed(0)
    n, nd = 10, 30
    logl = torch.sort(torch.randn(n + nd, generator=g, dtype=torch.float64)).values - 1000.0
    pts = torch.arange(n + nd, dtype=torch.float64)[:, None]
    res = evidence_sampling(points=pts, log_likelihoods=logl, sample_pool_size=n, generator=g, num_runs=20)
    rep = calculation_report(res)
    assert np.all(np.isfinite(rep.evidence_progression))
    np.testing.assert_allclose(rep.evidence_progression[-1], float(res.crude_log_evidence), atol=1e-6)
