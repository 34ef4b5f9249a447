"""The port's proper scores (``results/scoring.py``) against the JAX
package, on the CPU in float64.

Parity tests score one predictive in both packages (the JAX package's
``PointwiseMixture`` carried into the port by ``interop``), at rtol 1e-12:
the closed-form Gaussian-mixture CRPS (also over chunks of query points),
the ensemble CRPS on the same draws, the log score, PIT, the interval
coverage and width (quantiles by the shared bisection) and the
Dawid-Sebastiani score, for Normal and Student-t components.  Oracle tests
hold the port to ``tests/test_scoring.py``'s oracles, one counterpart each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.dists import pointwise as jpw
from bayesianinference_tpu.dists import scalar as jsc
from bayesianinference_tpu.results import scoring as js
from bayesianinference_tpu_torch.dists.pointwise import PointwiseMixture
from bayesianinference_tpu_torch.dists.scalar import Normal, StudentT
from bayesianinference_tpu_torch.interop import pointwise_mixture_from_numpy
from bayesianinference_tpu_torch.results import scoring as ts

torch.set_num_threads(1)
RTOL = 1e-12


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=1e-300):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _predictive(family, s=6, m=9, seed=0):
    """The same random S-component predictive at m points in both packages,
    and observations near it."""
    rng = np.random.default_rng(seed)
    params = dict(loc=rng.normal(size=(s, m)), scale=rng.uniform(0.3, 1.5, size=(s, m)))
    if family == "StudentT":
        params["df"] = rng.uniform(2.5, 30.0, size=(s, m))
    j = jpw.PointwiseMixture(log_weights=jnp.asarray(rng.normal(size=s)),
                             component=getattr(jsc, family)(**{k: jnp.asarray(v) for k, v in params.items()}))
    y = rng.normal(size=m) * 1.5
    return j, pointwise_mixture_from_numpy(j, device="cpu", dtype=torch.float64), y


FAMILIES = ["Normal", "StudentT"]


def test_closed_form_crps_matches_jax():
    j, t, y = _predictive("Normal")
    close(ts.crps(t, T(y)).numpy(), np.asarray(js.crps(j, jnp.asarray(y))))
    c = t.component
    close(ts.crps_gaussian_mixture(t.log_weights, c.loc, c.scale, y).numpy(),
          np.asarray(js.crps_gaussian_mixture(j.log_weights, j.component.loc, j.component.scale, jnp.asarray(y))))


def test_closed_form_crps_over_chunks_of_points_matches_jax(monkeypatch):
    j, t, y = _predictive("Normal", s=5, m=13)
    monkeypatch.setattr(ts, "CRPS_PAIR_ELEMENTS", 2 * 25)  # two points per chunk
    close(ts.crps(t, T(y)).numpy(), np.asarray(js.crps(j, jnp.asarray(y))))


def test_ensemble_crps_matches_jax_on_the_same_draws():
    rng = np.random.default_rng(1)
    samples, y = rng.normal(size=(300, 7)), rng.normal(size=7)
    close(ts.crps_ensemble(T(samples), T(y)).numpy(), np.asarray(js.crps_ensemble(jnp.asarray(samples), jnp.asarray(y))))


@pytest.mark.parametrize("family", FAMILIES)
def test_log_score_pit_and_dawid_sebastiani_match_jax(family):
    j, t, y = _predictive(family)
    close(ts.log_score(t, T(y)).numpy(), np.asarray(js.log_score(j, jnp.asarray(y))))
    close(ts.pit(t, T(y)).numpy(), np.asarray(js.pit(j, jnp.asarray(y))), atol=1e-16)
    close(ts.dawid_sebastiani_score(t, T(y)).numpy(), np.asarray(js.dawid_sebastiani_score(j, jnp.asarray(y))))


@pytest.mark.parametrize("family", FAMILIES)
def test_interval_coverage_matches_jax(family):
    j, t, y = _predictive(family, m=40, seed=3)
    got, want = ts.interval_coverage(t, T(y), levels=(0.5, 0.9)), js.interval_coverage(j, jnp.asarray(y))
    assert set(got) == set(want) == {0.5, 0.9}
    for level in got:
        assert float(got[level][0]) == float(want[level][0])
        close(float(got[level][1]), float(want[level][1]), atol=1e-13)


def test_observations_that_are_not_tensors_go_to_the_predictive():
    j, t, y = _predictive("Normal")
    for fn in (ts.log_score, ts.pit, ts.dawid_sebastiani_score, ts.crps):
        close(fn(t, y).numpy(), fn(t, T(y)).numpy(), rtol=0)


# tests/test_scoring.py's oracles


def _mixture(locs, scales, log_w=None):
    locs, scales = T(locs), T(scales)
    log_w = torch.zeros(locs.shape[0], dtype=torch.float64) if log_w is None else T(log_w)
    return PointwiseMixture(log_weights=log_w, component=Normal(locs, scales))


def test_single_gaussian_crps_matches_textbook():
    from scipy.stats import norm

    mu, s = 0.7, 1.3
    for y in (-1.0, 0.7, 2.5):
        z = (y - mu) / s
        ref = s * (z * (2 * norm.cdf(z) - 1) + 2 * norm.pdf(z) - 1 / np.sqrt(np.pi))
        got = float(ts.crps_gaussian_mixture(torch.zeros(1, dtype=torch.float64), T([[mu]]), T([[s]]), T([y]))[0])
        close(got, ref, rtol=1e-10)


def test_mixture_crps_matches_energy_estimator():
    rng = np.random.default_rng(0)
    mix = _mixture(rng.normal(size=(5, 3)), rng.uniform(0.3, 1.5, size=(5, 3)), rng.normal(size=5))
    y = T([0.3, -0.8, 1.1])
    draws = mix.sample(torch.Generator().manual_seed(1), (40_000,))
    close(ts.crps(mix, y).numpy(), ts.crps_ensemble(draws, y).numpy(), rtol=0, atol=0.01)


def test_point_mass_limit_is_absolute_error():
    got = ts.crps_gaussian_mixture(torch.zeros(1, dtype=torch.float64), T([[1.0, 1.0]]), T([[1e-9, 1e-9]]),
                                   T([0.0, 2.0]))
    close(got.numpy(), [1.0, 1.0], rtol=0, atol=1e-6)


def test_pit_uniform_and_coverage_calibrated():
    rng = np.random.default_rng(2)
    m = 4000
    mu, s = rng.normal(size=m), rng.uniform(0.5, 2.0, size=m)
    y = T(rng.normal(mu, s))
    mix = _mixture(mu[None, :], s[None, :])
    u = ts.pit(mix, y).numpy()
    assert np.all((u > 0) & (u < 1))
    assert abs(u.mean() - 0.5) < 0.02 and abs(u.var() - 1 / 12) < 0.01
    grid = np.linspace(0.05, 0.95, 19)
    assert np.max(np.abs(np.asarray([(u <= g).mean() for g in grid]) - grid)) < 0.03
    cov = ts.interval_coverage(mix, y, levels=(0.5, 0.9))
    assert abs(float(cov[0.5][0]) - 0.5) < 0.03 and abs(float(cov[0.9][0]) - 0.9) < 0.02
    assert float(cov[0.9][1]) > float(cov[0.5][1])


def test_scores_prefer_the_true_model():
    rng = np.random.default_rng(3)
    m = 1500
    y = T(rng.normal(0.0, 1.0, size=m))
    true, wrong = _mixture(np.zeros((1, m)), np.ones((1, m))), _mixture(np.full((1, m), 1.5), np.full((1, m), 0.4))
    for score in (ts.crps, ts.log_score, ts.dawid_sebastiani_score):
        assert float(score(true, y).mean()) < float(score(wrong, y).mean())


def test_sample_fallback_and_validation():
    mix = PointwiseMixture(log_weights=torch.zeros(2, dtype=torch.float64),
                           component=StudentT(df=torch.full((2, 3), 6.0, dtype=torch.float64),
                                              loc=torch.zeros((2, 3), dtype=torch.float64),
                                              scale=torch.ones((2, 3), dtype=torch.float64)))
    y = T([0.0, 0.5, -1.0])
    with pytest.raises(ValueError, match="generator"):
        ts.crps(mix, y)
    vals = ts.crps(mix, y, generator=torch.Generator().manual_seed(0), num_samples=4000)
    ref = ts.crps_gaussian_mixture(torch.zeros(1, dtype=torch.float64), torch.zeros((1, 3), dtype=torch.float64),
                                   torch.ones((1, 3), dtype=torch.float64), y)
    close(vals.numpy(), ref.numpy(), rtol=0, atol=0.12)


def test_student_t_mixture_sample_crps_matches_jax_estimator_on_the_same_draws():
    j, t, y = _predictive("StudentT", s=3, m=4)
    draws = np.asarray(j.sample(jax.random.PRNGKey(2), (500,)))
    close(ts.crps_ensemble(T(draws), T(y)).numpy(), np.asarray(js.crps_ensemble(jnp.asarray(draws), jnp.asarray(y))))
