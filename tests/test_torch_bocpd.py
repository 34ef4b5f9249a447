"""The port's changepoint detection (``ops/bocpd.py``,
``engines/changepoint.py``) against the JAX package, on the CPU in float64.

The run-length filter agrees with JAX at rtol 1e-12 (Gaussian and Poisson
UPMs, masked steps, a truncated buffer whose overflow slot absorbs mass) and
with the JAX tests' enumeration of all 2^(T-1) segmentations.  The engine's
batched likelihood (the filter under ``torch.func.vmap``), its run-length
posterior and its draw-averaged changepoint probability (out-of-support
draws dropped) agree with JAX; Laplace meets the JAX test's hazard gate.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln
from scipy.special import logsumexp as sp_logsumexp

from bayesianinference_tpu.engines import changepoint as jeng
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import changepoint as teng
from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit

# each package's ops namespace binds ``bocpd`` to the function
jb = importlib.import_module("bayesianinference_tpu.ops.bocpd")
tb = importlib.import_module("bayesianinference_tpu_torch.ops.bocpd")

torch.set_num_threads(1)

NIG = dict(mu0=0.3, kappa0=2.0, alpha0=1.5, beta0=0.8)
GAM = dict(alpha0=2.0, beta0=1.0)
j_bocpd = jax.jit(jb.bocpd, static_argnums=(1, 3))


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _nig_segment_logml(y, mu0, kappa0, alpha0, beta0):
    n = y.size
    if n == 0:
        return 0.0
    ybar = y.mean()
    kn, an = kappa0 + n, alpha0 + 0.5 * n
    bn = beta0 + 0.5 * np.sum((y - ybar) ** 2) + 0.5 * kappa0 * n * (ybar - mu0) ** 2 / kn
    return float(gammaln(an) - gammaln(alpha0) + alpha0 * np.log(beta0) - an * np.log(bn)
                 + 0.5 * (np.log(kappa0) - np.log(kn)) - 0.5 * n * np.log(2 * np.pi))


def _poisson_segment_logml(y, alpha0, beta0):
    n = y.size
    if n == 0:
        return 0.0
    s = y.sum()
    return float(-np.sum(gammaln(y + 1.0)) + gammaln(alpha0 + s) - gammaln(alpha0) + alpha0 * np.log(beta0)
                 - (alpha0 + s) * np.log(beta0 + n))


def _enumerate(y, h, segment_logml, mask=None):
    """Exact (log p(y), run-length posteriors [T, T]) over all changepoint
    configurations (``tests/test_bocpd.py``'s oracle)."""
    obs = np.ones(y.size, bool) if mask is None else mask
    rl = np.zeros((y.size, y.size))
    for t in range(1, y.size + 1):
        scores = {}
        for cfg in itertools.product([0, 1], repeat=t - 1):
            bounds = [0] + [s + 1 for s in range(t - 1) if cfg[s]] + [t]
            lp = sum(c * np.log(h) + (1 - c) * np.log1p(-h) for c in cfg)
            for a, b in zip(bounds[:-1], bounds[1:]):
                lp += segment_logml(y[a:b][obs[a:b]])
            scores[cfg] = lp
        tot = sp_logsumexp(np.array(list(scores.values())))
        for cfg, lp in scores.items():
            rl[t - 1, t - 1 - max([0] + [s + 1 for s in range(t - 1) if cfg[s]])] += np.exp(lp - tot)
    return tot, rl


@pytest.fixture(scope="module")
def small_series():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(0.0, 1.0, 4), rng.normal(3.0, 0.5, 4)])


@pytest.mark.parametrize("masked", [False, True])
def test_gaussian_filter_matches_enumeration_and_jax(small_series, masked):
    y, h = small_series, 0.15
    mask = None
    if masked:
        mask = np.ones(y.size, bool)
        mask[[2, 5]] = False
    ll, rl = _enumerate(y, h, lambda s: _nig_segment_logml(s, **NIG), mask)
    got = tb.bocpd(T(y), tb.gaussian_upm(**NIG), h, mask=None if mask is None else T(mask))
    want = jb.bocpd(jnp.asarray(y), jb.gaussian_upm(**NIG), h, mask=None if mask is None else jnp.asarray(mask))
    close(got.log_likelihood, ll)
    close(got.log_likelihood, want.log_likelihood)
    close(got.log_run_length, want.log_run_length)
    if not masked:
        close(torch.exp(got.log_run_length), rl)


def test_poisson_filter_matches_enumeration_and_jax():
    rng = np.random.default_rng(1)
    y = np.concatenate([rng.poisson(2.0, 4), rng.poisson(9.0, 4)]).astype(float)
    ll, rl = _enumerate(y, 0.1, lambda s: _poisson_segment_logml(s, **GAM))
    got = tb.bocpd(T(y), tb.poisson_upm(**GAM), 0.1)
    close(got.log_likelihood, ll)
    close(torch.exp(got.log_run_length), rl)
    close(got.log_run_length, jb.bocpd(jnp.asarray(y), jb.poisson_upm(**GAM), 0.1).log_run_length)


def test_truncated_buffer_matches_jax(small_series):
    """r_max = 5 < T: the overflow slot absorbs mass and adopts stats."""
    y = np.concatenate([small_series, np.random.default_rng(3).normal(1.0, 1.0, 40)])
    got = tb.bocpd(T(y), tb.gaussian_upm(**NIG), 0.15, r_max=5)
    want = j_bocpd(jnp.asarray(y), jb.gaussian_upm(**NIG), 0.15, 5)
    close(got.log_likelihood, want.log_likelihood)
    close(got.log_run_length, want.log_run_length)
    full = float(tb.bocpd(T(small_series), tb.gaussian_upm(**NIG), 0.15).log_likelihood)
    trunc = float(tb.bocpd(T(small_series), tb.gaussian_upm(**NIG), 0.15, r_max=5).log_likelihood)
    assert abs(trunc - full) < 0.05 * abs(full)


def test_detects_planted_mean_shift():
    rng = np.random.default_rng(2)
    y = np.concatenate([rng.normal(0, 1, 60), rng.normal(4, 1, 60)])
    cp = tb.changepoint_probabilities(tb.bocpd(T(y), tb.gaussian_upm(), hazard=0.02)).numpy()
    peak = int(np.argmax(cp[1:])) + 1
    assert 55 <= peak <= 65 and cp[peak] > 0.3 and cp[peak] > 20 * np.median(cp[1:])


# ---------------------------------------------------------------- engine

def _series():
    rng = np.random.default_rng(3)
    return np.concatenate([rng.normal(m, 1.0, 25) for m in rng.normal(0, 3, 8)])  # true hazard ~ 1/25


@pytest.fixture(scope="module")
def hazard_problem():
    y = _series()
    kw = dict(parameters=[("hazard", 1e-3, 0.5)], prior_distribution=["scale"], validate=False)
    jp = jeng.define_changepoint_model(y, lambda th: (jb.gaussian_upm(0.0, 0.2, 2.0, 2.0), th[0]), **kw)
    tp = teng.define_changepoint_model(T(y), lambda th: (tb.gaussian_upm(0.0, 0.2, 2.0, 2.0), th[0]), **kw)
    return jp, tp, y


def test_problem_likelihood_matches_jax_and_guards(hazard_problem):
    jp, tp, _ = hazard_problem
    th = np.array([[0.01], [0.04], [0.2]])
    want = np.asarray(jax.jit(jax.vmap(jp.log_likelihood))(jnp.asarray(th)))
    close(tp.guarded_log_likelihood(T(th)), want)
    bad = tp.guarded_log_likelihood(T([[np.nan], [-0.1], [1.5]]))
    assert not bool(torch.isnan(bad).any()) and bool(is_log_zero(bad).all())


def test_laplace_hazard_run_lengths_and_cp_probability(hazard_problem):
    jp, tp, y = hazard_problem
    fit = laplace_posterior_fit(problem=tp, initial_guess=T([[0.05]]))
    h = float(fit.mean[0])
    assert 0.01 < h < 0.15 and np.isfinite(float(fit.log_evidence))  # truth 0.04
    res = teng.run_length_posterior(tp, fit.mean)
    assert res.log_run_length.shape == (200, 200)
    close(torch.exp(res.log_run_length).sum(1), np.ones(200), rtol=1e-8)
    want = jeng.run_length_posterior(jp, jnp.asarray([0.04]))
    got = teng.run_length_posterior(tp, T([0.04]))
    close(got.log_likelihood, want.log_likelihood)
    close(got.log_run_length, want.log_run_length, atol=1e-10)

    draws = np.array([[0.04], [-0.01], [0.05], [0.03]])
    cp = teng.changepoint_probability(tp, T(draws)).numpy()
    close(cp, jeng.changepoint_probability(jp, jnp.asarray(draws)), rtol=1e-10)
    assert np.isfinite(cp).all()
    close(cp, teng.changepoint_probability(tp, T(draws[[0, 2, 3]])), rtol=1e-12)
    hits = [cp[k] for k in range(25, 200, 25)]
    assert np.mean(hits) > 5 * np.median(cp[2:])


def test_interop_carries_the_result(small_series):
    from bayesianinference_tpu_torch import interop

    res = interop.bocpd_result_from_numpy(jb.bocpd(jnp.asarray(small_series), jb.gaussian_upm(**NIG), 0.15),
                                          device="cpu")
    assert isinstance(res, tb.BOCPDResult)
    for a, w in zip(res, tb.bocpd(T(small_series), tb.gaussian_upm(**NIG), 0.15)):
        close(a, w)
