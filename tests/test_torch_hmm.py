"""The port's hidden Markov models (``ops/hmm.py``, ``engines/hmm.py``)
against the JAX package, on the CPU in float64.

Deterministic functions (both forward methods, masked and not, the
smoother, Viterbi, the forecast) agree with JAX at rtol 1e-12 and with the
JAX tests' enumeration of all K^T paths; parallel against sequential at
T = 257 and on the long series of ``tests/test_hmm.py:164``.  The samplers
are fed JAX's Gumbel noise (``jax.random.categorical`` is argmax(logits +
gumbel)) and agree draw for draw; the port's own draws meet the FFBS path
frequency oracle.  The engine's Laplace fit runs ``method="parallel"``;
NS against Laplace (``tests/test_hmm.py:273``) is marked slow, as in JAX.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import hmm as jeng
from bayesianinference_tpu.ops import hmm as jh
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import hmm as teng
from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
from bayesianinference_tpu_torch.ops import hmm as th

torch.set_num_threads(1)

# the JAX functions run jitted: eager, each op of the associative scan's
# levels compiles on its own
j_filter = jax.jit(jh.hmm_filter, static_argnames="method")
j_smoother = jax.jit(jh.hmm_smoother, static_argnames="method")


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _enumerate(pi, a, b, mask=None):
    """Exact sums over all K^T paths (``tests/test_hmm.py``'s oracle): (ll,
    filtered, smoothed, MAP path, {path: posterior})."""
    t, k = b.shape
    if mask is not None:
        b = b * mask[:, None]
    joint = {}
    for path in itertools.product(range(k), repeat=t):
        lp = pi[path[0]] + b[0, path[0]]
        for s in range(1, t):
            lp += a[path[s - 1], path[s]] + b[s, path[s]]
        joint[path] = lp
    ll = np.logaddexp.reduce(np.array(list(joint.values())))
    post = {p: np.exp(lp - ll) for p, lp in joint.items()}
    smoothed = np.zeros((t, k))
    for p, w in post.items():
        for s in range(t):
            smoothed[s, p[s]] += w
    filtered = np.zeros((t, k))
    for s in range(t):
        scores = {}
        for prefix in itertools.product(range(k), repeat=s + 1):
            lp = pi[prefix[0]] + b[0, prefix[0]]
            for u in range(1, s + 1):
                lp += a[prefix[u - 1], prefix[u]] + b[u, prefix[u]]
            scores[prefix] = lp
        tot = np.logaddexp.reduce(np.array(list(scores.values())))
        for prefix, lp in scores.items():
            filtered[s, prefix[-1]] += np.exp(lp - tot)
    return ll, filtered, smoothed, np.array(max(joint, key=joint.get)), post


def _chain(seed, k, t, shift=0.0):
    rng = np.random.default_rng(seed)
    log_a = np.asarray(jh.row_stochastic(jnp.asarray(rng.normal(size=(k, k - 1)))))
    pi = np.log(rng.dirichlet(np.ones(k)))
    b = rng.normal(size=(t, k)) + shift
    return pi, log_a, b


def _pair(pi, log_a):
    return jh.HMM(jnp.asarray(pi), jnp.asarray(log_a)), th.HMM(T(pi), T(log_a))


def test_row_stochastic_matches_jax():
    logits = np.array([[0.3, -1.2], [2.0, 0.1], [0.0, 0.0]])
    la = th.row_stochastic(T(logits))
    close(la, jh.row_stochastic(jnp.asarray(logits)), atol=0)
    close(torch.exp(la).sum(-1), np.ones(3))


@pytest.mark.parametrize("masked", [False, True])
def test_small_chain_matches_enumeration_and_jax(masked):
    pi, log_a, b = _chain(0, 3, 6)
    mask = np.array([0, 1, 1, 0, 1, 1], bool) if masked else None
    ll, filtered, smoothed, best, _ = _enumerate(pi, log_a, b, None if mask is None else mask.astype(float))
    jm, tm = _pair(pi, log_a)
    for method in ("sequential", "parallel"):
        got = th.hmm_filter(tm, T(b), None if mask is None else T(mask), method)
        want = j_filter(jm, jnp.asarray(b), None if mask is None else jnp.asarray(mask), method)
        close(got.log_likelihood, ll)
        close(got.log_likelihood, want.log_likelihood)
        close(got.log_filtered, want.log_filtered)
        if not masked:
            close(torch.exp(got.log_filtered), filtered)
    if not masked:
        sm = th.hmm_smoother(tm, T(b))
        close(torch.exp(sm), smoothed)
        close(sm, jh.hmm_smoother(jm, jnp.asarray(b)))
        np.testing.assert_array_equal(th.hmm_viterbi(tm, T(b)).numpy(), best)


def test_parallel_equals_sequential_and_jax_at_odd_length():
    pi, log_a, b = _chain(4, 4, 257)
    jm, tm = _pair(pi, log_a)
    seq, par = th.hmm_filter(tm, T(b)), th.hmm_filter(tm, T(b), method="parallel")
    close(par.log_likelihood, seq.log_likelihood)
    close(par.log_filtered, seq.log_filtered, atol=1e-11)
    close(par.log_filtered, j_filter(jm, jnp.asarray(b), None, "parallel").log_filtered, atol=1e-12)
    close(th.hmm_smoother(tm, T(b), method="parallel"), j_smoother(jm, jnp.asarray(b), None, "parallel"),
          atol=1e-12)
    np.testing.assert_array_equal(th.hmm_viterbi(tm, T(b)).numpy(), np.asarray(jh.hmm_viterbi(jm, jnp.asarray(b))))


def test_parallel_long_series_stable():
    """``tests/test_hmm.py:164``: T = 4096 with emissions near -50."""
    pi, log_a, b = _chain(2, 4, 4096, shift=-50.0)
    tm = th.HMM(T(np.full(4, np.log(0.25))), T(log_a))
    ll_s = float(th.hmm_log_likelihood(tm, T(b)))
    ll_p = float(th.hmm_log_likelihood(tm, T(b), method="parallel"))
    assert np.isfinite(ll_s)
    np.testing.assert_allclose(ll_p, ll_s, rtol=1e-10)


def test_batched_chain_equals_each_chain():
    chains = [_chain(s, 3, 40) for s in range(3)]
    tm = th.HMM(T(np.stack([c[0] for c in chains])), T(np.stack([c[1] for c in chains])))
    b = T(np.stack([c[2] for c in chains]))
    for method in ("sequential", "parallel"):
        batch = th.hmm_filter(tm, b, method=method)
        for i, (pi, log_a, bb) in enumerate(chains):
            one = th.hmm_filter(th.HMM(T(pi), T(log_a)), T(bb), method=method)
            close(batch.log_likelihood[i], one.log_likelihood, rtol=1e-13)
            close(batch.log_filtered[i], one.log_filtered, atol=1e-13)
        shared = th.hmm_filter(tm, T(chains[0][2]), method=method)  # one series, three chains
        for i, (pi, log_a, _) in enumerate(chains):
            one = th.hmm_filter(th.HMM(T(pi), T(log_a)), T(chains[0][2]), method=method)
            close(shared.log_likelihood[i], one.log_likelihood, rtol=1e-13)


def _jax_ffbs_gumbels(key, num_draws, t, k):
    """The Gumbel noise of ``ops/hmm.py::hmm_posterior_sample`` from its key:
    [num_draws, T, K], row T-1 from kT, row t from split(krest, T-1)[t]."""
    out = []
    for kk in jax.random.split(key, num_draws):
        k_t, k_rest = jax.random.split(kk)
        rows = [jax.random.gumbel(kx, (k,), jnp.float64) for kx in jax.random.split(k_rest, t - 1)]
        out.append(np.stack([np.asarray(r) for r in rows] + [np.asarray(jax.random.gumbel(k_t, (k,), jnp.float64))]))
    return np.stack(out)


def test_ffbs_replays_jax_and_matches_the_path_posterior():
    pi, log_a = np.log([0.7, 0.3]), np.log([[0.8, 0.2], [0.4, 0.6]])
    b = np.random.default_rng(1).normal(size=(4, 2))
    jm, tm = _pair(pi, log_a)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jh.hmm_posterior_sample(key, jm, jnp.asarray(b), 64))
    got = th.hmm_posterior_sample(None, tm, T(b), 64, gumbels=T(_jax_ffbs_gumbels(key, 64, 4, 2)))
    np.testing.assert_array_equal(got.numpy(), want)
    *_, post = _enumerate(pi, log_a, b)
    draws = th.hmm_posterior_sample(torch.Generator().manual_seed(0), tm, T(b), 40000).numpy()
    for path, p_exact in post.items():
        assert abs(np.mean((draws == np.array(path)).all(axis=1)) - p_exact) < 0.012, path


def test_prior_states_replay_jax_and_hit_the_stationary_law():
    jm, tm = _pair(np.log([0.5, 0.5]), np.log([[0.9, 0.1], [0.3, 0.7]]))
    key = jax.random.PRNGKey(0)
    k0, k_rest = jax.random.split(key)
    g = [np.asarray(jax.random.gumbel(k0, (2,), jnp.float64))]
    g += [np.asarray(jax.random.gumbel(kx, (2,), jnp.float64)) for kx in jax.random.split(k_rest, 99)]
    got = th.hmm_sample_states(None, tm, 100, gumbels=T(np.stack(g)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jh.hmm_sample_states(key, jm, 100)))
    z = th.hmm_sample_states(torch.Generator().manual_seed(0), tm, 20000).numpy()
    assert abs(z.mean() - 0.25) < 0.03


# ---------------------------------------------------------------- engines

PARAMS = [("mu0", -6.0, 0.0), ("mu1", 0.0, 6.0), ("l01", -6.0, 6.0), ("l10", -6.0, 6.0)]


def _regime_data():
    rng = np.random.default_rng(3)
    z = np.zeros(300, int)
    for s in range(1, 300):
        z[s] = z[s - 1] if rng.random() < 0.92 else 1 - z[s - 1]
    return np.where(z == 0, -2.0, 2.0) + rng.normal(size=300), z


def _j_builder(y):
    def builder(theta):
        hmm = jh.HMM(jnp.log(jnp.asarray([0.5, 0.5], theta.dtype)),
                     jh.row_stochastic(jnp.stack([theta[2], theta[3]])[:, None]))
        mus = jnp.stack([theta[0], theta[1]])
        return hmm, -0.5 * (y[:, None] - mus[None, :]) ** 2 - 0.5 * jnp.log(2 * jnp.pi)

    return builder


def _t_builder(y):
    def builder(theta):
        hmm = th.HMM(torch.log(torch.tensor([0.5, 0.5], dtype=theta.dtype)),
                     th.row_stochastic(torch.stack([theta[2], theta[3]])[:, None]))
        mus = torch.stack([theta[0], theta[1]])
        return hmm, -0.5 * (y[:, None] - mus[None, :]) ** 2 - 0.5 * np.log(2 * np.pi)

    return builder


@pytest.fixture(scope="module")
def regime_problem():
    y, z = _regime_data()
    jp = jeng.define_hidden_markov_model(_j_builder(jnp.asarray(y)), parameters=PARAMS,
                                         prior_distribution=["location"] * 4, validate=False)
    tps = {m: teng.define_hidden_markov_model(_t_builder(T(y)), parameters=PARAMS, method=m,
                                              prior_distribution=["location"] * 4, validate=m == "parallel",
                                              device="cpu", dtype=torch.float64,
                                              generator=torch.Generator().manual_seed(0))
           for m in ("sequential", "parallel")}
    return jp, tps, z


def test_problem_likelihood_matches_jax_and_guards_nan(regime_problem):
    jp, tps, _ = regime_problem
    thetas = np.array([[-2.0, 2.0, -2.4, -2.4], [-1.5, 1.5, -2.0, -2.0], [-0.5, 0.5, 1.0, 3.0]])
    want = np.asarray(jax.jit(jax.vmap(jp.log_likelihood))(jnp.asarray(thetas)))
    bad = T([[np.nan, 2.0, 0.0, 0.0]])
    for tp in tps.values():
        close(tp.guarded_log_likelihood(T(thetas)), want, rtol=1e-12)
        close(tp.log_likelihood(T(thetas[1])), want[1])
        # NaN emissions: a finite raw value (sequential: the guarded
        # log-sum-exp drops them, as in JAX) or NaN (parallel); the guard
        # returns the sentinel either way
        assert bool(is_log_zero(tp.guarded_log_likelihood(bad)).all())
        assert bool(is_log_zero(tp.log_posterior_density(bad)).all())


def test_laplace_regimes_and_consumers(regime_problem):
    """The JAX tests' gates (``tests/test_hmm.py:236-269``) on the port's fit
    (parallel method); the consumers at a fixed theta against JAX."""
    jp, tps, z = regime_problem
    fit = laplace_posterior_fit(problem=tps["parallel"], initial_guess=T([[-1.0, 1.0, 1.0, 1.0]]))
    mu0, mu1, l01, _ = fit.mean.tolist()
    assert abs(mu0 + 2.0) < 0.4 and abs(mu1 - 2.0) < 0.4
    assert 0.8 < 1.0 / (1.0 + np.exp(-l01)) <= 0.99
    g = teng.regime_probabilities(tps["parallel"], fit.mean).numpy()
    assert g.shape == (300, 2) and np.mean((g[:, 1] > 0.5) == (z == 1)) > 0.9
    assert np.mean((teng.most_likely_states(tps["parallel"], fit.mean).numpy() == 1) == (z == 1)) > 0.9

    theta = np.array([-2.0, 2.0, 2.4, 2.4])
    for tp in tps.values():
        close(teng.regime_probabilities(tp, T(theta)), jeng.regime_probabilities(jp, jnp.asarray(theta)))
        np.testing.assert_array_equal(teng.most_likely_states(tp, T(theta)).numpy(),
                                      np.asarray(jeng.most_likely_states(jp, jnp.asarray(theta))))
        got = teng.forecast_regime_probabilities(tp, T(theta), 6).numpy()
        close(got, jeng.forecast_regime_probabilities(jp, jnp.asarray(theta), 6))
        hmm, log_obs = _t_builder(T(_regime_data()[0]))(T(theta))
        p = torch.exp(th.hmm_filter(hmm, log_obs).log_filtered[-1]).numpy()
        a = np.exp(hmm.transition_log_probs.numpy())
        close(got, np.stack([p @ np.linalg.matrix_power(a, h) for h in range(1, 7)]))


def test_sample_hidden_paths_replays_jax(regime_problem):
    jp, tps, z = regime_problem
    thetas = np.array([[-2.0, 2.0, 2.4, 2.4], [-1.9, 2.1, 2.2, 2.6], [-2.1, 1.9, 2.5, 2.3]])
    key = jax.random.PRNGKey(2)
    want = np.asarray(jax.jit(lambda k, t: jeng.sample_hidden_paths(jp, k, t, 5))(key, jnp.asarray(thetas)))
    gumbels = np.stack([_jax_ffbs_gumbels(k, 5, 300, 2) for k in jax.random.split(key, 3)])
    for tp in tps.values():
        got = teng.sample_hidden_paths(tp, None, T(thetas), 5, gumbels=T(gumbels))
        assert got.shape == (3, 5, 300)
        np.testing.assert_array_equal(got.numpy(), want)
    assert abs(float((want == 1).mean()) - (z == 1).mean()) < 0.15


@pytest.mark.slow
def test_ns_evidence_agrees_with_laplace(regime_problem):
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    _, tps, _ = regime_problem
    fit = laplace_posterior_fit(problem=tps["parallel"], generator=torch.Generator().manual_seed(0))
    # tests/test_hmm.py passes num_living_points=400 and seed_with_domain_points=False, which neither
    # package's nested_sampling takes (a TypeError there too): 400 live points are sample_pool_size here
    res = nested_sampling(tps["parallel"], torch.Generator().manual_seed(1), sample_pool_size=400)
    print(f"HMM regime problem on the CPU: NS logZ {float(res.log_evidence.mean):.4f} +- "
          f"{float(res.log_evidence.standard_error):.4f}, Laplace {float(fit.log_evidence):.4f} (tolerance 1.5); "
          f"{res.iterations} iterations, {res.num_likelihood_evals} likelihood evaluations")
    assert abs(float(res.log_evidence.mean) - float(fit.log_evidence)) < 1.5


def test_interop_carries_the_chain_and_its_filter():
    from bayesianinference_tpu_torch import interop

    pi, log_a, b = _chain(6, 3, 20)
    jm, tm = _pair(pi, log_a)
    model = interop.hmm_from_numpy(jm, device="cpu")
    assert isinstance(model, th.HMM)
    np.testing.assert_array_equal(model.transition_log_probs.numpy(), log_a)
    fr = interop.hmm_filter_result_from_numpy(j_filter(jm, jnp.asarray(b), None, "sequential"), device="cpu")
    for a, w in zip(fr, th.hmm_filter(model, T(b))):
        close(a, w)
