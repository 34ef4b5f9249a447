"""The port's Kalman filter and state-space engine (``ops/kalman.py``,
``engines/ssm.py``) against the JAX package, on the CPU in float64.

Deterministic functions (both filter methods, masked and not, the smoother,
the forecast, the components) agree with JAX at rtol 1e-12; parallel against
sequential at T = 257 (odd, not a power of two: a swapped combine would
show).  The samplers are fed the JAX key tree's normals
(``KalmanSampleDraws``): ``kalman_sample``, ``simulation_smoother`` and
``sample_state_paths`` then agree draw for draw (1e-10) where both LAPACKs'
``eigh`` give the same factor (diagonal noise with distinct entries, 1 x 1
noise); the dense-noise smoother is held to the JAX tests' dense
conditioning oracle.  The engine's Laplace fit runs ``method="parallel"``
(the sequential fit takes about 80 s here, the same mode) and is held to
the JAX test's gates; NS against Laplace (``tests/test_ssm.py:311``) is
marked slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

from bayesianinference_tpu.engines import ssm as jssm
from bayesianinference_tpu.ops import kalman as jk
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.engines import ssm as tssm
from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
from bayesianinference_tpu_torch.ops import kalman as tk

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


# the JAX functions run jitted: eager, each op of the associative scan's
# levels compiles on its own (about 40 s at T = 257, 5 s jitted)
j_filter = jax.jit(jk.kalman_filter, static_argnames="method")
j_smoother = jax.jit(jk.kalman_smoother, static_argnames="method")
j_sim = jax.jit(jk.simulation_smoother, static_argnames=("num_draws", "method"))
j_sample = jax.jit(jk.kalman_sample, static_argnames="num_steps")


def close(got, want, rtol=1e-12, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _random_arrays(seed=0, ds=3, do=2):
    rng = np.random.default_rng(seed)
    f = 0.6 * np.eye(ds) + 0.1 * rng.normal(size=(ds, ds))
    qh = rng.normal(size=(ds, ds))
    q = qh @ qh.T / ds + 0.3 * np.eye(ds)
    h = rng.normal(size=(do, ds))
    rh = rng.normal(size=(do, do))
    r = rh @ rh.T / do + 0.2 * np.eye(do)
    m0 = rng.normal(size=ds)
    p0h = rng.normal(size=(ds, ds))
    p0 = p0h @ p0h.T / ds + 0.5 * np.eye(ds)
    return f, q, h, r, m0, p0, 0.1 * rng.normal(size=ds), 0.2 * rng.normal(size=do)


def _pair(arrays):
    return jk.LGSSM(*(jnp.asarray(a) for a in arrays)), tk.LGSSM(*(T(a) for a in arrays))


@pytest.fixture(scope="module")
def random_model():
    jm, tm = _pair(_random_arrays())
    _, y = jk.kalman_sample(jax.random.PRNGKey(1), jm, 12)
    return jm, tm, np.asarray(y)


def _dense_moments(model, t_total):
    """Exact joint mean/cov of y_{1:T} (``tests/test_ssm.py``'s oracle)."""
    f, q, h, r = (np.asarray(x) for x in model[:4])
    c, d = (np.asarray(x) for x in model.offsets())
    ds = f.shape[0]
    mux = np.zeros((t_total, ds))
    mux[0] = np.asarray(model.initial_mean)
    for t in range(1, t_total):
        mux[t] = f @ mux[t - 1] + c
    sx = np.zeros((t_total, ds, t_total, ds))
    sx[0, :, 0, :] = np.asarray(model.initial_cov)
    for t in range(1, t_total):
        for s in range(t):
            sx[t, :, s, :] = f @ sx[t - 1, :, s, :]
            sx[s, :, t, :] = sx[t, :, s, :].T
        sx[t, :, t, :] = f @ sx[t - 1, :, t - 1, :] @ f.T + q
    hb = np.kron(np.eye(t_total), h)
    muy = (mux @ h.T + d).reshape(-1)
    sxf = sx.reshape(t_total * ds, t_total * ds)
    sy = hb @ sxf @ hb.T + np.kron(np.eye(t_total), r)
    return mux, sxf, muy, sy, hb


@pytest.mark.parametrize("t_total", [257])
@pytest.mark.parametrize("method", ["sequential", "parallel"])
@pytest.mark.parametrize("masked", [False, True])
def test_filter_matches_jax(t_total, method, masked):
    jm, tm = _pair(_random_arrays(seed=t_total))
    y = np.random.default_rng(t_total).normal(size=(t_total, 2))
    mask = None
    if masked:
        mask = np.ones(t_total, bool)
        mask[[3, 7, t_total - 1]] = False
    want = j_filter(jm, jnp.asarray(y), None if mask is None else jnp.asarray(mask), method)
    got = tk.kalman_filter(tm, T(y), None if mask is None else T(mask), method)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-12, atol=1e-12)


def test_parallel_equals_sequential_at_odd_length():
    _, tm = _pair(_random_arrays(seed=5))
    y = T(np.random.default_rng(5).normal(size=(257, 2)))
    seq, par = tk.kalman_filter(tm, y), tk.kalman_filter(tm, y, method="parallel")
    for s, p in zip(seq, par):
        close(p, s, rtol=1e-12, atol=1e-12)


def test_loglik_matches_dense_gaussian_and_masks(random_model):
    jm, tm, y = random_model
    _, _, muy, sy, _ = _dense_moments(jm, 12)
    mask = np.ones(12, bool)
    mask[[3, 7]] = False
    keep = np.repeat(mask, 2)
    full = multivariate_normal(mean=muy, cov=sy).logpdf(y.reshape(-1))
    part = multivariate_normal(mean=muy[keep], cov=sy[np.ix_(keep, keep)]).logpdf(y.reshape(-1)[keep])
    for method in ("sequential", "parallel"):
        close(tk.kalman_log_likelihood(tm, T(y), method=method), full, rtol=1e-10)
        close(tk.kalman_log_likelihood(tm, T(y), mask=T(mask), method=method), part, rtol=1e-10)


def test_batched_model_equals_each_model():
    arrays = [_random_arrays(seed=s) for s in range(3)]
    stacked = tk.LGSSM(*(T(np.stack(a)) for a in zip(*arrays)))
    y = np.random.default_rng(9).normal(size=(21, 2))
    for method in ("sequential", "parallel"):
        batch = tk.kalman_filter(stacked, T(y), method=method)
        for i, a in enumerate(arrays):
            one = tk.kalman_filter(tk.LGSSM(*(T(x) for x in a)), T(y), method=method)
            for b, o in zip(batch, one):
                close(b[i], o, rtol=1e-13, atol=1e-14)


def test_smoother_and_forecast_match_jax_and_dense_conditioning(random_model):
    jm, tm, y = random_model
    for method in ("sequential", "parallel"):
        got, want = tk.kalman_smoother(tm, T(y), method=method), j_smoother(jm, jnp.asarray(y), method=method)
        close(got.means, want.means)
        close(got.covs, want.covs)
    mux, sxf, muy, sy, hb = _dense_moments(jm, 12)
    sxy = sxf @ hb.T
    cond_mean = mux.reshape(-1) + sxy @ np.linalg.solve(sy, y.reshape(-1) - muy)
    cc = (sxf - sxy @ np.linalg.solve(sy, sxy.T)).reshape(12, 3, 12, 3)
    sm = tk.kalman_smoother(tm, T(y))
    close(sm.means.reshape(-1), cond_mean, rtol=0, atol=1e-9)
    close(sm.covs, np.stack([cc[i, :, i, :] for i in range(12)]), rtol=0, atol=1e-9)
    fm, fv = tk.kalman_forecast(tm, tk.kalman_filter(tm, T(y)), 4)
    jm_, jv_ = jk.kalman_forecast(jm, j_filter(jm, jnp.asarray(y)), 4)
    close(fm, jm_)
    close(fv, jv_)


def _jax_sample_draws(key, ds, do, t_total):
    """The normals of ``ops/kalman.py::kalman_sample`` from its key."""
    kx, ky, k0 = jax.random.split(key, 3)
    return (np.asarray(jax.random.normal(k0, (ds,), jnp.float64)),
            np.asarray(jax.random.normal(kx, (t_total, ds), jnp.float64)),
            np.asarray(jax.random.normal(ky, (t_total, do), jnp.float64)))


def _draws(per):
    """KalmanSampleDraws from nested lists of (initial, states, observations)."""
    def stack(rows, i):
        return np.stack([stack(r, i) for r in rows]) if isinstance(rows, list) else rows[i]

    return tk.KalmanSampleDraws(*(T(stack(per, i)) for i in range(3)))


def _diagonal_noise_pair():
    f, _, h, _, m0, _, c, d = _random_arrays(seed=3)
    q, r, p0 = np.diag([0.3, 0.7, 1.1]), np.diag([0.4, 0.9]), np.diag([2.0, 1.5, 0.5])
    return _pair((f, q, h, r, m0, p0, c, d))


def test_kalman_sample_and_simulation_smoother_replay_jax_draws():
    jm, tm = _diagonal_noise_pair()
    key = jax.random.PRNGKey(4)
    xs_j, ys_j = j_sample(key, jm, 30)
    draws = tk.KalmanSampleDraws(*(T(a) for a in _jax_sample_draws(key, 3, 2, 30)))
    xs_t, ys_t = tk.kalman_sample(None, tm, 30, draws)
    close(xs_t, xs_j, rtol=1e-10, atol=1e-12)
    close(ys_t, ys_j, rtol=1e-10, atol=1e-12)

    mask = np.ones(30, bool)
    mask[[2, 8]] = False
    for method in ("sequential", "parallel"):
        want = j_sim(jax.random.PRNGKey(5), jm, ys_j, 6, mask=jnp.asarray(mask), method=method)
        d = _draws([_jax_sample_draws(k, 3, 2, 30) for k in jax.random.split(jax.random.PRNGKey(5), 6)])
        got = tk.simulation_smoother(None, tm, ys_t, 6, mask=T(mask), method=method, draws=d)
        close(got, want, rtol=1e-10, atol=1e-10)


def test_simulation_smoother_joint_posterior(random_model):
    """Dense noise: held to dense conditioning (``tests/test_ssm.py:174``),
    cross-time covariance blocks included."""
    jm, tm, y = random_model
    mux, sxf, muy, sy, hb = _dense_moments(jm, 12)
    sxy = sxf @ hb.T
    cond_cov = sxf - sxy @ np.linalg.solve(sy, sxy.T)
    draws = tk.simulation_smoother(torch.Generator().manual_seed(3), tm, T(y), 4096).numpy().reshape(4096, -1)
    sm = tk.kalman_smoother(tm, T(y)).means.numpy().reshape(-1)
    np.testing.assert_allclose(draws.mean(0), sm, atol=0.2)
    scale = np.sqrt(np.outer(np.diag(cond_cov), np.diag(cond_cov)))
    np.testing.assert_allclose(np.cov(draws.T) / scale, cond_cov / scale, atol=0.12)


def test_structural_components_match_jax():
    t64 = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    j = jssm.structural_lgssm([jssm.trend_component(0.1, 0.01), jssm.seasonal_component(4, 0.05),
                               jssm.ar_component(jnp.asarray([0.5, -0.2]), 0.3),
                               jssm.ar_component(jnp.asarray(0.7), 0.2, initial_var=3.0)], obs_var=0.2)
    t = tssm.structural_lgssm([tssm.trend_component(t64(0.1), 0.01), tssm.seasonal_component(4, t64(0.05)),
                               tssm.ar_component(t64([0.5, -0.2]), 0.3),
                               tssm.ar_component(t64(0.7), 0.2, initial_var=3.0)], obs_var=0.2)
    assert t.state_dim == 2 + 3 + 2 + 1 and t.obs_dim == 1
    for a, b in zip(t, j):
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = np.random.default_rng(2).normal(size=30)
    close(tk.kalman_log_likelihood(t, T(y)), j_filter(j, jnp.asarray(y)).log_likelihood)


# ---------------------------------------------------------------- engine

PARAMS = [("level_var", 1e-4, 10.0), ("obs_var", 1e-4, 10.0)]


def _j_builder(th):
    return jssm.structural_lgssm([jssm.level_component(th[0])], obs_var=th[1])


def _t_builder(th):
    return tssm.structural_lgssm([tssm.level_component(th[0])], obs_var=th[1])


@pytest.fixture(scope="module")
def local_level():
    model = jssm.structural_lgssm([jssm.level_component(0.3)], obs_var=0.8)
    _, y = jk.kalman_sample(jax.random.PRNGKey(7), model, 400)
    y = np.asarray(y[:, 0])
    jp = jssm.define_state_space_model(jnp.asarray(y), _j_builder, parameters=PARAMS,
                                       prior_distribution=["scale", "scale"], validate=False)
    tps = {m: tssm.define_state_space_model(T(y), _t_builder, parameters=PARAMS, method=m,
                                            prior_distribution=["scale", "scale"], validate=m == "parallel",
                                            generator=torch.Generator().manual_seed(0))
           for m in ("sequential", "parallel")}
    return y, jp, tps


def test_problem_likelihood_matches_jax_and_guards_the_sentinel(local_level):
    _, jp, tps = local_level
    th = np.array([[0.3, 0.8], [0.1, 1.2], [1.0, 0.5], [3.0, 0.05]])
    want = np.asarray(jax.jit(jax.vmap(jp.log_likelihood))(jnp.asarray(th)))
    bad = T([[-1.0, 0.5], [0.5, -2.0]])  # negative variances: NaN innovations, outside the box
    for tp in tps.values():
        close(tp.guarded_log_likelihood(T(th)), want)
        close(tp.log_likelihood(T(th[0])), want[0])  # one theta [d] takes the batch path at B = 1
        assert bool(torch.isnan(tp.raw_log_likelihood(bad)).all())
        assert bool(is_log_zero(tp.guarded_log_likelihood(bad)).all())
        assert bool(is_log_zero(tp.log_posterior_density(bad)).all())


def test_laplace_recovers_the_variances_and_the_consumers_match_jax(local_level):
    """The JAX test's gates (``tests/test_ssm.py:268``) on the port's fit; the
    smoother and forecast at a theta near the mode against JAX."""
    y, jp, tps = local_level
    fit = laplace_posterior_fit(problem=tps["parallel"], initial_guess=T([[0.5, 0.5]]))
    lv, ov = fit.mean.tolist()
    assert 0.3 * 0.3 < lv < 3.0 * 0.3 and 0.5 * 0.8 < ov < 2.0 * 0.8
    assert np.isfinite(float(fit.log_evidence))
    theta = np.array([0.27, 0.75])
    jsm = jssm.smoothed_states(jp, jnp.asarray(theta))
    jm_, jv_ = jssm.forecast_observations(jp, jnp.asarray(theta), 5)
    for p in tps.values():
        sm = tssm.smoothed_states(p, T(theta))
        close(sm.means, jsm.means, rtol=1e-11, atol=1e-12)
        close(sm.covs, jsm.covs, rtol=1e-11, atol=1e-12)
        fm, fv = tssm.forecast_observations(p, T(theta), 5)
        close(fm, jm_, rtol=1e-11)
        close(fv, jv_, rtol=1e-11)
        assert float(fv[-1, 0, 0]) > float(fv[0, 0, 0])


def test_sample_state_paths_replays_jax_draws(local_level):
    y, jp, tps = local_level
    thetas = np.array([[0.3, 0.8], [0.2, 1.0], [0.5, 0.6]])
    key = jax.random.PRNGKey(2)
    want = jax.jit(lambda k, th: jssm.sample_state_paths(jp, k, th, 4))(key, jnp.asarray(thetas))
    draws = _draws([[_jax_sample_draws(k2, 1, 1, 400) for k2 in jax.random.split(k, 4)]
                    for k in jax.random.split(key, 3)])
    for p in tps.values():
        got = tssm.sample_state_paths(p, None, T(thetas), paths_per_theta=4, draws=draws)
        assert got.shape == (3, 4, 400, 1)
        close(got, want, rtol=1e-9, atol=1e-10)
    one = tssm.sample_state_paths(tps["parallel"], torch.Generator().manual_seed(3), T(thetas[0]), 64)
    sm = tssm.smoothed_states(tps["parallel"], T(thetas[0]))
    assert one.shape == (1, 64, 400, 1)
    mean_err = np.abs(one[0].mean(0).numpy() - sm.means.numpy()).mean()
    assert mean_err < 0.6 * float(np.sqrt(sm.covs.numpy()).mean())


@pytest.mark.slow
def test_ns_evidence_agrees_with_laplace(local_level):
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    _, _, tps = local_level
    tp = tps["parallel"]
    fit = laplace_posterior_fit(problem=tp, generator=torch.Generator().manual_seed(0))
    res = nested_sampling(tp, torch.Generator().manual_seed(1), sample_pool_size=200, monte_carlo_steps=60,
                          max_iterations=2000)
    lz = res.log_evidence
    assert abs(float(lz.mean) - float(fit.log_evidence)) < 4 * float(lz.standard_error) + 0.5


def test_interop_carries_the_model_and_results(random_model):
    from bayesianinference_tpu_torch import interop

    jm, tm, y = random_model
    model = interop.lgssm_from_numpy(jm, device="cpu")
    assert isinstance(model, tk.LGSSM)
    for a, b in zip(model, tm):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    no_offsets = interop.lgssm_from_numpy(jm._replace(transition_offset=None, observation_offset=None),
                                          device="cpu")
    assert no_offsets.transition_offset is None and no_offsets.observation_offset is None
    fr = interop.filter_result_from_numpy(j_filter(jm, jnp.asarray(y)), device="cpu")
    for a, b in zip(fr, tk.kalman_filter(model, T(y))):
        close(a, b)
    sm = interop.smoother_result_from_numpy(j_smoother(jm, jnp.asarray(y)), device="cpu")
    for a, b in zip(sm, tk.kalman_smoother(model, T(y))):
        close(a, b)
