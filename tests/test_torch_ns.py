"""Parity of the port's nested-sampling bookkeeping and evidence resampling
with the JAX package, plus the headline NS problem against its analytic
evidence, on the CPU in float64.

Evidence post-processing is fed the JAX package's own Exponential draws,
regenerated from its key as ``engines/evidence.py`` splits it, so both
sides compute the same numbers: rtol 1e-10 (float64 sums over a few
thousand terms in a different order).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import evidence as jev
from bayesianinference_tpu.ops.ns_math import pool_schedule as j_pool_schedule
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import evidence as tev
from bayesianinference_tpu_torch.engines import nested_sampling as tns
from bayesianinference_tpu_torch.interop import ns_state_from_numpy, ns_state_to_numpy
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops.ns_math import pool_schedule

# the engines package re-exports a function of the same name as the module
jns = importlib.import_module("bayesianinference_tpu.engines.nested_sampling")
torch.set_num_threads(1)
RTOL = 1e-10


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _dead_live(cap, n_live, n_dead, d, seed):
    rng = np.random.default_rng(seed)
    dead_logl = np.sort(rng.normal(size=cap) * 3)
    dead_logl[n_dead:] = -1e300
    live_logl = np.sort(rng.normal(size=n_live) * 0.5 + dead_logl[n_dead - 1] + 1.0) if n_dead else \
        np.sort(rng.normal(size=n_live))
    return dead_logl, live_logl, rng.normal(size=(cap, d)), rng.normal(size=(n_live, d))


@pytest.mark.parametrize("n_dead", [0, 37, 120])
def test_crude_log_z_masked_matches_jax(n_dead):
    cap, n_live = 120, 30
    sched = j_pool_schedule(n_live, 5, cap)
    log_xd = np.asarray(-jnp.cumsum(1.0 / sched))
    dead_logl, live_logl, _, _ = _dead_live(cap, n_live, n_dead, 2, n_dead)
    got = tns.crude_log_z_masked(T(log_xd), n_dead, T(dead_logl), T(live_logl))
    want = jns._crude_log_z_masked(jnp.asarray(log_xd), n_dead, jnp.asarray(dead_logl), jnp.asarray(live_logl))
    for g, w in zip(got, want):
        close(g, w)


def test_simulated_evidence_matches_jax_on_jax_draws():
    n_live, k, n_del, runs, d = 25, 5, 140, 16, 2
    rng = np.random.default_rng(11)
    logl = np.sort(rng.normal(size=n_del + n_live) * 4)
    pts = rng.normal(size=(n_del + n_live, d))
    sched = j_pool_schedule(n_live, k, n_del)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    e_del = np.asarray(jax.random.exponential(k1, (runs, n_del), jnp.float64))
    e_live = np.asarray(jax.random.exponential(k2, (runs, n_live), jnp.float64))

    want_lx = jev._simulate_log_x(key, sched, n_live, runs)
    got_lx = tev.simulate_log_x(T(e_del), T(e_live), T(sched))
    close(got_lx, want_lx)

    want = jev._simulated_arrays(key, sched, jnp.asarray(logl), jnp.asarray(pts), n_live, runs)
    got = tev.simulated_arrays(got_lx, T(logl), T(pts))
    for g, w in zip(got, want[1:]):  # want[0] is the sampled logX again
        close(g, w, atol=1e-12)

    # the deterministic (crude) part of the whole post-processing
    jres = jev.evidence_sampling(points=jnp.asarray(pts), log_likelihoods=jnp.asarray(logl),
                                 sample_pool_size=n_live, schedule=sched, key=key, num_runs=runs)
    tres = tev.evidence_sampling(points=T(pts), log_likelihoods=T(logl), sample_pool_size=n_live,
                                 schedule=T(sched), generator=torch.Generator().manual_seed(0),
                                 num_runs=runs)
    for f in ("points", "log_likelihoods", "crude_log_posterior_weights", "log_x",
              "crude_log_evidence", "log_likelihood_maximum", "log_estimated_missing_evidence",
              "crude_relative_entropy"):
        close(getattr(tres, f), getattr(jres, f))
    # the simulated part agrees in distribution: logZ means within their errors
    dz = float(tres.log_evidence.mean) - float(jres.log_evidence.mean)
    assert abs(dz) < 4 * float(jres.log_evidence.standard_error) / math.sqrt(runs) * math.sqrt(2)


def test_padded_evidence_program_matches_jax_on_jax_draws():
    cap, n_live, n_dead, runs, d = 150, 20, 96, 12, 3
    dead_logl, live_logl, dead_pts, live_pts = _dead_live(cap, n_live, n_dead, d, 3)
    sched = j_pool_schedule(n_live, 4, cap)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    e_dead = np.asarray(jax.random.exponential(k1, (runs, cap), jnp.float64))
    e_live = np.asarray(jax.random.exponential(k2, (runs, n_live), jnp.float64))
    want = jev._padded_evidence_program(
        key, sched, jnp.asarray(dead_logl), jnp.asarray(live_logl), jnp.asarray(dead_pts),
        jnp.asarray(live_pts), jnp.asarray(n_dead, jnp.int32), n_live, runs)
    got = tev.padded_evidence_program(T(e_dead), T(e_live), T(sched), T(dead_logl), T(live_logl),
                                      T(dead_pts), T(live_pts), n_dead)
    for g, w in zip(got, want):
        close(g, w, atol=1e-12)


def test_combine_runs_dedups_and_merges():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(60, 2))
    logl = np.sort(rng.normal(size=60))
    a = tev.evidence_sampling(points=T(pts[:40]), log_likelihoods=T(logl[:40]), sample_pool_size=10,
                              generator=torch.Generator().manual_seed(0), num_runs=8)
    b = tev.evidence_sampling(points=T(pts[20:]), log_likelihoods=T(logl[20:]), sample_pool_size=10,
                              generator=torch.Generator().manual_seed(1), num_runs=8)
    merged = tev.combine_runs(a, b, generator=torch.Generator().manual_seed(2), num_runs=8)
    assert merged.total_samples == 60 and merged.sample_pool_size == 20
    jmerged = jev.evidence_sampling(points=jnp.asarray(pts), log_likelihoods=jnp.asarray(logl),
                                    sample_pool_size=20, num_runs=0)
    close(merged.crude_log_evidence, jmerged.crude_log_evidence)


def test_interop_round_trips_ns_state():
    rng = np.random.default_rng(6)
    n, cap, d = 12, 40, 3
    j_state = jns.NSState(
        key=jax.random.PRNGKey(0),
        live_points=jnp.asarray(rng.normal(size=(n, d))),
        live_logl=jnp.asarray(np.sort(rng.normal(size=n))),
        live_logp=jnp.asarray(rng.normal(size=n)),
        dead_points=jnp.asarray(rng.normal(size=(cap, d))),
        dead_logl=jnp.asarray(rng.normal(size=cap)),
        dead_logp=jnp.asarray(rng.normal(size=cap)),
        dead_acc=jnp.asarray(rng.uniform(size=cap)),
        n_dead=jnp.asarray(16, jnp.int32),
        iteration=jnp.asarray(5, jnp.int32),
        mean_est=jnp.asarray(rng.normal(size=d)),
        cov_est=jnp.asarray(np.eye(d) * 0.5),
        log_z=jnp.asarray(-3.2),
        entropy=jnp.asarray(1.1),
        log_missing=jnp.asarray(-7.0),
        num_likelihood_evals=jnp.asarray([3, 12345], jnp.int32),
        interrupted=jnp.asarray(False),
    )
    arrays = {f: np.asarray(getattr(j_state, f)) for f in j_state._fields if f != "key"}
    state = ns_state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert int(state.num_likelihood_evals) == jns.evals_to_int(j_state.num_likelihood_evals)
    assert state.n_dead == 16 and state.iteration == 5 and state.interrupted is False
    back = ns_state_to_numpy(state)
    for f, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[f]), a, err_msg=f)


def _headline_problem():
    return define_inference_problem(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        device="cpu", dtype=torch.float64,
    )


def test_headline_problem_hits_analytic_evidence():
    """bench.py's headline problem: a 2-D standard Gaussian under the
    uniform box [-5, 5]^2, logZ = -log 100; pool 200 must land within 3
    standard errors."""
    problem = _headline_problem()
    res = tns.nested_sampling(problem, torch.Generator().manual_seed(3), sample_pool_size=200,
                              num_delete=20, monte_carlo_steps=30, max_iterations=300)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    assert math.isfinite(logz) and 0 < err < 0.5
    assert abs(logz + math.log(100.0)) <= 3 * err
    assert res.iterations >= 100 and res.total_samples == res.generated_nested_samples + 200
    # acceptance rates: one per dead point, NaN for the live tail
    acc = res.acceptance_rates.numpy()
    assert np.isfinite(acc[: res.generated_nested_samples]).all() and np.isnan(acc[-200:]).all()
    mean = res.parameter_expected_values.mean.numpy()
    assert np.all(np.abs(mean) < 0.25)
    assert res.num_likelihood_evals == res.iterations * 20 * 31


def test_progress_callback_and_interrupt_are_per_iteration_calls():
    calls = []

    def progress(iteration, n_samples, log_z, entropy):
        calls.append((iteration, n_samples, log_z, entropy))

    run = tns.nested_sampling_loop(
        _headline_problem(),
        torch.rand((40, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64) * 10 - 5,
        torch.Generator().manual_seed(1),
        num_delete=4, monte_carlo_steps=5, min_iterations=20, max_iterations=50,
        progress_callback=progress, progress_interval=5,
        interrupt_check=lambda: len(calls) >= 3,
    )
    assert [c[0] for c in calls] == [5, 10, 15]
    assert [c[1] for c in calls] == [40 + 4 * i for i in (5, 10, 15)]
    assert all(isinstance(c[2], float) and math.isfinite(c[2]) for c in calls)
    assert run.state.interrupted and run.state.iteration == 16 and run.state.n_dead == 60


def test_policy_and_unported_options_raise():
    assert tns.resolve_monte_carlo_method("auto", 16) == "adaptive_metropolis"
    assert tns.default_monte_carlo_steps("adaptive_metropolis", 3) == jns.default_monte_carlo_steps(
        "adaptive_metropolis", 3)
    for method, dim in (("auto", 17), ("slice", 3), ("chmc", 3)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tns.resolve_monte_carlo_method(method, dim)
    with pytest.raises(ValueError):
        tns.resolve_monte_carlo_method("gibbs", 3)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        tns.nested_sampling(_headline_problem(), checkpoint_path="x", checkpoint_every=2)


def test_starting_points_without_sampleable_prior():
    """An improper prior falls back to an adaptive-Metropolis chain on the
    prior density seeded from truncated-Cauchy domain points."""
    problem = define_inference_problem(
        parameters=[("a", -2.0, 2.0)],
        log_likelihood=lambda th: -0.5 * torch.sum(th**2),
        device="cpu", dtype=torch.float64,
    )
    pts = tns.generate_starting_points(problem, torch.Generator().manual_seed(0), 20, burn_in=50, thinning=20)
    assert pts.shape == (20, 1)
    assert bool(((pts >= -2) & (pts <= 2)).all())
    assert len(torch.unique(pts)) > 10


def test_pool_schedule_matches_jax():
    close(pool_schedule(30, 7, 100, dtype=torch.float64), j_pool_schedule(30, 7, 100), rtol=0)
