"""The port's dynamic nested sampling against the JAX package, on the CPU in
float64: ``segment_from_run`` and ``merge_segments`` on fixed arrays
(rtol 1e-12; they are host-side sorts and counts), the deterministic part
of the variable-pool evidence post-processing (rtol 1e-10), and the whole
engine against the conjugate-normal closed form and the static run's
posterior effective sample size, as ``tests/test_dynamic_ns.py`` does.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu.engines import dynamic_ns as jdyn
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import dynamic_ns as tdyn
from bayesianinference_tpu_torch.engines import nested_sampling as tns
from bayesianinference_tpu_torch.engines.evidence import evidence_sampling
from bayesianinference_tpu_torch.interop import ns_segment_from_numpy, ns_state_from_numpy
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops.ns_math import pool_schedule

jns = importlib.import_module("bayesianinference_tpu.engines.nested_sampling")
torch.set_num_threads(1)


def _segment_fields(rng, n_live, k, batches, constraint, dim=2, shift=0.0):
    """A constant-pool segment as a toy NS process makes it: thresholds rise
    batch by batch, the tail is the sorted final live set."""
    live = np.sort(rng.uniform(0.0, 1.0, n_live)) + shift
    dead = []
    for _ in range(batches):
        thr = live[k - 1]
        dead.extend(live[:k])
        live = np.sort(np.concatenate([thr + rng.uniform(0.01, 1.0, k), live[k:]]))
    levels = np.concatenate([dead, live])
    n = levels.shape[0]
    return dict(points=rng.normal(size=(n, dim)), log_likelihoods=levels, log_priors=rng.normal(size=n),
                n_live=n_live, num_delete=k, n_dead=len(dead), constraint_logl=constraint,
                num_likelihood_evals=17 * n)


MERGES = {
    "one_run": [dict(n_live=20, k=1, batches=30, constraint=-np.inf)],
    "batched_deletion": [dict(n_live=24, k=4, batches=12, constraint=-np.inf)],
    "two_full_runs": [dict(n_live=16, k=2, batches=15, constraint=-np.inf),
                      dict(n_live=10, k=1, batches=25, constraint=-np.inf)],
    "base_and_batches": [dict(n_live=20, k=2, batches=25, constraint=-np.inf),
                         dict(n_live=12, k=3, batches=6, constraint=1.7, shift=1.7),
                         dict(n_live=8, k=1, batches=9, constraint=2.4, shift=2.4)],
}


@pytest.mark.parametrize("name", sorted(MERGES))
def test_merge_segments_matches_jax(name):
    rng = np.random.default_rng(len(name))
    fields = [_segment_fields(rng, s["n_live"], s["k"], s["batches"], s["constraint"], shift=s.get("shift", 0.0))
              for s in MERGES[name]]
    got = tdyn.merge_segments([ns_segment_from_numpy(f) for f in fields])
    want = jdyn.merge_segments([jdyn.NSSegment(**f) for f in fields])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    m = got[3]
    assert m.min() >= 1 and m[-1] == 1 and np.all(np.diff(got[1]) >= 0)
    if name == "batched_deletion":
        np.testing.assert_array_equal(m[:48], pool_schedule(24, 4, 48).numpy())
    if name == "two_full_runs":
        assert m[0] == m.max() == 26
    seg = ns_segment_from_numpy(fields[0])
    assert (seg.n_dead, seg.n_live, seg.num_likelihood_evals) == tuple(fields[0][f] for f in ("n_dead", "n_live", "num_likelihood_evals"))


def test_merge_segments_rejects_nothing_and_inconsistent_segments():
    with pytest.raises(ValueError):
        tdyn.merge_segments([])
    rng = np.random.default_rng(0)
    wrong = _segment_fields(rng, 10, 1, 5, constraint=50.0)  # born above every death: no pool at the first one
    with pytest.raises(AssertionError, match="non-positive pool size"):
        tdyn.merge_segments([ns_segment_from_numpy(wrong)])


def test_segment_from_run_matches_jax():
    """The same loop state through both packages' ``segment_from_run``."""
    rng = np.random.default_rng(3)
    n, k, cap, nd, d = 12, 3, 45, 27, 2
    dead_logl = np.sort(rng.normal(size=cap))
    arrays = dict(
        live_points=rng.normal(size=(n, d)), live_logl=rng.permutation(dead_logl[nd - 1] + rng.uniform(0.1, 2, n)),
        live_logp=rng.normal(size=n), dead_points=rng.normal(size=(cap, d)), dead_logl=dead_logl,
        dead_logp=rng.normal(size=cap), dead_acc=rng.uniform(size=cap), n_dead=np.asarray(nd, np.int32),
        iteration=np.asarray(10, np.int32), mean_est=np.zeros(d), cov_est=np.eye(d), log_z=np.asarray(-3.0),
        entropy=np.asarray(1.0), log_missing=np.asarray(-9.0),
        num_likelihood_evals=np.asarray([2, 77], np.int32), interrupted=np.asarray(False),
    )
    jstate = jns.NSState(key=jax.random.PRNGKey(0), **{f: jnp.asarray(v) for f, v in arrays.items()})
    want = jdyn.segment_from_run(jns.NSRunData(jstate, n, k, cap), constraint_logl=-0.5)
    state = ns_state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    got = tdyn.segment_from_run(tns.NSRunData(state, n, k, cap), constraint_logl=-0.5)
    for f in ("points", "log_likelihoods", "log_priors"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, atol=0)
    for f in ("n_live", "num_delete", "n_dead", "constraint_logl", "num_likelihood_evals"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.num_likelihood_evals == 2 * 2**30 + 77 and np.all(np.diff(got.log_likelihoods[nd:]) >= 0)


def test_merged_evidence_crude_part_matches_jax():
    rng = np.random.default_rng(5)
    fields = [_segment_fields(rng, 20, 2, 25, -np.inf), _segment_fields(rng, 12, 3, 6, 1.7, shift=1.7)]
    pts, logl, logp, m = tdyn.merge_segments([ns_segment_from_numpy(f) for f in fields])
    want = jdyn.merged_evidence_sampling(points=jnp.asarray(pts), log_likelihoods=jnp.asarray(logl),
                                         log_priors=jnp.asarray(logp), schedule=jnp.asarray(m), num_runs=0,
                                         sample_pool_size=20)
    got = tdyn.merged_evidence_sampling(points=pts, log_likelihoods=logl, log_priors=logp, schedule=m, num_runs=0,
                                        sample_pool_size=20, device="cpu")
    for f in ("points", "log_likelihoods", "log_priors", "crude_log_posterior_weights", "log_x",
              "crude_log_evidence", "log_likelihood_maximum", "log_estimated_missing_evidence",
              "crude_relative_entropy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.parameter_expected_values.mean.numpy(),
                               np.asarray(want.parameter_expected_values.mean), rtol=1e-10)
    assert got.total_samples == want.total_samples and bool(torch.isnan(got.log_evidence.standard_error))
    # the simulated part agrees in distribution
    sim = tdyn.merged_evidence_sampling(points=pts, log_likelihoods=logl, log_priors=logp, schedule=m, num_runs=200,
                                        generator=torch.Generator().manual_seed(0), device="cpu")
    jsim = jdyn.merged_evidence_sampling(points=jnp.asarray(pts), log_likelihoods=jnp.asarray(logl),
                                         log_priors=jnp.asarray(logp), schedule=jnp.asarray(m), num_runs=200,
                                         key=jax.random.PRNGKey(0))
    se = math.hypot(float(sim.log_evidence.standard_error), float(jsim.log_evidence.standard_error)) / math.sqrt(200)
    assert abs(float(sim.log_evidence.mean) - float(jsim.log_evidence.mean)) < 5 * se
    np.testing.assert_allclose(float(sim.log_evidence.standard_error), float(jsim.log_evidence.standard_error), rtol=0.3)
    if not torch.cuda.is_available():  # numpy arrays go to the card, and there is none
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdyn.merged_evidence_sampling(points=pts, log_likelihoods=logl, log_priors=logp, schedule=m)


# --- the whole engine on the conjugate normal (tests/test_dynamic_ns.py)

def _conjugate_problem(n_obs=40, seed=1, tau0=3.0):
    data = np.random.default_rng(seed).normal(1.2, 1.0, n_obs)
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: Normal(th[0], 1.0),
        data=torch.as_tensor(data), prior_distribution=[Normal(0.0, tau0)], validate=False)
    cov = tau0**2 * np.ones((n_obs, n_obs)) + np.eye(n_obs)
    post_prec = 1 / tau0**2 + n_obs
    return problem, st.multivariate_normal(np.zeros(n_obs), cov).logpdf(data), (data.sum() / post_prec, post_prec**-0.5)


K = 8  # deletions per iteration: an eighth of the iterations of the JAX tests' k = 1


def _ess(result) -> float:
    w = torch.exp(result.crude_log_posterior_weights)
    return float(1.0 / torch.sum(w * w))


@pytest.fixture(scope="module")
def conjugate():
    problem, log_z, post = _conjugate_problem()
    g = torch.Generator().manual_seed(1)
    run = tns.nested_sampling_loop(problem, tns.generate_starting_points(problem, g, 64), g, monte_carlo_steps=30,
                                   num_delete=K)
    return problem, log_z, post, run


def test_single_run_merge_reproduces_pool_schedule(conjugate):
    _, _, _, run = conjugate
    seg = tdyn.segment_from_run(run)
    _, logl, _, m = tdyn.merge_segments([seg])
    np.testing.assert_array_equal(m[: seg.n_dead], pool_schedule(64, K, seg.n_dead).numpy())
    np.testing.assert_array_equal(m[seg.n_dead:], np.arange(64, 0, -1))
    assert np.all(np.diff(logl) >= 0) and seg.num_likelihood_evals == (run.state.iteration - 1) * K * 31


def test_stop_at_log_likelihood_bounds_thresholds(conjugate):
    problem, _, _, run = conjugate
    stop = float(np.quantile(tdyn.segment_from_run(run).log_likelihoods, 0.5))
    g = torch.Generator().manual_seed(10)
    batch = tns.nested_sampling_loop(problem, tns.generate_starting_points(problem, g, 32), g, monte_carlo_steps=30,
                                     num_delete=4, min_iterations=1, stop_at_log_likelihood=stop, max_iterations=2000)
    nd = batch.state.n_dead
    dead = batch.state.dead_logl[:nd].numpy()
    # the thresholds stop within one deletion batch past the level
    assert nd < 8000 and dead[:-4].max() <= stop < float(batch.state.live_logl[3])


@pytest.mark.parametrize("method", ["adaptive_metropolis", "slice", "chmc"])
def test_dynamic_oracle_and_ess(conjugate, method):
    """logZ and the posterior moments against the closed form, for every
    chain kind (each also decorrelates the batches' seeds); posterior ESS
    above the static run's, the algorithm's reason to exist."""
    problem, log_z, (pm, ps), run = conjugate
    steps = {"adaptive_metropolis": 30, "slice": 6, "chmc": 32}[method]
    dyn = tdyn.dynamic_nested_sampling(problem, torch.Generator().manual_seed(12), sample_pool_size=64,
                                       num_batches=2, monte_carlo_steps=steps, monte_carlo_method=method, num_delete=K)
    se = float(dyn.log_evidence.standard_error)
    assert abs(float(dyn.log_evidence.mean) - log_z) < 3 * se + 0.05, (float(dyn.log_evidence.mean), log_z, se)
    w = torch.exp(dyn.crude_log_posterior_weights).numpy()
    x = dyn.points[:, 0].numpy()
    mean = float(w @ x)
    np.testing.assert_allclose(mean, pm, atol=0.05)
    np.testing.assert_allclose(float(np.sqrt(w @ (x - mean) ** 2)), ps, rtol=0.2)
    points, ll, lp, _, nd = run.finalize()
    static = evidence_sampling(points=points, log_likelihoods=ll, log_priors=lp, sample_pool_size=64,
                               schedule=pool_schedule(64, K, nd, dtype=torch.float64),
                               generator=torch.Generator().manual_seed(13), num_runs=20)
    assert _ess(dyn) > 1.5 * _ess(static), (_ess(dyn), _ess(static))
    assert dyn.num_likelihood_evals > 0 and dyn.iterations > run.state.iteration - 1 - 10
    assert dyn.total_samples > static.total_samples and dyn.sample_pool_size == 64


def test_dynamic_validation_and_ess_target(conjugate):
    problem, *_ = conjugate
    with pytest.raises(ValueError):
        tdyn.dynamic_nested_sampling(problem, posterior_fraction=1.5)
    with pytest.raises(ValueError):
        tdyn.dynamic_nested_sampling(problem, importance_fraction=1.0)
    # a target that the base run already meets adds no batch
    dyn = tdyn.dynamic_nested_sampling(problem, torch.Generator().manual_seed(20), sample_pool_size=64,
                                       num_batches=5, target_posterior_ess=1.0, monte_carlo_steps=30, num_delete=K)
    assert dyn.total_samples == dyn.iterations * K + 64
    # the evidence target puts its batch at the start of the run (the prior), not on the posterior bulk
    ev = tdyn.dynamic_nested_sampling(problem, torch.Generator().manual_seed(21), sample_pool_size=64,
                                      num_batches=1, posterior_fraction=0.0, monte_carlo_steps=30, num_delete=K)
    assert ev.total_samples > dyn.total_samples and math.isfinite(float(ev.log_evidence.mean))


@pytest.mark.slow
@pytest.mark.parametrize("steps,num_delete", [(50, 10), (200, 20)])
def test_dynamic_ns_is_unbiased_over_seeds(steps, num_delete):
    """Mean of (logZ - analytic) / sigma over ten seeds on the 2-D unit
    Gaussian in [-5, 5]^2 (pool 100, four batches).  Too few Metropolis
    steps per replacement leave seed correlation that lifts logZ: printed
    for both chain lengths (run with ``-s``), held to a mean below one
    sigma; the default length, 200 steps, is the one a run should use."""
    problem = define_inference_problem(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"], device="cpu", dtype=torch.float64)
    analytic = 2 * (math.log(math.erf(5 / math.sqrt(2))) - math.log(10))
    zs = []
    for seed in range(10):
        dyn = tdyn.dynamic_nested_sampling(problem, torch.Generator().manual_seed(seed), sample_pool_size=100,
                                           num_delete=num_delete, monte_carlo_steps=steps)
        zs.append((float(dyn.log_evidence.mean) - analytic) / float(dyn.log_evidence.standard_error))
    print(f"dynamic NS, {steps} steps, {num_delete} deletions: z over ten seeds {[round(z, 2) for z in zs]}, "
          f"mean {np.mean(zs):+.2f}")
    assert abs(np.mean(zs)) < 1.0
