"""Run-level parallel nested sampling in the port, on the CPU in float64.

* ``merge_runs`` against the JAX function on the same synthetic
  [R = 3, cap, d] buffers, without resampling: deterministic, rtol 1e-12;
  with k > 1 deletions per iteration the merge sums the runs' pool
  schedules, so one run merged is that run's own evidence (rtol 1e-14).
* The batched loop at R = 1 against ``nested_sampling_loop`` under one
  generator seed, for each chain kind: bit-equal states.
* ``run_chmc_chain`` with a [C, d, d] factor of equal rows against the
  shared [d, d] factor: bit-equal chains.
* A run that has ended keeps its state while the others go on.
* R = 4 runs of the 2-D oracle (the JAX tests' settings, half the runs),
  and four runs deleting a tenth of their pool per iteration, within 4
  standard errors of the analytic logZ.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.parallel import parallel_ns as jpar
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import nested_sampling as tns
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops import chmc as tchmc
from bayesianinference_tpu_torch.parallel import merge_runs, parallel_nested_sampling

torch.set_num_threads(1)
F64 = torch.float64


def _oracle(dim: int = 2):
    """A unit Gaussian likelihood under the uniform box [-5, 5]^dim."""
    problem = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(dim)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim,
        device="cpu", dtype=F64,
    )
    return problem, dim * (math.log(math.erf(5.0 / math.sqrt(2.0))) - math.log(10.0))


def _synthetic_runs(seed, r=3, cap=60, n=12, d=2):
    """R runs' padded dead buffers and live sets, logL increasing along
    each dead prefix, with one point duplicated across two runs."""
    rng = np.random.default_rng(seed)
    n_dead = np.array([48, 60, 36])[:r]
    dead_pts, dead_logl = rng.normal(size=(r, cap, d)), np.full((r, cap), -1e300)
    live_pts, live_logl = rng.normal(size=(r, n, d)), np.empty((r, n))
    for i in range(r):
        levels = np.sort(rng.normal(-8.0, 3.0, n_dead[i] + n))
        dead_logl[i, : n_dead[i]] = levels[: n_dead[i]]
        live_logl[i] = rng.permutation(levels[n_dead[i]:])
    dead_pts[1, 5], dead_logl[1, 5] = dead_pts[0, 3], dead_logl[0, 3]
    dead_logp = rng.normal(size=(r, cap))
    live_logp = rng.normal(size=(r, n))
    return dead_pts, dead_logl, dead_logp, n_dead, live_pts, live_logl, live_logp


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_runs_matches_jax(seed):
    arrays = _synthetic_runs(seed)
    n_live = arrays[4].shape[1]
    want = jpar.merge_runs(*(jnp.asarray(a) for a in arrays), total_pool=3 * n_live, key=None,
                           post_process_sampling_runs=None, param_names=("a", "b"))
    got = merge_runs(*(torch.as_tensor(a) for a in arrays), total_pool=3 * n_live,
                     post_process_sampling_runs=None, param_names=("a", "b"))
    assert got.total_samples == want.total_samples == arrays[3].sum() + 3 * n_live - 1
    assert got.sample_pool_size == want.sample_pool_size and got.param_names == ("a", "b")
    for f in ("points", "log_likelihoods", "log_priors", "crude_log_posterior_weights", "log_x",
              "crude_log_evidence", "log_likelihood_maximum", "log_estimated_missing_evidence",
              "crude_relative_entropy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-12, atol=1e-14,
                                   err_msg=f)
    np.testing.assert_allclose(got.parameter_expected_values.mean.numpy(),
                               np.asarray(want.parameter_expected_values.mean), rtol=1e-12)


def test_merge_of_one_run_with_batch_deletions_is_its_own_evidence():
    """One run that deleted k = 4 per iteration: the merge's pools are the
    run's own pool schedule, so its crude evidence is the single run's."""
    from bayesianinference_tpu_torch.engines.evidence import evidence_sampling
    from bayesianinference_tpu_torch.ops.ns_math import pool_schedule

    arrays = [torch.as_tensor(a[:1]) for a in _synthetic_runs(3)]
    n_live, nd = arrays[4].shape[1], int(arrays[3][0])
    merged = merge_runs(*arrays, total_pool=n_live, num_delete=4, post_process_sampling_runs=None)
    order = torch.argsort(arrays[5][0], stable=True)
    single = evidence_sampling(points=torch.cat([arrays[0][0, :nd], arrays[4][0][order]]),
                               log_likelihoods=torch.cat([arrays[1][0, :nd], arrays[5][0][order]]),
                               sample_pool_size=n_live, schedule=pool_schedule(n_live, 4, nd, dtype=F64),
                               num_runs=None)
    torch.testing.assert_close(merged.crude_log_evidence, single.crude_log_evidence, rtol=1e-14, atol=0)
    torch.testing.assert_close(merged.log_x, single.log_x, rtol=1e-14, atol=0)


def test_parallel_runs_with_batch_deletions_hit_the_oracle():
    """Four runs deleting a tenth of their pool per iteration: the merge
    sums the runs' pool schedules (a constant combined pool would place
    logZ high)."""
    problem, analytic = _oracle(2)
    res = parallel_nested_sampling(problem, torch.Generator().manual_seed(2), num_runs=4, sample_pool_size=100,
                                   num_delete=10, monte_carlo_steps=30, min_iterations=20)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    assert abs(logz - analytic) < 4 * err, (logz, analytic, err)


_LOOP_CASES = {
    "adaptive_metropolis": dict(dim=2, n_live=30, num_delete=5, monte_carlo_steps=12, min_iterations=6,
                                max_iterations=12),
    "slice": dict(dim=3, n_live=30, num_delete=6, monte_carlo_steps=8, min_iterations=4, max_iterations=8),
    "chmc": dict(dim=3, n_live=24, num_delete=6, monte_carlo_steps=16, min_iterations=3, max_iterations=5,
                 chmc_num_leapfrog=4),
}


@pytest.mark.parametrize("method", sorted(_LOOP_CASES))
def test_batched_loop_of_one_run_is_the_single_run_loop(method):
    case = dict(_LOOP_CASES[method])
    dim, n_live = case.pop("dim"), case.pop("n_live")
    problem, _ = _oracle(dim)
    starts = torch.rand((n_live, dim), generator=torch.Generator().manual_seed(2), dtype=F64) * 10 - 5
    single = tns.nested_sampling_loop(problem, starts, torch.Generator().manual_seed(9), monte_carlo_method=method,
                                      **case).state
    cfg = tns.make_loop_config(dim, gradient_check=problem.gradient_sanity, monte_carlo_method=method, **case)
    assert cfg.monte_carlo_method == method
    batch = tns.run_loop_batched(problem, tns._init_batch(problem, starts[None], cfg.capacity),
                                 torch.Generator().manual_seed(9), cfg, n_live=n_live)
    one = batch.state(0)
    assert one.n_dead == single.n_dead > 0 and one.iteration == single.iteration
    for f in ("live_points", "live_logl", "live_logp", "dead_points", "dead_logl", "dead_logp", "dead_acc",
              "mean_est", "cov_est", "log_z", "entropy", "log_missing", "num_likelihood_evals"):
        assert torch.equal(getattr(one, f), getattr(single, f)), f


def test_chmc_takes_one_factor_per_chain():
    chains, dim = 12, 4
    g = torch.Generator().manual_seed(4)
    x0 = torch.rand((chains, dim), generator=g, dtype=F64) - 0.5
    a = torch.randn((dim, dim), generator=g, dtype=F64) * 0.1
    chol = torch.linalg.cholesky(0.64 * torch.eye(dim, dtype=F64) + a @ a.T)
    draws = tchmc.chmc_draws(g, 5, chains, dim, dtype=F64)
    lower, upper = torch.full((dim,), -2.0, dtype=F64), torch.full((dim,), 2.0, dtype=F64)

    def like(x):
        return -0.5 * (x * x).sum(dim=-1)

    def prior(x):
        return -0.25 * ((x - 0.3) ** 2).sum(dim=-1)

    args = (like, prior, torch.full((chains,), -1.0, dtype=F64))
    shared = tchmc.run_chmc_chain(draws, x0, *args, chol, lower, upper, 6, 0.4)
    per_chain = tchmc.run_chmc_chain(draws, x0, *args, chol.expand(chains, dim, dim).clone(), lower, upper, 6, 0.4)
    for f in shared._fields:
        assert torch.equal(getattr(shared, f), getattr(per_chain, f)), f
    assert int(shared.accepted.sum()) > 0
    # a different factor for one chain changes that chain only
    chols = chol.expand(chains, dim, dim).clone()
    chols[3] = 0.5 * chol
    mixed = tchmc.run_chmc_chain(draws, x0, *args, chols, lower, upper, 6, 0.4)
    rest = torch.arange(chains) != 3
    assert torch.equal(mixed.x[rest], shared.x[rest]) and not torch.equal(mixed.x[3], shared.x[3])


def test_an_ended_run_keeps_its_state_while_the_others_go_on():
    """Three runs to termination (A), and the same three stopped by
    ``max_iterations`` where the first of them ended (B): the run that
    ended first is the same in both, bit for bit in its points and
    counters, although the others went on in A."""
    problem, _ = _oracle(2)
    n_live, k = 20, 4
    starts = torch.rand((3, n_live, 2), generator=torch.Generator().manual_seed(1), dtype=F64) * 10 - 5
    kw = dict(num_delete=k, monte_carlo_steps=10, min_iterations=5, monte_carlo_method="adaptive_metropolis")

    def run(max_iterations):
        cfg = tns.make_loop_config(2, max_iterations=max_iterations, **kw)
        b = tns._init_batch(problem, starts, cfg.capacity)
        return tns.run_loop_batched(problem, b, torch.Generator().manual_seed(3), cfg, n_live=n_live)

    a = run(400)
    first = int(np.argmin(a.iteration))
    assert max(a.iteration) > a.iteration[first] and max(a.iteration) <= 400
    b = run(a.iteration[first] - 1)
    assert b.iteration == [a.iteration[first]] * 3
    nd = a.n_dead[first]
    assert b.n_dead[first] == nd == (a.iteration[first] - 1) * k and max(a.n_dead) > nd
    for f in ("live_points", "live_logl", "live_logp", "mean_est", "cov_est", "num_likelihood_evals"):
        assert torch.equal(getattr(a, f)[first], getattr(b, f)[first]), f
    for f in ("dead_points", "dead_logl", "dead_logp", "dead_acc"):
        assert torch.equal(getattr(a, f)[first, :nd], getattr(b, f)[first, :nd]), f
    assert bool((a.dead_logl[first, nd:] == -1e300).all())
    # the crude logZ sums padded buffers of different lengths: equal to rounding
    torch.testing.assert_close(a.log_z[first], b.log_z[first], rtol=1e-13, atol=0)
    assert int(a.num_likelihood_evals.sum()) > int(b.num_likelihood_evals.sum())


def test_parallel_runs_hit_the_oracle():
    """The JAX test's run (tests/test_parallel.py: pool 25 per run, 60
    steps, min_iterations 30) with 4 runs instead of 8."""
    problem, analytic = _oracle(2)
    before = tns.run_loop_batched.host_reads
    res = parallel_nested_sampling(problem, torch.Generator().manual_seed(0), num_runs=4, sample_pool_size=25,
                                   max_iterations=800, min_iterations=30, monte_carlo_steps=60)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    assert res.sample_pool_size == 100 and 0 < err < 0.5
    assert abs(logz - analytic) < 4 * err, (logz, analytic, err)
    np.testing.assert_allclose(res.parameter_expected_values.mean.numpy(), [0.0, 0.0], atol=0.2)
    # one host read per iteration past min_iterations, for all four runs
    assert tns.run_loop_batched.host_reads - before <= res.iterations + 1 - 30
    # every evaluation counted once: per iteration and run, 60 proposals per chain and the new point's
    assert res.num_likelihood_evals % 61 == 0 and res.num_likelihood_evals >= 4 * 30 * 61
    assert res.generated_nested_samples == res.total_samples - 100


@pytest.mark.parametrize("kw", [dict(monte_carlo_method="slice", monte_carlo_steps=40, num_delete=5),
                                dict(monte_carlo_method="adaptive_metropolis", monte_carlo_steps=(7, 3, 21),
                                     min_iterations=300, termination_fraction=0.05),
                                dict(monte_carlo_method="chmc", monte_carlo_steps=64, chmc_step_size=0.3,
                                     chmc_num_leapfrog=8, max_iterations=50, log_likelihood_maximum=1.5)])
def test_loop_config_matches_jax_for_named_chains(kw):
    """With the chains named and the steps given, the port's resolved
    options are the JAX package's canonical ones."""
    from bayesianinference_tpu.engines.nested_sampling import make_loop_config as j_make_loop_config

    got, want = tns.make_loop_config(8, **kw), j_make_loop_config(**kw)
    for f in ("max_iterations", "min_iterations", "mc_steps", "termination_fraction", "num_delete",
              "min_max_acceptance_rate", "covariance_learn_delay", "log_likelihood_maximum", "monte_carlo_method",
              "chmc_step_size", "chmc_num_leapfrog"):
        assert getattr(got, f) == getattr(want, f), f


def test_loop_config_resolves_once():
    cfg = tns.make_loop_config(24, monte_carlo_steps=None, min_iterations=50, max_iterations=10)
    assert cfg.monte_carlo_method == "slice" and cfg.mc_steps == (200, 200, 1000)
    assert cfg.max_iterations == 50 and cfg.capacity == 50
    cfg = tns.make_loop_config(80, monte_carlo_method="chmc", num_delete=4)
    assert cfg.mc_steps[0] == 480 and cfg.capacity == 40000
    assert tns.make_loop_config(2, monte_carlo_steps=(3, 4, 5)).mc_steps == (3, 4, 5)
    with pytest.raises(ValueError):
        tns.make_loop_config(2, monte_carlo_method="nuts")
    problem, _ = _oracle(2)
    with pytest.raises(ValueError):
        parallel_nested_sampling(problem, torch.Generator(), num_runs=2, sample_pool_size=10, num_delete=10)
