"""The port's parallel dynamic NS (``parallel/parallel_dynamic_ns.py``)
against the JAX function, and ``mesh=`` in the run-level parallel engines
(parallel NS split over two device groups against its oracle), on the CPU
in float64.

* ``_segments_from_batch`` against JAX's ``_segments_from_stacked`` on the
  same run arrays (those of the port's own base run and first stage, R = 3
  runs each), and the stage's merge and interval against JAX's
  ``merge_segments`` and ``_stage_interval`` on those segments: 1e-12.
* The JAX oracle (``tests/test_parallel_dynamic_ibis.py``: the Normal mean,
  pool 48, ``num_batches=8`` with ``num_runs=8``, one stage) and its
  ``num_delete`` check.
* With R = 1 the engine is ``dynamic_nested_sampling`` draw for draw on
  one generator, whose base run is ``nested_sampling_loop``'s.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp as sp_lse
from scipy.stats import norm

from bayesianinference_tpu.engines import dynamic_ns as jdns
from bayesianinference_tpu.engines.nested_sampling import _EVAL_BASE
from bayesianinference_tpu.parallel.parallel_dynamic_ns import _segments_from_stacked
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch import parallel
from bayesianinference_tpu_torch.engines import dynamic_ns as tdns
from bayesianinference_tpu_torch.engines.nested_sampling import (_init_batch, make_loop_config, nested_sampling_loop,
                                                                 run_loop_batched)
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.engines.dynamic_ns import _segments_from_batch

torch.set_num_threads(1)
SIGMA, TAU = 1.0, 2.0
DATA = np.random.default_rng(3).normal(0.8, 1.0, size=40)  # tests/test_parallel_dynamic_ibis.py's data


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def normal_mean():
    y = T(DATA)
    problem = define_inference_problem(parameters=[("mu", -10.0, 10.0)],
                                       log_likelihood=lambda th: td.Normal(th[0], SIGMA).log_prob(y).sum(),
                                       prior_distribution=td.Product((td.Normal(T(0.0), T(TAU)),)), validate=False,
                                       device="cpu", dtype=torch.float64)
    post_var = 1.0 / (1.0 / TAU**2 + DATA.size / SIGMA**2)
    grid = np.linspace(-10, 10, 4001)
    ll = norm.logpdf(DATA[None, :], loc=grid[:, None], scale=SIGMA).sum(1)
    log_z = float(sp_lse(ll + norm.logpdf(grid, scale=TAU)) + np.log(grid[1] - grid[0]))
    return problem, post_var * DATA.sum() / SIGMA**2, post_var, log_z


def _stacked(b):
    """A batch state as the JAX program's stacked outputs (its evaluation
    counter a (hi, lo) pair in base ``_EVAL_BASE``)."""
    host = lambda t: t.detach().numpy()  # noqa: E731
    evals = host(b.num_likelihood_evals)
    counter = np.stack([evals // _EVAL_BASE, evals % _EVAL_BASE], axis=-1)
    return (host(b.dead_points), host(b.dead_logl), host(b.dead_logp), np.asarray(b.n_dead), host(b.live_points),
            host(b.live_logl), host(b.live_logp), counter, np.asarray(b.iteration))


def _same_segments(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("points", "log_likelihoods", "log_priors"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        for f in ("n_live", "num_delete", "n_dead", "constraint_logl", "num_likelihood_evals"):
            assert getattr(g, f) == getattr(w, f), f


def test_segments_and_stage_merge_match_jax(normal_mean):
    problem = normal_mean[0]
    g = torch.Generator().manual_seed(0)
    runs, pool, batch, k = 3, 12, 10, 2
    cfg = make_loop_config(1, max_iterations=15, min_iterations=15, monte_carlo_steps=20, num_delete=k)
    starts = torch.stack([tdns.generate_starting_points(problem, g, pool) for _ in range(runs)])
    base = run_loop_batched(problem, _init_batch(problem, starts, cfg.capacity), g, cfg, n_live=pool)
    got = _segments_from_batch(base, pool, k, -math.inf)
    want = _segments_from_stacked(_stacked(base), pool, k, -np.inf)
    _same_segments(got, want)

    kw = dict(posterior_fraction=0.7, importance_fraction=0.8, target_posterior_ess=None)
    lo, hi, pts, logl = tdns._stage_interval(got, device="cpu", **kw)
    j_lo, j_hi, _, _ = jdns._stage_interval(want, **kw)
    close([lo, hi], [j_lo, j_hi])
    seeds, _ = tdns._stage_seeds(problem, g, pts, logl, lo, runs * batch, num_delete=k, monte_carlo_steps=20,
                                 method="adaptive_metropolis")
    stage_cfg = make_loop_config(1, max_iterations=50, min_iterations=1, monte_carlo_steps=20, num_delete=k)
    stage = run_loop_batched(problem, _init_batch(problem, seeds.reshape(runs, batch, 1), stage_cfg.capacity), g,
                             stage_cfg, n_live=batch, stop_at_log_likelihood=hi)
    got += _segments_from_batch(stage, batch, k, lo)
    want += _segments_from_stacked(_stacked(stage), batch, k, lo)
    _same_segments(got, want)
    for a, b in zip(tdns.merge_segments(got), jdns.merge_segments(want)):
        close(a, b)
    t = tdns.merged_evidence_sampling(*(), **dict(zip(("points", "log_likelihoods", "log_priors", "schedule"),
                                                      tdns.merge_segments(got))), num_runs=None, device="cpu")
    j = jdns.merged_evidence_sampling(**dict(zip(("points", "log_likelihoods", "log_priors", "schedule"),
                                                 (jnp.asarray(a) for a in jdns.merge_segments(want)))),
                                      key=None, num_runs=None)
    close(t.crude_log_evidence, j.crude_log_evidence)


def test_parallel_dynamic_ns_oracle(normal_mean):
    """tests/test_parallel_dynamic_ibis.py::test_parallel_dynamic_ns_oracle
    with the runs folded into the batch (``num_runs=8``: one stage)."""
    problem, post_mean, post_var, log_z = normal_mean
    res = parallel.parallel_dynamic_nested_sampling(problem, torch.Generator().manual_seed(5), num_runs=8,
                                                    sample_pool_size=48, num_batches=8, monte_carlo_steps=40,
                                                    post_process_sampling_runs=50)
    z = (float(res.log_evidence.mean) - log_z) / float(res.log_evidence.standard_error)
    assert abs(z) < 4.0, (float(res.log_evidence.mean), log_z, z)
    w = torch.exp(res.crude_log_posterior_weights).numpy()
    assert abs(float(w @ res.points[:, 0].numpy()) - post_mean) < 4 * np.sqrt(post_var)
    assert res.num_likelihood_evals > 0 and res.iterations > 0


def test_parallel_dynamic_ns_validates_num_delete(normal_mean):
    with pytest.raises(ValueError, match="num_delete"):
        parallel.parallel_dynamic_nested_sampling(normal_mean[0], None, sample_pool_size=48, batch_size=16,
                                                  num_delete=16)
    with pytest.raises(ValueError, match="num_runs"):
        parallel.parallel_dynamic_nested_sampling(normal_mean[0], None, num_runs=0)


def test_one_run_is_dynamic_nested_sampling(normal_mean):
    """R = 1 is the single-run engine, whose base run is the plain loop."""
    problem = normal_mean[0]
    kw = dict(sample_pool_size=24, num_batches=2, batch_size=16, monte_carlo_steps=20, num_delete=2,
              post_process_sampling_runs=20)
    got = parallel.parallel_dynamic_nested_sampling(problem, torch.Generator().manual_seed(1), **kw)
    want = tdns.dynamic_nested_sampling(problem, torch.Generator().manual_seed(1), **kw)
    for f in ("points", "log_likelihoods", "crude_log_posterior_weights"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.log_evidence.mean, want.log_evidence.mean)
    assert (got.iterations, got.num_likelihood_evals) == (want.iterations, want.num_likelihood_evals)

    g = torch.Generator().manual_seed(1)
    run = nested_sampling_loop(problem, tdns.generate_starting_points(problem, g, 24), g, monte_carlo_steps=20,
                               num_delete=2, monte_carlo_method="adaptive_metropolis")
    base = tdns.dynamic_nested_sampling(problem, torch.Generator().manual_seed(1), **dict(kw, num_batches=0))
    pts, logl, _, _ = tdns.merge_segments([tdns.segment_from_run(run)])
    assert np.array_equal(np.sort(logl), np.sort(base.log_likelihoods.numpy()))
    assert base.iterations == run.state.n_dead // 2 and base.num_likelihood_evals == int(run.state.num_likelihood_evals)


def _gauss():
    return define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                    log_likelihood=lambda th: td.Normal(0.0, 1.0).log_prob(th).sum(),
                                    prior_distribution=["location", "location"], validate=False, device="cpu",
                                    dtype=torch.float64)


MESH_AXES = {"parallel_smc": "runs", "parallel_hmc": "chains", "parallel_ensemble": "walkers",
             "parallel_ibis": "particles", "parallel_dynamic_nested_sampling": "runs",
             "parallel_nested_sampling": "runs"}
MESH_CALLS = {
    "parallel_smc": lambda p, m: parallel.parallel_smc(p, None, num_runs=2, n_particles=50, mcmc_steps=2, mesh=m),
    "parallel_hmc": lambda p, m: parallel.parallel_hmc(p, None, num_chains=2, num_samples=4, num_warmup=4,
                                                       num_leapfrog=3, mesh=m),
    "parallel_ensemble": lambda p, m: parallel.parallel_ensemble(p, None, num_walkers=8, num_samples=3,
                                                                 num_warmup=2, mesh=m),
    "parallel_ibis": lambda p, m: parallel.parallel_ibis(p, lambda th, y: -y * th[0], torch.ones(3), None,
                                                         n_particles=64, mcmc_steps=2, mesh=m),
    "parallel_dynamic_nested_sampling": lambda p, m: parallel.parallel_dynamic_nested_sampling(
        p, None, sample_pool_size=20, num_batches=2, batch_size=10, monte_carlo_steps=5, max_iterations=40,
        min_iterations=5, post_process_sampling_runs=5, mesh=m),
    "parallel_nested_sampling": lambda p, m: parallel.parallel_nested_sampling(
        p, None, num_runs=2, sample_pool_size=20, monte_carlo_steps=5, max_iterations=40, min_iterations=5,
        post_process_sampling_runs=5, mesh=m),
}


def test_parallel_ns_splits_its_runs_by_device():
    """tests/test_parallel.py::test_parallel_ns_over_mesh's oracle (8 runs of
    pool 25, 60 steps; slow in JAX) on a mesh of two "devices" ("cpu" and
    "cpu:0" compare unequal), so the runs go as two device groups, each on
    its copy of the problem, and merge: within 4 sigma of the analytic
    logZ."""
    problem = _gauss()
    mesh = parallel.make_mesh(("runs",), devices=["cpu"] * 4 + ["cpu:0"] * 4)
    res = parallel.parallel_nested_sampling(problem, torch.Generator().manual_seed(0), num_runs=8,
                                            sample_pool_size=25, monte_carlo_steps=60, max_iterations=800,
                                            min_iterations=30, mesh=mesh)
    analytic = 2 * (math.log(math.erf(5 / math.sqrt(2))) - math.log(10.0))
    assert res.sample_pool_size == 200 and res.iterations > 30
    assert abs(float(res.log_evidence.mean) - analytic) < 4 * float(res.log_evidence.standard_error)


@pytest.mark.parametrize("engine", sorted(MESH_CALLS))
def test_mesh_over_two_devices_runs_and_checks_its_shape(engine):
    """Every run-level engine takes a mesh over two devices ("cpu" and
    "cpu:0" compare unequal, so the problem is carried to a second device):
    no engine refuses it any longer, the coupled ones splitting their batch
    per shard and the others by device; a mesh of CPU shards runs, with the
    JAX function's multiple-of-shards check; an object that is not the
    port's Mesh is refused."""
    axis = MESH_AXES[engine]
    assert MESH_CALLS[engine](_gauss(), parallel.make_mesh((axis,), devices=["cpu", "cpu:0"])) is not None
    with pytest.raises(TypeError, match="takes the port's parallel.Mesh"):
        MESH_CALLS[engine](_gauss(), axis)
    assert MESH_CALLS[engine](_gauss(), parallel.make_mesh((axis,), devices=["cpu"] * 2)) is not None
    if engine != "parallel_dynamic_nested_sampling":  # R is the axis size there, as in JAX
        with pytest.raises(ValueError, match=f"must be a multiple of the mesh '{axis}' axis size 3"):
            MESH_CALLS[engine](_gauss(), parallel.make_mesh((axis,), devices=["cpu"] * 3))
