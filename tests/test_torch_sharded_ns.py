"""The port's pool-sharded nested sampling (``parallel/sharded_pool_ns.py``)
against the JAX loop on the 8-device CPU mesh of ``tests/conftest.py``,
float64.

* Replay: the JAX loop's own ``build_pool_loop`` and ``pool_loop_init`` run
  one and three iterations inside a ``shard_map`` (one compiled program,
  module-scoped) from the same starting points; the port's loop takes the
  JAX per-shard draws (each iteration ``split(key, 3)`` into the next key,
  ``k_pick`` and ``k_chain``; shard s's Gumbel noise from
  ``fold_in(k_pick, s)`` and its chains' keys split from
  ``fold_in(k_chain, s)``, each chain's block normals and log-uniforms as
  ``ops/metropolis.py::am_block`` draws them).  Live points, logL, log
  prior, the dead ledger, the moments, logZ, the missing-evidence estimate
  and the evaluation count at 1e-12.
* Whole runs on the port's own draws against the oracles of
  ``tests/test_parallel.py:167-215``: the analytic -2 log 10 within 4 sigma,
  and the port's single-device batched-deletion run within 4 combined sigma.
* The refusals (chmc, ``num_delete >= pool / P``, sizes not multiples of
  the axis).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines.nested_sampling import evals_to_int
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu.ops.ns_math import crude_log_x_deleted as j_log_xd
from bayesianinference_tpu.ops.ns_math import pool_schedule as j_schedule
from bayesianinference_tpu.parallel import make_mesh as j_make_mesh
from bayesianinference_tpu.parallel.sharded_pool_ns import build_pool_loop, pool_loop_init as j_init
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.parallel import make_mesh, sharded_pool_nested_sampling
from bayesianinference_tpu_torch.parallel.sharded_pool_ns import (
    PoolDraws,
    on_own_device,
    pool_config,
    pool_loop_init,
    pool_loop_step,
)
from bayesianinference_tpu_torch.parallel.sharding import cat_to

torch.set_num_threads(1)
F64 = jnp.float64
A = 5.0
N, K, SHARDS, STEPS, ITERS = 128, 8, 8, 40, 3


def T(a):
    return torch.tensor(np.asarray(a))


def _problems():
    jp = j_define(parameters=[("x", -A, A), ("y", -A, A)],
                  log_likelihood=lambda th: jnp.sum(jd.Normal(0.0, 1.0).log_prob(th)),
                  prior_distribution=["location", "location"], validate=False)
    tp = define_inference_problem(parameters=[("x", -A, A), ("y", -A, A)],
                                  log_likelihood=lambda th: Normal(0.0, 1.0).log_prob(th).sum(),
                                  prior_distribution=["location", "location"], validate=False, device="cpu",
                                  dtype=torch.float64)
    return jp, tp


def _jax_draws(key, iters, n_loc, c, d, steps):
    """The JAX loop's numbers for ``iters`` iterations, per shard."""
    out = []
    for _ in range(iters):
        key, k_pick, k_chain = jax.random.split(key, 3)
        gumbels, zs, lus = [], [], []
        for s in range(SHARDS):
            gumbels.append(T(jax.random.gumbel(jax.random.fold_in(k_pick, s), (c, n_loc), F64)))
            z, lu = [], []
            for ck in jax.random.split(jax.random.fold_in(k_chain, s), c):
                kz, ka = jax.random.split(jax.random.split(ck)[0])  # run_chain_adaptive's k_init, then am_block's
                z.append(np.asarray(jax.random.normal(kz, (d, steps), F64)))
                lu.append(np.log(np.asarray(jax.random.uniform(ka, (steps,), F64, minval=1e-38, maxval=1.0))))
            zs.append(T(np.stack(z)))
            lus.append(T(np.stack(lu)))
        out.append(PoolDraws(gumbels, zs, lus))
    return out


@pytest.fixture(scope="module")
def replay():
    """The JAX loop after 1 and after ITERS iterations, its draws, and the
    starting points."""
    jp, _ = _problems()
    jmesh = j_make_mesh(("live",))
    n_loc, c, capacity = N // SHARDS, K // SHARDS, 10 * K
    log_xd = j_log_xd(j_schedule(N, K, capacity).astype(F64))
    cond, body = build_pool_loop(
        jp.guarded_log_likelihood, jp.guarded_log_prior, jp.in_support, axis_name="live", n=N, k=K, n_loc=n_loc,
        c=c, dtype=F64, capacity=capacity, log_xd=log_xd, log_term=jnp.log(jnp.asarray(0.01, F64)),
        mc=(STEPS, STEPS, 5 * STEPS), min_max_acceptance_rate=(0.0, 1.0), covariance_learn_delay=10,
        monte_carlo_method="adaptive_metropolis", max_iterations=10, min_iterations=10)

    @jax.jit
    @partial(jax.shard_map, mesh=jmesh, in_specs=(P("live"), P(), P()),
             out_specs=(P("live"), P("live"), P("live")) + (P(),) * 9, check_vma=False)
    def run(starts, key, iters):
        state = j_init(starts, key, jp.guarded_log_likelihood, jp.guarded_log_prior, axis_name="live", n=N,
                       capacity=capacity, dtype=F64)
        state = jax.lax.fori_loop(0, iters, lambda _, s: body(s), state)
        (_, live, logl, logp, dead_p, dead_l, dead_pr, n_dead, _, mean_est, cov_est, evals, log_z, log_missing) = state
        return live, logl, logp, dead_p, dead_l, dead_pr, n_dead, mean_est, cov_est, evals[None], log_z, log_missing

    starts = np.random.default_rng(4).uniform(-A, A, (N, 2))
    key = jax.random.PRNGKey(3)
    outs = {it: [np.asarray(v) for v in run(jnp.asarray(starts), key, jnp.asarray(it))] for it in (1, ITERS)}
    return starts, _jax_draws(key, ITERS, n_loc, c, 2, STEPS), outs


@pytest.mark.parametrize("iters", [1, ITERS])
def test_pool_loop_replays_the_jax_loop_on_its_draws(replay, iters):
    _, tp = _problems()
    starts, draws, outs = replay
    cfg = pool_config(N, K, SHARDS, 2, max_iterations=10, min_iterations=10, monte_carlo_steps=STEPS,
                      termination_fraction=0.01, min_max_acceptance_rate=(0.0, 1.0), covariance_learn_delay=10,
                      monte_carlo_method="auto", engine="mesh axis size", sizes="pool")
    assert cfg.method == "adaptive_metropolis" and (cfg.n_loc, cfg.c) == (16, 1)
    ll, lp, sup = (on_own_device(f) for f in (tp.guarded_log_likelihood, tp.guarded_log_prior, tp.in_support))
    state = pool_loop_init([T(starts[i * 16:(i + 1) * 16]) for i in range(SHARDS)], [ll] * SHARDS, lp, n=N,
                           capacity=cfg.capacity)
    for it in range(iters):
        state = pool_loop_step(state, draws[it], cfg, [ll] * SHARDS, lp, sup)
    live, logl, logp, dead_p, dead_l, dead_pr, n_dead, mean_est, cov_est, evals, log_z, log_missing = outs[iters]
    assert state.n_dead == int(n_dead) == iters * K and state.iteration == iters + 1
    close = lambda got, want: np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12, atol=1e-12)  # noqa: E731
    close(cat_to(state.live, "cpu"), live)
    close(cat_to(state.logl, "cpu"), logl)
    close(cat_to(state.logp, "cpu"), logp)
    nd = state.n_dead
    for got, want in ((state.dead_points, dead_p), (state.dead_logl, dead_l), (state.dead_logp, dead_pr)):
        close(got[:nd], want[:nd])
    close(state.mean_est, mean_est)
    close(state.cov_est, cov_est)
    close(state.log_z, log_z)
    close(state.log_missing, log_missing)
    assert int(state.evals) == evals_to_int(evals)
    # the draws moved some points: not a trivial replay
    assert not np.allclose(cat_to(state.live, "cpu").numpy(), starts)


def _analytic():
    return -2 * np.log(2 * A)


def test_sharded_pool_ns_oracle_and_single_device_run():
    """tests/test_parallel.py::test_sharded_pool_nested_sampling's
    configuration on an 8-shard CPU mesh."""
    _, tp = _problems()
    mesh = make_mesh(("live",), devices=["cpu"] * SHARDS)
    kw = dict(sample_pool_size=N, num_delete=K, max_iterations=900, min_iterations=50, monte_carlo_steps=STEPS)
    r = sharded_pool_nested_sampling(tp, torch.Generator().manual_seed(0), mesh=mesh, **kw)
    z = (float(r.log_evidence.mean) - _analytic()) / float(r.log_evidence.standard_error)
    assert abs(z) < 4.0, (float(r.log_evidence.mean), z)
    assert r.num_likelihood_evals > 0 and r.iterations > 50 and r.sample_pool_size == N
    r1 = nested_sampling(tp, torch.Generator().manual_seed(7), **kw)
    err = np.hypot(float(r.log_evidence.standard_error), float(r1.log_evidence.standard_error))
    assert abs(float(r.log_evidence.mean) - float(r1.log_evidence.mean)) < 4.0 * err


def test_sharded_pool_ns_refusals():
    _, tp = _problems()
    mesh = make_mesh(("live",), devices=["cpu"] * SHARDS)
    with pytest.raises(ValueError, match="must be multiples of the mesh axis size 8"):
        sharded_pool_nested_sampling(tp, None, sample_pool_size=100, num_delete=8, mesh=mesh)
    with pytest.raises(ValueError, match="must be < pool/devices = 4"):
        sharded_pool_nested_sampling(tp, None, sample_pool_size=32, num_delete=8, mesh=mesh)
    with pytest.raises(ValueError, match="chmc"):
        sharded_pool_nested_sampling(tp, None, sample_pool_size=N, num_delete=8, mesh=mesh, monte_carlo_method="chmc")
