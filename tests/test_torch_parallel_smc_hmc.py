"""The port's parallel SMC and parallel HMC (``parallel/parallel_smc.py``,
``parallel/parallel_hmc.py``) against the JAX functions run on the
8-device CPU mesh that ``tests/conftest.py`` makes, in float64.

On one card the mesh axis is the batch: SMC's runs are the ladders' run
axis, HMC's global adaptation (``pmean`` of acceptance, ``psum``-merged
moments, the ChEES collectives) the reductions over all chains.  So fed the
numbers of a JAX mesh run, the port must reproduce it:

* SMC: JAX keys each run and splits its key three ways per stage (the next
  key, the resampling offset, the move's chain keys, one per particle, each
  split into the block's normals and log-uniforms); the port takes those as
  ``SMCStageDraws`` and the JAX run's starting particles.  logZ runs 1e-12,
  particles 1e-10, stage counts exactly, at 8 runs on 8 shards, 16 runs (2 a
  shard) and 12 runs (the default mesh's 6 shards).  On its own generator
  the port's ``parallel_smc`` is its ``smc_sampler`` bit for bit, as the
  JAX function is JAX's ``smc_sampler``.
* HMC: JAX keys each shard and splits that key over the shard's chains
  (``ops/hmc.py``'s and ``ops/chees.py``'s schedules, as in
  ``tests/test_torch_hmc.py``); the shards' draws, concatenated on the chain
  axis, replay the run: samples, acceptance, divergences, step size,
  inverse mass and trajectory length at 1e-10 for the diagonal mass, the
  dense mass (symmetric to 1e-12) and ``num_leapfrog="auto"``, over 6
  warmup iterations (``HMC_CASES`` says why no longer), and ChEES also at
  the JAX smoke configuration, 60 + 40.
* The JAX tests' oracles (``tests/test_parallel_smc_hmc.py``) on the port's
  own draws; the global-adaptation test is slow-marked, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines.nested_sampling import generate_starting_points as j_starts
from bayesianinference_tpu.engines.smc import prepare_smc_starting_points as j_prepare
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu.parallel import make_mesh
from bayesianinference_tpu.parallel import parallel_hmc as j_parallel_hmc
from bayesianinference_tpu.parallel import parallel_smc as j_parallel_smc
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines.hmc import hmc_sample
from bayesianinference_tpu_torch.engines.smc import SMCStageDraws, smc_sampler
from bayesianinference_tpu_torch.models.problem import define_inference_problem
from bayesianinference_tpu_torch.ops.chees import ChEESDraws
from bayesianinference_tpu_torch.ops.hmc import HMCDraws
from bayesianinference_tpu_torch.parallel import parallel_hmc, parallel_smc

torch.set_num_threads(1)
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _problems():
    """tests/test_parallel_smc_hmc.py's 2-D standard normal in [-5, 5]^2."""
    jp = j_define(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                  log_likelihood=lambda th: jnp.sum(jd.Normal(0.0, 1.0).log_prob(th)),
                  prior_distribution=["location", "location"], validate=False)
    tp = define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                  log_likelihood=lambda th: Normal(0.0, 1.0).log_prob(th).sum(),
                                  prior_distribution=["location", "location"], validate=False, device="cpu",
                                  dtype=torch.float64)
    return jp, tp


# --- SMC


def _am_block_draws(chain_keys, d, steps):
    """``ops/metropolis.py::run_chain``'s numbers for one block of each chain key."""

    def one(ck):
        kz, ka = jax.random.split(ck)
        return (jax.random.normal(kz, (d, steps), F64),
                jnp.log(jax.random.uniform(ka, (steps,), F64, minval=1e-38, maxval=1.0)))

    z, log_u = jax.vmap(one)(chain_keys)
    return T(z), T(log_u)


def _smc_draws(key, runs, n, d, steps, stages):
    """``parallel_smc``'s starting key and each stage's draws: per run
    ``split(key, 3)`` into the next key, the resampling key and the move's
    key, split into one chain key per particle."""
    k_start, k_runs = jax.random.split(key)
    keys = jax.random.split(k_runs, runs)
    out = []
    for _ in range(stages):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        keys, k_res, k_mut = ks[:, 0], ks[:, 1], ks[:, 2]
        offset = jax.vmap(lambda k: jax.random.uniform(k, (), F64))(k_res)
        chain_keys = jax.vmap(lambda k: jax.random.split(k, n))(k_mut).reshape((runs * n,) + k_mut.shape[1:])
        out.append(SMCStageDraws(T(offset), *_am_block_draws(chain_keys, d, steps)))
    return k_start, out


@pytest.mark.parametrize("runs,shards,n", [(8, 8, 200), (16, 8, 100), (12, None, 64)])
def test_parallel_smc_replays_the_jax_mesh_run(runs, shards, n):
    """8 runs on 8 shards (the JAX mesh-equals-single test's configuration),
    16 (two a shard) and 12 on the default mesh (six shards)."""
    jp, tp = _problems()
    key, steps = jax.random.PRNGKey(0), 8 if shards else 4
    mesh = make_mesh(("runs",)) if shards else None
    want = j_parallel_smc(jp, key, num_runs=runs, n_particles=n, mcmc_steps=steps, mesh=mesh)
    if shards:
        assert mesh.shape["runs"] == shards
    k_start, draws = _smc_draws(key, runs, n, 2, steps, int(np.max(want.n_stages)))
    start = np.asarray(j_prepare(jp, k_start, None, runs, n)[0])
    got = parallel_smc(tp, None, num_runs=runs, n_particles=n, mcmc_steps=steps, starting_points=T(start),
                       draws=draws)
    close(got.log_z_runs, want.log_z_runs, rtol=1e-12)
    close(got.particles, want.particles)
    np.testing.assert_array_equal(got.n_stages.numpy(), np.asarray(want.n_stages))
    for f in ("log_likelihoods", "betas", "ess_fractions", "acceptance_rates"):
        close(getattr(got, f), getattr(want, f))
    assert got.num_likelihood_evals == want.num_likelihood_evals


def test_parallel_smc_is_smc_sampler_on_one_generator():
    _, tp = _problems()
    got = parallel_smc(tp, torch.Generator().manual_seed(4), num_runs=8, n_particles=200, mcmc_steps=8)
    want = smc_sampler(tp, torch.Generator().manual_seed(4), num_runs=8, n_particles=200, mcmc_steps=8)
    for f in ("particles", "log_likelihoods", "log_z_runs", "betas", "acceptance_rates", "n_stages"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(), err_msg=f)  # NaN == NaN


def test_parallel_smc_oracle_at_two_runs_a_shard():
    """tests/test_parallel_smc_hmc.py::test_parallel_smc_vmapped_runs_per_device."""
    _, tp = _problems()
    r = parallel_smc(tp, torch.Generator().manual_seed(0), num_runs=16, n_particles=100, mcmc_steps=8)
    assert r.log_z_runs.shape == (16,)
    assert np.isfinite(float(r.log_evidence.standard_error))
    assert abs(float(r.log_evidence.mean) + 4.6052) < 0.3


def test_parallel_smc_twelve_runs():
    """tests/test_parallel_smc_hmc.py::test_parallel_smc_default_mesh_divisor:
    no shard count to divide on one card."""
    _, tp = _problems()
    r = parallel_smc(tp, torch.Generator().manual_seed(0), num_runs=12, n_particles=64, mcmc_steps=4)
    assert r.log_z_runs.shape == (12,) and torch.isfinite(r.log_z_runs).all()


# --- HMC


def _hmc_step_draws(key, d):
    k_mom, k_eps, k_acc = jax.random.split(key, 3)
    return (jax.random.normal(k_mom, (d,), F64), jax.random.uniform(k_eps, (), F64, minval=-1.0, maxval=1.0),
            jax.random.uniform(k_acc, (), F64))


def _phases(num_warmup):
    p1 = max(num_warmup // 3, 1)
    p2 = max(num_warmup // 3, 1)
    return p1, p2, max(num_warmup - p1 - p2, 1)


def _trajectory_keys(key, num_warmup, num_samples, thinning, chains):
    """One shard's keys, [trajectories, chains], of ``ops/hmc.py``'s
    ``warmup_and_sample``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    rows = [jax.random.split(kit, chains) for k, p in zip((k1, k2, k3), _phases(num_warmup))
            for kit in jax.random.split(k, p)]
    for ks in jax.random.split(k4, num_samples):
        per_chain = jax.vmap(lambda kc: jax.random.split(kc, thinning))(jax.random.split(ks, chains))
        rows.extend(per_chain[:, j] for j in range(thinning))
    return rows


def _chees_keys(key, num_warmup, num_samples, thinning):
    """One shard's per-trajectory keys of ``ops/chees.py``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    keys = [k for kk, p in zip((k1, k2, k3), _phases(num_warmup)) for k in jax.random.split(kk, p)]
    return keys + [kt for ks in jax.random.split(k4, num_samples) for kt in jax.random.split(ks, thinning)]


def _mesh_hmc_draws(key, chains, shards, d, num_warmup, num_samples, thinning, auto):
    """The draws of ``parallel_hmc``'s mesh run: one key per shard (split
    from the run key), each shard's draws over its chains, concatenated on
    the chain axis."""
    _, k_run = jax.random.split(key)
    local = chains // shards
    per_shard = []
    for k_shard in jax.random.split(k_run, shards):
        if auto:
            rows = []
            for k in _chees_keys(k_shard, num_warmup, num_samples, thinning):
                k_mom, k_acc = jax.random.split(k)
                mom = jax.vmap(lambda kk: jax.random.normal(kk, (d,), F64))(jax.random.split(k_mom, local))
                rows.append((mom, jax.random.uniform(k_acc, (local,), F64)))
        else:
            rows = [jax.vmap(lambda kk: _hmc_step_draws(kk, d))(keys)
                    for keys in _trajectory_keys(k_shard, num_warmup, num_samples, thinning, local)]
        per_shard.append([np.stack([np.asarray(r[i]) for r in rows]) for i in range(len(rows[0]))])
    fields = [T(np.concatenate([s[i] for s in per_shard], axis=1)) for i in range(len(per_shard[0]))]
    return ChEESDraws(*fields) if auto else HMCDraws(*fields)


# (chains, keyword arguments).  With a fixed L, warmup is 6 iterations: past
# that the rounding differences of XLA's and PyTorch's reductions grow through
# dual averaging as any 1e-15 change of the start does in JAX alone (its own
# run against one from x0 (1 + 1e-15): 6.5e-14 apart in the samples after 6
# warmup iterations, 1.4e-12 after 9, 1.5e-6 after 30, 0.09 after 60), so no
# 1e-10 replay of a longer run is possible.  ChEES amplifies them far less
# (1e-15 to 5e-11 in the samples at 60 + 40 over PRNGKey(0) to PRNGKey(3),
# tests/parallel_hmc_study.py), so it is also replayed at the JAX smoke
# configuration, where both packages freeze a trajectory of one or two
# leapfrog steps.
HMC_CASES = {
    "diag_thinned": (16, dict(num_samples=3, num_warmup=6, num_leapfrog=5, thinning=2)),
    "dense": (8, dict(num_samples=4, num_warmup=6, num_leapfrog=5, dense_mass=True)),
    "auto": (8, dict(num_samples=4, num_warmup=6, num_leapfrog="auto")),
    "auto_smoke": (8, dict(num_samples=40, num_warmup=60, num_leapfrog="auto")),
}


@pytest.mark.parametrize("case", sorted(HMC_CASES))
def test_parallel_hmc_replays_the_jax_mesh_run(case):
    """On 8 shards: the diagonal mass (two chains a shard, thinned), the
    dense mass and ChEES (one chain a shard), ChEES also with the frozen
    trajectory length of the JAX smoke configuration."""
    chains, kw = HMC_CASES[case]
    jp, tp = _problems()
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(("chains",))
    want = j_parallel_hmc(jp, key, num_chains=chains, mesh=mesh, **kw)
    start = np.asarray(j_starts(jp, jax.random.split(key)[0], chains))
    draws = _mesh_hmc_draws(key, chains, mesh.shape["chains"], 2, kw["num_warmup"], kw["num_samples"],
                            kw.get("thinning", 1), kw["num_leapfrog"] == "auto")
    got = parallel_hmc(tp, None, num_chains=chains, starting_points=T(start), draws=draws, **kw)
    assert got.samples.shape == (chains, kw["num_samples"], 2) and got.step_size.shape == ()
    for f in ("samples", "acceptance_rates", "step_size", "inv_mass_diag", "trajectory_length"):
        close(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.divergences.numpy(), np.asarray(want.divergences))
    if kw.get("dense_mass"):
        m = got.inv_mass_diag.numpy()
        assert m.shape == (2, 2)
        np.testing.assert_allclose(m, m.T, rtol=1e-12)
    assert float(got.step_size) > 0 and float(got.trajectory_length) > 0


def test_parallel_hmc_oracle_runs():
    """tests/test_parallel_smc_hmc.py's smoke, dense-mass and ChEES runs on
    the port's own draws: shapes, finite samples, one step size, a
    symmetric dense mass, one positive trajectory length."""
    _, tp = _problems()
    g = torch.Generator().manual_seed(0)
    r = parallel_hmc(tp, g, num_chains=8, num_samples=40, num_warmup=60, num_leapfrog=5)
    assert r.samples.shape == (8, 40, 2) and r.step_size.shape == () and float(r.step_size) > 0
    assert torch.isfinite(r.samples).all()
    r = parallel_hmc(tp, g, num_chains=8, num_samples=30, num_warmup=60, num_leapfrog=5, dense_mass=True)
    m = r.inv_mass_diag.numpy()
    assert m.shape == (2, 2) and torch.isfinite(r.samples).all()
    np.testing.assert_allclose(m, m.T, rtol=1e-12)
    r = parallel_hmc(tp, g, num_chains=8, num_samples=60, num_warmup=120, num_leapfrog="auto")
    assert r.samples.shape == (8, 60, 2) and r.trajectory_length.shape == ()
    assert float(r.trajectory_length) > 0 and torch.isfinite(r.samples).all()


@pytest.mark.slow
def test_parallel_hmc_global_adaptation():
    """tests/test_parallel_smc_hmc.py::test_parallel_hmc_global_adaptation's
    gates (slow there too): the pooled moments, acceptance above 0.5, no
    divergence, agreement with ``hmc_sample``."""
    _, tp = _problems()
    r = parallel_hmc(tp, torch.Generator().manual_seed(0), num_chains=8, num_samples=600, num_warmup=400,
                     num_leapfrog=10)
    assert r.samples.shape == (8, 600, 2) and r.step_size.shape == ()
    pooled = r.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(pooled.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(pooled.std(axis=0), 1.0, atol=0.1)
    assert (r.acceptance_rates > 0.5).all() and int(r.divergences.sum()) == 0
    r1 = hmc_sample(tp, torch.Generator().manual_seed(1), num_chains=8, num_samples=600, num_warmup=400,
                    num_leapfrog=10)
    np.testing.assert_allclose(pooled.mean(axis=0), r1.samples.reshape(-1, 2).numpy().mean(axis=0), atol=0.1)
    np.testing.assert_allclose(r.inv_mass_diag.numpy(), r1.inv_mass_diag.numpy(), rtol=0.5)


def test_parallel_hmc_checks_its_arguments():
    _, tp = _problems()
    with pytest.raises(ValueError, match="starting_points"):
        parallel_hmc(tp, None, num_chains=4, starting_points=torch.zeros(3, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="num_leapfrog"):
        parallel_hmc(tp, None, num_chains=4, num_leapfrog=0)
