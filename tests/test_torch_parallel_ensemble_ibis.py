"""The port's parallel ensemble and parallel IBIS
(``parallel/parallel_ensemble.py``, ``parallel/parallel_ibis.py``) against
the JAX functions run on the 8-device CPU mesh that ``tests/conftest.py``
makes, in float64.

On one card the mesh axis is the batch: the ensemble's shard of half A
against the gathered half B is half A against half B; IBIS's global
logsumexp, gathered population and summed acceptance are the reductions
over all particles.  So fed the numbers of a JAX mesh run, the port must
reproduce it:

* the ensemble: JAX keys each shard (one key split from the run key), splits
  off a warmup key when there is warmup, and gives every sweep ``split(k)``
  into its two halves' keys; each shard draws for its walkers of the half
  (``_stretch_half``: ``split(key, 3)``; ``_de_half``: ``split(key, 5)``,
  partners in the whole complement).  The shards' draws, concatenated in
  walker order, replay the run: samples and acceptance at 1e-10 for
  ``"stretch"`` and ``"de"``, and with ``thinning`` 2;
* IBIS: the prior draws from ``split(fold_in(key, 0))``'s first key; at
  stage t, ``fold_in(k_loop, t)`` split into the resampling key (the
  offset) and the move key, into which each shard folds its index and
  splits one chain key per particle (``run_chain``'s normals and
  log-uniforms).  logZ, the predictives, the ESS history and acceptance at
  1e-10, the resampled flags exactly.

Oracles on the port's own draws are the JAX tests': the walker-count and
move checks (``tests/test_ensemble.py``'s and ``parallel_ensemble.py``'s),
and ``tests/test_parallel_dynamic_ibis.py``'s IBIS oracle and validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp as sp_lse
from scipy.stats import norm

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines.nested_sampling import generate_starting_points as j_starts
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu.parallel import make_mesh
from bayesianinference_tpu.parallel import parallel_ensemble as j_parallel_ensemble
from bayesianinference_tpu.parallel import parallel_ibis as j_parallel_ibis
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.engines.ibis import IBISStageDraws, ibis_sampler
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.ops import ensemble as tens
from bayesianinference_tpu_torch.parallel import make_mesh as t_make_mesh
from bayesianinference_tpu_torch.parallel import parallel_ensemble, parallel_ibis

torch.set_num_threads(1)
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --- the ensemble


def _gauss_problems():
    """A correlated 2-D Gaussian in [-5, 5]^2."""
    prec = np.array([[1.5, 0.6], [0.6, 0.9]])
    jp = j_define(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                  log_likelihood=lambda th: -0.5 * th @ jnp.asarray(prec) @ th,
                  prior_distribution=["location", "location"], validate=False)
    tprec = T(prec)
    tp = define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                  log_likelihood=lambda th: -0.5 * th @ tprec @ th,
                                  prior_distribution=["location", "location"], validate=False, device="cpu",
                                  dtype=torch.float64)
    return jp, tp


def _half_draws(key, m, m2, d, move):
    """The numbers ``ops/ensemble.py``'s half-update draws from ``key``."""
    if move == "stretch":
        k_j, k_z, k_u = jax.random.split(key, 3)
        return (jax.random.randint(k_j, (m,), 0, m2), jax.random.uniform(k_z, (m,), F64),
                jax.random.uniform(k_u, (m,), F64))
    k_r1, k_r2, k_g, k_e, k_u = jax.random.split(key, 5)
    return (jax.random.randint(k_r1, (m,), 0, m2), jax.random.randint(k_r2, (m,), 0, m2 - 1),
            jax.random.uniform(k_g, (m,), F64), jax.random.normal(k_e, (m, d), F64),
            jax.random.uniform(k_u, (m,), F64))


def _mesh_ensemble_draws(key, walkers, shards, d, num_warmup, num_samples, thinning, move):
    """The draws of ``parallel_ensemble``'s mesh run, [sweeps, ...] for each
    half, the shards' walkers in order."""
    h = walkers // 2
    local = h // shards
    _, k_run = jax.random.split(key)
    per_shard = []
    for k in jax.random.split(k_run, shards):
        sweeps = []
        if num_warmup > 0:
            k_w, k = jax.random.split(k)
            sweeps += list(jax.random.split(k_w, num_warmup))
        sweeps += [kt for ks in jax.random.split(k, num_samples) for kt in jax.random.split(ks, thinning)]
        per_shard.append([[_half_draws(kh, local, h, d, move) for kh in jax.random.split(ks)] for ks in sweeps])
    kind = tens.StretchDraws if move == "stretch" else tens.DEDraws
    halves = []
    for half in range(2):
        fields = []
        for f in range(len(kind._fields)):
            rows = [np.concatenate([np.asarray(s[t][half][f]) for s in per_shard]) for t in range(len(per_shard[0]))]
            a = T(np.stack(rows))
            fields.append(a.long() if a.dtype == torch.int32 else a)
        halves.append(kind(*fields))
    return tuple(halves)


@pytest.mark.parametrize("move,thinning", [("stretch", 1), ("de", 1), ("stretch", 2)])
def test_parallel_ensemble_replays_the_jax_mesh_run(move, thinning):
    """32 walkers: two a shard of each half on 8 shards."""
    jp, tp = _gauss_problems()
    key, walkers, warmup, samples = jax.random.PRNGKey(1), 32, 6, 8 // thinning
    mesh = make_mesh(("walkers",))
    want = j_parallel_ensemble(jp, key, num_walkers=walkers, num_samples=samples, num_warmup=warmup,
                               thinning=thinning, move=move, mesh=mesh)
    start = np.asarray(j_starts(jp, jax.random.split(key)[0], walkers))
    draws = _mesh_ensemble_draws(key, walkers, mesh.shape["walkers"], 2, warmup, samples, thinning, move)
    got = parallel_ensemble(tp, None, num_walkers=walkers, num_samples=samples, num_warmup=warmup, thinning=thinning,
                            move=move, starting_points=T(start), draws=draws,
                            mesh=t_make_mesh(("walkers",), devices=["cpu"] * mesh.shape["walkers"]))
    assert got.samples.shape == (walkers, samples, 2) and got.move == move
    close(got.samples, want.samples)
    close(got.acceptance_rates, want.acceptance_rates)
    assert 0 < float(got.acceptance_rates.mean()) < 1


def test_parallel_ensemble_moments():
    """The sampled law on the port's own draws: the Gaussian's moments."""
    _, tp = _gauss_problems()
    r = parallel_ensemble(tp, torch.Generator().manual_seed(0), num_walkers=64, num_samples=400, num_warmup=200)
    pts = r.posterior_samples().points.numpy()
    cov = np.linalg.inv(np.array([[1.5, 0.6], [0.6, 0.9]]))
    np.testing.assert_allclose(pts.mean(axis=0), 0.0, atol=0.1)
    np.testing.assert_allclose(np.cov(pts.T), cov, atol=0.15)


def test_parallel_ensemble_checks_its_arguments():
    _, tp = _gauss_problems()
    with pytest.raises(ValueError, match="even"):
        parallel_ensemble(tp, None, num_walkers=7)
    with pytest.raises(ValueError, match="2d\\+2"):
        parallel_ensemble(tp, None, num_walkers=4)
    with pytest.raises(ValueError, match="unknown move"):
        parallel_ensemble(tp, None, num_walkers=8, move="walk")
    with pytest.raises(ValueError, match="gamma_jump_prob"):
        parallel_ensemble(tp, None, num_walkers=8, gamma_jump_prob=0.2)
    with pytest.raises(ValueError, match="starting_points"):
        parallel_ensemble(tp, None, num_walkers=8, starting_points=torch.zeros(6, 2, dtype=torch.float64))


# --- IBIS


@pytest.fixture(scope="module")
def normal_mean():
    """tests/test_parallel_dynamic_ibis.py's normal_mean_setup."""
    data = np.random.default_rng(3).normal(0.8, 1.0, size=40)
    sigma, tau = 1.0, 2.0
    jdata = jnp.asarray(data)
    jp = j_define(parameters=[("mu", -10.0, 10.0)],
                  log_likelihood=lambda th: jnp.sum(jd.Normal(th[0], sigma).log_prob(jdata)),
                  prior_distribution=jd.Product((jd.Normal(0.0, tau),)), validate=False)
    y = T(data)
    tp = define_inference_problem(parameters=[("mu", -10.0, 10.0)],
                                  log_likelihood=lambda th: td.Normal(th[0], sigma).log_prob(y).sum(),
                                  prior_distribution=td.Product((td.Normal(T(0.0), T(tau)),)), validate=False,
                                  device="cpu", dtype=torch.float64)
    post_var = 1.0 / (1.0 / tau**2 + data.size / sigma**2)
    post_mean = post_var * data.sum() / sigma**2
    grid = np.linspace(-10, 10, 4001)
    ll = norm.logpdf(data[None, :], loc=grid[:, None], scale=sigma).sum(1)
    log_z = float(sp_lse(ll + norm.logpdf(grid, scale=tau)) + np.log(grid[1] - grid[0]))
    return dict(data=data, jp=jp, j_pointwise=lambda th, v: jd.Normal(th[0], sigma).log_prob(v), tp=tp,
                t_pointwise=lambda th, v: td.Normal(th[0], sigma).log_prob(v), post_mean=post_mean,
                post_var=post_var, log_z=log_z)


def _mesh_ibis_draws(key, n, shards, d, steps, stages):
    """``parallel_ibis``'s prior key and each stage's draws."""
    k_init, k_loop = jax.random.split(jax.random.fold_in(key, 0))
    local = n // shards

    def block(chain_key):
        kz, ka = jax.random.split(chain_key)
        return (jax.random.normal(kz, (d, steps), F64),
                jnp.log(jax.random.uniform(ka, (steps,), F64, minval=1e-38, maxval=1.0)))

    out = []
    for t in range(stages):
        k_res, k_mut = jax.random.split(jax.random.fold_in(k_loop, t))
        parts = [jax.vmap(block)(jax.random.split(jax.random.fold_in(k_mut, p), local)) for p in range(shards)]
        out.append(IBISStageDraws(offset=T(jax.random.uniform(k_res, (), F64)),
                                  z=T(np.concatenate([np.asarray(z) for z, _ in parts])),
                                  log_u=T(np.concatenate([np.asarray(lu) for _, lu in parts]))))
    return k_init, out


def test_parallel_ibis_replays_the_jax_mesh_run(normal_mean):
    m = normal_mean
    key, n, steps, batch = jax.random.PRNGKey(1), 256, 6, 5
    want = j_parallel_ibis(m["jp"], m["j_pointwise"], jnp.asarray(m["data"]), key, n_particles=n, batch_size=batch,
                           mcmc_steps=steps)
    stages = -(-m["data"].size // batch)
    k_init, draws = _mesh_ibis_draws(key, n, len(jax.devices()), 1, steps, stages)
    start = np.asarray(m["jp"].prior_distribution.sample(k_init, (n,))).reshape(n, 1)
    got = parallel_ibis(m["tp"], m["t_pointwise"], T(m["data"]), None, n_particles=n, batch_size=batch,
                        mcmc_steps=steps, starting_points=T(start), draws=draws,
                        mesh=t_make_mesh(("particles",), devices=["cpu"] * len(jax.devices())))
    np.testing.assert_array_equal(got.resampled.numpy(), np.asarray(want.resampled))
    assert got.resampled.any() and not got.resampled.all()
    for f in ("log_evidence", "log_predictives", "ess_history", "acceptance_history", "particles", "log_weights_"):
        close(getattr(got, f), getattr(want, f))


def test_parallel_ibis_oracle(normal_mean):
    """tests/test_parallel_dynamic_ibis.py::test_parallel_ibis_oracle's gates."""
    m = normal_mean
    y = T(m["data"])
    res = parallel_ibis(m["tp"], m["t_pointwise"], y, torch.Generator().manual_seed(1), n_particles=2048,
                        batch_size=5, mcmc_steps=15)
    assert abs(float(res.log_evidence) - m["log_z"]) < 0.25
    np.testing.assert_allclose(float(res.log_predictives.sum()), float(res.log_evidence), rtol=1e-6)
    w = torch.softmax(res.log_weights, 0).numpy()
    x = res.particles[:, 0].numpy()
    mu = float((w * x).sum())
    assert abs(mu - m["post_mean"]) < 4 * np.sqrt(m["post_var"] / 500)
    assert abs(float((w * (x - mu) ** 2).sum()) / m["post_var"] - 1.0) < 0.25
    assert res.resampled.any()
    assert np.nanmean(res.acceptance_history.numpy()) > 0.1
    ref = ibis_sampler(m["tp"], m["t_pointwise"], y, torch.Generator().manual_seed(2), n_particles=2048, batch_size=5,
                       mcmc_steps=15)
    assert abs(float(res.log_evidence) - float(ref.log_evidence)) < 0.25


def test_parallel_ibis_validation(normal_mean):
    m = normal_mean
    with pytest.raises(ValueError, match="batch_size"):
        parallel_ibis(m["tp"], m["t_pointwise"], T(m["data"]), None, n_particles=64, batch_size=0)
