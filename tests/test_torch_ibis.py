"""The port's IBIS (``engines/ibis.py``) against the JAX package, on the CPU
in float64.

Replay: the port starts from JAX's prior draws and takes each moving
stage's resampling offset and adaptive-Metropolis normals and log-uniforms
from the JAX key tree (``fold_in(k_loop, t)`` split into the resampling and
the move keys, one chain key per particle); every stage then agrees with
JAX (1e-10): the prequential increments, the ESS, the resampling decision,
the acceptance and the final particles.  Oracles, on the port's own draws,
are the JAX tests': the exact evidence and posterior of the conjugate
Normal mean (4096 particles, batch 5, 20 steps), batch-size invariance and
the prequential model comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp as sp_lse
from scipy.stats import norm

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines.ibis import ibis_sampler as j_ibis
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch import interop
from bayesianinference_tpu_torch.engines.ibis import IBISStageDraws, ibis_sampler
from bayesianinference_tpu_torch.models import define_inference_problem

torch.set_num_threads(1)
F64 = jnp.float64


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _pair(data, sigma=1.0, tau=2.0):
    jp = j_define(parameters=[("mu", -10.0, 10.0)],
                  log_likelihood=lambda th: jnp.sum(jd.Normal(th[0], sigma).log_prob(jnp.asarray(data))),
                  prior_distribution=jd.Product((jd.Normal(0.0, tau),)), validate=False)
    tp = define_inference_problem(parameters=[("mu", -10.0, 10.0)],
                                  log_likelihood=lambda th: td.Normal(th[0], sigma).log_prob(T(data)).sum(),
                                  prior_distribution=td.Product((td.Normal(T(0.0), T(tau)),)), validate=False,
                                  device="cpu", dtype=torch.float64)
    return (jp, lambda th, y: jd.Normal(th[0], sigma).log_prob(y)), \
        (tp, lambda th, y: td.Normal(th[0], sigma).log_prob(y))


@pytest.fixture(scope="module")
def setup():
    data = np.random.default_rng(0).normal(1.3, 1.0, size=60)
    n, tau = data.size, 2.0
    post_var = 1.0 / (1.0 / tau**2 + n)
    post_mean = post_var * data.sum()
    grid = np.linspace(-10, 10, 4001)
    ll = norm.logpdf(data[None, :], loc=grid[:, None]).sum(1)
    log_z = sp_lse(ll + norm.logpdf(grid, scale=tau)) + np.log(grid[1] - grid[0])
    return data, post_mean, post_var, log_z


def _jax_stage_draws(key, n, d, steps, stages):
    """Per stage, the resampling offset and the move's draws from
    ``engines/ibis.py``'s key tree; and the prior draws that start it."""
    k_init, k_loop = jax.random.split(jax.random.fold_in(key, 0))
    out = []
    for t in range(stages):
        k_res, k_mut = jax.random.split(jax.random.fold_in(k_loop, t))
        zs, lus = [], []
        for ck in jax.random.split(k_mut, n):
            kz1, kacc = jax.random.split(ck)
            zs.append(np.asarray(jax.random.normal(kz1, (d, steps), F64)))
            lus.append(np.log(np.asarray(jax.random.uniform(kacc, (steps,), F64, minval=1e-38, maxval=1.0))))
        out.append(IBISStageDraws(offset=T(np.asarray(jax.random.uniform(k_res, (), F64))), z=T(np.stack(zs)),
                                  log_u=T(np.stack(lus))))
    return k_init, out


def test_stages_replay_jax(setup):
    data = setup[0]
    (jp, jpw), (tp, tpw) = _pair(data)
    key, n, steps = jax.random.PRNGKey(1), 256, 6
    want = j_ibis(jp, jpw, jnp.asarray(data), key, n_particles=n, batch_size=5, mcmc_steps=steps)
    k_init, draws = _jax_stage_draws(key, n, 1, steps, 12)
    start = np.asarray(jp.prior_distribution.sample(k_init, (n,))).reshape(n, 1)
    got = ibis_sampler(tp, tpw, T(data), None, n_particles=n, batch_size=5, mcmc_steps=steps,
                       starting_points=T(start), draws=draws)
    np.testing.assert_array_equal(got.resampled.numpy(), np.asarray(want.resampled))
    assert got.resampled.any() and not got.resampled.all()
    carried = interop.ibis_result_from_numpy(want, device="cpu")
    assert carried.resampled.dtype == torch.bool
    for f in ("particles", "log_weights_", "log_evidence", "log_predictives", "ess_history", "acceptance_history"):
        close(getattr(got, f), getattr(want, f))
        close(getattr(carried, f), getattr(got, f))


def test_exact_evidence_and_posterior(setup):
    data, post_mean, post_var, log_z = setup
    (_, _), (tp, tpw) = _pair(data)
    res = ibis_sampler(tp, tpw, T(data), torch.Generator().manual_seed(1), n_particles=4096, batch_size=5,
                       mcmc_steps=20)
    assert abs(float(res.log_evidence) - log_z) < 0.2
    close(res.log_predictives.sum(), res.log_evidence, rtol=1e-10)
    w = torch.softmax(res.log_weights, 0).numpy()
    x = res.particles[:, 0].numpy()
    mu = float((w * x).sum())
    assert abs(mu - post_mean) < 4 * np.sqrt(post_var / 1000)
    assert abs(float((w * (x - mu) ** 2).sum()) / post_var - 1.0) < 0.2
    assert res.resampled.any() and not res.resampled.all()
    assert np.nanmean(res.acceptance_history.numpy()) > 0.1


def test_batch_size_invariance_and_model_comparison(setup):
    data, _, _, log_z = setup
    (_, _), (tp, tpw) = _pair(data)
    for bs in (1, 20, 60):
        res = ibis_sampler(tp, tpw, T(data), torch.Generator().manual_seed(2), n_particles=4096, batch_size=bs,
                           mcmc_steps=15)
        assert abs(float(res.log_evidence) - log_z) < 0.12, (bs, float(res.log_evidence), log_z)
        assert res.log_predictives.shape == (-(-60 // bs),)
    (_, _), (wrong, wrong_pw) = _pair(data, sigma=3.0)
    cum = [torch.cumsum(ibis_sampler(p, pw, T(data), torch.Generator().manual_seed(3), n_particles=2048,
                                     batch_size=10, mcmc_steps=15).log_predictives, 0)[-1]
           for p, pw in ((tp, tpw), (wrong, wrong_pw))]
    assert float(cum[0]) > float(cum[1]) + 5
