"""The port's tempered SMC against the JAX package, on the CPU in float64.

* The ladder's pieces on the same inputs: ``_ess_fraction``,
  ``_find_delta`` (float64, and float32 on a degenerate population, where
  the floor must move beta), ``_systematic_resample`` given the JAX
  function's own uniform, ``_population_logl_moments``: rtol 1e-12 (indices
  exactly).  The port's versions take a leading run axis; a batch of runs
  equals the runs one by one.
* ``thermodynamic_log_evidence`` on one set of ladder arrays in both
  packages: rtol 1e-12.
* ``smc_sampler`` on tests/test_smc.py's 2-D Gaussian in a box: logZ within
  4 standard errors of the analytic value, the ladder ending at exactly 1
  and rising strictly, and within 4 combined standard errors of the JAX
  engine's logZ on the same problem; thermodynamic integration within 0.1
  of the analytic value as in the JAX test.  Eight runs rather than the JAX
  test's four: an error bar estimated from four runs is too noisy to gate
  at 4 sigma (a t-distribution with 3 degrees of freedom; at four runs
  over seeds 0-99, ``tests/witness_port_jax.py smc-seeds``, two of the
  port's seeds and one of the JAX package's read past 4 sigma, while the
  400 runs of each pool to within one standard error of the analytic
  value).  32 runs in one batch then hold
  the mean logZ of the port's ladder to a 0.015 error bar.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines import smc as jsmc
from bayesianinference_tpu.engines.evidence import MeanAndError as JMeanAndError
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import smc as tsmc
from bayesianinference_tpu_torch.engines.evidence import MeanAndError
from bayesianinference_tpu_torch.models.problem import define_inference_problem

torch.set_num_threads(1)
A = 5.0


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a), dtype=dtype)


def close(got, want, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _logl(seed, n=300, sentinels=20):
    rng = np.random.default_rng(seed)
    ll = rng.normal(-8.0, 4.0, n)
    ll[rng.choice(n, sentinels, replace=False)] = -1e300
    return ll


def test_ess_fraction_matches_jax():
    ll = np.stack([_logl(s) for s in range(3)])
    deltas = np.array([0.0, 0.013, 0.4])
    got = tsmc._ess_fraction(T(deltas), T(ll), ll.shape[1])
    for r in range(3):
        close(got[r], jsmc._ess_fraction(deltas[r], jnp.asarray(ll[r]), ll.shape[1]))
    np.testing.assert_allclose(float(got[0]), 1.0, rtol=1e-14)


@pytest.mark.parametrize("beta", [0.0, 0.3, 0.999])
def test_find_delta_matches_jax_f64(beta):
    """tests/test_smc.py::test_ess_and_delta_search's ladder and two
    populations with sentinels, as one batch of three runs."""
    cfg = tsmc.SMCConfig()
    ll = np.stack([np.linspace(-5.0, 0.0, 300), _logl(1), _logl(2)])
    delta, full = tsmc._find_delta(T(ll), T([beta] * 3), cfg)
    for r in range(3):
        jdelta, jfull = jsmc._find_delta(jnp.asarray(ll[r]), jnp.asarray(beta), jsmc.SMCConfig())
        close(delta[r], jdelta)
        assert bool(full[r]) == bool(jfull)
    if bool(full[0]):  # the whole remaining step keeps the target: straight to beta = 1
        assert beta > 0 and float(delta[0]) == pytest.approx(1.0 - beta)
    else:  # the bisection lands on the target
        close(tsmc._ess_fraction(delta[0], T(ll[0]), 300), 0.5, rtol=0, atol=1e-6)


def test_find_delta_progresses_in_f32():
    """tests/test_smc.py::test_find_delta_progresses_in_f32 in the port,
    against the JAX function: the floor moves beta and never overshoots."""
    ll = np.array([-1e20] * 199 + [0.0], np.float32)
    delta, full = tsmc._find_delta(T(ll, torch.float32), torch.tensor(0.5, dtype=torch.float32), tsmc.SMCConfig())
    jdelta, jfull = jsmc._find_delta(jnp.asarray(ll), jnp.asarray(0.5, jnp.float32), jsmc.SMCConfig())
    assert delta.dtype == torch.float32 and not bool(full) and not bool(jfull)
    assert float(delta) == float(jdelta)
    b = torch.tensor(0.5, dtype=torch.float32)
    assert float(b + delta) > 0.5 and float(delta) <= 0.5


def test_systematic_resample_matches_jax_on_its_uniform():
    rng = np.random.default_rng(0)
    n = 4000
    log_w = np.log(rng.gamma(1.0, size=(2, n)))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    u = np.array([float(jax.random.uniform(k, (), jnp.float64)) for k in keys])
    got = tsmc._systematic_resample(T(u), T(log_w)).numpy()
    for r in range(2):
        want = np.asarray(jsmc._systematic_resample(keys[r], jnp.asarray(log_w[r])))
        np.testing.assert_array_equal(got[r], want)
        # systematic resampling's guarantee: each count is floor or ceil of n w_i
        w = np.exp(log_w[r] - log_w[r].max())
        expected = n * w / w.sum()
        counts = np.bincount(got[r], minlength=n)
        assert (counts >= np.floor(expected) - 1e-9).all() and (counts <= np.ceil(expected) + 1e-9).all()


def test_population_logl_moments_matches_jax():
    ll = np.stack([_logl(3), _logl(4, sentinels=0)])
    mean, var = tsmc._population_logl_moments(T(ll), -1e300)
    for r in range(2):
        jm, jv = jsmc._population_logl_moments(jnp.asarray(ll[r]), -1e300)
        close(mean[r], jm)
        close(var[r], jv)


def _ladder_arrays(seed, runs=3, stages=12):
    """NaN-padded ladder records of three runs of 7, 9 and 12 stages."""
    rng = np.random.default_rng(seed)
    betas = np.full((runs, stages), np.nan)
    means, vars_ = np.full_like(betas, np.nan), np.full_like(betas, np.nan)
    for r, k in enumerate((7, 9, 12)[:runs]):
        b = np.sort(rng.uniform(0, 1, k - 1))
        betas[r, :k] = np.append(b, 1.0)
        means[r, :k] = -2.0 - 3.0 * np.exp(-5.0 * betas[r, :k]) + 0.01 * rng.normal(size=k)
        vars_[r, :k] = 15.0 * np.exp(-5.0 * betas[r, :k])
    return dict(betas=betas, logl_means=means, logl_vars=vars_, logl_mean_prior=rng.normal(-5.0, 0.1, runs),
                logl_var_prior=rng.uniform(10.0, 20.0, runs), log_z_runs=rng.normal(-4.0, 0.1, runs))


def test_thermodynamic_log_evidence_matches_jax():
    arr = _ladder_arrays(0)
    runs = arr["betas"].shape[0]
    common = dict(particles=np.zeros((runs, 2, 1)), log_likelihoods=np.zeros((runs, 2)),
                  ess_fractions=arr["betas"], acceptance_rates=arr["betas"], n_stages=np.array([7, 9, 12]))
    jres = jsmc.SMCResult(log_evidence=JMeanAndError(mean=jnp.asarray(0.0), standard_error=jnp.asarray(0.0)),
                          **{k: jnp.asarray(v) for k, v in {**common, **arr}.items()})
    tres = tsmc.SMCResult(log_evidence=MeanAndError(mean=torch.tensor(0.0), standard_error=torch.tensor(0.0)),
                          **{k: T(v) for k, v in {**common, **arr}.items()})
    got, want = tsmc.thermodynamic_log_evidence(tres), jsmc.thermodynamic_log_evidence(jres)
    close(got.mean, want.mean)
    close(got.standard_error, want.standard_error)
    assert got.mean.dtype == torch.float64


def _analytic_log_z(sigma=1.0):
    mass = st.norm(0, sigma).cdf(A) - st.norm(0, sigma).cdf(-A)
    return 2 * (np.log(mass) - np.log(2 * A))


def _t_problem():
    return define_inference_problem(
        parameters=[("x", -A, A), ("y", -A, A)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        device="cpu", dtype=torch.float64,
    )


def _j_problem():
    return j_define(
        parameters=[("x", -A, A), ("y", -A, A)],
        log_likelihood=lambda th: jnp.sum(jd.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        validate=False,
    )


def test_smc_sampler_gaussian_oracle_and_jax_agreement():
    runs = 8
    r = tsmc.smc_sampler(_t_problem(), torch.Generator().manual_seed(0), n_particles=400, num_runs=runs,
                         mcmc_steps=10)
    want = _analytic_log_z()
    logz, err = float(r.log_evidence.mean), float(r.log_evidence.standard_error)
    assert math.isfinite(err) and 0 < err < 0.5
    assert abs(logz - want) < 4 * err, (logz, want, err)
    for run in range(runs):
        ns = int(r.n_stages[run])
        assert 1 < ns < 100
        betas = r.betas[run, :ns].numpy()
        assert betas[-1] == 1.0 and (np.diff(np.concatenate([[0.0], betas])) > 0).all()
        assert np.isnan(r.betas[run, ns:].numpy()).all()
    np.testing.assert_allclose(r.posterior_samples().mean().numpy(), 0.0, atol=0.15)
    np.testing.assert_allclose(r.particles.var(dim=(0, 1), correction=0).numpy(), 1.0, rtol=0.25)
    assert r.num_likelihood_evals == int(r.n_stages.sum()) * 400 * 12 + runs * 400
    jr = jsmc.smc_sampler(_j_problem(), jax.random.PRNGKey(0), n_particles=400, num_runs=runs, mcmc_steps=10)
    jz, jerr = float(jr.log_evidence.mean), float(jr.log_evidence.standard_error)
    assert abs(logz - jz) < 4 * math.hypot(err, jerr), (logz, err, jz, jerr)


def test_smc_sampler_many_runs_unbiased():
    """32 runs of the port's ladder in one batch: their mean logZ within 4
    of its standard errors (0.015 here) of the analytic value, a tighter
    check for a bias of the ladder than the 8-run oracle above."""
    r = tsmc.smc_sampler(_t_problem(), torch.Generator().manual_seed(0), n_particles=400, num_runs=32,
                         mcmc_steps=10)
    logz, err = float(r.log_evidence.mean), float(r.log_evidence.standard_error)
    assert 0 < err < 0.05
    assert abs(logz - _analytic_log_z()) < 4 * err, (logz, _analytic_log_z(), err)


def test_thermodynamic_integration_gaussian():
    """tests/test_smc.py::test_thermodynamic_integration_gaussian in the
    port (ess_target 0.7, four runs): TI within 0.1 of the analytic logZ
    and of the stepping-stone estimate; the beta = 0 end at the prior mean
    of logL."""
    r = tsmc.smc_sampler(_t_problem(), None, n_particles=400, num_runs=4, mcmc_steps=10, ess_target=0.7)
    ti = tsmc.thermodynamic_log_evidence(r)
    want = _analytic_log_z()
    assert math.isfinite(float(ti.standard_error))
    assert abs(float(ti.mean) - want) < 0.1
    assert abs(float(ti.mean) - float(r.log_evidence.mean)) < 0.1
    np.testing.assert_allclose(r.logl_mean_prior.numpy(), -(A**2) / 3.0 - np.log(2 * np.pi), rtol=0.1)


def test_starting_points_and_max_stages():
    """Given starting particles ([n, d] for one run), and a ladder cut by
    max_stages, which warns that logZ is an underestimate."""
    starts = torch.rand((200, 2), generator=torch.Generator().manual_seed(1), dtype=torch.float64) * 2 * A - A
    with pytest.warns(UserWarning, match="max_stages"):
        r = tsmc.smc_sampler(_t_problem(), None, num_runs=1, starting_points=starts, max_stages=1, mcmc_steps=3)
    assert r.particles.shape == (1, 200, 2) and int(r.n_stages[0]) == 1 and float(r.betas[0, 0]) < 1.0
    assert math.isnan(float(r.log_evidence.standard_error))
    with pytest.raises(ValueError, match="num_runs"):
        tsmc.smc_sampler(_t_problem(), None, num_runs=2, starting_points=starts)
