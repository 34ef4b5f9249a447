"""The port's mixtures and censoring (``dists/combinators.py``: ``Mixture``,
``HeterogeneousMixture``, ``Censored``), its kernel density estimate
(``dists/empirical.py``: ``GaussianKDE``, ``silverman_bandwidth``) and the
exponential-family abstraction (``dists/expfam.py``) against the JAX
package, on the CPU in float64.

Parity tests put the same parameters and points through both packages at
rtol 1e-12: densities, CDFs, moments and quantiles; the samplers on the JAX
draws (component indices from its ``categorical`` key, the picked
components' draws, the KDE's kernel normals); every function of every
exponential family, its conjugate update and predictive.  Oracle tests
hold the port to ``tests/test_dists_combinators.py``'s mixture and
censoring oracles and ``tests/test_dists_conjugate_expfam.py:77-276``
(scipy and quadrature), one counterpart each, and the Normal family's
conjugate update and predictive to the port's own conjugate Normal engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from scipy import integrate
from scipy.special import gammaln

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.core.numerics import is_log_zero
from bayesianinference_tpu_torch.dists.empirical import silverman_bandwidth
from bayesianinference_tpu_torch.interop import gaussian_kde_from_numpy, mixture_from_numpy

torch.set_num_threads(1)
RTOL = 1e-12


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=1e-300):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _mixture_pair(family, params, weights):
    j = jd.Mixture(log_weights=jnp.log(jnp.asarray(weights)),
                   component=getattr(jd, family)(**{k: jnp.asarray(v) for k, v in params.items()}))
    return j, mixture_from_numpy(j, device="cpu", dtype=torch.float64)


MIXTURES = [
    ("Normal", dict(loc=[-2.0, 3.0, 0.5], scale=[1.0, 0.5, 2.0]), [0.3, 0.5, 0.2]),
    ("Laplace", dict(loc=[-1.0, 2.0], scale=[0.5, 1.0]), [0.4, 0.6]),
    ("StudentT", dict(df=[3.0, 8.0], loc=[0.0, 1.0], scale=[1.0, 0.4]), [0.5, 0.5]),
    ("Gamma", dict(a=[2.0, 5.0], rate=[1.0, 0.5]), [0.7, 0.3]),
]


@pytest.mark.parametrize("family,params,weights", MIXTURES, ids=[m[0] for m in MIXTURES])
def test_mixture_density_cdf_and_moments_match_jax(family, params, weights):
    j, t = _mixture_pair(family, params, weights)
    x = np.linspace(-6, 9, 31) if family != "Gamma" else np.linspace(0.05, 20, 31)
    close(t.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))
    close(t.cdf(T(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))), atol=1e-16)
    close(float(t.mean()), float(j.mean()))
    close(float(t.variance()), float(j.variance()))
    assert t.num_components == j.num_components


@pytest.mark.parametrize("family,params,weights", MIXTURES, ids=[m[0] for m in MIXTURES])
def test_mixture_quantile_matches_jax(family, params, weights):
    j, t = _mixture_pair(family, params, weights)
    q = np.array([0.05, 0.25, 0.5, 0.9])
    close(t.quantile(T(q)).numpy(), np.asarray(j.quantile(jnp.asarray(q))), atol=1e-13)


def test_mixture_sampler_replays_jax_on_its_indices_and_draws():
    j, t = _mixture_pair("Laplace", MIXTURES[1][1], MIXTURES[1][2])
    key = jax.random.PRNGKey(3)
    n = 500
    want = np.asarray(j.sample(key, (n,)))
    k1, k2 = jax.random.split(key)
    idx = jax.random.categorical(k1, j._norm_logw(), shape=(n,))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(jax.random.split(k2, n))
    got = t.sample(None, (n,), indices=torch.tensor(np.asarray(idx)), draws={"uniforms": T(u)})
    close(got.numpy(), want, atol=1e-13)
    one = t.sample(None, (), indices=torch.tensor([1]), draws={"uniforms": T([0.25])})
    assert one.shape == ()


def test_multivariate_mixture_matches_jax():
    locs, covs = np.array([[0.0, 0.0], [4.0, 4.0]]), np.stack([np.eye(2), 0.5 * np.eye(2) + 0.1])
    j = jd.Mixture(log_weights=jnp.log(jnp.asarray([0.4, 0.6])),
                   component=jd.MultivariateNormal(jnp.asarray(locs), jnp.asarray(covs)))
    t = td.Mixture(log_weights=torch.log(T([0.4, 0.6])), component=td.MultivariateNormal(T(locs), T(covs)))
    x = np.array([[0.0, 0.0], [4.0, 4.0], [2.0, 2.0], [-1.0, 3.0]])
    close(t.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))
    close(t.mean().numpy(), np.asarray(j.mean()))
    close(t.variance().numpy(), np.asarray(j.variance()))
    assert t.sample(torch.Generator().manual_seed(0), (200,)).shape == (200, 2)


HETERO = dict(weights=[0.3, 0.7], comps=(("StudentT", dict(df=4.0, loc=1.0, scale=2.0)),
                                         ("Normal", dict(loc=-1.0, scale=0.5))))


def _hetero_pair():
    lw = np.log(HETERO["weights"])
    j = jd.HeterogeneousMixture(jnp.asarray(lw), tuple(getattr(jd, f)(**p) for f, p in HETERO["comps"]))
    t = td.HeterogeneousMixture(T(lw), tuple(getattr(td, f)(**{k: T(v) for k, v in p.items()})
                                             for f, p in HETERO["comps"]))
    return j, t


def test_heterogeneous_mixture_matches_jax():
    j, t = _hetero_pair()
    x = np.linspace(-5, 8, 41)
    close(t.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))
    close(t.cdf(T(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))), atol=1e-16)
    close(float(t.mean()), float(j.mean()))
    close(float(t.variance()), float(j.variance()))
    for a, b in zip(t.support(), j.support()):
        assert float(a) == float(b)


def test_heterogeneous_mixture_sampler_replays_jax_on_its_indices_and_draws():
    j, t = _hetero_pair()
    key, n = jax.random.PRNGKey(5), 400
    want = np.asarray(j.sample(key, (n,)))
    k_pick, k_draw = jax.random.split(key)
    idx = jax.random.categorical(k_pick, j._norm_logw(), shape=(n,))
    draws = jnp.stack([c.sample(k, (n,)) for c, k in zip(j.components, jax.random.split(k_draw, 2))])
    got = t.sample(None, (n,), indices=torch.tensor(np.asarray(idx)), draws=T(draws))
    close(got.numpy(), want)


def test_heterogeneous_mixture_oracle():
    """tests/test_results_direct.py's mixed Student-t and Normal mixture
    against scipy, and its sampler's moments on the generator."""
    _, t = _hetero_pair()
    xs = np.linspace(-5, 8, 41)
    close(t.log_prob(T(xs)).numpy(), np.log(0.3 * st.t.pdf(xs, 4, 1, 2) + 0.7 * st.norm.pdf(xs, -1, 0.5)))
    close(t.cdf(T(xs)).numpy(), 0.3 * st.t.cdf(xs, 4, 1, 2) + 0.7 * st.norm.cdf(xs, -1, 0.5))
    close(float(t.mean()), 0.3 * 1.0 + 0.7 * -1.0)
    s = t.sample(torch.Generator().manual_seed(0), (100000,)).numpy()
    close(s.mean(), float(t.mean()), rtol=0, atol=0.03)
    close(s.var(), float(t.variance()), rtol=0.05)
    with pytest.raises(ValueError, match="event shape"):
        td.HeterogeneousMixture(log_weights=torch.zeros(2), components=(
            td.Normal(0.0, 1.0), td.MultivariateNormal(torch.zeros(2), torch.eye(2))))


def test_mixture_scalar_oracle():
    """tests/test_dists_combinators.py::test_mixture_scalar."""
    mix = td.Mixture(log_weights=torch.log(T([0.3, 0.7])), component=td.Normal(T([-2.0, 3.0]), T([1.0, 0.5])))
    x = np.linspace(-6, 6, 31)
    close(mix.log_prob(T(x)).numpy(), np.log(0.3 * st.norm(-2, 1).pdf(x) + 0.7 * st.norm(3, 0.5).pdf(x)),
          rtol=1e-8)
    close(float(mix.mean()), 0.3 * -2 + 0.7 * 3, rtol=1e-10)
    close(float(mix.variance()), 0.3 * (1 + 4) + 0.7 * (0.25 + 9) - (0.3 * -2 + 0.7 * 3) ** 2, rtol=1e-10)
    s = mix.sample(torch.Generator().manual_seed(0), (100_000,)).numpy()
    close(s.mean(), float(mix.mean()), rtol=0, atol=0.02)
    close(mix.cdf(T(x)).numpy(), 0.3 * st.norm(-2, 1).cdf(x) + 0.7 * st.norm(3, 0.5).cdf(x), rtol=1e-8)


def test_mixture_multivariate_oracle():
    locs, covs = T([[0.0, 0.0], [4.0, 4.0]]), torch.stack([torch.eye(2), 0.5 * torch.eye(2)]).double()
    mix = td.Mixture(log_weights=torch.log(T([0.5, 0.5])), component=td.MultivariateNormal(locs, covs))
    x = np.asarray([[0.0, 0.0], [4.0, 4.0], [2.0, 2.0]])
    want = np.log(0.5 * st.multivariate_normal([0, 0], np.eye(2)).pdf(x)
                  + 0.5 * st.multivariate_normal([4, 4], 0.5 * np.eye(2)).pdf(x))
    close(mix.log_prob(T(x)).numpy(), want, rtol=1e-8)


def test_mixture_quantile_roundtrip():
    mix = td.Mixture(log_weights=torch.log(T([0.3, 0.7])), component=td.Normal(T([-1.0, 2.0]), T([0.5, 1.0])))
    q = T([0.05, 0.5, 0.95])
    x = mix.quantile(q)
    close(mix.cdf(x).numpy(), q.numpy(), rtol=0, atol=1e-9)
    assert np.all(np.diff(x.numpy()) > 0)


# ---------------------------------------------------------------------------
# Censored
# ---------------------------------------------------------------------------

CENSORED = [(-1.0, 2.0), (-np.inf, 1.0), (-0.5, np.inf)]


@pytest.mark.parametrize("low,high", CENSORED, ids=["both", "top", "bottom"])
def test_censored_matches_jax(low, high):
    j = jd.Censored(jd.Normal(0.5, 1.2), low=low, high=high)
    t = td.Censored(td.Normal(T(0.5), T(1.2)), low=T(low), high=T(high))
    x = np.concatenate([np.linspace(-3, 3, 25), [low, high, -1.5, 2.5]])
    x = x[np.isfinite(x)]
    close(t.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))
    close(t.cdf(T(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))), atol=1e-16)


def test_censored_log_prob_matches_manual_normal():
    from scipy.stats import norm

    c = td.Censored(td.Normal(T(0.5), T(1.2)), low=-1.0, high=2.0)
    close(float(c.log_prob(T(0.3))), norm.logpdf(0.3, 0.5, 1.2))
    close(float(c.log_prob(T(-1.0))), norm.logcdf(-1.0, 0.5, 1.2), rtol=1e-7)
    close(float(c.log_prob(T(2.0))), norm.logsf(2.0, 0.5, 1.2), rtol=1e-7)
    interior, _ = integrate.quad(lambda v: norm.pdf(v, 0.5, 1.2), -1.0, 2.0)
    total = np.exp(float(c.log_prob(T(-1.0)))) + interior + np.exp(float(c.log_prob(T(2.0))))
    close(total, 1.0, rtol=1e-9)
    assert bool(is_log_zero(c.log_prob(T(2.5))))


def test_censored_sampling_piles_mass_on_bounds():
    from scipy.stats import norm

    c = td.Censored(td.Normal(T(0.0), T(1.0)), low=-0.5, high=1.0)
    s = c.sample(torch.Generator().manual_seed(0), (200_000,)).numpy()
    close((s == -0.5).mean(), norm.cdf(-0.5), rtol=0, atol=0.005)
    close((s == 1.0).mean(), norm.sf(1.0), rtol=0, atol=0.005)
    assert np.all((s >= -0.5) & (s <= 1.0))
    close(float(c.cdf(T(-0.5))), norm.cdf(-0.5), rtol=1e-6)
    assert float(c.cdf(T(-0.51))) == 0.0
    assert float(c.cdf(T(1.0))) == 1.0


def test_tobit_regression_recovers_slope():
    """Top-coded linear data: the censored likelihood recovers the slope
    where a plain Gaussian fit is biased low."""
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.models import define_inference_problem

    rng = np.random.default_rng(0)
    n = 300
    x = T(rng.uniform(-2, 2, size=n))
    y = torch.clamp(1.4 * x + 0.3 + 0.4 * T(rng.normal(size=n)), max=1.0)

    def make(censored):
        def ll(th):
            base = td.Normal(th[0] * x + th[1], th[2])
            return torch.sum((td.Censored(base, high=1.0) if censored else base).log_prob(y))

        return define_inference_problem(parameters=[("a", -5.0, 5.0), ("b", -5.0, 5.0), ("s", 0.05, 3.0)],
                                        log_likelihood=ll, prior_distribution=["location", "location", "scale"],
                                        validate=False, device="cpu", dtype=torch.float64)

    a_c = float(laplace_posterior_fit(problem=make(True), generator=torch.Generator().manual_seed(1)).mean[0])
    a_n = float(laplace_posterior_fit(problem=make(False), generator=torch.Generator().manual_seed(1)).mean[0])
    assert abs(a_c - 1.4) < 0.1 and abs(a_c - 1.4) < abs(a_n - 1.4), (a_c, a_n)


# ---------------------------------------------------------------------------
# GaussianKDE
# ---------------------------------------------------------------------------


def test_kde_fit_density_and_mean_match_jax():
    rng = np.random.default_rng(0)
    pts, lw = rng.normal(size=(300, 2)), rng.normal(size=300)
    j = jd.GaussianKDE.fit(jnp.asarray(pts), jnp.asarray(lw))
    t = td.GaussianKDE.fit(T(pts), T(lw))
    close(t.bandwidth.numpy(), np.asarray(j.bandwidth))
    x = rng.normal(size=(7, 2)) * 2
    close(t.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))
    close(t.mean().numpy(), np.asarray(j.mean()))
    k = gaussian_kde_from_numpy(j, device="cpu")
    close(k.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))


def test_kde_of_one_dimensional_samples_is_one_dimensional():
    rng = np.random.default_rng(1)
    s = rng.normal(size=200)
    j, t = jd.GaussianKDE.fit(jnp.asarray(s)), td.GaussianKDE.fit(T(s))
    assert t.points.shape == (200, 1) and t.event_shape == (1,)
    close(t.log_prob(T(s[:5, None])).numpy(), np.asarray(j.log_prob(jnp.asarray(s[:5, None]))))


def test_silverman_bandwidth_matches_jax():
    from bayesianinference_tpu.dists.empirical import silverman_bandwidth as jsb

    rng = np.random.default_rng(2)
    p, w = rng.normal(size=(50, 3)), rng.uniform(size=50)
    close(silverman_bandwidth(T(p), T(w)).numpy(), np.asarray(jsb(jnp.asarray(p), jnp.asarray(w))))
    close(silverman_bandwidth(T(p)).numpy(), np.asarray(jsb(jnp.asarray(p))))


def test_kde_sampler_replays_jax_on_its_indices_and_normals():
    rng = np.random.default_rng(3)
    j = jd.GaussianKDE.fit(jnp.asarray(rng.normal(size=(100, 2))), jnp.asarray(rng.normal(size=100)))
    t = gaussian_kde_from_numpy(j, device="cpu")
    key = jax.random.PRNGKey(9)
    want = np.asarray(j.sample(key, (50,)))
    k1, k2 = jax.random.split(key)
    idx = jax.random.categorical(k1, j._norm_logw(), shape=(50,))
    normals = jax.random.normal(k2, (50, 2), jnp.float64)
    got = t.sample(None, (50,), indices=torch.tensor(np.asarray(idx)), normals=T(normals))
    close(got.numpy(), want)


def test_empirical_and_kde_oracle():
    """tests/test_dists_conjugate_expfam.py::test_empirical_and_kde."""
    pts = T(np.random.default_rng(0).normal(size=(500, 2)))
    emp = td.Empirical(points=pts, log_weights=torch.zeros(500, dtype=torch.float64))
    close(emp.mean().numpy(), pts.numpy().mean(0), rtol=1e-10)
    assert emp.sample(torch.Generator().manual_seed(0), (1000,)).shape == (1000, 2)
    kde = td.GaussianKDE.fit(pts)
    lp = float(kde.log_prob(torch.zeros((1, 2), dtype=torch.float64))[0])
    ref = st.gaussian_kde(pts.numpy().T).logpdf(np.zeros((2, 1)))[0]
    assert np.isfinite(lp) and abs(lp - ref) < 0.5
    s = kde.sample(torch.Generator().manual_seed(1), (4000,)).numpy()
    close(s.mean(0), kde.mean().numpy(), rtol=0, atol=0.06)


# ---------------------------------------------------------------------------
# Exponential families
# ---------------------------------------------------------------------------

# family, standard parameters, points, (chi, nu) of a conjugate prior (None: no closed form)
EXPFAM = [
    ("EXPONENTIAL", (1.7,), np.linspace(0.1, 5, 17), ([4.0], 3.0)),
    ("NORMAL", (0.8, 2.2), np.linspace(-3, 5, 17), ([3.0, 8.0], 4.0)),
    ("POISSON", (3.1,), np.arange(0, 10, dtype=float), ([5.0], 2.0)),
    ("LOG_NORMAL", (0.4, 0.5), np.linspace(0.1, 5, 17), ([1.0, 2.0], 3.0)),
    ("GAMMA", (2.3, 1.7), np.linspace(0.1, 6, 17), None),
    ("INVERSE_GAMMA", (3.2, 1.4), np.linspace(0.1, 6, 17), None),
]


@pytest.mark.parametrize("name,std,x,conj", EXPFAM, ids=[e[0] for e in EXPFAM])
def test_expfam_functions_match_jax(name, std, x, conj):
    j, t = getattr(jd, name), getattr(td, name)
    eta_j = j.natural_parameters(*(jnp.asarray(v) for v in std))
    eta_t = t.natural_parameters(*(T(v) for v in std))
    close(eta_t.numpy(), np.asarray(eta_j))
    close(float(t.log_partition(eta_t)), float(j.log_partition(eta_j)))
    close(t.sufficient_statistic(T(x)).numpy(), np.asarray(j.sufficient_statistic(jnp.asarray(x))))
    # lgamma(2) is 0 in torch and -8.9e-16 in XLA
    close(t.log_base_measure(T(x)).numpy(), np.asarray(j.log_base_measure(jnp.asarray(x))), atol=1e-14)
    close(t.log_pdf(T(x), eta_t).numpy(), np.asarray(j.log_pdf(jnp.asarray(x), eta_j)), atol=1e-14)
    if t.natural_parameter_support is not None:
        assert bool(t.natural_parameter_support(eta_t)) == bool(j.natural_parameter_support(eta_j))
    if t.parameter_support is not None:
        assert bool(t.parameter_support(*(T(v) for v in std))) == bool(j.parameter_support(*std))
    assert t.natural_parameter_count == j.natural_parameter_count and t.name == j.name


@pytest.mark.parametrize("name,std,x,conj", EXPFAM, ids=[e[0] for e in EXPFAM])
def test_expfam_conjugate_update_and_densities_match_jax(name, std, x, conj):
    j, t = getattr(jd, name), getattr(td, name)
    chi0, nu0 = conj if conj is not None else ([0.5, 1.0], 1.0)
    data = x[:5]
    chi_j, nu_j = jd.conjugate_update(j, jnp.asarray(chi0), nu0, jnp.asarray(data))
    chi_t, nu_t = td.conjugate_update(t, T(chi0), nu0, T(data))
    close(chi_t.numpy(), np.asarray(chi_j))
    close(float(nu_t), float(nu_j))
    eta = np.asarray(j.natural_parameters(*(jnp.asarray(v) for v in std)))
    close(float(t.log_conjugate_kernel(T(eta), chi_t, nu_t)), float(j.log_conjugate_kernel(jnp.asarray(eta), chi_j, nu_j)))
    if conj is None:
        with pytest.raises(NotImplementedError):
            t.log_conjugate_pdf(T(eta), chi_t, nu_t)
        with pytest.raises(NotImplementedError):
            t.log_predictive_pdf(T(1.0), chi_t, nu_t)
        return
    close(float(t.log_conjugate_partition(chi_t, nu_t)), float(j.log_conjugate_partition(chi_j, nu_j)))
    close(float(t.log_conjugate_pdf(T(eta), chi_t, nu_t)), float(j.log_conjugate_pdf(jnp.asarray(eta), chi_j, nu_j)))
    close(t.log_predictive_pdf(T(x), chi_t, nu_t).numpy(), np.asarray(j.log_predictive_pdf(jnp.asarray(x), chi_j, nu_j)))


def test_bound_gamma_shape_matches_jax():
    j, t = jd.bind_gamma_shape(3.0), td.bind_gamma_shape(T(3.0))
    x = np.linspace(0.1, 6, 13)
    eta_j, eta_t = j.natural_parameters(3.0, 2.0), t.natural_parameters(T(3.0), T(2.0))
    close(t.log_pdf(T(x), eta_t).numpy(), np.asarray(j.log_pdf(jnp.asarray(x), eta_j)))
    chi_j, nu_j = jd.conjugate_update(j, jnp.asarray([2.0]), 1.0, jnp.asarray(x[:4]))
    chi_t, nu_t = td.conjugate_update(t, T([2.0]), 1.0, T(x[:4]))
    close(t.log_predictive_pdf(T(x), chi_t, nu_t).numpy(), np.asarray(j.log_predictive_pdf(jnp.asarray(x), chi_j, nu_j)))
    close(t.log_pdf(T(x), eta_t).numpy(), st.gamma(3.0, scale=0.5).logpdf(x), rtol=1e-8)


def test_expfam_canonical_pdfs_oracle():
    for fam, dist, std in [(td.EXPONENTIAL, st.expon(scale=1 / 1.7), (1.7,)),
                           (td.NORMAL, st.norm(0.8, np.sqrt(2.2)), (0.8, 2.2)),
                           (td.POISSON, st.poisson(3.1), (3.1,)),
                           (td.LOG_NORMAL, st.lognorm(np.sqrt(0.5), scale=np.exp(0.4)), (0.4, 0.5)),
                           (td.GAMMA, st.gamma(2.3, scale=1.7), (2.3, 1.7)),
                           (td.INVERSE_GAMMA, st.invgamma(3.2, scale=1.4), (3.2, 1.4))]:
        eta = fam.natural_parameters(*(T(v) for v in std))
        if fam.name == "Poisson":
            x = np.arange(0, 10, dtype=float)
            want = dist.logpmf(x.astype(int))
        else:
            x = np.linspace(0.1, 5, 17)
            want = dist.logpdf(x)
        close(fam.log_pdf(T(x), eta).numpy(), want, rtol=1e-8)
    assert not bool(td.GAMMA.natural_parameter_support(T([-1.5, -1.0])))
    assert not bool(td.INVERSE_GAMMA.natural_parameter_support(T([-0.5, -1.0])))


def test_expfam_conjugate_partition_vs_quadrature():
    num, _ = integrate.quad(lambda e: np.exp(e * 4.0 + 3.0 * np.log(-e)), -np.inf, 0)
    close(float(td.EXPONENTIAL.log_conjugate_partition(T([4.0]), 3.0)), np.log(num), rtol=1e-6)
    num, _ = integrate.quad(lambda e: np.exp(e * 5.0 - 2.0 * np.exp(e)), -50, 20)
    close(float(td.POISSON.log_conjugate_partition(T([5.0]), 2.0)), np.log(num), rtol=1e-6)

    def integrand(e2, e1):
        a = -(e1**2) / (4 * e2) - 0.5 * np.log(-2 * e2)
        return np.exp(e1 * 3.0 + e2 * 8.0 - 4.0 * a)

    num, _ = integrate.dblquad(integrand, -20, 20, -60, -1e-6)
    close(float(td.NORMAL.log_conjugate_partition(T([3.0, 8.0]), 4.0)), np.log(num), rtol=1e-4)


def test_expfam_predictive_matches_negative_binomial():
    chi, nu = td.conjugate_update(td.POISSON, T([1.0]), 1.0, T([2.0, 4.0, 3.0]))
    close(chi.numpy(), [10.0])
    assert float(nu) == 4.0
    x = np.arange(0, 12, dtype=float)
    r, p = 10.0, 4.0 / 5.0
    want = gammaln(x + r) - gammaln(r) - gammaln(x + 1) + r * np.log(p) + x * np.log(1 - p)
    close(td.POISSON.log_predictive_pdf(T(x), chi, nu).numpy(), want, rtol=1e-8)


def test_expfam_gamma_conjugate_update_and_quadrature_predictive():
    fam = td.GAMMA
    data = np.array([1.2, 0.7, 2.5])
    chi, nu = td.conjugate_update(fam, T([0.5, 1.0]), 1.0, T(data))
    close(chi.numpy(), [0.5 + np.sum(np.log(data)), 1.0 + data.sum()])
    assert float(nu) == 4.0
    close(float(fam.log_conjugate_kernel(T([1.0, -2.0]), chi, float(nu))),
          1.0 * float(chi[0]) - 2.0 * float(chi[1]) - float(nu) * float(fam.log_partition(T([1.0, -2.0]))))

    def kernel_integral(c, nu_):
        def f(e2, e1):
            a = gammaln(e1 + 1.0) - (e1 + 1.0) * np.log(-e2)
            return np.exp(e1 * c[0] + e2 * c[1] - nu_ * a)

        return integrate.dblquad(f, -0.95, 8.0, -30.0, -1e-3)[0]

    c = chi.numpy()
    denom = kernel_integral(c, float(nu))
    xs = np.linspace(1e-3, 12, 40)
    ys = [kernel_integral(c + np.array([np.log(v), v]), float(nu) + 1.0) / denom for v in xs]
    close(np.trapezoid(ys, xs), 1.0, rtol=2e-2)


def test_normal_family_predictive_is_the_conjugate_engine_predictive():
    """expfam.NORMAL's (chi, nu) prior is NIG(chi1 / nu, nu, (chi2 - chi1^2 / nu) / 2,
    nu / 2 + 3 / 2): its update and predictive are the conjugate Normal engine's."""
    from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu_torch.engines.conjugate import normal_conjugate_model

    chi0, nu0 = T([1.5, 6.0]), 2.0
    data = T(np.random.default_rng(4).normal(1.0, 1.3, size=25))
    prior = NormalInverseGamma(mu0=chi0[0] / nu0, lam=T(nu0), beta=(chi0[1] - chi0[0] ** 2 / nu0) / 2,
                               nu=T(nu0 / 2 + 1.5))
    fit = normal_conjugate_model(data, prior=prior)
    chi, nu = td.conjugate_update(td.NORMAL, chi0, nu0, data)
    x = T(np.linspace(-3, 5, 9))
    close(td.NORMAL.log_predictive_pdf(x, chi, nu).numpy(), fit.posterior_predictive.log_prob(x).numpy())
    close(float(chi[0] / nu), float(fit.posterior.mu0))
