"""The port's scalar families (``dists/scalar.py``: the twelve beyond the
first slices, and ``Beta.cdf`` and ``StudentT.cdf``) and its regularized
incomplete beta (``core.numerics.betainc``) against the JAX package, on the
CPU in float64.

Parity tests put the same parameters and points through both packages:
``log_prob``, ``cdf``, ``icdf`` (closed form or the shared 80-step
bisection) and ``mean``/``variance`` at rtol 1e-12, one table of families
as ``tests/test_dists_scalar.py`` has; the inverse-CDF samplers draw for
draw on the JAX draws (its U[0, 1) numbers, standard Gumbel and
exponential draws).  Oracle tests hold the port to the oracles of
``tests/test_dists_scalar.py`` (scipy), one counterpart each; the Poisson,
binomial and negative-binomial samplers (``torch.poisson`` and
``torch.binomial`` on the generator) to its moment gates.

``betainc`` is held to scipy on the grid a, b in {0.05, 0.5, 1, 5, 50,
500, 5000} and 29 points x in (0, 1), 1e-12 and 1 - 1e-12 among them, per
(a, b) cell (the largest error over x): in float64 at most
max(2 x JAX's error in that cell, 1e-13); in float32 at most 2 x JAX's
float32 error in that cell + 1e-6, both against scipy at the float32
inputs (1 - 1e-12 is 1 there).  ``tests/data/betainc_jax_error.json``
holds JAX's errors for ``chip_smoke.py`` (no JAX on the card's machine);
a test holds it equal to the live measurement and ``python
tests/test_torch_scalar_families.py`` rewrites it.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.core import numerics
from bayesianinference_tpu_torch.core.numerics import BETAINC_TERMS, betainc, is_log_zero

torch.set_num_threads(1)
RTOL = 1e-12
BETAINC_ERRORS = Path(__file__).parent / "data" / "betainc_jax_error.json"
AB = (0.05, 0.5, 1.0, 5.0, 50.0, 500.0, 5000.0)
X = (1e-12, 1e-8, 1e-4, 1e-3, 0.01, 0.05, *np.linspace(0.1, 0.9, 17).tolist(), 0.95, 0.99, 0.999,
     1 - 1e-4, 1 - 1e-8, 1 - 1e-12)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=1e-300):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def pair(name, params):
    """The JAX family and the port's, on the same float64 parameters."""
    return getattr(jd, name)(**params), getattr(td, name)(**{k: T(v) for k, v in params.items()})


# name, parameters, grid range, (cdf, icdf, moments): the new families with
# tests/test_dists_scalar.py's parameters and ranges, Beta and StudentT for their new CDFs
FAMILIES = [
    ("Exponential", dict(rate=2.5), (0.01, 4), (True, True)),
    ("HalfCauchy", dict(scale=2.0), (0.01, 10), (True, True, False)),
    ("Laplace", dict(loc=-1.0, scale=2.0), (-8, 6), (True, True)),
    ("Weibull", dict(k=1.7, scale=2.0), (0.05, 7), (True, True)),
    ("Logistic", dict(loc=0.5, scale=1.2), (-7, 8), (True, True)),
    ("ChiSquared", dict(df=5.0), (0.1, 18), (True, True)),
    ("Gumbel", dict(loc=1.0, scale=2.0), (-5, 12), (True, True)),
    ("Pareto", dict(xmin=1.5, alpha=5.0), (1.55, 12), (True, True)),
    ("Poisson", dict(rate=3.5), (0, 14), (False, False)),
    ("Binomial", dict(n=10.0, p=0.3), (0, 10), (False, False)),
    ("NegativeBinomial", dict(r=4.0, p=0.35), (0, 24), (False, False)),
    ("Geometric", dict(p=0.3), (0, 24), (False, False)),
    ("Beta", dict(a=2.0, b=5.0), (0.01, 0.99), (True, True)),
    ("StudentT", dict(df=4.0, loc=1.0, scale=2.0), (-8, 10), (True, True)),
]
IDS = [f[0] for f in FAMILIES]
DISCRETE = {"Poisson", "Binomial", "NegativeBinomial", "Geometric"}
WITH_CDF = [f for f in FAMILIES if f[3][0]]
WITH_ICDF = [f for f in FAMILIES if f[3][1]]
WITH_MOMENTS = [f for f in FAMILIES if f[3][-1]]


def _grid(name, rng_):
    if name in DISCRETE:
        x = np.arange(rng_[0], rng_[1] + 1, dtype=float)
        return np.concatenate([x, [-1.0, 2.5, rng_[1] + 0.5]])  # off the support and between integers
    x = np.linspace(*rng_, 41)
    return np.concatenate([x, [rng_[0] - 20.0, -1.0]])


@pytest.mark.parametrize("name,params,rng_,api", FAMILIES, ids=IDS)
def test_log_prob_matches_jax(name, params, rng_, api):
    j, t = pair(name, params)
    x = _grid(name, rng_)
    close(t.log_prob(T(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))


@pytest.mark.parametrize("name,params,rng_,api", WITH_CDF, ids=[f[0] for f in WITH_CDF])
def test_cdf_matches_jax(name, params, rng_, api):
    j, t = pair(name, params)
    x = np.concatenate([np.linspace(*rng_, 17), [rng_[0] - 5.0, rng_[1] + 5.0]])
    close(t.cdf(T(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))), atol=1e-15)


@pytest.mark.parametrize("name,params,rng_,api", WITH_ICDF, ids=[f[0] for f in WITH_ICDF])
def test_icdf_matches_jax(name, params, rng_, api):
    j, t = pair(name, params)
    q = np.linspace(0.05, 0.95, 10)
    close(t.icdf(T(q)).numpy(), np.asarray(j.icdf(jnp.asarray(q))), atol=1e-13)


@pytest.mark.parametrize("name,params,rng_,api", WITH_MOMENTS, ids=[f[0] for f in WITH_MOMENTS])
def test_moments_match_jax(name, params, rng_, api):
    j, t = pair(name, params)
    close(float(t.mean()), float(j.mean()))
    close(float(t.variance()), float(j.variance()))


def test_heavy_tail_moments_are_inf_or_nan_as_in_jax():
    for name, params in (("Pareto", dict(xmin=1.0, alpha=0.5)), ("Pareto", dict(xmin=1.0, alpha=1.5)),
                         ("StudentT", dict(df=1.5)), ("StudentT", dict(df=0.8))):
        j, t = pair(name, params)
        np.testing.assert_array_equal(float(t.mean()), float(j.mean()))
        np.testing.assert_array_equal(float(t.variance()), float(j.variance()))


# inverse-CDF samplers: the input the port takes, made from the JAX key as JAX draws it
REPLAYS = [
    ("Laplace", dict(loc=-1.0, scale=2.0), "uniforms", jax.random.uniform),
    ("HalfCauchy", dict(scale=2.0), "uniforms", jax.random.uniform),
    ("Weibull", dict(k=1.7, scale=2.0), "uniforms", jax.random.uniform),
    ("Logistic", dict(loc=0.5, scale=1.2), "uniforms", jax.random.uniform),
    ("Pareto", dict(xmin=1.5, alpha=5.0), "uniforms", jax.random.uniform),
    ("Geometric", dict(p=0.3), "uniforms", jax.random.uniform),
    ("Gumbel", dict(loc=1.0, scale=2.0), "gumbels", jax.random.gumbel),
    ("Exponential", dict(rate=2.5), "exponentials", jax.random.exponential),
]


@pytest.mark.parametrize("name,params,keyword,draw", REPLAYS, ids=[r[0] for r in REPLAYS])
def test_inverse_cdf_sampler_replays_jax_draw_for_draw(name, params, keyword, draw):
    j, t = pair(name, params)
    key = jax.random.PRNGKey(7)
    want = np.asarray(j.sample(key, (2000,)))
    got = t.sample(None, (2000,), **{keyword: T(draw(key, (2000,), jnp.float64))}).numpy()
    # a draw near 0 (loc + a term of about -loc) keeps the absolute error of its terms
    close(got, want, atol=1e-13)


# tests/test_dists_scalar.py's oracles, one counterpart each (its CASES)
CASES = [
    (td.Normal(loc=T(1.5), scale=T(2.0)), st.norm(1.5, 2.0), (-5, 8)),
    (td.Uniform(low=T(-1.0), high=T(3.0)), st.uniform(-1.0, 4.0), (-0.9, 2.9)),
    (td.Exponential(rate=T(2.5)), st.expon(scale=1 / 2.5), (0.01, 4)),
    (td.Gamma(a=T(3.0), rate=T(2.0)), st.gamma(3.0, scale=1 / 2.0), (0.05, 6)),
    (td.InverseGamma(a=T(3.0), b=T(2.0)), st.invgamma(3.0, scale=2.0), (0.05, 6)),
    (td.Beta(a=T(2.0), b=T(5.0)), st.beta(2.0, 5.0), (0.01, 0.99)),
    (td.StudentT(df=T(4.0), loc=T(1.0), scale=T(2.0)), st.t(4.0, 1.0, 2.0), (-8, 10)),
    (td.Cauchy(loc=T(0.5), scale=T(1.5)), st.cauchy(0.5, 1.5), (-10, 10)),
    (td.HalfCauchy(scale=T(2.0)), st.halfcauchy(scale=2.0), (0.01, 10)),
    (td.LogNormal(loc=T(0.3), scale=T(0.8)), st.lognorm(0.8, scale=np.exp(0.3)), (0.05, 8)),
    (td.Laplace(loc=T(-1.0), scale=T(2.0)), st.laplace(-1.0, 2.0), (-8, 6)),
    (td.Weibull(k=T(1.7), scale=T(2.0)), st.weibull_min(1.7, scale=2.0), (0.05, 7)),
    (td.Logistic(loc=T(0.5), scale=T(1.2)), st.logistic(0.5, 1.2), (-7, 8)),
    (td.ChiSquared(df=T(5.0)), st.chi2(5.0), (0.1, 18)),
    (td.Gumbel(loc=T(1.0), scale=T(2.0)), st.gumbel_r(1.0, 2.0), (-5, 12)),
    (td.Pareto(xmin=T(1.5), alpha=T(5.0)), st.pareto(5.0, scale=1.5), (1.55, 12)),
]
CASE_IDS = [type(c[0]).__name__ for c in CASES]


@pytest.mark.parametrize("ours,ref,rng_", CASES, ids=CASE_IDS)
def test_logpdf_vs_scipy(ours, ref, rng_):
    x = np.linspace(*rng_, 41)
    close(ours.log_prob(T(x)).numpy(), ref.logpdf(x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("ours,ref,rng_", CASES, ids=CASE_IDS)
def test_cdf_vs_scipy(ours, ref, rng_):
    x = np.linspace(*rng_, 17)
    close(ours.cdf(T(x)).numpy(), ref.cdf(x), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ours,ref,rng_", CASES, ids=CASE_IDS)
def test_icdf_roundtrip(ours, ref, rng_):
    q = np.linspace(0.05, 0.95, 10)
    close(ours.cdf(ours.icdf(T(q))).numpy(), q, rtol=1e-5, atol=1e-6)


WITH_STATS = [c for c in CASES if not isinstance(c[0], (td.Cauchy, td.HalfCauchy))]  # no moments


@pytest.mark.parametrize("ours,ref,rng_", WITH_STATS, ids=[type(c[0]).__name__ for c in WITH_STATS])
def test_sampling_moments(ours, ref, rng_):
    s = ours.sample(torch.Generator().manual_seed(0), (200_000,)).numpy()
    m_ref, v_ref = ref.stats()
    close(s.mean(), m_ref, rtol=0.05, atol=0.02)
    close(s.var(), v_ref, rtol=0.1, atol=0.05)


def test_out_of_support_is_logzero():
    assert bool(is_log_zero(td.Exponential(T(1.0)).log_prob(T(-1.0))))
    assert bool(is_log_zero(td.Uniform(T(0.0), T(1.0)).log_prob(T(2.0))))
    assert bool(is_log_zero(td.Gamma(T(2.0), T(1.0)).log_prob(T(-0.5))))
    assert bool(is_log_zero(td.Beta(T(2.0), T(2.0)).log_prob(T(1.5))))


def test_poisson_logpmf():
    x = np.arange(0, 15, dtype=float)
    ours = td.Poisson(rate=T(3.5))
    close(ours.log_prob(T(x)).numpy(), st.poisson(3.5).logpmf(x.astype(int)), rtol=1e-9)
    assert bool(is_log_zero(ours.log_prob(T(2.5))))
    assert bool(is_log_zero(ours.log_prob(T(-1.0))))


def test_binomial_logpmf():
    x = np.arange(0, 11, dtype=float)
    close(td.Binomial(n=T(10.0), p=T(0.3)).log_prob(T(x)).numpy(), st.binom(10, 0.3).logpmf(x.astype(int)),
          rtol=1e-9)


DISCRETE_CASES = [
    (td.NegativeBinomial(r=T(4.0), p=T(0.35)), st.nbinom(4, 0.35)),
    (td.Geometric(p=T(0.3)), st.geom(0.3, loc=-1)),  # scipy's geom counts trials
]


@pytest.mark.parametrize("ours,ref", DISCRETE_CASES, ids=lambda c: type(c).__name__)
def test_discrete_logpmf_vs_scipy(ours, ref):
    x = np.arange(0, 25, dtype=float)
    close(ours.log_prob(T(x)).numpy(), ref.logpmf(x.astype(int)), rtol=1e-7, atol=1e-9)
    assert bool(is_log_zero(ours.log_prob(T(2.5))))
    assert bool(is_log_zero(ours.log_prob(T(-1.0))))


# the samplers on the generator, held to tests/test_dists_scalar.py's discrete moment gates
MOMENT_CASES = [
    (td.NegativeBinomial(r=T(4.0), p=T(0.35)), st.nbinom(4, 0.35)),
    (td.Geometric(p=T(0.3)), st.geom(0.3, loc=-1)),
    (td.Poisson(rate=T(3.5)), st.poisson(3.5)),
    (td.Binomial(n=T(10.0), p=T(0.3)), st.binom(10, 0.3)),
]


@pytest.mark.parametrize("ours,ref", MOMENT_CASES, ids=lambda c: type(c).__name__)
def test_discrete_sampling_moments(ours, ref):
    s = ours.sample(torch.Generator().manual_seed(0), (200_000,)).numpy()
    m_ref, v_ref = ref.stats()
    close(s.mean(), m_ref, rtol=0.05)
    close(s.var(), v_ref, rtol=0.1)
    close(float(ours.mean()), m_ref, rtol=1e-9)
    close(float(ours.variance()), v_ref, rtol=1e-9)


def test_samplers_broadcast_parameters_and_keep_their_dtype():
    g = torch.Generator().manual_seed(1)
    for dist in (td.Poisson(rate=T([1.0, 5.0])), td.Binomial(n=T([3.0, 8.0]), p=T(0.5)),
                 td.NegativeBinomial(r=T([2.0, 6.0]), p=T(0.4)), td.Laplace(loc=T([0.0, 1.0]), scale=T(1.0))):
        s = dist.sample(g, (5, 2))
        assert s.shape == (5, 2) and s.dtype == torch.float64


# ---------------------------------------------------------------------------
# betainc
# ---------------------------------------------------------------------------


def _grid_arrays(dtype):
    a, b, x = (v.ravel() for v in np.meshgrid(AB, AB, X, indexing="ij"))
    a, b, x = (v.astype(dtype) for v in (a, b, x))
    return a, b, x, sps.betainc(a.astype(float), b.astype(float), x.astype(float))


def _cell_errors(got, want):
    return np.abs(np.asarray(got, float) - want).reshape(len(AB), len(AB), -1).max(axis=-1)


def jax_betainc_errors() -> dict:
    """JAX's betainc error against scipy per (a, b) cell of the grid, in
    float64 and float32."""
    out = {"a_b": list(AB), "x": list(X)}
    for name, dt in (("float64", np.float64), ("float32", np.float32)):
        a, b, x, ref = _grid_arrays(dt)
        got = jsp.betainc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x))
        out[name] = _cell_errors(got, ref).tolist()
    return out


@pytest.fixture(scope="module")
def jax_errors():
    return jax_betainc_errors()


def test_betainc_error_file_holds_the_live_jax_errors(jax_errors):
    assert json.loads(BETAINC_ERRORS.read_text()) == json.loads(json.dumps(jax_errors))


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["float64", "float32"])
def test_betainc_meets_its_gate_in_every_cell(dtype, jax_errors):
    a, b, x, ref = _grid_arrays(dtype)
    got = betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x))
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    err = _cell_errors(got.double().numpy(), ref)
    jax_err = np.asarray(jax_errors["float64" if dtype == np.float64 else "float32"])
    gate = np.maximum(2 * jax_err, 1e-13) if dtype == np.float64 else 2 * jax_err + 1e-6
    assert np.all(err <= gate), (err / gate).max()


def test_betainc_is_differentiable_in_x_and_ends_at_0_and_1():
    x = T([0.0, 0.3, 0.7, 1.0, -0.5, 1.5]).requires_grad_(True)
    v = betainc(T(2.0), T(3.0), x)
    v.sum().backward()
    close(v.detach().numpy(), [0.0, *sps.betainc(2.0, 3.0, [0.3, 0.7]), 1.0, 0.0, 1.0], rtol=1e-13, atol=1e-16)
    pdf = st.beta(2.0, 3.0).pdf([0.3, 0.7])
    close(x.grad.numpy()[1:3], pdf, rtol=1e-10)
    assert np.all(np.isfinite(x.grad.numpy()))


def test_betainc_depth_is_the_least_multiple_of_32_that_meets_the_gate(jax_errors, monkeypatch):
    a, b, x, ref = _grid_arrays(np.float64)
    gate = np.maximum(2 * np.asarray(jax_errors["float64"]), 1e-13)
    monkeypatch.setattr(numerics, "BETAINC_TERMS", BETAINC_TERMS - 32)
    shallower = betainc(T(a), T(b), T(x)).numpy()
    assert not np.all(_cell_errors(shallower, ref) <= gate)


def test_logit_families_match_jax_beyond_softplus_linear_threshold():
    """log(1 + e^z) in full at |z| > 20, as jax.nn.softplus has it
    (torch.nn.functional.softplus returns z there: 2e-9 off at z = 20)."""
    logits = np.array([-40.0, -21.0, -5.0, 0.0, 5.0, 21.0, 40.0])
    for x in (0.0, 1.0):
        close(td.BernoulliLogits(T(logits)).log_prob(T(x)).numpy(),
              np.asarray(jd.BernoulliLogits(jnp.asarray(logits)).log_prob(jnp.asarray(x))))
    z = np.array([-30.0, -21.0, 0.0, 21.0, 30.0])
    close(td.Logistic(T(0.0), T(1.0)).log_prob(T(z)).numpy(), np.asarray(jd.Logistic(0.0, 1.0).log_prob(jnp.asarray(z))))


def test_student_t_cdf_uses_jax_form_in_both_tails():
    j, t = pair("StudentT", dict(df=3.0, loc=0.0, scale=1.0))
    z = np.array([-1e3, -30.0, -3.0, -1e-8, 0.0, 1e-8, 3.0, 30.0, 1e3])
    close(t.cdf(T(z)).numpy(), np.asarray(j.cdf(jnp.asarray(z))), atol=1e-16)
    # accurate in the lower tail; at |z| = 1e-8 the form's w = v / (v + z^2) rounds to 1, in both packages
    close(t.cdf(T(z[:3])).numpy(), st.t(3.0).cdf(z[:3]), rtol=1e-12)


def write_betainc_errors():
    BETAINC_ERRORS.parent.mkdir(exist_ok=True)
    BETAINC_ERRORS.write_text(json.dumps(jax_betainc_errors(), indent=1) + "\n")
    print(f"wrote {BETAINC_ERRORS}")


if __name__ == "__main__":
    # under the suite's JAX settings: tests/conftest.py sets XLA's flags before JAX starts
    import os
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    subprocess.run([sys.executable, "-c", "import conftest, test_torch_scalar_families as t; t.write_betainc_errors()"],
                   cwd=here, env={**os.environ, "PYTHONPATH": str(here.parent)}, check=True)
