"""Parity of the PyTorch port's numerics, NS bookkeeping math and
distributions with the JAX package, on the CPU in float64.

Deterministic functions are held to rtol 1e-12: both sides evaluate the
same formulas in IEEE float64, so only the order of a few operations (and
libm differences in exp/log) separates them.  Sampling is held to the
closed-form moments, since the two frameworks' generators differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

from bayesianinference_tpu.core import numerics as jnum
from bayesianinference_tpu.core.containers import WeightedSamples as JWeightedSamples
from bayesianinference_tpu.core.containers import take_posterior_fraction as j_take_fraction
from bayesianinference_tpu.dists import combinators as jcomb
from bayesianinference_tpu.dists import scalar as jscalar
from bayesianinference_tpu.dists.empirical import Empirical as JEmpirical
from bayesianinference_tpu.dists.pointwise import PointwiseMixture as JPointwise
from bayesianinference_tpu.models import problem as jproblem
from bayesianinference_tpu.ops import ns_math as jns
from bayesianinference_tpu_torch.core import numerics as tnum
from bayesianinference_tpu_torch.core.containers import WeightedSamples, take_posterior_fraction
from bayesianinference_tpu_torch.dists import combinators as tcomb
from bayesianinference_tpu_torch.dists import scalar as tscalar
from bayesianinference_tpu_torch.dists.empirical import Empirical
from bayesianinference_tpu_torch.dists.pointwise import PointwiseMixture
from bayesianinference_tpu_torch.models import problem as tproblem
from bayesianinference_tpu_torch.ops import ns_math as tns

torch.set_num_threads(1)
RTOL = 1e-12


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_log_zero_and_guard():
    assert tnum.log_zero(torch.float64) == float(jnum.log_zero(jnp.float64))
    assert np.float32(tnum.log_zero(torch.float32)) == np.asarray(jnum.log_zero(jnp.float32))
    x = np.array([0.5, -np.inf, np.nan, -1e301, 3.0])
    close(tnum.guard_log_density(T(x)), jnum.guard_log_density(jnp.asarray(x)))
    np.testing.assert_array_equal(
        np.asarray(tnum.is_log_zero(T(x))), np.asarray(jnum.is_log_zero(jnp.asarray(x)))
    )


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_logsumexp(axis):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 6)) * 20
    a[1, 2] = -np.inf
    a[2, :] = float(jnum.log_zero(jnp.float64))
    b = rng.uniform(0.1, 2.0, size=(4, 6))
    close(tnum.logsumexp(T(a), dim=axis), jnum.logsumexp(jnp.asarray(a), axis=axis))
    close(tnum.logsumexp(T(a), dim=axis, b=T(b)), jnum.logsumexp(jnp.asarray(a), axis=axis, b=jnp.asarray(b)))


def test_logaddexp_logsubexp_xlogy():
    rng = np.random.default_rng(1)
    x = rng.normal(size=50) * 5
    y = x + np.abs(rng.normal(size=50))
    lz = float(jnum.log_zero(jnp.float64))
    x[:3] = lz
    close(tnum.logaddexp(T(x), T(y)), jnum.logaddexp(jnp.asarray(x), jnp.asarray(y)))
    close(tnum.logsubexp(T(y), T(x)), jnum.logsubexp(jnp.asarray(y), jnp.asarray(x)))
    close(tnum.logsubexp(T(x), T(y)), jnum.logsubexp(jnp.asarray(x), jnp.asarray(y)))
    close(tnum.logsubexp(np.log(2.0), T(-np.abs(x))), jnum.logsubexp(np.log(2.0), jnp.asarray(-np.abs(x))))
    u = np.abs(rng.normal(size=20))
    u[:4] = 0.0
    close(tnum.xlogy(T(u), T(np.abs(x[:20]) + 1)), jnum.xlogy(jnp.asarray(u), jnp.asarray(np.abs(x[:20]) + 1)))


def test_ns_math():
    sched_t = tns.pool_schedule(50, 7, 300, dtype=torch.float64)
    sched_j = jns.pool_schedule(50, 7, 300)
    close(sched_t, sched_j)
    lxd_t = tns.crude_log_x_deleted(sched_t)
    lxd_j = jns.crude_log_x_deleted(sched_j)
    close(lxd_t, lxd_j)
    close(tns.log_x_live_tail(50, lxd_t[-1], dtype=torch.float64), jns.log_x_live_tail(50, lxd_j[-1]))
    log_x = np.concatenate([np.asarray(lxd_j), np.asarray(jns.log_x_live_tail(50, lxd_j[-1]))])
    close(tns.log_trapezoid_weights(T(log_x)), jns.log_trapezoid_weights(jnp.asarray(log_x)))
    batch = np.stack([log_x, log_x - 0.3])
    valid = np.arange(batch.shape[1])[None, :] < np.array([[200], [311]])
    close(
        tns.log_trapezoid_weights(T(batch), torch.as_tensor(valid)),
        jns.log_trapezoid_weights(jnp.asarray(batch), jnp.asarray(valid)),
    )
    rng = np.random.default_rng(2)
    ll = rng.normal(size=log_x.shape) * 3
    lw = np.asarray(jns.log_trapezoid_weights(jnp.asarray(log_x))) + ll
    lzv = float(jnum.logsumexp(jnp.asarray(lw)))
    close(tns.entropy_from_weights(T(lw), T(ll), lzv), jns.entropy_from_weights(jnp.asarray(lw), jnp.asarray(ll), lzv))


def _pairs():
    return [
        (tscalar.Normal(T(0.3), T(1.7)), jscalar.Normal(0.3, 1.7)),
        (tscalar.Uniform(T(-2.0), T(3.0)), jscalar.Uniform(-2.0, 3.0)),
        (tscalar.LogUniform(T(0.05), T(5.0)), jscalar.LogUniform(0.05, 5.0)),
        (tscalar.Cauchy(T(0.5), T(2.0)), jscalar.Cauchy(0.5, 2.0)),
        (
            tcomb.Truncated(tscalar.Normal(0.0, 2.0), low=T(-1.0), high=T(3.0)),
            jcomb.Truncated(jscalar.Normal(0.0, 2.0), low=-1.0, high=3.0),
        ),
    ]


@pytest.mark.parametrize("i", range(5))
def test_scalar_log_prob_cdf_icdf(i):
    tdist, jdist = _pairs()[i]
    x = np.linspace(-4.0, 6.0, 41)
    close(tdist.log_prob(T(x)), jdist.log_prob(jnp.asarray(x)))
    q = np.linspace(0.01, 0.99, 17)
    close(tdist.icdf(T(q)), jdist.icdf(jnp.asarray(q)), rtol=1e-10)
    xin = np.asarray(jdist.icdf(jnp.asarray(q)))
    close(tdist.cdf(T(xin)), jdist.cdf(jnp.asarray(xin)), rtol=1e-10)


@pytest.mark.parametrize("i", range(5))
def test_scalar_sample_moments(i):
    """Sample mean and variance within 5 standard errors of the JAX
    density's, integrated on a fine grid (for Cauchy, the median)."""
    tdist, jdist = _pairs()[i]
    n = 40000
    s = tdist.sample(torch.Generator().manual_seed(i), (n,)).numpy()
    assert s.shape == (n,) and s.dtype == np.float64
    assert np.all(np.asarray(tdist.log_prob(torch.as_tensor(s))) > -1e299)
    if isinstance(tdist, tscalar.Cauchy):
        med = float(jdist.icdf(0.5))
        assert abs(np.median(s) - med) < 0.05 * 2.0
        return
    lo, hi = (float(b) for b in np.broadcast_to(jdist.support(), (2,)))
    lo, hi = max(lo, -12.0), min(hi, 12.0)
    grid = np.linspace(lo, hi, 400001)
    dens = np.exp(np.asarray(jdist.log_prob(jnp.asarray(grid))))
    dx = grid[1] - grid[0]
    m = np.sum(grid * dens) * dx
    v = np.sum((grid - m) ** 2 * dens) * dx
    assert abs(s.mean() - m) < 5 * np.sqrt(v / n)
    assert abs(s.var() - v) < 5 * v * np.sqrt(2.0 / n) + 1e-3 * v


def test_product_and_ignorance_prior():
    params = [("a", -5.0, 5.0), ("b", 0.01, 2.0), ("c", 0.0, 4.0)]
    specs = ["location", "scale", jscalar.Normal(1.0, 2.0)]
    jprior = jproblem.ignorance_prior(specs, params)
    tprior = tproblem.ignorance_prior(["location", "scale", tscalar.Normal(1.0, 2.0)], params,
                                      dtype=torch.float64)
    rng = np.random.default_rng(3)
    x = np.stack([rng.uniform(-6, 6, 30), rng.uniform(-0.5, 2.5, 30), rng.uniform(-1, 5, 30)], -1)
    close(tprior.log_prob(T(x)), jprior.log_prob(jnp.asarray(x)))
    lo_t, hi_t = tprior.support()
    lo_j, hi_j = jprior.support()
    close(lo_t, lo_j)
    close(hi_t, hi_j)
    s = tprior.sample(torch.Generator().manual_seed(0), (2000,))
    assert s.shape == (2000, 3) and s.dtype == torch.float64
    assert bool(tprior.log_prob(s).gt(-1e299).all())
    imp = tcomb.ImproperUniform(dim=3)
    close(imp.log_prob(T(x)), jcomb.ImproperUniform(dim=3).log_prob(jnp.asarray(x)))
    with pytest.raises(NotImplementedError):
        imp.sample(torch.Generator(), (2,))


def test_weighted_samples_and_empirical():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(60, 3))
    lw = rng.normal(size=60) * 2
    tw, jw = WeightedSamples(T(pts), T(lw)), JWeightedSamples(jnp.asarray(pts), jnp.asarray(lw))
    for name in ("normalized_weights", "mean", "cov", "var", "std_error", "effective_sample_size"):
        close(getattr(tw, name)(), getattr(jw, name)())
    close(take_posterior_fraction(tw, 0.7).log_weights, j_take_fraction(jw, 0.7).log_weights)
    te, je = Empirical(T(pts), T(lw)), JEmpirical(jnp.asarray(pts), jnp.asarray(lw))
    for name in ("mean", "variance", "covariance"):
        close(getattr(te, name)(), getattr(je, name)())
    xq = rng.normal(size=(5, 3))
    close(te.cdf(T(xq)), je.cdf(jnp.asarray(xq)))
    draws = te.sample(torch.Generator().manual_seed(1), (7,))
    assert draws.shape == (7, 3)


def test_pointwise_mixture():
    rng = np.random.default_rng(5)
    s_, m_ = 6, 4
    loc, scale = rng.normal(size=(s_, m_)), rng.uniform(0.2, 1.0, size=(s_, m_))
    lw = rng.normal(size=s_)
    tm = PointwiseMixture(T(lw), tscalar.Normal(loc=T(loc), scale=T(scale)))
    jm = JPointwise(jnp.asarray(lw), jscalar.Normal(loc=jnp.asarray(loc), scale=jnp.asarray(scale)))
    x = rng.normal(size=(3, m_))
    close(tm.log_prob(T(x)), jm.log_prob(jnp.asarray(x)))
    close(tm.cdf(T(x)), jm.cdf(jnp.asarray(x)))
    close(tm.mean(), jm.mean())
    close(tm.variance(), jm.variance())
    close(tm.quantile(T([0.1, 0.5, 0.9])), jm.quantile(jnp.asarray([0.1, 0.5, 0.9])), rtol=1e-9)
    assert tm.sample(torch.Generator().manual_seed(0), (5,)).shape == (5, m_)


@pytest.mark.parametrize("form", ["iid", "regression", "theta_data", "closure_constraint"])
def test_problem_densities_match_jax(form):
    """The guarded densities of ``define_inference_problem`` in each
    likelihood form, batched over [..., d] by vmap, against the JAX
    problem's vmapped per-point densities."""
    rng = np.random.default_rng(7)
    xs, ys = rng.normal(size=25), rng.normal(size=25) * 0.5 + 1.0
    params = [("a", -3.0, 3.0), ("s", 0.1, 4.0)]
    common = dict(parameters=params, prior_distribution=["location", "scale"])
    if form == "iid":
        t = tproblem.define_inference_problem(likelihood=lambda th: tscalar.Normal(th[0], th[1]), data=T(ys), **common)
        j = jproblem.define_inference_problem(likelihood=lambda th: jscalar.Normal(th[0], th[1]),
                                              data=jnp.asarray(ys), **common)
    elif form == "regression":
        t = tproblem.define_inference_problem(likelihood=lambda th, x: tscalar.Normal(th[0] * x, th[1]),
                                              data=T(ys), independent_variables=T(xs), **common)
        j = jproblem.define_inference_problem(likelihood=lambda th, x: jscalar.Normal(th[0] * x, th[1]),
                                              data=jnp.asarray(ys), independent_variables=jnp.asarray(xs),
                                              **common)
    elif form == "theta_data":
        t = tproblem.define_inference_problem(
            log_likelihood=lambda th, d: torch.sum(tscalar.Normal(th[0] + d[0], th[1]).log_prob(d[1])),
            data=(T(xs), T(ys)), **common)
        j = jproblem.define_inference_problem(
            log_likelihood=lambda th, d: jnp.sum(jscalar.Normal(th[0] + d[0], th[1]).log_prob(d[1])),
            data=(jnp.asarray(xs), jnp.asarray(ys)), **common)
    else:
        t = tproblem.define_inference_problem(
            log_likelihood=lambda th: -0.5 * torch.sum((th - 1.0) ** 2), constraint=lambda th: th[0] < th[1],
            device="cpu", dtype=torch.float64, **common)
        j = jproblem.define_inference_problem(
            log_likelihood=lambda th: -0.5 * jnp.sum((th - 1.0) ** 2), constraint=lambda th: th[0] < th[1],
            **common)
    theta = np.stack([rng.uniform(-4, 4, 60), rng.uniform(-0.5, 5, 60)], -1)
    for name in ("guarded_log_likelihood", "guarded_log_prior", "log_posterior_density"):
        got = getattr(t, name)(T(theta.reshape(3, 20, 2)))
        assert got.shape == (3, 20)
        want = __import__("jax").vmap(getattr(j, name))(jnp.asarray(theta))
        close(got.reshape(-1), want)
    assert t.param_names == ("a", "s") and t.dim == 2
    if t.data is not None:
        moved = t.with_data((t.data[0], t.data[1] + 1.0) if isinstance(t.data, tuple) else t.data + 1.0)
        assert not torch.equal(moved.guarded_log_likelihood(T(theta[:5])), t.guarded_log_likelihood(T(theta[:5])))


def test_validate_problem_rejects_nan_and_all_log_zero():
    params = [("a", -1.0, 1.0)]
    with pytest.raises(ValueError, match="NaN"):
        tproblem.define_inference_problem(parameters=params, log_likelihood=lambda th: th[0] * float("nan"),
                                          prior_distribution=["location"], device="cpu",
                                          dtype=torch.float64)
    with pytest.raises(ValueError, match="log-zero on ALL"):
        tproblem.define_inference_problem(parameters=params, log_likelihood=lambda th: th[0] * 0.0 - 1e300,
                                          prior_distribution=["location"], device="cpu",
                                          dtype=torch.float64)
    with pytest.raises(ValueError, match="with_data"):
        tproblem.define_inference_problem(parameters=params, log_likelihood=lambda th: th[0],
                                          prior_distribution=["location"], device="cpu",
                                          dtype=torch.float64).with_data(T([1.0]))


# --- the families, numerics and combinator of the conjugate engines


def _conjugate_pairs():
    return {
        "gamma": (tscalar.Gamma(T(2.5), T(1.5)), jscalar.Gamma(2.5, 1.5)),
        "inverse_gamma": (tscalar.InverseGamma(T(3.5), T(2.0)), jscalar.InverseGamma(3.5, 2.0)),
        "beta": (tscalar.Beta(T(2.0), T(3.5)), jscalar.Beta(2.0, 3.5)),
        "student_t": (tscalar.StudentT(T(4.5), T(0.3), T(1.2)), jscalar.StudentT(4.5, 0.3, 1.2)),
    }


@pytest.mark.parametrize("name", ["gamma", "inverse_gamma", "beta", "student_t"])
def test_conjugate_scalar_families_match_jax(name):
    """log_prob on a grid through the support's edges (the sentinel outside,
    and at the open boundaries), mean and variance."""
    tdist, jdist = _conjugate_pairs()[name]
    x = np.concatenate([np.linspace(-2.0, 6.0, 33), [0.0, 1.0, 1e-3, 0.999]])
    got, want = tdist.log_prob(T(x)), jdist.log_prob(jnp.asarray(x))
    close(got, want)
    assert not bool(torch.isnan(got).any())
    if name != "student_t":
        assert float(got[0]) == -1e300  # x = -2 lies outside the support
    close(tdist.mean(), jdist.mean())
    close(tdist.variance(), jdist.variance())
    if name in ("gamma", "inverse_gamma"):
        close(tdist.cdf(T(x)), jdist.cdf(jnp.asarray(x)), rtol=1e-10, atol=1e-15)


@pytest.mark.parametrize("name", ["gamma", "inverse_gamma", "beta", "student_t"])
def test_conjugate_scalar_samples_have_the_closed_form_moments(name):
    """Sample mean within 4 standard errors, sample variance within 4
    standard errors of its own estimate (from the fourth moment)."""
    tdist, _ = _conjugate_pairs()[name]
    n = 40000
    s = tdist.sample(torch.Generator().manual_seed(7), (n,))
    assert s.shape == (n,) and s.dtype == torch.float64
    assert bool((tdist.log_prob(s) > -1e299).all())
    m, v = float(tdist.mean()), float(tdist.variance())
    assert abs(float(s.mean()) - m) < 4 * np.sqrt(v / n)
    m4 = float(((s - m) ** 4).mean())
    assert abs(float(s.var()) - v) < 4 * np.sqrt(max(m4 - v * v, 0.0) / n)


def test_categorical_matches_jax_and_samples_its_probabilities():
    logits = np.array([[0.3, -1.0, 2.0, 0.0], [1.0, 1.0, -0.5, 0.2]])
    tdist, jdist = tscalar.Categorical(T(logits)), jscalar.Categorical(jnp.asarray(logits))
    x = np.array([[0.0, 2.0], [3.0, 1.0], [-1.0, 1.5], [4.0, 2.0]])
    got = tdist.log_prob(T(x))
    close(got, jdist.log_prob(jnp.asarray(x)))
    assert float(got[2, 0]) == float(got[2, 1]) == float(got[3, 0]) == -1e300
    close(tdist.mean(), jdist.mean())
    close(tdist.variance(), jdist.variance())
    n = 40000
    s = tdist.sample(torch.Generator().manual_seed(3), (n,))
    assert s.shape == (n, 2)
    p = torch.softmax(T(logits), dim=-1)
    for row in range(2):
        freq = torch.stack([(s[:, row] == c).double().mean() for c in range(4)])
        assert bool((torch.abs(freq - p[row]) < 4 * torch.sqrt(p[row] * (1 - p[row]) / n)).all())


def test_conjugate_numerics_match_jax():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(4, 6)) * 3.0
    for axis in (None, 0, 1):
        close(tnum.logmeanexp(T(a), dim=axis), jnum.logmeanexp(jnp.asarray(a), axis=axis))
    x = np.array([-1.0, 0.0, 1e-300, 0.5, 2.0, 7.0])
    close(tnum.xlogx(T(x)), jnum.xlogx(jnp.asarray(x)))
    close(tnum.safe_log(T(x)), jnum.safe_log(jnp.asarray(x)))
    close(tnum.safe_sqrt(T(x - 0.25)), jnum.safe_sqrt(jnp.asarray(x - 0.25)))
    assert float(tnum.safe_log(T(-1.0))) == -1e300 and float(tnum.safe_sqrt(T(-1e-18))) == 0.0
    close(tnum.gammaln_precise(T(x[3:])), gammaln(x[3:]))
    close(tnum.log1p_precise(T(x[1:])), np.log1p(x[1:]))


def test_conditional_product_matches_jax():
    """variance ~ InverseGamma, mean | variance ~ Normal(0.5, sqrt(variance)):
    the joint density, ancestral draws in node order, the dependency graph."""
    tcp = tcomb.ConditionalProduct([
        ("variance", tscalar.InverseGamma(T(3.0), T(2.0))),
        ("mean", lambda v: tscalar.Normal(T(0.5), torch.sqrt(torch.as_tensor(v["variance"])))),
    ])
    jcp = jcomb.ConditionalProduct([
        ("variance", jscalar.InverseGamma(3.0, 2.0)),
        ("mean", lambda v: jscalar.Normal(0.5, jnp.sqrt(jnp.asarray(v["variance"])))),
    ])
    var, mean = np.array([0.5, 1.0, 2.0, -1.0]), np.array([0.1, 0.5, -2.0, 0.0])
    close(tcp.log_prob({"variance": T(var), "mean": T(mean)}),
          jcp.log_prob({"variance": jnp.asarray(var), "mean": jnp.asarray(mean)}))
    draws = tcp.sample(torch.Generator().manual_seed(0), (20000,))
    assert list(draws) == ["variance", "mean"] and draws["mean"].shape == (20000,)
    # E[variance] = 2 / (3 - 1) = 1, and the mean's marginal variance is E[variance]
    assert abs(float(draws["variance"].mean()) - 1.0) < 0.05
    assert abs(float(draws["mean"].var()) - 1.0) < 0.06
    assert tcp.graph() == jcp.graph() == [("variance", "mean")]
    with pytest.raises(ValueError):
        tcomb.ConditionalProduct([("a", tscalar.Normal()), ("a", tscalar.Normal())])


def test_with_metadata_returns_an_updated_copy():
    """``InferenceProblem.with_metadata`` was missing from the port: it
    returns a copy with the metadata dict updated and leaves the original
    unchanged, as the JAX method does."""
    problem = tproblem.define_inference_problem(
        parameters=[("a", -1.0, 1.0)], log_likelihood=lambda th: -th[0] ** 2, prior_distribution=["location"],
        device="cpu", dtype=torch.float64, tag=0, source="x")
    jprob = jproblem.define_inference_problem(
        parameters=[("a", -1.0, 1.0)], log_likelihood=lambda th: -th[0] ** 2, prior_distribution=["location"],
        tag=0, source="x")
    tagged, jtagged = problem.with_metadata(tag=1, extra=True), jprob.with_metadata(tag=1, extra=True)
    assert tagged.metadata == jtagged.metadata == {"tag": 1, "source": "x", "extra": True}
    assert problem.metadata == jprob.metadata == {"tag": 0, "source": "x"}
    assert tagged.lower is problem.lower and tagged.log_likelihood is problem.log_likelihood
    bare = tproblem.define_inference_problem(parameters=[("a", -1.0, 1.0)], log_likelihood=lambda th: -th[0] ** 2,
                                             prior_distribution=["location"], device="cpu")
    assert bare.metadata is None and bare.with_metadata(k=2).metadata == {"k": 2}


def test_normal_cdf_keeps_the_lower_tail():
    """``core.numerics.ndtr`` (erfc form) keeps the standard normal CDF's
    lower tail, as ``jax.scipy.special.ndtr`` does: the Normal and
    LogNormal CDFs, the probit link and log EI use it (``torch.special.ndtr``
    returned 0 for 7.6e-24 at -10 and was 1.3e-10 off at -6)."""
    from jax.scipy.special import ndtr as j_ndtr

    z = np.array([-37.0, -10.0, -6.0, -4.71, -1.0, 0.0, 0.5, 3.0, 8.0])
    close(tnum.ndtr(T(z)), np.asarray(j_ndtr(jnp.asarray(z))), rtol=RTOL)
    close(tscalar.Normal(1.0, 2.0).cdf(T(1.0 + 2.0 * z)), np.asarray(jscalar.Normal(1.0, 2.0).cdf(1.0 + 2.0 * z)),
          rtol=RTOL)
    x = np.exp(0.3 + 0.5 * z)
    close(tscalar.LogNormal(0.3, 0.5).cdf(T(x)), np.asarray(jscalar.LogNormal(0.3, 0.5).cdf(x)), rtol=RTOL)
