"""The port's stochastic variational GP (``ops/svgp.py``,
``engines/svgp.py``) against the JAX package, on the CPU, float64.

Parity tests put the same numpy-seeded inputs through both packages; the
fits take the JAX key tree's draws as inputs (``SVGPDraws``: the minibatch
indices of each step's ``jax.random.randint``, the multiclass normals of
each step's and of the final bound's ``jax.random.normal``).  Oracle tests
hold the port to the oracles of ``tests/test_svgp.py``, one counterpart
each; its mesh-sharded test's counterpart runs the port's fit on an
8-shard CPU mesh against the JAX fit on the 8-device mesh of
``tests/conftest.py``.  Tolerances:

* KL, latent moments, ELBO values and gradients (every named likelihood,
  a custom scalar one, point weights): rtol 1e-12, gradients 1e-12 of
  their largest entry;
* Adam traces over 30-40 steps on the JAX draws: the bound and every
  parameter at 1e-9 of its largest entry (K_zz's factor, with its 1e-6
  relative jitter, carries the condition number of K_zz into the last
  digits), the multiclass fit's at 1e-8 (Adam divides each Monte-Carlo
  gradient entry by its own running scale, which magnifies the rounding of
  the small entries: 2e-9 seen on the CPU);
* predictions from a JAX fit carried over by ``interop``: rtol 1e-10;
* the data-sharded fit against the JAX mesh fit (40 full-batch steps): the
  replays' 1e-9 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinference_tpu.engines import gp_classify as jgc
from bayesianinference_tpu.engines import svgp as jsv
from bayesianinference_tpu.ops import gp_kernels as jgk
from bayesianinference_tpu.ops import gp_laplace as jgl
from bayesianinference_tpu.ops import svgp as jops
from bayesianinference_tpu_torch import interop
from bayesianinference_tpu_torch.engines import gp_classify as tgc
from bayesianinference_tpu_torch.engines import svgp as tsv
from bayesianinference_tpu_torch.ops import gp_kernels as tgk
from bayesianinference_tpu_torch.ops import gp_laplace as tgl
from bayesianinference_tpu_torch.ops import svgp as tops

torch.set_num_threads(1)

PARAMS = [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)]


def T(a, dtype=torch.float64):
    return torch.tensor(np.array(a), dtype=dtype)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _toy(n=30, seed=0):
    """``tests/test_svgp.py::_toy``: y ~ Bernoulli(sigmoid(3 sin 1.5x))."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
    return x, (rng.uniform(size=n) < p).astype(float)


def _amp_ls(pkg):
    return lambda th: pkg.se_kernel(th[0] ** 2, th[1])


# ---------------------------------------------------------------------------
# ops parity
# ---------------------------------------------------------------------------


def test_kl_matches_jax_and_dense_closed_form():
    rng = np.random.default_rng(1)
    raw, m = rng.normal(size=(6, 6)), rng.normal(size=6)
    got = float(tops.svgp_kl(tops.SVGPVariational(T(m), T(raw))))
    close(got, float(jops.svgp_kl(jops.SVGPVariational(jnp.asarray(m), jnp.asarray(raw)))), rtol=1e-12)
    l = np.tril(raw, -1) + np.diag(np.log1p(np.exp(np.diagonal(raw))))
    s = l @ l.T
    close(got, 0.5 * (np.trace(s) + m @ m - 6 - np.linalg.slogdet(s)[1]), rtol=1e-10)
    init = tops.svgp_init_variational(5, torch.float64, scale=0.01)
    jinit = jops.svgp_init_variational(5, jnp.float64, scale=0.01)
    close(init.raw_scale, jinit.raw_scale, rtol=1e-15)
    assert tops.default_jitter(torch.float64) == jops.default_jitter(jnp.float64)
    assert tops.default_jitter(torch.float32) == jops.default_jitter(jnp.float32)


def test_latent_moments_match_jax_and_dense_algebra():
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(-2, 2, size=(9, 1)), axis=0)
    z = np.linspace(-2, 2, 4)[:, None]
    raw, m = rng.normal(size=(4, 4)) * 0.3, rng.normal(size=4)
    mu, s2 = tops.svgp_latent_moments(tgk.se_kernel(1.5, 0.8), T(x), T(z), tops.SVGPVariational(T(m), T(raw)),
                                      jitter=1e-8)
    jmu, js2 = jax.jit(lambda *a: jops.svgp_latent_moments(jgk.se_kernel(1.5, 0.8), *a, jitter=1e-8))(
        jnp.asarray(x), jnp.asarray(z), jops.SVGPVariational(jnp.asarray(m), jnp.asarray(raw)))
    close(mu, jmu, rtol=1e-12)
    close(s2, js2, rtol=1e-12)
    kern = jgk.se_kernel(1.5, 0.8)  # the dense reference, jitter relative to the mean prior variance
    kzz = np.asarray(kern.matrix(z, z))
    a = np.linalg.solve(np.linalg.cholesky(kzz + 1e-8 * np.mean(np.diagonal(kzz)) * np.eye(4)),
                        np.asarray(kern.matrix(z, x)))
    lv = np.tril(raw, -1) + np.diag(np.log1p(np.exp(np.diagonal(raw))))
    close(mu, a.T @ m, rtol=0, atol=1e-10)
    close(s2, 1.5 - np.sum(a * a, axis=0) + np.sum((lv.T @ a) ** 2, axis=0), rtol=0, atol=1e-10)


def _binomial_targets(rng, n):
    trials = rng.integers(1, 6, size=n)
    return np.stack([rng.integers(0, trials + 1), trials], axis=1).astype(float)


@pytest.mark.parametrize("name", ["bernoulli_logit", "bernoulli_probit", "poisson_log", "binomial_logit"])
def test_elbo_and_gradients_match_jax(name):
    """The ELBO and its gradient in (theta, z, m, raw) for every named
    likelihood: the closed forms on the [Q, n] nodes, the binomial's scalar
    log_prob mapped over the points."""
    rng = np.random.default_rng(3)
    n, m = 25, 6
    x, z = rng.uniform(-3, 3, (n, 2)), rng.uniform(-3, 3, (m, 2))
    y = {"poisson_log": rng.poisson(2.0, n).astype(float),
         "binomial_logit": _binomial_targets(rng, n)}.get(name, (rng.uniform(size=n) < 0.5).astype(float))
    mv, raw = rng.normal(size=m), rng.normal(size=(m, m)) * 0.3
    jlik, tlik = jgc._NAMED_LIKELIHOODS[name](), tgc._NAMED_LIKELIHOODS[name]()

    def jf(th, z_, m_, r):
        return jops.svgp_elbo(jgk.se_kernel(th[0], th[1]), x, y, z_, jlik, jops.SVGPVariational(m_, r),
                              data_scale=2.5, num_quad_points=16)

    args = (jnp.asarray([2.0, 1.1]), jnp.asarray(z), jnp.asarray(mv), jnp.asarray(raw))
    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(*args)
    targs = [T(a).requires_grad_(True) for a in ([2.0, 1.1], z, mv, raw)]
    tv = tops.svgp_elbo(tgk.se_kernel(targs[0][0], targs[0][1]), T(x), T(y), targs[1], tlik,
                        tops.SVGPVariational(targs[2], targs[3]), data_scale=2.5, num_quad_points=16)
    tg = torch.autograd.grad(tv, targs)
    close(tv.detach(), jv, rtol=1e-12)
    for got, want in zip(tg, jg):
        close_rel(got, want, 1e-12)


def test_expected_loglik_point_weights_match_jax():
    x, y = _toy(20, 4)
    w = np.random.default_rng(5).uniform(size=20)
    z = np.linspace(-3, 3, 5)[:, None]
    var = tops.svgp_init_variational(5, torch.float64)
    got = tops.svgp_expected_loglik(tgk.se_kernel(2.0, 1.0), T(x), T(y), T(z), tgl.bernoulli_logit_likelihood(), var,
                                    point_weights=T(w))
    want = jops.svgp_expected_loglik(jgk.se_kernel(2.0, 1.0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                                     jgl.bernoulli_logit_likelihood(), jops.svgp_init_variational(5, jnp.float64),
                                     point_weights=jnp.asarray(w))
    close(got, want, rtol=1e-12)


def test_multiclass_and_hetero_bounds_match_jax():
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(-2, 2, size=(7, 1)), axis=0)
    z = np.linspace(-2, 2, 4)[:, None]
    c, m = 3, 4
    m_all, raw_all = rng.normal(size=(c, m)), rng.normal(size=(c, m, m)) * 0.4
    labels = rng.integers(0, c, size=7)
    key = jax.random.PRNGKey(3)
    eps = jax.random.normal(key, (5, 7, c), jnp.float64)
    jv = jops.svgp_multiclass_elbo(jgk.se_kernel(1.3, 0.9), jnp.asarray(x), jnp.asarray(labels), jnp.asarray(z),
                                   jnp.asarray(m_all), jnp.asarray(raw_all), key, num_mc=5, jitter=1e-8,
                                   data_scale=1.7)
    tv = tops.svgp_multiclass_elbo(tgk.se_kernel(1.3, 0.9), T(x), torch.tensor(labels), T(z), T(m_all), T(raw_all),
                                   T(eps), jitter=1e-8, data_scale=1.7)
    close(tv, jv, rtol=1e-12)
    mu, s2 = tops.svgp_multiclass_latent_moments(tgk.se_kernel(1.3, 0.9), T(x), T(z), T(m_all), T(raw_all), 1e-8)
    for ci in range(c):  # the shared-kernel moments are the per-class ones
        mu_c, s2_c = tops.svgp_latent_moments(tgk.se_kernel(1.3, 0.9), T(x), T(z),
                                              tops.SVGPVariational(T(m_all[ci]), T(raw_all[ci])), 1e-8)
        close(mu[:, ci], mu_c, rtol=0, atol=1e-12)
        close(s2[:, ci], s2_c, rtol=0, atol=1e-12)
    y = rng.normal(size=7)
    vf = (rng.normal(size=m), rng.normal(size=(m, m)) * 0.3)
    vg = (rng.normal(size=m) * 0.3, rng.normal(size=(m, m)) * 0.2)
    jh = jops.svgp_hetero_elbo(jgk.se_kernel(1.5, 0.8), jgk.se_kernel(0.7, 1.2), jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(z), jops.SVGPVariational(*map(jnp.asarray, vf)),
                               jops.SVGPVariational(*map(jnp.asarray, vg)), jitter=1e-8, data_scale=2.0,
                               noise_bias=0.3)
    th = tops.svgp_hetero_elbo(tgk.se_kernel(1.5, 0.8), tgk.se_kernel(0.7, 1.2), T(x), T(y), T(z),
                               tops.SVGPVariational(*map(T, vf)), tops.SVGPVariational(*map(T, vg)), jitter=1e-8,
                               data_scale=2.0, noise_bias=0.3)
    close(th, jh, rtol=1e-12)


# ---------------------------------------------------------------------------
# fits on the JAX draws
# ---------------------------------------------------------------------------


def _jax_indices(keys, n, b):
    return torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.randint(k, (b,), 0, n))(keys)))


def _fit_close(got, want, names, tol=1e-9):
    for name in names:
        close_rel(getattr(got, name), np.asarray(getattr(want, name)), tol)


@pytest.mark.parametrize("minibatch", [None, 12])
def test_fit_svgp_replays_jax(minibatch):
    x, y = _toy(n=40, seed=3)
    key, steps = jax.random.PRNGKey(4), 40
    kw = dict(inducing=8, steps=steps, learning_rate=0.05, minibatch=minibatch)
    want = jsv.fit_svgp(x, y, _amp_ls(jgk), PARAMS, key=key, **kw)
    idx = None if minibatch is None else _jax_indices(jax.random.split(key, steps), 40, minibatch)
    got = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, draws=tsv.SVGPDraws(idx), **kw)
    _fit_close(got, want, ("elbo_trace", "elbo", "theta", "z"))
    close_rel(got.variational.m, want.variational.m, 1e-9)
    close_rel(got.variational.raw_scale, want.variational.raw_scale, 1e-9)
    xq = np.linspace(-3, 3, 11)[:, None]
    for a, b in zip(tsv.predict_from_svgp(got, T(xq)), jsv.predict_from_svgp(want, xq)):
        close_rel(a, b, 1e-9)
    # the JAX fit carried over by interop predicts what the JAX fit predicts
    port = interop.svgp_fit_from_numpy(want, _amp_ls(tgk), "bernoulli_logit", device="cpu")
    close(port.variational.raw_scale, want.variational.raw_scale, rtol=0)
    for a, b in zip(tsv.predict_from_svgp(port, T(xq)), jsv.predict_from_svgp(want, xq)):
        close(a, b, rtol=1e-10)


def _jax_multiclass_draws(key, steps, n, b, num_mc, c):
    k_run, k_final = jax.random.split(key)
    pairs = jax.vmap(jax.random.split)(jax.random.split(k_run, steps))
    idx = None if b is None else _jax_indices(pairs[:, 0], n, b)
    normals = jax.vmap(lambda k: jax.random.normal(k, (num_mc, n if b is None else b, c), jnp.float64))(pairs[:, 1])
    final = jax.random.normal(k_final, (tsv.FINAL_MC, n, c), jnp.float64)
    return tsv.SVGPDraws(idx, T(normals), T(final))


@pytest.mark.parametrize("minibatch", [None, 20])
def test_fit_multiclass_replays_jax(minibatch):
    rng = np.random.default_rng(7)
    n = 60
    x = rng.uniform(-3, 3, size=(n, 2))
    y = np.digitize(np.arctan2(x[:, 1], x[:, 0]), [-np.pi / 3, np.pi / 3])
    key, steps = jax.random.PRNGKey(0), 30
    kw = dict(inducing=8, steps=steps, learning_rate=0.05, minibatch=minibatch, num_mc=4)
    want = jsv.fit_svgp_multiclass(x, y, _amp_ls(jgk), PARAMS, key=key, **kw)
    draws = _jax_multiclass_draws(key, steps, n, minibatch, 4, 3)
    got = tsv.fit_svgp_multiclass(T(x), torch.tensor(y), _amp_ls(tgk), PARAMS, draws=draws, **kw)
    assert got.num_classes == want.num_classes == 3
    _fit_close(got, want, ("elbo_trace", "elbo", "theta", "z", "m", "raw_scale"), tol=1e-8)
    normals = jax.random.normal(jax.random.PRNGKey(1), (64, 9, 3), jnp.float64)
    xq = rng.uniform(-3, 3, size=(9, 2))
    jp = jsv.predict_from_svgp_multiclass(want, xq, num_mc=64, key=jax.random.PRNGKey(1))
    tp = tsv.predict_from_svgp_multiclass(got, T(xq), normals=T(normals))
    for a, b in zip(tp, jp):
        close_rel(a, b, 1e-8)
    port = interop.svgp_multiclass_fit_from_numpy(want, _amp_ls(tgk), device="cpu")
    for a, b in zip(port.latent_moments(T(xq)), want.latent_moments(xq)):
        close(a, b, rtol=1e-10)


@pytest.mark.parametrize("minibatch", [None, 25])
def test_fit_heteroscedastic_replays_jax(minibatch):
    rng = np.random.default_rng(10)
    n = 60
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    y = np.sin(1.2 * x[:, 0]) + (0.05 + 0.5 * (1 + np.tanh(x[:, 0]))) * rng.normal(size=n)
    key, steps = jax.random.PRNGKey(2), 40
    params = [("amp_f", 0.05, 10.0), ("ls_f", 0.1, 5.0), ("amp_g", 0.05, 5.0), ("ls_g", 0.3, 5.0)]
    kw = dict(inducing=8, steps=steps, learning_rate=0.03, minibatch=minibatch)
    builders = lambda pkg: (lambda th: pkg.se_kernel(th[0] ** 2, th[1]), lambda th: pkg.se_kernel(th[2] ** 2, th[3]))  # noqa: E731
    want = jsv.fit_svgp_heteroscedastic(x, y, *builders(jgk), params, key=key, **kw)
    idx = None if minibatch is None else _jax_indices(jax.random.split(key, steps), n, minibatch)
    got = tsv.fit_svgp_heteroscedastic(T(x), T(y), *builders(tgk), params, draws=tsv.SVGPDraws(idx), **kw)
    _fit_close(got, want, ("elbo_trace", "elbo", "theta", "z", "noise_bias"))
    for v in ("var_f", "var_g"):
        close_rel(getattr(got, v).raw_scale, getattr(want, v).raw_scale, 1e-9)
    xq = np.linspace(-3, 3, 7)[:, None]
    for a, b in zip(tsv.predict_from_svgp_heteroscedastic(got, T(xq)),
                    jsv.predict_from_svgp_heteroscedastic(want, xq)):
        close_rel(a, b, 1e-9)
    port = interop.svgp_hetero_fit_from_numpy(want, *builders(tgk), device="cpu")
    for a, b in zip(tsv.predict_from_svgp_heteroscedastic(port, T(xq)),
                    jsv.predict_from_svgp_heteroscedastic(want, xq)):
        close(a, b, rtol=1e-10)


# ---------------------------------------------------------------------------
# the JAX tests' oracles on the port
# ---------------------------------------------------------------------------


def test_elbo_lower_bounds_exact_marginal_and_tightens():
    """n = 3, M = 3 inducing at the data: the optimized ELBO sits below the
    exact marginal and within 0.05 nats of it."""
    from tests.test_gp_ep import _exact_logz_gh

    x, y = np.array([[-1.0], [0.2], [1.4]]), np.array([0.0, 1.0, 1.0])
    exact = _exact_logz_gh(jgk.covariance_matrix(jgk.se_kernel(1.5, 1.0), jnp.asarray(x), 1e-8), jnp.asarray(y),
                           jgl.bernoulli_logit_likelihood())
    fit = tsv.fit_svgp(T(x), T(y), lambda th: tgk.se_kernel(1.5, 1.0), [("dummy", 0.5, 2.0)], inducing=T(x),
                       optimize_inducing=False, steps=1500, learning_rate=0.03, jitter=1e-8, num_quad_points=40)
    elbo = float(fit.elbo)
    assert elbo <= exact + 1e-3 and exact - elbo < 0.05, (elbo, exact)
    close(fit.z, x, rtol=0)


def test_fit_matches_laplace_bridge_predictions():
    x, y = _toy(n=40, seed=3)
    fit = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, inducing=12, steps=400, learning_rate=0.05)
    assert bool(torch.isfinite(fit.elbo_trace).all())
    xq = T(np.linspace(-3, 3, 21)[:, None])
    p_svgp, _, _ = tsv.predict_from_svgp(fit, xq)
    assert bool(((p_svgp >= 0) & (p_svgp <= 1)).all())
    prob = tgc.define_gp_classifier(T(x), T(y), _amp_ls(tgk), PARAMS, validate=False)
    p_ref = tgc.predict_from_gp_classifier(fit.theta, prob, xq)
    close(p_svgp, p_ref.mean, rtol=0, atol=0.08)


def test_minibatch_elbo_unbiased_and_fit_consistent():
    x, y = _toy(n=60, seed=4)
    kern, lik = tgk.se_kernel(2.0, 1.0), tgl.bernoulli_logit_likelihood()
    z = T(np.linspace(-3, 3, 8)[:, None])
    var = tops.svgp_init_variational(8, torch.float64)
    full = float(tops.svgp_elbo(kern, T(x), T(y), z, lik, var))
    vals = [float(tops.svgp_elbo(kern, T(x[b]), T(y[b]), z, lik, var, data_scale=3.0))
            for b in (slice(0, 20), slice(20, 40), slice(40, 60))]
    close(np.mean(vals), full, rtol=1e-10)
    kw = dict(inducing=8, learning_rate=0.05)
    fit_fb = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, steps=300, generator=torch.Generator().manual_seed(1),
                          **kw)
    fit_mb = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, steps=900, minibatch=20,
                          generator=torch.Generator().manual_seed(1), **kw)
    assert abs(float(fit_fb.elbo) - float(fit_mb.elbo)) < 2.0
    xq = T(np.linspace(-3, 3, 15)[:, None])
    close(tsv.predict_from_svgp(fit_fb, xq)[0], tsv.predict_from_svgp(fit_mb, xq)[0], rtol=0, atol=0.15)


def test_multiclass_fit_separable_three_classes():
    rng = np.random.default_rng(7)
    n = 150
    x = rng.uniform(-3, 3, size=(n, 2))
    y = np.digitize(np.arctan2(x[:, 1], x[:, 0]), [-np.pi / 3, np.pi / 3])
    flip = rng.uniform(size=n) < 0.05
    y[flip] = rng.integers(0, 3, size=int(flip.sum()))
    fit = tsv.fit_svgp_multiclass(T(x), torch.tensor(y), _amp_ls(tgk), PARAMS, inducing=16, steps=400,
                                  learning_rate=0.05, num_mc=8, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(fit.elbo)) and fit.num_classes == 3
    probs, _, _ = tsv.predict_from_svgp_multiclass(fit, T(x), num_mc=256)
    close(probs.sum(dim=-1), np.ones(n), rtol=0, atol=1e-6)
    assert float(np.mean(np.argmax(probs.numpy(), axis=-1) == y)) > 0.85
    fit_mb = tsv.fit_svgp_multiclass(T(x), torch.tensor(y), _amp_ls(tgk), PARAMS, inducing=16, steps=300,
                                     learning_rate=0.05, minibatch=50, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(fit_mb.elbo))


def test_multiclass_two_class_agrees_with_binary_svgp():
    """C = 2 softmax is Bernoulli-logit on the latent difference."""
    x, y = _toy(n=60, seed=8)
    kw = dict(inducing=10, steps=500, learning_rate=0.05, generator=torch.Generator().manual_seed(2))
    fit_bin = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, **kw)
    fit_mc = tsv.fit_svgp_multiclass(T(x), torch.tensor(y.astype(int)), _amp_ls(tgk), PARAMS, num_mc=16, **kw)
    xq = T(np.linspace(-3, 3, 13)[:, None])
    probs, _, _ = tsv.predict_from_svgp_multiclass(fit_mc, xq, num_mc=1024)
    close(probs[:, 1], tsv.predict_from_svgp(fit_bin, xq)[0], rtol=0, atol=0.12)


def test_hetero_expected_loglik_closed_form_vs_mc():
    rng = np.random.default_rng(9)
    x = T(np.sort(rng.uniform(-2, 2, size=(6, 1)), axis=0))
    z = T(np.linspace(-2, 2, 3)[:, None])
    y = T(rng.normal(size=6))
    kf, kg = tgk.se_kernel(1.5, 0.8), tgk.se_kernel(0.7, 1.2)
    vf = tops.SVGPVariational(T(rng.normal(size=3)), T(rng.normal(size=(3, 3)) * 0.3))
    vg = tops.SVGPVariational(T(rng.normal(size=3) * 0.3), T(rng.normal(size=(3, 3)) * 0.2))
    elbo = float(tops.svgp_hetero_elbo(kf, kg, x, y, z, vf, vg, jitter=1e-8))
    mu_f, s2_f = tops.svgp_latent_moments(kf, x, z, vf, jitter=1e-8)
    mu_g, s2_g = tops.svgp_latent_moments(kg, x, z, vg, jitter=1e-8)
    g = torch.Generator().manual_seed(0)
    f = mu_f + torch.sqrt(s2_f) * torch.randn((400_000, 6), generator=g, dtype=torch.float64)
    lg = mu_g + torch.sqrt(s2_g) * torch.randn((400_000, 6), generator=g, dtype=torch.float64)
    ll = -0.5 * np.log(2 * np.pi) - lg - 0.5 * (y - f) ** 2 / torch.exp(2 * lg)
    kl = float(tops.svgp_kl(vf)) + float(tops.svgp_kl(vg))
    close(elbo, float(ll.mean(dim=0).sum()) - kl, rtol=2e-3)


def test_hetero_fit_recovers_noise_profile():
    rng = np.random.default_rng(10)
    n = 300
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    f_true = np.sin(1.2 * x[:, 0])
    sd_true = 0.05 + 0.5 * (1 + np.tanh(x[:, 0]))
    y = f_true + sd_true * rng.normal(size=n)
    params = [("amp_f", 0.05, 10.0), ("ls_f", 0.1, 5.0), ("amp_g", 0.05, 5.0), ("ls_g", 0.3, 5.0)]
    builders = (lambda th: tgk.se_kernel(th[0] ** 2, th[1]), lambda th: tgk.se_kernel(th[2] ** 2, th[3]))
    fit = tsv.fit_svgp_heteroscedastic(T(x), T(y), *builders, params, inducing=20, steps=800, learning_rate=0.03)
    assert np.isfinite(float(fit.elbo))
    mean, total_sd, noise_sd, latent_sd = (t.numpy() for t in tsv.predict_from_svgp_heteroscedastic(fit, T(x)))
    assert np.corrcoef(mean, f_true)[0, 1] > 0.95
    assert np.corrcoef(noise_sd, sd_true)[0, 1] > 0.8
    assert noise_sd[:30].mean() < 0.35 and 0.6 < noise_sd[-30:].mean() < 1.6
    assert np.all(total_sd >= latent_sd)
    fit_mb = tsv.fit_svgp_heteroscedastic(T(x), T(y), *builders, params, inducing=20, steps=400, learning_rate=0.03,
                                          minibatch=100, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(fit_mb.elbo))


def test_sharded_fit_matches_jax_mesh_fit():
    """``tests/test_svgp.py::test_sharded_fit_matches_single_device``: 50
    points pad to 56 over 8 shards; the fit on the port's mesh against the
    JAX fit on its mesh and against the port's unsharded fit."""
    from bayesianinference_tpu.parallel import make_mesh as j_make_mesh
    from bayesianinference_tpu_torch.parallel import make_mesh

    x, y = _toy(n=50, seed=5)
    kw = dict(likelihood="bernoulli_logit", inducing=8, steps=40, learning_rate=0.05)
    want = jsv.fit_svgp(x, y, _amp_ls(jgk), PARAMS, mesh=j_make_mesh(("data",)), key=jax.random.PRNGKey(2), **kw)
    got = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, mesh=make_mesh(("data",), devices=["cpu"] * 8), **kw)
    single = tsv.fit_svgp(T(x), T(y), _amp_ls(tgk), PARAMS, **kw)
    _fit_close(got, want, ("elbo_trace", "elbo", "theta", "z"))
    _fit_close(got, single, ("elbo_trace", "elbo", "theta", "z"))
    close_rel(got.variational.m, want.variational.m, 1e-9)
    xq = np.linspace(-3, 3, 9)[:, None]
    for a, b in zip(tsv.predict_from_svgp(got, T(xq)), jsv.predict_from_svgp(want, xq)):
        close_rel(a, b, 1e-9)


def test_validation_errors_and_mesh():
    x, y = _toy(n=10)
    ls = lambda th: tgk.se_kernel(1.0, th[0])  # noqa: E731
    with pytest.raises(ValueError, match="unknown likelihood"):
        tsv.fit_svgp(T(x), T(y), ls, [("ls", 0.1, 5.0)], likelihood="nope")
    with pytest.raises(ValueError, match="minibatch"):
        tsv.fit_svgp(T(x), T(y), ls, [("ls", 0.1, 5.0)], minibatch=99)
    with pytest.raises(TypeError, match="takes the port's parallel.Mesh"):
        tsv.fit_svgp(T(x), T(y), ls, [("ls", 0.1, 5.0)], mesh=object())
    from bayesianinference_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="mutually exclusive"):
        tsv.fit_svgp(T(x), T(y), ls, [("ls", 0.1, 5.0)], mesh=make_mesh(("data",), devices=["cpu"] * 8),
                     minibatch=5)
    z = torch.zeros((4, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="labels must lie"):
        tsv.fit_svgp_multiclass(z, torch.tensor([0, 1, 5, 2]), ls, [("ls", 0.1, 5.0)], num_classes=3, steps=1)
    with pytest.raises(ValueError, match="at least 2"):
        tsv.fit_svgp_multiclass(z, torch.zeros(4, dtype=torch.int64), ls, [("ls", 0.1, 5.0)], steps=1)


def test_svgp_draws_shapes_and_entry_point_device():
    g = torch.Generator().manual_seed(0)
    d = tsv.svgp_draws(g, 5, 100, 16, num_mc=3, num_classes=4, dtype=torch.float64)
    assert d.indices.shape == (5, 16) and int(d.indices.max()) < 100 and int(d.indices.min()) >= 0
    assert d.normals.shape == (5, 3, 16, 4) and d.final_normals.shape == (tsv.FINAL_MC, 100, 4)
    assert tsv.svgp_draws(g, 5, 100).indices is None
    x, y = _toy(n=12)
    fit = tsv.fit_svgp(x, y, lambda th: tgk.se_kernel(1.0, th[0]), [("ls", 0.1, 5.0)], inducing=4, steps=2,
                       device="cpu")
    assert fit.z.device.type == "cpu" and fit.elbo_trace.shape == (2,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsv.fit_svgp(x, y, lambda th: tgk.se_kernel(1.0, th[0]), [("ls", 0.1, 5.0)], steps=1)
