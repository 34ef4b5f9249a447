"""The port's ADVI (``engines/vi.py``) and cosine-decayed Adam
(``core/optim.py``) against the JAX package, on the CPU in float64.

Parity tests feed the port the JAX key tree's normals (``VIDraws``: step t
draws from ``split(key, num_steps)[t]``, the final bound from
``fold_in(key, num_steps + 1)``): one step and 20-step traces of both
families, on the conjugate model and on a 2-D problem with an extra
constraint whose sentinel region the draws reach (the guard and the zeroed
gradients): every step's ELBO, the fitted location and factor and the final
ELBO at rtol 1e-10.  The schedule is held to optax's over a whole run
(1e-15), and a JAX fit carried over by ``interop`` samples and evaluates
its density as JAX does (1e-12).  Oracle tests hold the port to
``tests/test_vi.py``'s gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines import vi as jvi
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch import interop
from bayesianinference_tpu_torch.core.optim import cosine_decay_schedule
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import vi as tvi
from bayesianinference_tpu_torch.models.problem import define_inference_problem

torch.set_num_threads(1)
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def jax_draws(key, num_steps, S, F, d):
    """The normals ``advi_fit(problem, key)`` draws, as port draws."""
    steps = np.stack([np.asarray(jax.random.normal(k, (S, d), F64)) for k in jax.random.split(key, num_steps)])
    final = np.asarray(jax.random.normal(jax.random.fold_in(key, num_steps + 1), (F, d), F64))
    return tvi.VIDraws(T(steps), T(final))


def test_cosine_schedule_matches_optax_over_a_run():
    import optax

    for lr, steps in ((0.02, 3000), (0.1, 7)):
        want = optax.cosine_decay_schedule(lr, steps, alpha=0.01)
        got = cosine_decay_schedule(lr, steps, alpha=0.01)
        counts = list(range(0, steps + 5))
        close([got(c) for c in counts], [float(want(jnp.asarray(c, jnp.int32))) for c in counts], rtol=1e-15)
        assert got(0) == lr  # the first step takes the full rate
    with pytest.raises(ValueError):
        cosine_decay_schedule(0.1, 0)


def _conjugate(n_obs=40, seed=1, tau0=3.0):
    rng = np.random.default_rng(seed)
    data = rng.normal(1.2, 1.0, n_obs)
    jp = j_define(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: jd.Normal(th[0], 1.0),
                  data=jnp.asarray(data), prior_distribution=[jd.Normal(0.0, tau0)], validate=False)
    tp = define_inference_problem(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: Normal(th[0], 1.0),
                                  data=T(data), prior_distribution=[Normal(0.0, tau0)], validate=False)
    post_prec = 1 / tau0**2 + n_obs
    cov = tau0**2 * np.ones((n_obs, n_obs)) + np.eye(n_obs)
    log_z = st.multivariate_normal(np.zeros(n_obs), cov).logpdf(data)
    return jp, tp, data.sum() / post_prec, post_prec**-0.5, log_z


def _constrained():
    """A correlated 2-D Gaussian under an extra constraint a + b < 1.2 that
    draws around the starting point (0.9, 0.9) cross: sentinel values enter
    the ELBO and their gradients are zeroed."""
    prec = np.array([[2.0, 1.2], [1.2, 1.5]])
    params = [("a", -3.0, 3.0), ("b", -3.0, 3.0)]
    jp = j_define(parameters=params, log_likelihood=lambda th: -0.5 * th @ jnp.asarray(prec) @ th,
                  prior_distribution=["location", "location"], constraint=lambda th: th[0] + th[1] < 1.2,
                  validate=False)
    tp = define_inference_problem(parameters=params, log_likelihood=lambda th: -0.5 * th @ T(prec) @ th,
                                  prior_distribution=["location", "location"],
                                  constraint=lambda th: th[0] + th[1] < 1.2, validate=False, device="cpu",
                                  dtype=torch.float64)
    return jp, tp


@pytest.mark.parametrize("family", ["meanfield", "fullrank"])
@pytest.mark.parametrize("case, num_steps", [("conjugate", 1), ("conjugate", 20), ("constrained", 20)])
def test_advi_matches_jax_step_for_step(case, num_steps, family):
    jp, tp = _conjugate()[:2] if case == "conjugate" else _constrained()
    key = jax.random.PRNGKey(4)
    kw = dict(family=family, num_steps=num_steps, num_elbo_samples=16, final_elbo_samples=64,
              learning_rate=0.3, initial_point=[0.9] * tp.dim if case == "constrained" else None)
    want = jvi.advi_fit(jp, key, **kw)
    got = tvi.advi_fit(tp, None, draws=jax_draws(key, num_steps, 16, 64, tp.dim), **kw)
    close(got.elbo_history.numpy(), np.asarray(want.elbo_history), rtol=1e-10)
    close(got.loc.numpy(), np.asarray(want.loc), rtol=1e-10, atol=1e-14)
    close(got.scale_tril.numpy(), np.asarray(want.scale_tril), rtol=1e-10, atol=1e-14)
    close(float(got.elbo), float(want.elbo), rtol=1e-10)
    assert got.family == family and got.param_names == tuple(jp.param_names)
    if case == "constrained":
        assert float(got.elbo_history.min()) < -1e290  # the sentinel region was reached


def test_vi_result_from_jax_samples_and_density_as_jax():
    jp, _, *_ = _conjugate()
    key = jax.random.PRNGKey(2)
    for family in ("meanfield", "fullrank"):
        want = jvi.advi_fit(jp, key, family=family, num_steps=200)
        got = interop.vi_result_from_numpy({f: np.asarray(getattr(want, f)) for f in (
            "loc", "scale_tril", "elbo", "elbo_history", "lower", "upper")} | dict(
            param_names=want.param_names, family=family), device="cpu")
        k = jax.random.PRNGKey(5)
        eps = np.asarray(jax.random.normal(k, (300, 1), F64))
        close(got.sample(None, 300, normals=T(eps)).numpy(), np.asarray(want.sample(k, 300)), rtol=1e-12)
        pts = np.linspace(0.5, 2.0, 31)[:, None]
        close(got.log_prob(T(pts)).numpy(), np.asarray(want.log_prob(jnp.asarray(pts))), rtol=1e-12)
        close(got.log_prob(T(pts[:3]).reshape(3, 1, 1)).numpy(),
              np.asarray(want.log_prob(jnp.asarray(pts[:3]).reshape(3, 1, 1))), rtol=1e-12)
        ps = got.posterior_samples(torch.Generator().manual_seed(0), 50)
        assert ps.points.shape == (50, 1) and bool((ps.log_weights == 0).all())


# ---------------------------------------------------------------------------
# the JAX tests' oracles, on CPU tensors
# ---------------------------------------------------------------------------


def test_advi_conjugate_posterior_and_elbo():
    _, problem, post_mean, post_sd, log_z = _conjugate()
    r = tvi.advi_fit(problem, torch.Generator().manual_seed(0), num_steps=3000, learning_rate=0.02)
    samples = r.sample(torch.Generator().manual_seed(5), 20000)[:, 0].numpy()
    np.testing.assert_allclose(samples.mean(), post_mean, atol=0.02)
    np.testing.assert_allclose(samples.std(), post_sd, rtol=0.1)
    elbo = float(r.elbo)
    assert log_z - 0.1 < elbo < log_z + 0.02, (elbo, log_z)
    assert bool(torch.isfinite(r.log_prob(T(samples[:2000])[:, None])).all())
    assert float(r.log_prob(T([post_mean]))) > float(r.log_prob(T([post_mean + 2 * post_sd])))


def test_advi_fullrank_recovers_correlation():
    rho = 0.9
    prec = T(np.linalg.inv(np.asarray([[1.0, rho], [rho, 1.0]])))
    problem = define_inference_problem(parameters=[("a", -8.0, 8.0), ("b", -8.0, 8.0)],
                                       log_likelihood=lambda th: -0.5 * th @ prec @ th,
                                       prior_distribution=["location", "location"], validate=False, device="cpu",
                                       dtype=torch.float64)
    mf = tvi.advi_fit(problem, torch.Generator().manual_seed(0), family="meanfield", num_steps=3000)
    fr = tvi.advi_fit(problem, torch.Generator().manual_seed(0), family="fullrank", num_steps=3000)
    assert float(fr.elbo) > float(mf.elbo) + 0.3, (float(fr.elbo), float(mf.elbo))
    s = fr.sample(torch.Generator().manual_seed(2), 20000).numpy()
    np.testing.assert_allclose(np.corrcoef(s.T)[0, 1], rho, atol=0.06)
    s_mf = mf.sample(torch.Generator().manual_seed(2), 20000).numpy()
    assert abs(np.corrcoef(s_mf.T)[0, 1]) < 0.2


def test_advi_bounded_scale_parameter():
    data = np.random.default_rng(0).normal(0.0, 0.7, 60)
    problem = define_inference_problem(parameters=[("sigma", 0.05, 5.0)], likelihood=lambda th: Normal(0.0, th[0]),
                                       data=T(data), prior_distribution=["scale"], validate=False)
    r = tvi.advi_fit(problem, torch.Generator().manual_seed(0), num_steps=1500)
    s = r.sample(torch.Generator().manual_seed(1), 5000)[:, 0].numpy()
    assert s.min() > 0.05 and s.max() < 5.0
    np.testing.assert_allclose(s.mean(), 0.7, atol=0.1)


def test_advi_refit_on_fresh_data():
    """``tests/test_vi.py::test_advi_serving_cache`` without its program
    cache (an XLA workaround the port does not have): a refit on shifted
    data moves the posterior mean by about the shift."""
    data = np.random.default_rng(0).normal(1.0, 1.0, 25)
    problem = define_inference_problem(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: Normal(th[0], 1.0),
                                       data=T(data), prior_distribution=[Normal(0.0, 3.0)], validate=False)
    r1 = tvi.advi_fit(problem, torch.Generator().manual_seed(0), num_steps=300)
    r2 = tvi.advi_fit(problem.with_data(T(data + 0.5)), torch.Generator().manual_seed(0), num_steps=300)
    m1 = float(r1.sample(torch.Generator().manual_seed(1), 4000).mean())
    m2 = float(r2.sample(torch.Generator().manual_seed(1), 4000).mean())
    assert 0.2 < m2 - m1 < 0.8


def test_advi_rejects_unknown_family_and_bad_draws():
    problem = define_inference_problem(parameters=[("x", -1.0, 1.0)], log_likelihood=lambda th: -0.5 * torch.sum(th**2),
                                       prior_distribution=["location"], validate=False, device="cpu",
                                       dtype=torch.float64)
    with pytest.raises(ValueError, match="family"):
        tvi.advi_fit(problem, None, family="flow")
    with pytest.raises(ValueError, match="draws must be"):
        tvi.advi_fit(problem, None, num_steps=3, draws=tvi.vi_draws(torch.Generator(), 4, 32, 4096, 1))


def test_adam_step_is_the_per_tensor_formula_bit_for_bit():
    """``adam_step`` runs ``torch._foreach`` ops over every tensor at once;
    each tensor takes the per-tensor formula's values to the bit."""
    from bayesianinference_tpu_torch.core.optim import adam_init, adam_step

    def per_tensor(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
        t = state.count + 1
        c1, c2 = 1.0 - b1**t, 1.0 - b2**t
        mu = {k: (1.0 - b1) * grads[k] + b1 * state.mu[k] for k in params}
        nu = {k: (1.0 - b2) * grads[k] ** 2 + b2 * state.nu[k] for k in params}
        new = {k: params[k] + (-lr) * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k in params}
        return new, type(state)(mu=mu, nu=nu, count=t)

    for dtype in (torch.float64, torch.float32):
        g = torch.Generator().manual_seed(0)
        params = {"a": torch.randn(5, 3, generator=g, dtype=dtype), "b": torch.randn(7, generator=g, dtype=dtype),
                  "c": torch.randn((), generator=g, dtype=dtype)}
        got, want = (params, adam_init(params)), (params, adam_init(params))
        for i in range(20):
            grads = {k: torch.randn(v.shape, generator=g, dtype=dtype) * 10.0 ** (i % 5 - 2) for k, v in params.items()}
            got, want = adam_step(*got[:1], grads, got[1], 0.01), per_tensor(*want[:1], grads, want[1], 0.01)
        for k in params:
            assert torch.equal(got[0][k], want[0][k]) and torch.equal(got[1].mu[k], want[1].mu[k])
            assert torch.equal(got[1].nu[k], want[1].nu[k]) and got[1].count == want[1].count == 20
