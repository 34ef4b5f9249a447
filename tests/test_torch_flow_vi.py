"""The port's RealNVP flow VI (``engines/flow_vi.py``)
against the JAX package, on the CPU in float64.

Parity tests carry the JAX flow's parameters over (``interop``) and feed
the port the JAX key tree's numbers (the initial parameters from
``split(key, 3)[0]``, step t's normals from ``split(k_opt, num_steps)[t]``,
the final batch's from ``k_final``): the forward and inverse passes and
their log-determinants (1e-12), the negative ELBO and its gradient on the
same base draws (1e-10), ten Adam steps against ``_flow_vi_program``
(1e-10), and the PSIS evidence from the JAX log-weights (1e-12).  Oracle
tests hold the port to ``tests/test_flow_vi.py``'s gates at its sizes; its
compile-cache test (``test_flow_serving_cache``) is an XLA workaround with
no counterpart, and its HMC flow-start test is held in
``tests/test_torch_hmc.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.engines import flow_vi as jfv
from bayesianinference_tpu.models import define_inference_problem as j_define
from bayesianinference_tpu_torch import interop
from bayesianinference_tpu_torch.dists.scalar import Normal
from bayesianinference_tpu_torch.engines import flow_vi as tfv
from bayesianinference_tpu_torch.engines import vi as tvi
from bayesianinference_tpu_torch.models.problem import define_inference_problem

torch.set_num_threads(1)
F64 = jnp.float64


def T(a):
    return torch.tensor(np.array(a))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=rtol, atol=atol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed_params(d, layers=4, hidden=16):
    params = jfv._init_flow(jax.random.PRNGKey(0), d, layers, hidden, F64)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    # perturb every leaf so that the flow is not the identity
    return jax.tree_util.tree_unflatten(treedef, [a + 0.1 * jax.random.normal(k, a.shape, a.dtype)
                                                   for a, k in zip(leaves, keys)])


@pytest.mark.parametrize("d", [1, 2, 5])
def test_forward_inverse_and_log_determinants_match_jax(d):
    jparams = _perturbed_params(d)
    tparams = interop.flow_params_from_numpy(_np_tree(jparams), device="cpu")
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64, d), F64))
    x_j, ld_j = jax.jit(jfv._flow_forward, static_argnums=2)(jparams, jnp.asarray(z), d)
    x_t, ld_t = tfv._flow_forward(tparams, T(z), d)
    close(x_t.numpy(), np.asarray(x_j), rtol=1e-12, atol=1e-14)
    close(ld_t.numpy(), np.asarray(ld_j), rtol=1e-12, atol=1e-14)
    zb_j, ldi_j = jax.jit(jfv._flow_inverse, static_argnums=2)(jparams, x_j, d)
    zb_t, ldi_t = tfv._flow_inverse(tparams, x_t, d)
    close(zb_t.numpy(), np.asarray(zb_j), rtol=1e-12, atol=1e-13)
    close(ldi_t.numpy(), np.asarray(ldi_j), rtol=1e-12, atol=1e-14)
    # tests/test_flow_vi.py::test_flow_forward_inverse_roundtrip on the port
    close(zb_t.numpy(), z, rtol=0, atol=1e-9)
    close(ldi_t.numpy(), ld_t.numpy(), rtol=0, atol=1e-9)
    # a leading batch axis rides through the inverse's one triangular solve
    zb3, _ = tfv._flow_inverse(tparams, x_t.reshape(4, 16, d), d)
    close(zb3.reshape(64, d).numpy(), zb_t.numpy(), rtol=1e-13, atol=1e-14)


def _conjugate(n_obs=40, seed=1):
    rng = np.random.default_rng(seed)
    data = rng.normal(1.2, 1.0, n_obs)
    tau0, mu0 = 3.0, 0.0
    jp = j_define(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: jd.Normal(th[0], 1.0),
                  data=jnp.asarray(data), prior_distribution=[jd.Normal(mu0, tau0)], validate=False)
    tp = define_inference_problem(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: Normal(th[0], 1.0),
                                  data=T(data), prior_distribution=[Normal(mu0, tau0)], validate=False)
    post_prec = 1 / tau0**2 + n_obs
    post_mean = (mu0 / tau0**2 + data.sum()) / post_prec
    cov = tau0**2 * np.ones((n_obs, n_obs)) + np.eye(n_obs)
    log_z = st.multivariate_normal(np.full(n_obs, mu0), cov).logpdf(data)
    return jp, tp, post_mean, post_prec**-0.5, log_z


def _banana():
    """tests/test_flow_vi.py's curved 2-D posterior (its ``banana_problem``)."""
    params = [("a", -6.0, 6.0), ("b", -4.0, 12.0)]

    def ll(th):
        return -0.5 * (th[..., 0] ** 2 / 4.0 + 4.0 * (th[..., 1] - th[..., 0] ** 2 / 2.0) ** 2)

    jp = j_define(parameters=params, log_likelihood=ll, prior_distribution=["location", "location"], validate=False)
    tp = define_inference_problem(parameters=params, log_likelihood=ll, prior_distribution=["location", "location"],
                                  validate=False, device="cpu", dtype=torch.float64)
    return jp, tp


def _jax_program_numbers(key, d, layers, hidden, steps, S, F):
    """The initial parameters and the normals of ``_flow_vi_program``."""
    k_init, k_opt, k_final = jax.random.split(key, 3)
    params = interop.flow_params_from_numpy(_np_tree(jfv._init_flow(k_init, d, layers, hidden, F64)), device="cpu")
    step = np.stack([np.asarray(jax.random.normal(k, (S, d), F64)) for k in jax.random.split(k_opt, steps)])
    final = np.asarray(jax.random.normal(k_final, (F, d), F64))
    return params, tvi.VIDraws(T(step), T(final))


@pytest.mark.parametrize("case", ["conjugate", "banana"])
def test_negative_elbo_and_gradient_match_jax_on_the_same_draws(case):
    jp, tp = _conjugate()[:2] if case == "conjugate" else _banana()
    d = tp.dim
    jparams = _perturbed_params(d, layers=6, hidden=32)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (64, d), F64))
    from bayesianinference_tpu.core.transforms import box_bijection as j_box

    bij = j_box(jp.lower, jp.upper)

    def j_neg_elbo(params):
        z, logdet = jfv._flow_forward(params, jnp.asarray(eps), d)
        lps = jax.vmap(lambda zz: jp.log_posterior_density(bij.to_x(zz)) + bij.log_jacobian(zz))(z)
        return -jnp.mean(lps - (jfv._base_logpdf(jnp.asarray(eps)) - logdet))

    want, want_g = jax.jit(jax.value_and_grad(j_neg_elbo))(jparams)
    from bayesianinference_tpu_torch.core.transforms import box_bijection

    log_target = tvi.z_log_target(tp, box_bijection(tp.lower, tp.upper))
    like = tfv._leaves(interop.flow_params_from_numpy(_np_tree(jparams), device="cpu"))
    theta = torch.cat([t.reshape(-1) for t in like]).requires_grad_(True)
    z, logdet = tfv._flow_forward(tfv._tree(theta, like), T(eps), d)
    got = -torch.mean(log_target(z) - (tfv._base_logpdf(T(eps)) - logdet))
    (grad,) = torch.autograd.grad(got, theta)
    close(float(got.detach()), float(want), rtol=1e-10)
    want_g = np.concatenate([np.asarray(t).reshape(-1) for t in tfv._leaves(want_g)])
    close(grad.numpy(), want_g, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("case", ["conjugate", "banana"])
def test_ten_adam_steps_and_psis_evidence_match_jax(case):
    jp, tp = _conjugate()[:2] if case == "conjugate" else _banana()
    key = jax.random.PRNGKey(3)
    kw = dict(num_layers=6, hidden=32, num_steps=10, num_elbo_samples=64, learning_rate=0.01,
              final_evidence_samples=512)
    params, elbo, hist, lw = jfv._flow_vi_program(jp, key, kw["num_layers"], kw["hidden"], kw["num_steps"],
                                                  kw["num_elbo_samples"], kw["learning_rate"],
                                                  kw["final_evidence_samples"])
    init, draws = _jax_program_numbers(key, tp.dim, 6, 32, 10, 64, 512)
    got = tfv.flow_vi_fit(tp, None, initial_params=init, draws=draws, **kw)
    close(got.elbo_history.numpy(), np.asarray(hist), rtol=1e-10)
    for g, w in zip(tfv._leaves(got.params), tfv._leaves(params)):
        close(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-13)
    close(float(got.elbo), float(elbo), rtol=1e-10)
    # the PSIS evidence and its k-hat from the JAX log-weights, as
    # flow_vi_fit computes them
    want = jfv.flow_vi_fit(jp, key, **kw)
    from bayesianinference_tpu_torch.core.numerics import logmeanexp
    from bayesianinference_tpu_torch.results.information import _psis_smooth_tail

    lw_np = np.asarray(lw)
    smoothed, khat = _psis_smooth_tail(lw_np - lw_np.max())
    close(lw_np.max() + float(logmeanexp(T(smoothed))), float(want.log_evidence), rtol=1e-12)
    close(khat, float(want.pareto_k), rtol=1e-12)
    close(float(got.log_evidence), float(want.log_evidence), rtol=1e-10)
    close(float(got.pareto_k), float(want.pareto_k), rtol=1e-8)
    # the JAX fit carried over samples and evaluates its density as JAX does
    carried = interop.flow_vi_result_from_numpy(
        {f: (_np_tree(getattr(want, f)) if f == "params" else np.asarray(getattr(want, f))) for f in (
            "params", "elbo", "elbo_history", "log_evidence", "pareto_k", "lower", "upper")}
        | dict(param_names=want.param_names), device="cpu")
    d = tp.dim
    k = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(k, (300, d), F64))
    close(carried.sample(None, 300, normals=T(eps)).numpy(), np.asarray(want.sample(k, 300)), rtol=1e-12,
          atol=1e-13)
    pts = np.linspace(-2.0, 2.0, 21 * d).reshape(21, d) + 1.0
    close(carried.log_prob(T(pts)).numpy(), np.asarray(want.log_prob(jnp.asarray(pts))), rtol=1e-12)
    ps = carried.posterior_samples(torch.Generator().manual_seed(0), 50)
    assert ps.points.shape == (50, d) and bool((ps.log_weights == 0).all())
    assert carried.param_names == tuple(jp.param_names)


# ---------------------------------------------------------------------------
# the JAX tests' oracles, on CPU tensors
# ---------------------------------------------------------------------------


def test_flow_conjugate_posterior_and_evidence():
    _, problem, post_mean, post_sd, log_z = _conjugate()
    r = tfv.flow_vi_fit(problem, torch.Generator().manual_seed(0), num_steps=2000)
    s = r.sample(torch.Generator().manual_seed(5), 20000)[:, 0].numpy()
    np.testing.assert_allclose(s.mean(), post_mean, atol=0.02)
    np.testing.assert_allclose(s.std(), post_sd, rtol=0.1)
    assert log_z - 0.1 < float(r.elbo) < log_z + 0.02, (float(r.elbo), log_z)
    assert float(r.pareto_k) < 0.7, float(r.pareto_k)
    np.testing.assert_allclose(float(r.log_evidence), log_z, atol=0.03)
    assert float(r.log_prob(T([post_mean]))) > float(r.log_prob(T([post_mean + 2 * post_sd])))


def test_flow_respects_box_and_scale():
    data = np.random.default_rng(0).normal(0.0, 0.7, 60)
    problem = define_inference_problem(parameters=[("sigma", 0.05, 5.0)], likelihood=lambda th: Normal(0.0, th[0]),
                                       data=T(data), prior_distribution=["scale"], validate=False)
    r = tfv.flow_vi_fit(problem, torch.Generator().manual_seed(0), num_steps=1500)
    s = r.sample(torch.Generator().manual_seed(1), 5000)[:, 0].numpy()
    assert s.min() > 0.05 and s.max() < 5.0
    np.testing.assert_allclose(s.mean(), 0.7, atol=0.1)


def test_flow_rejects_draws_of_the_wrong_shape():
    _, tp = _banana()
    with pytest.raises(ValueError, match="draws must be"):
        tfv.flow_vi_fit(tp, None, num_steps=3, draws=tvi.vi_draws(torch.Generator(), 4, 64, 8192, 2))


@pytest.mark.slow
def test_flow_beats_gaussian_families_on_banana():
    """tests/test_flow_vi.py's slow capacity test; ``chip_smoke.py`` phase
    18b runs it on the card."""
    _, problem = _banana()
    xs, ys = np.linspace(-6, 6, 2001), np.linspace(-4, 12, 2001)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    f = np.exp(-0.5 * (xx**2 / 4.0 + 4.0 * (yy - xx**2 / 2.0) ** 2))
    log_z = np.log(np.trapezoid(np.trapezoid(f, ys, axis=1), xs)) - np.log(12.0 * 16.0)
    fr = tvi.advi_fit(problem, torch.Generator().manual_seed(0), family="fullrank", num_steps=3000)
    fl = tfv.flow_vi_fit(problem, torch.Generator().manual_seed(0), num_steps=4000, learning_rate=2e-3)
    assert float(fl.elbo) > float(fr.elbo) + 0.2, (float(fl.elbo), float(fr.elbo))
    assert float(fl.pareto_k) < 0.7, float(fl.pareto_k)
    np.testing.assert_allclose(float(fl.log_evidence), log_z, atol=0.05)
    s = fl.sample(torch.Generator().manual_seed(3), 20000).numpy()
    np.testing.assert_allclose((s[:, 1] - s[:, 0] ** 2 / 2.0).std(), 0.5, rtol=0.2)
    np.testing.assert_allclose(s[:, 0].std(), 2.0, rtol=0.2)
