"""The port's Laplace-marginalized latents (``models/marginalize.py``)
against the JAX package and the oracles of ``tests/test_marginalize.py``,
on the CPU, float64.

The port's ``log_density`` takes theta [d] or [B, d] and runs one host
Newton loop over the batch (a frozen lane per converged theta); it serves
``define_inference_problem(batched_likelihood=True)``.  Tolerances:

* collapsed densities against the JAX function, lane by lane: rtol 1e-12;
  against the exact marginal of a conditionally Gaussian model: rtol 1e-8
  (the JAX test's);
* gradients in theta: rtol 1e-6 / atol 1e-8 against the exact marginal's
  (the JAX test's), 1e-10 of the largest entry against the JAX function's;
* the Hessian in theta with two refine steps: rtol 1e-4 / atol 1e-6
  against the exact (the JAX test's), 1e-8 against the JAX function's;
* Newton steps per lane: equal to each theta's steps alone;
* the latent posterior: rtol 1e-6 against the normal-normal closed form;
* a joint density through the SE-covariance and Cholesky ops: 1e-10
  against the exact Gaussian marginal, value and gradient.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayesianinference_tpu import dists as jd
from bayesianinference_tpu.models.marginalize import marginalize_latents as j_marginalize
from bayesianinference_tpu_torch import dists as td
from bayesianinference_tpu_torch.engines import direct_posterior_distribution
from bayesianinference_tpu_torch.models import define_inference_problem, marginalize_latents
from bayesianinference_tpu_torch.ops import gp_kernels as tgk

torch.set_num_threads(1)

Y8 = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
S8 = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
TY8, TS8 = torch.tensor(Y8), torch.tensor(S8)
THETAS = np.array([[5.0, 1.5], [0.0, 0.0], [-3.0, 2.5], [4.0, 1.2]])


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_rel(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def joint8(theta, z):
    """Eight schools: y_j ~ N(z_j, s_j^2), z_j ~ N(mu, tau^2)."""
    return torch.sum(td.Normal(z, TS8).log_prob(TY8)) + torch.sum(td.Normal(theta[0], torch.exp(theta[1])).log_prob(z))


def exact8(theta):
    return torch.sum(td.Normal(theta[0], torch.sqrt(TS8**2 + torch.exp(2.0 * theta[1]))).log_prob(TY8))


def _jax_joint8(theta, z):
    return (jnp.sum(jd.Normal(z, jnp.asarray(S8)).log_prob(jnp.asarray(Y8)))
            + jnp.sum(jd.Normal(theta[0], jnp.exp(theta[1])).log_prob(z)))


def test_exact_on_conditionally_gaussian_and_matches_jax():
    marg = marginalize_latents(joint8, latent_dim=8)
    jld = jax.jit(j_marginalize(_jax_joint8, latent_dim=8).log_density)
    got = marg.log_density(T(THETAS))
    assert got.shape == (4,)
    close(got, [float(exact8(T(t))) for t in THETAS], rtol=1e-8)
    close(got, [float(jld(jnp.asarray(t))) for t in THETAS], rtol=1e-12)
    for t in THETAS:
        one = marg.log_density(T(t))
        assert one.shape == ()
        close(one, float(jld(jnp.asarray(t))), rtol=1e-12)


def test_batch_lanes_equal_singles():
    """The batch's lanes (the JAX test's vmap) are the single-theta calls,
    each lane stopping after its own Newton steps."""
    marg = marginalize_latents(joint8, latent_dim=8, z_init=lambda th: th[0] * torch.ones(8, dtype=th.dtype))
    thetas = T([[5.0, 1.5], [0.0, 0.5], [2.0, 2.0], [-1.0, 1.0], [40.0, -1.5]])
    batched = marg.log_density(thetas)
    iters = marg.newton_iterations.clone()
    singles = []
    for i, t in enumerate(thetas):
        singles.append(marg.log_density(t))
        assert int(marg.newton_iterations[0]) == int(iters[i])
    close(batched, torch.stack(singles), rtol=1e-12)
    assert marg.newton_loop_steps >= int(iters.max())


def test_ift_gradients_match_exact_and_jax():
    marg = marginalize_latents(joint8, latent_dim=8)
    th = T(THETAS).requires_grad_(True)
    (g,) = torch.autograd.grad(marg.log_density(th).sum(), th)
    jgrad = jax.jit(jax.grad(j_marginalize(_jax_joint8, latent_dim=8).log_density))
    for i, t in enumerate(THETAS):
        te = T(t).requires_grad_(True)
        (ge,) = torch.autograd.grad(exact8(te), te)
        close(g[i], ge, rtol=1e-6, atol=1e-8)
        close_rel(g[i], jgrad(jnp.asarray(t)), 1e-10)


def _graph_size(t: torch.Tensor) -> int:
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    return len(seen)


def test_newton_loop_leaves_nothing_on_the_graph():
    """Only the refine steps carry a graph: a start that takes the loop
    many steps and one that takes it few give the same graph and the same
    gradient."""
    th = T([4.0, 1.2]).requires_grad_(True)
    sizes, grads, steps = [], [], []
    w = math.exp(2.4) / (math.exp(2.4) + S8**2)
    for z0 in (np.full(8, 200.0), w * Y8 + (1 - w) * 4.0):  # far from the mode, and at it
        marg = marginalize_latents(joint8, latent_dim=8, z_init=T(z0))
        out = marg.log_density(th)
        sizes.append(_graph_size(out))
        grads.append(torch.autograd.grad(out, th)[0])
        steps.append(marg.newton_loop_steps)
    assert sizes[0] == sizes[1] and steps[0] != steps[1]
    close(grads[0], grads[1], rtol=1e-10)
    assert marginalize_latents(joint8, latent_dim=8).log_density(T([4.0, 1.2])).grad_fn is None


def test_hessian_over_theta_matches_exact_and_jax():
    """refine_steps = 2: the Hessian in theta (third derivatives of the
    joint through the refine steps) matches the exact marginal's."""
    marg = marginalize_latents(joint8, latent_dim=8, refine_steps=2)
    th = T([4.0, 1.2])
    h = torch.autograd.functional.hessian(marg.log_density, th)
    close(h, torch.autograd.functional.hessian(exact8, th), rtol=1e-4, atol=1e-6)
    jh = jax.jit(jax.hessian(j_marginalize(_jax_joint8, latent_dim=8, refine_steps=2).log_density))(
        jnp.asarray([4.0, 1.2]))
    close_rel(h, jh, 1e-8)


def test_latent_posterior_moments_exact():
    marg = marginalize_latents(joint8, latent_dim=8)
    z_hat, cov = marg.latent_posterior(T([5.0, 1.5]))
    tau2 = math.exp(3.0)
    w = tau2 / (tau2 + S8**2)
    close(z_hat, w * Y8 + (1 - w) * 5.0, rtol=1e-6)
    close(torch.diagonal(cov), w * S8**2, rtol=1e-6)
    off = cov.numpy() - np.diag(np.diagonal(cov.numpy()))
    assert np.max(np.abs(off)) < 1e-8
    zb, cb = marg.latent_posterior(T(THETAS))
    assert zb.shape == (4, 8) and cb.shape == (4, 8, 8)
    close(zb[0], z_hat, rtol=1e-12)


def test_non_gaussian_latent_vs_quadrature():
    """One Poisson count with a log-normal latent rate: within 1 % of a
    200-node Gauss-Hermite quadrature, and a stationary mode."""
    y = 7.0

    def joint(theta, z):
        return y * z[0] - torch.exp(z[0]) - math.lgamma(y + 1.0) + td.Normal(theta[0], 0.5).log_prob(z[0])

    marg = marginalize_latents(joint, latent_dim=1)
    got = float(marg.log_density(T([1.5])))
    nodes, weights = np.polynomial.hermite_e.hermegauss(200)
    zq = 1.5 + 0.5 * nodes
    from scipy import stats as sps

    want = np.log(np.sum(np.exp(sps.poisson.logpmf(int(y), np.exp(zq))) * weights) / np.sqrt(2 * np.pi))
    assert abs(got - want) < 0.01 * abs(want) + 0.01
    z_hat, _ = marg.latent_posterior(T([1.5]))
    zz = z_hat.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(joint(T([1.5]), zz), zz)
    assert float(g.abs().max()) < 1e-4
    jy = j_marginalize(lambda th, z: (y * z[0] - jnp.exp(z[0]) - math.lgamma(y + 1.0)
                                      + jd.Normal(th[0], 0.5).log_prob(z[0])), latent_dim=1)
    close(got, float(jax.jit(jy.log_density)(jnp.asarray([1.5]))), rtol=1e-12)


def test_data_argument_threading():
    def joint(theta, z, data):
        return (torch.sum(td.Normal(z, TS8).log_prob(data))
                + torch.sum(td.Normal(theta[0], torch.exp(theta[1])).log_prob(z)))

    marg = marginalize_latents(joint, latent_dim=8)
    th = T([5.0, 1.5])
    a, b = float(marg.log_density(th, TY8)), float(marg.log_density(th, TY8 + 1.0))
    assert a != b
    close(a, float(exact8(th)), rtol=1e-8)


def test_engine_integration_eight_schools():
    """Direct quadrature (48 x 48) over (mu, log tau) of the collapsed
    likelihood, as a batched likelihood, against the same on the exact
    marginal: logZ to 1e-6."""
    marg = marginalize_latents(joint8, latent_dim=8)

    def make(loglike, batched):
        return define_inference_problem(
            parameters=[("mu", -15.0, 25.0), ("log_tau", -2.0, 3.5)], log_likelihood=loglike,
            prior_distribution=[td.Uniform(-15.0, 25.0), td.Uniform(-2.0, 3.5)], validate=False,
            batched_likelihood=batched, device="cpu", dtype=torch.float64)

    post_c = direct_posterior_distribution(problem=make(marg.log_density, True), num_points=48)
    post_e = direct_posterior_distribution(problem=make(exact8, False), num_points=48)
    close(post_c.log_evidence, post_e.log_evidence, rtol=1e-6)


def test_failed_solve_returns_sentinel():
    marg = marginalize_latents(lambda theta, z: math.nan * (theta[0] + z[0]), latent_dim=1, newton_steps=3)
    v = marg.log_density(T([[1.0], [2.0]]))
    assert bool(torch.isfinite(v).all()) and bool((v < -1e250).all())


def test_joint_through_the_custom_ops():
    """Latents with an SE-covariance prior, factored by the Cholesky op:
    z ~ N(0, K(theta)), y ~ N(z, s^2).  The latent Hessian and the refine
    steps run reverse over reverse through both ops' rules; the collapsed
    density and its gradient equal the exact N(y; 0, K + s^2 I)."""
    rng = np.random.default_rng(4)
    x = torch.tensor(np.sort(rng.uniform(-2, 2, size=(6, 1)), axis=0))
    y = torch.tensor(rng.normal(size=6))

    def cov(theta):
        return tgk.covariance_matrix(tgk.se_kernel(torch.exp(theta[0]), torch.exp(theta[1])), x, 1e-6)

    def joint(theta, z):
        factor = tgk.cholesky(cov(theta))
        w = torch.linalg.solve_triangular(factor, z[:, None], upper=False)[:, 0]
        prior = -0.5 * torch.sum(w * w) - torch.sum(torch.log(torch.diagonal(factor))) - 3.0 * math.log(2 * math.pi)
        return prior + torch.sum(td.Normal(z, 0.3).log_prob(y))

    def exact(theta):
        return tgk.gp_log_marginal_likelihood(cov(theta) + 0.09 * torch.eye(6, dtype=torch.float64), y)

    marg = marginalize_latents(joint, latent_dim=6)
    th = T([[0.2, -0.3], [-0.5, 0.4]]).requires_grad_(True)
    got = marg.log_density(th)
    want = torch.stack([exact(t) for t in th])
    close(got.detach(), want.detach(), rtol=1e-10)
    (g,) = torch.autograd.grad(got.sum(), th)
    (ge,) = torch.autograd.grad(want.sum(), th)
    close_rel(g, ge, 1e-10)
