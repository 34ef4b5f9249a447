"""The hand-written CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: without a CUDA device every test here skips (the
check happens inside the fixture, never at import).  On a machine with a
card run them with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
suite's conftest imports JAX);
``chip_smoke.py`` is the authoritative check there.

The Cholesky runs at sizes on each side of the route threshold and of the
panel edges, at B = 1 and 10.  Tolerances are chip_smoke.py's: se_covariance max abs error <= 1e-12 * var
(float64) and 1e-5 * var (float32); cholesky <= 1e-10 * max|L| (float64)
and 5e-4 * max|L| (float32, the bound of tests/test_gp.py).  The GP logML
gradient and Hessian through the kernels: 1e-8 of the largest entry
against the same on CPU tensors (float64).  The samplers' new shapes: the
fused Cholesky at the GP SMC's B = 1000 (1e-10 * max|L|), and one HMC
trajectory of 16 chains on a GP's z-space density through both kernels and
both reverse rules against the same on CPU tensors (1e-8).  The latent-GP,
sparse, Student-t and multi-output engines (float64, against CPU tensors):
the classifier's Laplace and EP logML and gradient at B = 3 (Newton steps
and sweeps equal lane by lane) and its Hessian, 1e-8; ESS draws on the same
draws, 1e-10 of the largest or ten times the two prior factors' relative
difference, whichever is larger (the factor of a kernel matrix with a 1e-6
jitter carries its condition number); the SGPR bound and gradient, the TP
and MOGP logML and gradients, 1e-8.  The variational GP, Bayesian
optimization and marginalized latents (float64, against CPU tensors): the
SVGP ELBO and its gradient in (theta, z, m, raw) through both
kernels, a BO suggestion on the same draws, and Laplace-marginalized
latents whose joint reaches both ops, 1e-8 of the largest entry; numpy
bounds of ``gauss_legendre_grid`` land on the card.  ADVI, Pathfinder and
bridge sampling on the ARD GP, and WAIC / PSIS-LOO / model weights on card
tensors (float64, against CPU tensors on the same draws): 1e-8 of the
largest entry.  The consumption layer (float64, against CPU tensors): the
regularized incomplete beta and the new scalar families, 1e-12; a GP
predictive's scores and its regression-predictive route through both
kernels, 1e-10.
"""

import numpy as np
import pytest
import torch

from bayesianinference_tpu_torch.ops import gp_kernels as gk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_se_covariance_kernel_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((10, 512, 3), generator=g, device=cuda, dtype=dtype)
    var = 0.5 + torch.rand((10,), generator=g, device=cuda, dtype=dtype)
    before = gk.se_covariance_cuda.launches
    got = gk.se_covariance(x, x, var)
    assert gk.se_covariance_cuda.launches == before + 1
    want = gk.se_covariance_plain(x, x, var)
    assert ((got - want).abs() / var[:, None, None]).max().item() <= tol
    assert torch.equal(got, got.mT)


# (B, n1, n2 or None for the symmetric call, d): both feature paths
# (registers up to d = 8, shared memory above), ragged and odd sizes, the
# cross shape
SE_SHAPES = [(1, 1, None, 1), (3, 50, None, 3), (10, 512, None, 3), (2, 513, None, 8), (3, 130, None, 9),
             (1, 257, None, 40), (10, 512, 64, 3), (2, 65, 33, 9), (1, 64, 512, 5)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", SE_SHAPES, ids=lambda s_: "B{}-n{}-m{}-d{}".format(*s_))
@pytest.mark.parametrize("ard,nugget,shared,tile", [(False, False, False, 0), (True, True, False, 32),
                                                    (False, True, True, 64), (True, False, True, 0)])
def test_se_covariance_fused_call_matches_plain(cuda, dtype, tol, shape, ard, nugget, shared, tile):
    """One launch per call; error against the plain version; the symmetric
    call bitwise symmetric and bit-equal to the two-input call on a copy."""
    b, n1, n2, d = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    rand = lambda *size: torch.rand(size, generator=g, device=cuda, dtype=dtype)  # noqa: E731
    x1 = torch.randn((1 if shared else b, n1, d), generator=g, device=cuda, dtype=dtype)
    x2 = None if n2 is None else torch.randn((1 if shared else b, n2, d), generator=g, device=cuda, dtype=dtype)
    var = 0.5 + rand(b)
    scale = 0.5 + (rand(b, d) if ard else rand(b, 1).expand(b, d))
    nug = (0.01 + rand(b, 1)).expand(b, n1) if nugget and n2 is None else None
    before = gk.se_covariance_cuda.launches
    got = gk.se_covariance_cuda(x1, x2, var, scale, nug, tile=tile)
    assert gk.se_covariance_cuda.launches == before + 1
    want = gk.se_covariance_plain(x1, x2, var, scale, nug)
    assert ((got - want).abs() / var[:, None, None]).max().item() <= tol
    if n2 is None:
        assert torch.equal(got, got.mT)
        two = gk.se_covariance_cuda(x1, x1.clone(), var, scale, None, tile=tile)
        assert torch.equal(got, two if nug is None else two + torch.diag_embed(nug))
    # through the op and the wrapper: the same bits
    assert torch.equal(gk.se_covariance(x1, x2, var, scale, nug), gk.se_covariance_cuda(x1, x2, var, scale, nug))


def test_covariance_matrix_is_one_cuda_kernel(cuda):
    """covariance_matrix(se_kernel(...), x, nugget) with the hyperparameters
    on the card: one launch of the hand-written kernel and no other CUDA
    kernel (torch.profiler), alone and under vmap over thetas."""
    from torch.profiler import ProfilerActivity, profile, schedule

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((512, 3), generator=g, device=cuda, dtype=torch.float64)
    thetas = 0.5 + torch.rand((10, 3), generator=g, device=cuda, dtype=torch.float64)
    assemble = lambda t: gk.covariance_matrix(gk.se_kernel(t[0], t[1]), x, t[2], symmetrize=False)  # noqa: E731
    for call in (lambda: assemble(thetas[0]), lambda: torch.func.vmap(assemble)(thetas)):
        call()
        torch.cuda.synchronize()
        # a trace can lose its first kernels' records: a warm-up step, traced and dropped, comes first
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(10):
                torch.zeros(8, device=cuda).add_(1.0)
            torch.cuda.synchronize()
            prof.step()
            before = gk.se_covariance_cuda.launches
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        assert gk.se_covariance_cuda.launches == before + 1
        assert len(names) == 1 and "se_covariance_kernel" in names[0], names


def test_se_covariance_kernel_propagates_nan(cuda):
    x = torch.randn((2, 70, 3), device=cuda, dtype=torch.float64)
    x[1, 5, 2] = float("nan")
    for x2 in (None, x.clone()):
        bad = torch.isnan(gk.se_covariance(x, x2, 1.3, 0.7))
        expect = torch.zeros_like(bad)
        expect[1, 5, :] = True
        expect[1, :, 5] = True
        assert torch.equal(bad, expect)


# both sides of the route threshold and of the 32- and 128-wide panel edges
CHOL_SIZES = [1, 3, 31, 32, 33, 127, 128, 129, 255, 257, 512, 639, 640, 641, 1000, 1023, 1024, 1025, 2048, 4096]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 5e-4)])
@pytest.mark.parametrize("n", CHOL_SIZES)
@pytest.mark.parametrize("batch", [1, 10])
def test_cholesky_kernel_matches_plain(cuda, dtype, tol, n, batch):
    """Either path against cholesky_ex: error, an exactly zero upper
    triangle, one count per call."""
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((batch, n, n), generator=g, device=cuda, dtype=dtype)
    k = a @ a.mT + n * torch.eye(n, device=cuda, dtype=dtype)
    before = gk.cholesky_cuda.launches
    got = gk.cholesky(k)
    assert gk.cholesky_cuda.launches == before + 1
    want = gk.cholesky_plain(k)
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()
    assert torch.count_nonzero(torch.triu(got, 1)).item() == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [40, 1500])  # the fused and the blocked path (route threshold 640)
def test_cholesky_kernel_non_pd_propagates_nan(cuda, dtype, n):
    """All-identical points, no nugget: every diagonal entry after the
    first failed pivot is NaN, in each matrix of the batch."""
    x = torch.zeros((2, n, 2), device=cuda, dtype=dtype)
    k = gk.se_covariance(x, x, torch.ones(2, device=cuda, dtype=dtype))
    diag = torch.diagonal(gk.cholesky(k), dim1=-2, dim2=-1)
    assert torch.isnan(diag[:, 2:]).all().item()


def _logml(th, x, y):
    k = gk.covariance_matrix(gk.se_kernel(torch.exp(th[0]), torch.exp(th[1])), x, nugget=torch.exp(th[2]),
                             symmetrize=False)
    return gk.gp_log_marginal_likelihood(k, y)


def test_logml_grad_and_hessian_through_kernels_match_plain(cuda):
    """n = 512, float64: the gradient and the reverse-over-reverse Hessian
    through both kernels and their reverse rules equal the same on CPU
    tensors (the plain versions), rtol 1e-8 of the largest entry."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((512, 3), generator=g, dtype=torch.float64)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn(512, generator=g, dtype=torch.float64)
    th = torch.tensor([0.2, 0.3, -2.0], dtype=torch.float64)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    grad = torch.func.grad(_logml)(th.to(cuda), x.to(cuda), y.to(cuda)).cpu()
    hess = torch.func.jacrev(torch.func.jacrev(_logml))(th.to(cuda), x.to(cuda), y.to(cuda)).cpu()
    assert gk.se_covariance_cuda.launches > before[0] and gk.cholesky_cuda.launches > before[1]
    want_grad = torch.func.grad(_logml)(th, x, y)
    want_hess = torch.func.jacrev(torch.func.jacrev(_logml))(th, x, y)
    assert (grad - want_grad).abs().max().item() <= 1e-8 * want_grad.abs().max().item()
    assert (hess - want_hess).abs().max().item() <= 1e-8 * want_hess.abs().max().item()


def test_failed_factorization_gives_zero_gradient_on_the_card(cuda):
    """All-identical inputs, no nugget: all-ones K, NaN factor from the
    kernel, the sentinel value and a zero (not NaN) gradient."""
    x = torch.zeros((40, 2), device=cuda, dtype=torch.float64)
    y = torch.linspace(-1, 1, 40, device=cuda, dtype=torch.float64)

    def f(th):
        return gk.gp_log_marginal_likelihood(gk.covariance_matrix(gk.se_kernel(torch.exp(th[0]), 1.0), x), y)

    th = torch.zeros(1, device=cuda, dtype=torch.float64)
    assert f(th).item() == -1e300
    assert torch.equal(torch.func.grad(f)(th), torch.zeros_like(th))


# --- the slice and constrained-HMC chains on the card

def _ard_problem(device, n=64, d=9):
    """A GP with one lengthscale per input (d + 2 hyperparameters on their
    log scale): per-row ARD lengthscales and shared data under the chain
    batch, d = 9 on the SE kernel's shared-memory path."""
    from bayesianinference_tpu_torch.engines.gp import define_gaussian_process

    g = torch.Generator().manual_seed(0)
    x = torch.randn((n, d), generator=g, dtype=torch.float64)
    y = torch.sin(x[:, 0]) + 0.5 * x[:, 1] + 0.1 * torch.randn(n, generator=g, dtype=torch.float64)
    names = ["log_amp"] + [f"log_len{i}" for i in range(d)] + ["log_noise"]
    return define_gaussian_process(
        x.to(device), y.to(device),
        kernel_builder=lambda th: gk.se_kernel(torch.exp(2.0 * th[0]), torch.exp(th[1:1 + d])),
        nugget_builder=lambda th: torch.exp(2.0 * th[-1]),
        parameters=[(name, -2.0, 2.0) for name in names], prior_distribution=["location"] * len(names))


def test_batched_likelihood_gradient_through_reverse_rules_matches_plain(cuda):
    """The chmc chains' gradient call: autograd on the batched likelihood, so
    both reverse rules run once at B = 12 with per-row ARD lengthscales."""
    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    theta = torch.rand((12, problem.dim), generator=torch.Generator().manual_seed(1), dtype=torch.float64) * 2 - 1
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    tg = theta.to(cuda).requires_grad_(True)
    value = problem.guarded_log_likelihood(tg)
    (grad,) = torch.autograd.grad(value.sum(), tg)
    assert gk.se_covariance_cuda.launches == before[0] + 1 and gk.cholesky_cuda.launches == before[1] + 1
    tc = theta.clone().requires_grad_(True)
    want = plain.guarded_log_likelihood(tc)
    (want_grad,) = torch.autograd.grad(want.sum(), tc)
    assert ((value.detach().cpu() - want.detach()).abs() / want.detach().abs()).max().item() <= 1e-10
    assert (grad.cpu() - want_grad).abs().max().item() <= 1e-8 * want_grad.abs().max().item()


def test_slice_chain_on_the_card_matches_the_cpu_on_the_same_draws(cuda):
    from bayesianinference_tpu_torch.ops import slice as slice_ops

    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    g = torch.Generator().manual_seed(2)
    x0 = torch.rand((8, problem.dim), generator=g, dtype=torch.float64) - 0.5
    draws = slice_ops.slice_draws(g, 8, problem.dim, num_updates=4, dtype=torch.float64)
    chol = 0.5 * torch.eye(problem.dim, dtype=torch.float64)
    threshold = float(plain.guarded_log_likelihood(x0).min()) - 5.0
    before = gk.cholesky_cuda.launches
    got = slice_ops.run_slice_chain(slice_ops.SliceDraws(*(a.to(cuda) for a in draws)), x0.to(cuda),
                                    lambda x: problem.constrained_log_prior(x, threshold), chol.to(cuda))
    want = slice_ops.run_slice_chain(draws, x0, lambda x: plain.constrained_log_prior(x, threshold), chol)
    assert torch.equal(got.evals.cpu(), want.evals) and torch.equal(got.moved.cpu(), want.moved)
    assert (got.x.cpu() - want.x).abs().max().item() <= 1e-10
    # a pass is one launch for the batch; the batch makes at least its busiest chain's evaluations
    assert gk.cholesky_cuda.launches - before >= int(want.evals.max())


def test_chmc_chain_on_the_card_matches_the_cpu_on_the_same_draws(cuda):
    from bayesianinference_tpu_torch.ops import chmc

    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    g = torch.Generator().manual_seed(3)
    x0 = torch.rand((8, problem.dim), generator=g, dtype=torch.float64) - 0.5
    draws = chmc.chmc_draws(g, 2, 8, problem.dim, dtype=torch.float64)
    chol = 0.6 * torch.eye(problem.dim, dtype=torch.float64)
    threshold = float(plain.guarded_log_likelihood(x0).min()) - 2.0
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    got = chmc.run_chmc_chain(chmc.CHMCDraws(*(a.to(cuda) for a in draws)), x0.to(cuda),
                              problem.guarded_log_likelihood, problem.guarded_log_prior, threshold, chol.to(cuda),
                              problem.lower, problem.upper, 4, 0.2, in_support=problem.in_support)
    want = chmc.run_chmc_chain(draws, x0, plain.guarded_log_likelihood, plain.guarded_log_prior, threshold, chol,
                               plain.lower, plain.upper, 4, 0.2, in_support=plain.in_support)
    # 1 start + 2 trajectories x 4 steps x (a value-and-gradient and a value) forward launches
    assert gk.cholesky_cuda.launches - before[1] >= 17 and gk.se_covariance_cuda.launches - before[0] >= 17
    assert torch.equal(got.accepted.cpu(), want.accepted) and int(want.accepted.sum()) > 0
    assert (got.x.cpu() - want.x).abs().max().item() <= 1e-8
    assert ((got.logl.cpu() - want.logl).abs() / want.logl.abs()).max().item() <= 1e-8
    assert bool((got.logl > threshold).all()) and bool(problem.in_support(got.x).all())


def test_conjugate_engines_on_the_card_factor_through_the_kernel(cuda):
    """Bayesian linear regression and the Multinormal model on the card:
    the Cholesky kernel runs, and the log evidence equals the same fit on
    CPU tensors to 1e-10 (float64)."""
    from bayesianinference_tpu_torch.engines import conjugate as tc

    g = torch.Generator().manual_seed(0)
    x = 4.0 * torch.rand((256, 1), generator=g, dtype=torch.float64) - 2.0
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * torch.randn(256, generator=g, dtype=torch.float64)
    data = torch.randn((50, 3), generator=g, dtype=torch.float64)
    for fit in (lambda d: tc.bayesian_linear_regression(x.to(d), y.to(d), degree=3),
                lambda d: tc.multinormal_conjugate_model(data.to(d))):
        before = gk.cholesky_cuda.launches
        got = float(fit(cuda).log_evidence)
        assert gk.cholesky_cuda.launches > before
        want = float(fit("cpu").log_evidence)
        assert abs(got - want) <= 1e-10 * abs(want)


def test_parallel_runs_on_the_card_batch_their_chains(cuda):
    """Two runs of a 2-D Gaussian in a box on the card, merged: finite
    evidence near the analytic -log 100."""
    import math

    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models.problem import define_inference_problem
    from bayesianinference_tpu_torch.parallel import parallel_nested_sampling

    problem = define_inference_problem(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"], device=cuda, dtype=torch.float64)
    res = parallel_nested_sampling(problem, torch.Generator(device=cuda).manual_seed(0), num_runs=2,
                                   sample_pool_size=200, num_delete=20, monte_carlo_steps=30)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    assert res.points.device.type == "cuda" and abs(logz + math.log(100.0)) <= 4 * err


def test_fused_cholesky_at_the_smc_batch_matches_plain(cuda):
    """The fused path at B = 1000, n = 512 float64 (the GP SMC's batch:
    many waves of 8-CTA clusters) against cholesky_ex."""
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn((1000, 512, 64), generator=g, device=cuda, dtype=torch.float64)
    k = a @ a.mT + 512 * torch.eye(512, device=cuda, dtype=torch.float64)
    assert gk._cholesky_route(512)[0] == "fused"
    got, want = gk.cholesky(k), gk.cholesky_plain(k)
    assert (got - want).abs().max().item() <= 1e-10 * want.abs().max().item()


def test_gp_hmc_trajectory_on_the_card_matches_the_cpu_on_the_same_draws(cuda):
    """One HMC trajectory of 16 chains on the ARD GP's z-space density:
    every leapfrog step is a value-and-gradient through both kernels and
    both reverse rules at B = 16; the end states, densities and gradients
    against the same trajectory on CPU tensors, 1e-8."""
    from bayesianinference_tpu_torch.core.transforms import box_bijection
    from bayesianinference_tpu_torch.engines.hmc import z_space_density
    from bayesianinference_tpu_torch.ops import hmc

    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    dens = z_space_density(problem, box_bijection(problem.lower, problem.upper))
    dens_cpu = z_space_density(plain, box_bijection(plain.lower, plain.upper))
    g = torch.Generator().manual_seed(5)
    z0 = 0.5 * torch.randn((16, problem.dim), generator=g, dtype=torch.float64)
    draws = hmc.hmc_draws(g, 16, problem.dim, dtype=torch.float64)
    inv_mass = torch.full((problem.dim,), 0.3, dtype=torch.float64)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    got, got_p = hmc.hmc_step(hmc.HMCDraws(*(a.to(cuda) for a in draws)), hmc.hmc_init(z0.to(cuda), dens), dens,
                              0.05, inv_mass.to(cuda), 6)
    want, want_p = hmc.hmc_step(draws, hmc.hmc_init(z0, dens_cpu), dens_cpu, 0.05, inv_mass, 6)
    assert gk.se_covariance_cuda.launches - before[0] == 7 and gk.cholesky_cuda.launches - before[1] == 7
    assert torch.equal(got.accepted.cpu(), want.accepted) and int(want.accepted.sum()) > 0
    for a, b in ((got.x, want.x), (got.log_density, want.log_density), (got.grad, want.grad), (got_p, want_p)):
        assert (a.cpu() - b).abs().max().item() <= 1e-8 * max(b.abs().max().item(), 1.0)


def test_hmc_trajectory_on_the_card_makes_no_synchronizing_call(cuda):
    """A trajectory of the box-Gaussian problem's z-space density
    (``chip_smoke.py`` phase 13a's target) under
    ``torch.cuda.set_sync_debug_mode("error")``: no copy to or from the
    host and no wait, so the host can queue a whole trajectory ahead of the
    card.  Distribution parameters given as Python numbers are filled in on
    the device."""
    from bayesianinference_tpu_torch.core.transforms import box_bijection
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.engines.hmc import z_space_density
    from bayesianinference_tpu_torch.models.problem import define_inference_problem
    from bayesianinference_tpu_torch.ops import hmc

    problem = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(4)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * 4, device=cuda, dtype=torch.float32)
    dens = z_space_density(problem, box_bijection(problem.lower, problem.upper))
    g = torch.Generator(device=cuda).manual_seed(6)
    state = hmc.hmc_init(torch.randn((64, 4), generator=g, device=cuda), dens)
    draws = hmc.hmc_draws(g, 64, 4, dtype=torch.float32)
    inv_mass = torch.ones((4,), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, prob = hmc.hmc_step(draws, state, dens, 0.3, inv_mass, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.proposed.sum()) == 64 and float(prob.mean()) > 0.5


def _class_problem(device, method="laplace", n=64):
    import numpy as np

    from bayesianinference_tpu_torch.engines.gp_classify import define_gp_classifier

    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))).astype(float)
    return define_gp_classifier(torch.tensor(x, device=device), torch.tensor(y, device=device),
                                lambda th: gk.se_kernel(th[0] ** 2, th[1]), [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)],
                                method=method, prior_distribution=["scale", "scale"], validate=False)


def _value_and_grad(problem, theta):
    th = theta.detach().clone().requires_grad_(True)
    value = problem.guarded_log_likelihood(th)
    (grad,) = torch.autograd.grad(value.sum(), th)
    return value.detach().cpu(), grad.cpu()


@pytest.mark.parametrize("method", ["laplace", "ep"])
def test_classifier_logml_gradient_and_steps_on_the_card_match_the_cpu(cuda, method):
    from bayesianinference_tpu_torch.ops import gp_ep, gp_laplace

    gpu, cpu = _class_problem(cuda, method), _class_problem("cpu", method)
    theta = torch.tensor([[1.5, 1.0], [0.5, 0.4], [3.0, 2.0]], dtype=torch.float64)
    before = gk.cholesky_cuda.launches
    for got, want in zip(_value_and_grad(gpu, theta.to(cuda)), _value_and_grad(cpu, theta)):
        assert torch.allclose(got, want, rtol=0, atol=1e-8 * want.abs().max())
    assert gk.cholesky_cuda.launches > before
    models = [p.metadata["gp_classifier"] for p in (gpu, cpu)]
    ks = [m._k_batch(theta.to(m.x.device)) for m in models]
    if method == "laplace":
        steps = [gp_laplace._newton_loop(k, m.y, m.likelihood._derivs(), 50, 1e-8).iterations.cpu()
                 for k, m in zip(ks, models)]
    else:
        steps = [gp_ep.gp_ep_state(k, m.y, m.likelihood).iterations.cpu() for k, m in zip(ks, models)]
    assert torch.equal(*steps)
    th = torch.tensor([1.7, 0.9], dtype=torch.float64)
    h_gpu = torch.autograd.functional.hessian(gpu.log_likelihood, th.to(cuda)).cpu()
    h_cpu = torch.autograd.functional.hessian(cpu.log_likelihood, th)
    assert torch.allclose(h_gpu, h_cpu, rtol=0, atol=1e-8 * h_cpu.abs().max())


def test_ess_latents_on_the_card_match_the_cpu_on_the_same_draws(cuda, monkeypatch):
    from bayesianinference_tpu_torch.engines import gp_classify
    from bayesianinference_tpu_torch.engines.gp_classify import GPLatentDraws, gp_latent_draws, sample_gp_latents
    from bayesianinference_tpu_torch.ops.ess import ESSDraws

    gpu, cpu = _class_problem(cuda), _class_problem("cpu")
    draws = gp_latent_draws(torch.Generator().manual_seed(0), 8, 64, 40, dtype=torch.float64)
    on_card = GPLatentDraws(draws.init.to(cuda), ESSDraws(*(t.to(cuda) for t in draws.updates)))
    theta = torch.tensor([1.7, 0.9], dtype=torch.float64)
    before = gk.cholesky_cuda.launches
    got = sample_gp_latents(None, gpu, theta.to(cuda), 20, num_chains=8, burn_in=20, thin=1, draws=on_card)
    assert gk.cholesky_cuda.launches > before
    want = sample_gp_latents(None, cpu, theta, 20, num_chains=8, burn_in=20, thin=1, draws=draws)
    # the draws are linear in the prior's factor, and two correct factors of this K (jitter 1e-6) differ by
    # about its condition number times eps: 1e-10 or ten times the difference that cuSOLVER's factor makes
    # on the card, as chip_smoke.py 14f
    monkeypatch.setattr(gp_classify, "cholesky", gk.cholesky_plain)
    witness = sample_gp_latents(None, gpu, theta.to(cuda), 20, num_chains=8, burn_in=20, thin=1, draws=on_card)
    spread = ((witness.draws.cpu() - want.draws).abs().max() / want.draws.abs().max()).item()
    tol = max(1e-10, 10.0 * spread)
    assert torch.allclose(got.draws.cpu(), want.draws, rtol=0, atol=tol * want.draws.abs().max())
    assert torch.equal(got.evals.cpu(), want.evals)


def test_sgpr_tp_and_mogp_on_the_card_match_the_cpu(cuda):
    import numpy as np

    from bayesianinference_tpu_torch.engines.mogp import define_multi_output_gp
    from bayesianinference_tpu_torch.engines.sparse_gp import define_sparse_gaussian_process
    from bayesianinference_tpu_torch.engines.t_process import define_t_process
    from bayesianinference_tpu_torch.ops.mogp import coregional_matrix

    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=200)
    y2 = np.stack([y, 0.5 * y + 0.1 * rng.normal(size=200)], axis=-1)[:60]
    kern = lambda th: gk.se_kernel(th[0] ** 2, th[1])  # noqa: E731
    params = [("amp", 0.05, 5.0), ("ls", 0.05, 5.0), ("noise", 0.01, 1.0)]

    def problems(d):
        xt, yt = torch.tensor(x, device=d), torch.tensor(y, device=d)
        common = dict(prior_distribution=["scale"] * 3, validate=False)
        return (define_sparse_gaussian_process(xt, yt, kern, params, nugget_builder=lambda th: th[2] ** 2,
                                               inducing=32, **common),
                define_t_process(xt, yt, kern, params, nu=4.0, nugget_builder=lambda th: th[2] ** 2, **common),
                define_multi_output_gp(xt[:60], y2, kern,
                                       lambda th: coregional_matrix(torch.stack([th[2], 0.5 * th[2]]),
                                                                    torch.full((2,), 0.1, dtype=th.dtype,
                                                                               device=th.device)),
                                       params, noise_builder=lambda th: th[2] ** 2, **common))

    theta = torch.tensor([[1.3, 0.8, 0.3], [0.7, 1.5, 0.5]], dtype=torch.float64)
    for gpu, cpu in zip(problems(cuda), problems("cpu")):
        for got, want in zip(_value_and_grad(gpu, theta.to(cuda)), _value_and_grad(cpu, theta)):
            assert torch.allclose(got, want, rtol=0, atol=1e-8 * want.abs().max())


def test_gauss_legendre_grid_puts_numpy_bounds_on_the_card(cuda):
    from bayesianinference_tpu_torch.engines.direct import gauss_legendre_grid

    nodes, log_w = gauss_legendre_grid(np.array([0.0, -1.0]), np.array([1.0, 1.0]), 5)
    assert nodes.is_cuda and log_w.is_cuda and nodes.shape == (25, 2)
    nodes, _ = gauss_legendre_grid(np.array([0.0]), np.array([1.0]), 5, device="cpu")
    assert nodes.device.type == "cpu"


def test_svgp_elbo_and_gradient_on_the_card_match_the_cpu(cuda):
    from bayesianinference_tpu_torch.ops import gp_laplace, svgp

    rng = np.random.default_rng(5)
    vals = [np.array([2.0, 0.9]), rng.uniform(-3, 3, (16, 2)), rng.normal(size=16), 0.2 * rng.normal(size=(16, 16)),
            rng.uniform(-3, 3, (300, 2)), (rng.uniform(size=300) < 0.5).astype(float)]

    def value_and_grad(d):
        args = [torch.tensor(v, device=d).requires_grad_(i < 4) for i, v in enumerate(vals)]
        th, z, m, raw, x, y = args
        out = svgp.svgp_elbo(gk.se_kernel(th[0], th[1]), x, y, z, gp_laplace.bernoulli_logit_likelihood(),
                             svgp.SVGPVariational(m, raw), data_scale=3.0)
        return [out.detach().reshape(1)] + [g.detach() for g in torch.autograd.grad(out, args[:4])]

    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    got = value_and_grad(cuda)
    assert gk.se_covariance_cuda.launches >= before[0] + 2 and gk.cholesky_cuda.launches > before[1]
    for a, b in zip(got, value_and_grad("cpu")):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-8 * b.abs().max())


def test_bo_suggestion_on_the_card_matches_the_cpu_on_the_same_draws(cuda):
    from bayesianinference_tpu_torch.engines import bayesopt as bo

    cfg = bo.BayesOptConfig(num_candidates=64, hyper_steps=3, refine_steps=3)
    draws = bo.bo_draws(torch.Generator().manual_seed(1), 2, cfg, dtype=torch.float64)
    out = []
    for d in (cuda, torch.device("cpu")):
        state, x_init = bo.bo_init(torch.tensor([-1.0, 0.0], device=d, dtype=torch.float64),
                                   torch.tensor([1.0, 2.0], device=d, dtype=torch.float64), 12, num_init=5,
                                   dtype=torch.float64, draws=bo.design_draws(torch.Generator().manual_seed(0), 5, 2,
                                                                              torch.float64))
        for x in x_init:
            state = bo.bo_observe(state, x, torch.sum(x**2) + torch.sin(3 * x[0]))
        before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
        state, x_next = bo.bo_suggest(state, draws, cfg)
        if d.type == "cuda":
            assert gk.se_covariance_cuda.launches > before[0] and gk.cholesky_cuda.launches > before[1]
        out.append(torch.cat([x_next, state.log_ell, state.log_var[None]]).cpu())
    assert torch.allclose(out[0], out[1], rtol=0, atol=1e-8 * out[1].abs().max())


def test_marginalized_latents_through_the_kernels_match_the_cpu(cuda):
    from bayesianinference_tpu_torch.models import marginalize_latents

    rng = np.random.default_rng(4)
    xs, ys = np.sort(rng.uniform(-2, 2, size=(6, 1)), axis=0), rng.normal(size=6)

    def marginal(d):
        x, y = torch.tensor(xs, device=d), torch.tensor(ys, device=d)

        def joint(theta, z):
            k = gk.covariance_matrix(gk.se_kernel(torch.exp(theta[0]), torch.exp(theta[1])), x, 1e-6)
            factor = gk.cholesky(k)
            w = torch.linalg.solve_triangular(factor, z[:, None], upper=False)[:, 0]
            return -0.5 * torch.sum(w * w) - torch.sum(torch.log(torch.diagonal(factor))) - 0.5 * torch.sum(
                (y - z) ** 2) / 0.09

        th = torch.tensor([[0.2, -0.3], [-0.5, 0.4]], dtype=torch.float64, device=d).requires_grad_(True)
        out = marginalize_latents(joint, latent_dim=6).log_density(th)
        return [out.detach(), torch.autograd.grad(out.sum(), th)[0]]

    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    got = marginal(cuda)
    assert gk.se_covariance_cuda.launches > before[0] and gk.cholesky_cuda.launches > before[1]
    for a, b in zip(got, marginal("cpu")):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-8 * b.abs().max())


def _rel_to(a, b):
    return (a.cpu() - b).abs().max().item() / max(b.abs().max().item(), 1.0)


def test_advi_and_pathfinder_on_the_card_match_the_cpu_on_the_same_draws(cuda, monkeypatch):
    """Five ADVI steps of both families (value and gradient through both
    kernels and both reverse rules at B = 32) and a short Pathfinder fit (a
    line-search try at B = 4, the ELBO block and final draws in chunks) on
    the ARD GP against the same on CPU tensors, 1e-8."""
    from bayesianinference_tpu_torch.engines import pathfinder as pf
    from bayesianinference_tpu_torch.engines import vi

    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    g = torch.Generator().manual_seed(3)
    draws = vi.vi_draws(g, 5, 32, 64, problem.dim)
    for family in ("meanfield", "fullrank"):
        before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
        kw = dict(family=family, num_steps=5, final_elbo_samples=64, learning_rate=0.1)
        got = vi.advi_fit(problem, None, draws=vi.VIDraws(*(a.to(cuda) for a in draws)), **kw)
        want = vi.advi_fit(plain, None, draws=draws, **kw)
        assert gk.se_covariance_cuda.launches - before[0] >= 6 and gk.cholesky_cuda.launches - before[1] >= 6
        for a, b in ((got.elbo_history, want.elbo_history), (got.loc, want.loc), (got.scale_tril, want.scale_tril),
                     (got.elbo, want.elbo)):
            assert _rel_to(a, b) <= 1e-8
    pd = pf.pathfinder_draws(g, 4, problem.dim, 5, 16)
    kw = dict(num_paths=4, maxiter=3, num_elbo_draws=5, num_draws_per_path=16)
    monkeypatch.setattr(vi, "EVAL_CHUNK", 24)
    got = pf.pathfinder_fit(problem, None, draws=pf.PathfinderDraws(*(a.to(cuda) for a in pd)), **kw)
    want = pf.pathfinder_fit(plain, None, draws=pd, **kw)
    assert torch.equal(got.best_iteration.cpu(), want.best_iteration)
    for a, b in ((got.elbo_per_path, want.elbo_per_path), (got.samples.log_weights, want.samples.log_weights),
                 (got.samples.points, want.samples.points)):
        assert _rel_to(a, b) <= 1e-8


def test_pathfinder_factor_above_2j_on_the_card_matches_the_cpu(cuda):
    """Pathfinder's factor and draws at d = 22 > 2J = 12 (the thin QR's
    m = 2J branch) over a [4, 3] batch of windows with masked pairs, on the
    card against the same on CPU tensors, 1e-10."""
    from bayesianinference_tpu_torch.engines import pathfinder as pf

    rng = np.random.default_rng(1)
    d, J = 22, 6
    a = rng.normal(size=(d, d))
    S = rng.normal(size=(4, 3, J, d))
    Y = S @ (a @ a.T / d + np.eye(d))
    ok = rng.random((4, 3, J)) < 0.7
    alpha = rng.uniform(0.3, 2.0, size=(4, 3, d))
    eps = rng.normal(size=(4, 3, 5, d))
    mu = rng.normal(size=(4, 3, d))
    out = {}
    for dev in (cuda, "cpu"):
        t = [torch.as_tensor(v, device=dev) for v in (alpha, S, Y, ok, mu, eps)]
        sqrt_a, Q, Lm, half = pf.factor(*t[:4])
        assert Q.shape[-1] == 2 * J
        out[dev] = (pf.draw(t[4], sqrt_a, Q, Lm, t[5]).cpu(), half.cpu())
    for a, b in zip(out[cuda], out["cpu"]):
        assert _rel_to(a, b) <= 1e-10


def test_bridge_and_information_on_the_card_match_the_cpu(cuda):
    """Bridge sampling of the ARD GP from 64 draws (both sweeps through the
    kernels) and WAIC / PSIS-LOO / stacking on card tensors, against the
    same on CPU tensors, 1e-8."""
    from bayesianinference_tpu_torch.core.containers import WeightedSamples
    from bayesianinference_tpu_torch.engines.bridge import bridge_sampling_evidence
    from bayesianinference_tpu_torch.results import model_weights, psis_loo, waic

    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    g = torch.Generator().manual_seed(4)
    draws = 0.3 * torch.randn((64, problem.dim), generator=g, dtype=torch.float64)
    normals = torch.randn((32, problem.dim), generator=g, dtype=torch.float64)
    got = bridge_sampling_evidence(problem, draws.to(cuda), proposal_normals=normals.to(cuda))
    want = bridge_sampling_evidence(plain, draws, proposal_normals=normals)
    assert got.num_iterations == want.num_iterations
    assert _rel_to(got.log_evidence, want.log_evidence) <= 1e-8
    y = torch.randn(30, generator=g, dtype=torch.float64)
    pts = torch.stack([0.3 * torch.randn(500, generator=g, dtype=torch.float64) + 0.5,
                       0.1 * torch.randn(500, generator=g, dtype=torch.float64)], dim=1)

    def pointwise(th):
        return -0.5 * (y.to(th.device) - th[0]) ** 2 * torch.exp(-2 * th[1]) - th[1]

    ws = WeightedSamples(points=pts, log_weights=torch.zeros(500, dtype=torch.float64))
    ws_card = WeightedSamples(points=pts.to(cuda), log_weights=ws.log_weights.to(cuda))
    for fn in (waic, psis_loo):
        a, b = fn(ws_card, pointwise), fn(ws, pointwise)
        assert a.pointwise_elpd.device.type == "cuda" and _rel_to(a.pointwise_elpd, b.pointwise_elpd) <= 1e-8
    w = model_weights([a.pointwise_elpd, a.pointwise_elpd - 0.1])
    assert w.device.type == "cuda" and abs(float(w.sum()) - 1.0) < 1e-12


def test_betainc_and_the_new_families_on_the_card_match_the_cpu(cuda):
    """The regularized incomplete beta on its grid and the twelve new
    families' densities, CDFs and quantiles, card against CPU, 1e-12."""
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.core.numerics import betainc

    a, b, x = (t.reshape(-1) for t in torch.meshgrid(
        torch.tensor([0.05, 0.5, 5.0, 500.0], dtype=torch.float64),
        torch.tensor([0.05, 1.0, 50.0, 5000.0], dtype=torch.float64),
        torch.tensor([1e-12, 1e-3, 0.3, 0.7, 0.999, 1 - 1e-12], dtype=torch.float64), indexing="ij"))
    assert _rel_to(betainc(a.to(cuda), b.to(cuda), x.to(cuda)), betainc(a, b, x)) <= 1e-12
    q = torch.linspace(0.05, 0.95, 7, dtype=torch.float64)
    for name, params in (("StudentT", dict(df=4.0, loc=1.0, scale=2.0)), ("Beta", dict(a=2.0, b=5.0)),
                         ("Laplace", dict(loc=-1.0, scale=2.0)), ("Weibull", dict(k=1.7, scale=2.0)),
                         ("Gumbel", dict(loc=1.0, scale=2.0)), ("Pareto", dict(xmin=1.5, alpha=5.0))):
        make = lambda d: getattr(dists, name)(**{k: torch.tensor(v, dtype=torch.float64, device=d)  # noqa: E731
                                                 for k, v in params.items()})
        card, cpu = make(cuda), make("cpu")
        xs = cpu.icdf(q)
        assert _rel_to(card.icdf(q.to(cuda)), xs) <= 1e-12
        assert _rel_to(card.cdf(xs.to(cuda)), cpu.cdf(xs)) <= 1e-12
        assert _rel_to(card.log_prob(xs.to(cuda)), cpu.log_prob(xs)) <= 1e-12


def test_gp_predictive_scores_and_regression_route_on_the_card_match_the_cpu(cuda):
    """A GP predictive built through both kernels, scored on the card against
    the same on CPU tensors (1e-10), and its regression-predictive route
    against predict_from_gaussian_process (1e-10)."""
    from bayesianinference_tpu_torch.core.containers import WeightedSamples
    from bayesianinference_tpu_torch.dists import Normal
    from bayesianinference_tpu_torch.engines.gp import define_gaussian_process, predict_from_gaussian_process
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel
    from bayesianinference_tpu_torch.results import regression_predictive_distribution, scoring

    g = torch.Generator().manual_seed(7)
    x = torch.randn((128, 3), generator=g, dtype=torch.float64)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn(128, generator=g, dtype=torch.float64)
    draws = WeightedSamples(points=torch.rand((40, 3), generator=g, dtype=torch.float64) * 0.8 + 0.2,
                            log_weights=torch.randn(40, generator=g, dtype=torch.float64))
    xq = torch.randn((32, 3), generator=g, dtype=torch.float64)
    yq = torch.sin(xq[:, 0])

    def problem(d):
        return define_gaussian_process(x.to(d), y.to(d), kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
                                       nugget_builder=lambda th: th[2] ** 2,
                                       parameters=[("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)])

    card, cpu = problem(cuda), problem("cpu")
    draws_card = WeightedSamples(points=draws.points.to(cuda), log_weights=draws.log_weights.to(cuda))
    pred, pred_cpu = predict_from_gaussian_process(draws_card, card, xq.to(cuda)), \
        predict_from_gaussian_process(draws, cpu, xq)
    for fn in (scoring.crps, scoring.log_score, scoring.pit, scoring.dawid_sebastiani_score):
        assert _rel_to(fn(pred, yq.to(cuda)), fn(pred_cpu, yq)) <= 1e-10
    model = card.metadata["gaussian_process"]
    route = regression_predictive_distribution(
        draws_card, lambda th, xx: Normal(*(lambda m, s: (m, torch.clamp(s, min=1e-12)))(*model.posterior_moments(th, xx))),
        xq.to(cuda))
    assert _rel_to(route.mean(), pred.mean().cpu()) <= 1e-10
    assert _rel_to(route.variance(), pred.variance().cpu()) <= 1e-10
