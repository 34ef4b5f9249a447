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
kernels, 1e-10.  The quasi-Bayesian net at the reference's defaults (its
forward pass, alpha-divergence loss and two training steps on the same
masks: float64 1e-12, float32 1e-5, gradients and steps at 100 x) and
three flow-VI steps on the ARD GP through both kernels (float64, against
CPU tensors on the same draws, 1e-8).  The time-series engines: numpy data
lands on the card, and the Kalman, HMM and BOCPD likelihoods and an IBIS
run on the same draws match the CPU (float64, 1e-10).  The single-card
parallel engines (float64, against CPU tensors on the same draws): parallel
SMC, HMC over 3 warmup iterations and IBIS, 1e-12; the parallel ensemble
on an ARD GP through both kernels, 1e-10, one launch of each a density call.
"""

import math

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
    the device.  The same holds for a warmup iteration split over 4 shards
    on the card, its collectives included."""
    from bayesianinference_tpu_torch.core.transforms import box_bijection
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.engines.hmc import z_space_density
    from bayesianinference_tpu_torch.models.problem import define_inference_problem
    from bayesianinference_tpu_torch.ops import hmc
    from bayesianinference_tpu_torch.parallel.sharding import ShardAxis

    problem = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(4)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * 4, device=cuda, dtype=torch.float32)
    dens = z_space_density(problem, box_bijection(problem.lower, problem.upper))
    g = torch.Generator(device=cuda).manual_seed(6)
    state = hmc.hmc_init(torch.randn((64, 4), generator=g, device=cuda), dens)
    draws = hmc.hmc_draws(g, 64, 4, dtype=torch.float32)
    inv_mass = torch.ones((4,), device=cuda)
    # a warmup iteration split over 4 shards on the card: each shard's trajectory, the mean acceptance across
    # them, the dual-averaging update and the shards' moments merged, all without a host read
    shards = ShardAxis([cuda] * 4, cuda)
    parts = [hmc.hmc_init(x, dens) for x in shards.split(torch.randn((64, 4), generator=g, device=cuda))]
    iteration = hmc._FixedLength([dens] * 4, 8, shards)
    split_draws = [type(draws)(*f) for f in zip(*(shards.split(a) for a in hmc.hmc_draws(g, 64, 4)))]
    masses, factors = shards.send(inv_mass), shards.send(hmc.momentum_factor(inv_mass))
    da = hmc.dual_averaging_init(torch.full((), 0.3, device=cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, prob = hmc.hmc_step(draws, state, dens, 0.3, inv_mass, 8)
        parts, ap_mean = iteration.step(split_draws, parts, torch.exp(da.log_eps), masses, factors, 0, True)
        da = hmc.dual_averaging_update(da, ap_mean)
        merged = shards.welford([hmc._Welford.empty(st.x, False).merge(st.x) for st in parts])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.proposed.sum()) == 64 and float(prob.mean()) > 0.5
    assert sum(int(st.proposed.sum()) for st in parts) == 64 and merged[2] == 64 and bool(torch.isfinite(da.log_eps))


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


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_bnn_forward_and_training_steps_on_the_card_match_the_cpu(cuda, dtype, tol):
    """The reference's default net (depth 4, width 100, p = 0.25) on the same
    masks: its forward pass, the alpha-divergence loss (k = 10) and its
    gradient, and two Adam steps on the card against CPU tensors (gradient
    and steps at 100 x the tolerance)."""
    from bayesianinference_tpu_torch import bnn

    g = torch.Generator().manual_seed(0)
    x = torch.rand((64, 1), generator=g, dtype=dtype) * 4 - 2
    y = torch.sin(2 * x[:, 0]) + 0.1 * torch.randn(64, generator=g, dtype=dtype)
    net = bnn.regression_net()
    params = net.init(g, x[:1])
    masks = net.draw_masks(g, 64, 10, dtype=dtype)
    dev = {k: v.to(cuda) for k, v in params.items()}
    card_masks = [m.to(cuda) for m in masks]

    def rel(a, b):
        return ((a.detach().cpu() - b.detach()).abs().max() / b.detach().abs().max().clamp(min=1.0)).item()

    assert rel(net(x.to(cuda), card_masks, params=dev), net(x, masks, params=params)) <= tol
    vals = []
    for p, xx, yy, mm in ((dev, x.to(cuda), y.to(cuda), card_masks), (params, x, y, masks)):
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = bnn.regression_loss(net, p, None, xx, yy, alpha=0.5, sample_number=10, masks=mm)
        vals.append([loss, *torch.autograd.grad(loss, list(p.values()))])
    assert rel(vals[0][0], vals[1][0]) <= tol
    assert max(rel(a, b) for a, b in zip(vals[0][1:], vals[1][1:])) <= 100 * tol
    draws = [bnn.BNNStepDraws(None, net.draw_masks(g, 64, 10, dtype=dtype)) for _ in range(2)]
    kw = dict(num_steps=2, initial_params=params, learning_rate=1e-3)
    got = bnn.train_regression_net(net, None, x.to(cuda), y.to(cuda), draws=[
        bnn.BNNStepDraws(None, [m.to(cuda) for m in d.masks]) for d in draws], **{**kw, "initial_params": dev})
    want = bnn.train_regression_net(net, None, x, y, draws=draws, **kw)
    assert max(rel(got.params[k], want.params[k]) for k in want.params) <= 100 * tol


def test_flow_steps_on_the_gp_on_the_card_match_the_cpu(cuda, monkeypatch):
    """Three flow-VI steps on the ARD GP (each a value and gradient through
    both kernels and both reverse rules at B = 16) and the final PSIS batch
    in chunks, against the same on CPU tensors on the same draws, 1e-8."""
    from bayesianinference_tpu_torch.engines import flow_vi, vi

    problem, plain = _ard_problem(cuda), _ard_problem("cpu")
    g = torch.Generator().manual_seed(4)
    init = flow_vi._init_flow(g, problem.dim, 6, 32, torch.float64, "cpu")
    draws = vi.vi_draws(g, 3, 16, 64, problem.dim)
    monkeypatch.setattr(vi, "EVAL_CHUNK", 24)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    kw = dict(num_steps=3, num_elbo_samples=16, final_evidence_samples=64)
    card_init = {"couplings": [{k: v.to(cuda) for k, v in c.items()} for c in init["couplings"]],
                 "affine": {k: v.to(cuda) for k, v in init["affine"].items()}}
    got = flow_vi.flow_vi_fit(problem, None, initial_params=card_init,
                              draws=vi.VIDraws(*(a.to(cuda) for a in draws)), **kw)
    want = flow_vi.flow_vi_fit(plain, None, initial_params=init, draws=draws, **kw)
    assert gk.se_covariance_cuda.launches - before[0] >= 6 and gk.cholesky_cuda.launches - before[1] >= 6
    for a, b in ((got.elbo_history, want.elbo_history), (got.elbo, want.elbo), (got.log_evidence, want.log_evidence),
                 *zip(flow_vi._leaves(got.params), flow_vi._leaves(want.params))):
        assert _rel_to(a, b) <= 1e-8


def test_time_series_entry_points_default_to_the_card_and_match_the_cpu(cuda):
    """The time-series engines: numpy data lands on the card when no device
    is named, and the Kalman, HMM and BOCPD likelihoods, a particle filter on
    the same draws and an IBIS run on the same draws agree with the same on
    CPU tensors (float64, 1e-10 of the largest entry)."""
    from bayesianinference_tpu_torch import dists as td
    from bayesianinference_tpu_torch.engines import changepoint, hmm, ibis, particle, ssm
    from bayesianinference_tpu_torch.ops import hmm as ohmm
    from bayesianinference_tpu_torch.ops import kalman
    from bayesianinference_tpu_torch.ops import particle as opf
    from bayesianinference_tpu_torch.ops.bocpd import gaussian_upm

    rng = np.random.default_rng(0)
    y = rng.normal(size=60)
    theta = np.array([[0.3, 0.8], [0.1, 1.2]])
    for method in ("sequential", "parallel"):
        probs = {dev: ssm.define_state_space_model(
            y, lambda th: ssm.structural_lgssm([ssm.level_component(th[0])], obs_var=th[1]),
            parameters=[("lv", 1e-4, 10.0), ("ov", 1e-4, 10.0)], prior_distribution=["scale", "scale"],
            validate=False, method=method, device=dev, dtype=torch.float64) for dev in (None, "cpu")}
        assert probs[None].device.type == "cuda" and probs["cpu"].device.type == "cpu"
        a = probs[None].guarded_log_likelihood(torch.as_tensor(theta, device=cuda))
        b = probs["cpu"].guarded_log_likelihood(torch.as_tensor(theta))
        assert _rel_to(a, b) <= 1e-10
    assert ssm.level_component(0.3).transition.device.type == "cuda"

    yt = torch.as_tensor(y)

    def hmm_builder(ys):
        def build(th):
            chain = ohmm.HMM(torch.log(torch.full((2,), 0.5, dtype=th.dtype, device=th.device)),
                             ohmm.row_stochastic(th[2:][:, None]))
            return chain, -0.5 * (ys[:, None] - th[:2][None, :]) ** 2
        return build

    params = [("m0", -6.0, 0.0), ("m1", 0.0, 6.0), ("a", -6.0, 6.0), ("b", -6.0, 6.0)]
    hp = hmm.define_hidden_markov_model(hmm_builder(yt.to(cuda)), params, prior_distribution=["location"] * 4,
                                        validate=False, dtype=torch.float64)
    hc = hmm.define_hidden_markov_model(hmm_builder(yt), params, prior_distribution=["location"] * 4,
                                        validate=False, device="cpu", dtype=torch.float64)
    assert hp.device.type == "cuda"
    th4 = torch.tensor([[-1.0, 1.0, 2.0, 2.0]], dtype=torch.float64)
    assert _rel_to(hp.guarded_log_likelihood(th4.to(cuda)), hc.guarded_log_likelihood(th4)) <= 1e-10

    cp = changepoint.define_changepoint_model(y, lambda th: (gaussian_upm(), th[0]), [("h", 1e-3, 0.5)],
                                              prior_distribution=["scale"], validate=False)
    cc = changepoint.define_changepoint_model(yt, lambda th: (gaussian_upm(), th[0]), [("h", 1e-3, 0.5)],
                                              prior_distribution=["scale"], validate=False)
    assert cp.device.type == "cuda"
    h = torch.tensor([[0.05]], dtype=torch.float64)
    assert _rel_to(cp.guarded_log_likelihood(h.to(cuda)), cc.guarded_log_likelihood(h)) <= 1e-10

    # a particle filter and a PMMH run on numpy data default to the card
    def ar1(dev):
        return opf.ParticleModel(lambda g, n: torch.zeros((n, 1), dtype=torch.float64, device=dev),
                                 lambda g, x, t: 0.8 * x + 0.3 * torch.randn(x.shape, generator=g, dtype=x.dtype,
                                                                             device=dev),
                                 lambda x, y_t, t: -0.5 * (y_t - x[:, 0]) ** 2)

    u = torch.rand(60, dtype=torch.float64)
    g_card = torch.Generator(device=cuda).manual_seed(0)
    card = opf.particle_filter(ar1(cuda), yt.to(cuda)[:, None], 64, g_card, uniforms=u.to(cuda))
    assert card.filter_means.device.type == "cuda" and bool(torch.isfinite(card.log_likelihood))
    res = particle.pmmh_sample(lambda th: ar1(cuda), y[:, None], [("phi", 0.3, 0.99)], g_card, num_particles=32,
                               num_samples=3, num_warmup=3, num_chains=2)
    assert res.samples.device.type == "cuda"

    problem_kw = dict(parameters=[("mu", -10.0, 10.0)], log_likelihood=lambda th: th.sum() * 0.0, validate=False,
                      dtype=torch.float64)
    from bayesianinference_tpu_torch.models import define_inference_problem

    pc = define_inference_problem(prior_distribution=td.Product((td.Normal(torch.tensor(0.0, device=cuda),
                                                                           torch.tensor(2.0, device=cuda)),)),
                                  device=cuda, **problem_kw)
    ph = define_inference_problem(prior_distribution=td.Product((td.Normal(torch.tensor(0.0), torch.tensor(2.0)),)),
                                  device="cpu", **problem_kw)
    gh = torch.Generator().manual_seed(5)
    start = torch.randn((128, 1), generator=gh, dtype=torch.float64)
    draws = [ibis.ibis_stage_draws(gh, 128, 1, 4, dtype=torch.float64) for _ in range(6)]
    pw = lambda th, yy: -0.5 * (yy - th[0]) ** 2  # noqa: E731
    got = ibis.ibis_sampler(pc, pw, yt.to(cuda), None, n_particles=128, batch_size=10, mcmc_steps=4,
                            starting_points=start.to(cuda),
                            draws=[ibis.IBISStageDraws(*(a.to(cuda) for a in d)) for d in draws])
    want = ibis.ibis_sampler(ph, pw, yt, None, n_particles=128, batch_size=10, mcmc_steps=4, starting_points=start,
                             draws=draws)
    assert bool((got.resampled.cpu() == want.resampled).all())
    assert _rel_to(got.log_predictives, want.log_predictives) <= 1e-10
    assert _rel_to(got.particles, want.particles) <= 1e-10
    fr = kalman.kalman_filter(kalman.LGSSM(*(torch.eye(1, dtype=torch.float64, device=cuda),) * 4,
                                           torch.zeros(1, dtype=torch.float64, device=cuda),
                                           torch.eye(1, dtype=torch.float64, device=cuda)), y)
    assert fr.log_likelihood.device.type == "cuda"


def _box2(dev):
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models import define_inference_problem

    return define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                    log_likelihood=lambda th: Normal(0.0, 1.0).log_prob(th).sum(),
                                    prior_distribution=["location", "location"], validate=False, device=dev,
                                    dtype=torch.float64)


def test_parallel_smc_hmc_and_ibis_on_the_card_match_the_cpu_on_the_same_draws(cuda):
    """chip_smoke.py 20a, 20b and 20d at small sizes (float64, the card
    against CPU tensors on the same draws, 1e-12 of the largest entry):
    parallel SMC (4 runs x 64 particles), parallel HMC over 3 warmup
    iterations (diagonal, dense and ChEES; rounding grows through dual
    averaging, 2.2e-12 after 6 on one start, tests/test_torch_parallel_smc_hmc.py),
    ChEES also at 60 + 40 (5e-11) and parallel IBIS;
    a problem built without a device lands on the card."""
    from bayesianinference_tpu_torch import dists as td
    from bayesianinference_tpu_torch.engines.ibis import IBISStageDraws, ibis_stage_draws
    from bayesianinference_tpu_torch.engines.smc import SMCStageDraws
    from bayesianinference_tpu_torch.models import define_inference_problem
    from bayesianinference_tpu_torch.ops.chees import ChEESDraws, chees_draws
    from bayesianinference_tpu_torch.ops.hmc import HMCDraws, _phase_lengths, hmc_draws
    from bayesianinference_tpu_torch.parallel import parallel_hmc, parallel_ibis, parallel_smc

    card, host = _box2(None), _box2("cpu")
    assert card.device.type == "cuda"
    g = torch.Generator().manual_seed(0)
    start = 8.0 * torch.rand((4, 64, 2), generator=g, dtype=torch.float64) - 4.0
    draws = [SMCStageDraws(torch.rand(4, generator=g, dtype=torch.float64),
                           torch.randn((256, 2, 4), generator=g, dtype=torch.float64),
                           torch.log(torch.rand((256, 4), generator=g, dtype=torch.float64))) for _ in range(30)]
    kw = dict(num_runs=4, n_particles=64, mcmc_steps=4)
    a = parallel_smc(card, None, starting_points=start.to(cuda), draws=[SMCStageDraws(*(t.to(cuda) for t in d))
                                                                         for d in draws], **kw)
    b = parallel_smc(host, None, starting_points=start, draws=draws, **kw)
    assert torch.equal(a.n_stages.cpu(), b.n_stages)
    assert _rel_to(a.log_z_runs, b.log_z_runs) <= 1e-12 and _rel_to(a.particles, b.particles) <= 1e-12

    x0 = 4.0 * torch.rand((8, 2), generator=g, dtype=torch.float64) - 2.0
    for kw in (dict(num_leapfrog=5), dict(num_leapfrog=5, dense_mass=True), dict(num_leapfrog="auto")):
        make, kind = (chees_draws, ChEESDraws) if kw["num_leapfrog"] == "auto" else (hmc_draws, HMCDraws)
        d = make(g, 8, 2, num_trajectories=3 + 3, dtype=torch.float64)
        a = parallel_hmc(card, None, num_chains=8, num_warmup=3, num_samples=3, starting_points=x0.to(cuda),
                         draws=kind(*(t.to(cuda) for t in d)), **kw)
        b = parallel_hmc(host, None, num_chains=8, num_warmup=3, num_samples=3, starting_points=x0, draws=d, **kw)
        for f in ("samples", "step_size", "inv_mass_diag", "trajectory_length"):
            assert _rel_to(getattr(a, f), getattr(b, f)) <= 1e-12, (kw, f)
    # ChEES at the JAX smoke configuration, 60 + 40: the card against the CPU at most 5e-11, the spread JAX shows
    # against itself there over four keys (1e-15 to 5e-11); the card read 2.0e-15 to 3.1e-14 over seeds 0-3
    # (tests/chees_card_gap_study.py, NVIDIA H100 80GB HBM3, 700.00 W)
    d = chees_draws(g, 8, 2, num_trajectories=sum(_phase_lengths(60)) + 40, dtype=torch.float64)
    kw = dict(num_chains=8, num_warmup=60, num_samples=40, num_leapfrog="auto", starting_points=x0)
    a = parallel_hmc(card, None, draws=ChEESDraws(*(t.to(cuda) for t in d)), **dict(kw, starting_points=x0.to(cuda)))
    b = parallel_hmc(host, None, draws=d, **kw)
    for f in ("samples", "step_size", "inv_mass_diag", "trajectory_length"):
        assert _rel_to(getattr(a, f), getattr(b, f)) <= 5e-11, ("ChEES 60 + 40", f)

    y = torch.as_tensor(np.random.default_rng(3).normal(0.8, 1.0, size=40))
    prior = lambda dev: td.Product((td.Normal(torch.tensor(0.0, device=dev), torch.tensor(2.0, device=dev)),))  # noqa: E731
    probs = [define_inference_problem(parameters=[("mu", -10.0, 10.0)], log_likelihood=lambda th: th.sum() * 0.0,
                                      prior_distribution=prior(dev), validate=False, device=dev, dtype=torch.float64)
             for dev in (cuda, "cpu")]
    pw = lambda th, yy: td.Normal(th[0], 1.0).log_prob(yy)  # noqa: E731
    start = 2.0 * torch.randn((256, 1), generator=g, dtype=torch.float64)
    draws = [ibis_stage_draws(g, 256, 1, 6, dtype=torch.float64) for _ in range(8)]
    a = parallel_ibis(probs[0], pw, y.to(cuda), None, n_particles=256, batch_size=5, mcmc_steps=6,
                      starting_points=start.to(cuda), draws=[IBISStageDraws(*(t.to(cuda) for t in d)) for d in draws])
    b = parallel_ibis(probs[1], pw, y, None, n_particles=256, batch_size=5, mcmc_steps=6, starting_points=start,
                      draws=draws)
    assert torch.equal(a.resampled.cpu(), b.resampled) and bool(b.resampled.any())
    for f in ("particles", "log_predictives", "ess_history"):
        assert _rel_to(getattr(a, f), getattr(b, f)) <= 1e-12, f


def test_parallel_ensemble_on_a_gp_through_both_kernels_matches_the_cpu(cuda):
    """chip_smoke.py 20c at n = 64 (float64): the parallel ensemble on an ARD
    GP's five hyperparameters, every density call through both kernels at
    B = 8 (16 at the start), against CPU tensors on the same draws for 5
    sweeps, 1e-10 of the largest entry."""
    from bayesianinference_tpu_torch.ops.ensemble import ensemble_draws
    from bayesianinference_tpu_torch.parallel import parallel_ensemble

    card, host = _ard_problem(cuda, d=3), _ard_problem("cpu", d=3)
    g = torch.Generator().manual_seed(1)
    start = 2.0 * torch.rand((16, 5), generator=g, dtype=torch.float64) - 1.0
    rows = [ensemble_draws(g, 16, 5, dtype=torch.float64) for _ in range(5)]
    draws = tuple(type(rows[0][h])(*(torch.stack(f) for f in zip(*(r[h] for r in rows)))) for h in range(2))
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    a = parallel_ensemble(card, None, num_walkers=16, num_warmup=0, num_samples=5, starting_points=start.to(cuda),
                          draws=tuple(type(h)(*(t.to(cuda) for t in h)) for h in draws))
    assert gk.se_covariance_cuda.launches - before[0] == 11 and gk.cholesky_cuda.launches - before[1] == 11
    b = parallel_ensemble(host, None, num_walkers=16, num_warmup=0, num_samples=5, starting_points=start, draws=draws)
    assert _rel_to(a.samples, b.samples) <= 1e-10 and _rel_to(a.acceptance_rates, b.acceptance_rates) <= 1e-10


def test_sharded_gp_on_a_four_shard_mesh_runs_both_kernels_on_every_shard(cuda):
    """The row-sharded GP on 4 shards (one a card where there are four, else
    all on the one): each assembly one SE launch a shard, the blocked logML
    and Cholesky at least one Cholesky launch a panel, each against CPU
    tensors on a CPU mesh (float64, 1e-10 of the largest entry)."""
    from bayesianinference_tpu_torch.parallel import (make_mesh, sharded_cholesky, sharded_covariance_matrix,
                                                      sharded_gp_logml_blocked, sharded_gp_predict)

    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if count >= 4 else ["cuda:0"] * 4
    mesh, host = make_mesh(("data",), devices=devices), make_mesh(("data",), devices=["cpu"] * 4)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-2, 2, (1024, 3)))
    y = torch.sin(x[:, 0]) + 0.1 * torch.tensor(rng.normal(size=1024))
    kern = gk.se_kernel(1.3, 0.8)
    before = gk.se_covariance_cuda.launches
    k_card = sharded_covariance_matrix(kern, x.to(cuda), mesh, nugget=0.1)
    assert gk.se_covariance_cuda.launches - before == 4
    assert [str(k_card[i].device) for i in range(4)] == [str(torch.device(d)) for d in devices]
    k_host = sharded_covariance_matrix(kern, x, host, nugget=0.1).gather()
    assert _rel_to(k_card.gather("cpu"), k_host) <= 1e-10
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    got = sharded_gp_logml_blocked(kern, x.to(cuda), y.to(cuda), mesh, nugget=0.1, block=128)
    assert gk.se_covariance_cuda.launches - before[0] == 4 and gk.cholesky_cuda.launches - before[1] >= 1024 // 128
    assert _rel_to(got, sharded_gp_logml_blocked(kern, x, y, host, nugget=0.1, block=128)) <= 1e-10
    before = gk.cholesky_cuda.launches
    l_card, logdet = sharded_cholesky(k_card, mesh, block=256)
    assert gk.cholesky_cuda.launches - before >= 1024 // 256
    l_host, logdet_host = sharded_cholesky(k_host, host, block=256)
    assert _rel_to(l_card.gather("cpu"), l_host.gather()) <= 1e-10 and _rel_to(logdet, logdet_host) <= 1e-10
    xq = torch.tensor(rng.normal(size=(17, 3)))
    mean, std = sharded_gp_predict(kern, x.to(cuda), y.to(cuda), xq.to(cuda), mesh, nugget=0.1, block=128)
    mean_h, std_h = sharded_gp_predict(kern, x, y, xq, host, nugget=0.1, block=128)
    assert _rel_to(mean, mean_h) <= 1e-10 and _rel_to(std, std_h) <= 1e-10


def test_sharded_conjugate_sgpr_and_svgp_on_a_card_mesh_match_the_cpu(cuda):
    """The data-sharded BLR (its k x k factor through the Cholesky kernel),
    the SGPR bound and an SVGP fit on a 4-shard card mesh against the same
    on a CPU mesh (float64, 1e-10; the fit's 10 steps 1e-8)."""
    from bayesianinference_tpu_torch.engines.sparse_gp import define_sparse_gaussian_process
    from bayesianinference_tpu_torch.engines.svgp import fit_svgp
    from bayesianinference_tpu_torch.parallel import make_mesh, sharded_bayesian_linear_regression

    count = torch.cuda.device_count()
    mesh = make_mesh(("data",), devices=[f"cuda:{i}" for i in range(4)] if count >= 4 else ["cuda:0"] * 4)
    host = make_mesh(("data",), devices=["cpu"] * 4)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.uniform(-2, 2, (203, 1)))
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * torch.tensor(rng.normal(size=203))
    before = gk.cholesky_cuda.launches
    a = sharded_bayesian_linear_regression(x.to(cuda), y.to(cuda), mesh, degree=3)
    assert gk.cholesky_cuda.launches > before
    b = sharded_bayesian_linear_regression(x, y, host, degree=3)
    assert _rel_to(a.log_evidence, b.log_evidence) <= 1e-10 and _rel_to(a.posterior_parameters.b,
                                                                       b.posterior_parameters.b) <= 1e-10
    params = [("v", 0.05, 20.0), ("l", 0.05, 20.0), ("s2", 1e-3, 2.0)]
    kw = dict(nugget_builder=lambda th: th[2], inducing=16, validate=False, jitter=1e-10)
    th = torch.tensor([[1.3, 0.8, 0.05]], dtype=torch.float64)
    ys = torch.sin(3 * x[:, 0])
    p_card = define_sparse_gaussian_process(x.to(cuda), ys.to(cuda), lambda t: gk.se_kernel(t[0], t[1]), params,
                                            mesh=mesh, **kw)
    p_host = define_sparse_gaussian_process(x, ys, lambda t: gk.se_kernel(t[0], t[1]), params, mesh=host, **kw)
    assert _rel_to(p_card.guarded_log_likelihood(th.to(cuda)), p_host.guarded_log_likelihood(th)) <= 1e-10
    yb = (ys > 0).double()
    kb = lambda t: gk.se_kernel(t[0] ** 2, t[1])  # noqa: E731
    amp_ls = [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)]
    f_card = fit_svgp(x.to(cuda), yb.to(cuda), kb, amp_ls, inducing=8, steps=10, mesh=mesh)
    f_host = fit_svgp(x, yb, kb, amp_ls, inducing=8, steps=10, mesh=host)
    assert _rel_to(f_card.elbo_trace, f_host.elbo_trace) <= 1e-8 and _rel_to(f_card.theta, f_host.theta) <= 1e-8


def test_run_level_engines_split_their_runs_over_the_cards(cuda):
    """Parallel NS and SMC and PMMH on a mesh over every card (4 shards on
    the one card where there is one): the runs or chains of each card run
    as one batch there, on a copy of the problem; NS within 4 sigma and SMC
    within 0.3 of the analytic logZ of the 2-D Gaussian box, PMMH finite on
    its 4 chains."""
    import math

    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.engines.particle import pmmh_sample
    from bayesianinference_tpu_torch.models.problem import define_inference_problem
    from bayesianinference_tpu_torch.ops.particle import ParticleModel
    from bayesianinference_tpu_torch.parallel import make_mesh, parallel_nested_sampling, parallel_smc

    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if count >= 4 else ["cuda:0"] * 4
    problem = define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                       log_likelihood=lambda th: Normal(0.0, 1.0).log_prob(th).sum(),
                                       prior_distribution=["location"] * 2, validate=False, device=cuda,
                                       dtype=torch.float64)
    analytic = 2 * (math.log(math.erf(5 / math.sqrt(2))) - math.log(10.0))
    g = torch.Generator(device=cuda).manual_seed(0)
    ns = parallel_nested_sampling(problem, g, num_runs=8, sample_pool_size=25, monte_carlo_steps=60,
                                  max_iterations=800, min_iterations=30, mesh=make_mesh(("runs",), devices=devices))
    assert abs(float(ns.log_evidence.mean) - analytic) < 4 * float(ns.log_evidence.standard_error)
    smc = parallel_smc(problem, g, num_runs=8, n_particles=200, mcmc_steps=8, mesh=make_mesh(("runs",), devices=devices))
    assert abs(float(smc.log_evidence.mean) - analytic) < 0.3 and smc.log_z_runs.device == problem.device
    y = torch.randn(30, generator=g, device=cuda, dtype=torch.float64)
    model = lambda th: ParticleModel(  # noqa: E731
        lambda gen, n: torch.randn((n, 1), generator=gen, device=gen.device, dtype=torch.float64),
        lambda gen, x, t: th[0] * x + 0.5 * torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype),
        lambda x, yt, t: Normal(x[..., 0], 0.6).log_prob(yt))
    r = pmmh_sample(model, y, [("phi", 0.3, 0.99)], g, num_particles=64, num_samples=5, num_warmup=5, num_chains=4,
                    mesh=make_mesh(("chains",), devices=devices))
    assert r.samples.shape == (4, 5, 1) and bool(torch.isfinite(r.log_likelihoods).all())


def test_pmmh_chains_split_over_the_cards_are_the_unsharded_chains(cuda):
    """PMMH's 8 chains on a mesh over every card (4 shards on the one card
    where there is one), with the filters' noise fixed and every other draw
    given: each chain's path is a function of its start and its draws, so
    the chains that each card runs are the unsharded run's, in its order
    (float64, 1e-12)."""
    from bayesianinference_tpu_torch.engines.particle import pmmh_draws, pmmh_sample
    from bayesianinference_tpu_torch.ops.particle import ParticleModel
    from bayesianinference_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if count >= 4 else ["cuda:0"] * 4
    rng = np.random.default_rng(11)
    p, steps, c = 32, 30, 8
    y = torch.tensor(rng.normal(size=(steps, 1)), device=cuda)
    z0, zs = torch.tensor(rng.normal(size=(p, 1))), torch.tensor(rng.normal(size=(steps, p, 1)))

    def builder(th):
        dev = th.device
        return ParticleModel(lambda g, n: 0.5 * z0.to(dev), lambda g, x, t: th[0] * x + 0.3 * zs.to(dev)[t],
                             lambda x, yt, t: -0.5 * ((yt[0] - x[:, 0]) / 0.4) ** 2)

    draws = pmmh_draws(torch.Generator(device=cuda).manual_seed(12), 12, c, 1, steps, dtype=torch.float64)

    def run(mesh):
        return pmmh_sample(builder, y, [("phi", 0.3, 0.99)], torch.Generator(device=cuda).manual_seed(13),
                           num_particles=p, num_samples=6, num_warmup=6, num_chains=c, draws=draws, mesh=mesh)

    one, split = run(None), run(make_mesh(("chains",), devices=devices))
    for f in ("samples", "log_likelihoods", "acceptance_rate", "proposal_scales"):
        assert _rel_to(getattr(split, f), getattr(one, f).cpu()) <= 1e-12, f


def _coupled_runs(dev, mesh, problems, draws):
    """Parallel HMC (diagonal, dense, ChEES), the ensemble (stretch) and
    IBIS on ``dev``'s problems with ``mesh`` (None: one batch), on the same
    draws: the results by name."""
    from bayesianinference_tpu_torch import dists as td
    from bayesianinference_tpu_torch.engines.ibis import IBISStageDraws
    from bayesianinference_tpu_torch.ops.chees import ChEESDraws
    from bayesianinference_tpu_torch.ops.hmc import HMCDraws
    from bayesianinference_tpu_torch.parallel import make_mesh, parallel_ensemble, parallel_hmc, parallel_ibis

    on = lambda t: t.to(dev)  # noqa: E731
    box, normal = problems
    meshes = {a: None if mesh is None else make_mesh((a,), devices=mesh) for a in ("chains", "walkers", "particles")}
    out = {}
    for name, kw in (("diagonal", dict(num_leapfrog=4)), ("dense", dict(num_leapfrog=4, dense_mass=True)),
                     ("auto", dict(num_leapfrog="auto"))):
        kind = ChEESDraws if name == "auto" else HMCDraws
        out[name] = parallel_hmc(box, None, num_chains=8, num_warmup=6, num_samples=3, mesh=meshes["chains"],
                                 starting_points=on(draws["x0"]), draws=kind(*map(on, draws[name])), **kw)
    ens = tuple(type(h)(*map(on, h)) for h in draws["ensemble"])
    out["ensemble"] = parallel_ensemble(box, None, num_walkers=16, num_warmup=2, num_samples=3, draws=ens,
                                        starting_points=on(draws["walkers"]), mesh=meshes["walkers"])
    out["ibis"] = parallel_ibis(normal, lambda th, v: td.Normal(th[0], 1.0).log_prob(v), on(draws["y"]), None,
                                n_particles=128, batch_size=5, mcmc_steps=4, starting_points=on(draws["particles"]),
                                draws=[IBISStageDraws(*map(on, d)) for d in draws["ibis"]], mesh=meshes["particles"])
    return out


def _coupled_problems(dev):
    from bayesianinference_tpu_torch import dists as td
    from bayesianinference_tpu_torch.models import define_inference_problem

    y = torch.as_tensor(np.random.default_rng(3).normal(0.8, 1.0, size=40), device=dev)
    normal = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)], log_likelihood=lambda th, v: td.Normal(th[0], 1.0).log_prob(v).sum(), data=y,
        prior_distribution=td.Product((td.Normal(torch.tensor(0.0, device=dev, dtype=torch.float64),
                                                 torch.tensor(2.0, device=dev, dtype=torch.float64)),)),
        validate=False, device=dev, dtype=torch.float64)
    return _box2(dev), normal


def _coupled_draws():
    from bayesianinference_tpu_torch.engines.ibis import ibis_stage_draws
    from bayesianinference_tpu_torch.ops.chees import chees_draws
    from bayesianinference_tpu_torch.ops.ensemble import ensemble_draws
    from bayesianinference_tpu_torch.ops.hmc import _phase_lengths, hmc_draws

    g = torch.Generator().manual_seed(21)
    f64 = dict(dtype=torch.float64)
    t = sum(_phase_lengths(6)) + 3
    rows = [ensemble_draws(g, 16, 2, **f64) for _ in range(5)]
    halves = tuple(type(rows[0][h])(*(torch.stack(f) for f in zip(*(r[h] for r in rows)))) for h in range(2))
    return dict(x0=4.0 * torch.rand((8, 2), generator=g, **f64) - 2.0,
                diagonal=hmc_draws(g, 8, 2, num_trajectories=t, **f64),
                dense=hmc_draws(g, 8, 2, num_trajectories=t, **f64),
                auto=chees_draws(g, 8, 2, num_trajectories=t, **f64), ensemble=halves,
                walkers=2.0 * torch.rand((16, 2), generator=g, **f64) - 1.0,
                y=torch.as_tensor(np.random.default_rng(3).normal(0.8, 1.0, size=40)),
                particles=2.0 * torch.randn((128, 1), generator=g, **f64),
                ibis=[ibis_stage_draws(g, 128, 1, 4, **f64) for _ in range(8)])


_COUPLED_FIELDS = {"diagonal": ("samples", "step_size", "inv_mass_diag", "acceptance_rates"),
                   "dense": ("samples", "step_size", "inv_mass_diag", "acceptance_rates"),
                   "auto": ("samples", "step_size", "inv_mass_diag", "trajectory_length"),
                   "ensemble": ("samples", "acceptance_rates"),
                   "ibis": ("particles", "log_evidence", "log_predictives", "ess_history")}


_GP_FIELDS = {"ensemble": ("samples", "acceptance_rates"),
              "hmc": ("samples", "acceptance_rates", "step_size", "inv_mass_diag")}


def _gp_mesh_runs(dev, mesh):
    """Parallel HMC and the ensemble on an ARD GP's five hyperparameters
    (n = 64) through both kernels, on ``mesh``'s devices (None: the
    one-batch run on ``dev``), and the launches by card of each."""
    from bayesianinference_tpu_torch.ops.ensemble import ensemble_draws
    from bayesianinference_tpu_torch.ops.hmc import HMCDraws, _phase_lengths, hmc_draws
    from bayesianinference_tpu_torch.parallel import make_mesh, parallel_ensemble, parallel_hmc

    problem = _ard_problem(dev, d=3)
    g = torch.Generator().manual_seed(22)
    start = (2.0 * torch.rand((16, 5), generator=g, dtype=torch.float64) - 1.0).to(dev)
    rows = [ensemble_draws(g, 16, 5, dtype=torch.float64) for _ in range(3)]
    ens = tuple(type(rows[0][h])(*(torch.stack(f).to(dev) for f in zip(*(r[h] for r in rows)))) for h in range(2))
    hmc = HMCDraws(*(t.to(dev) for t in hmc_draws(g, 8, 5, num_trajectories=sum(_phase_lengths(3)) + 2,
                                                  dtype=torch.float64)))
    on_mesh = lambda axis: None if mesh is None else make_mesh((axis,), devices=mesh)  # noqa: E731
    out = {}
    for name, run in (("ensemble", lambda: parallel_ensemble(problem, None, num_walkers=16, num_warmup=0, num_samples=3,
                                                             starting_points=start, draws=ens,
                                                             mesh=on_mesh("walkers"))),
                      ("hmc", lambda: parallel_hmc(problem, None, num_chains=8, num_warmup=3, num_samples=2,
                                                   num_leapfrog=2, starting_points=start[:8], draws=hmc,
                                                   mesh=on_mesh("chains")))):
        se, chol = (dict(c.launches_by_device) for c in (gk.se_covariance_cuda, gk.cholesky_cuda))
        res = run()
        out[name] = (res, {i: (gk.se_covariance_cuda.launches_by_device[i] - se.get(i, 0),
                               gk.cholesky_cuda.launches_by_device[i] - chol.get(i, 0))
                           for i in dict.fromkeys(torch.device(d).index for d in mesh or [dev])})
    return out


def test_coupled_engines_split_on_the_card_match_the_one_batch_run(cuda):
    """chip_smoke.py 20b-d at small sizes: parallel HMC (diagonal, dense,
    ChEES), the ensemble and IBIS split over 4 shards on the one card
    against the one-batch run on the same draws (float64, 1e-10: the
    cross-shard reductions run in another order), and the GP-slice HMC and
    ensemble through both kernels on the split mesh, against the one-batch
    runs (1e-10)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    problems, draws = _coupled_problems(dev), _coupled_draws()
    one, split = _coupled_runs(dev, None, problems, draws), _coupled_runs(dev, [dev] * 4, problems, draws)
    for name, fields in _COUPLED_FIELDS.items():
        for f in fields:
            assert _rel_to(getattr(split[name], f), getattr(one[name], f).cpu()) <= 1e-10, (name, f)
    gp_one, gp_split = _gp_mesh_runs(dev, None), _gp_mesh_runs(dev, [dev] * 4)
    for name, (res, cards) in gp_split.items():
        assert all(se >= 1 and chol >= 1 for se, chol in cards.values()), (name, cards)
        assert bool(torch.isfinite(res.samples).all()), name
        for f in _GP_FIELDS[name]:
            assert _rel_to(getattr(res, f), getattr(gp_one[name][0], f).cpu()) <= 1e-10, (name, f)


def test_coupled_engines_one_shard_a_card_match_four_shards_on_one_card(cuda):
    """Four cards: each coupled engine split one shard a card against the
    same 4-shard mesh on cuda:0 alone, on the same draws.  Both sum the
    collectives in axis order on cuda:0 and each shard's work is the same
    kernels at the same shapes, so HMC, the ensemble and IBIS agree bit for
    bit; the GP-slice HMC and ensemble launch both kernels on every card
    and agree bit for bit too.  Dynamic NS is the stated exception: each
    card's group of runs draws its chains' numbers from a generator of its
    own, so there its logZ is held within 4 joint standard errors of the
    one-card run."""
    from bayesianinference_tpu_torch.parallel import make_mesh, parallel_dynamic_nested_sampling

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    cards = [torch.device("cuda", i) for i in range(4)]
    home = cards[0]
    problems, draws = _coupled_problems(home), _coupled_draws()
    four, one = _coupled_runs(home, cards, problems, draws), _coupled_runs(home, [home] * 4, problems, draws)
    for name, fields in _COUPLED_FIELDS.items():
        for f in fields:
            assert torch.equal(getattr(four[name], f), getattr(one[name], f)), (name, f)
    gp_four, gp_one = _gp_mesh_runs(home, cards), _gp_mesh_runs(home, [home] * 4)
    for name in gp_four:
        (a, by_card), (b, _) = gp_four[name], gp_one[name]
        assert sorted(by_card) == [0, 1, 2, 3] and all(se >= 1 and chol >= 1 for se, chol in by_card.values())
        assert torch.equal(a.samples, b.samples), name
    box = problems[0]
    kw = dict(sample_pool_size=16, num_batches=4, batch_size=16, monte_carlo_steps=5, post_process_sampling_runs=20)
    runs = [parallel_dynamic_nested_sampling(box, torch.Generator(device=home).manual_seed(11),
                                             mesh=make_mesh(("runs",), devices=m), **kw) for m in (cards, [home] * 4)]
    a, b = (r.log_evidence for r in runs)
    assert abs(float(a.mean) - float(b.mean)) < 4 * math.hypot(float(a.standard_error), float(b.standard_error))


_REGIME_PARAMS = [("mu0", -6.0, 0.0), ("mu1", 0.0, 6.0), ("l01", -6.0, 6.0), ("l10", -6.0, 6.0)]


def _regime_problem_on(dev):
    """``tests/test_torch_hmm.py::regime_problem``'s parallel-method problem
    (300 steps of a sticky two-state chain, unit-variance emissions at -2
    and 2), built on ``dev``."""
    from bayesianinference_tpu_torch.engines import hmm as teng
    from bayesianinference_tpu_torch.ops import hmm as th

    rng = np.random.default_rng(3)
    z = np.zeros(300, int)
    for s in range(1, 300):
        z[s] = z[s - 1] if rng.random() < 0.92 else 1 - z[s - 1]
    y = torch.as_tensor(np.where(z == 0, -2.0, 2.0) + rng.normal(size=300), device=dev)

    def builder(theta):
        hmm = th.HMM(torch.log(torch.full((2,), 0.5, dtype=theta.dtype, device=theta.device)),
                     th.row_stochastic(torch.stack([theta[2], theta[3]])[:, None]))
        mus = torch.stack([theta[0], theta[1]])
        return hmm, -0.5 * (y[:, None] - mus[None, :]) ** 2 - 0.5 * math.log(2 * math.pi)

    return teng.define_hidden_markov_model(builder, parameters=_REGIME_PARAMS, method="parallel",
                                           prior_distribution=["location"] * 4, device=dev, dtype=torch.float64,
                                           generator=torch.Generator(device=dev).manual_seed(0))


@pytest.mark.slow
def test_hmm_ns_evidence_agrees_with_laplace_on_the_card(cuda):
    """The slow oracle of ``tests/test_torch_hmm.py`` (``tests/test_hmm.py:273``
    in JAX: nested sampling with 400 live points against the Laplace
    evidence, within 1.5 nats) on the card, where the CPU run takes more
    than 3000 s."""
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling

    problem = _regime_problem_on(cuda)
    fit = laplace_posterior_fit(problem=problem, generator=torch.Generator(device=cuda).manual_seed(0))
    res = nested_sampling(problem, torch.Generator(device=cuda).manual_seed(1), sample_pool_size=400)
    ns, lap = float(res.log_evidence.mean), float(fit.log_evidence)
    print(f"HMM regime problem on the card: NS logZ {ns:.4f} +- {float(res.log_evidence.standard_error):.4f}, "
          f"Laplace {lap:.4f}, difference {ns - lap:+.4f} (tolerance 1.5); {res.iterations} iterations, "
          f"{res.num_likelihood_evals} likelihood evaluations")
    assert abs(ns - lap) < 1.5
