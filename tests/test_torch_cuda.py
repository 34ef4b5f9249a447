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
against the same on CPU tensors (float64).
"""

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
