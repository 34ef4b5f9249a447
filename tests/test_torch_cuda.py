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
