"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):

1. device: requires CUDA, prints the card's name and power limit, builds
   the hand-written kernels from ``bayesianinference_tpu_torch/csrc``;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, float32 and float64, at the slice's shapes and around them;
3. NS spine: nested sampling of a 2-D standard Gaussian under the uniform
   box [-5, 5]^2 (analytic logZ = -log 100) to termination;
4. the slice: GP hyperparameter posterior by nested sampling at n = 512,
   d = 3 (float64), then prediction at 64 query points; the kernels'
   launch counters prove the run went through them;
5. kernel times with CUDA events at the slice's shapes.

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

SLICE_N, SLICE_D, SLICE_B = 512, 3, 10
SE_SOURCE = "bayesianinference_tpu_torch/csrc/se_covariance.cu"
CHOL_SOURCE = "bayesianinference_tpu_torch/csrc/cholesky.cu"
SE_REPLACES = "bayesianinference_tpu/ops/gp_kernels.py:436"
CHOL_REPLACES = "bayesianinference_tpu/ops/gp_kernels.py:500"
TOL = {
    # se_covariance: max abs error relative to the variance
    "se": {torch.float64: 1e-12, torch.float32: 1e-5},
    # cholesky: max abs error relative to max |L| (tests/test_gp.py's f32 bound)
    "chol": {torch.float64: 1e-10, torch.float32: 5e-4},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from bayesianinference_tpu_torch import csrc

    t0 = time.perf_counter()
    csrc.load_library()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | kernels built/loaded in {time.perf_counter() - t0:.1f} s")
    return smi


def phase_kernel_parity():
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"se_covariance": 0.0, "cholesky": 0.0}
    for dtype in (torch.float64, torch.float32):
        for b, n1, n2, d in ((1, 50, 50, 1), (10, 512, 512, 3), (3, 1000, 1000, 3), (10, 512, 64, 3)):
            x1 = torch.randn((b, n1, d), generator=g, device=dev, dtype=dtype)
            x2 = x1 if n1 == n2 else torch.randn((b, n2, d), generator=g, device=dev, dtype=dtype)
            var = 0.5 + torch.rand((b,), generator=g, device=dev, dtype=dtype)
            got = gk.se_covariance(x1, x2, var)
            want = gk.se_covariance_plain(x1, x2, var)
            torch.cuda.synchronize()
            err = ((got - want).abs() / var[:, None, None]).max().item()
            if not err <= TOL["se"][dtype]:
                raise AssertionError(f"se_covariance {dtype} {(b, n1, n2, d)}: rel err {err:.3e}")
            if x2 is x1 and not torch.equal(got, got.mT):
                raise AssertionError(f"se_covariance {dtype} {(b, n1, d)}: not bitwise symmetric")
            worst["se_covariance"] = max(worst["se_covariance"], (got - want).abs().max().item())
        for n in (50, 128, 512, 1000):
            for b in (1, 10):
                a = torch.randn((b, n, n), generator=g, device=dev, dtype=dtype)
                k = a @ a.mT + n * torch.eye(n, device=dev, dtype=dtype)
                got = gk.cholesky(k)
                want = gk.cholesky_plain(k)
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                if not err <= TOL["chol"][dtype] * scale:
                    raise AssertionError(f"cholesky {dtype} B={b} n={n}: err {err:.3e} (max|L| {scale:.3e})")
                if torch.count_nonzero(torch.triu(got, 1)).item() != 0:
                    raise AssertionError(f"cholesky {dtype} B={b} n={n}: upper triangle not zero")
                worst["cholesky"] = max(worst["cholesky"], err)
        # non-PD: all-identical points, unit variance, no nugget -> all-ones K
        x = torch.zeros((2, 50, 3), device=dev, dtype=dtype)
        k = gk.se_covariance(x, x, torch.ones(2, device=dev, dtype=dtype))
        for name, fac in (("kernel", gk.cholesky(k)), ("plain", gk.cholesky_plain(k))):
            diag_ok = torch.isfinite(torch.diagonal(fac, dim1=-2, dim2=-1)).all(dim=-1)
            if bool(diag_ok.any()):
                raise AssertionError(f"cholesky {name} {dtype}: non-PD input gave a finite diagonal")
    torch.cuda.synchronize()
    log(f"[2 kernel parity] se_covariance max abs err {worst['se_covariance']:.3e}, "
        f"cholesky max abs err {worst['cholesky']:.3e}; symmetric, upper zero, non-PD -> NaN (f32, f64)")
    return worst


def _time_ms(fn, reps: int = 20):
    """(device ms per call, wall ms per call) of ``fn``, each the median of
    ``reps`` samples after a warm-up, timed with CUDA events.

    Device time: 20 calls enqueued back to back behind a ~50 ms
    ``torch.cuda._sleep``, so the host's dispatch overlaps the sleep and
    the events see only device work.  Wall time: one call between the
    events with an idle device, host dispatch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device, wall = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall.append(start.elapsed_time(end))
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / 20)
    return statistics.median(device), statistics.median(wall)


def phase_kernel_times(smi: str):
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    times = {}
    for dtype in (torch.float64, torch.float32):
        x = torch.randn((SLICE_B, SLICE_N, SLICE_D), generator=g, device=dev, dtype=dtype)
        var = 0.5 + torch.rand((SLICE_B,), generator=g, device=dev, dtype=dtype)
        k = gk.se_covariance_plain(x, x, var) + 1e-2 * torch.eye(SLICE_N, device=dev, dtype=dtype)
        name = "f64" if dtype == torch.float64 else "f32"
        # in turns plain, kernel, kernel, plain; each pair's median
        for op, kern, plain in (
            ("se_covariance", lambda: gk.se_covariance(x, x, var), lambda: gk.se_covariance_plain(x, x, var)),
            ("cholesky", lambda: gk.cholesky(k), lambda: gk.cholesky_plain(k)),
        ):
            p1, k1, k2, p2 = _time_ms(plain), _time_ms(kern), _time_ms(kern), _time_ms(plain)
            times[(op, name)] = tuple(
                statistics.median(pair) for pair in ((k1[0], k2[0]), (p1[0], p2[0]), (k1[1], k2[1]), (p1[1], p2[1]))
            )
    for (op, name), (kd, pd, kw, pw) in times.items():
        log(f"[5 kernel times] {op} {name} B={SLICE_B} n={SLICE_N}"
            f"{f' d={SLICE_D}' if op == 'se_covariance' else ''}: device ms per call kernel {kd:.4f}, "
            f"plain {pd:.4f}; one call with host dispatch kernel {kw:.4f}, plain {pw:.4f} | {smi}")
    return times


def phase_ns_spine(smi: str):
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    dev = torch.device("cuda")
    problem = define_inference_problem(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        device=dev, dtype=torch.float64,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), sample_pool_size=1000,
                          num_delete=100, monte_carlo_steps=100)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    analytic = -math.log(100.0)
    if not (math.isfinite(logz) and math.isfinite(err) and abs(logz - analytic) <= 3 * err):
        raise AssertionError(f"NS spine: logZ {logz} +- {err}, analytic {analytic:.3f}")
    log(f"[3 NS spine] logZ {logz:.4f} +- {err:.4f} (analytic {analytic:.4f}), {res.iterations} iterations, "
        f"{res.num_likelihood_evals} evals in {wall:.2f} s = {res.num_likelihood_evals / wall:.4g} evals/s | {smi}")


def _gp_problem(x, y):
    from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    return define_gaussian_process(
        x, y,
        kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
        nugget_builder=lambda th: th[2] ** 2,
        parameters=[("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)],
        prior_distribution=["scale", "scale", "scale"],
    )


def _grid_log_evidence(problem, res, num: int, chunk: int = 2000) -> float:
    """logZ of the slice by midpoint quadrature in log-hyperparameter space
    (the priors are log-uniform), on a box of +-8 posterior standard
    deviations around the posterior mean, clipped to the prior box; the
    likelihood runs through the kernels in batches of ``chunk``."""
    lo, hi = torch.log(problem.lower), torch.log(problem.upper)
    u = torch.log(res.points)
    w = torch.exp(res.crude_log_posterior_weights)[:, None]
    mu = (w * u).sum(dim=0)
    sd = torch.sqrt((w * (u - mu) ** 2).sum(dim=0))
    a, b = torch.maximum(lo, mu - 8 * sd), torch.minimum(hi, mu + 8 * sd)
    steps = (torch.arange(num, device=u.device, dtype=u.dtype) + 0.5) / num
    axes = [a[i] + steps * (b[i] - a[i]) for i in range(u.shape[1])]
    theta = torch.exp(torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, u.shape[1]))
    ll = torch.cat([problem.guarded_log_likelihood(theta[i:i + chunk]) for i in range(0, theta.shape[0], chunk)])
    log_mean = torch.logsumexp(ll, dim=0) - u.shape[1] * math.log(num)
    return float(log_mean + torch.log((b - a) / (hi - lo)).sum())


def phase_gp_slice(smi: str):
    from bayesianinference_tpu_torch.engines.gp import predict_from_gaussian_process
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(SLICE_N, SLICE_D))
    y_np = np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=SLICE_N)
    xq = torch.as_tensor(rng.normal(size=(64, SLICE_D)), device=dev)
    x, y = problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64)
    problem = _gp_problem(x, y)
    mc_steps = 100
    torch.cuda.synchronize()
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    t0 = time.perf_counter()
    res = nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), sample_pool_size=100,
                          num_delete=10, monte_carlo_steps=mc_steps)
    pred = predict_from_gaussian_process(res, problem, xq)
    mean, std = pred.mean(), torch.sqrt(pred.variance())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    if not (math.isfinite(logz) and math.isfinite(err)):
        raise AssertionError(f"GP slice: logZ {logz} +- {err}")
    if launches["se_covariance"] == 0 or launches["cholesky"] < res.iterations * mc_steps:
        raise AssertionError(f"GP slice: kernel launches {launches} for {res.iterations} iterations")
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(std).all()) and bool((std > 0).all())):
        raise AssertionError("GP slice: non-finite predictive moments")

    # logML through the kernels (here) against the plain versions (the same
    # model on CPU tensors, which dispatch the custom ops to their plain
    # PyTorch versions) on 256 posterior points
    thetas = res.points[:256]
    got = problem.guarded_log_likelihood(thetas).cpu()
    want = _gp_problem(x.cpu(), y.cpu()).guarded_log_likelihood(thetas.cpu())
    lz = -1e300
    sentinel_got, sentinel_want = got <= 0.5 * lz, want <= 0.5 * lz
    if not torch.equal(sentinel_got, sentinel_want):
        raise AssertionError("GP slice: kernel and plain logML put the sentinel in different places")
    ok = ~sentinel_got
    rel = ((got - want).abs() / torch.clamp(want.abs(), min=1.0))[ok]
    max_rel = rel.max().item() if rel.numel() else 0.0
    if not max_rel <= 1e-8:
        raise AssertionError(f"GP slice: kernel vs plain logML rel diff {max_rel:.3e}")
    # logZ against grid quadrature at full width (kernels on the card)
    z_fine, z_coarse = _grid_log_evidence(problem, res, 40), _grid_log_evidence(problem, res, 30)
    grid_err = abs(z_fine - z_coarse)
    if not abs(logz - z_fine) <= 3 * err + grid_err:
        raise AssertionError(f"GP slice: logZ {logz} +- {err} vs grid quadrature {z_fine} (grid err {grid_err:.2e})")
    log(f"[4 GP slice] n={SLICE_N} d={SLICE_D} f64: logZ {logz:.4f} +- {err:.4f}, {res.iterations} iterations, "
        f"{res.num_likelihood_evals} evals in {wall:.2f} s = {res.num_likelihood_evals / wall:.4g} evals/s; "
        f"grid quadrature logZ {z_fine:.4f} (40^3 vs 30^3 differ by {grid_err:.1e}); launches {launches}; logML kernel vs plain max rel diff {max_rel:.3e} on {int(ok.sum())} points "
        f"({int(sentinel_got.sum())} sentinels); predictive mean range [{mean.min().item():.3f}, "
        f"{mean.max().item():.3f}] | {smi}")
    return launches


def main():
    smi = phase_device()
    worst = phase_kernel_parity()
    phase_ns_spine(smi)
    launches = phase_gp_slice(smi)
    times = phase_kernel_times(smi)
    print(json.dumps({"kernels": [
        {"name": "se_covariance", "route": "cuda", "source": SE_SOURCE, "replaces": SE_REPLACES,
         "launches": launches["se_covariance"], "max_abs_err": worst["se_covariance"],
         "ms": times[("se_covariance", "f64")][0], "plain_ms": times[("se_covariance", "f64")][1]},
        {"name": "cholesky", "route": "cuda", "source": CHOL_SOURCE, "replaces": CHOL_REPLACES,
         "launches": launches["cholesky"], "max_abs_err": worst["cholesky"],
         "ms": times[("cholesky", "f64")][0], "plain_ms": times[("cholesky", "f64")][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
