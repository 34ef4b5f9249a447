"""Where the device time goes on the port's two n = 512 paths, on one NVIDIA GPU.

    python3 chip_profile.py [--repo PATH]

``--repo`` imports ``bayesianinference_tpu_torch`` from another checkout
(default: this one), so that two trees can be profiled in one run on one
card, in turns.  Three workloads, those of ``chip_smoke.py`` phases 4, 7
and 6, and, where the tree has the slice and constrained-HMC chains, four
more, those of phases 8 and 9 (below):

* the GP slice: nested sampling of the SE-kernel GP's hyperparameters at
  n = 512, d = 3, float64 (pool 100, ``num_delete=10``, 100 MC steps), for
  6 iterations; a chain step is one batched likelihood call
  (one ``cholesky`` op call at B = 10);
* the Laplace fit of that problem from 8 fixed starts;
* the GP logML and its hyperparameter gradient at n = 16384, d = 3,
  float32 (``bench.py::bench_gp``): wall ms (median of 3), device ms and
  CUDA kernels of one call, and the peak device memory of the call above
  what was held before it.

For each: the unprofiled wall time (host clock around work ending in a
synchronize; the fit's median of 3), then one run under torch.profiler:
device time (the sum of CUDA kernel durations), CUDA kernels per chain step
or per factorization, the Cholesky kernels' and the SE covariance kernel's
share of device time, and the busy share (device time over unprofiled
wall).  Prints one line per workload and a JSON line last.

The chain workloads: one nested-sampling iteration of the d = 32 oracle by
slice chains (pool 400, 200 deletions, 40 updates) and of the d = 72 oracle
by constrained-HMC chains (pool 512, 448 deletions, 108 four-step
trajectories), and one of the GP with ARD lengthscales (n = 512, d = 20, 22
hyperparameters, pool 100, 10 deletions) by each kind of chain.  The unit is
a batch pass (one density call for all chains of the batch) for the slice
chains and a leapfrog step (a likelihood value-and-gradient, a likelihood
value and two priors) for the constrained-HMC chains.

The HMC workloads, where the tree has ``ops/hmc.py``: one trajectory of
``chip_smoke.py`` phase 13a (8192 chains on the d = 16 box Gaussian in
z-space, float32, 16 leapfrog steps) and of phase 13c (16 chains on the GP
slice's problem, float64, 8 steps: both kernels and both reverse rules per
step); the unit is a leapfrog step (one batched value-and-gradient).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NS_ITERATIONS = 6
CHOL_KERNELS = ("fused_kernel", "diag_block", "panel_trsm", "syrk", "potrf_tile", "trsm_panel", "copy_lower")


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


def _profile(fn):
    """(device ms, CUDA kernels and copies, Cholesky ms, SE covariance ms)
    of one call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # a trace can lose the records of its first kernels: open it with a warm-up step that is traced and dropped
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(10):
            torch.zeros(8, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    # device-side events other than the ranges of user annotations (such as
    # torch.optim's "Optimizer.step#LBFGS.step", which spans the whole step)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa: E731
    return (ms(kernels), len(kernels), ms([e for e in kernels if any(c in e.name for c in CHOL_KERNELS)]),
            ms([e for e in kernels if "se_cov" in e.name]))


def _chain_workloads(smi: str, out: dict) -> None:
    """One iteration on each of chip_smoke.py's phase 8 and 9 problems (the
    d = 72 one with 448 of 512 deletions, 384 there): wall and device time
    per unit, CUDA kernels per unit, the kernels' shares."""
    import chip_smoke
    from bayesianinference_tpu_torch.engines.nested_sampling import generate_starting_points, nested_sampling_loop
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.models.problem import InferenceProblem

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(chip_smoke.ARD_N, chip_smoke.ARD_D))
    y_np = np.sin(x_np[:, 0]) + 0.5 * x_np[:, 1] + 0.1 * rng.normal(size=chip_smoke.ARD_N)
    ard = chip_smoke._ard_gp_problem(*problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64))
    box32, box72 = chip_smoke._gaussian_box_problem(32)[0], chip_smoke._gaussian_box_problem(72)[0]
    # name, problem, pool, loop options, leapfrog steps per iteration (None: count the slice chains' batch passes)
    workloads = (
        ("ns_d32_slice", box32, 400, dict(num_delete=200, monte_carlo_steps=40, monte_carlo_method="slice"), None),
        ("ns_d72_chmc", box72, 512, dict(num_delete=448, monte_carlo_method="chmc"), 432),
        ("gp_ard_slice", ard, 100, dict(num_delete=10, monte_carlo_steps=25, monte_carlo_method="slice"), None),
        ("gp_ard_chmc", ard, 100, dict(num_delete=10, monte_carlo_steps=32, monte_carlo_method="chmc"), 32),
    )
    passes = [0]
    density = InferenceProblem.constrained_log_prior

    def counted(self, theta, threshold):
        passes[0] += 1
        return density(self, theta, threshold)

    for name, problem, pool, kw, leapfrogs in workloads:
        start = generate_starting_points(problem, torch.Generator(device=dev).manual_seed(0), pool)

        def run():
            nested_sampling_loop(problem, start, torch.Generator(device=dev).manual_seed(1), min_iterations=1,
                                 max_iterations=1, **kw)

        run()
        torch.cuda.synchronize()
        InferenceProblem.constrained_log_prior = counted
        try:
            passes[0] = 0
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            InferenceProblem.constrained_log_prior = density
        units, unit, plural = ((passes[0], "batch pass", "batch passes") if leapfrogs is None
                               else (leapfrogs, "leapfrog step", "leapfrog steps"))
        dev_ms, kernels, chol_ms, se_ms = _profile(run)
        out[name] = {"unit": unit, "units": units, "wall_ms_per_unit": wall / units, "device_ms_per_unit": dev_ms / units,
                     "kernels_per_unit": kernels / units, "busy_share": dev_ms / wall,
                     "cholesky_share": chol_ms / dev_ms, "se_covariance_share": se_ms / dev_ms}
        print(f"{name}, one iteration, {kw['num_delete']} chains, {units} {plural}: wall {wall / units:.3f} ms and "
              f"device {dev_ms / units:.3f} ms per {unit} (busy share {dev_ms / wall:.3f}), {kernels / units:.1f} CUDA "
              f"kernels per {unit}, Cholesky {100 * chol_ms / dev_ms:.1f} % and SE covariance "
              f"{100 * se_ms / dev_ms:.1f} % of device time | {smi}", flush=True)


def _hmc_workloads(smi: str, out: dict) -> None:
    """One HMC trajectory of chip_smoke.py's phases 13a and 13c: wall (median
    of 3) and device ms per leapfrog step, CUDA kernels per step, busy share,
    the kernels' shares."""
    import chip_smoke
    from bayesianinference_tpu_torch.core.transforms import box_bijection
    from bayesianinference_tpu_torch.engines.hmc import z_space_density
    from bayesianinference_tpu_torch.engines.nested_sampling import generate_starting_points
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.ops import hmc

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(512, 3))
    y_np = np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=512)
    gp = _gp_problem(*problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64))
    # name, problem, chains, leapfrog steps, step size
    workloads = (("hmc_box_d16", chip_smoke._box_problem_f32(16, dev), 8192, 16, 0.5),
                 ("hmc_gp", gp, 16, 8, 0.05))
    for name, problem, chains, leapfrog, eps in workloads:
        bij = box_bijection(problem.lower, problem.upper)
        density = z_space_density(problem, bij)
        g = torch.Generator(device=dev).manual_seed(0)
        state = hmc.hmc_init(bij.to_z(generate_starting_points(problem, g, chains)), density)
        draws = hmc.hmc_draws(g, chains, problem.dim, dtype=problem.dtype)
        inv_mass = torch.ones(problem.dim, dtype=problem.dtype, device=dev)

        def run():
            hmc.hmc_step(draws, state, density, eps, inv_mass, leapfrog)

        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / leapfrog)
        wall = statistics.median(walls)
        dev_ms, kernels, chol_ms, se_ms = _profile(run)
        dev_ms, kernels = dev_ms / leapfrog, kernels / leapfrog
        out[name] = {"chains": chains, "leapfrog": leapfrog, "wall_ms_per_step": walls, "device_ms_per_step": dev_ms,
                     "kernels_per_step": kernels, "busy_share": dev_ms / wall,
                     "cholesky_share": chol_ms / leapfrog / dev_ms, "se_covariance_share": se_ms / leapfrog / dev_ms}
        print(f"{name}, one trajectory, {chains} chains, {leapfrog} leapfrog steps: wall "
              f"{', '.join(f'{w:.3f}' for w in walls)} ms and device {dev_ms:.3f} ms per leapfrog step (busy share "
              f"{dev_ms / wall:.3f}), {kernels:.1f} CUDA kernels per step, Cholesky "
              f"{100 * chol_ms / leapfrog / dev_ms:.1f} % and SE covariance {100 * se_ms / leapfrog / dev_ms:.1f} % "
              f"of device time | {smi}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is false; this script needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.models.problem import random_domain_points
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(512, 3))
    y_np = np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=512)
    x, y = problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64)
    problem = _gp_problem(x, y)
    out = {"repo": os.path.abspath(args.repo), "device": smi}

    def run_ns():
        nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), sample_pool_size=100, num_delete=10,
                        monte_carlo_steps=100, max_iterations=NS_ITERATIONS, min_iterations=NS_ITERATIONS,
                        post_process_sampling_runs=0)

    run_ns()  # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    gk.cholesky_cuda.launches = 0
    t0 = time.perf_counter()
    run_ns()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    steps = gk.cholesky_cuda.launches
    dev_ms, kernels, chol_ms, se_ms = _profile(run_ns)
    out["gp_slice"] = {"steps": steps, "wall_ms_per_step": wall / steps, "device_ms_per_step": dev_ms / steps,
                       "kernels_per_step": kernels / steps, "cholesky_share": chol_ms / dev_ms,
                       "se_covariance_share": se_ms / dev_ms, "busy_share": dev_ms / wall}
    print(f"GP slice n=512 B=10 f64, {steps} chain steps: wall {wall / steps:.3f} ms/step, device "
          f"{dev_ms / steps:.3f} ms/step (busy share {dev_ms / wall:.3f}), {kernels / steps:.1f} CUDA kernels/step, "
          f"Cholesky {100 * chol_ms / dev_ms:.1f} % and SE covariance {100 * se_ms / dev_ms:.1f} % of device time "
          f"| {smi}", flush=True)

    starts = random_domain_points(torch.Generator().manual_seed(0), problem.lower.cpu(), problem.upper.cpu(), 8,
                                  scale=5.0).to(dev)
    walls = []
    for _ in range(3):
        gk.cholesky_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        laplace_posterior_fit(problem=problem, initial_guess=starts)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    factorizations = gk.cholesky_cuda.launches
    wall = statistics.median(walls)
    dev_ms, kernels, chol_ms, se_ms = _profile(lambda: laplace_posterior_fit(problem=problem, initial_guess=starts))
    out["laplace"] = {"factorizations": factorizations, "wall_ms": walls, "device_ms": dev_ms,
                      "kernels_per_factorization": kernels / factorizations, "cholesky_share": chol_ms / dev_ms,
                      "busy_share": dev_ms / wall}
    print(f"Laplace fit n=512 f64, 8 starts, {factorizations} factorizations: wall ms "
          f"{', '.join(f'{w:.1f}' for w in walls)}, device {dev_ms:.1f} ms (busy share {dev_ms / wall:.3f}), "
          f"{kernels / factorizations:.1f} CUDA kernels per factorization, Cholesky {100 * chol_ms / dev_ms:.1f} % "
          f"of device time | {smi}", flush=True)
    n = 16384
    xg = torch.as_tensor(rng.normal(size=(n, 3)), device=dev, dtype=torch.float32)
    yg = torch.sin(xg[:, 0])
    th0 = torch.tensor([0.0, 0.0, -2.0], device=dev)

    def value_and_grad():
        th = th0.clone().requires_grad_(True)
        k = gk.covariance_matrix(gk.se_kernel(torch.exp(th[0]), torch.exp(th[1])), xg, nugget=torch.exp(th[2]),
                                 symmetrize=False)
        value = gk.gp_log_marginal_likelihood(k, yg)
        return value.detach(), torch.autograd.grad(value, th)[0]

    value_and_grad()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        value_and_grad()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    dev_ms, kernels, chol_ms, se_ms = _profile(value_and_grad)
    out["gp_grad"] = {"n": n, "wall_ms": walls, "device_ms": dev_ms, "kernels": kernels, "peak_mib": peak_mib,
                      "se_covariance_ms": se_ms, "cholesky_ms": chol_ms}
    print(f"GP logML+grad n={n} f32: wall ms {', '.join(f'{w:.1f}' for w in walls)}, device {dev_ms:.1f} ms in "
          f"{kernels} CUDA kernels (SE covariance {se_ms:.3f} ms, Cholesky {chol_ms:.1f} ms), peak device memory "
          f"{peak_mib:.0f} MiB above what was held | {smi}", flush=True)
    del xg, yg
    torch.cuda.empty_cache()
    if os.path.exists(os.path.join(os.path.abspath(args.repo), "bayesianinference_tpu_torch", "ops", "chmc.py")):
        _chain_workloads(smi, out)
    if os.path.exists(os.path.join(os.path.abspath(args.repo), "bayesianinference_tpu_torch", "ops", "hmc.py")):
        _hmc_workloads(smi, out)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
