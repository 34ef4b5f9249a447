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
import dataclasses
import json
import math
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


# ---------------------------------------------------------------------------
# The timing rows of chip_smoke.py phases 14-19 (--smoke-rows).  The smoke run
# keeps every gate and launch count of those phases; their timing-only rows
# run here, under the names they had there.  Phase 5's kernel times, which
# feed the smoke run's kernels line, stay in chip_smoke.py.
# ---------------------------------------------------------------------------


def _unit_costs(runs, reps=1) -> list:
    """Per unit (wall ms, device ms, CUDA kernels) of each ``(name, run,
    least)``: ``run(s)`` does ``s`` units, each of at least ``least`` CUDA
    kernels; by difference of 3 units and 1.  A trace can lose the records
    of its first kernels, so a window that holds fewer than its bound (1
    unit's ``least``; 1 unit's count plus 2 ``least`` for 3) is taken again;
    the differenced device ms must be positive."""
    import chip_smoke as cs

    def profiled(fn, bound, what):
        for attempt in range(5):
            dev_ms, kernels = cs._profile_call(fn, cpu=False, warm=attempt > 0)
            if kernels >= bound:
                return dev_ms, kernels
        raise AssertionError(f"{what}: torch.profiler kept losing kernel records ({kernels} seen, at least "
                             f"{bound} expected)")

    out = []
    for name, run, least in runs:
        w_lo, w_hi = cs._wall_ms(lambda: run(1), reps=reps), cs._wall_ms(lambda: run(3), reps=reps)
        d_lo, k_lo = profiled(lambda: run(1), least, name)
        d_hi, k_hi = profiled(lambda: run(3), k_lo + 2 * least, name)
        wall, devm, kern = (w_hi - w_lo) / 2, (d_hi - d_lo) / 2, (k_hi - k_lo) / 2
        if not (devm > 0 and kern > 0):
            raise AssertionError(f"{name}: per unit device {devm} ms, {kern} CUDA kernels")
        out.append(f"{name}: wall {wall:.2f} ms, device {devm:.3f} ms, {kern:.0f} CUDA kernels, busy share "
                   f"{devm / wall if wall > 0 else math.nan:.3f}")
    return out


def _phase15_times(smi, dev):
    """The kernels at this slice's new shapes against their plain versions,
    their bounds and cholesky_ex (device ms in turns)."""
    import chip_smoke as cs

    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    g = torch.Generator(device=dev).manual_seed(0)
    lines = []
    one32 = torch.full((1,), 2.0, device=dev)
    z = 6.0 * torch.rand((1, cs.SVGP_M, 2), generator=g, device=dev) - 3.0
    points = lambda n: 6.0 * torch.rand((1, n, 2), generator=g, device=dev) - 3.0  # noqa: E731
    for what, x2, n2 in (("K_zz", None, cs.SVGP_M), ("K_zx", points(cs.SVGP_B), cs.SVGP_B),
                         ("K_zx full data", points(cs.SVGP_N), cs.SVGP_N)):
        kw = dict(reps=3, groups=3, per_group=5 if n2 <= cs.SVGP_B else 3)
        ms, plain_ms, _, _ = cs._in_turns(lambda: gk.se_covariance_cuda(z, x2, one32),
                                          lambda: gk.se_covariance_plain(z, x2, one32), **kw)
        bound, by = cs._se_bound(z, x2, one32, None, None)
        lines.append(f"SE {what} [{cs.SVGP_M}, {n2}] f32: {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound:.2e} by "
                     f"{by})")
    lines.append(cs._chol_turns(cs.SVGP_M, torch.float32, dev))
    for dt in (torch.float32, torch.float64):
        x = torch.rand((1, 64, 2), generator=g, device=dev, dtype=dt)
        q = torch.rand((1, 512, 2), generator=g, device=dev, dtype=dt)
        var = torch.ones(1, device=dev, dtype=dt)
        ell = torch.full((1, 2), 0.3, device=dev, dtype=dt)
        for what, x2 in (("capacity [64, 64]", None), ("cross [64, 512]", q)):
            ms, plain_ms, _, _ = cs._in_turns(lambda: gk.se_covariance_cuda(x, x2, var, ell),
                                              lambda: gk.se_covariance_plain(x, x2, var, ell), reps=3, groups=3,
                                              per_group=5)
            bound, by = cs._se_bound(x, x2, var, ell, None)
            lines.append(f"SE BO {what} ARD {str(dt).split('.')[-1]}: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
                         f"{bound:.2e} by {by})")
        lines.append(cs._chol_turns(64, dt, dev))
    cs.log(f"[15 kernel times] device ms in turns: {'; '.join(lines)} | {smi}")


def _phase16_times(smi, dev, problem, pf_problem):
    """16g: the kernels at the slice's new shapes against their plain
    versions, their bounds and cholesky_ex; per ADVI step and per
    Pathfinder iteration wall ms, device ms, CUDA kernels and busy share."""
    import chip_smoke as cs

    from bayesianinference_tpu_torch.engines import pathfinder as pf
    from bayesianinference_tpu_torch.engines import vi
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    g = torch.Generator(device=dev).manual_seed(0)
    lines = []
    # the times do not depend on the values
    x = torch.randn((1, cs.SLICE_N, cs.SLICE_D), generator=g, device=dev, dtype=torch.float64)
    for what, b, data, d in (("ADVI step", 32, x, cs.SLICE_D), ("ELBO chunk", vi.EVAL_CHUNK, x, cs.SLICE_D),
                             ("ARD try", 8, torch.randn((1, cs.ARD_N, cs.ARD_D), generator=g, device=dev,
                                                        dtype=torch.float64), cs.ARD_D)):
        var = 0.5 + torch.rand((b,), generator=g, device=dev, dtype=torch.float64)
        scale = 0.5 + torch.rand((b, d), generator=g, device=dev, dtype=torch.float64)
        if what != "ARD try":
            scale = scale[:, :1].expand(b, d)
        nug = (0.01 + torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)).expand(b, data.shape[1])
        per = 3 if b > 64 else 5
        ms, plain_ms, _, _ = cs._in_turns(lambda: gk.se_covariance_cuda(data, None, var, scale, nug),
                                          lambda: gk.se_covariance_plain(data, None, var, scale, nug), reps=3, groups=3,
                                          per_group=per)
        bound, by = cs._se_bound(data, None, var, scale, nug)
        k = gk.se_covariance_cuda(data, None, var, scale, nug)
        c_ms, c_lib, _, _ = cs._in_turns(lambda: gk.cholesky(k), lambda: torch.linalg.cholesky_ex(k), reps=3, groups=3,
                                         per_group=per)
        c_plain, _ = cs._time_ms(lambda: gk.cholesky_plain(k), reps=3, groups=3, per_group=per)
        c_bound, c_by = cs._chol_bound(b, data.shape[1], 8)
        lines.append(f"{what} B={b} n={data.shape[1]} f64: SE {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound:.3g} by "
                     f"{by}); Cholesky {c_ms:.4f} ms (plain {c_plain:.4f}, cholesky_ex {c_lib:.4f}, bound "
                     f"{c_bound:.3g} by {c_by})")
        del k
    pr9 = []
    for n, dt in ((256, torch.float32), (64, torch.float32), (64, torch.float64)):
        a = torch.randn((1, n, n), generator=g, device=dev, dtype=dt)
        k = a @ a.mT / n + torch.eye(n, device=dev, dtype=dt)
        c_ms, c_lib, _, _ = cs._in_turns(lambda: gk.cholesky(k), lambda: torch.linalg.cholesky_ex(k), reps=3, groups=3,
                                         per_group=5)
        c_plain, _ = cs._time_ms(lambda: gk.cholesky_plain(k), reps=3, groups=3, per_group=5)
        pr9.append(f"n={n} {str(dt).split('.')[-1]} {c_ms:.4f} (plain {c_plain:.4f}, cholesky_ex {c_lib:.4f})")
    # per ADVI step and per Pathfinder iteration (its L-BFGS step and its
    # share of the ELBO block), by difference of fits
    draws = vi.vi_draws(g, 3, 32, 32, problem.dim)
    pf_draws = pf.pathfinder_draws(g, 8, pf_problem.dim, 30, 32)
    # the bounds: about two thirds of the CUDA kernels a complete trace of
    # one unit counts on an H100 (425 and 2113)
    lines += _unit_costs((
        ("ADVI step (B = 32)", lambda s: vi.advi_fit(problem, None, num_steps=s, final_elbo_samples=32,
                                                     draws=vi.VIDraws(draws.steps[:s], draws.final)), 280),
        ("Pathfinder iteration (ARD, 8 paths)", lambda s: pf.pathfinder_fit(pf_problem, None, maxiter=s,
                                                                             num_draws_per_path=32, draws=pf_draws),
         1400)),
        reps=1)
    cs.log(f"[16g kernel times] device ms in turns: {'; '.join(lines)}; the SVGP and BO Cholesky shapes at B = 1, "
           f"kernel ms {'; '.join(pr9)} | {smi}")


def _phase17_times(smi, dev, shapes):
    """17f: the kernels at the slice's new shapes (the predictive's
    symmetric K and cross-covariance, and K's factor, at each B of
    ``shapes``) against their plain versions, bounds and cholesky_ex."""
    import chip_smoke as cs

    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    g = torch.Generator(device=dev).manual_seed(17)
    lines = []
    x = torch.randn((1, cs.SLICE_N, cs.SLICE_D), generator=g, device=dev, dtype=torch.float64)
    xq = torch.randn((1, cs.HOLDOUT_N, cs.SLICE_D), generator=g, device=dev, dtype=torch.float64)
    for what, b in shapes:
        var = 0.5 + torch.rand((b,), generator=g, device=dev, dtype=torch.float64)
        scale = (0.5 + torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)).expand(b, cs.SLICE_D)
        nug = (0.01 + torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)).expand(b, cs.SLICE_N)
        kw = dict(reps=2, groups=2, per_group=3 if b > 64 else 10)
        ms, plain_ms, _, _ = cs._in_turns(lambda: gk.se_covariance_cuda(x, None, var, scale, nug),
                                          lambda: gk.se_covariance_plain(x, None, var, scale, nug), **kw)
        bound, by = cs._se_bound(x, None, var, scale, nug)
        x_ms, x_plain, _, _ = cs._in_turns(lambda: gk.se_covariance_cuda(x, xq, var, scale),
                                           lambda: gk.se_covariance_plain(x, xq, var, scale), **kw)
        x_bound, x_by = cs._se_bound(x, xq, var, scale, None)
        k = gk.se_covariance_cuda(x, None, var, scale, nug)
        c_ms, c_lib, _, _ = cs._in_turns(lambda: gk.cholesky(k), lambda: torch.linalg.cholesky_ex(k), **kw)
        c_plain, _ = cs._time_ms(lambda: gk.cholesky_plain(k), **kw)
        c_bound, c_by = cs._chol_bound(b, cs.SLICE_N, 8)
        lines.append(f"{what} B={b} n={cs.SLICE_N} f64: SE {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound:.3g} by "
                     f"{by}); cross SE [{cs.SLICE_N}, {cs.HOLDOUT_N}] {x_ms:.4f} ms (plain {x_plain:.4f}, bound "
                     f"{x_bound:.3g} by {x_by}); Cholesky {c_ms:.4f} ms (plain {c_plain:.4f}, cholesky_ex "
                     f"{c_lib:.4f}, bound {c_bound:.3g} by {c_by})")
        del k
    cs.log(f"[17f kernel times] device ms in turns: {'; '.join(lines)} | {smi}")


def _phase18_bnn_units(smi, dev, beside="alone on the card"):
    """18a's per-unit rows at the defaults (f32, n = 256): a training step
    and a sample_trained_net call (200 samples, 31 points); ``beside``
    says what else ran."""
    import chip_smoke as cs

    from bayesianinference_tpu_torch import bnn

    x_np, y_np = cs._sine_data()
    x, y = torch.as_tensor(x_np, device=dev), torch.as_tensor(y_np, device=dev)
    net = bnn.regression_net()
    g = torch.Generator(device=dev).manual_seed(1)
    init = net.init(g, x[:1])
    draws = [bnn.BNNStepDraws(None, net.draw_masks(g, cs.BNN_N, 10, dtype=torch.float32)) for _ in range(3)]
    # the bounds: about two thirds of the CUDA kernels a complete trace of
    # one unit counts on an H100 (214 and 54-67)
    rows = _unit_costs((
        ("training step", lambda s: bnn.train_regression_net(net, None, x, y, initial_params=init, num_steps=s,
                                                             draws=draws[:s]), 140),
        ("sample_trained_net (200 samples, 31 points)",
         lambda s: [bnn.sample_trained_net(net, init, g, x[:31], num_samples=200).std() for _ in range(s)], 44)))
    cs.log(f"[18a BNN units] at the defaults (f32, n = {cs.BNN_N}), {beside}: {'; '.join(rows)} | {smi}")


def _phase18_times(smi, dev, problem):
    """18d: the kernels at the flow step's B = 64 (n = 512 f64) against their
    plain versions, bounds and cholesky_ex; per flow step and per ADVI step
    at the same B wall ms, device ms, CUDA kernels and busy share."""
    import chip_smoke as cs

    from bayesianinference_tpu_torch.engines import vi
    from bayesianinference_tpu_torch.engines.flow_vi import flow_vi_fit
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    g = torch.Generator(device=dev).manual_seed(18)
    b = cs.FLOW_GP_B
    x = torch.randn((1, cs.SLICE_N, cs.SLICE_D), generator=g, device=dev, dtype=torch.float64)
    var = 0.5 + torch.rand((b,), generator=g, device=dev, dtype=torch.float64)
    scale = (0.5 + torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)).expand(b, cs.SLICE_D)
    nug = (0.01 + torch.rand((b, 1), generator=g, device=dev, dtype=torch.float64)).expand(b, cs.SLICE_N)
    kw = dict(reps=2, groups=2, per_group=10)
    ms, plain_ms, _, _ = cs._in_turns(lambda: gk.se_covariance_cuda(x, None, var, scale, nug),
                                      lambda: gk.se_covariance_plain(x, None, var, scale, nug), **kw)
    bound, by = cs._se_bound(x, None, var, scale, nug)
    k = gk.se_covariance_cuda(x, None, var, scale, nug)
    c_ms, c_lib, _, _ = cs._in_turns(lambda: gk.cholesky(k), lambda: torch.linalg.cholesky_ex(k), **kw)
    c_plain, _ = cs._time_ms(lambda: gk.cholesky_plain(k), **kw)
    c_bound, c_by = cs._chol_bound(b, cs.SLICE_N, 8)
    del k
    draws = vi.vi_draws(g, 3, b, 64, problem.dim)
    # the bounds: about two thirds of the CUDA kernels a complete trace of
    # one unit counts on an H100 (696-742 and 436)
    parts = _unit_costs((
        (f"flow step at B = {b}", lambda s: flow_vi_fit(problem, g, num_steps=s, num_elbo_samples=b,
                                                        final_evidence_samples=64,
                                                        draws=vi.VIDraws(draws.steps[:s], draws.final)), 490),
        (f"ADVI step (fullrank) at B = {b}", lambda s: vi.advi_fit(problem, None, family="fullrank", num_steps=s,
                                                                   num_elbo_samples=b, final_elbo_samples=64,
                                                                   draws=vi.VIDraws(draws.steps[:s], draws.final)),
         290)),
        reps=1)
    cs.log(f"[18d kernel times] device ms in turns: B={b} n={cs.SLICE_N} f64: SE {ms:.4f} ms (plain "
           f"{plain_ms:.4f}, bound {bound:.3g} by {by}); Cholesky {c_ms:.4f} ms (plain {c_plain:.4f}, cholesky_ex {c_lib:.4f}, bound "
           f"{c_bound:.3g} by {c_by}); {'; '.join(parts)} | {smi}")


def _phase20_units(smi, dev, problem, start):
    """Phase 20's per-unit rows (wall ms, device ms, CUDA kernels, busy
    share, by difference of runs of 3 units and 1): an SMC stage (8 runs x
    200 particles, 8 steps), an HMC trajectory (8 chains, L = 5), an
    ensemble sweep on phase 4's GP slice (32 walkers from ``start``), an
    IBIS stage with a move (2048 particles, 15 steps) and a dynamic-NS loop
    iteration of 8 batched runs (40 AM steps)."""
    import chip_smoke as cs
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.engines import nested_sampling as tns
    from bayesianinference_tpu_torch.engines.smc import SMCConfig, _smc_ladders
    from bayesianinference_tpu_torch.parallel import parallel_ensemble, parallel_hmc, parallel_ibis

    box, _ = cs._gaussian_box_problem(2, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    smc_start = tns.generate_starting_points(box, g, 1600).reshape(8, 200, 2)
    # a ladder of s stages: max_stages caps it (each stage's step is the ESS-targeted one)
    smc = lambda s: _smc_ladders(box, smc_start, g, SMCConfig(max_stages=s, mcmc_steps=8))  # noqa: E731
    hmc_start = tns.generate_starting_points(box, g, 8)
    hmc = lambda s: parallel_hmc(box, g, num_chains=8, num_warmup=1, num_samples=s, num_leapfrog=5,  # noqa: E731
                                 starting_points=hmc_start)
    ens = lambda s: parallel_ensemble(problem, g, num_walkers=32, num_warmup=0, num_samples=s,  # noqa: E731
                                      starting_points=start)
    normal, yd = cs._normal_mean_problem(dev, cs.PAR_DATA)
    pointwise = lambda th, v: dists.Normal(th[0], 1.0).log_prob(v)  # noqa: E731
    ibis = lambda s: parallel_ibis(normal, pointwise, yd[:5 * s], g, n_particles=2048, batch_size=5,  # noqa: E731
                                   mcmc_steps=15, ess_threshold=2.0)
    cfg = tns.make_loop_config(1, monte_carlo_steps=40, monte_carlo_method="adaptive_metropolis")
    dns_start = torch.stack([tns.generate_starting_points(normal, g, 48) for _ in range(8)])

    def dns(s):
        c = dataclasses.replace(cfg, max_iterations=s, min_iterations=s)
        tns.run_loop_batched(normal, tns._init_batch(normal, dns_start, c.capacity), g, c, n_live=48)

    # the bounds: about two thirds of the CUDA kernels tests/parallel_op_counts.py counts a unit
    rows = _unit_costs((("SMC stage (8 runs x 200 particles, 8 steps)", smc, 2700),
                        ("HMC trajectory (8 chains, L = 5)", hmc, 600),
                        ("ensemble sweep on the GP slice (32 walkers, B = 16 a half)", ens, 150),
                        ("IBIS stage with a move (2048 particles, 15 steps)", ibis, 300),
                        ("dynamic-NS loop iteration (8 runs, 40 AM steps)", dns, 3000)))
    cs.log(f"[20 units] {'; '.join(rows)} | {smi}")


def _smoke_rows(smi: str) -> None:
    """The rows: 14a's density call, 14b's, 14c's and 14e's value-and-grad
    walls and Cholesky times, 15a's ELBO step, 15d's suggestions,
    15's kernel times, 16g, 17d's quantile call, 17f, 18a's units, 18d,
    19a-d's density calls, PMMH step and IBIS stage, and phase 20's units.  The sub-phases whose
    rows share their setup run whole with ``times=True`` (their gates too);
    phase 4's NS run gives 16g, 17 and 18 their problem and posterior, and
    19c runs its PMMH oracle in this process."""
    import chip_smoke as cs
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy

    dev = torch.device("cuda")
    _, problem, _, _, (res, _, _) = cs.phase_gp_slice(smi)
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(cs.ARD_N, cs.ARD_D))
    y_np = np.sin(x_np[:, 0]) + 0.5 * x_np[:, 1] + 0.1 * rng.normal(size=cs.ARD_N)
    ard = cs._ard_gp_problem(*problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64))
    with cs._KernelWatch() as watch:
        cs._phase14_classifier(smi, watch, dev, 100, 50, 20, 4, 20, times=True)
        cs._phase14_bridges(smi, watch, dev, cs.BRIDGE_NS, times=True)
        cs._phase14_sgpr(smi, watch, dev, times=True)
        cs._phase14_mogp(smi, watch, dev, times=True)
        cs._phase15_elbo(smi, watch, dev, times=True)
        cs._phase15_bo(smi, watch, dev, times=True)
        _phase15_times(smi, dev)
        _phase16_times(smi, dev, problem, ard)
        cs._phase17_tp_quantiles(smi, watch, dev, res, cs._holdout(dev)[0], times=True)
        _phase17_times(smi, dev, (("predictive", 512), ("regression", res.points.shape[0])))
        _phase18_bnn_units(smi, dev)
        _phase18_times(smi, dev, problem)
        for sub in (cs._phase19a_kalman, cs._phase19b_hmm_bocpd, cs._phase19c_particle, cs._phase19d_ibis):
            sub(smi, dev, times=True)
    w = torch.exp(res.crude_log_posterior_weights)
    _phase20_units(smi, dev, problem, res.points[torch.multinomial(w, 32, replacement=True)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--smoke-rows", action="store_true",
                    help="print the timing rows of chip_smoke.py phases 14-19 instead of the workloads")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: torch.cuda.is_available() is false; this script needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    if args.smoke_rows:
        from chip_smoke import phase_device

        _smoke_rows(phase_device())
        return
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
