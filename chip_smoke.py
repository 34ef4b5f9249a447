"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is not 0):

1. device: requires CUDA, prints the card's name and power limit, builds
   the hand-written kernels from ``bayesianinference_tpu_torch/csrc``;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, float32 and float64, at the slice's shapes and around them: the
   SE covariance at d = 1 to 40 (both feature paths), n = 1 to 1000
   (ragged, odd row length), B = 1 to 10, the cross shape, with and without
   nugget, scalar and ARD lengthscale, shared and per-matrix data, both
   tile edges, bitwise symmetric and bit-equal to the two-input call, NaN
   propagating; the Cholesky on both of its paths (one launch up to
   n = 640, 256-wide panels above) and on both sides of the panel edges;
3. NS spine: nested sampling of a 2-D standard Gaussian under the uniform
   box [-5, 5]^2 (analytic logZ = -log 100) to termination;
4. the slice: GP hyperparameter posterior by nested sampling at n = 512,
   d = 3 (float64), then prediction at 64 query points; the kernels'
   launch counters prove the run went through them;
5. kernel times with CUDA events at the slice's shapes, and at bench.py's
   n = 16384 (float32), each beside its bound and its library call; the
   SE assembly in one call (lengthscale and nugget fused) against the
   unfused assembly it replaced, and its bulk-asynchronous-store build
   against the default; the Cholesky's two paths against each
   other around the route threshold; CUDA kernel launches per call counted
   by torch.profiler;
6. GP logML and its hyperparameter gradient at bench.py's full width
   (n = 16384, d = 3, float32): through the kernels and the closed-form
   backward, and through the plain versions, each against the plain
   float64 value; wall times of both, and of the K^-1 the backward uses;
   the peak device memory of the forward-and-gradient call;
7. the Laplace fit of phase 4's GP problem from 8 fixed starts through the
   kernels, twice, held against the same fit through the plain versions on
   CPU tensors, and its Gaussian posterior's density at 1000 of its draws
   against the same on the CPU; its logZ beside the nested-sampling logZ
   of phase 4;
8. nested sampling above d = 16 on the analytic oracle (float64, no
   kernel): d = 32 through ``monte_carlo_method="auto"`` (the slice
   chains; pool 400, 300 deletions, 40 updates) and d = 72 through ``auto``
   (the constrained-HMC chains: 36 four-step trajectories per replacement,
   d / 2 where the law takes 1.5 d, at eps = 0.8 / sqrt(72); pool 512, 448
   deletions), each within 4 max(sigma, 0.2) of the analytic logZ (no
   hand-written kernel: both runs go to two worker processes started after
   phase 12, beside phases 13-17, and are gated after phase 17);
9. a GP with ARD lengthscales (n = 512, d = 20: 22 hyperparameters, so
   ``auto`` takes the slice chains) by slice and by constrained-HMC nested
   sampling, three iterations each: both kernels launched at least once
   per batch of counted evaluations, every replacement in the box above
   its threshold; at the final live points' hyperparameters K and its
   factor through the wrappers against the plain versions (B = 10), logML
   through the kernels against the plain versions on CPU tensors (1e-8),
   and for the chmc chains the
   likelihood gradient through both reverse rules at batch size 16 against
   the plain path (1e-6);
10. a run of phase 3's problem (pool 500) cut after 10 iterations, saved,
    loaded and resumed, bit-equal to the uncut run; the same in segments
    through ``nested_sampling(checkpoint_every=15)``; ``dynamic_nested_sampling``
    (20 deletions, chains of 50 steps) against the analytic logZ and the
    static run's posterior ESS;
11. ``parallel_nested_sampling``: (a) four runs of phase 3's problem at its
    per-run settings, the merged logZ within 3 sigma of the analytic one
    and its error bar below phase 3's, one host read of the termination
    test per iteration for all runs; (b) four runs of phase 4's GP problem
    for 20 iterations, every kernel launch at B = 40 (four runs of 10
    chains) after the starting points' one, logML at the merged run's live
    points against the plain versions on CPU tensors (1e-8);
12. Bayesian linear regression at bench.py's width (n = 4096, degree 3,
    float64 and float32) against the textbook normal-inverse-gamma evidence,
    through the Cholesky kernel, with its fits per second; the vector-output
    regression, the Normal, Multinormal and categorical models against the
    same on CPU tensors; precision.py's blr, conjugate-normal, direct
    quadrature (400 x 400 nodes) and two NS bookkeeping checks against
    numpy references, float64 within 1e-10 and float32 within ten times
    PRECISION.json's float32 value or 1e-6;
13. the samplers at the JAX bench's widths: (a) HMC, d = 16 box Gaussian,
    8192 chains, 60 warmup, 64 samples, 16 leapfrog, float32, its
    grad-evals/s, moments, acceptance, divergences, no synchronizing CUDA
    call inside a trajectory (``torch.cuda.set_sync_debug_mode``); (b)
    ChEES on the same problem (1024 chains, 150 warmup, 100 samples,
    max_leapfrog 64, dense mass: its factor through the Cholesky kernel at
    n = 16), one synchronizing call per trajectory, and on tests/test_hmc.py's
    rho = 0.9 Gaussian; (c) HMC on phase 4's GP problem, 16 chains (started
    at draws of phase 4's posterior) through
    both kernels and both reverse rules at B = 16, logML and gradient at
    the final states against the plain path, the posterior against phase
    4's, no synchronizing call inside a trajectory; (d) SMC at bench_smc's width (d = 2, 2 x 32768 particles, 100 MH
    steps, float32) against the analytic logZ and its thermodynamic
    estimate, one synchronizing call per stage; (e) SMC of phase 4's GP problem, 2 x 500 particles, both
    kernels at B = 1000, against phase 4's grid-quadrature logZ, one
    synchronizing call per stage, with its peak device memory; (f) the ensemble at bench_ensemble's width (32768
    walkers, d = 8, float32, 1024 stretch sweeps; 256 DE sweeps).

14. the slice of the latent-GP, sparse, Student-t and multi-output engines:
    (a) the main path, GP classification (Bernoulli logit, Laplace) by
    nested sampling over (amp, ls) at n = 512 (f64, pool 100, 50 deletions,
    at least 20 iterations, 20 AM steps), logZ within 3 sigma of a grid quadrature, every launch at
    the chains' batch, logML and Newton steps at the live points against
    the plain path, its Laplace fit against CPU tensors, predictions at 41
    points; (b) Laplace and EP logML + gradient at n = 512-4096 f32 against
    plain f64; (c) the SGPR bound + gradient at n = 262144, m = 512 f32 and
    its Adam fit against CPU tensors; (d) the Student-t process on phase 4's
    data; (e) the multi-output GP at nT = 8192 f32, and against its
    Kronecker identity; (f) ESS latents at (a)'s mode, against CPU tensors
    on the same draws and against the Laplace latent moments.  Every
    launch of both kernels at a new shape is held against the plain version
    on the same inputs.

15. the stochastic variational GP and Bayesian optimization: (a) the
    SVGP ELBO and its gradient in (theta, z, m, raw) at bench_svgp_step's
    width (n = 262144, M = 256, batch 8192, f32; K_zz's jitter 1e-4 in
    both dtypes) through the kernels and plain against plain f64, each
    quantity's error over 8 data seeds at
    most twice the plain f32 path's plus 1e-6, with the step's peak memory;
    (b) fit_svgp on
    _class_data at n = 262144 (256 farthest inducing points, minibatch
    8192, 300 steps, f32), its full-data bound, its predictions against the
    truth, and an f64 fit against CPU tensors on the same draws (within ten
    times the change that an eps-sized change of K_zz makes to the CPU run,
    or 1e-6, a gate that must reject the same run with K_zz factored in
    float32); (c) the multiclass (C = 3) and heteroscedastic fits, f64,
    against CPU tensors alike;
    (d) Bayesian optimization: Branin's ask/tell run on the JAX test's
    draws (tests/data), the Six-Hump Camel at the default configuration
    (8 + 56 evaluations) in f32 and f64, the f64 history against CPU
    tensors (1e-8), the final states' masked logML and moments against
    plain (printed); (e) laplace_posterior_fit(model=...) against problem= on a
    logistic model at n = 4096, eight schools collapsed by
    marginalize_latents through direct quadrature, and a 256-group random
    effects model at 64 thetas against its closed form (no hand-written
    kernel runs in 15e).

16. ADVI, Pathfinder, bridge sampling and the results layer: (a) ADVI at
    its defaults (3000 steps, 32 draws) on tests/test_vi.py's conjugate
    oracle under its gates, fullrank on its rho = 0.9 Gaussian (no
    hand-written kernel: in phase 8's worker pool after its runs); (b) ADVI
    on phase 4's GP problem, both families, 250 steps (3000 cut), each
    step's value and gradient through both kernels and both reverse rules
    at B = 32, the ELBO under phase 4's grid logZ plus 4 MC standard
    errors, and a 5-step f64 fit on the card against the same fit on CPU
    tensors on the same draws (1e-8); (c) Pathfinder at its defaults on
    the conjugate oracle (tests/test_pathfinder.py's gates), the GP
    (logZ_IS within 0.1 of the grid logZ when pareto k < 0.7, the ELBO
    under it) and phase 9's ARD GP (22 hyperparameters, d > 2J; the ELBO
    under a logZ from bridge sampling of 32 HMC chains, and logZ_IS within
    4 max(relative error, 0.2) of it when k < 0.7), with the ELBO block's
    chunk and peak memory, and the factor at d = 22 > 2J and d = 3 against
    the BFGS inverse Hessian built pair by pair in numpy; (d) hmc_sample(starting_points="pathfinder") on the
    GP at 13c's sizes against phase 4's NS posterior (13c's gate); (e)
    bridge sampling on the conjugate oracle (4000 draws, 5e-3) and on the
    GP from (d)'s and (c)'s draws (3 relative errors + 0.05 of the grid
    logZ); (f) PSIS-LOO and WAIC on a quantile grid of a conjugate Normal
    model's exact posterior against its exact leave-one-out elpd (three
    times the CPU's readings, tests/loo_gate_study.py) and against the same
    on CPU tensors (1e-10), model weights by all three methods, an SBC
    study of the conjugate Normal engine (200 replications) and the
    summary and calculation report of phase 4's NS result, on card
    tensors.

17. the consumption layer: (a) the 24 scalar families' log_prob, cdf and
    icdf on tests/test_dists_scalar.py's grids on the card against CPU
    tensors (1e-12) and scipy (that test's tolerances), the sampling moments
    of 2^20 card draws each under its moment gates, and the port's betainc
    on its 7 x 7 x 29 grid against scipy, per (a, b) cell at most
    max(2 x JAX's error, 1e-13) in float64 and 2 x JAX's + 1e-6 in float32
    (JAX's errors from tests/data/betainc_jax_error.json); (b) phase 4's
    GP predictive at its defaults (S <= 512 posterior samples, n = 512 f64)
    on 512 held-out points of phase 4's data law (seed 1), scored by CRPS,
    log score, PIT, interval coverage (0.5, 0.9) and Dawid-Sebastiani: each
    against the same predictive on CPU tensors (1e-10), the closed-form CRPS
    against the ensemble CRPS of 2^14 draws (4 standard errors), the mean
    CRPS and log score below a constant Normal's, one call under
    utils.profiling.trace and timed; (c) regression_predictive_distribution
    of the GP's posterior moments over every NS point against
    predict_from_gaussian_process(max_samples=None) (1e-10); (d) the
    Student-t process predictive's 0.05 and 0.95 quantiles through
    StudentT.cdf at phase 4's data, at one theta against scipy's t.ppf
    (1e-9) and at 16 against CPU tensors (1e-10); (e) predictive_distribution and
    posterior_predictive_check (2000 replicates) on NS of a conjugate
    Normal model against its exact predictive (4 NS standard errors), the
    Normal exponential family against the conjugate Normal engine (1e-12),
    the mixtures, censoring and a KDE of phase 4's posterior on card
    against CPU tensors (1e-12).

18. the quasi-Bayesian networks and RealNVP flow VI: (a) the MC-dropout
    net trained on the card in float32 on tests/test_bnn.py's data
    (n = 256) at the reference's defaults (depth 4, width 100, p 0.25,
    alpha 0.5, k 10, 2000 Adam steps at 1e-3) and at the JAX test's
    configuration (depth 2, width 48, p 0.1, k 5, 1500 steps at 3e-3),
    each under test_bnn_end_to_end's gates (mean |error| < 0.2, sd > 0.03,
    3-sigma coverage > 0.9, the trained network log evidence above the
    initial one), its forward pass, loss and gradient on the card against
    CPU tensors on the same masks (float64 1e-12, float32 1e-5); (b)
    tests/test_flow_vi.py's
    oracles: the conjugate posterior and evidence (2000 steps), the box and
    scale test (1500 steps), the banana against fullrank ADVI (4000 flow steps at 2e-3, 3000 ADVI steps; the
    slow test's gates) and hmc_sample(starting_points="flow") on the
    banana; (c) flow VI on phase 4's GP problem through both kernels and
    both reverse rules (64 draws a step, 1000 steps, the final 8192 in
    chunks of 1024): pareto k < 0.7, the PSIS logZ within 0.05 of phase
    4's grid logZ and the ELBO at most 0.02 above it.  (b)'s five fits (no
    hand-written kernel in them) run in five worker processes while (a) and
    (c) run, so (a)'s and (c)'s wall times are taken under that load; the
    same pool runs 19c's PMMH oracle first, which goes on into phase 19,
    and 20e's run after the fits, which goes on into phase 20.
19. the time-series engines (no hand-written kernel: the watch holds both
    counters at 0): (a) the Kalman filter, smoother, forecast and
    simulation smoother (both methods, masked steps; the latter on
    diagonal noise, where LAPACK's and cuSOLVER's eigh give one factor)
    against CPU tensors, float64, 1e-12; the parallel filter against the
    sequential one at T = 4097 (1e-10); benchmarks/kalman_throughput.py's
    engine width (level plus period-4 seasonal, 8192 chains, T = 256,
    float32) by both methods and its long series (T = 131072) by the
    parallel method, each float32 run within twice the CPU's float32 error
    of the CPU's float64 plus 1e-6 relative (on 256 chains); Laplace on
    tests/test_ssm.py's local level (T = 400, parallel) against the same
    fit on CPU tensors (1e-6) and the JAX test's gates; (b) the HMM and
    BOCPD enumeration oracles on the card (1e-12); benchmarks/
    hmm_throughput.py's widths (K = 4, 8192 chains, T = 256, both methods;
    K = 8, T = 131072 parallel; BOCPD T = 8192, r_max = 512) under the same
    float32 gate; Laplace on tests/test_bocpd.py's hazard problem against
    CPU tensors; (c) the bootstrap filter against the Kalman likelihood on
    tests/test_particle.py's AR(1) (T = 150, P = 4096, 8 seeds), the
    degenerate RBPF against Kalman (1e-10), PMMH against the exact grid
    posterior (512 particles, 250 + 250 steps, 8 chains; the JAX test's
    gates; a host-bound run with no hand-written kernel, in a worker
    process of 18b's pool from phase 18 on); (d) IBIS against the exact
    evidence and posterior (4096 particles, batch 5, 20 steps).
20. the single-card parallel engines (``parallel/``): (a) parallel SMC at
    tests/test_parallel_smc_hmc.py's configuration (the 2-D Gaussian box,
    8 runs, 200 particles, 8 AM steps), bit for bit ``smc_sampler`` on one
    generator, logZ within 0.3 of the analytic value, the card against CPU
    tensors on the same draws (1e-12); (b) parallel HMC at the JAX smoke
    configuration (8 chains, 60 + 40, L = 5) with the diagonal mass, the
    dense mass (its factor through the Cholesky kernel) and ChEES, each
    against CPU tensors on the same draws: ChEES at 1e-12; the fixed L at
    1e-12 after 3 warmup iterations (rounding grows past that through dual
    averaging) and at 60 + 40 by the moment gate on both sides and the
    step sizes' ratio; and a moment run (64 chains, 150 + 100) gated at 4
    standard errors from its own chains;
    (c) the parallel ensemble on phase 4's GP slice through both kernels
    (32 walkers, B = 16 a half-update, 100 + 600 sweeps from draws of
    phase 4's posterior): the card against CPU tensors on the same draws
    for 5 sweeps (1e-10), the pooled mean within 4 Monte Carlo standard
    errors (batch means, and the NS mean's own) of phase 4's NS posterior
    mean, one launch of each kernel a density call; (d) parallel IBIS on
    the JAX oracle (the normal mean, 40 observations, 2048 particles, batch
    5, 15 steps) under its gates, and against CPU tensors (1e-12); (e)
    parallel dynamic NS on the JAX oracle (8 runs of pool 48, one stage, 40
    steps): |z| < 4 and the posterior mean (a host-bound run with no
    hand-written kernel, in a worker process of 18b's pool from phase 18
    on), its 8 runs on an 8-shard mesh over 20's mesh devices.  Each of
    (b)-(e) also runs its engine split over a 4-shard mesh (one shard a
    card where there are four cards, else all four on the one: the layout
    on a line of its own), each shard its block of the batch on its card
    against its copy of the problem, held against the one-batch run on the
    same draws (1e-10; dynamic NS's shards on one card are one batch, bit
    for bit, and on four cards draw their chains' numbers per card, so
    logZ within 4 joint sigma); (b) also runs parallel HMC on phase 4's GP
    slice (8 chains, 6 + 2 trajectories of 3 leapfrog steps) split over
    the mesh through both kernels and their reverse rules; (b) and (c)
    fail unless every card of the mesh launched both kernels (the wrappers'
    counters by device).
21. the multi-card engines (``parallel/sharding.py`` and the ``sharded_*``
    modules) on a 4-shard mesh, one shard a card where there are four
    cards, else all four on the one (the layout on a line of its own): (a)
    ``sharded_covariance_matrix`` at bench.py's n = 16384, d = 3, f32
    against the single-device op's K (1e-6), one SE launch a shard; (b)
    ``sharded_gp_logml_blocked`` there (block 256) against plain f64 beside
    the single-device kernel path (phase 6's gates), its wall (a second
    call), Cholesky launches and peak memory; (c) ``sharded_cholesky`` at n
    = 4096 f64 against the ``cholesky`` op's factor (1e-10); (d) the
    blocked logML's value and theta-gradient at n = 2048 f64 against the
    single-device kernel path (1e-7); (e) ``sharded_gp_predict`` at n =
    16384, m = 512 f32, mean and std against plain f64 within twice the
    single-device kernel path's error plus 1e-6; (f) the four sharded
    conjugate models at 2^20 rows f64 against the dense engines (1e-10);
    (g) the blocked logML at n = 65536 f32 (a 4 GiB row block a shard)
    against the single-device kernel path's f32 value (5e-5), run after the
    shards are freed, with the peak memory per device; where there are
    four cards, one blocked Cholesky (n = 1024) on the last card against
    the plain version (its shared-memory limits are set per device); (h)
    in a worker process of 18b's pool, the pool-sharded NS on the headline
    problem (pool 128, 8 deletions, 40 steps) against the analytic logZ (4
    sigma) and the single-device run (4 combined sigma), and the runs x
    live x data NS at (2, 2, 2) against the quadrature logZ (4 sigma +
    0.1).
22. 26 of the 31 port examples (``examples_torch/``, the counterparts of
    the JAX package's ``examples/``; ``EXAMPLE_ORDER``, the longest first)
    at smoke size on the card, each in a process of its own (``python
    examples_torch/gates.py NN`` with ``BI_EXAMPLE_SMOKE=1``, one CPU thread,
    its own time limit), ``EXAMPLE_WORKERS`` at a time, started after phase
    5's kernel times and running beside phases 6-20, gated after phase 20
    (before 21): each must exit 0 and pass its checks
    (``examples_torch/gates.py``: an analytic oracle, the truth inside a
    credible band, or for the deterministic fits the same example on CPU
    tensors in the same process); the SE and Cholesky launches each one
    counts (the wrappers' counters in its process) join the JSON line's
    launches.  10, 16, 18, 27 and 30 are left out for the 1200 s limit: at
    smoke size on the card 16 took 714 s and 30 did not end in 1500 s, and
    with 10, 18 and 27 in the pool (six processes) the script took 959 s
    against 740 s without them on a like host, its phases 13-15 slowed
    1.5-2 x by the processes beside them.

The timing-only rows of phases 14-21 (per-unit wall and device ms, CUDA
kernels and busy shares, and each slice's kernel times in turns) are
``chip_profile.py --smoke-rows``'s; this script keeps every gate and launch
count of those phases, and phase 5's kernel times, which feed the JSON line.
A line that phases 6-20 print with a time in it while phase 22's examples
run ends in ``[beside phase 22's examples]``: its wall was taken with those
processes on the card and the host.

Each of phases 4, 6, 7, 9, 11b, 12, 13c, 13e, 14, 15, 16, 17, 18 and 20 (and 13b the Cholesky's)
zeroes the kernels' launch counters before it drives its path and fails if
a kernel of that path was not launched; phase 21 zeroes them before each
sharded call and reads them after it (its single-device and plain
references outside that count); each example of phase 22 counts from 0 in
its own process, and phase 22 fails unless the GP examples (03, 09, 17, 19,
20, 21, 22, 29) launched both kernels; the ``launches`` of the JSON line are their
sum.  Phase 19 zeroes them too and fails if either kernel
launched: no hand-written kernel lies on the time-series path, and it adds
0 to the sum.  Phase 5 fails
unless each kernel is one CUDA kernel launch per call at the slice's shape,
and unless ``covariance_matrix(se_kernel(...), x, nugget)`` is one CUDA
kernel in all.

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import functools
import itertools
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

SLICE_N, SLICE_D, SLICE_B = 512, 3, 10
ARD_N, ARD_D = 512, 20  # the GP with one lengthscale per input
GRAD_N = 16384  # bench.py::bench_gp
PARENT_GRAD_PEAK_MIB = 8193  # chip_profile.py --repo <the parent commit>, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md)
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


_BESIDE_EXAMPLES = []  # non-empty while phase 22's example processes run beside the main phases


def log(msg: str) -> None:
    if _BESIDE_EXAMPLES and (" ms" in msg or "busy share" in msg or "/s" in msg):
        msg += " [beside phase 22's examples]"
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from concurrent.futures import ThreadPoolExecutor

    from bayesianinference_tpu_torch import csrc

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # phase 5's variant of the SE kernel compiles beside the kernels themselves
        variant = pool.submit(_bulk_store_libraries, csrc, se_only=True)
        csrc.load_library()
        variant.result()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | kernels built/loaded in {time.perf_counter() - t0:.1f} s")
    return smi


def _se_plain_in_row_blocks(gk, x1, x2, var, scale, nugget):
    """``se_covariance_plain`` on row blocks small enough for its accurate
    direct-difference form (at most 2^24 elements of [rows, n2, d] per
    matrix, and of [matrices, rows, n2, d] per call: the batches of
    thousands of matrices of the ELBO blocks go a few matrices at a time)."""
    other = x1 if x2 is None else x2
    per_row = other.shape[1] * other.shape[2]
    step = max(1, gk._DIRECT_SQDIST_MAX_ELEMS // per_row)
    b = max(x1.shape[0], var.shape[0])
    b_step = max(1, gk._DIRECT_SQDIST_MAX_ELEMS // (per_row * min(step, x1.shape[1])))

    def part(t, j):
        return t if t is None or t.shape[0] == 1 else t[j:j + b_step]

    k = torch.cat([torch.cat([gk.se_covariance_plain(part(x1, j)[:, i:i + step], part(other, j), part(var, j),
                                                     part(scale, j))
                              for i in range(0, x1.shape[1], step)], dim=1) for j in range(0, b, b_step)], dim=0)
    return k if nugget is None else k + torch.diag_embed(nugget)


def _se_parity_cases():
    """(B, n1, n2 or None for the symmetric call, d, ARD, nugget, shared data,
    tile): every d of both feature paths against every n (ragged, odd row
    length), the flags in rotation; every flag combination and both tile
    edges at the slice's shape; the cross shape; the ARD problem's call
    (d = 20, one lengthscale per matrix and input, shared data, nugget) at
    the chains' batch of 10 and at the gradient check's 16."""
    cases, turn = [], 0
    for d in (1, 3, 8, 9, 40):
        for n in (1, 50, 512, 513, 1000):
            b = (1, 3, 10)[turn % 3]
            cases.append((b, n, None, d, bool(turn & 1), bool(turn & 2), bool(turn & 4), (0, 32, 64)[turn % 3]))
            cases.append((b, n, n, d, bool(turn & 2), False, bool(turn & 1), 0))
            turn += 1
    for ard in (False, True):
        for nugget in (False, True):
            for shared in (False, True):
                cases += [(SLICE_B, SLICE_N, None, SLICE_D, ard, nugget, shared, tile) for tile in (0, 32, 64)]
    cases += [(10, 512, 64, 3, True, False, False, 0), (3, 512, 64, 3, False, False, True, 32),
              (1, 64, 512, 9, True, False, False, 64)]
    cases += [(b, ARD_N, None, ARD_D, True, True, True, 0) for b in (10, 16)]
    return cases


def phase_kernel_parity():
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"se_covariance": 0.0, "cholesky": 0.0}
    rand = lambda *shape, dtype: torch.randn(shape, generator=g, device=dev, dtype=dtype)  # noqa: E731
    cases = _se_parity_cases()
    for dtype in (torch.float64, torch.float32):
        for b, n1, n2, d, ard, with_nugget, shared, tile in cases:
            what = f"se_covariance {dtype} B={b} n1={n1} n2={n2} d={d} ard={ard} nugget={with_nugget} shared={shared} tile={tile}"
            x1 = rand(1 if shared else b, n1, d, dtype=dtype)
            x2 = None if n2 is None else rand(1 if shared else b, n2, d, dtype=dtype)
            var = 0.5 + torch.rand((b,), generator=g, device=dev, dtype=dtype)
            # ARD: one lengthscale per matrix and feature; else a scalar one per matrix, as a stride-0 view
            scale = 0.5 + torch.rand((b, d if ard else 1), generator=g, device=dev, dtype=dtype)
            scale = scale if ard else scale.expand(b, d)
            nugget = (0.01 + torch.rand((b, 1), generator=g, device=dev, dtype=dtype)).expand(b, n1) if with_nugget else None
            got = gk.se_covariance_cuda(x1, x2, var, scale, nugget, tile=tile)
            want = _se_plain_in_row_blocks(gk, x1, x2, var, scale, nugget)
            torch.cuda.synchronize()
            err = ((got - want).abs() / var[:, None, None]).max().item()
            if not err <= TOL["se"][dtype]:
                raise AssertionError(f"{what}: rel err {err:.3e}")
            if x2 is None:
                if not torch.equal(got, got.mT):
                    raise AssertionError(f"{what}: not bitwise symmetric")
                two = gk.se_covariance_cuda(x1, x1.clone(), var, scale, None, tile=tile)
                if not torch.equal(got, two if nugget is None else two + torch.diag_embed(nugget)):
                    raise AssertionError(f"{what}: the symmetric call differs from the two-input call on a copy")
            worst["se_covariance"] = max(worst["se_covariance"], (got - want).abs().max().item())
        # the wrapper (op, broadcasting, no lengthscale) equals the direct launch; NaN in gives NaN out
        x = rand(3, 130, 3, dtype=dtype)
        if not torch.equal(gk.se_covariance(x, None, 1.5, 0.7, 0.1),
                           gk.se_covariance_cuda(x, None, torch.full((1,), 1.5, device=dev, dtype=dtype),
                                                 torch.full((1, 3), 0.7, device=dev, dtype=dtype),
                                                 torch.full((1, 130), 0.1, device=dev, dtype=dtype))):
            raise AssertionError(f"se_covariance {dtype}: the wrapper and the direct launch differ")
        x[0, 3, 1] = float("nan")
        for x2 in (None, x.clone()):
            k = gk.se_covariance(x, x2, 1.5)
            bad = torch.isnan(k)
            expect = torch.zeros_like(bad)
            expect[0, 3, :] = True
            expect[0, :, 3] = True
            if not torch.equal(bad, expect):
                raise AssertionError(f"se_covariance {dtype}: NaN in x did not give exactly row and column 3 NaN")
        # 3: a Laplace posterior's factor; 512: the slice; above 640: blocked
        for n in (3, 50, 128, 512, 640, 641, 1000, 2047, 2048, 2049, 4096):
            for b in ((1, 10) if n <= 1024 else (1, 2)):
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
        # non-PD: all-identical points, unit variance, no nugget -> all-ones
        # K; n = 50 takes the fused path, n = 1500 the blocked one
        for n in (50, 1500):
            x = torch.zeros((2, n, 3), device=dev, dtype=dtype)
            k = gk.se_covariance(x, None, torch.ones(2, device=dev, dtype=dtype))
            for name, fac in (("kernel", gk.cholesky(k)), ("plain", gk.cholesky_plain(k))):
                diag_ok = torch.isfinite(torch.diagonal(fac, dim1=-2, dim2=-1)).all(dim=-1)
                if bool(diag_ok.any()):
                    raise AssertionError(f"cholesky {name} {dtype} n={n}: non-PD input gave a finite diagonal")
    torch.cuda.synchronize()
    log(f"[2 kernel parity] se_covariance max abs err {worst['se_covariance']:.3e} over {len(cases)} cases "
        f"(d 1-40, n 1-1000, B 1-16, cross, nugget, ARD, shared data, both tile edges; bitwise symmetric and "
        f"equal to the two-input call; NaN propagates), "
        f"cholesky max abs err {worst['cholesky']:.3e} (n up to 4096, both paths); symmetric, upper zero, "
        f"non-PD -> NaN on both paths (f32, f64)")
    return worst


# H100 SXM peaks at the full 700 W (NVIDIA's data sheet): HBM3, and
# 67 TFLOP/s for float32 outside the tensor cores and for float64 through
# them (DMMA)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12


def _bound(nbytes: float, flops: float):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _stored(t) -> int:
    """Elements of ``t`` that memory holds: a broadcast (stride-0) dim counts once."""
    return math.prod(size for size, stride in zip(t.shape, t.stride()) if stride != 0 or size == 1) if t is not None else 0


def _se_bound(x1, x2, variance, lengthscale, nugget):
    """Every operand read once as memory holds it (shared data once for the
    batch, x2 only where it is another tensor, a scalar lengthscale or
    nugget once per matrix) and K written once, the whole of it in the
    symmetric call too; per entry d differences, scalings and
    squares-and-adds, the halving, exp and variance."""
    b, n1, d = max(x1.shape[0], variance.shape[0]), x1.shape[1], x1.shape[2]
    n2 = n1 if x2 is None else x2.shape[1]
    read = sum(_stored(t) for t in (x1, x2, variance, lengthscale, nugget))
    return _bound((read + b * n1 * n2) * x1.element_size(), b * n1 * n2 * (4 * d + 3))


def _chol_bound(b, n, itemsize):
    """The lower triangle read once and the factor written once; n^3 / 3
    multiply-adds counted as flops, as the Cholesky is usually counted."""
    return _bound(b * (n * (n + 1) // 2 + n * n) * itemsize, b * n**3 / 3)


_MEASURING = {"seconds": 0.0, "depth": 0}


def _measuring(fn):
    """Adds the seconds of ``fn``'s outermost calls to ``_MEASURING``: the
    script's time in its timing and profiling helpers, which no gate
    reads; the ``[seconds]`` lines print it beside each phase's time."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _MEASURING["depth"] += 1
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _MEASURING["depth"] -= 1
            if _MEASURING["depth"] == 0:
                _MEASURING["seconds"] += time.perf_counter() - t
    return wrapped


@_measuring
def _time_ms(fn, reps: int = 5, groups: int = 3, per_group: int = 20):
    """(device ms per call, wall ms per call) of ``fn``, each a median after
    a warm-up, timed with CUDA events.

    Device time: ``per_group`` calls enqueued back to back behind a ~20 ms
    ``torch.cuda._sleep``, longer than the host's dispatch of 20 calls of
    the costliest function timed here (the unfused assembly: 160 launches
    at 20-50 us), so the host's dispatch overlaps the sleep and the events
    see only device work; median of ``groups``.  Wall time: one call between the
    events with an idle device, host dispatch included; median of
    ``reps``."""
    for _ in range(2):
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
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / per_group)
    return statistics.median(device), statistics.median(wall)


@_measuring
def _in_turns(kern, plain, **kw):
    """plain, kernel, kernel, plain; each pair's median of
    (device ms, wall ms): (kernel device, plain device, kernel wall, plain wall)."""
    p1, k1, k2, p2 = _time_ms(plain, **kw), _time_ms(kern, **kw), _time_ms(kern, **kw), _time_ms(plain, **kw)
    return tuple(statistics.median(pair) for pair in ((k1[0], k2[0]), (p1[0], p2[0]), (k1[1], k2[1]), (p1[1], p2[1])))


@_measuring
def _launches_per_call(fn, calls: int = 5) -> float:
    """CUDA kernels per call of ``fn``, counted by torch.profiler.

    A trace can lose the records of its first kernels, so the window opens
    with a warm-up step that is traced and dropped, and a window that holds
    fewer kernels than the hand-written kernels' own launch counters saw is
    taken again."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(10):
                torch.zeros(8, device="cuda").add_(1.0)
            torch.cuda.synchronize()
            prof.step()
            ours = gk.se_covariance_cuda.launches + gk.cholesky_cuda.launches
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            ours = gk.se_covariance_cuda.launches + gk.cholesky_cuda.launches - ours
        seen = sum(e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                   for e in prof.events())
        if seen >= ours:
            return seen / calls
    raise AssertionError(f"torch.profiler kept losing kernel records ({seen} seen, {ours} launched by the wrappers)")


def _se_operands(b, n, dtype, g):
    """The SE call's operands as the main path hands them over: data shared
    by the batch, one variance, one scalar lengthscale and one scalar nugget
    per matrix (the last two as stride-0 views)."""
    dev = torch.device("cuda")
    x = torch.randn((1, n, SLICE_D), generator=g, device=dev, dtype=dtype)
    var = 0.5 + torch.rand((b,), generator=g, device=dev, dtype=dtype)
    scale = (0.5 + torch.rand((b, 1), generator=g, device=dev, dtype=dtype)).expand(b, SLICE_D)
    nug = (0.01 + torch.rand((b, 1), generator=g, device=dev, dtype=dtype)).expand(b, n)
    return x, var, scale, nug


def _se_unfused(gk, x, var, scale, nug):
    """The assembly as it was before the op took the lengthscale and the
    nugget: two scaled copies of the data, the two-input call, diag_embed,
    add."""
    inv = (1.0 / scale)[:, None, :]
    return gk.se_covariance(x * inv, x * inv, var) + torch.diag_embed(nug)


def _bulk_store_libraries(csrc, se_only: bool = False) -> list:
    """The SE source built with -DSE_BULK_STORE, and the default Cholesky
    beside it unless ``se_only``."""
    se, chol = (Path(csrc.__file__).resolve().parent / name for name in csrc.SOURCES)
    paths = csrc.build([se], flags=(*csrc.NVCC_FLAGS, "-DSE_BULK_STORE"))
    return paths if se_only else paths + csrc.build([chol])


def _bulk_store_variant(gk, smi: str, g):
    """The option the SE kernel's source keeps beside its vector stores:
    built with -DSE_BULK_STORE, whole 32 x 32 tiles leave shared memory by
    bulk asynchronous copies.  Same K, and its time beside the default's."""
    from bayesianinference_tpu_torch import csrc

    variant = csrc._Library(_bulk_store_libraries(csrc))
    default = csrc.load_library
    for dtype in (torch.float64, torch.float32):
        x, var, scale, nug = _se_operands(SLICE_B, SLICE_N, dtype, g)
        call = lambda: gk.se_covariance_cuda(x, None, var, scale, nug, tile=32)  # noqa: E731
        want, plain_ms = call(), _time_ms(call, reps=1)[0]
        csrc.load_library = lambda: variant
        try:
            got, bulk_ms = call(), _time_ms(call, reps=1)[0]
        finally:
            csrc.load_library = default
        if not torch.equal(got, want):
            raise AssertionError(f"se_covariance {dtype}: the bulk-store variant's K differs from the default's")
        log(f"[5 kernel times] se_covariance {dtype} B={SLICE_B} n={SLICE_N} d={SLICE_D}, 32 x 32 tiles: device ms per "
            f"call with bulk asynchronous stores (-DSE_BULK_STORE) {bulk_ms:.4f}, with the default vector stores "
            f"{plain_ms:.4f}; the same K | {smi}")


def phase_kernel_times(smi: str):
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    times = {}  # (op, dtype name) -> dict of ms at the slice's shape

    # the SE assembly: the fused call against its plain version, its bound and the unfused assembly
    se_shapes = ((torch.float64, SLICE_B, SLICE_N, {}), (torch.float32, SLICE_B, SLICE_N, {}),
                 (torch.float64, 1, SLICE_N, {}), (torch.float32, 1, GRAD_N, dict(reps=2, groups=3, per_group=3)))
    for dtype, b, n, kw in se_shapes:
        x, var, scale, nug = _se_operands(b, n, dtype, g)
        name = "f64" if dtype == torch.float64 else "f32"
        fused = lambda: gk.se_covariance(x, None, var, scale, nug)  # noqa: E731
        kd, pd, kw_ms, pw_ms = _in_turns(fused, lambda: gk.se_covariance_plain(x, None, var, scale, nug), **kw)
        ud, fd, _, _ = _in_turns(lambda: _se_unfused(gk, x, var, scale, nug), fused, **kw)
        bound = _se_bound(x, None, var, scale, nug)
        # through the entry point, hyperparameters on the card as the chains hold them
        th = torch.stack([var, scale[:, 0], nug[:, 0]], dim=-1)
        assemble = lambda t: gk.covariance_matrix(gk.se_kernel(t[0], t[1]), x[0], t[2], symmetrize=False)  # noqa: E731
        entry = (lambda: assemble(th[0])) if b == 1 else (lambda: torch.func.vmap(assemble)(th))
        t = {"ms": kd, "plain_ms": pd, "wall_ms": kw_ms, "plain_wall_ms": pw_ms, "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None, "unfused_ms": ud, "fused_again_ms": fd,
             "launches_per_call": _launches_per_call(fused), "entry_launches_per_call": _launches_per_call(entry),
             "unfused_launches_per_call": _launches_per_call(lambda: _se_unfused(gk, x, var, scale, nug))}
        if (b, n) == (SLICE_B, SLICE_N):
            times[("se_covariance", name)] = t
        log(f"[5 kernel times] se_covariance {name} B={b} n={n} d={SLICE_D}, lengthscale and nugget fused: device ms "
            f"per call kernel {kd:.4f}, plain {pd:.4f}, library none, bound {bound[0]:.4f} ({bound[1]}; kernel at "
            f"{100 * bound[0] / kd:.2f} % of it); the unfused assembly (two scaled copies, the two-input call, "
            f"diag_embed, add) {ud:.4f} against the fused call {fd:.4f} in turns; one call with host dispatch kernel "
            f"{kw_ms:.4f}, plain {pw_ms:.4f}; CUDA kernels per call: the op {t['launches_per_call']:g}, "
            f"covariance_matrix(se_kernel(...), x, nugget) {t['entry_launches_per_call']:g}, the unfused assembly "
            f"{t['unfused_launches_per_call']:g} | {smi}")
        if t["launches_per_call"] != 1 or t["entry_launches_per_call"] != 1:
            raise AssertionError(f"se_covariance {name} B={b} n={n}: {t['launches_per_call']} CUDA kernels per op call, "
                                 f"{t['entry_launches_per_call']} per covariance_matrix call, expected 1 and 1")
        del x, var, scale, nug, th
        torch.cuda.empty_cache()

    _bulk_store_variant(gk, smi, g)

    for dtype in (torch.float64, torch.float32):
        x, var, scale, nug = _se_operands(SLICE_B, SLICE_N, dtype, g)
        k = gk.se_covariance_plain(x, None, var, scale, nug)
        name = "f64" if dtype == torch.float64 else "f32"
        size = torch.finfo(dtype).bits // 8
        # cuSOLVER's cholesky_ex is the Cholesky's library call (its plain twin adds a torch.where)
        kd, pd, kw_ms, pw_ms = _in_turns(lambda: gk.cholesky(k), lambda: gk.cholesky_plain(k))
        bound = _chol_bound(SLICE_B, SLICE_N, size)
        t = times[("cholesky", name)] = {
            "ms": kd, "plain_ms": pd, "wall_ms": kw_ms, "plain_wall_ms": pw_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": _time_ms(lambda: torch.linalg.cholesky_ex(k))[0],
            "launches_per_call": _launches_per_call(lambda: gk.cholesky(k))}
        log(f"[5 kernel times] cholesky {name} B={SLICE_B} n={SLICE_N}: device ms per call kernel {t['ms']:.4f}, "
            f"plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ({t['bound_by']}; "
            f"kernel at {100 * t['bound_ms'] / t['ms']:.2f} % of it); one call with host dispatch kernel "
            f"{t['wall_ms']:.4f}, plain {t['plain_wall_ms']:.4f}; CUDA kernels per call {t['launches_per_call']:g} | {smi}")
        if t["launches_per_call"] != 1:
            raise AssertionError(f"cholesky {name} at B={SLICE_B} n={SLICE_N}: {t['launches_per_call']} CUDA kernels "
                                 f"per call, expected 1")

    # the Cholesky at bench.py's width (B = 1, f32; few reps: ~70 ms a call)
    x = torch.randn((1, GRAD_N, SLICE_D), generator=g, device=dev, dtype=torch.float32)
    k = gk.se_covariance(x, None, 1.0, None, math.exp(-2.0))
    del x
    kd, pd, _, _ = _in_turns(lambda: gk.cholesky(k), lambda: torch.linalg.cholesky_ex(k), reps=1, groups=3,
                             per_group=2)
    bound_ms, bound_by = _chol_bound(1, GRAD_N, 4)
    big = {"ms": kd, "library_ms": pd, "bound_ms": bound_ms,
           "launches_per_call": _launches_per_call(lambda: gk.cholesky(k), 1)}
    del k
    torch.cuda.empty_cache()
    log(f"[5 kernel times] cholesky f32 B=1 n={GRAD_N}: device ms per call kernel {kd:.2f}, library "
        f"(cholesky_ex) {pd:.2f} ({kd / pd:.2f} x), bound {bound_ms:.2f} ({bound_by}; kernel at "
        f"{100 * bound_ms / kd:.1f} %, library at {100 * bound_ms / pd:.1f} %); CUDA kernels per call "
        f"{big['launches_per_call']:g} | {smi}")

    # the two paths around the route threshold (device ms, float64)
    routes = []
    for b, n in ((1, 512), (10, 512), (1, 640), (10, 640), (1, 768), (10, 768), (1, 896), (10, 896), (1, 1024),
                 (10, 1024)):
        a = torch.randn((b, n, n), generator=g, device=dev, dtype=torch.float64)
        k = a @ a.mT + n * torch.eye(n, device=dev, dtype=torch.float64)
        fused = _time_ms(lambda: gk._cholesky_launch(k, "fused", 32), reps=1)[0]
        blocked = _time_ms(lambda: gk._cholesky_launch(k, "blocked", 256), reps=1)[0]
        routes.append(f"B={b} n={n} fused {fused:.4f} blocked {blocked:.4f}")
    log(f"[5 kernel times] cholesky f64 paths, device ms per call: {'; '.join(routes)} | {smi}")
    return times, big


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
    return err, res.num_likelihood_evals / wall


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
    cpu_problem = _gp_problem(x.cpu(), y.cpu())
    want = cpu_problem.guarded_log_likelihood(thetas.cpu())
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
    return launches, problem, (logz, err), res.num_likelihood_evals / wall, (res, z_fine, cpu_problem)


def _gp_logml(th, x, y):
    """bench.py's GP objective through the port's API: SE kernel with
    log-variance th[0], log-lengthscale th[1], log-nugget th[2],
    ``symmetrize=False``; on CUDA tensors both kernels and the closed-form
    backward."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    k = gk.covariance_matrix(gk.se_kernel(torch.exp(th[0]), torch.exp(th[1])), x, nugget=torch.exp(th[2]),
                             symmetrize=False)
    return gk.gp_log_marginal_likelihood(k, y)


def _gp_logml_plain(th, x, y):
    """The same objective through the plain versions only:
    ``se_covariance_plain``, ``torch.linalg.cholesky``, autograd."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    xs = x * torch.exp(-th[1])
    k = gk.se_covariance_plain(xs[None], xs[None], torch.exp(th[0])[None])[0]
    k = k + torch.exp(th[2]) * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    factor = torch.linalg.cholesky(k)
    w = torch.linalg.solve_triangular(factor, y[:, None], upper=False)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(factor)).sum()
    return -0.5 * (x.shape[0] * math.log(2 * math.pi) + logdet + (w * w).sum())


def _value_and_grad(fn, th, x, y):
    th = th.detach().requires_grad_(True)
    value = fn(th, x, y)
    (grad,) = torch.autograd.grad(value, th)
    return value.detach(), grad


@_measuring
def _wall_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of ``fn`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def phase_gp_grad(smi: str):
    """bench.py::bench_gp at full width: logML and its theta-gradient at
    n = 16384, d = 3, f32, through the kernels and through the plain
    versions, each held against the plain f64 value."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(GRAD_N, SLICE_D)).astype(np.float32)
    y_np = (np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=GRAD_N)).astype(np.float32)
    th_np = np.array([0.0, 0.0, -2.0])
    data = {dt: (torch.as_tensor(x_np, device=dev, dtype=dt), torch.as_tensor(y_np, device=dev, dtype=dt),
                 torch.as_tensor(th_np, device=dev, dtype=dt)) for dt in (torch.float32, torch.float64)}
    x, y, th = data[torch.float32]

    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = _value_and_grad(_gp_logml, th, x, y)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"GP grad: kernel launches {launches}")
    plain = _value_and_grad(_gp_logml_plain, th, x, y)
    x64, y64, th64 = data[torch.float64]
    ref = _value_and_grad(_gp_logml_plain, th64, x64, y64)
    torch.cuda.synchronize()
    # the f64 reference reads the same f32-rounded data, so each error is the
    # arithmetic's alone
    flat = lambda vg: torch.cat([vg[0].reshape(1), vg[1]]).double().cpu()  # noqa: E731
    got, plain, ref = flat(got), flat(plain), flat(ref)
    err_k, err_p = (got - ref).abs(), (plain - ref).abs()
    # no worse than twice the plain f32 path, and within 5e-5 relative: a
    # few times the kernel path's own error (6.3e-6 relative on the logML,
    # 2.2e-7 to 2.9e-6 on the gradient), since the plain path's alone sits
    # 100x above it at this width
    bound = torch.minimum(2.0 * err_p + 1e-6 * ref.abs(), 5e-5 * ref.abs())
    names = ("logML", "d/dlogvar", "d/dloglen", "d/dlognug")
    if not (bool(torch.isfinite(got).all()) and bool((err_k <= bound).all())):
        raise AssertionError("GP grad: " + "; ".join(
            f"{nm} kernel {g:.9g} plain {p:.9g} f64 {r:.9g}" for nm, g, p, r in zip(names, got, plain, ref)))

    k_f32 = gk.covariance_matrix(gk.se_kernel(1.0, 1.0), x, nugget=math.exp(-2.0), symmetrize=False)
    factor = gk.cholesky(k_f32)
    del k_f32
    ms = {
        "kernel fwd": _wall_ms(lambda: _gp_logml(th, x, y)),
        "kernel fwd+grad": _wall_ms(lambda: _value_and_grad(_gp_logml, th, x, y)),
        "plain fwd": _wall_ms(lambda: _gp_logml_plain(th, x, y)),
        "plain fwd+grad": _wall_ms(lambda: _value_and_grad(_gp_logml_plain, th, x, y)),
        "K^-1 cholesky_inverse": _wall_ms(lambda: gk._inv_from_chol(factor)),
    }
    del factor
    torch.cuda.empty_cache()
    log(f"[6 GP grad] n={GRAD_N} d={SLICE_D} f32 theta={th_np.tolist()}: "
        + "; ".join(f"{nm} kernel {g:.9g} (err {ek:.3g}) plain {p:.9g} (err {ep:.3g}) f64 {r:.9g}"
                    for nm, g, p, r, ek, ep in zip(names, got, plain, ref, err_k, err_p))
        + f"; launches {launches}; peak device memory of the forward-and-gradient call above what was held before "
          f"it {peak_mib:.0f} MiB (the parent commit, before the lengthscale and the nugget were fused: "
          f"{PARENT_GRAD_PEAK_MIB} MiB, chip_profile.py on the same card model); wall ms (median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f" | {smi}")
    return launches, ms


def phase_laplace(smi: str, problem, ns_logz):
    """The slice's Laplace path: ``laplace_posterior_fit`` on phase 4's GP
    problem (n = 512, d = 3, f64) from 8 fixed starts, through the kernels,
    then its Gaussian posterior; held against the same on CPU tensors (the
    plain versions).  The fit runs twice on the card: the second run
    reports whether the first repeats bit for bit."""
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.models.problem import random_domain_points
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    model = problem.metadata["gaussian_process"]
    cpu_problem = _gp_problem(model.x.cpu(), model.y.cpu())
    starts = random_domain_points(torch.Generator().manual_seed(0), cpu_problem.lower, cpu_problem.upper, 8, scale=5.0)
    torch.cuda.synchronize()
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    t0 = time.perf_counter()
    fit = laplace_posterior_fit(problem=problem, initial_guess=starts.cuda())
    logz_gpu = float(fit.log_evidence)
    wall = time.perf_counter() - t0
    post = fit.posterior_distribution
    draws = post.sample(torch.Generator(device="cuda").manual_seed(0), (1000,))
    lp = post.log_prob(draws).cpu()
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"Laplace: kernel launches {launches}")
    again = laplace_posterior_fit(problem=problem, initial_guess=starts.cuda())
    repeats = bool(torch.equal(again.mean, fit.mean) and torch.equal(again.precision_matrix, fit.precision_matrix))
    repeat_launches = gk.cholesky_cuda.launches - launches["cholesky"]
    t0 = time.perf_counter()
    ref = laplace_posterior_fit(problem=cpu_problem, initial_guess=starts)
    wall_cpu = time.perf_counter() - t0
    lp_ref = ref.posterior_distribution.log_prob(draws.cpu())
    mode, prec = fit.mean.cpu(), fit.precision_matrix.cpu()
    if not bool(torch.isfinite(torch.linalg.cholesky_ex(prec)[0]).all()) or int(torch.linalg.cholesky_ex(prec)[1]):
        raise AssertionError(f"Laplace: precision matrix not PD: {prec.tolist()}")
    if not bool(((mode > cpu_problem.lower) & (mode < cpu_problem.upper)).all()):
        raise AssertionError(f"Laplace: mode {mode.tolist()} outside the box")
    errs = {
        "mode": ((mode - ref.mean).abs() / ref.mean.abs()).max().item(),
        "logZ": abs(logz_gpu - float(ref.log_evidence)) / abs(float(ref.log_evidence)),
        "Hessian": ((prec - ref.precision_matrix).abs().max() / ref.precision_matrix.abs().max()).item(),
        "posterior log density": ((lp - lp_ref).abs() / lp_ref.abs().clamp(min=1.0)).max().item(),
    }
    tol = {"mode": 1e-6, "logZ": 1e-6, "Hessian": 1e-5, "posterior log density": 1e-5}
    if not (draws.shape == (1000, SLICE_D) and bool(torch.isfinite(lp).all())):
        raise AssertionError(f"Laplace: posterior draws {tuple(draws.shape)}, finite densities {bool(torch.isfinite(lp).all())}")
    if not all(errs[k] <= tol[k] for k in tol):
        raise AssertionError(f"Laplace: kernel fit vs plain CPU fit relative errors {errs} (bounds {tol})")
    ns, ns_err = ns_logz
    log(f"[7 Laplace] n={SLICE_N} d={SLICE_D} f64, 8 starts: mode {[round(v, 6) for v in mode.tolist()]}, "
        f"logZ {logz_gpu:.6f} (NS {ns:.4f} +- {ns_err:.4f}: {(logz_gpu - ns) / ns_err:+.2f} NS sigmas); "
        f"vs the plain CPU fit: rel err {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}; "
        f"wall {wall:.3f} s through the kernels ({wall_cpu:.3f} s plain on the host CPU); launches {launches}; "
        f"second fit on the card: {repeat_launches} cholesky launches, "
        f"{'bitwise the same' if repeats else 'NOT bitwise the same'} mode and Hessian | {smi}")
    return launches, wall


def _gaussian_box_problem(dim: int, device="cuda"):
    """The analytic oracle: a standard Gaussian likelihood under the uniform
    box [-5, 5]^dim, logZ = dim * log(erf(5 / sqrt 2) / 10)."""
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    problem = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(dim)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim,
        device=torch.device(device), dtype=torch.float64,
    )
    return problem, dim * (math.log(math.erf(5.0 / math.sqrt(2.0))) - math.log(10.0))


# the JAX tests' runs (tests/test_nested_sampling.py) with more deletions per iteration, which cuts the
# iterations (each run is host-bound, minutes long otherwise): 8a three quarters of the pool, as 8b had before;
# 8b seven eighths, for the script's time limit.  8b's chains at d / 2 trajectories per replacement (144 leapfrog
# steps), not the law's 1.5 d (432), for the script's time limit: 218 s at 432 steps, 69-70 s at 288 with logZ
# +0.83 and -0.33 sigma at seeds 0 and 1 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md); at 144 steps and 448
# deletions +0.08 to +0.96 sigma over seeds 0-3 on CPU tensors (PERF.md).  (tag, d, expected chains, the JAX
# test's deletions, options)
NS_HIGHDIM_CASES = (
    ("a", 32, "slice", 50, dict(sample_pool_size=400, max_iterations=400, min_iterations=20, monte_carlo_steps=40,
                                num_delete=300)),
    ("b", 72, "chmc", 256, dict(sample_pool_size=512, max_iterations=150, min_iterations=20, num_delete=448,
                                post_process_sampling_runs=20, monte_carlo_steps=144)),
)


def _ns_highdim_job(tag: str, dev: str) -> dict:
    """One of phase 8's runs: its readings as Python numbers.  No
    hand-written kernel lies on this path, so it runs in a worker process
    beside phases 13-17 (it fails if a kernel launched)."""
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling, resolve_monte_carlo_method
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    _, dim, _, _, kw = next(c for c in NS_HIGHDIM_CASES if c[0] == tag)
    dev = torch.device(dev)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    problem, analytic = _gaussian_box_problem(dim, dev)
    method = resolve_monte_carlo_method("auto", dim, gradient_check=problem.gradient_sanity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), **kw)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches) != before:
        raise AssertionError(f"8{tag}: a hand-written kernel launched")
    return dict(method=method, logz=logz, err=err, analytic=analytic, iterations=res.iterations,
                evals=res.num_likelihood_evals, wall=wall,
                acc=float(res.acceptance_rates[: res.generated_nested_samples].mean()))


def _ns_highdim_start(dev="cuda"):
    """Starts phase 8's two runs in two worker processes (the longer first),
    then 16a's fits (:func:`_advi_oracle_job`) in the same pool: (pool,
    pending results by tag, 16a's pending result); :func:`phase_ns_highdim`
    gates the runs and closes the pool, phase 16 gates the fits."""
    pool = multiprocessing.get_context("spawn").Pool(2)
    runs = {tag: pool.apply_async(_ns_highdim_job, (tag, str(dev))) for tag in ("b", "a")}
    return pool, runs, pool.apply_async(_advi_oracle_job, (str(dev),))


def phase_ns_highdim(smi: str, pending=None):
    """Nested sampling above d = 16 on the analytic oracle, float64, through
    ``monte_carlo_method="auto"``: (a) d = 32 takes the slice chains, (b)
    d = 72 the constrained-HMC chains, at d / 2 trajectories per
    replacement.  ``pending``: :func:`_ns_highdim_start`'s pool and results
    (the pool is closed here), or None to run both here."""
    t = time.perf_counter()
    if pending is None:
        readings = {c[0]: _ns_highdim_job(c[0], "cuda") for c in NS_HIGHDIM_CASES}
        where = "in this process"
    else:
        pool, jobs = pending[:2]
        readings = {tag: job.get() for tag, job in jobs.items()}
        pool.close()
        pool.join()
        where = f"in a worker process beside phases 13-17, waited for {time.perf_counter() - t:.1f} s here"
    for tag, dim, expect, jax_delete, kw in NS_HIGHDIM_CASES:
        r = readings[tag]
        if r["method"] != expect:
            raise AssertionError(f"NS d={dim}: auto resolved to {r['method']}, expected {expect}")
        logz, err, analytic = r["logz"], r["err"], r["analytic"]
        if not (math.isfinite(logz) and math.isfinite(err) and abs(logz - analytic) <= 4 * max(err, 0.2)):
            raise AssertionError(f"NS d={dim} ({expect}): logZ {logz} +- {err}, analytic {analytic:.3f}")
        log(f"[8{tag} NS d={dim}] auto -> {expect}, pool {kw['sample_pool_size']}, num_delete {kw['num_delete']} "
            f"({jax_delete} in the JAX test's run; more here to fit the script's time)"
            f"{', 36 four-step chmc trajectories per replacement (the law 108; cut to fit the time)' if tag == 'b' else ''}: "
            f"logZ {logz:.3f} +- {err:.3f} (analytic {analytic:.3f}), {r['iterations']} iterations, "
            f"{r['evals']} evals in {r['wall']:.2f} s = {r['evals'] / r['wall']:.4g} evals/s {where}, "
            f"mean recorded acceptance {r['acc']:.3f} | {smi}")


def _ard_gp_problem(x, y):
    """SE kernel with an amplitude, one lengthscale per input and a nugget,
    each hyperparameter sampled on its log scale under a uniform prior."""
    from bayesianinference_tpu_torch.engines.gp import define_gaussian_process
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    names = ["log_amp"] + [f"log_len{i}" for i in range(ARD_D)] + ["log_noise"]
    bounds = [(0.05, 5.0)] + [(0.5, 50.0)] * ARD_D + [(0.01, 1.0)]
    return define_gaussian_process(
        x, y,
        kernel_builder=lambda th: se_kernel(torch.exp(2.0 * th[0]), torch.exp(th[1:1 + ARD_D])),
        nugget_builder=lambda th: torch.exp(2.0 * th[-1]),
        parameters=[(n, math.log(lo), math.log(hi)) for n, (lo, hi) in zip(names, bounds)],
        prior_distribution=["location"] * len(names),
    )


def _rel(got, want):
    return ((got - want).abs() / torch.clamp(want.abs(), min=1.0)).max().item()


def phase_gp_ard(smi: str):
    """GP with ARD lengthscales (22 hyperparameters) by slice and by
    constrained-HMC nested sampling, a fixed few iterations of each, one
    iteration per loop entry so that every replacement can be held against
    the threshold it was drawn under."""
    from bayesianinference_tpu_torch.engines.checkpoint import resume_nested_sampling_loop
    from bayesianinference_tpu_torch.engines.nested_sampling import (
        generate_starting_points,
        nested_sampling_loop,
        resolve_monte_carlo_method,
    )
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(ARD_N, ARD_D))
    y_np = np.sin(x_np[:, 0]) + 0.5 * x_np[:, 1] + 0.1 * rng.normal(size=ARD_N)
    x, y = problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64)
    problem = _ard_gp_problem(x, y)
    cpu_problem = _ard_gp_problem(x.cpu(), y.cpu())
    if resolve_monte_carlo_method("auto", problem.dim, gradient_check=problem.gradient_sanity) != "slice":
        raise AssertionError("GP ARD: auto did not resolve to slice at 22 hyperparameters")
    k, total = 10, {"se_covariance": 0, "cholesky": 0}
    lz = -1e300
    start = generate_starting_points(problem, torch.Generator(device=dev).manual_seed(0), 100)
    for method, steps, iterations in (("auto", 25, 3), ("chmc", 32, 3)):
        g = torch.Generator(device=dev).manual_seed(1)
        kw = dict(monte_carlo_steps=steps, monte_carlo_method=method)
        gk.se_covariance_cuda.launches = 0
        gk.cholesky_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = nested_sampling_loop(problem, start, g, num_delete=k, min_iterations=0, max_iterations=0, **kw)
        init_launches = gk.cholesky_cuda.launches  # the starting points' likelihoods: not counted as evals
        moved = 0
        for it in range(iterations):
            before = run.state
            threshold = before.live_logl[k - 1]
            run = resume_nested_sampling_loop(problem, run, g, extra_iterations=1, min_iterations=it + 1, **kw)
            s = run.state
            # every point the chains moved to lies strictly above the threshold; a chain that never moved
            # leaves a copy of its seed, a survivor, which may tie with a later threshold but not fall below
            new = torch.logical_not((s.live_points[:, None, :] == before.live_points[None]).all(dim=-1).any(dim=-1))
            moved += int(new.sum())
            gap = s.live_logl - threshold
            if not (bool((gap[new] > 0).all()) and bool((gap >= 0).all())
                    and bool(problem.in_support(s.live_points).all())):
                raise AssertionError(f"GP ARD {method}: after iteration {it + 1} the live set is not all in the box "
                                     f"above the threshold {float(threshold):.4f}: {int((gap < 0).sum())} below, "
                                     f"{int((gap[new] <= 0).sum())} moved points not above, least gap "
                                     f"{float(gap.min()):.3e}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
        evals = int(run.state.num_likelihood_evals)
        if s.n_dead != iterations * k or min(launches.values()) - init_launches < evals / k:
            raise AssertionError(f"GP ARD {method}: {launches} launches for {evals} evals in batches of {k}")
        for name in total:
            total[name] += launches[name]
        # K and its factor through the wrappers against the plain versions, at the hyperparameters of the k
        # lowest live points: the shape the chains called (per-row ARD lengthscales, shared data, nugget)
        pts = s.live_points
        var, scale = torch.exp(2.0 * pts[:k, 0]), torch.exp(pts[:k, 1:1 + ARD_D])
        nug = torch.exp(2.0 * pts[:k, -1])[:, None].expand(k, ARD_N)
        cov = gk.se_covariance(x, None, var, scale, nug)
        se_err = ((cov - _se_plain_in_row_blocks(gk, x[None], None, var, scale, nug)).abs() / var[:, None, None]).max().item()
        factor, factor_plain = gk.cholesky(cov), gk.cholesky_plain(cov)
        chol_err = ((factor - factor_plain).abs().max() / factor_plain.abs().max()).item()
        if not (cov.shape == (k, ARD_N, ARD_N) and se_err <= TOL["se"][torch.float64]
                and chol_err <= TOL["chol"][torch.float64]):
            raise AssertionError(f"GP ARD {method}: at B={k} n={ARD_N} d={ARD_D} se_covariance rel err {se_err:.3e}, "
                                 f"cholesky rel err {chol_err:.3e} against the plain versions")
        # logML through the kernels against the plain versions (the same model on CPU tensors)
        got = problem.guarded_log_likelihood(pts).cpu()
        want = cpu_problem.guarded_log_likelihood(pts.cpu())
        if not torch.equal(got <= 0.5 * lz, want <= 0.5 * lz):
            raise AssertionError(f"GP ARD {method}: kernel and plain logML put the sentinel in different places")
        ok = want > 0.5 * lz
        rel = _rel(got[ok], want[ok])
        if not (rel <= 1e-8 and _rel(s.live_logl.cpu()[ok], want[ok]) <= 1e-8):
            raise AssertionError(f"GP ARD {method}: kernel vs plain logML rel diff {rel:.3e}")
        grad_note = ""
        if method == "chmc":
            # the likelihood gradient through both kernels' reverse rules at B = 16 against the plain path
            p16 = pts[-16:].detach()
            with torch.enable_grad():
                pg = p16.clone().requires_grad_(True)
                (g_kernel,) = torch.autograd.grad(problem.guarded_log_likelihood(pg).sum(), pg)
                pc = p16.cpu().requires_grad_(True)
                (g_plain,) = torch.autograd.grad(cpu_problem.guarded_log_likelihood(pc).sum(), pc)
            g_rel = ((g_kernel.cpu() - g_plain).abs().amax(dim=-1) / g_plain.abs().amax(dim=-1)).max().item()
            if not (bool(torch.isfinite(g_kernel).all()) and g_rel <= 1e-6):
                raise AssertionError(f"GP ARD chmc: gradient through the reverse rules vs plain rel diff {g_rel:.3e}")
            grad_note = f", gradient at 16 live points through the reverse rules vs plain rel diff {g_rel:.3e}"
        acc = float(s.dead_acc[: s.n_dead].mean())
        log(f"[9 GP ARD {'slice (auto)' if method == 'auto' else method}] n={ARD_N} d={ARD_D} f64, 22 hyperparameters, "
            f"pool 100, num_delete {k}, {steps} steps, {iterations} iterations: launches {launches}, {evals} evals in "
            f"{wall:.2f} s = {evals / wall:.4g} evals/s, mean recorded acceptance {acc:.3f}; every replacement in the "
            f"box above its threshold, {moved} of {iterations * k} moved off their seeds; K and L at the first {k} live points kernel vs plain rel err {se_err:.3e} and {chol_err:.3e}; logML kernel vs plain max rel diff {rel:.3e} on {int(ok.sum())} live points"
            f"{grad_note} | {smi}")
    return total


def phase_checkpoint_dynamic(smi: str):
    """Checkpoint, resume and dynamic NS on the NS spine's 2-D problem."""
    import tempfile

    from bayesianinference_tpu_torch.engines.checkpoint import load_ns_run, resume_nested_sampling_loop, save_ns_run
    from bayesianinference_tpu_torch.engines.dynamic_ns import dynamic_nested_sampling
    from bayesianinference_tpu_torch.engines.nested_sampling import (
        generate_starting_points,
        nested_sampling,
        nested_sampling_loop,
    )

    dev = torch.device("cuda")
    problem, analytic = _gaussian_box_problem(2)
    # half of phase 3's pool and chain length, a fifth of the pool deleted per iteration
    pool, kw = 500, dict(num_delete=100, monte_carlo_steps=50, min_iterations=20)
    seeded = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "run.npz"
        # one run uncut; the same seed cut after 10 iterations, saved, loaded and resumed to its end
        g = seeded()
        whole = nested_sampling_loop(problem, generate_starting_points(problem, g, pool), g, **kw)
        g = seeded()
        part = nested_sampling_loop(problem, generate_starting_points(problem, g, pool), g,
                                    **dict(kw, min_iterations=10, max_iterations=10))
        save_ns_run(path, part, g)
        loaded = load_ns_run(path)
        kept = loaded.state.dead_logl.clone()
        done = resume_nested_sampling_loop(problem, loaded, g, extra_iterations=10000 - 10, min_iterations=20,
                                           monte_carlo_steps=kw["monte_carlo_steps"])
        if loaded.state.live_points.device.type != "cuda" or not torch.equal(loaded.state.dead_logl, kept):
            raise AssertionError("checkpoint: the loaded run is not on the card, or the resumed run wrote into it")
        if done.state.n_dead != whole.state.n_dead or not torch.equal(done.state.log_z, whole.state.log_z):
            raise AssertionError(f"checkpoint: resumed run ends with n_dead {done.state.n_dead}, logZ "
                                 f"{float(done.state.log_z)}; uncut {whole.state.n_dead}, {float(whole.state.log_z)}")
        # the same through the entry point, in segments of 15 iterations
        res = nested_sampling(problem, seeded(), sample_pool_size=pool, checkpoint_path=path, checkpoint_every=15, **kw)
        on_disk = load_ns_run(path)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    if res.generated_nested_samples != whole.state.n_dead or on_disk.state.n_dead != whole.state.n_dead:
        raise AssertionError(f"checkpoint: segmented run n_dead {res.generated_nested_samples}, on disk "
                             f"{on_disk.state.n_dead}, uncut {whole.state.n_dead}")
    if not abs(logz - analytic) <= 3 * err:
        raise AssertionError(f"checkpoint: segmented logZ {logz} +- {err}, analytic {analytic:.3f}")
    wall_ckpt = time.perf_counter() - t0

    # dynamic NS with its defaults (pool 100, 4 batches) but for 20 deletions per iteration instead of 1 and
    # chains of 50 steps (the checkpoint runs') instead of 200: its defaults are host-bound for minutes.  The
    # static run beside it ends by the evidence criterion; the dynamic run's base goes on to the loop's default
    # of 100 iterations.
    ess = lambda r: float(1.0 / torch.sum(torch.exp(r.crude_log_posterior_weights) ** 2))  # noqa: E731
    dkw = dict(sample_pool_size=100, num_delete=20, monte_carlo_steps=50)
    t0 = time.perf_counter()
    base = nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), min_iterations=20, **dkw)
    dyn = dynamic_nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), **dkw)
    dz, derr = float(dyn.log_evidence.mean), float(dyn.log_evidence.standard_error)
    wall_dyn = time.perf_counter() - t0
    if not (math.isfinite(derr) and abs(dz - analytic) <= 3 * derr):
        raise AssertionError(f"dynamic NS: logZ {dz} +- {derr}, analytic {analytic:.3f}")
    if not ess(dyn) >= ess(base):
        raise AssertionError(f"dynamic NS: posterior ESS {ess(dyn):.1f} below the base run's {ess(base):.1f}")
    log(f"[10 checkpoint, dynamic NS] 2-D spine problem, pool {pool}, num_delete {kw['num_delete']}, "
        f"{kw['monte_carlo_steps']} steps: cut after 10 iterations, saved, loaded, resumed: n_dead "
        f"{done.state.n_dead} and crude logZ {float(done.state.log_z):.4f}, bit-equal to the uncut run's; in segments "
        f"of 15 through nested_sampling: n_dead {res.generated_nested_samples}, logZ {logz:.4f} +- {err:.4f} "
        f"(analytic {analytic:.4f}); {wall_ckpt:.2f} s. dynamic_nested_sampling (its defaults: pool 100, 4 batches; "
        f"num_delete {dkw['num_delete']}, not its default 1, and {dkw['monte_carlo_steps']} steps, not 200, to fit "
        f"the script's time): logZ {dz:.4f} +- {derr:.4f}, {dyn.total_samples} samples, "
        f"{dyn.num_likelihood_evals} evals, "
        f"posterior ESS {ess(dyn):.1f} against the static run's {ess(base):.1f} ({base.total_samples} samples, "
        f"{base.iterations} iterations); "
        f"{wall_dyn:.2f} s | {smi}")


class _RecordingLibrary:
    """The kernels' library with every launch's batch size recorded by entry
    point family ("bi_se_covariance", "bi_cholesky")."""

    _BATCH_ARG = {"bi_se_covariance": 6, "bi_cholesky": 2}

    def __init__(self, lib, seen: dict):
        self._lib, self._seen = lib, seen

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        family = next(f for f in self._BATCH_ARG if name.startswith(f))

        def call(*args):
            self._seen[family].append(int(args[self._BATCH_ARG[family]]))
            return fn(*args)

        return call


def phase_parallel_ns(smi: str, spine, gp_rate: float, dev="cuda"):
    """Run-level parallel nested sampling through ``parallel_nested_sampling``:
    (a) four runs of phase 3's problem at phase 3's per-run settings, against
    the analytic logZ and phase 3's error bar; (b) four runs of phase 4's GP
    problem for a fixed 20 iterations, every kernel launch at B = 40 (four
    runs of 10 chains) after the starting points' one call at B = 400."""
    from bayesianinference_tpu_torch import csrc
    from bayesianinference_tpu_torch.engines import nested_sampling as tns
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.parallel import parallel_nested_sampling

    dev = torch.device(dev)
    runs = 4
    spine_err, spine_rate = spine
    problem, analytic = _gaussian_box_problem(2, dev)
    reads = tns.run_loop_batched.host_reads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = parallel_nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), num_runs=runs,
                                   sample_pool_size=1000, num_delete=100, monte_carlo_steps=100)
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = tns.run_loop_batched.host_reads - reads
    if not (math.isfinite(err) and abs(logz - analytic) <= 3 * err and err < spine_err):
        raise AssertionError(f"parallel NS: logZ {logz} +- {err} (analytic {analytic:.4f}; phase 3's error bar "
                             f"{spine_err:.4f})")
    if reads > res.iterations - 100 + 1:
        raise AssertionError(f"parallel NS: {reads} host reads of the termination test in {res.iterations} "
                             f"iterations, min_iterations 100")
    rate = res.num_likelihood_evals / wall
    log(f"[11a parallel NS] {runs} runs of phase 3's problem (pool 1000 each, 100 deletions, 100 steps, f64): "
        f"merged logZ {logz:.4f} +- {err:.4f} (analytic {analytic:.4f}; phase 3's one run +- {spine_err:.4f}), "
        f"{res.iterations} iterations, {res.num_likelihood_evals} evals in {wall:.2f} s = {rate:.4g} evals/s "
        f"(phase 3's one run here {spine_rate:.4g}: {rate / spine_rate:.2f} x); the termination test read "
        f"{reads} times for all {runs} runs: once per iteration past min_iterations = 100 | {smi}")

    # (b) the GP problem: both kernels at B = 4 runs x 10 chains
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(SLICE_N, SLICE_D))
    y_np = np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=SLICE_N)
    x, y = problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64)
    problem = _gp_problem(x, y)
    k, steps, iterations = 10, 100, 20
    seen = {"bi_se_covariance": [], "bi_cholesky": []}
    default = csrc.load_library
    csrc.load_library = lambda: _RecordingLibrary(default(), seen)
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = parallel_nested_sampling(problem, torch.Generator(device=dev).manual_seed(1), num_runs=runs,
                                       sample_pool_size=100, num_delete=k, monte_carlo_steps=steps,
                                       min_iterations=iterations, max_iterations=iterations)
        torch.cuda.synchronize()
    finally:
        csrc.load_library = default
    wall = time.perf_counter() - t0
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    # logML through the kernels against the plain versions (CPU tensors) at the merged run's live points, its
    # 400 highest likelihoods
    live = res.points[torch.argsort(res.log_likelihoods)[-runs * 100:]]
    cpu_problem = _gp_problem(x.cpu(), y.cpu())
    got = torch.cat([problem.guarded_log_likelihood(live[i:i + 100]) for i in range(0, live.shape[0], 100)]).cpu()
    want = torch.cat([cpu_problem.guarded_log_likelihood(live[i:i + 100].cpu()) for i in range(0, live.shape[0], 100)])
    ok = want > -0.5e300
    rel = _rel(got[ok], want[ok])
    if not (torch.equal(got > -0.5e300, ok) and bool(ok.all()) and rel <= 1e-8):
        raise AssertionError(f"parallel GP: logML kernel vs plain rel diff {rel:.3e}, {int((~ok).sum())} sentinels")
    # every chain step is one density call for all 40 chains
    calls = 1 + iterations * (steps + 2)  # the starting points; per iteration the chains' seeds, steps, results
    batches = {name: sorted(set(b[1:])) for name, b in seen.items()}
    if not (launches["se_covariance"] == launches["cholesky"] == calls
            and all(len(b) == calls and b[0] == runs * 100 for b in seen.values())
            and all(v == [runs * k] for v in batches.values())):
        raise AssertionError(f"parallel GP: launches {launches} (expected {calls} of each), batch sizes after the "
                             f"first {batches}, first {[b[:1] for b in seen.values()]}")
    rate = res.num_likelihood_evals / wall
    log(f"[11b parallel GP] {runs} runs of phase 4's problem (n={SLICE_N} d={SLICE_D} f64, pool 100 each, {k} "
        f"deletions, {steps} steps), {iterations} iterations: launches {launches}, every one at B = {runs * k} "
        f"after the starting points' one at B = {runs * 100}; {res.num_likelihood_evals} evals in {wall:.2f} s = "
        f"{rate:.4g} evals/s (phase 4's one run here {gp_rate:.4g}: {rate / gp_rate:.2f} x); logML kernel vs plain "
        f"max rel diff {rel:.3e} at the merged run's {live.shape[0]} live points | {smi}")
    return launches


# PRECISION.json's f32 section (the JAX package on the CPU): a check's float32 bound here is the larger of ten times
# its value there and 1e-6
PRECISION_F32 = {
    "blr_exact_logz": 4.2287002350864096e-07,
    "conjugate_normal_logz": 5.136424420553033e-09,
    "direct_quadrature_logz": 3.3116995292051024e-08,
    "ns_crude_bookkeeping": 8.495712652407968e-08,
    "merged_ns_bookkeeping": 5.797480376155269e-08,
}


def _nig_quadrature(y, *, mu0, lam, a_ig, scale_ig, mu_lo, mu_hi, v_lo, v_hi, n=400) -> float:
    """log of the integral of prod_i N(y_i | mu, var) N(mu | mu0, var / lam)
    InverseGamma(var | a_ig, scale_ig) over the (mu, var) box, by
    Gauss-Legendre in (mu, log var), in numpy float64."""
    y = np.asarray(y, float)
    xb, wb = np.polynomial.legendre.leggauss(n)
    mu = 0.5 * (mu_hi - mu_lo) * xb + 0.5 * (mu_hi + mu_lo)
    wmu = 0.5 * (mu_hi - mu_lo) * wb
    lo, hi = np.log(v_lo), np.log(v_hi)
    wv = 0.5 * (hi - lo) * wb
    mm, v = mu[:, None], np.exp(0.5 * (hi - lo) * xb + 0.5 * (hi + lo))[None, :]
    ss = (y**2).sum() - 2 * mm * y.sum() + y.size * mm**2
    logint = (-0.5 * ss / v - 0.5 * y.size * np.log(2 * np.pi * v) - 0.5 * lam * (mm - mu0) ** 2 / v
              - 0.5 * np.log(2 * np.pi * v / lam) + a_ig * np.log(scale_ig) - math.lgamma(a_ig)
              - (a_ig + 1) * np.log(v) - scale_ig / v + np.log(v))
    mx = logint.max()
    return float(mx + np.log(np.einsum("i,j,ij->", wmu, wv, np.exp(logint - mx))))


def _nig_textbook_log_z(fit, n: int) -> float:
    """The NIG marginal likelihood pi^(-n/2) sqrt(|L0| / |Ln|) G(nun/2) /
    G(nu0/2) (v0/2)^(nu0/2) / (vn/2)^(nun/2), in numpy float64 from the
    fit's own prior and posterior parameters (precision.py::check_blr)."""
    p0, p1 = fit.prior_parameters, fit.posterior_parameters
    lam0, lam1 = (p.lam.double().cpu().numpy() for p in (p0, p1))
    v0, nu0, v1, nu1 = (float(t) for t in (p0.v, p0.nu, p1.v, p1.nu))
    return float(-0.5 * n * np.log(2.0 * np.pi) + 0.5 * (np.linalg.slogdet(lam0)[1] - np.linalg.slogdet(lam1)[1])
                 + math.lgamma(nu1 / 2.0) - math.lgamma(nu0 / 2.0) + (nu0 / 2.0) * np.log(v0 / 2.0)
                 - (nu1 / 2.0) * np.log(v1 / 2.0))


def _check_blr(dev, dtype):
    from bayesianinference_tpu_torch.engines.conjugate import bayesian_linear_regression

    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (64, 1))
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.3 * rng.standard_normal(64)
    t = lambda a: torch.as_tensor(a, device=dev, dtype=dtype)  # noqa: E731
    fit = bayesian_linear_regression(t(x), t(y), degree=3)
    return float(fit.log_evidence), _nig_textbook_log_z(fit, 64)


def _check_conjugate_normal(dev, dtype):
    from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu_torch.engines.conjugate import normal_conjugate_model

    y = np.random.default_rng(1).normal(0.4, 1.3, 40)
    fit = normal_conjugate_model(torch.as_tensor(y, device=dev, dtype=dtype),
                                 prior=NormalInverseGamma(mu0=0.0, lam=0.5, beta=1.0, nu=2.0))
    return float(fit.log_evidence), _nig_quadrature(y, mu0=0.0, lam=0.5, a_ig=2.0, scale_ig=1.0, mu_lo=-30.0,
                                                    mu_hi=30.0, v_lo=1e-5, v_hi=1e4, n=2000)


def _check_direct(dev, dtype):
    from bayesianinference_tpu_torch.dists.scalar import InverseGamma, Normal
    from bayesianinference_tpu_torch.engines.direct import direct_posterior_distribution
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    y_np = np.random.default_rng(2).normal(0.2, 1.1, 25)
    y = torch.as_tensor(y_np, device=dev, dtype=dtype)
    problem = define_inference_problem(
        parameters=[("mu", -8.0, 8.0), ("var", 0.05, 20.0)],
        log_likelihood=lambda th: torch.sum(Normal(th[0], torch.sqrt(th[1])).log_prob(y)),
        log_prior=lambda th: Normal(0.0, torch.sqrt(th[1] / 0.5)).log_prob(th[0]) + InverseGamma(2.0, 1.0).log_prob(
            th[1]),
        validate=False, device=dev, dtype=dtype,
    )
    post = direct_posterior_distribution(problem=problem, num_points=400)
    return float(post.log_evidence), _nig_quadrature(y_np, mu0=0.0, lam=0.5, a_ig=2.0, scale_ig=1.0, mu_lo=-8.0,
                                                     mu_hi=8.0, v_lo=0.05, v_hi=20.0)


def _dense_crude_log_z(log_x: np.ndarray, logl: np.ndarray) -> float:
    """Trapezoid crude logZ in numpy float64: mirror 2 - X_1 before the
    first point, (X_{m-1} + X_m) / 2 for the last."""
    xs = np.exp(log_x)
    prev = np.concatenate([[2.0 - xs[0]], xs[:-1]])
    w = 0.5 * (prev - np.concatenate([xs[1:], [0.0]]))
    w[-1] = 0.5 * (xs[-2] + xs[-1])
    return float(np.log(np.sum(w * np.exp(logl - logl.max()))) + logl.max())


def _check_ns_bookkeeping(dev, dtype):
    from bayesianinference_tpu_torch.engines.nested_sampling import crude_log_z_masked
    from bayesianinference_tpu_torch.ops.ns_math import crude_log_x_deleted, pool_schedule

    rng = np.random.default_rng(4)
    n_live, n_dead, cap = 50, 300, 400
    logl_all = np.sort(rng.normal(-20.0, 6.0, n_dead + n_live))
    dead = np.full(cap, -1e30)
    dead[:n_dead] = logl_all[:n_dead]
    t = lambda a: torch.as_tensor(a, device=dev, dtype=dtype)  # noqa: E731
    log_xd = crude_log_x_deleted(pool_schedule(n_live, 1, cap, dtype=dtype, device=dev))
    log_z = crude_log_z_masked(log_xd, n_dead, t(dead), t(logl_all[n_dead:]))[0]
    xs_dead = -np.arange(1, n_dead + 1) / n_live
    log_x = np.concatenate([xs_dead, np.log(np.arange(n_live, 0, -1) / (n_live + 1.0)) + xs_dead[-1]])
    return float(log_z), _dense_crude_log_z(log_x, logl_all)


def _check_merged_ns_bookkeeping(dev, dtype):
    from bayesianinference_tpu_torch.engines.dynamic_ns import NSSegment, merge_segments, merged_evidence_sampling

    rng = np.random.default_rng(7)

    def synth(n_live, k, n_dead, lo, hi, constraint):
        levels = np.sort(rng.uniform(lo, hi, n_dead + n_live))
        return NSSegment(points=levels[:, None].copy(), log_likelihoods=levels, log_priors=np.zeros_like(levels),
                         n_live=n_live, num_delete=k, n_dead=n_dead, constraint_logl=constraint)

    base = synth(60, 1, 240, -40.0, -5.0, -np.inf)
    mid = float(np.median(base.log_likelihoods))
    pts, logl, logp, m = merge_segments([base, synth(40, 4, 120, mid + 1e-6, -5.0, mid)])
    t = lambda a: torch.as_tensor(a, device=dev, dtype=dtype)  # noqa: E731
    res = merged_evidence_sampling(points=t(pts), log_likelihoods=t(logl), log_priors=t(logp), schedule=t(m),
                                   num_runs=None)
    return float(res.crude_log_evidence), _dense_crude_log_z(-np.cumsum(1.0 / m), logl)


PRECISION_CHECKS = (
    ("blr_exact_logz", _check_blr),
    ("conjugate_normal_logz", _check_conjugate_normal),
    ("direct_quadrature_logz", _check_direct),
    ("ns_crude_bookkeeping", _check_ns_bookkeeping),
    ("merged_ns_bookkeeping", _check_merged_ns_bookkeeping),
)


def _bench_blr_data(n: int = 4096):
    """bench.py::bench_blr's law with numpy draws: x ~ U(-2, 2), y = 1 - 2 x
    + x^3 / 2 + 0.1 N(0, 1); a second output sin(x) + 0.1 N(0, 1)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, (n, 1))
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * rng.standard_normal(n)
    return x, y, np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)


def phase_conjugate(smi: str, dev="cuda"):
    """The conjugate engines and direct quadrature on the card: BLR at
    bench.py::bench_blr's width (n = 4096, degree 3) in float64 and float32
    against the textbook NIG evidence, with its fits per second; the
    vector-output BLR, the Normal, Multinormal and categorical models
    against the same on CPU tensors; precision.py's five checks of these
    paths against numpy references, in float64 and float32."""
    from bayesianinference_tpu_torch.engines import conjugate as tc
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device(dev)
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matrix products would run in TF32")
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    x_np, y_np, y2_np = _bench_blr_data()
    n = x_np.shape[0]
    notes = []
    for dtype, bound in ((torch.float64, 1e-10), (torch.float32, max(10 * PRECISION_F32["blr_exact_logz"], 1e-6))):
        x, y = (torch.as_tensor(a, device=dev, dtype=dtype) for a in (x_np, y_np))
        fit = tc.bayesian_linear_regression(x, y, degree=3)
        got, ref = float(fit.log_evidence), _nig_textbook_log_z(fit, n)
        rel = abs(got - ref) / abs(ref)
        if not rel <= bound:
            raise AssertionError(f"BLR n={n} {dtype}: logZ {got} against the textbook NIG {ref}: rel {rel:.3e}")
        fit_once = lambda: float(tc.bayesian_linear_regression(x, y, degree=3).log_evidence)  # noqa: E731
        wall = []
        for _ in range(21):
            t0 = time.perf_counter()
            fit_once()
            wall.append(time.perf_counter() - t0)
        notes.append(f"{str(dtype)[6:]} logZ {got:.6f} (textbook NIG {ref:.6f}, rel {rel:.2e}, bound {bound:.2e}), "
                     f"{1.0 / statistics.median(wall[1:]):.1f} fits/s (median of 20 after one warm-up), "
                     f"{_launches_per_call(fit_once, 3):g} CUDA kernels per fit")
    blr_launches = gk.cholesky_cuda.launches
    if blr_launches == 0:
        raise AssertionError("BLR: the cholesky kernel was not launched")

    # the other engines on the card against the same on CPU tensors (float64)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 3))
    mv_data = rng.normal(size=(200, 3)) @ (a @ a.T / 3 + np.eye(3)) + 0.5
    categories = rng.integers(0, 5, 300).astype(float)
    engines = {
        "vector-output BLR": lambda d: tc.bayesian_linear_regression(
            torch.as_tensor(x_np, device=d), torch.as_tensor(np.stack([y_np, y2_np], -1), device=d), degree=3),
        "normal model": lambda d: tc.normal_conjugate_model(torch.as_tensor(y_np[:500], device=d)),
        "multinormal model (d = 3)": lambda d: tc.multinormal_conjugate_model(torch.as_tensor(mv_data, device=d)),
        "categorical model": lambda d: tc.categorical_conjugate_model(
            torch.as_tensor(categories, device=d), num_categories=5),
    }
    for name, run in engines.items():
        before = gk.cholesky_cuda.launches
        on_card, on_cpu = run(dev), run("cpu")
        got, want = float(on_card.log_evidence), float(on_cpu.log_evidence)
        rel = abs(got - want) / abs(want)
        if not (on_card.log_evidence.device.type == dev.type and rel <= 1e-10):
            raise AssertionError(f"{name}: logZ {got} on {on_card.log_evidence.device}, {want} on the CPU")
        notes.append(f"{name} logZ {got:.6f} (CPU {rel:.1e} rel, {gk.cholesky_cuda.launches - before} cholesky "
                     f"launches)")
    fit = engines["vector-output BLR"](dev)
    draw = fit.posterior["FullPosterior"].sample(torch.Generator(device=dev).manual_seed(0))
    lp = fit.posterior["FullPosterior"].log_prob(draw)
    if not (draw["covariance"].shape == (2, 2) and draw["coefficients"].shape == (4, 2) and bool(torch.isfinite(lp))):
        raise AssertionError(f"vector-output BLR: posterior draw {[tuple(v.shape) for v in draw.values()]}, "
                             f"log density {float(lp)}")

    checks = []
    for name, check in PRECISION_CHECKS:
        for dtype in (torch.float64, torch.float32):
            got, ref = check(dev, dtype)
            rel = abs(got - ref) / max(abs(ref), 1e-300)
            bound = 1e-10 if dtype == torch.float64 else max(10 * PRECISION_F32[name], 1e-6)
            if not rel <= bound:
                raise AssertionError(f"{name} {dtype}: {got} against {ref}: rel {rel:.3e} above {bound:.1e}")
            checks.append(f"{name} {str(dtype)[6:]} {rel:.2e} (bound {bound:.1e})")
    log(f"[12 conjugate, BLR, direct] BLR n={n} degree 3: " + "; ".join(notes) + f"; {blr_launches} cholesky "
        f"launches in the BLR fits; precision.py's checks, rel err against numpy references: " + ", ".join(checks)
        + f" | {smi}")
    return {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}



class _Syncs:
    """The synchronizing CUDA calls made while entered, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: every copy to
    or from the host, ``.item()`` and ``bool()``, ``nonzero``, masked
    indexing, every wait on a stream or event, in Python or inside an op or
    its reverse rule.  Each is kept as the names of the port's functions on
    the stack when it was made, innermost last, and the innermost one's
    line."""

    def __enter__(self):
        self.stacks, self.sites = [], collections.Counter()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            port = [f for f in traceback.extract_stack() if "bayesianinference_tpu_torch" in f.filename]
            self.stacks.append(tuple(f.name for f in port))
            self.sites[f"{Path(port[-1].filename).name}:{port[-1].lineno} {port[-1].name}" if port else "script"] += 1

        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)

    def inside(self, name: str) -> int:
        """The syncs made while ``name`` was on the stack."""
        return sum(name in st for st in self.stacks)


def _box_problem_f32(dim: int, dev):
    """benchmarks/smc_hmc_throughput.py::make_problem: a standard Gaussian
    likelihood under the uniform box [-5, 5]^dim, float32."""
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    return define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(dim)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim, device=torch.device(dev), dtype=torch.float32)


# the variance of a standard normal truncated to [-5, 5]
_BOX_VAR = 1.0 - 10.0 * math.exp(-12.5) / math.sqrt(2 * math.pi) / math.erf(5.0 / math.sqrt(2.0))


def _check_box_moments(tag, samples, tol_mean=0.05, tol_var=0.10):
    pooled = samples.reshape(-1, samples.shape[-1]).double()
    mean, var = pooled.mean(dim=0), pooled.var(dim=0)
    worst_mean, worst_var = mean.abs().max().item(), ((var - _BOX_VAR).abs() / _BOX_VAR).max().item()
    if not (worst_mean <= tol_mean and worst_var <= tol_var):
        raise AssertionError(f"{tag}: pooled mean off 0 by {worst_mean:.4f} (gate {tol_mean}), variance off the "
                             f"truncated unit variance by {worst_var:.2%} (gate {tol_var:.0%})")
    return f"pooled mean within {worst_mean:.4f} of 0, variance within {worst_var:.2%} of {_BOX_VAR:.6f}"


def _sampler_hmc(smi, dev, chains=8192, warmup=60, samples=64, leapfrog=16, dim=16):
    """(a) bench_hmc's width: fixed 16-step trajectories, float32.  64
    samples, the bench's setting through its round 4 (256 since): with 256
    this run took 37 s and the phase 96 s on a slow host."""
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample

    problem = _box_problem_f32(dim, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Syncs() as syncs:
        r = hmc_sample(problem, torch.Generator(device=dev).manual_seed(0), num_chains=chains, num_samples=samples,
                       num_warmup=warmup, num_leapfrog=leapfrog)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moments = _check_box_moments("13a HMC", r.samples)
    acc = float(r.acceptance_rates.mean())
    div = int(r.divergences.sum()) / (chains * samples)
    # none inside a trajectory, and too few in the run for one per iteration anywhere
    in_traj, total = syncs.inside("hmc_step"), sum(syncs.sites.values())
    if not (0.6 <= acc <= 0.95 and div < 0.01 and in_traj == 0 and total < warmup + samples):
        raise AssertionError(f"13a HMC: acceptance {acc:.3f}, divergent share {div:.4f}, {in_traj} syncs inside a "
                             f"trajectory, {total} in the run: {dict(syncs.sites)}")
    rate = chains * (samples + warmup) * leapfrog / wall
    log(f"[13a HMC] d={dim} box Gaussian f32, {chains} chains, {warmup} warmup, {samples} samples (the bench's 256 "
        f"cut to its round-4 64 to fit the script's time), {leapfrog} leapfrog: {rate:.4g} grad-evals/s (the bench's "
        f"chains x (samples + warmup) x leapfrog / wall; {wall:.2f} s); {moments}; acceptance {acc:.3f}, divergent "
        f"share {div:.4%}, step size {float(r.step_size):.4f}; synchronizing calls {in_traj} inside trajectories, "
        f"{total} in the whole run ({dict(syncs.sites)}) | {smi}")


def _sampler_chees(smi, dev, chains=1024, warmup=150, samples=100, max_leapfrog=64, dim=16):
    """(b) ChEES on (a)'s problem with a dense mass (its factor through the
    Cholesky kernel at n = d), and on tests/test_hmc.py's rho = 0.9
    Gaussian, where the JAX test holds the learned length above 4 steps."""
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample
    from bayesianinference_tpu_torch.ops import chees
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    problem = _box_problem_f32(dim, dev)
    steps, run_leapfrog = [], chees.leapfrog

    def recording(x, p, grad, fn, eps, inv_mass, num_steps):
        steps.append(num_steps)
        return run_leapfrog(x, p, grad, fn, eps, inv_mass, num_steps)

    gk.cholesky_cuda.launches = 0
    chees.leapfrog = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _Syncs() as syncs:
            r = hmc_sample(problem, torch.Generator(device=dev).manual_seed(1), num_chains=chains,
                           num_samples=samples, num_warmup=warmup, num_leapfrog="auto", max_leapfrog=max_leapfrog,
                           dense_mass=True)
            torch.cuda.synchronize()
    finally:
        chees.leapfrog = run_leapfrog
    wall = time.perf_counter() - t0
    chol = gk.cholesky_cuda.launches
    moments = _check_box_moments("13b ChEES", r.samples)
    trajectories = warmup + samples
    tl, eps = float(r.trajectory_length), float(r.step_size)
    acc = float(r.acceptance_rates.mean())
    in_traj, total = syncs.inside("_chees_iteration"), sum(syncs.sites.values())
    # the learned length on this isotropic target: the JAX package gives 3.5-4.0 step sizes here (CPU, 256
    # chains, two seeds), so its 4-step floor is gated on the correlated target below, and here at 2
    if not (math.isfinite(tl) and tl > 2 * eps and len(steps) == trajectories and max(steps) <= max_leapfrog
            and in_traj == trajectories and total - in_traj < trajectories and chol == 2 and 0.6 <= acc <= 0.95):
        raise AssertionError(f"13b ChEES: length {tl} at step {eps}, {len(steps)} trajectories of at most "
                             f"{max(steps, default=0)} steps, {in_traj} syncs inside {trajectories} trajectories and "
                             f"{total} in the run ({dict(syncs.sites)}), {chol} dense factors, acceptance {acc:.3f}")
    line = (f"[13b ChEES] d={dim} box Gaussian f32, {chains} chains, {warmup} warmup, {samples} samples, "
            f"max_leapfrog {max_leapfrog}, dense mass (its factor: {chol} Cholesky kernel launches at n = {dim}): "
            f"{wall:.2f} s; {moments}; learned length {tl:.4f} = {tl / eps:.2f} steps of {eps:.4f}, longest "
            f"trajectory {max(steps)} steps, acceptance {acc:.3f}; synchronizing calls {in_traj} inside "
            f"{trajectories} trajectories, {total} in the whole run ({dict(syncs.sites)})")

    cov = torch.tensor([[1.0, 0.9], [0.9, 1.0]], dtype=torch.float32, device=dev)
    prec = torch.linalg.inv(cov)
    x0 = torch.randn((chains, 2), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    r = hmc_sample(lambda x: -0.5 * x @ prec @ x, torch.Generator(device=dev).manual_seed(3), num_chains=chains,
                   num_samples=samples, num_warmup=450, num_leapfrog="auto", starting_points=x0)
    tl, eps = float(r.trajectory_length), float(r.step_size)
    pooled = r.samples.reshape(-1, 2).double()
    err = (torch.cov(pooled.T) - cov.double()).abs().max().item()
    if not (tl > 4 * eps and pooled.mean(dim=0).abs().max().item() <= 0.05 and err <= 0.05):
        raise AssertionError(f"13b ChEES rho = 0.9: length {tl} at step {eps}, covariance error {err:.4f}")
    log(f"{line}; on tests/test_hmc.py's rho = 0.9 Gaussian (450 warmup, diagonal mass): {tl / eps:.2f} steps "
        f"(gate 4), covariance within {err:.4f} | {smi}")
    return chol


def _sampler_hmc_gp(smi, dev, problem, cpu_problem, ns_res, chains=16, warmup=60, samples=60, leapfrog=8):
    """(c) HMC on phase 4's GP problem through both kernels and both reverse
    rules at B = 16, the chains started at draws of phase 4's weighted NS
    posterior.  From prior draws some chains stay away from the bulk (on
    the card a secondary mode, lengthscale about 0.29 and the noise at its
    floor): 60, 150 and 300 warmup iterations each left a chain there
    (split R-hat 2.3-7.3).  The JAX package's ``hmc_sample`` from the same
    prior draws does the same (``tests/witness_port_jax.py gp-hmc``)."""
    from bayesianinference_tpu_torch import csrc
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.results import gelman_rubin

    w = torch.exp(ns_res.crude_log_posterior_weights)
    w = w / w.sum()
    starts = ns_res.points[torch.multinomial(w, chains, replacement=True,
                                             generator=torch.Generator(device=dev).manual_seed(11))]
    seen = {"bi_se_covariance": [], "bi_cholesky": []}
    default = csrc.load_library
    csrc.load_library = lambda: _RecordingLibrary(default(), seen)
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _Syncs() as syncs:
            r = hmc_sample(problem, torch.Generator(device=dev).manual_seed(4), num_chains=chains,
                           num_samples=samples, num_warmup=warmup, num_leapfrog=leapfrog, starting_points=starts)
            torch.cuda.synchronize()
    finally:
        csrc.load_library = default
    wall = time.perf_counter() - t0
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    steps = (warmup + samples) * leapfrog
    batches = {name: sorted(set(b)) for name, b in seen.items()}
    if not (min(launches.values()) >= steps and all(v == [chains] for v in batches.values())):
        raise AssertionError(f"13c GP HMC: launches {launches} for {steps} leapfrog steps, batch sizes {batches}")
    # logML and its gradient at the final states against the plain path on CPU tensors
    final = r.samples[:, -1]
    got, got_g = _problem_value_and_grad(problem, final)
    want, want_g = _problem_value_and_grad(cpu_problem, final.cpu())
    rel_v = _rel(got.cpu(), want)
    rel_g = ((got_g.cpu() - want_g).abs().max() / want_g.abs().max()).item()
    # the posterior of the log-hyperparameters against phase 4's weighted NS posterior
    u = torch.log(ns_res.points)
    ns_mean = (w[:, None] * u).sum(dim=0)
    ns_sd = torch.sqrt((w[:, None] * (u - ns_mean) ** 2).sum(dim=0))
    hmc_mean = torch.log(r.samples).reshape(-1, r.samples.shape[-1]).mean(dim=0)
    off = ((hmc_mean - ns_mean).abs() / ns_sd).max().item()
    rhat = max(float(gelman_rubin(r.per_parameter_chains(i))) for i in range(r.samples.shape[-1]))
    acc = float(r.acceptance_rates.mean())
    in_traj = syncs.inside("hmc_step")
    if not (rel_v <= 1e-8 and rel_g <= 1e-6 and off <= 0.3 and rhat < 1.1 and in_traj == 0):
        raise AssertionError(f"13c GP HMC: logML vs plain {rel_v:.3e}, gradient {rel_g:.3e}, posterior mean "
                             f"{off:.3f} NS sds off, split R-hat {rhat:.4f}, {in_traj} syncs inside trajectories "
                             f"({dict(syncs.sites)})")
    log(f"[13c GP HMC] phase 4's problem (n={SLICE_N} d={SLICE_D} f64), {chains} chains started at draws of phase 4's "
        f"NS posterior, {warmup} warmup, {samples} samples (100 cut to fit the script's time), {leapfrog} leapfrog: "
        f"{wall:.2f} s = {1e3 * wall / steps:.2f} ms per leapfrog step, {chains * steps / wall:.4g} grad-evals/s; "
        f"launches {launches}, every one at B = {chains}; acceptance {acc:.3f}, divergences "
        f"{int(r.divergences.sum())}; logML vs plain {rel_v:.3e}, gradient {rel_g:.3e} at the final states; "
        f"log-hyperparameter means within {off:.3f} posterior sds of phase 4's NS posterior; split R-hat at most "
        f"{rhat:.4f}; synchronizing calls {in_traj} inside trajectories, "
        f"{sum(syncs.sites.values())} in the whole run ({dict(syncs.sites)}) | {smi}")
    return launches


def _problem_value_and_grad(problem, theta):
    th = theta.detach().clone().requires_grad_(True)
    value = problem.guarded_log_likelihood(th)
    (grad,) = torch.autograd.grad(value.sum(), th)
    return value.detach(), grad


def _sampler_smc(smi, dev, particles=32768, runs=2, steps=100, dim=2):
    """(d) bench_smc's width: the d = 2 box Gaussian, float32."""
    from bayesianinference_tpu_torch.engines.smc import smc_sampler, thermodynamic_log_evidence

    problem = _box_problem_f32(dim, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Syncs() as syncs:
        r = smc_sampler(problem, torch.Generator(device=dev).manual_seed(5), n_particles=particles, num_runs=runs,
                        mcmc_steps=steps)
        logz, sem = float(r.log_evidence.mean), float(r.log_evidence.standard_error)
    wall = time.perf_counter() - t0
    stages = int(r.n_stages.max())
    in_loop = syncs.inside("_smc_ladders")
    ti = thermodynamic_log_evidence(r)
    ti_mean, ti_sem = float(ti.mean), float(ti.standard_error)
    analytic = -math.log(100.0)
    ladders_ok = True
    for run in range(runs):
        ns = int(r.n_stages[run])
        b = r.betas[run, :ns].double().cpu().numpy()
        ladders_ok &= bool(b[-1] == 1.0 and (np.diff(np.concatenate([[0.0], b])) > 0).all())
    if not (abs(logz - analytic) <= 4 * max(sem, 0.02) and abs(ti_mean - logz) <= 4 * max(math.hypot(ti_sem, sem),
                                                                                         0.05) and ladders_ok
            and in_loop == stages + 1):
        raise AssertionError(f"13d SMC: logZ {logz} +- {sem} (analytic {analytic:.4f}), TI {ti_mean} +- {ti_sem}, "
                             f"ladders ending at 1 and rising: {ladders_ok}; {in_loop} syncs in the stage loop of "
                             f"{stages} stages ({dict(syncs.sites)})")
    log(f"[13d SMC] d={dim} box Gaussian f32, {particles} particles x {runs} runs, {steps} MH steps: logZ "
        f"{logz:.4f} +- {sem:.4f} (analytic {analytic:.4f}), thermodynamic {ti_mean:.4f} +- {ti_sem:.4f}; stages "
        f"{r.n_stages.tolist()}; {r.num_likelihood_evals} evals in {wall:.2f} s = "
        f"{r.num_likelihood_evals / wall:.4g} evals/s; synchronizing calls {in_loop} in the stage loop (one per "
        f"stage and the last test), {sum(syncs.sites.values())} in the whole run ({dict(syncs.sites)}) | "
        f"{smi}")


def _sampler_smc_gp(smi, dev, problem, cpu_problem, grid_logz, particles=500, runs=2, steps=10):
    """(e) SMC on phase 4's GP problem: both forward kernels at B = 1000."""
    from bayesianinference_tpu_torch import csrc
    from bayesianinference_tpu_torch.engines.smc import smc_sampler
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    seen = {"bi_se_covariance": [], "bi_cholesky": []}
    default = csrc.load_library
    csrc.load_library = lambda: _RecordingLibrary(default(), seen)
    gk.se_covariance_cuda.launches = 0
    gk.cholesky_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with _Syncs() as syncs:
            r = smc_sampler(problem, torch.Generator(device=dev).manual_seed(6), n_particles=particles,
                            num_runs=runs, mcmc_steps=steps)
            logz, sem = float(r.log_evidence.mean), float(r.log_evidence.standard_error)
    finally:
        csrc.load_library = default
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
    batches = {name: sorted(set(b)) for name, b in seen.items()}
    stages = int(r.n_stages.max())
    calls = 1 + stages * (steps + 2)  # the starting particles; per stage the chains' seeds, steps and results
    if not (all(v == [runs * particles] for v in batches.values())
            and launches["se_covariance"] == launches["cholesky"] == calls):
        raise AssertionError(f"13e GP SMC: launches {launches} (expected {calls} of each), batch sizes {batches}")
    # the card's side in one call at B = runs * particles, the ladder's shape; the plain side in chunks
    pts = r.particles.reshape(-1, r.particles.shape[-1])
    se_before = gk.se_covariance_cuda.launches
    got = problem.guarded_log_likelihood(pts).cpu()
    if gk.se_covariance_cuda.launches != se_before + 1:
        raise AssertionError(f"13e: the check at B = {pts.shape[0]} made "
                             f"{gk.se_covariance_cuda.launches - se_before} SE covariance launches, not one")
    want = torch.cat([cpu_problem.guarded_log_likelihood(pts[i:i + 100].cpu()) for i in range(0, pts.shape[0], 100)])
    ok = want > -0.5e300
    rel = _rel(got[ok], want[ok])
    in_loop = syncs.inside("_smc_ladders")
    if not (abs(logz - grid_logz) <= 4 * max(sem, 0.1) and bool(ok.all()) and rel <= 1e-8
            and in_loop == stages + 1):
        raise AssertionError(f"13e GP SMC: logZ {logz} +- {sem} against the grid's {grid_logz:.4f}; logML vs plain "
                             f"{rel:.3e}, {int((~ok).sum())} sentinels; {in_loop} syncs in the loop of {stages} "
                             f"stages ({dict(syncs.sites)})")
    # the fused Cholesky at the SMC's batch, timed against its plain version (cholesky_ex) and its bound
    g = torch.Generator(device=dev).manual_seed(9)
    a = torch.randn((runs * particles, SLICE_N, 64), generator=g, device=dev, dtype=torch.float64)
    k = a @ a.mT + SLICE_N * torch.eye(SLICE_N, device=dev, dtype=torch.float64)
    del a
    err = ((gk.cholesky_cuda(k) - gk.cholesky_plain(k)).abs().max() / gk.cholesky_plain(k).abs().max()).item()
    kern_ms, plain_ms, _, _ = _in_turns(lambda: gk.cholesky_cuda(k), lambda: gk.cholesky_plain(k), reps=3, groups=3,
                                        per_group=3)
    bound_ms, bound_by = _chol_bound(runs * particles, SLICE_N, 8)
    del k
    if not err <= TOL["chol"][torch.float64]:
        raise AssertionError(f"13e: the Cholesky kernel at B = {runs * particles} against plain: {err:.3e}")
    log(f"[13e GP SMC] phase 4's problem (n={SLICE_N} d={SLICE_D} f64), {runs} runs x {particles} particles, "
        f"{steps} MH steps: logZ {logz:.4f} +- {sem:.4f} (phase 4's grid quadrature {grid_logz:.4f}), stages "
        f"{r.n_stages.tolist()}; launches {launches}, every one at B = {runs * particles}; {r.num_likelihood_evals} "
        f"evals in {wall:.2f} s = {r.num_likelihood_evals / wall:.4g} evals/s; logML vs plain {rel:.3e} at the "
        f"{pts.shape[0]} final particles; peak device memory {peak:.0f} MiB; the Cholesky kernel at B = "
        f"{runs * particles}, n = {SLICE_N} f64: {kern_ms:.3f} device ms against plain {plain_ms:.3f} (bound "
        f"{bound_ms:.4f} by {bound_by}), max error {err:.2e} of max |L|; synchronizing calls "
        f"{in_loop} in the stage loop, {sum(syncs.sites.values())} in the whole run "
        f"({dict(syncs.sites)}) | {smi}")
    return launches


def _sampler_ensemble(smi, dev, walkers=32768, dim=8, sweeps=1024, de_sweeps=256):
    """(f) bench.py::bench_ensemble's width: the correlated d = 8 Gaussian,
    float32, stretch move; then the DE move."""
    from bayesianinference_tpu_torch.engines.ensemble import ensemble_sample

    rng = np.random.default_rng(0)
    a = rng.standard_normal((dim, dim))
    prec_np = np.eye(dim) + 0.1 * (a @ a.T)
    prec = torch.tensor(prec_np, dtype=torch.float32, device=dev)
    want = np.diag(np.linalg.inv(prec_np))
    x0 = torch.randn((walkers, dim), generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    notes = []
    for move, n in (("stretch", sweeps), ("de", de_sweeps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ensemble_sample(lambda x: -0.5 * x @ prec @ x, torch.Generator(device=dev).manual_seed(8),
                            num_walkers=walkers, num_samples=n, num_warmup=0, starting_points=x0, move=move)
        acc = float(r.acceptance_rates.mean())
        wall = time.perf_counter() - t0
        # the sweeps after the first quarter: the walkers start from N(0, I)
        kept = r.samples[:, n // 4:].reshape(-1, dim).double()
        var = kept.var(dim=0).cpu().numpy()
        worst = float(np.max(np.abs(var - want) / want))
        if not (worst <= 0.10 and (move == "de" or 0.2 < acc < 0.9)):
            raise AssertionError(f"13f ensemble {move}: variance off by {worst:.2%}, acceptance {acc:.3f}")
        notes.append(f"{move}: {n} sweeps, {walkers * n / wall:.4g} evals/s (walkers x sweeps / wall, {wall:.2f} "
                     f"s), acceptance {acc:.3f}, sample variances within {worst:.2%} of inv(prec)'s diagonal "
                     f"(sweeps after the first {n // 4})")
    log(f"[13f ensemble] {walkers} walkers, d={dim} correlated Gaussian f32: " + "; ".join(notes) + f" | {smi}")


def phase_samplers(smi: str, gp_problem, gp_posterior, dev="cuda"):
    """HMC (fixed and ChEES), tempered SMC and the ensemble at the JAX
    bench's widths, and HMC and SMC of phase 4's GP problem through both
    kernels.  Returns the kernels' launches of (c) and (e)."""
    dev = torch.device(dev)
    ns_res, grid_logz, cpu_problem = gp_posterior
    t = time.perf_counter()
    _sampler_hmc(smi, dev)
    dense_factors = _sampler_chees(smi, dev)
    launches = _sampler_hmc_gp(smi, dev, gp_problem, cpu_problem, ns_res)
    _sampler_smc(smi, dev)
    smc_launches = _sampler_smc_gp(smi, dev, gp_problem, cpu_problem, grid_logz)
    _sampler_ensemble(smi, dev)
    log(f"[13 samplers] {time.perf_counter() - t:.1f} s")
    return {"se_covariance": launches["se_covariance"] + smc_launches["se_covariance"],
            "cholesky": launches["cholesky"] + smc_launches["cholesky"] + dense_factors}


# ---------------------------------------------------------------------------
# phase 14: latent-GP classification (Laplace, EP, ESS), SGPR, the Student-t
# process and the multi-output GP
# ---------------------------------------------------------------------------

CLASS_N = 512  # benchmarks/latent_gp.py::bench_bridges' first width
BRIDGE_NS = (512, 1024, 2048, 4096)  # benchmarks/latent_gp.py::bench_bridges
BRIDGE_SEEDS = 8  # data draws per 14b case
SGPR_N, SGPR_M, SGPR_D = 262144, 512, 4  # bench.py::bench_sgpr
MOGP_N, MOGP_T = 2048, 4  # benchmarks/latent_gp.py::bench_mogp
_CLASS_PARAMS = [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)]  # tests/test_gp_classify.py:209-223


class _KernelWatch:
    """Holds the first launch of each kernel at each new shape against the
    plain version on the same inputs, while the path runs: wraps the SE
    op's CUDA implementation and the Cholesky's launch (the wrappers' own
    launch counters go on counting; the plain versions launch no kernel).
    ``errs`` maps each shape seen to its error: the SE's max abs error over
    the variance, the Cholesky's over max |L| (failed matrices must fail
    on both sides).  A Cholesky factor's forward error grows with the
    matrix's condition number (K_uu of an SGPR fit, with its 1e-12 jitter,
    is near singular); where it passes phase 2's bound the shape passes,
    and elsewhere the kernel's backward error max|L L^T - K| / max|K| must
    be at most twice cuSOLVER's plus n eps (``backward`` holds those)."""

    def __init__(self):
        self.errs, self.backward = {}, {}

    def __enter__(self):
        from bayesianinference_tpu_torch.ops import gp_kernels as gk

        self.gk, self.se_orig, self.launch_orig = gk, gk.se_covariance_cuda, gk._cholesky_launch
        watch = self

        def se(x1, x2, variance, lengthscale=None, nugget=None, tile=0):
            out = watch.se_orig(x1, x2, variance, lengthscale, nugget, tile)
            key = ("se_covariance", str(x1.dtype).split(".")[-1], tuple(out.shape), x1.shape[-1],
                   "symmetric" if x2 is None else "cross", lengthscale is not None, nugget is not None)
            if key not in watch.errs:
                with torch.no_grad():
                    want = _se_plain_in_row_blocks(gk, x1, x2, variance, lengthscale, nugget)
                    watch.errs[key] = ((out - want).abs() / variance.abs()[:, None, None]).max().item()
            return out

        se.launches, se.launches_by_device = self.se_orig.launches, self.se_orig.launches_by_device

        def launch(k, route, nb):
            out = watch.launch_orig(k, route, nb)
            key = ("cholesky", str(k.dtype).split(".")[-1], tuple(k.shape), route)
            if key not in watch.errs:
                with torch.no_grad():
                    want = gk.cholesky_plain(k)
                    ok_got = torch.isfinite(torch.diagonal(out, dim1=-2, dim2=-1)).all(dim=-1)
                    ok_want = torch.isfinite(torch.diagonal(want, dim1=-2, dim2=-1)).all(dim=-1)
                    if not torch.equal(ok_got, ok_want):
                        watch.errs[key] = math.inf
                    elif bool(ok_want.any()):
                        got_ok, want_ok, kk = out[ok_want], want[ok_want], k[ok_want]
                        watch.errs[key] = ((got_ok - want_ok).abs().max() / want_ok.abs().max()).item()
                        if watch.errs[key] > TOL["chol"][k.dtype]:
                            sym = kk.tril() + kk.tril(-1).mT
                            res = lambda f: ((f @ f.mT - sym).abs().max() / sym.abs().max()).item()  # noqa: E731
                            watch.backward[key] = (res(got_ok), res(want_ok),
                                                   k.shape[-1] * torch.finfo(k.dtype).eps)
                    else:
                        watch.errs[key] = 0.0
            return out

        gk.se_covariance_cuda, gk._cholesky_launch = se, launch
        return self

    def __exit__(self, *exc):
        self.se_orig.launches = self.gk.se_covariance_cuda.launches
        self.gk.se_covariance_cuda, self.gk._cholesky_launch = self.se_orig, self.launch_orig
        return False

    def counts(self) -> dict:
        return {"se_covariance": self.gk.se_covariance_cuda.launches, "cholesky": self.gk.cholesky_cuda.launches}

    def zero(self) -> None:
        self.gk.se_covariance_cuda.launches = 0
        self.gk.cholesky_cuda.launches = 0

    def check(self, what: str) -> str:
        """Fails unless every shape seen so far is within TOL; a summary."""
        def passes(key, err):
            if err <= TOL["se" if key[0] == "se_covariance" else "chol"][getattr(torch, key[1])]:
                return True
            r_kernel, r_plain, floor = self.backward.get(key, (math.inf, 0.0, 0.0))
            return r_kernel <= 2.0 * r_plain + floor

        bad = {k: (v, self.backward.get(k)) for k, v in self.errs.items() if not passes(k, v)}
        if bad:
            raise AssertionError(f"{what}: kernel against its plain version out of tolerance at {bad}")
        worst = {name: max([v for k, v in self.errs.items() if k[0] == name] or [0.0])
                 for name in ("se_covariance", "cholesky")}
        by_backward = "".join(f"; {k[1]} {k[2]} by backward error {r:.1e} (cuSOLVER {p:.1e})"
                              for k, (r, p, _) in self.backward.items())
        return (f"{len(self.errs)} kernel shapes held against the plain versions, worst rel err "
                f"se {worst['se_covariance']:.2e}, cholesky {worst['cholesky']:.2e}{by_backward}")


class _plain_ops:
    """Routes the GP modules through plain PyTorch (no hand-written kernel):
    the SE kernel's covariance by ``squared_distances`` and ``exp``, every
    Cholesky by ``torch.linalg.cholesky_ex`` (NaN where it fails), both
    differentiated by autograd.  The plain path of a sub-phase's accuracy
    gate; the launch counters must not move inside."""

    def __enter__(self):
        from bayesianinference_tpu_torch.engines import bayesopt, gp_classify
        from bayesianinference_tpu_torch.ops import gp_kernels as gk
        from bayesianinference_tpu_torch.ops import gp_laplace, mogp, sgpr, svgp, t_process

        def chol(k):
            factor, info = torch.linalg.cholesky_ex(k)
            return torch.where((info == 0)[..., None, None], factor, torch.full_like(factor, math.nan))

        def se(x1, x2, variance, lengthscale=None, nugget=None):
            x1 = torch.as_tensor(x1)
            x2 = x1 if x2 is None else x2
            scale = 1.0 if lengthscale is None else lengthscale
            k = variance * torch.exp(-0.5 * gk.squared_distances(x1 / scale, x2 / scale))
            if nugget is not None:
                k = k + torch.diag_embed(torch.broadcast_to(torch.as_tensor(nugget, dtype=k.dtype, device=k.device),
                                                            k.shape[:-1]))
            return k

        self.saved = [(m, name, getattr(m, name)) for m, name in (
            (gk, "se_covariance"), (gk, "cholesky"), (gp_laplace, "cholesky"), (sgpr, "cholesky"),
            (t_process, "cholesky"), (mogp, "cholesky"), (gp_classify, "cholesky"), (svgp, "cholesky"),
            (bayesopt, "cholesky"), (bayesopt, "se_covariance"))]
        for m, name, _ in self.saved:
            setattr(m, name, se if name == "se_covariance" else chol)
        self.before = gk.se_covariance_cuda.launches + gk.cholesky_cuda.launches
        self.gk = gk
        return self

    def __exit__(self, exc_type, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)
        if exc_type is None and self.gk.se_covariance_cuda.launches + self.gk.cholesky_cuda.launches != self.before:
            raise AssertionError("the plain path launched a hand-written kernel")
        return False


@_measuring
def _chol_turns(n: int, dtype, dev, b: int = 1) -> str:
    """The Cholesky at [b, n, n] against ``cholesky_ex`` in turns (device ms)
    beside its bound, on a well-conditioned matrix (the time does not
    depend on the values)."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    g = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn((b, n, n), generator=g, device=dev, dtype=dtype)
    k = a @ a.mT / n + torch.eye(n, device=dev, dtype=dtype)
    kw = dict(reps=3, groups=3, per_group=3) if n >= 4096 else dict(reps=3, groups=3, per_group=5)
    ms, lib_ms, _, _ = _in_turns(lambda: gk.cholesky(k), lambda: torch.linalg.cholesky_ex(k), **kw)
    bound, by = _chol_bound(b, n, k.element_size())
    return (f"B={b} n={n} {str(dtype).split('.')[-1]} {gk._cholesky_route(n)[0]}: {ms:.3f} ms (cholesky_ex "
            f"{lib_ms:.3f}, bound {bound:.3g} by {by})")


def _class_data(n: int, seed: int = 0):
    """benchmarks/latent_gp.py::_class_data: sorted x on [-3, 3] (float32),
    y ~ Bernoulli(sigmoid(3 sin(1.5 x)))."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0).astype(np.float32)
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
    return x, (rng.uniform(size=n) < p).astype(np.float32)


def _classifier(x, y, method: str = "laplace"):
    """tests/test_gp_classify.py's classifier (:209-223): SE kernel (amp^2, ls),
    Bernoulli-logit likelihood, scale priors."""
    from bayesianinference_tpu_torch.engines.gp_classify import define_gp_classifier
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    return define_gp_classifier(x, y, lambda th: se_kernel(th[0] ** 2, th[1]), _CLASS_PARAMS, method=method,
                                prior_distribution=["scale", "scale"], validate=False)


@_measuring
def _profile_call(fn, cpu: bool = True, warm: bool = True):
    """(device ms, CUDA kernels) of one call of ``fn`` under torch.profiler,
    the window opened with a traced warm-up step that is dropped.
    ``cpu=False`` records the CUDA activity alone: for a call of tens of
    thousands of kernels the host-side events take seconds to build.
    ``warm=False`` skips the untraced call before it, for a ``fn`` that was
    just timed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(10):
            torch.zeros(8, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def _vg(fn, *args):
    """[value, gradient...] of ``fn(*args)``, the gradient in those of
    ``args`` that require one, as one detached vector."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_(True) if isinstance(a, torch.Tensor) and a.requires_grad else a
                for a in args]
        value = fn(*args)
        grads = torch.autograd.grad(value, [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad])
    return torch.cat([value.detach().reshape(1)] + [g.detach().reshape(-1) for g in grads])


def _args(values, dev, grad: int):
    """``values`` as float32 and float64 tensors on ``dev`` ({dtype: list}),
    the first ``grad`` of them requiring a gradient."""
    return {dt: [torch.as_tensor(v, dtype=dt, device=dev).requires_grad_(i < grad) for i, v in enumerate(values)]
            for dt in (torch.float32, torch.float64)}


def _accuracy(fn, args32, args64):
    """The kernel path (float32) and the plain path (float32) against the
    plain float64 [value, gradient...] of ``fn`` on the same f32-rounded
    inputs.  Returns (kernel, plain, f64) as CPU float64 vectors and the
    two paths' normalized errors: the value's over |value|, each gradient
    entry's over the gradient's norm."""
    got = _vg(fn, *args32)
    with _plain_ops():
        plain = _vg(fn, *args32)
        ref = _vg(fn, *args64)
    torch.cuda.synchronize()
    got, plain, ref = got.double().cpu(), plain.double().cpu(), ref.double().cpu()
    scale = torch.cat([ref[:1].abs(), torch.full_like(ref[1:], float(ref[1:].norm()))]).clamp(min=1e-30)
    return got, plain, ref, (got - ref) / scale, (plain - ref) / scale


def _case_error(errs) -> float:
    """A case's normalized error over its runs (each an ``_accuracy``
    vector): the root mean square of the runs' norms, which is the norm
    itself for one run."""
    return math.sqrt(float(torch.stack([e.norm() ** 2 for e in errs]).mean()))


def _within_rule(ek: float, ep: float) -> bool:
    """The f32 accuracy rule: the kernel path's error at most twice the
    plain path's plus 1e-6."""
    return math.isfinite(ek) and ek <= 2.0 * ep + 1e-6


def _accuracy_gate(what: str, errs_kernel, errs_plain) -> str:
    """Fails unless one case's normalized errors (``_case_error`` of its
    runs) meet ``_within_rule``, the rule of phase 6."""
    ek, ep = _case_error(errs_kernel), _case_error(errs_plain)
    if not _within_rule(ek, ep):
        raise AssertionError(f"{what}: normalized error kernel path {ek:.3e} against the plain f32 path's {ep:.3e}")
    return f"normalized error kernel {ek:.2e} plain f32 {ep:.2e}"


def _phase14_classifier(smi, watch, dev, pool, k, steps, starts, min_iterations, n=CLASS_N, unit=10, times=False):
    """14a: the main path (NS over (amp, ls) of the logit classifier at
    n = 512, f64, Laplace), its Laplace fit and its predictions; with
    ``times`` (``chip_profile.py``), one density call at B = ``unit`` timed."""
    from bayesianinference_tpu_torch import csrc
    from bayesianinference_tpu_torch.engines.gp_classify import predict_from_gp_classifier
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.models.problem import random_domain_points
    from bayesianinference_tpu_torch.ops import gp_laplace as gl

    x_np, y_np = _class_data(n)
    x, y = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (x_np, y_np))
    problem = _classifier(x, y)
    seen = {"bi_se_covariance": [], "bi_cholesky": []}
    default = csrc.load_library
    csrc.load_library = lambda: _RecordingLibrary(default(), seen)
    watch.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), sample_pool_size=pool,
                              num_delete=k, monte_carlo_steps=steps, min_iterations=min_iterations)
        torch.cuda.synchronize()
    finally:
        csrc.load_library = default
    wall = time.perf_counter() - t0
    launches = watch.counts()
    calls = len(seen["bi_se_covariance"])  # one SE launch per density call
    newton = launches["cholesky"] - calls  # each call: a factorization per Newton step and one at the mode
    logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
    # every density call at the live batch: the starting pool's once, then the chains'
    se_b, chol_b = seen["bi_se_covariance"], seen["bi_cholesky"]
    first = next((i for i, b in enumerate(chol_b) if b != pool), len(chol_b))
    if not (se_b[:1] == [pool] and set(se_b[1:]) == {k} and set(chol_b[first:]) == {k} and launches["cholesky"]
            == len(chol_b) and launches["se_covariance"] == calls and launches["cholesky"] >= calls):
        raise AssertionError(f"14a: launches {launches}, SE batch sizes {sorted(set(se_b))} (first {se_b[:1]}), "
                             f"Cholesky batch sizes {sorted(set(chol_b[first:]))} after the first call's {first}")
    # logZ against a 2-D grid quadrature of the same logML x prior on the card
    z_fine, z_coarse = _grid_log_evidence(problem, res, 40, chunk=400), _grid_log_evidence(problem, res, 30, chunk=400)
    grid_err = abs(z_fine - z_coarse)
    if not (math.isfinite(logz) and abs(logz - z_fine) <= 3 * err + grid_err):
        raise AssertionError(f"14a: logZ {logz} +- {err} vs grid quadrature {z_fine} (grid err {grid_err:.2e})")
    # logML and Newton steps at the final live points against the plain path (CPU tensors)
    live = res.points[torch.argsort(res.log_likelihoods)[-pool:]]
    cpu_problem = _classifier(x.cpu(), y.cpu())
    got = problem.guarded_log_likelihood(live).cpu()
    want = cpu_problem.guarded_log_likelihood(live.cpu())
    rel = _rel(got, want)
    model, cpu_model = problem.metadata["gp_classifier"], cpu_problem.metadata["gp_classifier"]
    it_gpu = gl._newton_loop(model._k_batch(live), model.y, model.likelihood._derivs(), 50, 1e-8).iterations.cpu()
    it_cpu = gl._newton_loop(cpu_model._k_batch(live.cpu()), cpu_model.y, cpu_model.likelihood._derivs(), 50,
                             1e-8).iterations
    if not (rel <= 1e-8 and torch.equal(it_gpu, it_cpu)):
        raise AssertionError(f"14a: logML kernel vs plain rel diff {rel:.3e}; Newton steps equal "
                             f"{torch.equal(it_gpu, it_cpu)}")
    # the Laplace fit on the card against the same on CPU tensors
    st = random_domain_points(torch.Generator().manual_seed(0), cpu_problem.lower, cpu_problem.upper, starts,
                              scale=5.0)
    t1 = time.perf_counter()
    fit = laplace_posterior_fit(problem=problem, initial_guess=st.to(dev))
    fit_wall = time.perf_counter() - t1
    ref = laplace_posterior_fit(problem=cpu_problem, initial_guess=st)
    mode, prec = fit.mean.cpu(), fit.precision_matrix.cpu()
    errs = {"mode": ((mode - ref.mean).abs() / ref.mean.abs()).max().item(),
            "logZ": abs(float(fit.log_evidence) - float(ref.log_evidence)) / abs(float(ref.log_evidence)),
            "Hessian": ((prec - ref.precision_matrix).abs().max() / ref.precision_matrix.abs().max()).item()}
    tol = {"mode": 1e-6, "logZ": 1e-6, "Hessian": 1e-5}
    if not all(errs[key] <= tol[key] for key in tol):
        raise AssertionError(f"14a: Laplace fit on the card vs on CPU tensors, relative errors {errs} (bounds {tol})")
    xq = torch.linspace(-3, 3, 41, dtype=torch.float64, device=dev)[:, None]
    pred = predict_from_gp_classifier(res, problem, xq)
    p = pred.mean.cpu().numpy()
    p_true = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * xq[:, 0].cpu().numpy())))
    corr = float(np.corrcoef(p, p_true)[0, 1])
    if not (p.shape == (41,) and np.all((p >= 0) & (p <= 1)) and corr > 0.85):
        raise AssertionError(f"14a: predictions {p.tolist()} (correlation with the generating p {corr:.3f})")
    row = ""
    if times:
        # per density call at B = unit, the batch of PERF.md's row: CUDA kernels, Newton steps, wall and device time
        th = live[-unit:]
        one = lambda: problem.guarded_log_likelihood(th)  # noqa: E731
        c0 = watch.counts()["cholesky"]
        one()
        steps_here = watch.counts()["cholesky"] - c0 - 1
        kernels = _launches_per_call(one, calls=3)
        dev_ms, _ = _profile_call(one, warm=False)
        wall_ms = _wall_ms(one)
        row = (f"; one density call at B = {unit}: {steps_here} Newton steps, {kernels:.1f} CUDA kernels, wall "
               f"{wall_ms:.2f} ms, device {dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.3f}; the Cholesky of B, "
               f"device ms in turns: {_chol_turns(n, torch.float64, dev, b=unit)}")
    log(f"[14a GP classifier] logit, Laplace, n={n} f64 (benchmarks/latent_gp.py::_class_data), NS pool {pool}, "
        f"{k} deletions and at least {min_iterations} iterations, {steps} AM steps (cut from phase 4's 100), to fit "
        f"the time limit: logZ {logz:.4f} +- "
        f"{err:.4f}, grid quadrature {z_fine:.4f} (40^2 vs 30^2 differ by {grid_err:.1e}); {res.iterations} "
        f"iterations, {res.num_likelihood_evals} evals in {wall:.2f} s = {res.num_likelihood_evals / wall:.4g} "
        f"evals/s; {calls} density calls, {newton} batched Newton steps = {newton / calls:.2f} per call; launches "
        f"{launches}, every one at B = {k} after the starting pool's call at B = {pool}; logML kernel vs plain max "
        f"rel diff {rel:.3e} at the {pool} live points, Newton steps equal ({int(it_gpu.min())}-{int(it_gpu.max())}); "
        f"Laplace fit ({starts} starts) {fit_wall:.2f} s, mode {[round(v, 6) for v in mode.tolist()]}, logZ "
        f"{float(fit.log_evidence):.6f}, vs CPU tensors rel err {', '.join(f'{a} {b:.2e}' for a, b in errs.items())}; "
        f"predictions at 41 points, correlation with the generating p {corr:.3f}{row} | {smi}")
    return launches, problem, cpu_problem, fit.mean


def _phase14_bridges(smi, watch, dev, sizes, seeds=BRIDGE_SEEDS, times=False):
    """14b: logML + gradient of the logit classifier, Laplace and EP, at
    bench_bridges' widths (f32, theta = [1.5, 1.0], jitter 1e-5).  Each
    (n, method) case is gated on its own, over the data of ``seeds``
    generator seeds (seed 0 is the bench's): a single float32 gradient's
    error at these widths moves by a factor of two or more with the last
    bit of K, so one draw cannot tell two paths of like accuracy apart."""
    from bayesianinference_tpu_torch.ops import gp_ep as ge
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.ops import gp_laplace as gl

    lik = gl.bernoulli_logit_likelihood()
    lines, failed, launches = [], [], {"se_covariance": 0, "cholesky": 0}
    for n in sizes:
        for method, fn_ in (("laplace", gl.gp_laplace_log_marginal), ("ep", ge.gp_ep_log_marginal)):
            def logml(th, x, y, fn_=fn_):
                return fn_(gk.covariance_matrix(gk.se_kernel(th[0] ** 2, th[1]), x, 1e-5), y, lik)

            errs_k, errs_p = [], []
            watch.zero()
            for seed in range(seeds):
                x_np, y_np = _class_data(n, seed)
                args = _args(([1.5, 1.0], x_np, y_np), dev, grad=1)
                got, plain, ref, ek, ep = _accuracy(logml, args[torch.float32], args[torch.float64])
                errs_k.append(ek)
                errs_p.append(ep)
                if seed == 0:
                    bench = (got, ref, args)
            got, ref, args = bench
            with torch.no_grad():  # the kernel path's loop length on the bench's data, from the loop itself
                th, x, y = args[torch.float32]
                k = gk.covariance_matrix(gk.se_kernel(th[0] ** 2, th[1]), x, 1e-5)[None]
                loops = int((gl._newton_loop(0.5 * (k + k.mT), y, lik._derivs(), 50, 1e-4).iterations
                             if method == "laplace" else ge.gp_ep_state(k, y, lik).iterations)[0])
            for key, v in watch.counts().items():
                launches[key] += v
            ms = f"{_wall_ms(lambda: _vg(logml, *args[torch.float32]), reps=3):.1f} ms, " if times else ""
            ek, ep = _case_error(errs_k), _case_error(errs_p)
            ok = _within_rule(ek, ep)
            if not ok:
                failed.append(f"n={n} {method}")
            lines.append(f"n={n} {method}: {ms}{loops} {'Newton steps' if method == 'laplace' else 'sweeps'}"
                         f" (kernel path), logML {got[0]:.6f} (f64 {ref[0]:.6f}), normalized error over {seeds} "
                         f"seeds kernel {ek:.2e} plain f32 {ep:.2e} ({'within' if ok else 'ABOVE'} 2x + 1e-6; "
                         f"the bench's data alone {errs_k[0].norm():.2e} and {errs_p[0].norm():.2e})")
        lines[-1] += f", B's Cholesky route {gk._cholesky_route(n)[0]}"
    check = watch.check("14b")
    chol = ("; the Cholesky of B, device ms in turns: " + "; ".join(_chol_turns(n, torch.float32, dev) for n in sizes)
            if times else "")
    log(f"[14b latent-GP logML+grad] logit, f32, theta [1.5, 1.0], B = 1, data of seeds 0-{seeds - 1} of "
        f"_class_data: " + "; ".join(lines) + f"; {check}{chol} | {smi}")
    if failed:
        raise AssertionError(f"14b: the kernel path's normalized error is above twice the plain f32 path's plus "
                             f"1e-6 at {', '.join(failed)}")
    return launches


def _phase14_sgpr(smi, watch, dev, n=SGPR_N, m=SGPR_M, opt_n=16384, opt_m=128, opt_steps=50, times=False):
    """14c: the SGPR bound + gradient at bench_sgpr's width, the SE call that
    makes K_uf, and optimize_sparse_gp against the same on CPU tensors."""
    from bayesianinference_tpu_torch.engines.sparse_gp import define_sparse_gaussian_process, optimize_sparse_gp
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.ops.sgpr import sgpr_bound

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(n, SGPR_D)).astype(np.float32)
    y_np = (np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    z_np = x_np[:: n // m][:m]

    def bound(th, x, y, z):
        return sgpr_bound(gk.se_kernel(torch.exp(th[0]), torch.exp(th[1])), x, y, z, torch.exp(th[2]))

    args = _args(([0.0, 0.0, -2.0], x_np, y_np, z_np), dev, grad=1)
    watch.zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _vg(bound, *args[torch.float32])
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    got, plain, ref, ek, ep = _accuracy(bound, args[torch.float32], args[torch.float64])
    gate = _accuracy_gate("14c SGPR", [ek], [ep])
    launches = watch.counts()
    # 50 Adam steps at n = 16384, m = 128 (f64) on the card against the same on CPU tensors
    rng = np.random.default_rng(1)
    xo = rng.normal(size=(opt_n, SGPR_D))
    yo = np.sin(xo[:, 0]) + 0.1 * rng.normal(size=opt_n)
    traces = []
    for d in (dev, torch.device("cpu")):
        problem = define_sparse_gaussian_process(
            torch.as_tensor(xo, device=d), torch.as_tensor(yo, device=d),
            lambda th: gk.se_kernel(variance=th[0], lengthscale=th[1]),
            [("v", 0.05, 20.0), ("l", 0.05, 20.0), ("s2", 1e-3, 2.0)], nugget_builder=lambda th: th[2],
            inducing=opt_m, prior_distribution=["scale"] * 3, validate=False)
        t0 = time.perf_counter()
        opt = optimize_sparse_gp(problem, steps=opt_steps, learning_rate=0.03)
        traces.append((opt.bound_trace.cpu(), opt.theta.cpu(), time.perf_counter() - t0))
    launches = watch.counts()
    trace_rel = _rel(traces[0][0], traces[1][0])
    if not (trace_rel <= 1e-6 and float(traces[0][0][-1]) > float(traces[0][0][0])):
        raise AssertionError(f"14c: optimize_sparse_gp trace on the card vs CPU tensors rel diff {trace_rel:.3e}, "
                             f"first {float(traces[0][0][0])} last {float(traces[0][0][-1])}")
    timed = ""
    if times:
        ms = _wall_ms(lambda: _vg(bound, *args[torch.float32]), reps=3)
        x32, z32 = args[torch.float32][1], args[torch.float32][3]
        one = torch.ones(1, dtype=torch.float32, device=dev)
        se_ms, _ = _time_ms(lambda: gk.se_covariance_cuda(z32[None], x32[None], one), reps=5, groups=3, per_group=5)
        se_plain_ms, _ = _time_ms(lambda: gk.se_covariance_plain(z32[None], x32[None], one), reps=3, groups=3,
                                  per_group=3)
        se_bound, se_by = _se_bound(z32[None], x32[None], one, None, None)
        timed = (f"{ms:.1f} ms per value-and-grad; the SE call making K_uf [{m}, {n}]: {se_ms:.4f} ms (plain "
                 f"{se_plain_ms:.4f}, bound {se_bound:.4f} by {se_by}); ")
    log(f"[14c SGPR] n={n} m={m} d={SGPR_D} f32, z = x[::n//m][:m], theta [0, 0, -2] (numpy's generator, not "
        f"JAX's): bound {got[0]:.6f} (f64 {ref[0]:.6f}), value+grad {gate}; peak device memory of the call "
        f"{peak:.0f} MiB above what was held; {timed}optimize_sparse_gp n={opt_n} m={opt_m} f64, {opt_steps} Adam steps: bound "
        f"{float(traces[0][0][0]):.4f} -> {float(traces[0][0][-1]):.4f}, trace vs CPU tensors rel diff "
        f"{trace_rel:.2e}, {traces[0][2]:.2f} s on the card ({traces[1][2]:.2f} s on the host); launches {launches}; "
        f"{watch.check('14c')} | {smi}")
    return launches


def _tp_problem(x, y):
    from bayesianinference_tpu_torch.engines.t_process import define_t_process
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    return define_t_process(x, y, lambda th: se_kernel(th[0] ** 2, th[1]),
                            [("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)], nu=4.0,
                            nugget_builder=lambda th: th[2] ** 2, prior_distribution=["scale"] * 3, validate=False)


def _phase14_tp(smi, watch, dev, starts):
    """14d: the Student-t process on phase 4's data: logML and gradient
    against the plain path, the Laplace fit against CPU tensors."""
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy
    from bayesianinference_tpu_torch.models.problem import random_domain_points

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(SLICE_N, SLICE_D))
    y_np = np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=SLICE_N)
    x, y = problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64)
    problem, cpu_problem = _tp_problem(x, y), _tp_problem(x.cpu(), y.cpu())
    watch.zero()
    thetas = random_domain_points(torch.Generator().manual_seed(2), cpu_problem.lower, cpu_problem.upper, 16,
                                  scale=5.0)
    got_v, got_g = _problem_value_and_grad(problem, thetas.to(dev))
    want_v, want_g = _problem_value_and_grad(cpu_problem, thetas)
    rel_v = _rel(got_v.cpu(), want_v)
    rel_g = ((got_g.cpu() - want_g).abs().max() / want_g.abs().max()).item()
    if not (rel_v <= 1e-8 and rel_g <= 1e-8):
        raise AssertionError(f"14d: TP logML kernel vs plain rel diff {rel_v:.3e}, gradient {rel_g:.3e}")
    st = random_domain_points(torch.Generator().manual_seed(0), cpu_problem.lower, cpu_problem.upper, starts,
                              scale=5.0)
    t0 = time.perf_counter()
    fit = laplace_posterior_fit(problem=problem, initial_guess=st.to(dev))
    wall = time.perf_counter() - t0
    ref = laplace_posterior_fit(problem=cpu_problem, initial_guess=st)
    launches = watch.counts()
    mode = fit.mean.cpu()
    errs = {"mode": ((mode - ref.mean).abs() / ref.mean.abs()).max().item(),
            "logZ": abs(float(fit.log_evidence) - float(ref.log_evidence)) / abs(float(ref.log_evidence))}
    if not all(v <= 1e-6 for v in errs.values()):
        raise AssertionError(f"14d: TP Laplace fit on the card vs on CPU tensors, relative errors {errs}")
    log(f"[14d Student-t process] phase 4's data (n={SLICE_N} d={SLICE_D} f64), nu = 4: logML and gradient at 16 "
        f"points (B = 16) vs CPU tensors rel diff {rel_v:.2e} and {rel_g:.2e}; Laplace fit ({starts} starts) "
        f"{wall:.2f} s, mode {[round(v, 6) for v in mode.tolist()]}, logZ {float(fit.log_evidence):.6f}, vs CPU "
        f"tensors rel err {', '.join(f'{a} {b:.2e}' for a, b in errs.items())}; launches {launches}; "
        f"{watch.check('14d')} | {smi}")
    return launches


def _phase14_mogp(smi, watch, dev, n=MOGP_N, t_out=MOGP_T, times=False):
    """14e: the multi-output GP at bench_mogp's width: the dense logML and
    its gradient through both kernels against the plain path, and against
    the Kronecker path."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.ops import mogp as mo

    rng = np.random.default_rng(2)
    x_np = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0).astype(np.float32)
    y_np = rng.normal(size=(t_out, n)).reshape(-1).astype(np.float32)
    a_np = rng.normal(size=(t_out, 2)).astype(np.float32)

    def logml(var, ls, a, noise, x, y, jitter=1e-6):
        b = mo.coregional_matrix(a, torch.full((t_out,), 0.1, dtype=a.dtype, device=a.device))
        return mo.mogp_log_marginal_likelihood(gk.se_kernel(var, ls), b, x, y, noise.expand(t_out), jitter=jitter)

    args = _args((1.5, 0.9, a_np, [0.05], x_np, y_np), dev, grad=4)
    watch.zero()
    got, plain, ref, ek, ep = _accuracy(logml, args[torch.float32], args[torch.float64])
    gate = _accuracy_gate("14e MOGP", [ek], [ep])
    # the dense path (kernels, f64) against the Kronecker identity, both without jitter (the two paths place
    # a jitter differently)
    v64, l64, a64, s64, x64, y64 = args[torch.float64]
    b64 = mo.coregional_matrix(a64, torch.full((t_out,), 0.1, dtype=torch.float64, device=dev))
    with torch.no_grad():
        dense = float(logml(v64, l64, a64, s64, x64, y64, jitter=0.0))
        kron = float(mo.mogp_log_marginal_kronecker(gk.se_kernel(v64, l64), b64, x64, y64.reshape(t_out, n).mT,
                                                    s64[0], jitter=0.0))
    launches = watch.counts()
    timed = ""
    if times:
        timed = (f"{_wall_ms(lambda: _vg(logml, *args[torch.float32]), reps=3):.1f} ms per value-and-grad; the "
                 f"Cholesky of the covariance, device ms in turns: {_chol_turns(n * t_out, torch.float32, dev)}; ")
    if not abs(dense - kron) <= 1e-8 * abs(kron):
        raise AssertionError(f"14e: dense logML {dense} vs Kronecker {kron}")
    log(f"[14e MOGP] n={n} T={t_out} (nT={n * t_out}) f32 (benchmarks/latent_gp.py::bench_mogp's data), gradient in "
        f"(variance, lengthscale, a, noise): logML {got[0]:.4f} (f64 {ref[0]:.4f}), {gate}; {timed}dense (kernels, "
        f"f64, no jitter) {dense:.6f} vs Kronecker {kron:.6f}; launches {launches}; {watch.check('14e')} | {smi}")
    return launches


def _phase14_ess(smi, watch, dev, problem, cpu_problem, theta, chains, burn_in, samples, thin):
    """14f: latents by elliptical slice sampling at 14a's problem and
    Laplace mode: the card against CPU tensors on the same draws, and the
    latent means against the Laplace latent moments."""
    from bayesianinference_tpu_torch.engines.gp_classify import GPLatentDraws, gp_latent_draws, sample_gp_latents
    from bayesianinference_tpu_torch.ops.ess import ESSDraws

    model = problem.metadata["gp_classifier"]
    n = model.x.shape[0]
    updates = burn_in + samples * thin
    draws = gp_latent_draws(torch.Generator().manual_seed(0), chains, n, updates, dtype=torch.float64)
    on_card = GPLatentDraws(draws.init.to(dev), ESSDraws(*(t.to(dev) for t in draws.updates)))
    watch.zero()
    t0 = time.perf_counter()
    out = sample_gp_latents(None, problem, theta.to(dev), samples, num_chains=chains, burn_in=burn_in, thin=thin,
                            draws=on_card)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = watch.counts()
    ref = sample_gp_latents(None, cpu_problem, theta.cpu(), samples, num_chains=chains, burn_in=burn_in, thin=thin,
                            draws=draws)
    with _plain_ops():  # the same run on the card through cuSOLVER's factor: no hand-written kernel
        witness = sample_gp_latents(None, problem, theta.to(dev), samples, num_chains=chains, burn_in=burn_in,
                                    thin=thin, draws=on_card)

    def rel(a):
        return ((a.draws.cpu() - ref.draws).abs().max() / ref.draws.abs().max()).item()

    # the draws are linear in the prior's factor (nu = L z), and two correct factors of this K (jitter 1e-6,
    # condition number near 1e7) differ by about its condition number times eps: the draws are held to
    # 1e-10 or ten times the difference that cuSOLVER's factor makes on the card, whichever is larger, and
    # every shrink loop must have taken the same steps
    diff, spread = rel(out), rel(witness)
    if not (diff <= max(1e-10, 10.0 * spread) and torch.equal(out.evals.cpu(), ref.evals)):
        raise AssertionError(f"14f: ESS draws on the card vs CPU tensors rel diff {diff:.3e} (through cuSOLVER's "
                             f"factor {spread:.3e}); shrink steps equal {torch.equal(out.evals.cpu(), ref.evals)}")
    # ESS's latent means against the Laplace latent moments, per point over the
    # Monte Carlo standard error of the mean (from the chains' own means)
    mu, var = model.latent_moments(theta.to(dev), model.x)
    chain_means = out.draws.mean(dim=1)  # [C, n]
    z = ((chain_means.mean(dim=0) - mu) / (chain_means.std(dim=0) / math.sqrt(chains))).cpu()
    sd = torch.sqrt(var)
    near = (sd < sd.median()).cpu()  # the data-rich half, where the latent posterior is closest to Gaussian
    frac = float((z[near].abs() <= 3.0).double().mean())
    if not (bool(out.moved.min() == updates) and frac >= 0.95):
        raise AssertionError(f"14f: moves {out.moved.tolist()} of {updates}; {frac:.3f} of the near-Gaussian points "
                             f"within 3 MC standard errors of the Laplace mean")
    log(f"[14f ESS latents] 14a's problem at its Laplace mode, {chains} chains, {burn_in} burn-in + {samples} x "
        f"{thin} updates: {wall:.2f} s on the card; draws vs CPU tensors (the same draws) rel diff {diff:.2e} "
        f"(through cuSOLVER's factor on the card {spread:.2e}), the same shrink steps; "
        f"{float(out.evals.double().mean()) / updates:.2f} likelihood evaluations (shrink steps) per update; "
        f"latent means vs the Laplace latent moments: {frac:.3f} of the "
        f"{int(near.sum())} near-Gaussian points within 3 MC standard errors (median |z| "
        f"{float(z[near].abs().median()):.2f}, all points {float((z.abs() <= 3).double().mean()):.3f}); launches "
        f"{launches}; {watch.check('14f')} | {smi}")
    return launches


def phase_latent_gp(smi: str, dev="cuda", pool=100, k=50, steps=20, starts=4, min_iterations=20,
                    bridge_sizes=BRIDGE_NS, sgpr_n=SGPR_N, sgpr_m=SGPR_M, mogp_n=MOGP_N, ess=(16, 200, 200, 2)):
    """Phase 14: the slice's engines on the card (module docstring).  The
    keyword arguments shrink it for a rehearsal; the defaults are the run."""
    dev = torch.device(dev)
    t0 = time.perf_counter()
    total = {"se_covariance": 0, "cholesky": 0}
    with _KernelWatch() as watch:
        def add(launches):
            for key in total:
                total[key] += launches[key]

        launches, problem, cpu_problem, mode = _phase14_classifier(smi, watch, dev, pool, k, steps, starts,
                                                                   min_iterations)
        add(launches)
        log(f"[14a check] {watch.check('14a')}")
        seconds = [f"14a {time.perf_counter() - t0:.1f}"]
        for name, run in (("14b", lambda: _phase14_bridges(smi, watch, dev, bridge_sizes)),
                          ("14c", lambda: _phase14_sgpr(smi, watch, dev, n=sgpr_n, m=sgpr_m)),
                          ("14d", lambda: _phase14_tp(smi, watch, dev, starts)),
                          ("14e", lambda: _phase14_mogp(smi, watch, dev, n=mogp_n)),
                          ("14f", lambda: _phase14_ess(smi, watch, dev, problem, cpu_problem, mode, *ess))):
            t = time.perf_counter()
            add(run())
            seconds.append(f"{name} {time.perf_counter() - t:.1f}")
        log(f"[14 latent GP] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches {total}; "
            f"{watch.check('14')}")
    return total


# ---------------------------------------------------------------------------
# phase 15: the stochastic variational GP, Bayesian optimization, the
# generative front end and Laplace-marginalized latents
# ---------------------------------------------------------------------------

SVGP_N, SVGP_M, SVGP_B = 262144, 256, 8192  # benchmarks/latent_gp.py::bench_svgp_step
SVGP_SEEDS = range(1, 9)  # 15a's data draws; seed 1 is the bench's
SVGP_FIT_STEPS = 300  # the JAX default is 500, cut to fit the time limit
SVGP_MARGIN = 0.06  # 15b's predictive gate (PERF.md: a CPU rehearsal at the same width)
BRANIN_DRAWS = Path(__file__).resolve().parent / "tests" / "data" / "bo_branin_jax_draws.npz"


def _rel_max(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


def _svgp_bench_values(seed: int, n=SVGP_N, m=SVGP_M, batch=SVGP_B):
    """bench_svgp_step's data (x, y uniform labels and z uniform on [-3, 3]^2
    from the numpy generator of ``seed``), its first minibatch, and a
    variational state away from the prior (at the bench's prior state,
    m = 0 and L = I, the bound does not depend on z or theta, and their
    gradients are rounding): theta = [2, 1], m ~ N(0, 0.5^2),
    L = 0.5 I + 0.05 N(0, 1) below the diagonal."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, size=(n, 2)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    z = rng.uniform(-3, 3, size=(m, 2)).astype(np.float32)
    mv = (0.5 * rng.normal(size=m)).astype(np.float32)
    raw = (np.eye(m) * np.log(np.expm1(0.5)) + 0.05 * np.tril(rng.normal(size=(m, m)), -1)).astype(np.float32)
    return [np.array([2.0, 1.0], np.float32), z, mv, raw, x[:batch], y[:batch]]


def _svgp_elbo(n_total):
    """The bound of bench_svgp_step at one K_zz jitter for both dtypes:
    float32's default, 1e-4 (``svgp.default_jitter``), since float64's
    default of 1e-6 would make the f64 reference another function."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.ops import gp_laplace as gl
    from bayesianinference_tpu_torch.ops import svgp

    lik = gl.bernoulli_logit_likelihood()
    jitter = svgp.default_jitter(torch.float32)

    def elbo(th, z, m, raw, x, y):
        return svgp.svgp_elbo(gk.se_kernel(th[0], th[1]), x, y, z, lik, svgp.SVGPVariational(m, raw), jitter=jitter,
                              data_scale=n_total / x.shape[0])

    return elbo


_SVGP_QUANTITIES = ("value", "theta", "z", "m", "raw")


def _per_quantity(vec, sizes):
    return dict(zip(_SVGP_QUANTITIES, torch.split(vec, sizes)))


def _phase15_elbo(smi, watch, dev, n=SVGP_N, m=SVGP_M, batch=SVGP_B, seeds=SVGP_SEEDS, times=False):
    """15a: the SVGP ELBO and its gradient in (theta, z, m, raw) at
    bench_svgp_step's width, f32 through the kernels and plain against
    plain f64, each quantity gated on its own over the seeds' data; with
    ``times`` (``chip_profile.py``), a step's wall and device time."""
    elbo = _svgp_elbo(n)
    sizes = [1, 2, 2 * m, m, m * m]
    errs = {q: ([], []) for q in _SVGP_QUANTITIES}
    watch.zero()
    for seed in seeds:
        args = _args(_svgp_bench_values(seed, n, m, batch), dev, grad=4)
        got, plain, ref, _, _ = _accuracy(elbo, args[torch.float32], args[torch.float64])
        got, plain, ref = (_per_quantity(v, sizes) for v in (got, plain, ref))
        for q in _SVGP_QUANTITIES:
            scale = float(ref[q].norm()) or 1e-30
            errs[q][0].append(float((got[q] - ref[q]).norm()) / scale)
            errs[q][1].append(float((plain[q] - ref[q]).norm()) / scale)
        if seed == seeds[0]:
            bench = (got["value"].item(), ref["value"].item(), args)
    launches = watch.counts()
    if not (launches["se_covariance"] > 0 and launches["cholesky"] > 0):
        raise AssertionError(f"15a: launches {launches}")
    value, value64, args = bench
    step = lambda: _vg(elbo, *args[torch.float32])  # noqa: E731
    timed = ""
    if times:
        wall = _wall_ms(step, reps=3)
        device_ms, kernels = _profile_call(step, cpu=False, warm=False)
        timed = (f"wall {wall:.2f} ms (median of 3), device {device_ms:.3f} ms, {kernels} CUDA kernels, busy share "
                 f"{device_ms / wall:.3f}, ")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    lines, failed = [], []
    for q in _SVGP_QUANTITIES:
        ek = math.sqrt(float(np.mean(np.square(errs[q][0]))))
        ep = math.sqrt(float(np.mean(np.square(errs[q][1]))))
        ok = _within_rule(ek, ep)
        failed += [] if ok else [q]
        lines.append(f"{q} {ek:.2e} (plain f32 {ep:.2e}, {'within' if ok else 'ABOVE'})")
    log(f"[15a SVGP ELBO+grad] n={n} M={m} batch={batch} d=2 f32, Bernoulli logit, se_kernel(2, 1), data of "
        f"bench_svgp_step's generator at seeds {seeds[0]}-{seeds[-1]}: ELBO {value:.4f} (f64 {value64:.4f}); "
        f"normalized error, root mean square over {len(seeds)} seeds, kernel path against plain f32 (rule 2x + "
        f"1e-6): {'; '.join(lines)}; per step: {timed}peak device memory {peak:.0f} MiB above what "
        f"was held; launches {launches}; {watch.check('15a')} | {smi}")
    if failed:
        raise AssertionError(f"15a: the kernel path's normalized error is above twice the plain f32 path's plus "
                             f"1e-6 for {', '.join(failed)}")
    return launches


_AMP_LS = [("amp", 0.05, 10.0), ("ls", 0.1, 5.0)]  # tests/test_svgp.py


def _amp_ls_kernel(th):
    from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

    return se_kernel(th[0] ** 2, th[1])


def _fit_fields(fit, names):
    return torch.cat([getattr(fit, k).detach().double().reshape(-1).cpu() for k in names])


def _three_class_data(n, seed=7):
    """tests/test_svgp.py:231's three angular sectors with 5 % label noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, size=(n, 2))
    y = np.digitize(np.arctan2(x[:, 1], x[:, 0]), [-np.pi / 3, np.pi / 3])
    flip = rng.uniform(size=n) < 0.05
    y[flip] = rng.integers(0, 3, size=int(flip.sum()))
    return x, y


def _hetero_data(n, seed=10):
    """tests/test_svgp.py:329's noise profile, rising left to right."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
    sd = 0.05 + 0.5 * (1 + np.tanh(x[:, 0]))
    return x, np.sin(1.2 * x[:, 0]) + sd * rng.normal(size=n)


FIT_WITNESS_FACTOR = 10.0  # 15b-c's gate over its witness (PERF.md: the readings of sound runs and of the control)


class _f32_factor:
    """15b-c's control: the SVGP modules factor K_zz in float32 (the
    ``cholesky`` op on K_zz rounded to float32, the factor cast back), a
    lower-precision float64 path that the gate must reject."""

    def __enter__(self):
        from bayesianinference_tpu_torch.ops import svgp

        self.svgp, self.orig = svgp, svgp.cholesky
        self.svgp.cholesky = lambda k: self.orig(k.float()).to(k.dtype)
        return self

    def __exit__(self, *exc):
        self.svgp.cholesky = self.orig
        return False


def _card_against_cpu(what, run, dev, watch):
    """``run(device, jitter)`` -> (fit, compared vector), all on the same
    draws: through the kernels on the card, through plain PyTorch on the
    card (cuSOLVER's factor, printed) and on CPU tensors.  These Adam runs
    carry K_zz's condition number (a 1e-6 relative jitter) into every step,
    so the gate is their own sensitivity: the card's run within
    ``FIT_WITNESS_FACTOR`` times the difference that a jitter 1e-10 larger
    (an eps-sized change of K_zz) makes to the CPU run, or 1e-6 of the
    largest entry, whichever is larger.  A control, the card's run with
    K_zz factored in float32 (``_f32_factor``), must fail that gate (NaN,
    where the float32 factor fails, fails it).
    Returns (card fit, the card run's launches, card difference,
    cuSOLVER's, the witness's, the control's, card seconds)."""
    watch.zero()
    t0 = time.perf_counter()
    fit, got = run(dev, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = watch.counts()
    with _plain_ops():
        _, plain = run(dev, None)
    _, want = run(torch.device("cpu"), None)
    _, nudged = run(torch.device("cpu"), 1e-6 * (1.0 + 1e-10))
    with _f32_factor():
        _, control = run(dev, None)
    diff, diff_plain, witness = _rel_max(got, want), _rel_max(plain, want), _rel_max(nudged, want)
    diff_control, gate = _rel_max(control, want), max(1e-6, FIT_WITNESS_FACTOR * witness)
    if not diff <= gate:
        raise AssertionError(f"{what}: the card against CPU tensors differ by {diff:.3e} of the largest entry, "
                             f"an eps-sized change of K_zz by {witness:.3e}")
    if diff_control <= gate:  # a NaN control (the f32 factor failed) is rejected too
        raise AssertionError(f"{what}: the gate {gate:.3e} does not reject K_zz factored in float32 "
                             f"({diff_control:.3e})")
    return fit, launches, diff, diff_plain, witness, diff_control, seconds


def _phase15_fits(smi, watch, dev, n=SVGP_N, m=SVGP_M, batch=SVGP_B, steps=SVGP_FIT_STEPS, small_n=16384,
                  small_m=64, small_batch=1024, small_steps=100, class_n=8192):
    """15b and 15c: fit_svgp at the bench's width, float32, with its
    full-data bound and its predictions against the truth; the f64 fits
    (binary, multiclass, heteroscedastic) against the same on CPU tensors
    with the same draws."""
    from bayesianinference_tpu_torch.engines import svgp as sv

    x_np, y_np = _class_data(n)
    x, y = (torch.as_tensor(a, device=dev) for a in (x_np, y_np))
    watch.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = sv.fit_svgp(x, y, _amp_ls_kernel, _AMP_LS, inducing=m, minibatch=batch, steps=steps,
                      generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = watch.counts()
    xq = torch.linspace(-3, 3, 41, device=dev)[:, None]
    p, _, _ = sv.predict_from_svgp(fit, xq)
    truth = torch.sigmoid(3.0 * torch.sin(1.5 * xq[:, 0]))
    worst = float((p - truth).abs().max())
    trace = fit.elbo_trace
    if not (launches["se_covariance"] > 0 and launches["cholesky"] > 0 and bool(torch.isfinite(fit.elbo))
            and worst <= SVGP_MARGIN):
        raise AssertionError(f"15b: launches {launches}, full ELBO {float(fit.elbo)}, predictions off the truth "
                             f"by up to {worst:.3f} (margin {SVGP_MARGIN})")
    log(f"[15b fit_svgp] n={n} (benchmarks/latent_gp.py::_class_data), f32, {m} inducing by farthest, minibatch "
        f"{batch}, {steps} Adam steps (the JAX default of 500 cut to fit the time limit): {seconds:.1f} s, "
        f"{seconds / steps * 1e3:.1f} ms per step with the inducing selection; theta {fit.theta.tolist()}; "
        f"minibatch ELBO {float(trace[:10].mean()):.1f} (first 10) -> {float(trace[-10:].mean()):.1f} (last 10); "
        f"full-data ELBO {float(fit.elbo):.2f} (K_zx [{m}, {n}]); predict_from_svgp at 41 points of [-3, 3] "
        f"against sigmoid(3 sin 1.5x): max |error| {worst:.4f} (margin {SVGP_MARGIN}); launches {launches}; "
        f"{watch.check('15b')} | {smi}")
    total = dict(launches)

    def add(launches):
        for key, v in launches.items():
            total[key] += v

    rng = np.random.default_rng(3)
    xs = rng.uniform(-3, 3, size=(small_n, 1))
    ys = (rng.uniform(size=small_n) < 1 / (1 + np.exp(-3.0 * np.sin(1.5 * xs[:, 0])))).astype(float)
    draws = sv.svgp_draws(torch.Generator().manual_seed(1), small_steps, small_n, small_batch)

    def binary(d, jitter):
        f = sv.fit_svgp(torch.as_tensor(xs, device=d), torch.as_tensor(ys, device=d), _amp_ls_kernel, _AMP_LS,
                        inducing=small_m, minibatch=small_batch, steps=small_steps, draws=draws, jitter=jitter)
        return f, torch.cat([_fit_fields(f, ("elbo_trace", "theta", "z")), f.elbo.double().reshape(1).cpu()])

    _, launches_b, diff_b, plain_b, wit_b, ctl_b, sec_b = _card_against_cpu("15b f64 fit", binary, dev, watch)
    add(launches_b)
    log(f"[15b f64 fit] n={small_n} M={small_m} minibatch {small_batch}, {small_steps} steps, f64: the card "
        f"against CPU tensors on the same draws, trace, theta, z and full ELBO within {diff_b:.2e} of the largest "
        f"entry (gate max(1e-6, {FIT_WITNESS_FACTOR:g} x {wit_b:.2e}, the CPU run's change under an eps-sized "
        f"change of K_zz); cuSOLVER's run {plain_b:.2e}; control, K_zz factored in f32, {ctl_b:.2e}, rejected); "
        f"{sec_b:.2f} s on the card | {smi}")

    xc, yc = _three_class_data(class_n)
    mc = sv.svgp_draws(torch.Generator().manual_seed(2), small_steps, class_n, small_batch, num_mc=8, num_classes=3,
                       dtype=torch.float64)

    def multiclass(d, jitter):
        f = sv.fit_svgp_multiclass(torch.as_tensor(xc, device=d), torch.as_tensor(yc, device=d), _amp_ls_kernel,
                                   _AMP_LS, inducing=small_m, minibatch=small_batch, steps=small_steps, draws=mc,
                                   jitter=jitter)
        return f, torch.cat([_fit_fields(f, ("elbo_trace", "theta", "m")), f.elbo.double().reshape(1).cpu()])

    fit_c, launches_c, diff_c, plain_c, wit_c, ctl_c, sec_c = _card_against_cpu("15c multiclass", multiclass, dev,
                                                                                 watch)
    add(launches_c)
    probs, _, _ = sv.predict_from_svgp_multiclass(fit_c, torch.as_tensor(xc, device=dev),
                                                  generator=torch.Generator(device=dev).manual_seed(0))
    acc = float((probs.argmax(dim=-1).cpu().numpy() == yc).mean())
    xh, yh = _hetero_data(class_n)
    hb = (_amp_ls_kernel, lambda th: _amp_ls_kernel(th[2:]))
    hparams = [("amp_f", 0.05, 10.0), ("ls_f", 0.1, 5.0), ("amp_g", 0.05, 5.0), ("ls_g", 0.3, 5.0)]
    hd = sv.svgp_draws(torch.Generator().manual_seed(3), small_steps, class_n, small_batch)

    def hetero(d, jitter):
        f = sv.fit_svgp_heteroscedastic(torch.as_tensor(xh, device=d), torch.as_tensor(yh, device=d), *hb, hparams,
                                        inducing=small_m, minibatch=small_batch, steps=small_steps,
                                        learning_rate=0.03, draws=hd, jitter=jitter)
        return f, torch.cat([_fit_fields(f, ("elbo_trace", "theta", "noise_bias")), f.elbo.double().reshape(1).cpu()])

    fit_h, launches_h, diff_h, plain_h, wit_h, ctl_h, sec_h = _card_against_cpu("15c heteroscedastic", hetero, dev,
                                                                                 watch)
    add(launches_h)
    _, _, noise_sd, _ = sv.predict_from_svgp_heteroscedastic(fit_h, torch.as_tensor(xh, device=dev))
    noise_sd = noise_sd.cpu().numpy()
    corr = float(np.corrcoef(noise_sd, 0.05 + 0.5 * (1 + np.tanh(xh[:, 0])))[0, 1])
    log(f"[15c multiclass and heteroscedastic] n={class_n} M={small_m} minibatch {small_batch}, {small_steps} steps, "
        f"f64, data of tests/test_svgp.py's generators, against CPU tensors on the same draws (gate max(1e-6, "
        f"{FIT_WITNESS_FACTOR:g} x the eps-sized K_zz change's)): C = 3 softmax (8 MC draws per step) {diff_c:.2e} "
        f"(witness {wit_c:.2e}, cuSOLVER's run {plain_c:.2e}, f32-factor control {ctl_c:.2e} rejected), "
        f"{sec_c:.2f} s on the card, training accuracy {acc:.3f}; heteroscedastic {diff_h:.2e} (witness "
        f"{wit_h:.2e}, cuSOLVER's {plain_h:.2e}, control {ctl_h:.2e} rejected), {sec_h:.2f} s, noise sd against "
        f"the true profile corr {corr:.3f}; launches "
        f"{total}; {watch.check('15c')} | {smi}")
    return total


def _branin_torch(x):
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5 / math.pi
    r, s, t = 6.0, 10.0, 1 / (8 * math.pi)
    return a * (x[1] - b * x[0] ** 2 + c * x[0] - r) ** 2 + s * (1 - t) * torch.cos(x[0]) + s


def _camel_torch(x):
    x1, x2 = x[0], x[1]
    return (4.0 - 2.1 * x1**2 + x1**4 / 3.0) * x1**2 + x1 * x2 + (-4.0 + 4.0 * x2**2) * x2**2


def _bo_final_check(state, dev):
    """The final state's masked logML and moments at 16 probe points through
    the kernels, through plain PyTorch in the same dtype, and plain f64:
    (kernel error, plain error) as max |error| / max |f64 value|.  Printed,
    not gated: K carries the condition number of a nugget of 1e-6 or a
    learned one."""
    from bayesianinference_tpu_torch.engines import bayesopt as bo

    span = state.upper - state.lower
    x01 = (state.x - state.lower) / span
    mu, sd = bo._standardized(state.y, state.mask)
    ys = torch.where(state.mask, (state.y - mu) / sd, 0.0)
    probe = torch.rand((16, state.x.shape[1]), generator=torch.Generator().manual_seed(0), dtype=torch.float64)

    def values(dt):
        h = [t.to(dt) for t in (state.log_var, state.log_ell, state.log_nugget)]
        args = (x01.to(dt), ys.to(dt), state.mask)
        with torch.no_grad():
            logml = bo.masked_gp_log_marginal(*args, *h)
            mean, std = bo.masked_gp_moments(*args, probe.to(device=dev, dtype=dt), *h)
        return torch.cat([logml.reshape(1), mean, std]).double().cpu()

    got = values(state.x.dtype)
    with _plain_ops():
        plain, ref = values(state.x.dtype), values(torch.float64)
    return _rel_max(got, ref), _rel_max(plain, ref)


def _bo_step_row(state, draws, cfg) -> str:
    """Wall ms, device ms, CUDA kernels and SE and Cholesky launches of one
    suggestion from ``state``."""
    from bayesianinference_tpu_torch.engines import bayesopt as bo
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    step = lambda: bo.bo_suggest(state, draws, cfg)  # noqa: E731
    wall = _wall_ms(step, reps=3)
    device_ms, kernels = _profile_call(step, cpu=False, warm=False)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    step()
    return (f", per suggestion wall {wall:.1f} ms, device {device_ms:.2f} ms, {kernels} CUDA kernels, "
            f"{gk.se_covariance_cuda.launches - before[0]} SE and {gk.cholesky_cuda.launches - before[1]} Cholesky "
            "launches")


def _phase15_bo(smi, watch, dev, camel_steps=56, times=False):
    """15d: Bayesian optimization through both kernels: Branin's ask/tell run
    on the JAX test's draws, the Six-Hump Camel at the default configuration
    (f32), the same in f64 on the card and on CPU tensors; with ``times``
    (``chip_profile.py``), one suggestion profiled at each final state."""
    from bayesianinference_tpu_torch.engines import bayesopt as bo

    total = {"se_covariance": 0, "cholesky": 0}
    lines = []
    # Branin, exactly tests/test_bayesopt.py::test_ask_tell_agrees_and_improves on its own random numbers
    with np.load(BRANIN_DRAWS) as f:
        stored = {k: torch.as_tensor(v) for k, v in f.items()}
    lower, upper = torch.tensor([-5.0, 0.0], device=dev), torch.tensor([10.0, 15.0], device=dev)
    cfg = bo.BayesOptConfig(num_candidates=256, hyper_steps=6)
    watch.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, x_init = bo.bo_init(lower, upper, 26, num_init=6,
                               draws=bo.DesignDraws(stored["design_jitter"], stored["design_order"]))
    for x in x_init:
        state = bo.bo_observe(state, x, _branin_torch(x))
    step_draws = [bo.BODraws(*(stored[k][i] for k in bo.BODraws._fields)) for i in range(20)]
    for dr in step_draws:
        state, x_next = bo.bo_suggest(state, dr, cfg)
        if not bool(((x_next >= lower - 1e-6) & (x_next <= upper + 1e-6)).all()):
            raise AssertionError(f"15d Branin: suggestion {x_next.tolist()} outside the box")
        state = bo.bo_observe(state, x_next, _branin_torch(x_next))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = watch.counts()
    _, y_best = state.best()
    errs = _bo_final_check(state, dev)
    row = _bo_step_row(state, step_draws[-1], cfg) if times else ""
    if not (float(y_best) < 0.3979 + 0.7 and state.n == 26 and counts["se_covariance"] > 0 and counts["cholesky"] > 0):
        raise AssertionError(f"15d Branin: y_best {float(y_best)}, n {state.n}, launches {counts}")
    lines.append(f"Branin ask/tell (6 + 20, 256 candidates, 6 hyper steps, f32, the JAX test's draws from "
                 f"{BRANIN_DRAWS.name}): y_best {float(y_best):.4f} (gate < 1.0979), {wall:.2f} s{row}; final "
                 f"logML+moments error kernel {errs[0]:.1e} plain f32 {errs[1]:.1e}")
    for key in total:
        total[key] += counts[key]
    # Six-Hump Camel at the default configuration, nugget pinned at 1e-6
    cfg = bo.BayesOptConfig(nugget=1e-6)
    box = (torch.tensor([-2.0, -1.0]), torch.tensor([2.0, 1.0]))
    runs = {}
    for tag, dt, d in (("f32", torch.float32, dev), ("f64", torch.float64, dev), ("f64 cpu", torch.float64, "cpu")):
        g = torch.Generator().manual_seed(0)
        draws = (bo.design_draws(g, 8, 2, dt), bo.bo_draws(g, 2, cfg, steps=camel_steps, dtype=dt))
        watch.zero()
        t0 = time.perf_counter()
        res = bo.bayes_optimize(_camel_torch, *(b.to(device=d, dtype=dt) for b in box), num_steps=camel_steps,
                                num_init=8, config=cfg, dtype=dt, draws=draws)
        if d != "cpu":
            torch.cuda.synchronize()
        runs[tag] = (res, time.perf_counter() - t0, watch.counts())
    for tag in ("f32", "f64"):
        res, seconds, counts = runs[tag]
        errs = _bo_final_check(res.state, dev)
        row = _bo_step_row(res.state, bo.bo_draws(torch.Generator().manual_seed(1), 2, cfg, dtype=res.state.x.dtype),
                           cfg) if times else ""
        if not (float(res.y_best) < -1.0316 + 0.05 and counts["se_covariance"] > 0 and counts["cholesky"] > 0):
            raise AssertionError(f"15d Camel {tag}: y_best {float(res.y_best)}, launches {counts}")
        for key in total:
            total[key] += counts[key]
        lines.append(f"Camel {tag} (8 + {camel_steps}, capacity {8 + camel_steps}, 512 candidates, 8 hyper and 12 "
                     f"refine steps): y_best {float(res.y_best):.4f} (gate < -0.9816), {seconds:.2f} s"
                     f"{row.replace('per suggestion', 'per suggestion at the final state')}; launches over the run "
                     f"{counts}; final logML+moments error kernel {errs[0]:.1e} plain {errs[1]:.1e}")
    card, cpu = runs["f64"][0], runs["f64 cpu"][0]
    hist = max(_rel_max(card.x_history, cpu.x_history), _rel_max(card.y_history, cpu.y_history))
    if not hist <= 1e-8:
        raise AssertionError(f"15d Camel f64: the card's history against CPU tensors' on the same draws {hist:.3e}")
    lines.append(f"Camel f64 card against CPU tensors on the same draws: history within {hist:.1e} of the largest "
                 f"entry (gate 1e-8), {runs['f64 cpu'][1]:.2f} s on the host")
    log(f"[15d Bayesian optimization] {'; '.join(lines)}; launches {total}; {watch.check('15d')} | {smi}")
    return total


def _logistic_data(n: int, seed: int = 0):
    """tests/test_torch_generative.py::logistic_data: four standardized
    normal covariates, Bernoulli labels of sigmoid(0.5 + x @ [1.5, -2, 0.7, 0])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    x = (x - x.mean(0)) / x.std(0)
    p = 1.0 / (1.0 + np.exp(-(0.5 + x @ np.array([1.5, -2.0, 0.7, 0.0]))))
    return x, (rng.uniform(size=n) < p).astype(float)


def _phase15_models(smi, dev, n=4096, groups=256, batch=64):
    """15e: the generative front end and Laplace-marginalized latents (no
    hand-written kernel runs here)."""
    from bayesianinference_tpu_torch import dists as td
    from bayesianinference_tpu_torch.dists.combinators import ConditionalProduct
    from bayesianinference_tpu_torch.engines import direct_posterior_distribution
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.models import define_inference_problem, generative_model_problem
    from bayesianinference_tpu_torch.models import marginalize_latents

    x_np, y_np = _logistic_data(n)
    x, y = (torch.as_tensor(a, device=dev) for a in (x_np, y_np))
    model = ConditionalProduct([
        ("b0", lambda v: td.Normal(0.0, 10.0)),
        ("w", lambda v: td.Normal(torch.zeros(4, dtype=torch.float64, device=dev), 10.0)),
        ("y", lambda v: td.BernoulliLogits(logits=v["b0"] + v["x"] @ v["w"])),
    ])
    params = [("b0", -50.0, 50.0), ("w", -50.0, 50.0, (4,))]
    t0 = time.perf_counter()
    fit = laplace_posterior_fit(model=model, data={"y": y}, parameters=params, model_inputs={"x": x},
                                generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    problem = generative_model_problem(model, data={"y": y}, parameters=params, inputs={"x": x})
    ref = laplace_posterior_fit(problem=problem, generator=torch.Generator(device=dev).manual_seed(0))
    d_mean = float((fit.mean - ref.mean).abs().max())
    d_logz = abs(float(fit.log_evidence) - float(ref.log_evidence)) / abs(float(ref.log_evidence))
    if not (d_mean <= 1e-8 and d_logz <= 1e-10 and fit.mean.device.type == dev.type):
        raise AssertionError(f"15e model=: mean {d_mean:.3e}, logZ {d_logz:.3e} against problem=")
    # eight schools, collapsed, by direct quadrature against the exact marginal
    y8 = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], device=dev, dtype=torch.float64)
    s8 = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], device=dev, dtype=torch.float64)

    def joint8(theta, z):
        return torch.sum(td.Normal(z, s8).log_prob(y8)) + torch.sum(td.Normal(theta[0], torch.exp(theta[1])).log_prob(z))

    def exact8(theta):
        return torch.sum(td.Normal(theta[0], torch.sqrt(s8**2 + torch.exp(2.0 * theta[1]))).log_prob(y8))

    def schools(loglike, batched):
        return define_inference_problem(
            parameters=[("mu", -15.0, 25.0), ("log_tau", -2.0, 3.5)], log_likelihood=loglike,
            prior_distribution=[td.Uniform(-15.0, 25.0), td.Uniform(-2.0, 3.5)], validate=False,
            batched_likelihood=batched, device=dev, dtype=torch.float64)

    marg8 = marginalize_latents(joint8, latent_dim=8)
    t1 = time.perf_counter()
    post_c = direct_posterior_distribution(problem=schools(marg8.log_density, True), num_points=48)
    torch.cuda.synchronize()
    sec8 = time.perf_counter() - t1
    post_e = direct_posterior_distribution(problem=schools(exact8, False), num_points=48)
    d8 = abs(float(post_c.log_evidence) - float(post_e.log_evidence)) / abs(float(post_e.log_evidence))
    if not d8 <= 1e-6:
        raise AssertionError(f"15e eight schools: collapsed logZ {float(post_c.log_evidence)} against the exact "
                             f"{float(post_e.log_evidence)}")
    # random effects: y_j ~ N(z_j, s_j^2), z_j ~ N(mu, tau^2), j < groups
    rng = np.random.default_rng(5)
    s_re = torch.as_tensor(rng.uniform(0.5, 2.0, size=groups), device=dev)
    y_re = torch.as_tensor(1.0 + 0.8 * rng.normal(size=groups) + s_re.cpu().numpy() * rng.normal(size=groups),
                           device=dev)

    def joint_re(theta, z):
        return (torch.sum(td.Normal(z, s_re).log_prob(y_re))
                + torch.sum(td.Normal(theta[0], torch.exp(theta[1])).log_prob(z)))

    def exact_re(theta):
        return torch.sum(td.Normal(theta[:, :1], torch.sqrt(s_re**2 + torch.exp(2.0 * theta[:, 1:]))).log_prob(y_re),
                         dim=-1)

    thetas = torch.as_tensor(np.stack([rng.uniform(-1.0, 3.0, batch), rng.uniform(-1.5, 1.0, batch)], axis=1),
                             device=dev).requires_grad_(True)
    marg = marginalize_latents(joint_re, latent_dim=groups)
    t2 = time.perf_counter()
    got = marg.log_density(thetas)
    (g_got,) = torch.autograd.grad(got.sum(), thetas)
    torch.cuda.synchronize()
    sec_re = time.perf_counter() - t2
    want = exact_re(thetas)
    (g_want,) = torch.autograd.grad(want.sum(), thetas)
    d_val, d_grad = _rel_max(got.detach(), want.detach()), _rel_max(g_got, g_want)
    if not (d_val <= 1e-8 and d_grad <= 1e-8):
        raise AssertionError(f"15e random effects: value {d_val:.3e}, gradient {d_grad:.3e} against the closed form")
    iters = marg.newton_iterations
    log(f"[15e generative front end and marginalized latents] no hand-written kernel runs here. "
        f"laplace_posterior_fit(model=...) on the logistic model (b0 + 4 weights, BernoulliLogits) at n={n} f64 "
        f"(numpy-seeded covariates; the JAX test's Iris needs scikit-learn): {seconds:.1f} s, against problem= mean "
        f"{d_mean:.1e} (gate 1e-8), logZ {d_logz:.1e} (gate 1e-10), logZ {float(fit.log_evidence):.4f}; eight "
        f"schools collapsed through direct_posterior_distribution (48 x 48, batched likelihood) logZ "
        f"{float(post_c.log_evidence):.6f} against the exact marginal's {float(post_e.log_evidence):.6f} (rel "
        f"{d8:.1e}, gate 1e-6), {sec8:.2f} s; random effects, {groups} groups, at {batch} thetas: log density "
        f"{d_val:.1e} and gradient {d_grad:.1e} of the largest entry against the closed form (gate 1e-8), Newton "
        f"steps per lane {int(iters.min())}-{int(iters.max())} ({marg.newton_loop_steps} host steps for the batch), "
        f"{sec_re:.2f} s for value and gradient | {smi}")


def phase_svgp_bo(smi: str, dev="cuda", **sizes):
    """Phase 15: the stochastic variational GP and Bayesian optimization
    through both kernels, the generative front end and marginalized
    latents (module docstring).  ``sizes`` shrink 15a-e for a rehearsal
    (``elbo``, ``fits``, ``bo``, ``models``: keyword arguments of each
    sub-phase); the defaults are the run."""
    dev = torch.device(dev)
    t0 = time.perf_counter()
    total = {"se_covariance": 0, "cholesky": 0}
    seconds = []
    with _KernelWatch() as watch:
        for name, run in (("15a", lambda: _phase15_elbo(smi, watch, dev, **sizes.get("elbo", {}))),
                          ("15b-c", lambda: _phase15_fits(smi, watch, dev, **sizes.get("fits", {}))),
                          ("15d", lambda: _phase15_bo(smi, watch, dev, **sizes.get("bo", {})))):
            t = time.perf_counter()
            for key, v in run().items():
                total[key] += v
            seconds.append(f"{name} {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        _phase15_models(smi, dev, **sizes.get("models", {}))
        seconds.append(f"15e {time.perf_counter() - t:.1f}")
        if not (total["se_covariance"] > 0 and total["cholesky"] > 0):
            raise AssertionError(f"15: launches {total}")
        log(f"[15 SVGP and BO] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches {total}; "
            f"{watch.check('15')}")
    return total


# ---------------------------------------------------------------------------
# phase 16: ADVI, Pathfinder, bridge sampling, HMC's Pathfinder start and the
# model-comparison results layer
# ---------------------------------------------------------------------------

ADVI_GP_STEPS = 250  # the JAX default is 3000, cut to fit the time limit (the gate is an upper bound)
PATHFINDER_DRAWS = Path(__file__).resolve().parent / "tests" / "data" / "pathfinder_conjugate_jax_draws.npz"
ADVI_CPU_STEPS = 5  # the card-vs-CPU fit: a step on CPU tensors takes about 0.6 s at B = 32, n = 512, f64
# the ARD GP's reference logZ: HMC chains and steps (warmup and samples
# each); at n = 64 on the CPU 50 + 50 steps read within 0.2 of 150 + 150
# (tests/ard_reference_study.py)
ARD_REF_CHAINS, ARD_REF_STEPS = 32, 50
# 16f: draws of the exact posterior (a quantile grid), and three times the
# largest error against the exact LOO elpd that the CPU reads on that grid
# (PSIS-LOO 1.202e-3, WAIC 9.04e-4: tests/loo_gate_study.py)
LOO_DRAWS, LOO_TOL, WAIC_TOL = 4000, 3.7e-3, 2.8e-3


def _normal_model(dev, n_obs=40, seed=1, tau0=3.0, mu0=0.0):
    """tests/test_vi.py's conjugate oracle: y_i ~ N(mu, 1), mu ~ N(mu0, tau0^2);
    (problem, data, posterior mean, posterior sd, exact logZ)."""
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    data = np.random.default_rng(seed).normal(1.2, 1.0, n_obs)
    problem = define_inference_problem(parameters=[("mu", -10.0, 10.0)], likelihood=lambda th: Normal(th[0], 1.0),
                                       data=torch.as_tensor(data, device=dev), prior_distribution=[Normal(mu0, tau0)],
                                       validate=False)
    prec = 1 / tau0**2 + n_obs
    r = data - mu0
    # y ~ N(mu0 1, tau0^2 J + I): determinant and inverse by the rank-one update
    log_z = (-0.5 * n_obs * math.log(2 * math.pi) - 0.5 * math.log(1 + n_obs * tau0**2)
             - 0.5 * (r @ r - tau0**2 * r.sum() ** 2 / (1 + n_obs * tau0**2)))
    return problem, data, (mu0 / tau0**2 + data.sum()) / prec, prec**-0.5, log_z


def _advi_oracle_job(dev: str, steps: int = 3000) -> dict:
    """16a's fits: ADVI at its defaults on the conjugate oracle and fullrank
    on the rho = 0.9 Gaussian; their readings as Python numbers.  No
    hand-written kernel lies on this path, so it runs in a worker process
    of phase 8's pool beside phases 13-15 (it fails if a kernel launched)."""
    from bayesianinference_tpu_torch.engines.vi import advi_fit
    from bayesianinference_tpu_torch.models.problem import define_inference_problem
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device(dev)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    problem, _, pm, psd, log_z = _normal_model(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    r = advi_fit(problem, g, num_steps=steps)
    s = r.sample(g, 20000)[:, 0]
    elbo = float(r.elbo)
    wall = time.perf_counter() - t0
    prec = torch.as_tensor(np.linalg.inv([[1.0, 0.9], [0.9, 1.0]]), device=dev)
    corr_problem = define_inference_problem(parameters=[("a", -8.0, 8.0), ("b", -8.0, 8.0)],
                                            log_likelihood=lambda th: -0.5 * th @ prec @ th,
                                            prior_distribution=["location", "location"], validate=False, device=dev,
                                            dtype=torch.float64)
    t1 = time.perf_counter()
    fr = advi_fit(corr_problem, g, family="fullrank", num_steps=steps)
    got_rho = float(np.corrcoef(fr.sample(g, 20000).cpu().numpy().T)[0, 1])
    wall_fr = time.perf_counter() - t1
    if (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches) != before:
        raise AssertionError("16a: a hand-written kernel launched")
    return dict(mean=float(s.mean()), sd=float(s.std()), elbo=elbo, pm=pm, psd=psd, log_z=log_z, rho=got_rho,
                wall=wall, wall_fr=wall_fr, steps=steps)


def _phase16_advi_oracles(smi, dev, pending=None, **kw):
    """16a: ADVI at its defaults on the conjugate oracle (tests/test_vi.py's
    gates) and fullrank on the rho = 0.9 Gaussian, gated on
    :func:`_advi_oracle_job`'s readings (``pending``: its result from phase
    8's pool, or None to run it here with ``kw``)."""
    t = time.perf_counter()
    r = _advi_oracle_job(str(dev), **kw) if pending is None else pending.get()
    wait = time.perf_counter() - t
    mean, sd, elbo, pm, psd, log_z = r["mean"], r["sd"], r["elbo"], r["pm"], r["psd"], r["log_z"]
    if not (abs(mean - pm) <= 0.02 and abs(sd / psd - 1) <= 0.1 and log_z - 0.1 < elbo < log_z + 0.02):
        raise AssertionError(f"16a ADVI: mean {mean} (exact {pm}), sd {sd} ({psd}), ELBO {elbo} (logZ {log_z})")
    if not abs(r["rho"] - 0.9) <= 0.06:
        raise AssertionError(f"16a ADVI fullrank: correlation {r['rho']} (0.9)")
    where = ("in this process" if pending is None else
             f"in a worker process of phase 8's pool, waited for {wait:.1f} s here")
    log(f"[16a ADVI oracles] conjugate Normal, meanfield, {r['steps']} steps, 32 draws: mean {mean:.4f} (exact "
        f"{pm:.4f}), sd {sd:.4f} ({psd:.4f}), ELBO {elbo:.4f} vs logZ {log_z:.4f}, {r['wall']:.1f} s = "
        f"{1e3 * r['wall'] / r['steps']:.2f} ms a step; fullrank on the rho = 0.9 Gaussian: correlation "
        f"{r['rho']:.4f}, {r['wall_fr']:.1f} s, {where} | {smi}")


def _elbo_se(problem, fit, final) -> float:
    """Monte-Carlo standard error of a fit's final ELBO estimate, from the
    same draws: sd of log p(x(z)) + log|J| over them / sqrt(count)."""
    from bayesianinference_tpu_torch.core.transforms import box_bijection
    from bayesianinference_tpu_torch.engines.vi import in_chunks, z_log_target

    with torch.no_grad():
        z = fit.loc + final @ fit.scale_tril.T
        vals = in_chunks(z_log_target(problem, box_bijection(problem.lower, problem.upper)), z)
    return float(vals.std() / math.sqrt(vals.shape[0]))


def _phase16_advi_gp(smi, watch, dev, problem, cpu_problem, grid_logz, steps=ADVI_GP_STEPS, cpu_steps=ADVI_CPU_STEPS):
    """16b: ADVI on phase 4's GP problem through both kernels (the step's
    value and gradient at B = 32), both families; a short f64 fit on the
    card against the same fit on CPU tensors on the same draws."""
    from bayesianinference_tpu_torch.engines import vi

    out = {}
    for family in ("meanfield", "fullrank"):
        draws = vi.vi_draws(torch.Generator(device=dev).manual_seed(1), steps, 32, 4096, problem.dim)
        watch.zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = vi.advi_fit(problem, None, family=family, num_steps=steps, draws=draws)
        elbo = float(fit.elbo)
        wall = time.perf_counter() - t0
        launches = watch.counts()
        if min(launches.values()) < steps:
            raise AssertionError(f"16b ADVI {family}: launches {launches} for {steps} steps")
        se = _elbo_se(problem, fit, draws.final)
        if not elbo <= grid_logz + 4 * se:
            raise AssertionError(f"16b ADVI {family}: ELBO {elbo} above the grid logZ {grid_logz} + 4 x {se}")
        out[family] = (fit, launches, wall, elbo, se)
    draws = vi.vi_draws(torch.Generator().manual_seed(2), cpu_steps, 32, 64, problem.dim)
    kw = dict(num_steps=cpu_steps, final_elbo_samples=64)
    t0 = time.perf_counter()
    card = vi.advi_fit(problem, None, draws=vi.VIDraws(*(a.to(dev) for a in draws)), **kw)
    cpu = vi.advi_fit(cpu_problem, None, draws=draws, **kw)
    wall_cpu = time.perf_counter() - t0
    rel = max(_rel_max(a.cpu(), b) for a, b in ((card.elbo_history, cpu.elbo_history), (card.loc, cpu.loc),
                                                (card.scale_tril, cpu.scale_tril), (card.elbo, cpu.elbo)))
    if not rel <= 1e-8:
        raise AssertionError(f"16b ADVI: the card's {cpu_steps}-step fit vs the CPU's on the same draws: {rel:.3e}")
    lines = [f"{fam} ELBO {e:.4f} (grid logZ {grid_logz:.4f}, gap {grid_logz - e:.4f}, MC se {se:.4f}), "
             f"{w:.1f} s = {1e3 * w / steps:.2f} ms a step, launches {ln}" for fam, (_, ln, w, e, se) in out.items()]
    log(f"[16b ADVI GP] phase 4's problem (n={SLICE_N} d={SLICE_D} f64), {steps} steps (3000 cut to fit the time "
        f"limit), 32 draws a step through both kernels and both reverse rules, final bound on 4096 draws: "
        f"{'; '.join(lines)}; a {cpu_steps}-step meanfield fit (cut from 100 for the CPU's 0.6 s a step) on the "
        f"card vs CPU tensors on the same draws: max rel diff {rel:.3e} ({wall_cpu:.1f} s) | "
        f"{smi}")
    return {k: sum(v[1][k] for v in out.values()) for k in ("se_covariance", "cholesky")}, out


def _pathfinder_gates(r, ref, what, tol, ref_sd=0.0, slack_sd=4.0):
    """(log_evidence_is - ref, best ELBO - ref, the best ELBO's MC se) with
    the IS gate applied when pareto_k < 0.7; the ELBO must not exceed the
    logZ ``ref`` by more than ``slack_sd`` of its Monte-Carlo standard error
    and ``ref``'s, ``ref_sd``, together."""
    pk, lz = float(r.pareto_k), float(r.log_evidence_is)
    best = int(torch.argmax(r.elbo_per_path))
    m = r.samples.n // r.num_paths
    # the per-path ELBO is the mean of the path's raw log-weights; their sd from the smoothed ones is close
    se = float(r.samples.log_weights[best * m:(best + 1) * m].std()) / math.sqrt(m)
    if pk < 0.7 and not abs(lz - ref) <= tol:
        raise AssertionError(f"{what}: log_evidence_is {lz} vs {ref} (pareto k {pk:.3f})")
    if not (bool(torch.isfinite(r.samples.log_weights).all()) and math.isfinite(lz)):
        raise AssertionError(f"{what}: non-finite log weights or evidence {lz}")
    slack = slack_sd * max(math.hypot(se, ref_sd), 1e-3)
    if not float(r.elbo) <= ref + slack:
        raise AssertionError(f"{what}: ELBO {float(r.elbo)} above {ref} + {slack}")
    return lz - ref, float(r.elbo) - ref, se


def _phase16_pathfinder(smi, watch, dev, problem, grid_logz):
    """16c: Pathfinder at its defaults on the conjugate oracle, phase 4's GP
    problem and phase 9's ARD GP (d = 22 > 2J = 12)."""
    from bayesianinference_tpu_torch.engines import pathfinder as pf
    from bayesianinference_tpu_torch.engines.vi import EVAL_CHUNK
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy

    conj, _, pm, psd, log_z = _normal_model(dev)
    # the JAX test's own draws: its k-hat gate fails at 4 of 40 JAX keys (tests/test_torch_pathfinder.py)
    with np.load(PATHFINDER_DRAWS) as f:
        draws = pf.PathfinderDraws(*(torch.as_tensor(f[k], device=dev) for k in pf.PathfinderDraws._fields))
    r = pf.pathfinder_fit(conj, None, draws=draws)
    w = r.samples.normalized_weights()
    pts = r.samples.points[:, 0]
    m = float(w @ pts)
    sd = float(torch.sqrt(w @ (pts - m) ** 2))
    if not (abs(float(r.log_evidence_is) - log_z) <= 0.02 and log_z - 0.2 < float(r.elbo) < log_z + 0.05
            and abs(m - pm) <= 0.03 and abs(sd / psd - 1) <= 0.15 and float(r.pareto_k) < 0.7):
        raise AssertionError(f"16c Pathfinder conjugate: logZ_IS {float(r.log_evidence_is)} (exact {log_z}), ELBO "
                             f"{float(r.elbo)}, mean {m} ({pm}), sd {sd} ({psd}), pareto k {float(r.pareto_k)}")
    lines = [f"conjugate on the JAX test's draws ({PATHFINDER_DRAWS.name}): logZ_IS {float(r.log_evidence_is):.4f} "
             f"(exact {log_z:.4f}), ELBO {float(r.elbo):.4f}, "
             f"mean {m:.4f} ({pm:.4f}), sd {sd:.4f} ({psd:.4f}), pareto k {float(r.pareto_k):.3f}"]
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(ARD_N, ARD_D))
    y_np = np.sin(x_np[:, 0]) + 0.5 * x_np[:, 1] + 0.1 * rng.normal(size=ARD_N)
    ard = _ard_gp_problem(*problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64))
    fits, total = {}, {"se_covariance": 0, "cholesky": 0}
    for name, prob in (("GP", problem), ("ARD GP", ard)):
        watch.zero()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pf.pathfinder_fit(prob, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        launches = watch.counts()
        if min(launches.values()) == 0:
            raise AssertionError(f"16c Pathfinder {name}: launches {launches}")
        for k in total:
            total[k] += launches[k]
        if name == "GP":
            ref, ref_sd, ref_note = grid_logz, 0.0, "grid logZ"
        else:
            ref, re, ref_note, ref_launches = _ard_reference(watch, dev, prob, r)
            ref_sd = max(re, 0.2)
            for k in total:
                total[k] += ref_launches[k]
        tol = 0.1 if name == "GP" else 4 * ref_sd
        d_is, d_elbo, se = _pathfinder_gates(r, ref, f"16c Pathfinder {name}", tol, ref_sd)
        fits[name] = r
        lines.append(f"{name} (d={prob.dim}): logZ_IS - {ref_note} {d_is:+.4f} (gate {tol:.2f} when k < 0.7), "
                     f"ELBO - it {d_elbo:+.4f} (MC se {se:.4f}, gate 4 x hypot(se, {ref_sd:.3f})), pareto k "
                     f"{float(r.pareto_k):.3f}, best iterations {r.best_iteration.tolist()}, {wall:.2f} s, launches "
                     f"{launches}, ELBO block in chunks of {EVAL_CHUNK}, peak {peak:.0f} MiB")
    # the factor's 1e-10 jitter on its small block reads 1e-10 (covariance)
    # and 8e-10 (log det) on the CPU; a wrong factor is off by O(0.1)
    worst = _pathfinder_factor_check(dev)
    if not worst <= 1e-8:
        raise AssertionError(f"16c Pathfinder factor against the BFGS inverse Hessian: {worst:.3e}")
    log(f"[16c Pathfinder] 8 paths, 60 iterations, 30 ELBO draws, 256 draws a path, f64: {'; '.join(lines)}; the "
        f"factor at d = 22 > 2J = 12 and d = 3 against the BFGS inverse Hessian built pair by pair in numpy: "
        f"covariance and half log det within {worst:.3e} relative | {smi}")
    return total, fits, ard


def _ard_reference(watch, dev, problem, fit, chains=ARD_REF_CHAINS, steps=ARD_REF_STEPS):
    """A logZ of the ARD GP that Pathfinder's pool does not enter: bridge
    sampling (its own moment-matched proposal) of HMC draws, ``chains``
    chains started at the fit's draws, ``steps`` warmup and ``steps``
    samples of 8 leapfrog steps; (logZ, relative error, note, launches)."""
    from bayesianinference_tpu_torch.engines.bridge import bridge_sampling_evidence
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample
    from bayesianinference_tpu_torch.results import gelman_rubin

    g = torch.Generator(device=dev).manual_seed(5)
    watch.zero()
    t0 = time.perf_counter()
    h = hmc_sample(problem, g, num_chains=chains, num_samples=steps, num_warmup=steps, num_leapfrog=8,
                   starting_points=fit.posterior_samples(g, chains).points)
    br = bridge_sampling_evidence(problem, h, g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = watch.counts()
    rhat = max(float(gelman_rubin(h.per_parameter_chains(i))) for i in range(problem.dim))
    if not (rhat < 1.2 and br.converged and min(launches.values()) >= 2 * steps * 8):
        raise AssertionError(f"16c ARD reference: split R-hat {rhat}, bridge converged {br.converged}, launches "
                             f"{launches}")
    note = (f"bridge logZ of {chains} HMC chains x {steps} ({float(br.log_evidence):.4f}, re "
            f"{float(br.relative_error):.4f}, R-hat {rhat:.3f}, {wall:.2f} s, launches {launches})")
    return float(br.log_evidence), float(br.relative_error), note, launches


def _bfgs_inverse_hessian(alpha, S, Y, ok):
    """diag(alpha) updated by BFGS's inverse-Hessian rule once per kept
    (s, y) pair, oldest first: the matrix Pathfinder's factor represents."""
    H = np.diag(alpha)
    eye = np.eye(len(alpha))
    for s, y, keep in zip(S, Y, ok):
        if keep:
            rho = 1.0 / (s @ y)
            V = eye - rho * np.outer(y, s)
            H = V.T @ H @ V + rho * np.outer(s, s)
    return H


def _pathfinder_factor_check(dev, cases=((22, 6), (3, 6)), batch=4, seed=0) -> float:
    """``pathfinder.factor`` and ``draw`` on ``dev`` (d > 2J, the thin QR's
    m = 2J branch, and d < 2J): the covariance of the draws' linear map and
    the half log determinant against :func:`_bfgs_inverse_hessian`, on
    windows with masked pairs; the largest relative error."""
    from bayesianinference_tpu_torch.engines import pathfinder as pf

    rng = np.random.default_rng(seed)
    worst = 0.0
    for d, J in cases:
        a = rng.normal(size=(d, d))
        A = a @ a.T / d + 0.5 * np.eye(d)
        S = rng.normal(size=(batch, J, d))
        Y = S @ A  # y = A s: positive curvature
        ok = rng.random((batch, J)) < 0.7
        alpha = 0.5 + rng.random((batch, d))

        def t(v):
            return torch.as_tensor(v, device=dev)

        sqrt_a, Q, Lm, half_logdet = pf.factor(t(alpha), t(S), t(Y), t(ok))
        eye = torch.eye(d, dtype=torch.float64, device=dev).expand(batch, d, d)
        Wt = pf.draw(torch.zeros((batch, d), dtype=torch.float64, device=dev), sqrt_a, Q, Lm, eye).cpu().numpy()
        for b in range(batch):
            H = _bfgs_inverse_hessian(alpha[b], S[b], Y[b], ok[b])
            cov = Wt[b].T @ Wt[b]  # draws are W eps; row i of Wt is W e_i
            worst = max(worst, float(np.abs(cov - H).max() / np.abs(H).max()),
                        abs(float(half_logdet[b]) - 0.5 * np.linalg.slogdet(H)[1]) / max(1.0, abs(float(half_logdet[b]))))
    return worst


def _phase16_hmc_pathfinder(smi, watch, dev, problem, ns_res, chains=16, warmup=60, samples=60, leapfrog=8):
    """16d: hmc_sample(starting_points="pathfinder") on phase 4's GP problem
    at 13c's sizes, its moments against phase 4's NS posterior (13c's gate)."""
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample
    from bayesianinference_tpu_torch.results import gelman_rubin

    watch.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = hmc_sample(problem, torch.Generator(device=dev).manual_seed(4), num_chains=chains, num_samples=samples,
                   num_warmup=warmup, num_leapfrog=leapfrog, starting_points="pathfinder")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = watch.counts()
    w = torch.exp(ns_res.crude_log_posterior_weights)
    w = w / w.sum()
    u = torch.log(ns_res.points)
    ns_mean = (w[:, None] * u).sum(dim=0)
    ns_sd = torch.sqrt((w[:, None] * (u - ns_mean) ** 2).sum(dim=0))
    off = ((torch.log(r.samples).reshape(-1, r.samples.shape[-1]).mean(dim=0) - ns_mean).abs() / ns_sd).max().item()
    rhat = max(float(gelman_rubin(r.per_parameter_chains(i))) for i in range(r.samples.shape[-1]))
    if not (off <= 0.3 and rhat < 1.1 and min(launches.values()) >= (warmup + samples) * leapfrog):
        raise AssertionError(f"16d HMC from Pathfinder: means {off:.3f} NS sds off, split R-hat {rhat:.4f}, launches "
                             f"{launches}")
    log(f"[16d HMC from Pathfinder] phase 4's problem, {chains} chains started at draws of a Pathfinder fit (8 paths, "
        f"128 draws a path), {warmup} warmup, {samples} samples, {leapfrog} leapfrog: {wall:.2f} s; log-hyperparameter "
        f"means within {off:.3f} posterior sds of phase 4's NS posterior, split R-hat at most {rhat:.4f}, acceptance "
        f"{float(r.acceptance_rates.mean()):.3f}; launches {launches} | {smi}")
    return launches, r


def _phase16_bridge(smi, watch, dev, problem, grid_logz, hmc, pf_fit):
    """16e: bridge sampling on the conjugate oracle (4000 exact draws) and on
    the GP from 16d's HMC draws and 16c's Pathfinder fit."""
    from bayesianinference_tpu_torch.engines.bridge import bridge_sampling_evidence

    conj, _, pm, psd, log_z = _normal_model(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    draws = pm + psd * torch.randn((4000, 1), generator=g, device=dev, dtype=torch.float64)
    r = bridge_sampling_evidence(conj, draws, g)
    if not (r.converged and r.num_iterations < 20 and abs(float(r.log_evidence) - log_z) <= 5e-3):
        raise AssertionError(f"16e bridge conjugate: logZ {float(r.log_evidence)} (exact {log_z}), "
                             f"{r.num_iterations} iterations, converged {r.converged}")
    lines = [f"conjugate: logZ {float(r.log_evidence):.5f} (exact {log_z:.5f}), {r.num_iterations} iterations, "
             f"re {float(r.relative_error):.2e}"]
    watch.zero()
    for name, draws in (("GP from 16d's HMC draws", hmc), ("GP from 16c's Pathfinder fit", pf_fit)):
        t0 = time.perf_counter()
        r = bridge_sampling_evidence(problem, draws, g)
        wall = time.perf_counter() - t0
        err = float(r.log_evidence) - grid_logz
        if not abs(err) <= 3 * float(r.relative_error) + 0.05:
            raise AssertionError(f"16e bridge {name}: logZ {float(r.log_evidence)} vs grid {grid_logz}, re "
                                 f"{float(r.relative_error)}")
        lines.append(f"{name}: logZ - grid {err:+.4f} (re {float(r.relative_error):.4f}), {r.num_iterations} "
                     f"iterations, {r.num_posterior_draws} + {r.num_proposal_draws} draws, {wall:.2f} s")
    launches = watch.counts()
    if min(launches.values()) == 0:
        raise AssertionError(f"16e bridge: launches {launches}")
    log(f"[16e bridge] {'; '.join(lines)}; launches {launches} | {smi}")
    return launches


LOO_MODELS = ((0.0, 3.0), (-1.0, 0.3))  # 16f's conjugate Normal models, (mu0, tau0)


def _loo_case(dev, mu0, tau0, draws=None):
    """PSIS-LOO and WAIC of y_i ~ N(mu, 1), mu ~ N(mu0, tau0^2) (40
    observations) from ``draws`` [S] standard normals mapped onto its exact
    posterior, by default a quantile grid of LOO_DRAWS points (no Monte-Carlo
    noise); (psis_loo, waic, exact leave-one-out elpd)."""
    from bayesianinference_tpu_torch.core.containers import WeightedSamples
    from bayesianinference_tpu_torch.results import psis_loo, waic

    _, data, pm, psd, _ = _normal_model(dev, n_obs=40, tau0=tau0, mu0=mu0)
    y = torch.as_tensor(data, device=dev)
    n = len(data)
    # exact LOO: the posterior without y_i, N(m_-i, v_-i), predicts y_i ~ N(m_-i, 1 + v_-i)
    prec_i = 1 / tau0**2 + (n - 1)
    m_i = (mu0 / tau0**2 + (data.sum() - data)) / prec_i
    v_i = 1 / prec_i
    exact = float(np.sum(-0.5 * np.log(2 * np.pi * (1 + v_i)) - 0.5 * (data - m_i) ** 2 / (1 + v_i)))
    if draws is None:
        u = (torch.arange(LOO_DRAWS, device=dev, dtype=torch.float64) + 0.5) / LOO_DRAWS
        draws = torch.special.ndtri(u)
    pts = (pm + psd * draws)[:, None]
    ws = WeightedSamples(points=pts, log_weights=torch.zeros(pts.shape[0], device=dev, dtype=torch.float64))

    def pointwise(th):
        return -0.5 * math.log(2 * math.pi) - 0.5 * (y - th[0]) ** 2

    return psis_loo(ws, pointwise), waic(ws, pointwise), exact


def _phase16_results(smi, dev, ns_res, reps=200):
    """16f: the results layer on card tensors: WAIC and PSIS-LOO on the
    conjugate Normal model against its exact leave-one-out elpd and against
    the same on CPU tensors, model weights, an SBC study of the conjugate
    engine, and the summary and calculation report of phase 4's NS
    result."""
    from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu_torch.engines.conjugate import normal_conjugate_model
    from bayesianinference_tpu_torch.results import calculation_report, model_weights, sbc_ranks, summary

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(3)
    lines = []
    elpds = []
    for mu0, tau0 in LOO_MODELS:
        loo, wa, exact = _loo_case(dev, mu0, tau0)
        loo_cpu, wa_cpu, _ = _loo_case(torch.device("cpu"), mu0, tau0)
        rel = max(_rel_max(loo.pointwise_elpd.cpu(), loo_cpu.pointwise_elpd),
                  _rel_max(wa.pointwise_elpd.cpu(), wa_cpu.pointwise_elpd),
                  float((loo.pareto_k.cpu() - loo_cpu.pareto_k).abs().max()))
        if not (loo.pointwise_elpd.device.type == dev.type and abs(loo.elpd_loo - exact) <= LOO_TOL
                and abs(wa.elpd - exact) <= WAIC_TOL and bool((loo.pareto_k < 0.7).all()) and rel <= 1e-10):
            raise AssertionError(f"16f LOO (mu0 {mu0}, tau0 {tau0}): PSIS {loo.elpd_loo}, WAIC {wa.elpd}, exact "
                                 f"{exact}, max k {float(loo.pareto_k.max())}, card vs CPU {rel:.3e}")
        elpds.append(loo)
        lines.append(f"N(mu0={mu0}, tau0={tau0}): elpd PSIS-LOO - exact LOO {loo.elpd_loo - exact:+.3e} (gate "
                     f"{LOO_TOL}), WAIC - it {wa.elpd - exact:+.3e} ({WAIC_TOL}), exact LOO {exact:.4f}, max k "
                     f"{float(loo.pareto_k.max()):.3f}, card vs CPU {rel:.2e}")
    weights = {}
    for method in ("stacking", "pseudo-bma", "pseudo-bma+"):
        w = model_weights(elpds, method=method, generator=g)
        if not (w.device.type == dev.type and bool((w >= 0).all()) and abs(float(w.sum()) - 1) < 1e-12):
            raise AssertionError(f"16f model_weights {method}: {w.tolist()}")
        weights[method] = [round(v, 4) for v in w.tolist()]
    prior = NormalInverseGamma(mu0=0.5, lam=2.0, beta=1.5, nu=3.0)

    def prior_sample(gen):
        return torch.stack(prior.sample(gen))

    def simulate(gen, theta):
        return theta[0] + torch.sqrt(theta[1]) * torch.randn((10,), generator=gen, device=dev, dtype=theta.dtype)

    def posterior_draws(gen, data):
        m, v = normal_conjugate_model(data, prior=prior).posterior.sample(gen, (9,))
        return torch.stack([m, v], dim=-1)

    sbc = sbc_ranks(g, prior_sample=prior_sample, simulate=simulate, posterior_draws=posterior_draws,
                    num_replications=reps, param_names=("mean", "var"))
    p = sbc.uniformity_pvalues()
    if not (sbc.ranks.device.type == dev.type and float(p.min()) > 1e-3):
        raise AssertionError(f"16f SBC of the conjugate Normal engine: p-values {p.tolist()}")
    table = summary(ns_res)
    rep = calculation_report(ns_res)
    log(f"[16f results layer] {LOO_DRAWS} draws on a quantile grid of the exact posterior: {'; '.join(lines)}; "
        f"model weights {weights}; SBC of the conjugate Normal engine, {reps} "
        f"replications of 9 draws: uniformity p-values {[round(v, 4) for v in p.tolist()]}; "
        f"{time.perf_counter() - t0:.1f} s | {smi}")
    log("[16f summary of phase 4's NS result]\n" + str(table))
    log(f"[16f calculation report of phase 4's NS result] {len(rep.skilling_log_x)} samples, final log evidence "
        f"{rep.evidence_progression[-1]:.4f}, concentration fit {rep.concentration_fit_coefficients}, mean "
        f"acceptance {np.nanmean(rep.acceptance_rates):.3f}")


def phase_vi_pathfinder(smi: str, gp_problem, gp_posterior, dev="cuda", advi=None, **sizes):
    """Phase 16: ADVI, Pathfinder, bridge sampling, HMC's Pathfinder start
    and the results layer (module docstring).  ``advi`` is the pending
    result of 16a's fits in phase 8's pool, or None to run them here.
    ``sizes`` shrink 16a-f for a rehearsal (``oracles``, ``advi``, ``hmc``,
    ``results``: keyword arguments of each sub-phase)."""
    dev = torch.device(dev)
    ns_res, grid_logz, cpu_problem = gp_posterior
    t0 = time.perf_counter()
    seconds, total = [], {"se_covariance": 0, "cholesky": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    with _KernelWatch() as watch:
        t = time.perf_counter()
        _phase16_advi_oracles(smi, dev, advi, **sizes.get("oracles", {}))
        seconds.append(f"16a {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        launches, _ = _phase16_advi_gp(smi, watch, dev, gp_problem, cpu_problem, grid_logz, **sizes.get("advi", {}))
        add(launches)
        seconds.append(f"16b {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        launches, fits, _ = _phase16_pathfinder(smi, watch, dev, gp_problem, grid_logz)
        add(launches)
        seconds.append(f"16c {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        launches, hmc = _phase16_hmc_pathfinder(smi, watch, dev, gp_problem, ns_res, **sizes.get("hmc", {}))
        add(launches)
        seconds.append(f"16d {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        add(_phase16_bridge(smi, watch, dev, gp_problem, grid_logz, hmc, fits["GP"]))
        seconds.append(f"16e {time.perf_counter() - t:.1f}")
        if not (total["se_covariance"] > 0 and total["cholesky"] > 0):
            raise AssertionError(f"16: launches {total}")
        t = time.perf_counter()
        _phase16_results(smi, dev, ns_res, **sizes.get("results", {}))
        seconds.append(f"16f {time.perf_counter() - t:.1f}")
        log(f"[16 VI, Pathfinder, bridge, results] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches "
            f"{total}; {watch.check('16')}")
    return total


# --------------------------------------------------------------------------
# Phase 17: the consumption layer
# --------------------------------------------------------------------------

MOMENT_DRAWS = 2**20  # 17a's card draws per family
HOLDOUT_N = 512  # 17b's held-out points, phase 4's data law under seed 1
CRPS_DRAWS, CRPS_BATCHES = 2**14, 16  # 17b's ensemble CRPS and its batches for a standard error
TP_THETAS = 16  # 17d's hyperparameter draws
BETAINC_ERRORS = Path(__file__).resolve().parent / "tests" / "data" / "betainc_jax_error.json"
# tests/test_dists_scalar.py:10-27 and :70-147: family, parameters, scipy's law, grid
SCALAR_CASES = [
    ("Normal", dict(loc=1.5, scale=2.0), ("norm", (1.5, 2.0), {}), (-5, 8)),
    ("Uniform", dict(low=-1.0, high=3.0), ("uniform", (-1.0, 4.0), {}), (-0.9, 2.9)),
    ("Exponential", dict(rate=2.5), ("expon", (), {"scale": 1 / 2.5}), (0.01, 4)),
    ("Gamma", dict(a=3.0, rate=2.0), ("gamma", (3.0,), {"scale": 1 / 2.0}), (0.05, 6)),
    ("InverseGamma", dict(a=3.0, b=2.0), ("invgamma", (3.0,), {"scale": 2.0}), (0.05, 6)),
    ("Beta", dict(a=2.0, b=5.0), ("beta", (2.0, 5.0), {}), (0.01, 0.99)),
    ("StudentT", dict(df=4.0, loc=1.0, scale=2.0), ("t", (4.0, 1.0, 2.0), {}), (-8, 10)),
    ("Cauchy", dict(loc=0.5, scale=1.5), ("cauchy", (0.5, 1.5), {}), (-10, 10)),
    ("HalfCauchy", dict(scale=2.0), ("halfcauchy", (), {"scale": 2.0}), (0.01, 10)),
    ("LogNormal", dict(loc=0.3, scale=0.8), ("lognorm", (0.8,), {"scale": math.exp(0.3)}), (0.05, 8)),
    ("Laplace", dict(loc=-1.0, scale=2.0), ("laplace", (-1.0, 2.0), {}), (-8, 6)),
    ("Weibull", dict(k=1.7, scale=2.0), ("weibull_min", (1.7,), {"scale": 2.0}), (0.05, 7)),
    ("Logistic", dict(loc=0.5, scale=1.2), ("logistic", (0.5, 1.2), {}), (-7, 8)),
    ("ChiSquared", dict(df=5.0), ("chi2", (5.0,), {}), (0.1, 18)),
    ("Gumbel", dict(loc=1.0, scale=2.0), ("gumbel_r", (1.0, 2.0), {}), (-5, 12)),
    ("Pareto", dict(xmin=1.5, alpha=5.0), ("pareto", (5.0,), {"scale": 1.5}), (1.55, 12)),
    ("LogUniform", dict(low=0.1, high=10.0), ("loguniform", (0.1, 10.0), {}), (0.2, 9.0)),
    ("Poisson", dict(rate=3.5), ("poisson", (3.5,), {}), (0, 14)),
    ("Binomial", dict(n=10.0, p=0.3), ("binom", (10, 0.3), {}), (0, 10)),
    ("NegativeBinomial", dict(r=4.0, p=0.35), ("nbinom", (4, 0.35), {}), (0, 24)),
    ("Geometric", dict(p=0.3), ("geom", (0.3,), {"loc": -1}), (0, 24)),
    ("Bernoulli", dict(p=0.2), ("bernoulli", (0.2,), {}), (0, 1)),
    ("BernoulliLogits", dict(logits=0.7), ("bernoulli", (1 / (1 + math.exp(-0.7)),), {}), (0, 1)),
    ("Categorical", dict(logits=[0.1, -0.4, 1.2]), None, (0, 2)),
]
_DISCRETE = ("Poisson", "Binomial", "NegativeBinomial", "Geometric", "Bernoulli", "BernoulliLogits", "Categorical")


def _scalar_pair(name, params, dev):
    from bayesianinference_tpu_torch import dists

    build = lambda d: getattr(dists, name)(**{k: torch.tensor(v, dtype=torch.float64, device=d)  # noqa: E731
                                              for k, v in params.items()})
    return build(dev), build("cpu")


def _categorical_law(logits):
    from scipy import stats

    p = np.exp(np.asarray(logits) - np.logaddexp.reduce(logits))
    return stats.rv_discrete(values=(np.arange(len(p)), p))


def _optional(fn, *args):
    """``fn(*args)``, or None where the family does not define it."""
    try:
        return fn(*args)
    except NotImplementedError:
        return None


def _phase17_families(smi, dev, draws=MOMENT_DRAWS):
    """17a: the 24 scalar families' log_prob, cdf and icdf on the JAX
    tests' grids, on the card against CPU tensors (1e-12 relative) and
    against scipy at those tests' tolerances; their sampling moments at
    ``draws`` card draws under the tests' moment gates; the regularized
    incomplete beta on its grid under its gates (tests/test_torch_scalar_families.py)."""
    from scipy import special as sps
    from scipy import stats

    from bayesianinference_tpu_torch.core.numerics import betainc

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(17)
    worst, lines = {"log_prob": 0.0, "cdf": 0.0, "icdf": 0.0}, []
    q = np.linspace(0.05, 0.95, 10)
    for name, params, law, rng_ in SCALAR_CASES:
        card, cpu = _scalar_pair(name, params, dev)
        ref = _categorical_law(params["logits"]) if law is None else getattr(stats, law[0])(*law[1], **law[2])
        discrete = name in _DISCRETE
        x = np.arange(rng_[0], rng_[1] + 1, dtype=float) if discrete else np.linspace(*rng_, 41)
        xt = torch.tensor(x, dtype=torch.float64)
        lp = card.log_prob(xt.to(dev)).cpu()
        worst["log_prob"] = max(worst["log_prob"], _rel_max(lp, cpu.log_prob(xt)))
        want = ref.logpmf(x.astype(int)) if discrete else ref.logpdf(x)
        tol = dict(rtol=1e-7, atol=1e-9) if discrete else dict(rtol=1e-8, atol=1e-10)
        if not np.allclose(lp.numpy(), want, **tol):
            raise AssertionError(f"17a {name}: log_prob against scipy, max diff {np.abs(lp.numpy() - want).max():.3e}")
        c = _optional(card.cdf, xt[::2].to(dev))
        if c is not None:
            worst["cdf"] = max(worst["cdf"], _rel_max(c.cpu(), cpu.cdf(xt[::2])))
            if not np.allclose(c.cpu().numpy(), ref.cdf(x[::2]), rtol=1e-6, atol=1e-9):
                raise AssertionError(f"17a {name}: cdf against scipy")
            qi = _optional(card.icdf, torch.tensor(q, dtype=torch.float64, device=dev))
            if qi is not None:
                worst["icdf"] = max(worst["icdf"], _rel_max(qi.cpu(), cpu.icdf(torch.tensor(q, dtype=torch.float64))))
                if not np.allclose(card.cdf(qi).cpu().numpy(), q, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"17a {name}: cdf(icdf(q)) against q")
        if name not in ("Cauchy", "HalfCauchy"):
            s = card.sample(g, (draws,)).double()
            m, v = float(s.mean()), float(s.var(correction=0))
            m_ref, v_ref = (float(u) for u in ref.stats())
            tol_m, tol_v = (dict(rtol=0.05), dict(rtol=0.1)) if discrete else (dict(rtol=0.05, atol=0.02),
                                                                              dict(rtol=0.1, atol=0.05))
            if not (s.device.type == dev.type and np.isclose(m, m_ref, **tol_m) and np.isclose(v, v_ref, **tol_v)):
                raise AssertionError(f"17a {name}: {draws} card draws mean {m} var {v}, scipy {m_ref} {v_ref}")
            lines.append(f"{name} {m:.4f}/{v:.4f}")
    if not all(v <= 1e-12 for v in worst.values()):
        raise AssertionError(f"17a: card against CPU tensors {worst}")
    # betainc on its grid, against scipy, per (a, b) cell under its gates
    errors = json.loads(BETAINC_ERRORS.read_text())
    ab, xs = errors["a_b"], errors["x"]
    cells = {}
    for dtype, key in ((torch.float64, "float64"), (torch.float32, "float32")):
        a, b, x = (torch.tensor(v.ravel(), dtype=dtype) for v in np.meshgrid(ab, ab, xs, indexing="ij"))
        ref = sps.betainc(a.double().numpy(), b.double().numpy(), x.double().numpy())
        got = betainc(a.to(dev), b.to(dev), x.to(dev)).cpu()
        err = np.abs(got.double().numpy() - ref).reshape(len(ab), len(ab), -1).max(axis=-1)
        jax_err = np.asarray(errors[key])
        gate = np.maximum(2 * jax_err, 1e-13) if dtype == torch.float64 else 2 * jax_err + 1e-6
        if not (got.dtype == dtype and np.all(err <= gate)):
            raise AssertionError(f"17a betainc {key}: worst error over its gate {(err / gate).max():.3f}")
        cells[key] = (float(err.max()), float((err / gate).max()), float(jax_err.max()))
        if dtype == torch.float64:
            cpu_rel = _rel_max(got, betainc(a, b, x))
    log(f"[17a scalar families] 24 families on the card (f64): log_prob, cdf, icdf vs CPU tensors max rel "
        f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())}, vs scipy at tests/test_dists_scalar.py's "
        f"tolerances; sampling moments of {draws} card draws (mean/var): {'; '.join(lines)}; betainc on its "
        f"{len(ab)}x{len(ab)}x{len(xs)} grid vs scipy: f64 max err {cells['float64'][0]:.2e} (JAX {cells['float64'][2]:.2e}), "
        f"worst cell at {cells['float64'][1]:.3f} of its gate, card vs CPU {cpu_rel:.2e}; f32 max err "
        f"{cells['float32'][0]:.2e} (JAX {cells['float32'][2]:.2e}), worst cell at {cells['float32'][1]:.3f} of its "
        f"gate; {time.perf_counter() - t0:.1f} s | {smi}")


def _holdout(dev, n=HOLDOUT_N):
    """Phase 4's data law (x ~ N(0, I_3), y = sin x_0 + 0.1 e) under seed 1."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, SLICE_D))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return (torch.as_tensor(x, dtype=torch.float64, device=dev), torch.as_tensor(y, dtype=torch.float64, device=dev))


def _scores(pred, y):
    from bayesianinference_tpu_torch.results import scoring

    return ({"crps": scoring.crps(pred, y), "log_score": scoring.log_score(pred, y), "pit": scoring.pit(pred, y),
             "dss": scoring.dawid_sebastiani_score(pred, y)},
            scoring.interval_coverage(pred, y, levels=(0.5, 0.9)))


def _phase17_gp_scores(smi, watch, dev, problem, gp_posterior, holdout=HOLDOUT_N, crps_draws=CRPS_DRAWS):
    """17b: phase 4's GP predictive at its defaults on held-out points,
    scored: every score against the same predictive on CPU tensors, the
    closed-form CRPS against the ensemble CRPS of its draws, the scores
    against a constant Normal's; one scoring call traced and timed."""
    from bayesianinference_tpu_torch.core.containers import WeightedSamples
    from bayesianinference_tpu_torch.dists import Normal, PointwiseMixture
    from bayesianinference_tpu_torch.engines.gp import predict_from_gaussian_process
    from bayesianinference_tpu_torch.results import scoring
    from bayesianinference_tpu_torch.utils import profiling

    res, _, cpu_problem = gp_posterior
    t0 = time.perf_counter()
    xq, yq = _holdout(dev, holdout)
    watch.zero()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the truncation to max_samples
        pred = predict_from_gaussian_process(res, problem, xq)
        pred_cpu = predict_from_gaussian_process(
            WeightedSamples(points=res.points.cpu(), log_weights=res.crude_log_posterior_weights.cpu()), cpu_problem,
            xq.cpu())
    launches = watch.counts()
    if not (launches["se_covariance"] > 0 and launches["cholesky"] > 0):
        raise AssertionError(f"17b: launches {launches}")
    s_count = pred.log_weights.shape[0]
    got, cover = _scores(pred, yq)
    want, cover_cpu = _scores(pred_cpu, yq.cpu())
    rel = {k: _rel_max(got[k], want[k]) for k in got}
    widths = max(_rel_max(cover[k][1], cover_cpu[k][1]) for k in cover)
    same_cover = all(float(cover[k][0]) == float(cover_cpu[k][0]) for k in cover)
    if not (all(v <= 1e-10 for v in rel.values()) and widths <= 1e-10 and same_cover):
        raise AssertionError(f"17b: scores on the card vs CPU tensors {rel}, widths {widths:.2e}, coverage "
                             f"{cover} vs {cover_cpu}")
    closed = float(got["crps"].mean())
    draws = pred.sample(torch.Generator(device=dev).manual_seed(4), (crps_draws,))
    ens = float(scoring.crps_ensemble(draws, yq).mean())
    batch_means = torch.stack([scoring.crps_ensemble(part, yq).mean()
                               for part in draws.chunk(CRPS_BATCHES)]).double()
    se = float(batch_means.std() / math.sqrt(CRPS_BATCHES))
    if not abs(closed - ens) <= 4 * se:
        raise AssertionError(f"17b: closed-form CRPS {closed} vs ensemble {ens} (se {se})")
    y_train = problem.metadata["gaussian_process"].y
    m = yq.shape[0]
    const = PointwiseMixture(log_weights=torch.zeros(1, dtype=torch.float64, device=dev),
                             component=Normal(y_train.mean().expand(1, m), y_train.std(correction=0).expand(1, m)))
    c_crps, c_log = float(scoring.crps(const, yq).mean()), float(scoring.log_score(const, yq).mean())
    gp_log = float(got["log_score"].mean())
    if not (closed < c_crps and gp_log < c_log):
        raise AssertionError(f"17b: GP CRPS {closed} log score {gp_log}; constant Normal {c_crps}, {c_log}")
    trace_dir = Path(__file__).resolve().parent / "build" / "trace17"
    with profiling.timed() as box, profiling.trace(str(trace_dir)) as path:
        box["sync"] = scoring.crps(pred, yq)
    size = Path(path).stat().st_size if Path(path).exists() else 0
    if size == 0:
        raise AssertionError(f"17b: profiling.trace wrote no trace at {path}")
    log(f"[17b GP predictive scored] phase 4's NS posterior, predict_from_gaussian_process at its defaults: S = "
        f"{s_count} of {res.points.shape[0]} samples at n = {SLICE_N}, {m} held-out points (seed 1): mean CRPS "
        f"{closed:.6f} (ensemble of {crps_draws} draws {ens:.6f}, se {se:.2e}), log score {gp_log:.6f}, DSS "
        f"{float(got['dss'].mean()):.6f}, PIT mean {float(got['pit'].mean()):.4f}; coverage "
        f"{ {k: round(float(v[0]), 4) for k, v in cover.items()} }, widths "
        f"{ {k: round(float(v[1]), 4) for k, v in cover.items()} }; constant Normal CRPS {c_crps:.4f}, log score "
        f"{c_log:.4f}; card vs CPU tensors max rel {', '.join(f'{k} {v:.2e}' for k, v in rel.items())}, widths "
        f"{widths:.2e}; launches {launches}; one CRPS call under trace and timed {box['seconds'] * 1e3:.1f} ms, "
        f"trace {size} bytes; {time.perf_counter() - t0:.1f} s | {smi}")
    return launches, xq, s_count


def _phase17_regression(smi, watch, dev, problem, res, xq):
    """17c: regression_predictive_distribution of the GP's posterior
    moments over every NS point against predict_from_gaussian_process
    (max_samples=None): the same function by two routes."""
    from bayesianinference_tpu_torch.dists import Normal
    from bayesianinference_tpu_torch.engines.gp import predict_from_gaussian_process
    from bayesianinference_tpu_torch.results import regression_predictive_distribution

    model = problem.metadata["gaussian_process"]

    def builder(theta, x):
        mean, sd = model.posterior_moments(theta, x)
        return Normal(mean, torch.clamp(sd, min=1e-12))

    t0 = time.perf_counter()
    watch.zero()
    got = regression_predictive_distribution(res, builder, xq)
    want = predict_from_gaussian_process(res, problem, xq, max_samples=None)
    launches = watch.counts()
    rel = (_rel_max(got.mean(), want.mean()), _rel_max(got.variance(), want.variance()))
    if not (max(rel) <= 1e-10 and launches["se_covariance"] > 0 and launches["cholesky"] > 0):
        raise AssertionError(f"17c: mean and variance rel diff {rel}, launches {launches}")
    log(f"[17c regression predictive] every NS point (B = {res.points.shape[0]}, n = {SLICE_N} f64) at "
        f"{xq.shape[0]} points: mean and variance vs predict_from_gaussian_process(max_samples=None) rel diff "
        f"{rel[0]:.2e}, {rel[1]:.2e}; launches {launches}; {time.perf_counter() - t0:.1f} s | {smi}")
    return launches


def _phase17_tp_quantiles(smi, watch, dev, res, xq, thetas_n=TP_THETAS, times=False):
    """17d: the Student-t process predictive's 0.05 and 0.95 quantiles at
    phase 4's data (n = 512 f64) through StudentT.cdf: at one theta
    against scipy.stats.t.ppf, at ``thetas_n`` against CPU tensors; with
    ``times`` (``chip_profile.py``), wall ms and CUDA kernels per quantile
    call."""
    from scipy import stats

    from bayesianinference_tpu_torch.engines.t_process import predict_from_t_process
    from bayesianinference_tpu_torch.interop import problem_data_from_numpy

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(SLICE_N, SLICE_D))
    y_np = np.sin(x_np[:, 0]) + 0.1 * rng.normal(size=SLICE_N)
    x, y = problem_data_from_numpy(x_np, y_np, device=dev, dtype=torch.float64)
    problem, cpu_problem = _tp_problem(x, y), _tp_problem(x.cpu(), y.cpu())
    thetas = res.points[torch.argsort(-res.crude_log_posterior_weights, stable=True)[:thetas_n]]
    q = torch.tensor([0.05, 0.95], dtype=torch.float64, device=dev)
    watch.zero()
    one = predict_from_t_process(thetas[:1], problem, xq)
    got_one = one.quantile(q).cpu()
    c = one.component
    want_one = stats.t.ppf(q.cpu().numpy()[:, None], c.df[0].cpu().numpy(), c.loc[0].cpu().numpy(),
                           c.scale[0].cpu().numpy())
    many = predict_from_t_process(thetas, problem, xq)
    got_many = many.quantile(q).cpu()
    launches = watch.counts()
    want_many = predict_from_t_process(thetas.cpu(), cpu_problem, xq.cpu()).quantile(q.cpu())
    rel_one, rel_many = _rel_max(got_one, want_one), _rel_max(got_many, want_many)
    if not (rel_one <= 1e-9 and rel_many <= 1e-10 and bool((got_many[1] > got_many[0]).all())):
        raise AssertionError(f"17d: TP quantiles vs scipy {rel_one:.3e}, card vs CPU {rel_many:.3e}")
    row = ""
    if times:
        wall = _wall_ms(lambda: many.quantile(q), reps=1)
        dev_ms, kernels = _profile_call(lambda: many.quantile(q), cpu=False, warm=False)
        row = (f"; a quantile call at {thetas_n} thetas: wall {wall:.1f} ms, device {dev_ms:.2f} ms, {kernels} CUDA "
               f"kernels (80 bisection steps of the betainc CDF, {kernels / 80:.0f} a step)")
    log(f"[17d Student-t process quantiles] n = {SLICE_N} f64, nu = 4, {xq.shape[0]} points, q = 0.05 and 0.95: at "
        f"one theta vs scipy.stats.t.ppf max rel {rel_one:.2e}; at {thetas_n} thetas card vs CPU tensors "
        f"{rel_many:.2e}{row}; launches {launches}; {time.perf_counter() - t0:.1f} s | {smi}")
    return launches


def _phase17_rest(smi, dev, gp_res, ns_pool=400, ns_delete=40, ns_steps=20, replicates=2000):
    """17e: predictive_distribution and posterior_predictive_check on an NS
    run of the conjugate Normal model (known sigma) against its exact
    predictive; the Normal exponential family against the conjugate Normal
    engine; the mixtures, censoring and the KDE (fitted to phase 4's NS
    posterior) on card tensors against CPU tensors."""
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu_torch.engines.conjugate import normal_conjugate_model
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.results import posterior_predictive_check, predictive_distribution

    t0 = time.perf_counter()
    f64 = dict(dtype=torch.float64, device=dev)
    problem, data, post_mean, post_sd, _ = _normal_model(dev)
    res = nested_sampling(problem, torch.Generator(device=dev).manual_seed(5), sample_pool_size=ns_pool,
                          num_delete=ns_delete, monte_carlo_steps=ns_steps)
    pred = predictive_distribution(res, lambda th: dists.Normal(th[0], 1.0))
    ess = float(res.posterior_samples().effective_sample_size())
    v = post_sd**2
    m_err, v_err = float(pred.mean()) - post_mean, float(pred.variance()) - (1.0 + v)
    if not (abs(m_err) <= 4 * math.sqrt(v / ess) and abs(v_err) <= 4 * v * math.sqrt(2 / ess)):
        raise AssertionError(f"17e: predictive mean {float(pred.mean())} var {float(pred.variance())}, exact "
                             f"{post_mean} {1 + v}, ESS {ess}")
    data_t = torch.as_tensor(data, **f64)
    t_obs, t_rep, p = posterior_predictive_check(res, lambda th: dists.Normal(th[0], 1.0), data_t, torch.mean,
                                                 torch.Generator(device=dev).manual_seed(6), num_replicates=replicates)
    if not (t_rep.shape == (replicates,) and t_rep.device.type == dev.type and 0.001 < float(p) < 0.999):
        raise AssertionError(f"17e: predictive check p {float(p)}")
    # the Normal family's (chi, nu) prior is NIG(chi1 / nu, nu, (chi2 - chi1^2 / nu) / 2, nu / 2 + 3 / 2)
    chi0, nu0 = torch.tensor([1.5, 6.0], **f64), 2.0
    prior = NormalInverseGamma(mu0=chi0[0] / nu0, lam=torch.tensor(nu0, **f64),
                               beta=(chi0[1] - chi0[0] ** 2 / nu0) / 2, nu=torch.tensor(nu0 / 2 + 1.5, **f64))
    fit = normal_conjugate_model(data_t, prior=prior)
    chi, nu = dists.conjugate_update(dists.NORMAL, chi0, nu0, data_t)
    grid = torch.linspace(-3, 5, 17, **f64)
    ef = _rel_max(dists.NORMAL.log_predictive_pdf(grid, chi, nu), fit.posterior_predictive.log_prob(grid))
    if not ef <= 1e-12:
        raise AssertionError(f"17e: expfam NORMAL predictive vs the conjugate engine {ef:.3e}")
    # the combinators and the KDE, card against CPU tensors
    rel = {}
    pts = gp_res.points
    for name, make, x in (
            ("Mixture", lambda d: dists.Mixture(torch.log(torch.tensor([0.3, 0.5, 0.2], dtype=torch.float64, device=d)),
                                                dists.Normal(torch.tensor([-2.0, 3.0, 0.5], dtype=torch.float64, device=d),
                                                             torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64, device=d))),
             torch.linspace(-6, 9, 31, dtype=torch.float64)),
            ("HeterogeneousMixture", lambda d: dists.HeterogeneousMixture(
                torch.log(torch.tensor([0.3, 0.7], dtype=torch.float64, device=d)),
                (dists.StudentT(torch.tensor(4.0, dtype=torch.float64, device=d), 1.0, 2.0),
                 dists.Normal(torch.tensor(-1.0, dtype=torch.float64, device=d), 0.5))),
             torch.linspace(-5, 8, 41, dtype=torch.float64)),
            ("Censored", lambda d: dists.Censored(dists.Normal(torch.tensor(0.5, dtype=torch.float64, device=d), 1.2),
                                                  low=-1.0, high=2.0),
             torch.tensor([-1.0, -0.5, 0.3, 1.9, 2.0], dtype=torch.float64)),
            ("GaussianKDE", lambda d: dists.GaussianKDE.fit(torch.log(pts).to(d),
                                                            gp_res.crude_log_posterior_weights.to(d)),
             torch.log(pts[:64]).cpu())):
        card, cpu = make(dev), make("cpu")
        vals = [_rel_max(card.log_prob(x.to(dev)).cpu(), cpu.log_prob(x))]
        if name != "GaussianKDE":
            vals.append(_rel_max(card.cdf(x.to(dev)).cpu(), cpu.cdf(x)))
        if name != "Censored":  # no moments, as in the JAX package
            vals.append(_rel_max(torch.as_tensor(card.mean()).cpu(), torch.as_tensor(cpu.mean())))
        rel[name] = max(vals)
    if not all(v <= 1e-12 for v in rel.values()):
        raise AssertionError(f"17e: card vs CPU tensors {rel}")
    log(f"[17e predictive, check, expfam, mixtures] NS of tests/test_vi.py's conjugate Normal model (known sigma 1; "
        f"pool {ns_pool}, {ns_delete} deletions, ESS {ess:.0f}): predictive mean - exact {m_err:+.2e}, variance - "
        f"exact {v_err:+.2e} (4 NS se {4 * math.sqrt(v / ess):.2e}, {4 * v * math.sqrt(2 / ess):.2e}); predictive "
        f"check of the mean, {replicates} replicates: p {float(p):.4f}; expfam NORMAL vs the conjugate engine's "
        f"predictive {ef:.2e}; card vs CPU tensors {', '.join(f'{k} {v:.2e}' for k, v in rel.items())}; "
        f"{time.perf_counter() - t0:.1f} s | {smi}")


def phase_consumption(smi: str, gp_problem, gp_posterior, dev="cuda", **sizes):
    """Phase 17: the consumption layer (module docstring).  ``sizes``
    shrink 17a-e for a rehearsal (``families``, ``scores``, ``tp``,
    ``rest``: keyword arguments of each sub-phase)."""
    dev = torch.device(dev)
    res = gp_posterior[0]
    t0 = time.perf_counter()
    seconds, total = [], {"se_covariance": 0, "cholesky": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    with _KernelWatch() as watch:
        t = time.perf_counter()
        _phase17_families(smi, dev, **sizes.get("families", {}))
        seconds.append(f"17a {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        launches, xq, _ = _phase17_gp_scores(smi, watch, dev, gp_problem, gp_posterior,
                                                   **sizes.get("scores", {}))
        add(launches)
        seconds.append(f"17b {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        add(_phase17_regression(smi, watch, dev, gp_problem, res, xq))
        seconds.append(f"17c {time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        add(_phase17_tp_quantiles(smi, watch, dev, res, xq, **sizes.get("tp", {})))
        seconds.append(f"17d {time.perf_counter() - t:.1f}")
        if not (total["se_covariance"] > 0 and total["cholesky"] > 0):
            raise AssertionError(f"17: launches {total}")
        t = time.perf_counter()
        _phase17_rest(smi, dev, res, **sizes.get("rest", {}))
        seconds.append(f"17e {time.perf_counter() - t:.1f}")
        log(f"[17 consumption layer] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches {total}; "
            f"{watch.check('17')}")
    return total


# --------------------------------------------------------------------------
# Phase 18: the quasi-Bayesian networks and RealNVP flow VI
# --------------------------------------------------------------------------

BNN_N = 256  # tests/test_bnn.py::test_bnn_end_to_end's data
# 18a's configurations: (name, net keywords, training keywords); the first is
# the reference's defaults (bnn/nets.py, bnn/predict.py), the second the JAX
# test's own
BNN_CONFIGS = (
    ("defaults (depth 4, width 100, p 0.25, k 10, lr 1e-3)", {},
     dict(alpha=0.5, sample_number=10, num_steps=2000, learning_rate=1e-3)),
    ("tests/test_bnn.py (depth 2, width 48, p 0.1, k 5, lr 3e-3)",
     dict(depth=2, layer_size=48, dropout_probability=0.1),
     dict(alpha=0.5, sample_number=5, num_steps=1500, learning_rate=3e-3)),
)
FLOW_GP_STEPS = 1000  # hmc_sample's flow start; the JAX default is 3000
FLOW_GP_B = 64  # flow_vi_fit's num_elbo_samples
FLOW_GP_FINAL = 8192  # flow_vi_fit's final_evidence_samples, in chunks of vi.EVAL_CHUNK


def _sine_data(n=BNN_N):
    """tests/test_bnn.py::test_bnn_end_to_end's x on [-2, 2] and y = sin 2x + 0.1 noise (float32)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(n, 1)).astype(np.float32)
    return x, np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n).astype(np.float32)


def _bnn_gates(net, trained, init, x, y, g, what):
    """tests/test_bnn.py::test_bnn_end_to_end's gates on a trained net:
    (mean |error|, min sd, 3-sigma coverage, lz_init, lz_trained)."""
    from bayesianinference_tpu_torch import bnn

    xq = torch.linspace(-1.8, 1.8, 31, device=x.device, dtype=torch.float32)[:, None]
    pred = bnn.sample_trained_net(net, trained.params, g, xq, num_samples=200)
    mean, sd = pred.mean(), pred.std()
    err = (mean - torch.sin(2 * xq[:, 0])).abs()
    mae, min_sd, cover = float(err.mean()), float(sd.min()), float((err < 3 * sd).float().mean())
    lz = [float(bnn.network_log_evidence(net, p, g, x, y, lambda2=0.0, alpha=0.5, sample_number=20))
          for p in (init, trained.params)]
    first, last = float(trained.history[:100].mean()), float(trained.history[-100:].mean())
    if not (last < first and mae < 0.2 and min_sd > 0.03 and cover > 0.9 and math.isfinite(lz[1]) and lz[1] > lz[0]):
        raise AssertionError(f"18a BNN {what}: loss {first} -> {last}, mean |error| {mae}, min sd {min_sd}, "
                             f"coverage {cover}, log evidence {lz[0]} -> {lz[1]}")
    return mae, min_sd, cover, lz[0], lz[1], first, last


def _bnn_card_vs_cpu(dev):
    """The default net's forward pass, alpha-divergence loss (k = 10) and
    gradient on the card against CPU tensors on the same masks and
    parameters: (float64 worst relative error, float32 worst)."""
    from bayesianinference_tpu_torch import bnn

    out = {}
    x_np, y_np = _sine_data()
    for dtype in (torch.float64, torch.float32):
        g = torch.Generator().manual_seed(5)
        x, y = torch.as_tensor(x_np, dtype=dtype), torch.as_tensor(y_np, dtype=dtype)
        net = bnn.regression_net()
        params = net.init(g, x[:1])
        masks = net.draw_masks(g, BNN_N, 10, dtype=dtype)
        vals = []
        for d in (dev, torch.device("cpu")):
            p = {k: v.to(d).requires_grad_(True) for k, v in params.items()}
            fwd = net(x.to(d), [m.to(d) for m in masks], params=p)
            loss = bnn.regression_loss(net, p, None, x.to(d), y.to(d), alpha=0.5, sample_number=10,
                                       masks=[m.to(d) for m in masks])
            vals.append([fwd.detach(), loss.detach(), *torch.autograd.grad(loss, list(p.values()))])
        out[dtype] = max(_rel_max(a.cpu(), b) for a, b in zip(*vals))
    if not (out[torch.float64] <= 1e-12 and out[torch.float32] <= 1e-5):
        raise AssertionError(f"18a BNN card vs CPU: {out}")
    return out[torch.float64], out[torch.float32]


def _phase18_bnn(smi, dev, configs=BNN_CONFIGS):
    """18a: the quasi-Bayesian net trained on the card in float32 at the
    reference's defaults and at the JAX test's configuration, each under
    test_bnn_end_to_end's gates; card against CPU tensors."""
    from bayesianinference_tpu_torch import bnn

    x_np, y_np = _sine_data()
    x, y = torch.as_tensor(x_np, device=dev), torch.as_tensor(y_np, device=dev)
    lines = []
    for what, net_kw, train_kw in configs:
        g = torch.Generator(device=dev).manual_seed(0)
        net = bnn.regression_net(**net_kw)
        init = net.init(g, x[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = bnn.train_regression_net(net, g, x, y, initial_params=init, **train_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mae, min_sd, cover, lz0, lz1, first, last = _bnn_gates(net, trained, init, x, y, g, what)
        lines.append(f"{what}, {train_kw['num_steps']} steps: {wall:.1f} s = {1e3 * wall / train_kw['num_steps']:.2f} "
                     f"ms a step; loss {first:.4f} -> {last:.4f}; mean |error| {mae:.4f} (< 0.2), min sd {min_sd:.4f} "
                     f"(> 0.03), 3-sigma coverage {cover:.3f} (> 0.9), log evidence {lz0:.4f} -> {lz1:.4f}")
    e64, e32 = _bnn_card_vs_cpu(dev)
    log(f"[18a BNN] f32 on the card, n = {BNN_N} of test_bnn_end_to_end's data, alpha 0.5 (beside 18b's "
        f"workers): {'; '.join(lines)}; card vs CPU tensors on the same masks (forward, loss, gradient at the "
        f"defaults): f64 {e64:.2e} (1e-12), f32 {e32:.2e} (1e-5) | {smi}")


def _banana_problem(dev):
    """tests/test_flow_vi.py's banana and its grid-quadrature logZ."""
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    problem = define_inference_problem(
        parameters=[("a", -6.0, 6.0), ("b", -4.0, 12.0)],
        log_likelihood=lambda th: -0.5 * (th[0] ** 2 / 4.0 + 4.0 * (th[1] - th[0] ** 2 / 2.0) ** 2),
        prior_distribution=["location", "location"], validate=False, device=dev, dtype=torch.float64)
    xs, ys = np.linspace(-6, 6, 2001), np.linspace(-4, 12, 2001)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    f = np.exp(-0.5 * (xx**2 / 4.0 + 4.0 * (yy - xx**2 / 2.0) ** 2))
    return problem, float(np.log(np.trapezoid(np.trapezoid(f, ys, axis=1), xs)) - np.log(12.0 * 16.0))


def _phase18b_job(job: str, dev: str, steps: dict) -> dict:
    """One of 18b's independent fits, in a worker process of its own (the
    fits are host-bound loops of eager steps; processes run them on separate
    cores): the readings its gates need, as Python numbers.  None of these
    problems reaches a hand-written kernel, and the worker fails if one
    launched: kernel work belongs in the main process, under the watch and
    the launch counters."""
    from bayesianinference_tpu_torch.engines.flow_vi import flow_vi_fit
    from bayesianinference_tpu_torch.engines.hmc import hmc_sample
    from bayesianinference_tpu_torch.engines.vi import advi_fit
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device(dev)
    t0 = time.perf_counter()
    if job == "conjugate":
        problem, _, pm, psd, log_z = _normal_model(dev)
        g = torch.Generator(device=dev).manual_seed(0)
        r = flow_vi_fit(problem, g, num_steps=steps["conj"])
        s = r.sample(g, 20000)[:, 0]
        peak = float(r.log_prob(torch.tensor([pm], device=dev))) > float(
            r.log_prob(torch.tensor([pm + 2 * psd], device=dev)))
        out = dict(mean=float(s.mean()), sd=float(s.std()), elbo=float(r.elbo), lz=float(r.log_evidence),
                   k=float(r.pareto_k), peak_over_tail=peak, pm=pm, psd=psd, log_z=log_z)
    elif job == "box":
        from bayesianinference_tpu_torch.dists.scalar import Normal
        from bayesianinference_tpu_torch.models.problem import define_inference_problem

        data = np.random.default_rng(0).normal(0.0, 0.7, 60)
        problem = define_inference_problem(parameters=[("sigma", 0.05, 5.0)], likelihood=lambda th: Normal(0.0, th[0]),
                                           data=torch.as_tensor(data, device=dev), prior_distribution=["scale"],
                                           validate=False)
        r = flow_vi_fit(problem, torch.Generator(device=dev).manual_seed(0), num_steps=steps["box"])
        s = r.sample(torch.Generator(device=dev).manual_seed(1), 5000)[:, 0]
        out = dict(lo=float(s.min()), hi=float(s.max()), mean=float(s.mean()))
    elif job == "banana_flow":
        banana, z = _banana_problem(dev)
        fl = flow_vi_fit(banana, torch.Generator(device=dev).manual_seed(0), num_steps=steps["banana"],
                         learning_rate=2e-3)
        sb = fl.sample(torch.Generator(device=dev).manual_seed(3), 20000)
        out = dict(elbo=float(fl.elbo), lz=float(fl.log_evidence), k=float(fl.pareto_k), grid_z=z,
                   resid_sd=float((sb[:, 1] - sb[:, 0] ** 2 / 2.0).std()), a_sd=float(sb[:, 0].std()))
    elif job == "banana_advi":
        banana, _ = _banana_problem(dev)
        fr = advi_fit(banana, torch.Generator(device=dev).manual_seed(0), family="fullrank", num_steps=steps["advi"])
        out = dict(elbo=float(fr.elbo))
    else:  # "hmc_flow"
        banana, _ = _banana_problem(dev)
        h = hmc_sample(banana, torch.Generator(device=dev).manual_seed(0), num_chains=8, num_samples=50,
                       num_warmup=steps["hmc_warmup"], num_leapfrog=16, starting_points="flow")
        draws = h.samples.reshape(-1, 2)
        out = dict(finite=bool(torch.isfinite(draws).all()), resid=float((draws[:, 1] - draws[:, 0] ** 2 / 2.0).mean()))
    if gk.se_covariance_cuda.launches or gk.cholesky_cuda.launches:
        raise AssertionError(f"18b {job}: a hand-written kernel launched in a worker process")
    return {**out, "seconds": time.perf_counter() - t0}


def _phase18b_start(dev, pmmh=None, dns=None, mesh_ns=None, conj_steps=2000, box_steps=1500, banana_steps=4000,
                    advi_steps=3000, hmc_warmup=100):
    """Starts 18b: tests/test_flow_vi.py's oracles on the card (the
    conjugate posterior and evidence, the box-and-scale test, the banana
    against full-rank ADVI with the slow test's gates, HMC from a flow start
    on the banana), the five fits in five worker processes; before them, in
    the same pool, 19c's PMMH oracle (:func:`_pmmh_oracle`, keyword
    arguments ``pmmh``) unless ``pmmh`` is None, and after them 20e's run
    (:func:`_dns_oracle`, keyword arguments ``dns``) unless ``dns`` is
    None, then 21h's runs (:func:`_mesh_ns_oracle`, keyword arguments
    ``mesh_ns``) unless ``mesh_ns`` is None: (pool, pending result, sizes,
    the PMMH oracle's, 20e's and 21h's pending results or None)."""
    steps = dict(conj=conj_steps, box=box_steps, banana=banana_steps, advi=advi_steps, hmc_warmup=hmc_warmup)
    pool = multiprocessing.get_context("spawn").Pool(5)
    pmmh_pending = None if pmmh is None else pool.apply_async(_pmmh_oracle, (str(dev),), pmmh)
    jobs = ("banana_flow", "conjugate", "box", "banana_advi", "hmc_flow")  # the longest first
    fits = pool.starmap_async(_phase18b_job, [(job, str(dev), steps) for job in jobs])
    dns_pending = None if dns is None else pool.apply_async(_dns_oracle, (str(dev),), dns)
    mesh_pending = None if mesh_ns is None else pool.apply_async(_mesh_ns_oracle, (str(dev),), mesh_ns)
    return pool, fits, steps, pmmh_pending, dns_pending, mesh_pending


def _phase18b_finish(smi, pending, steps):
    """18b's gates on the workers' readings."""
    bf, c, box, ba, h = pending.get()
    if not (abs(c["mean"] - c["pm"]) <= 0.02 and abs(c["sd"] / c["psd"] - 1) <= 0.1
            and c["log_z"] - 0.1 < c["elbo"] < c["log_z"] + 0.02 and c["k"] < 0.7
            and abs(c["lz"] - c["log_z"]) <= 0.03 and c["peak_over_tail"]):
        raise AssertionError(f"18b flow conjugate: {c}")
    if not (box["lo"] > 0.05 and box["hi"] < 5.0 and abs(box["mean"] - 0.7) <= 0.1):
        raise AssertionError(f"18b flow box and scale: {box}")
    if not (bf["elbo"] > ba["elbo"] + 0.2 and bf["k"] < 0.7 and abs(bf["lz"] - bf["grid_z"]) <= 0.05
            and abs(bf["resid_sd"] / 0.5 - 1) <= 0.2 and abs(bf["a_sd"] / 2.0 - 1) <= 0.2):
        raise AssertionError(f"18b flow banana: {bf}; fullrank ADVI {ba}")
    if not (h["finite"] and abs(h["resid"]) < 0.3):
        raise AssertionError(f"18b HMC from a flow start: {h}")
    log(f"[18b flow VI oracles] five fits at once in worker processes (seconds each include the others' load): "
        f"conjugate Normal, {steps['conj']} steps: mean {c['mean']:.4f} (exact {c['pm']:.4f}), sd {c['sd']:.4f} "
        f"({c['psd']:.4f}), ELBO {c['elbo']:.4f}, PSIS logZ {c['lz']:.4f} (exact {c['log_z']:.4f}), k {c['k']:.3f}, "
        f"{c['seconds']:.1f} s; box and scale, {steps['box']} steps: draws in [{box['lo']:.4f}, {box['hi']:.4f}] "
        f"(inside [0.05, 5]), mean {box['mean']:.4f} (0.7 +- 0.1), {box['seconds']:.1f} s; banana, {steps['banana']} "
        f"steps at lr 2e-3: ELBO {bf['elbo']:.4f} against fullrank ADVI's {ba['elbo']:.4f} ({steps['advi']} steps, "
        f"{ba['seconds']:.1f} s), PSIS logZ {bf['lz']:.4f} (grid {bf['grid_z']:.4f}), k {bf['k']:.3f}, residual sd "
        f"{bf['resid_sd']:.4f} (0.5), a sd {bf['a_sd']:.4f} (2.0), {bf['seconds']:.1f} s; HMC from a flow start (8 "
        f"chains, {steps['hmc_warmup']} warmup, 50 samples, 16 leapfrog): residual mean {h['resid']:+.4f} (|.| < 0.3), "
        f"{h['seconds']:.1f} s | {smi}")


def _phase18_flow_gp(smi, watch, dev, problem, grid_logz, steps=FLOW_GP_STEPS, batch=FLOW_GP_B,
                     final=FLOW_GP_FINAL):
    """18c: flow VI on phase 4's GP problem through both kernels and both
    reverse rules (B = 64 a step, the final batch in chunks of
    vi.EVAL_CHUNK), under its PSIS and ELBO gates against phase 4's grid
    logZ."""
    from bayesianinference_tpu_torch.engines.flow_vi import flow_vi_fit
    from bayesianinference_tpu_torch.engines.vi import EVAL_CHUNK

    watch.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = flow_vi_fit(problem, torch.Generator(device=dev).manual_seed(0), num_steps=steps, num_elbo_samples=batch,
                    final_evidence_samples=final)
    elbo, lz, pk = float(r.elbo), float(r.log_evidence), float(r.pareto_k)
    wall = time.perf_counter() - t0
    launches = watch.counts()
    if min(launches.values()) < steps + final // EVAL_CHUNK:
        raise AssertionError(f"18c flow VI GP: launches {launches} for {steps} steps")
    if not (pk < 0.7 and abs(lz - grid_logz) <= 0.05 and elbo <= grid_logz + 0.02):
        raise AssertionError(f"18c flow VI GP: PSIS logZ {lz}, ELBO {elbo} against the grid logZ {grid_logz}, k {pk}")
    log(f"[18c flow VI GP] phase 4's problem (n={SLICE_N} d={SLICE_D} f64), {steps} steps (the JAX default 3000 cut "
        f"to hmc_sample's flow start), {batch} draws a step through both kernels and both reverse rules, the final "
        f"{final} in chunks of {EVAL_CHUNK}: PSIS logZ {lz:.4f} against the grid logZ {grid_logz:.4f} (off by "
        f"{lz - grid_logz:+.4f}, gate 0.05), k {pk:.3f} (< 0.7), ELBO {elbo:.4f} (gap {grid_logz - elbo:.4f}); "
        f"{wall:.1f} s = {1e3 * wall / steps:.2f} ms a step beside 18b's workers; launches {launches} | {smi}")
    return launches


def phase_flow_bnn(smi: str, gp_problem, gp_posterior, dev="cuda", pmmh=None, dns=None, mesh_ns=None, **sizes):
    """Phase 18: the quasi-Bayesian networks and flow VI (module
    docstring).  18b's five fits run in worker processes while 18a and 18c
    run here.  ``pmmh`` (keyword arguments of :func:`_pmmh_oracle`, or
    None) puts 19c's PMMH oracle in the same pool first, ``dns`` (of
    :func:`_dns_oracle`, or None) 20e's run after the fits and ``mesh_ns``
    (of :func:`_mesh_ns_oracle`, or None) 21h's after that.  ``sizes``
    shrink 18a-c for a rehearsal (``bnn`` (``configs=``), ``oracles``,
    ``gp``: keyword arguments of each sub-phase).  Returns (launches,
    None), or with any of those runs (launches, (pool, the PMMH oracle's
    pending result, 20e's, 21h's)): the pool stays open for phases 19-21;
    the caller closes it."""
    dev = torch.device(dev)
    grid_logz = gp_posterior[1]
    t0 = time.perf_counter()
    seconds = []
    pool, pending, steps, pmmh_pending, dns_pending, mesh_pending = _phase18b_start(dev, pmmh, dns, mesh_ns,
                                                                                    **sizes.get("oracles", {}))
    try:
        with _KernelWatch() as watch:
            t = time.perf_counter()
            _phase18_bnn(smi, dev, **sizes.get("bnn", {}))
            seconds.append(f"18a {time.perf_counter() - t:.1f}")
            t = time.perf_counter()
            total = _phase18_flow_gp(smi, watch, dev, gp_problem, grid_logz, **sizes.get("gp", {}))
            seconds.append(f"18c {time.perf_counter() - t:.1f}")
            if not (total["se_covariance"] > 0 and total["cholesky"] > 0):
                raise AssertionError(f"18: launches {total}")
            t = time.perf_counter()
            _phase18b_finish(smi, pending, steps)
            seconds.append(f"18b waited {time.perf_counter() - t:.1f}")
            log(f"[18 BNN and flow VI] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches {total}; "
                f"{watch.check('18')}")
    except BaseException:
        pool.terminate()
        pool.join()
        raise
    if pmmh_pending is None and dns_pending is None and mesh_pending is None:
        pool.close()
        pool.join()
        return total, None
    return total, (pool, pmmh_pending, dns_pending, mesh_pending)

# ---------------------------------------------------------------------------
# Phase 19: the time-series engines (no hand-written kernel on this path)

TS_THETA = (0.1, 0.05, 0.3)  # benchmarks/kalman_throughput.py::bench_vmapped's generating values
TS_FIT = (0.12, 0.04, 0.35)  # and its long series' model
F32_FLOOR = 1e-6  # PERF.md section 2: an f32 case may err at most twice the CPU f32 path plus this, relative


def _ts_builder(th):
    """Level plus period-4 seasonal (ds = 4): benchmarks/kalman_throughput.py::_builder."""
    from bayesianinference_tpu_torch.engines import ssm

    return ssm.structural_lgssm([ssm.level_component(th[0]), ssm.seasonal_component(4, th[1])], obs_var=th[2])


def _f32_gate(what, card32, cpu32, cpu64) -> str:
    """The card's float32 error against the CPU's float64 at most twice the
    CPU's float32 error plus F32_FLOOR, each relative to max |float64|."""
    e_card, e_cpu = _rel_max(card32, cpu64), _rel_max(cpu32, cpu64)
    if not e_card <= 2.0 * e_cpu + F32_FLOOR:
        raise AssertionError(f"{what}: card f32 error {e_card:.2e} against CPU f32 {e_cpu:.2e}")
    return f"f32 err card {e_card:.2e} (CPU {e_cpu:.2e})"


def _card_cpu_gate(what, pairs, tol=1e-12) -> float:
    """Each (card, cpu) pair within ``tol`` of max(|cpu|, 1); the worst."""
    worst = 0.0
    for i, (got, want) in enumerate(pairs):
        got, want = got.detach().double().cpu(), want.detach().double().cpu()
        err = float((got - want).abs().max() / want.abs().max().clamp(min=1.0))
        if not err <= tol:
            raise AssertionError(f"{what}: card against CPU {err:.2e} > {tol} at output {i}")
        worst = max(worst, err)
    return worst


@_measuring
def _call_row(name, fn, units: int, unit: str) -> str:
    """Wall ms (one call after a warm-up), device ms and CUDA kernels of one
    call (torch.profiler, CUDA activity only), busy share and units/s."""
    wall = _wall_ms(fn, reps=1)
    dev_ms, kernels = _profile_call(fn, cpu=False, warm=False)
    return (f"{name}: wall {wall:.2f} ms, device {dev_ms:.2f} ms, {kernels} CUDA kernels, busy share "
            f"{dev_ms / wall:.3f}, {units / wall * 1e3:.0f} {unit}/s")


@_measuring
def _unit_row(name, run, wall_ms=None) -> str:
    """One unit's device ms and CUDA kernels by difference of ``run(2)`` and
    ``run(1)`` under torch.profiler (CUDA activity only: the host events of
    tens of thousands of kernels take seconds to build); its wall ms by the
    same difference (``wall_ms``: taken already), and the busy share."""
    d1, k1 = _profile_call(lambda: run(1), cpu=False)
    d2, k2 = _profile_call(lambda: run(2), cpu=False)
    if wall_ms is None:
        wall_ms = _wall_ms(lambda: run(2), reps=1) - _wall_ms(lambda: run(1), reps=1)
    if not (d2 > d1 and k2 > k1):
        raise AssertionError(f"{name}: per unit device {d2 - d1} ms, {k2 - k1} CUDA kernels")
    busy = (d2 - d1) / wall_ms if wall_ms > 0 else math.nan  # a wall difference lost in the host's noise
    return (f"{name}: wall {wall_ms:.2f} ms, device {d2 - d1:.3f} ms, {k2 - k1} CUDA kernels, busy share "
            f"{busy:.3f}")


class _Lines(list):
    """A sub-phase's report lines, each ending in the seconds it took since
    the line before."""

    def __init__(self):
        super().__init__()
        self.t = time.perf_counter()

    def append(self, line: str) -> None:
        t, self.t = self.t, time.perf_counter()
        super().append(f"{line} [{self.t - t:.1f} s]")


def _ts_random_model(dev, seed=0):
    from bayesianinference_tpu_torch.ops import kalman

    rng = np.random.default_rng(seed)
    ds, do = 3, 2
    f = 0.6 * np.eye(ds) + 0.1 * rng.normal(size=(ds, ds))
    qh, rh, ph = rng.normal(size=(ds, ds)), rng.normal(size=(do, do)), rng.normal(size=(ds, ds))
    arrays = (f, qh @ qh.T / ds + 0.3 * np.eye(ds), rng.normal(size=(do, ds)), rh @ rh.T / do + 0.2 * np.eye(do),
              rng.normal(size=ds), ph @ ph.T / ds + 0.5 * np.eye(ds), 0.1 * rng.normal(size=ds),
              0.2 * rng.normal(size=do))
    return kalman.LGSSM(*(torch.as_tensor(a, device=dev) for a in arrays))


def _phase19a_kalman(smi, dev, chains=8192, t_bench=256, t_long=131072, t_par=4097, ref_chains=256,
                     level_t=400, times=False):
    from bayesianinference_tpu_torch.engines import ssm
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.ops import kalman

    cpu = torch.device("cpu")
    lines = _Lines()
    # card against CPU, f64, on the same inputs
    models = {d: _ts_random_model(d) for d in (dev, cpu)}
    y = torch.as_tensor(np.random.default_rng(1).normal(size=(64, 2)))
    mask = torch.ones(64, dtype=torch.bool)
    mask[[3, 17, 63]] = False
    draws = kalman.kalman_sample_draws(torch.Generator().manual_seed(2), models[cpu], 64, (16,))
    res = {}
    for d, m in models.items():
        out = []
        # the simulation smoother's factors come from eigh, whose eigenvector
        # signs LAPACK and cuSOLVER may pick apart: it runs on a model with
        # distinct diagonal noise, where both return the same factor
        diag = m._replace(transition_noise=torch.diag(torch.diagonal(m.transition_noise)),
                          observation_noise=torch.diag(torch.diagonal(m.observation_noise)),
                          initial_cov=torch.diag(torch.diagonal(m.initial_cov)))
        for method in ("sequential", "parallel"):
            out += list(kalman.kalman_filter(m, y.to(d), mask.to(d), method))
            out += list(kalman.kalman_smoother(m, y.to(d), mask.to(d), method))
            out.append(kalman.simulation_smoother(None, diag, y.to(d), 16, mask.to(d), method,
                                                  kalman.KalmanSampleDraws(*(a.to(d) for a in draws))))
        out += list(kalman.kalman_forecast(m, kalman.kalman_filter(m, y.to(d)), 6))
        res[d] = out
    worst = _card_cpu_gate("19a card against CPU", zip(res[dev], res[cpu]))
    lines.append(f"filter, smoother, simulation smoother (both methods, 3 masked steps; the latter with diagonal "
                 f"noise) and forecast, card against CPU f64 {worst:.1e} (1e-12)")
    # parallel against sequential at T = t_par, on the card in f64
    gen = torch.Generator(device=dev).manual_seed(3)
    model = _ts_builder(torch.tensor(TS_FIT, dtype=torch.float64, device=dev))
    _, yp = kalman.kalman_sample(gen, model, t_par)
    seq, par = kalman.kalman_filter(model, yp), kalman.kalman_filter(model, yp, method="parallel")
    e_ll = abs(float(par.log_likelihood - seq.log_likelihood)) / abs(float(seq.log_likelihood))
    e_m = _rel_max(par.filtered_means, seq.filtered_means)
    e_v = _rel_max(par.filtered_covs, seq.filtered_covs)
    if not max(e_ll, e_m, e_v) <= 1e-10:
        raise AssertionError(f"19a parallel against sequential at T = {t_par}: {e_ll:.1e} {e_m:.1e} {e_v:.1e}")
    lines.append(f"parallel against sequential at T = {t_par} f64: logL {e_ll:.1e}, means {e_m:.1e}, covs {e_v:.1e}"
                 " (1e-10)")

    # benchmarks/kalman_throughput.py's engine width, f32
    g = torch.Generator().manual_seed(0)
    gen_model = _ts_builder(torch.tensor(TS_THETA, dtype=torch.float64))
    y64 = kalman.kalman_sample(g, gen_model, t_bench)[1][:, 0]
    th64 = torch.exp(0.3 * torch.randn((chains, 3), generator=g, dtype=torch.float64)
                     + torch.log(torch.tensor(TS_THETA, dtype=torch.float64)))
    params = [("level_var", 1e-6, 10.0), ("seasonal_var", 1e-6, 10.0), ("obs_var", 1e-6, 10.0)]
    for method in ("sequential", "parallel"):
        def problem(d, dtype):
            return ssm.define_state_space_model(y64.to(d, dtype), _ts_builder, params, method=method,
                                                prior_distribution=["scale"] * 3, validate=False)

        card = problem(dev, torch.float32)
        th_card = th64.to(dev, torch.float32)
        got = card.log_posterior_density(th_card)
        refs = [problem(cpu, dt).log_posterior_density(th64[:ref_chains].to(dt)) for dt in (torch.float32,
                                                                                            torch.float64)]
        gate = _f32_gate(f"19a {method} at the engine width", got[:ref_chains], *refs)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"19a {method}: non-finite density at the engine width")
        row = _call_row(f"{method} density call, {chains} chains, T = {t_bench}, ds = 4 f32",
                        lambda: card.log_posterior_density(th_card), chains, "evals") if times else method
        lines.append(f"{row}; {gate} on {ref_chains} chains")
    # the long series, parallel only
    yl64 = kalman.kalman_sample(torch.Generator().manual_seed(4), gen_model, t_long)[1][:, 0]
    fit_model = _ts_builder(torch.tensor(TS_FIT, dtype=torch.float64))
    long = {}
    for d, dt in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
        m = kalman.LGSSM(*(None if a is None else a.to(d, dt) for a in fit_model))
        long[(d.type, dt)] = (m, yl64.to(d, dt), kalman.kalman_log_likelihood(m, yl64.to(d, dt), method="parallel"))
    gate = _f32_gate("19a long series", long[(dev.type, torch.float32)][2], long[("cpu", torch.float32)][2],
                     long[("cpu", torch.float64)][2])
    m32, y32, _ = long[(dev.type, torch.float32)]
    timed = ""
    if times:
        wall = _wall_ms(lambda: kalman.kalman_log_likelihood(m32, y32, method="parallel"), reps=1)
        timed = f"{wall:.1f} ms, {t_long / wall * 1e3:.3g} steps/s; "
    lines.append(f"long series T = {t_long} f32, parallel: {timed}{gate}")

    # the local-level problem of tests/test_ssm.py:249-282, Laplace through the parallel method
    truth = ssm.structural_lgssm([ssm.level_component(torch.tensor(0.3, dtype=torch.float64))], obs_var=0.8)
    yll = kalman.kalman_sample(torch.Generator().manual_seed(7), truth, level_t)[1][:, 0]
    fits = {}
    for d in (dev, cpu):
        p = ssm.define_state_space_model(
            yll.to(d), lambda th: ssm.structural_lgssm([ssm.level_component(th[0])], obs_var=th[1]),
            [("level_var", 1e-4, 10.0), ("obs_var", 1e-4, 10.0)], method="parallel",
            prior_distribution=["scale", "scale"], validate=False)
        t = time.perf_counter()
        fits[d.type] = (laplace_posterior_fit(problem=p, initial_guess=torch.tensor([[0.5, 0.5]], dtype=torch.float64,
                                                                                    device=d)),
                        time.perf_counter() - t, p)
    (fc, tc, pc), (fh, th_, _) = fits[dev.type], fits["cpu"]
    e_mode, e_z = _rel_max(fc.mean, fh.mean), abs(float(fc.log_evidence) - float(fh.log_evidence))
    lv, ov = fc.mean.tolist()
    if not (e_mode <= 1e-6 and e_z <= 1e-6 and 0.09 < lv < 0.9 and 0.4 < ov < 1.6):
        raise AssertionError(f"19a Laplace: mode {fc.mean.tolist()} ({e_mode:.1e} from the CPU), logZ {e_z:.1e}")
    sm = ssm.smoothed_states(pc, fc.mean)
    fm, fv = ssm.forecast_observations(pc, fc.mean, 5)
    if not (sm.means.shape == (level_t, 1) and bool((sm.covs[:, 0, 0] > 0).all()) and float(fv[-1, 0, 0])
            > float(fv[0, 0, 0])):
        raise AssertionError("19a: smoothed states or forecast of the local level")
    lines.append(f"Laplace on the local level (T = {level_t}, parallel, 1 start): mode {lv:.4f}, {ov:.4f}, logZ "
                 f"{float(fc.log_evidence):.4f}; card against CPU mode {e_mode:.1e}, logZ {e_z:.1e} (1e-6); "
                 f"{tc:.1f} s on the card, {th_:.1f} s on the CPU")
    for line in lines:
        log(f"  19a {line}")


def _hmm_enumeration(pi, log_a, b):
    """Exact (ll, filtered, smoothed, MAP path) over all K^T paths
    (tests/test_hmm.py::_enumerate)."""
    t, k = b.shape
    joint = {}
    for path in itertools.product(range(k), repeat=t):
        joint[path] = pi[path[0]] + b[0, path[0]] + sum(log_a[path[s - 1], path[s]] + b[s, path[s]]
                                                        for s in range(1, t))
    ll = np.logaddexp.reduce(np.array(list(joint.values())))
    smoothed, filtered = np.zeros((t, k)), np.zeros((t, k))
    for p, lp in joint.items():
        for s in range(t):
            smoothed[s, p[s]] += np.exp(lp - ll)
    for s in range(t):
        pref = {}
        for p, lp in joint.items():  # prefix probabilities: sum the suffixes out
            pref.setdefault(p[:s + 1], pi[p[0]] + b[0, p[0]] + sum(log_a[p[u - 1], p[u]] + b[u, p[u]]
                                                                  for u in range(1, s + 1)))
        tot = np.logaddexp.reduce(np.array(list(pref.values())))
        for p, lp in pref.items():
            filtered[s, p[-1]] += np.exp(lp - tot)
    return ll, filtered, smoothed, np.array(max(joint, key=joint.get))


def _bocpd_enumeration(y, h, segment):
    """Exact (ll, run-length posteriors [T, T]) over all 2^(T-1)
    segmentations (tests/test_bocpd.py::_enumerate)."""
    rl = np.zeros((y.size, y.size))
    for t in range(1, y.size + 1):
        scores = {}
        for cfg in itertools.product([0, 1], repeat=t - 1):
            bounds = [0] + [s + 1 for s in range(t - 1) if cfg[s]] + [t]
            scores[cfg] = sum(c * np.log(h) + (1 - c) * np.log1p(-h) for c in cfg) + sum(
                segment(y[a:b]) for a, b in zip(bounds[:-1], bounds[1:]))
        tot = np.logaddexp.reduce(np.array(list(scores.values())))
        for cfg, lp in scores.items():
            rl[t - 1, t - 1 - max([0] + [s + 1 for s in range(t - 1) if cfg[s]])] += np.exp(lp - tot)
    return tot, rl


def _nig_segment(y, mu0=0.3, kappa0=2.0, alpha0=1.5, beta0=0.8):
    from math import lgamma

    n = y.size
    if n == 0:
        return 0.0
    kn, an, ybar = kappa0 + n, alpha0 + 0.5 * n, y.mean()
    bn = beta0 + 0.5 * np.sum((y - ybar) ** 2) + 0.5 * kappa0 * n * (ybar - mu0) ** 2 / kn
    return (lgamma(an) - lgamma(alpha0) + alpha0 * math.log(beta0) - an * math.log(bn)
            + 0.5 * (math.log(kappa0) - math.log(kn)) - 0.5 * n * math.log(2 * math.pi))


def _phase19b_hmm_bocpd(smi, dev, chains=8192, t_bench=256, k=4, t_long=131072, k_long=8, bocpd_t=8192,
                        r_max=512, ref_chains=256, times=False):
    import importlib

    from bayesianinference_tpu_torch.engines import changepoint, hmm
    from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu_torch.ops import hmm as ohmm

    ob = importlib.import_module("bayesianinference_tpu_torch.ops.bocpd")  # ops.bocpd is the function
    cpu = torch.device("cpu")
    lines = _Lines()
    # the enumeration oracles (tests/test_hmm.py:95-143, tests/test_bocpd.py:117-171) on the card, f64
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 2))
    log_a = ohmm.row_stochastic(torch.as_tensor(logits)).numpy()
    pi, b = np.log(rng.dirichlet(np.ones(3))), rng.normal(size=(6, 3))
    ll, filtered, smoothed, best = _hmm_enumeration(pi, log_a, b)
    chain = ohmm.HMM(torch.as_tensor(pi, device=dev), torch.as_tensor(log_a, device=dev))
    bt = torch.as_tensor(b, device=dev)
    errs = []
    for method in ("sequential", "parallel"):
        fr = ohmm.hmm_filter(chain, bt, method=method)
        errs += [abs(float(fr.log_likelihood) - ll) / abs(ll), _rel_max(torch.exp(fr.log_filtered), filtered)]
    errs.append(_rel_max(torch.exp(ohmm.hmm_smoother(chain, bt)), smoothed))
    if not (max(errs) <= 1e-12 and np.array_equal(ohmm.hmm_viterbi(chain, bt).cpu().numpy(), best)):
        raise AssertionError(f"19b HMM enumeration: {errs}")
    rng = np.random.default_rng(0)
    y8 = np.concatenate([rng.normal(0.0, 1.0, 4), rng.normal(3.0, 0.5, 4)])
    ll_b, rl_b = _bocpd_enumeration(y8, 0.15, _nig_segment)
    res = ob.bocpd(torch.as_tensor(y8, device=dev), ob.gaussian_upm(0.3, 2.0, 1.5, 0.8), 0.15)
    e_b = max(abs(float(res.log_likelihood) - ll_b) / abs(ll_b), _rel_max(torch.exp(res.log_run_length), rl_b))
    if not e_b <= 1e-12:
        raise AssertionError(f"19b BOCPD enumeration: {e_b:.1e}")
    lines.append(f"enumeration oracles on the card f64: HMM (K = 3, T = 6, both methods) {max(errs):.1e}, Viterbi "
                 f"equal; BOCPD (T = 8) {e_b:.1e} (1e-12)")

    # benchmarks/hmm_throughput.py's widths, f32
    def hmm_data(kk, t, seed=0):
        g = torch.Generator().manual_seed(seed)
        gen = ohmm.HMM(torch.full((kk,), -math.log(kk), dtype=torch.float64),
                       ohmm.row_stochastic(0.5 * torch.randn((kk, kk - 1), generator=g, dtype=torch.float64)))
        z = ohmm.hmm_sample_states(g, gen, t)
        mus = torch.linspace(-2.0, 2.0, kk, dtype=torch.float64)
        yy = mus[z] + 0.7 * torch.randn(t, generator=g, dtype=torch.float64)
        return -0.5 * ((yy[:, None] - mus) / 0.7) ** 2

    def chain_of(th, kk):
        return ohmm.HMM(torch.full((kk,), -math.log(kk), dtype=th.dtype, device=th.device),
                        ohmm.row_stochastic(th.reshape(kk, kk - 1)))

    lo64 = hmm_data(k, t_bench)
    th64 = 0.3 * torch.randn((chains, k * (k - 1)), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    params = [(f"l{i}", -6.0, 6.0) for i in range(k * (k - 1))]
    for method in ("sequential", "parallel"):
        def problem(d, dt):
            lo = lo64.to(d, dt)
            return hmm.define_hidden_markov_model(lambda th: (chain_of(th, k), lo), params, method=method,
                                                  prior_distribution=["location"] * len(params), validate=False,
                                                  device=d, dtype=dt)

        card, th_card = problem(dev, torch.float32), th64.to(dev, torch.float32)
        got = card.log_posterior_density(th_card)
        refs = [problem(cpu, dt).log_posterior_density(th64[:ref_chains].to(dt)) for dt in (torch.float32,
                                                                                            torch.float64)]
        gate = _f32_gate(f"19b HMM {method}", got[:ref_chains], *refs)
        row = _call_row(f"HMM {method} density call, K = {k}, {chains} chains, T = {t_bench} f32",
                        lambda: card.log_posterior_density(th_card), chains, "evals") if times else method
        lines.append(f"{row}; {gate} on {ref_chains} chains")
    # the long series, parallel only
    lol = hmm_data(k_long, t_long, seed=3)
    gen_l = chain_of(0.4 * torch.randn(k_long * (k_long - 1), generator=torch.Generator().manual_seed(3),
                                       dtype=torch.float64), k_long)
    long = {}
    for d, dt in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
        m = ohmm.HMM(*(a.to(d, dt) for a in gen_l))
        long[(d.type, dt)] = (m, lol.to(d, dt), ohmm.hmm_log_likelihood(m, lol.to(d, dt), method="parallel"))
    gate = _f32_gate("19b HMM long series", *(long[key][2] for key in ((dev.type, torch.float32),
                                                                       ("cpu", torch.float32),
                                                                       ("cpu", torch.float64))))
    m32, l32, _ = long[(dev.type, torch.float32)]
    timed = f"{_wall_ms(lambda: ohmm.hmm_log_likelihood(m32, l32, method='parallel'), reps=1):.1f} ms; " if times else ""
    lines.append(f"HMM long series T = {t_long}, K = {k_long} f32, parallel: {timed}{gate}")
    # BOCPD at benchmarks/hmm_throughput.py::bench_bocpd's width
    yb = torch.randn(bocpd_t, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    runs = {}
    for d, dt in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
        t = time.perf_counter()
        runs[(d.type, dt)] = ob.bocpd(yb.to(d, dt), ob.gaussian_upm(), 0.01, r_max=r_max)
        if d.type == "cuda":
            torch.cuda.synchronize()
        runs[(d.type, dt, "s")] = time.perf_counter() - t
    keys = ((dev.type, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64))
    gate_ll = _f32_gate("19b BOCPD logL", *(runs[key].log_likelihood for key in keys))
    gate_rl = _f32_gate("19b BOCPD run lengths", *(torch.exp(runs[key].log_run_length) for key in keys))
    lines.append(f"BOCPD T = {bocpd_t}, r_max = {r_max} f32: card {runs[(dev.type, torch.float32, 's')]:.2f} s "
                 f"(one call, {bocpd_t / runs[(dev.type, torch.float32, 's')]:.0f} steps/s); logL {gate_ll}; "
                 f"run-length probabilities {gate_rl}")
    # Laplace on the hazard problem of tests/test_bocpd.py:200-225
    rng = np.random.default_rng(3)
    yh = np.concatenate([rng.normal(m, 1.0, 25) for m in rng.normal(0, 3, 8)])
    fits = {}
    for d in (dev, cpu):
        p = changepoint.define_changepoint_model(torch.as_tensor(yh, device=d),
                                                 lambda th: (ob.gaussian_upm(0.0, 0.2, 2.0, 2.0), th[0]),
                                                 [("hazard", 1e-3, 0.5)], prior_distribution=["scale"],
                                                 validate=False)
        t = time.perf_counter()
        fits[d.type] = (laplace_posterior_fit(problem=p, initial_guess=torch.tensor([[0.05]], dtype=torch.float64,
                                                                                    device=d)),
                        time.perf_counter() - t)
    (fc, tc), (fh, th_) = fits[dev.type], fits["cpu"]
    e_mode, e_z = _rel_max(fc.mean, fh.mean), abs(float(fc.log_evidence) - float(fh.log_evidence))
    h = float(fc.mean[0])
    if not (0.01 < h < 0.15 and e_mode <= 1e-6 and e_z <= 1e-6):
        raise AssertionError(f"19b Laplace hazard {h} ({e_mode:.1e} from the CPU), logZ {e_z:.1e}")
    lines.append(f"Laplace on the hazard problem (T = 200, 1 start): hazard {h:.4f} (0.01-0.15), logZ "
                 f"{float(fc.log_evidence):.4f}; card against CPU mode {e_mode:.1e}, logZ {e_z:.1e} (1e-6); "
                 f"{tc:.1f} s on the card, {th_:.1f} s on the CPU")
    for line in lines:
        log(f"  19b {line}")


def _ar1_particle_model(phi, dev, q=0.3, r=0.4):
    """tests/test_particle.py::_ar1_particle_model on ``dev``, drawing from
    the generator it is handed."""
    from bayesianinference_tpu_torch.ops import particle as opf

    norm = -math.log(r) - 0.5 * math.log(2 * math.pi)

    def init(g, p):  # PMMH builds the model at every step: the stationary sd is computed here only
        return (q**2 / (1 - phi**2)) ** 0.5 * torch.randn((p, 1), generator=g, dtype=torch.float64, device=dev)

    def trans(g, x, t):
        return torch.add(phi * x, torch.randn(x.shape, generator=g, dtype=x.dtype, device=dev), alpha=q)

    def obs(x, y_t, t):
        return norm - (0.5 / r**2) * (y_t[0] - x[:, 0]) ** 2

    return opf.ParticleModel(init, trans, obs)


def _ar1_lgssm(phi, dev, q=0.3, r=0.4):
    from bayesianinference_tpu_torch.ops import kalman

    phi = torch.as_tensor(phi, dtype=torch.float64, device=dev).reshape(-1, 1, 1)
    one = torch.ones_like(phi)
    return kalman.LGSSM(phi, q**2 * one, one, r**2 * one, torch.zeros(phi.shape[:-1], dtype=torch.float64,
                                                                        device=dev), q**2 / (1 - phi**2))


def _ar1_data(dev):
    """tests/test_particle.py's AR(1) model (phi = 0.85) and its T = 150
    series [150, 1], drawn on ``dev`` from seed 0."""
    from bayesianinference_tpu_torch.ops import kalman

    truth = _ar1_lgssm(0.85, dev)
    return truth, kalman.kalman_sample(torch.Generator(device=dev).manual_seed(0), truth, 150)[1][0]


def _pmmh_run(dev, y, warmup, samples, generator, particles=512, chains=8):
    from bayesianinference_tpu_torch.engines import particle

    return particle.pmmh_sample(lambda th: _ar1_particle_model(th[0], dev), y, [("phi", 0.3, 0.99)], generator,
                                num_particles=particles, num_samples=samples, num_warmup=warmup, num_chains=chains)


def _pmmh_oracle(dev: str, pm_particles=512, pm_warmup=250, pm_samples=250, pm_chains=8) -> dict:
    """19c's PMMH run for the exact grid posterior (tests/test_particle.py:163-200):
    a host-bound loop of eager filter steps that reaches no hand-written
    kernel, so it runs in a worker process of 18b's pool beside phases 18
    and 19a-b (it fails if a kernel launched during the run).  Its series, draws,
    acceptance rates, sizes and seconds."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    dev = torch.device(dev)
    _, y = _ar1_data(dev)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    t0 = time.perf_counter()
    res = _pmmh_run(dev, y, pm_warmup, pm_samples, torch.Generator(device=dev).manual_seed(4), pm_particles,
                    pm_chains)
    draws = res.points[:, 0].cpu().numpy()
    seconds = time.perf_counter() - t0
    if (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches) != before:
        raise AssertionError("19c PMMH: a hand-written kernel launched")
    return dict(y=y.cpu().numpy(), draws=draws, acc=res.acceptance_rate.cpu().numpy(), seconds=seconds,
                sizes=(pm_chains, pm_particles, pm_warmup, pm_samples))


def _phase19c_particle(smi, dev, particles=4096, seeds=8, pmmh=None, times=False, **pm):
    """19c; ``pmmh`` is (pool, pending result) of :func:`_pmmh_oracle` run in
    18b's pool, or None to run it here with the keyword arguments ``pm``."""
    from bayesianinference_tpu_torch.ops import kalman
    from bayesianinference_tpu_torch.ops import particle as opf
    from bayesianinference_tpu_torch.ops import rbpf

    lines = _Lines()
    truth, y = _ar1_data(dev)
    exact = float(kalman.kalman_log_likelihood(truth, y[:, 0])[0])
    g = torch.Generator(device=dev).manual_seed(1)
    # the seeds' filters as one batch of independent filters of one model
    ests = opf.batched_log_likelihood(lambda th: _ar1_particle_model(0.85, dev), torch.zeros((seeds, 1), device=dev),
                                      y, particles, g, 0.5, None).cpu().numpy()
    if not (abs(ests.mean() - exact) < 0.25 and ests.std() < 0.3):
        raise AssertionError(f"19c bootstrap filter: {ests} against Kalman {exact}")
    lines.append(f"bootstrap filter at P = {particles} over {seeds} seeds: mean {ests.mean():.4f} against Kalman "
                 f"{exact:.4f} (0.25), sd {ests.std():.4f} (0.3)")
    # the degenerate RBPF is one Kalman filter (tests/test_rbpf.py:55)
    a2 = torch.tensor([[1.0, 1.0], [0.0, 1.0]], dtype=torch.float64, device=dev)
    q2 = torch.diag(torch.tensor([0.05, 0.01], dtype=torch.float64, device=dev))
    h2 = torch.tensor([[1.0, 0.0]], dtype=torch.float64, device=dev)
    r1, z2 = torch.tensor([[0.4]], dtype=torch.float64, device=dev), torch.zeros(2, dtype=torch.float64, device=dev)
    eye2 = torch.eye(2, dtype=torch.float64, device=dev)
    yr = torch.as_tensor(np.random.default_rng(0).normal(size=30), device=dev)
    exact_r = float(kalman.kalman_log_likelihood(kalman.LGSSM(a2, q2, h2, r1, z2, eye2), yr))
    degen = rbpf.RBPFModel(lambda gg, p: torch.zeros((p, 1), dtype=torch.float64, device=dev), lambda gg, u, t: u,
                           lambda u: (z2, eye2), lambda u, t: (a2, z2, q2), lambda u, t: (h2, z2[:1], r1))
    lls = [float(rbpf.rbpf_log_likelihood(degen, yr, 64, g)) for _ in range(4)]
    e_r = max(abs(v - exact_r) for v in lls) / abs(exact_r)
    if not e_r <= 1e-10:
        raise AssertionError(f"19c degenerate RBPF: {lls} against {exact_r}")
    lines.append(f"degenerate RBPF against Kalman: {e_r:.1e} (1e-10)")

    # PMMH against the exact grid posterior (tests/test_particle.py:163-200)
    if pmmh is None:
        out, where = _pmmh_oracle(str(dev), **pm), "here"
    else:
        pool, pending = pmmh
        t = time.perf_counter()
        try:
            out = pending.get()
        finally:
            pool.close()
            pool.join()
        where = (f"in a worker process of 18b's pool beside phases 18 and 19a-b, waited for "
                 f"{time.perf_counter() - t:.1f} s here")
    if not np.allclose(out["y"], y.cpu().numpy(), rtol=1e-12, atol=0.0):
        raise AssertionError("19c PMMH: the worker's series differs from this process's")
    draws, acc, wall = out["draws"], out["acc"], out["seconds"]
    pm_chains, pm_particles, pm_warmup, pm_samples = out["sizes"]
    grid = np.linspace(0.3, 0.99, 200)
    logl = kalman.kalman_log_likelihood(_ar1_lgssm(grid, dev), y[:, 0]).cpu().numpy()
    w = np.exp(logl - logl.max())
    w /= w.sum()
    mean_ref = float((grid * w).sum())
    sd_ref = float(np.sqrt(((grid - mean_ref) ** 2 * w).sum()))
    ok = (np.all(acc > 0.05) and np.all(acc < 0.7) and abs(draws.mean() - mean_ref) < 3.0 * sd_ref / np.sqrt(50)
          and abs(draws.std() / sd_ref - 1.0) < 0.35)
    if not ok:
        raise AssertionError(f"19c PMMH: acceptance {acc}, mean {draws.mean()} ({mean_ref}), sd {draws.std()} "
                             f"({sd_ref})")
    lines.append(f"PMMH ({pm_chains} chains, {pm_particles} particles, {pm_warmup} + {pm_samples} steps): mean "
                 f"{draws.mean():.4f} against the grid's {mean_ref:.4f} (gate {3.0 * sd_ref / np.sqrt(50):.4f}), sd "
                 f"ratio {draws.std() / sd_ref:.3f} (0.65-1.35), acceptance {acc.min():.3f}-{acc.max():.3f}; "
                 f"{wall:.1f} s, {wall / (pm_warmup + pm_samples) * 1e3:.1f} ms a step, {where}")
    if times:
        # a call of k steps runs k + 1 filters (the start's and the steps')
        # and little else: a call of 4 steps alone here gives the wall ms of
        # one, and half a one-step call's device ms and kernels are one step's
        def run(steps, seed):
            return _pmmh_run(dev, y, 0, steps, torch.Generator(device=dev).manual_seed(seed), pm_particles, pm_chains)

        dev_ms, kernels = _profile_call(lambda: run(1, 5), cpu=False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(4, 6)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) / 5 * 1e3
        lines.append(f"PMMH step ({pm_chains} chains x {pm_particles} particles, T = 150): wall {step_ms:.2f} ms "
                     f"(a 4-step call alone here, by its 5 filters), device {dev_ms / 2:.3f} ms, {kernels / 2:.0f} "
                     f"CUDA kernels, busy share {dev_ms / 2 / step_ms:.3f}")
    for line in lines:
        log(f"  19c {line}")


def _phase19d_ibis(smi, dev, particles=4096, batch=5, steps=20, times=False):
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.engines.ibis import ibis_sampler
    from bayesianinference_tpu_torch.models import define_inference_problem

    data = np.random.default_rng(0).normal(1.3, 1.0, size=60)  # tests/test_ibis.py's data
    tau = 2.0
    post_var = 1.0 / (1.0 / tau**2 + data.size)
    post_mean = post_var * data.sum()
    grid = np.linspace(-10, 10, 4001)
    ll = -0.5 * ((data[None, :] - grid[:, None]) ** 2).sum(1) - 0.5 * data.size * math.log(2 * math.pi)
    lp = -0.5 * (grid / tau) ** 2 - math.log(tau) - 0.5 * math.log(2 * math.pi)
    lz = float(np.logaddexp.reduce(ll + lp) + math.log(grid[1] - grid[0]))
    yd = torch.as_tensor(data, device=dev)
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)], log_likelihood=lambda th: dists.Normal(th[0], 1.0).log_prob(yd).sum(),
        prior_distribution=dists.Product((dists.Normal(torch.tensor(0.0, dtype=torch.float64, device=dev),
                                                       torch.tensor(tau, dtype=torch.float64, device=dev)),)),
        validate=False, device=dev, dtype=torch.float64)

    def pointwise(th, yy):
        return dists.Normal(th[0], 1.0).log_prob(yy)

    t = time.perf_counter()
    res = ibis_sampler(problem, pointwise, yd, torch.Generator(device=dev).manual_seed(1), n_particles=particles,
                       batch_size=batch, mcmc_steps=steps)
    w = torch.softmax(res.log_weights, 0).cpu().numpy()
    x = res.particles[:, 0].cpu().numpy()
    wall = time.perf_counter() - t
    mu = float((w * x).sum())
    var = float((w * (x - mu) ** 2).sum())
    acc = np.nanmean(res.acceptance_history.cpu().numpy())
    ok = (abs(float(res.log_evidence) - lz) < 0.2 and abs(float(res.log_predictives.sum() - res.log_evidence))
          <= 1e-10 * abs(lz) and abs(mu - post_mean) < 4 * math.sqrt(post_var / 1000)
          and abs(var / post_var - 1.0) < 0.2 and bool(res.resampled.any()) and not bool(res.resampled.all())
          and acc > 0.1)
    if not ok:
        raise AssertionError(f"19d IBIS: logZ {float(res.log_evidence)} ({lz}), mean {mu} ({post_mean}), var {var} "
                             f"({post_var}), resampled {res.resampled.tolist()}, acceptance {acc}")
    lines = _Lines()
    lines.append(f"IBIS ({particles} particles, batch {batch}, {steps} steps): logZ {float(res.log_evidence):.4f} against "
             f"{lz:.4f} (0.2), mean {mu:.4f} ({post_mean:.4f}), var ratio {var / post_var:.3f}, "
             f"{int(res.resampled.sum())} of {res.resampled.numel()} stages moved, acceptance {acc:.3f}; "
             f"{wall:.2f} s")
    if times:
        g2 = torch.Generator(device=dev).manual_seed(2)
        lines.append(_unit_row(f"IBIS stage with a move ({particles} particles, {steps} steps)",
                               lambda s: ibis_sampler(problem, pointwise, yd[:batch * s], g2, n_particles=particles,
                                                      batch_size=batch, mcmc_steps=steps, ess_threshold=2.0)))
    for line in lines:
        log(f"  19d {line}")


def phase_time_series(smi: str, pmmh=None, dev="cuda", **sizes):
    """Phase 19: the time-series engines (module docstring).  ``pmmh`` is
    phase 18's (pool, pending result) of 19c's PMMH oracle, or None to run
    it in 19c.  ``sizes`` shrink 19a-d for a rehearsal (``kalman``,
    ``hmm``, ``particle``, ``ibis``: keyword arguments of each sub-phase).
    No hand-written kernel lies on this path:
    the watch holds the launch counters at 0."""
    dev = torch.device(dev)
    t0 = time.perf_counter()
    seconds = []
    with _KernelWatch() as watch:
        watch.zero()
        for tag, fn, key in (("19a", _phase19a_kalman, "kalman"), ("19b", _phase19b_hmm_bocpd, "hmm"),
                             ("19c", functools.partial(_phase19c_particle, pmmh=pmmh), "particle"),
                             ("19d", _phase19d_ibis, "ibis")):
            t = time.perf_counter()
            fn(smi, dev, **sizes.get(key, {}))
            seconds.append(f"{tag} {time.perf_counter() - t:.1f}")
        total = watch.counts()
    if total["se_covariance"] or total["cholesky"]:
        raise AssertionError(f"19: a GP kernel launched on the time-series path: {total}")
    log(f"[19 time series] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches {total} "
        "(no GP kernel on this path)" + ("" if pmmh is None else "; 19c's PMMH oracle in a worker process"))
    return total


# ---------------------------------------------------------------------------
# Phase 20: the single-card parallel engines (parallel SMC, HMC, the ensemble,
# IBIS and dynamic NS); only the ensemble on phase 4's GP reaches the kernels
# (and HMC's dense mass the Cholesky)
# ---------------------------------------------------------------------------

PAR_HMC_MOMENTS = dict(chains=64, warmup=150, samples=100, leapfrog=5)  # 20b's moment run
PAR_ENS = dict(walkers=32, warmup=100, samples=600, batches=12)  # 20c's run on the GP slice
PAR_CARD_CPU_TOL = 1e-12  # 20a, 20b and 20d: the card against CPU tensors on the same draws, f64
# 20b-e: the 4-shard split run against the one-batch run on the same draws, f64: the reductions that cross
# shards (HMC's mean acceptance and moments, ChEES's chain means and sums, IBIS's logsumexp) run in another
# order, and the shards' kernels at another batch size (tests/test_torch_coupled_mesh.py)
PAR_SPLIT_TOL = 1e-10
PAR_SPLIT_HMC = dict(warmup=6, samples=3)  # 20b's split runs (60 + 40 for ChEES's card-vs-CPU gate)
PAR_GP_HMC = dict(chains=8, warmup=6, samples=2, leapfrog=3)  # 20b's GP-slice HMC on the mesh
PAR_ENS_CARD_CPU_TOL = 1e-10  # 20c: through both kernels, whose sums run in another order than the plain versions'


def _card_cpu_err(pairs) -> float:
    """The largest of ``_rel_max`` over (card, CPU) pairs."""
    return max(_rel_max(a, b) for a, b in pairs)


def _split_mesh(axis: str, dev, shards: int = 4):
    """(20's mesh over ``axis``: ``shards`` shards over :func:`_mesh_devices`,
    its devices, its layout in words)."""
    from bayesianinference_tpu_torch.parallel import make_mesh

    devices = _mesh_devices(dev) * (shards // MESH_SHARDS)
    cards = len(set(devices))
    layout = (f"{shards} shards, {shards // cards} a card on {cards} cards" if cards > 1 else
              f"all {shards} shards on {devices[0]}")
    return make_mesh((axis,), devices=devices), devices, layout


def _launches_by_card() -> dict:
    """The kernels' launch counters by device index (a snapshot)."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    return {"se_covariance": collections.Counter(gk.se_covariance_cuda.launches_by_device),
            "cholesky": collections.Counter(gk.cholesky_cuda.launches_by_device)}


def _cards_since(before: dict, devices) -> tuple:
    """(every card of ``devices`` launched both kernels since ``before``,
    the launches since then by card as text)."""
    after = _launches_by_card()
    new = {k: after[k] - before[k] for k in after}
    idx = sorted({torch.device(d).index for d in devices}, key=lambda i: -1 if i is None else i)
    ok = all(new[k][i] >= 1 for k in new for i in idx)
    return ok, "; ".join(f"{'cpu' if i is None else f'cuda:{i}'} SE {new['se_covariance'][i]}, Cholesky "
                         f"{new['cholesky'][i]}" for i in idx)


class _SMCStageDraws:
    """Stage t's ``SMCStageDraws`` made on the host from ``seed`` and t and
    put on ``dev``: the same numbers for a run on the card and one on CPU
    tensors, whatever the number of stages."""

    def __init__(self, seed, runs, n, d, steps, dev):
        self.seed, self.shape, self.dev = seed, (runs, n, d, steps), dev

    def __getitem__(self, t):
        from bayesianinference_tpu_torch.engines.smc import SMCStageDraws

        runs, n, d, steps = self.shape
        g = torch.Generator().manual_seed(1000 * self.seed + t)
        offset = torch.rand((runs,), generator=g, dtype=torch.float64)
        z = torch.randn((runs * n, d, steps), generator=g, dtype=torch.float64)
        log_u = torch.log(1e-38 + (1.0 - 1e-38) * torch.rand((runs * n, steps), generator=g, dtype=torch.float64))
        return SMCStageDraws(offset.to(self.dev), z.to(self.dev), log_u.to(self.dev))


def _phase20a_smc(smi, dev, runs=8, particles=200, steps=8):
    """20a: parallel SMC at the JAX test's configuration: bit for bit
    ``smc_sampler`` on one generator, logZ against the analytic value, and
    the card against CPU tensors on the same draws."""
    from bayesianinference_tpu_torch.engines.nested_sampling import generate_starting_points
    from bayesianinference_tpu_torch.engines.smc import smc_sampler
    from bayesianinference_tpu_torch.parallel import parallel_smc

    problem, analytic = _gaussian_box_problem(2, dev)
    cpu_problem, _ = _gaussian_box_problem(2, "cpu")
    kw = dict(num_runs=runs, n_particles=particles, mcmc_steps=steps)
    t = time.perf_counter()
    res = parallel_smc(problem, torch.Generator(device=dev).manual_seed(0), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ref = smc_sampler(problem, torch.Generator(device=dev).manual_seed(0), **kw)
    bitwise = torch.equal(res.log_z_runs, ref.log_z_runs) and torch.equal(res.particles, ref.particles)
    logz = float(res.log_evidence.mean)
    start = generate_starting_points(cpu_problem, torch.Generator().manual_seed(1), runs * particles)
    start = start.reshape(runs, particles, 2)
    card = parallel_smc(problem, None, starting_points=start.to(dev), draws=_SMCStageDraws(1, runs, particles, 2, steps,
                                                                                             dev), **kw)
    cpu = parallel_smc(cpu_problem, None, starting_points=start, draws=_SMCStageDraws(1, runs, particles, 2, steps,
                                                                                      "cpu"), **kw)
    err = _card_cpu_err([(card.log_z_runs, cpu.log_z_runs), (card.particles, cpu.particles)])
    stages_equal = torch.equal(card.n_stages.cpu(), cpu.n_stages)
    if not (bitwise and abs(logz - analytic) < 0.3 and err <= PAR_CARD_CPU_TOL and stages_equal):
        raise AssertionError(f"20a parallel SMC: bitwise smc_sampler {bitwise}, logZ {logz} (analytic {analytic}), "
                             f"card vs CPU {err:.3e}, stage counts equal {stages_equal}")
    log(f"[20a parallel SMC] {runs} runs x {particles} particles, {steps} AM steps, f64 (tests/test_parallel_smc_hmc.py"
        f"'s configuration): bit for bit smc_sampler on one generator; logZ {logz:.4f} +- "
        f"{float(res.log_evidence.standard_error):.4f} (analytic {analytic:.4f}, gate 0.3), stages "
        f"{res.n_stages.tolist()}, {res.num_likelihood_evals} evals in {wall:.2f} s; the card against CPU tensors on "
        f"the same draws {err:.1e} (gate {PAR_CARD_CPU_TOL:g}) | {smi}")


def _par_hmc_draws(g, chains, d, warmup, samples, auto):
    """One run's trajectory draws from the host generator ``g``."""
    from bayesianinference_tpu_torch.ops.chees import chees_draws
    from bayesianinference_tpu_torch.ops.hmc import _phase_lengths, hmc_draws

    make = chees_draws if auto else hmc_draws
    return make(g, chains, d, num_trajectories=sum(_phase_lengths(warmup)) + samples, dtype=torch.float64)


def _chain_moment_gate(x) -> tuple:
    """The pooled mean and variance of chains ``x`` [chains, samples, 2]
    against 0 and the box's variance (``_BOX_VAR``, 1 - 1.5e-5), each
    within 4 standard errors, a standard error the spread of the chains'
    own values over sqrt(chains).  (passed, mean, variance, 4 se of each)."""
    x = x.cpu()
    c = x.shape[0]
    mean, var = x.reshape(-1, 2).mean(0), x.reshape(-1, 2).var(0)
    se_mean, se_var = x.mean(1).std(0) / math.sqrt(c), x.var(1).std(0) / math.sqrt(c)
    ok = bool((mean.abs() <= 4 * se_mean).all()) and bool(((var - _BOX_VAR).abs() <= 4 * se_var).all())
    return ok, mean, var, 4 * se_mean, 4 * se_var


def _rounded(t, places=4):
    return [round(v, places) for v in t.tolist()]


# 20b at 60 + 40 with a fixed trajectory length: the step size that the card
# and the CPU freeze on the same draws may differ by rounding that dual
# averaging amplifies, but no more than two runs from different seeds do:
# |log eps_card - log eps_cpu| <= 4 sqrt(2) sd, sd = 0.105, the largest spread
# of log eps over 16 seeds at this configuration (diagonal 0.097, dense 0.105;
# tests/parallel_hmc_study.py)
PAR_HMC_LOG_EPS_TOL = 4 * math.sqrt(2) * 0.105


def _phase20b_hmc(smi, watch, dev, chains=8, warmup=60, samples=40, leapfrog=5, replay_warmup=3, replay_samples=3,
                  moments=PAR_HMC_MOMENTS, split=PAR_SPLIT_HMC):
    """20b: parallel HMC at the JAX smoke configuration (diagonal, dense and
    ChEES), each on the card and on CPU tensors from the same draws, and a
    moment run.

    ChEES at ``warmup`` + ``samples`` is held against the CPU at 1e-12 in
    the samples, step size, inverse mass and trajectory length: it freezes a
    trajectory of one or two steps (as JAX does on its mesh,
    tests/test_torch_parallel_smc_hmc.py), and its rounding grows far less
    (the port against JAX at this configuration: 1e-15 to 5e-11 over four
    keys, tests/parallel_hmc_study.py; these draws read 1.6e-15).
    With the fixed L the rounding does grow through dual averaging (the JAX
    package against itself from starts 1e-15 apart: 6.5e-14 after 6 warmup
    iterations, 1.4e-12 after 9, 0.09 after 60; the card against the CPU
    0.10 and 0.85 at 60 + 40), so the diagonal and dense masses are held at
    1e-12 over ``replay_warmup`` + ``replay_samples``, and at the full
    configuration by what rounding cannot move: both runs pass the moment
    gate of :func:`_chain_moment_gate`, and their frozen step sizes agree
    within ``PAR_HMC_LOG_EPS_TOL``.  The moment run's gate is the same
    test at ``moments``' depth.  Each kind also runs split over 20's
    4-shard mesh at ``split``'s depth against the one-batch card run on the
    same draws (``PAR_SPLIT_TOL``)."""
    from bayesianinference_tpu_torch.ops.chees import ChEESDraws
    from bayesianinference_tpu_torch.ops.hmc import HMCDraws
    from bayesianinference_tpu_torch.parallel import parallel_hmc

    problem, _ = _gaussian_box_problem(2, dev)
    cpu_problem, _ = _gaussian_box_problem(2, "cpu")
    lines, launches = [], {"se_covariance": 0, "cholesky": 0}
    fields = ("samples", "step_size", "inv_mass_diag", "trajectory_length")
    start = 4.0 * torch.rand((chains, 2), generator=torch.Generator().manual_seed(2), dtype=torch.float64) - 2.0
    mesh, _, layout = _split_mesh("chains", dev)

    def split_gap(kw, seed):
        """The split run against the one-batch run on the card, on one host
        generator's draws at ``split``'s depth."""
        auto = kw["num_leapfrog"] == "auto"
        draws = _par_hmc_draws(torch.Generator().manual_seed(seed), chains, 2, split["warmup"], split["samples"], auto)
        run = dict(num_chains=chains, num_warmup=split["warmup"], num_samples=split["samples"],
                   starting_points=start.to(dev), draws=(ChEESDraws if auto else HMCDraws)(*(a.to(dev) for a in draws)),
                   **kw)
        before = watch.counts()
        one, parts = parallel_hmc(problem, None, **run), parallel_hmc(problem, None, mesh=mesh, **run)
        for k, v in watch.counts().items():
            launches[k] += v - before[k]
        return _card_cpu_err([(getattr(parts, f), getattr(one, f)) for f in fields])

    def pair(kw, nw, ns, seed, count=False):
        """The run on the card and on CPU tensors from one host generator's draws."""
        auto = kw["num_leapfrog"] == "auto"
        draws = _par_hmc_draws(torch.Generator().manual_seed(seed), chains, 2, nw, ns, auto)
        run = dict(num_chains=chains, num_warmup=nw, num_samples=ns, **kw)
        before = watch.counts()
        card = parallel_hmc(problem, None, starting_points=start.to(dev),
                            draws=(ChEESDraws if auto else HMCDraws)(*(a.to(dev) for a in draws)), **run)
        after = watch.counts()
        if count:
            for k in launches:
                launches[k] += after[k] - before[k]
        return card, parallel_hmc(cpu_problem, None, starting_points=start, draws=draws, **run)

    for name, kw in (("diagonal", dict(num_leapfrog=leapfrog)), ("dense", dict(num_leapfrog=leapfrog, dense_mass=True)),
                     ("auto", dict(num_leapfrog="auto"))):
        card, cpu = pair(kw, warmup, samples, 3, count=True)
        ok = bool(torch.isfinite(card.samples).all()) and float(card.step_size) > 0 and card.step_size.shape == ()
        if kw.get("dense_mass"):
            m = card.inv_mass_diag
            ok = ok and m.shape == (2, 2) and _rel_max(m, m.mT) <= 1e-12
        full = _card_cpu_err([(getattr(card, f), getattr(cpu, f)) for f in fields])
        if name == "auto":
            held = full <= PAR_CARD_CPU_TOL
            line = (f"the card against CPU tensors on the same draws {full:.1e} at {warmup} + {samples} (gate "
                    f"{PAR_CARD_CPU_TOL:g})")
        else:
            a, b = pair(kw, replay_warmup, replay_samples, 3)
            short = _card_cpu_err([(getattr(a, f), getattr(b, f)) for f in fields])
            gates = [_chain_moment_gate(r.samples) for r in (card, cpu)]
            log_eps = abs(math.log(float(card.step_size) / float(cpu.step_size)))
            held = short <= PAR_CARD_CPU_TOL and all(g[0] for g in gates) and log_eps <= PAR_HMC_LOG_EPS_TOL
            line = (f"the card against CPU tensors on the same draws {short:.1e} at {replay_warmup} + "
                    f"{replay_samples} (gate {PAR_CARD_CPU_TOL:g}); at {warmup} + {samples} {full:.1e}, the step "
                    f"sizes' |log ratio| {log_eps:.3f} (gate {PAR_HMC_LOG_EPS_TOL:.3f}), the moment gate on the card "
                    f"and the CPU: mean {_rounded(gates[0][1])} and {_rounded(gates[1][1])} (4 se "
                    f"{_rounded(gates[0][3])}, {_rounded(gates[1][3])}), variance {_rounded(gates[0][2])} and "
                    f"{_rounded(gates[1][2])} (4 se {_rounded(gates[0][4])}, {_rounded(gates[1][4])})")
        gap = split_gap(kw, 10)
        line += (f"; split over the mesh against the one-batch run on the same draws {gap:.1e} at {split['warmup']} + "
                 f"{split['samples']} (gate {PAR_SPLIT_TOL:g})")
        if not (ok and held and gap <= PAR_SPLIT_TOL):
            raise AssertionError(f"20b parallel HMC {name}: {line}; samples finite and one positive step size {ok}")
        lines.append(f"{name}: step size {float(card.step_size):.4f}, trajectory length "
                     f"{float(card.trajectory_length):.3f}, acceptance {float(card.acceptance_rates.mean()):.3f}; "
                     + line)
    c = moments["chains"]
    t = time.perf_counter()
    run = parallel_hmc(problem, torch.Generator(device=dev).manual_seed(4), num_chains=c,
                       num_warmup=moments["warmup"], num_samples=moments["samples"], num_leapfrog=moments["leapfrog"])
    ok, mean, var, se4_mean, se4_var = _chain_moment_gate(run.samples)
    wall = time.perf_counter() - t
    if not (ok and int(run.divergences.sum()) == 0):
        raise AssertionError(f"20b moments: mean {mean.tolist()} (4 se {se4_mean.tolist()}), variance "
                             f"{var.tolist()} (4 se {se4_var.tolist()}), divergences {int(run.divergences.sum())}")
    lines.append(f"moments ({c} chains, {moments['warmup']} + {moments['samples']}, L = {moments['leapfrog']}): "
                 f"mean {_rounded(mean)} (4 se {_rounded(se4_mean)}), variance {_rounded(var)} (4 se "
                 f"{_rounded(se4_var)}), {wall:.2f} s")
    log(f"[20b parallel HMC] {chains} chains, {warmup} + {samples} steps, L = {leapfrog} (the JAX smoke "
        f"configuration), f64, the mesh {layout}: {'; '.join(lines)}; the dense mass's factor through the Cholesky "
        f"kernel: launches {launches} | {smi}")
    return launches


def _phase20b_gp_hmc(smi, watch, dev, problem, gp_posterior, chains=PAR_GP_HMC["chains"],
                     warmup=PAR_GP_HMC["warmup"], samples=PAR_GP_HMC["samples"], leapfrog=PAR_GP_HMC["leapfrog"]):
    """20b (GP): parallel HMC on phase 4's GP slice, started at draws of its
    NS posterior, split over 20's 4-shard mesh (each shard's
    value-and-gradient one SE and one Cholesky launch with their reverse
    rules, on its card against its copy of the GP problem), against the
    one-batch run on the same draws (``PAR_SPLIT_TOL``); every card of the
    mesh must launch both kernels."""
    from bayesianinference_tpu_torch.ops.hmc import HMCDraws, _phase_lengths
    from bayesianinference_tpu_torch.parallel import parallel_hmc

    res = gp_posterior[0]
    mesh, devices, layout = _split_mesh("chains", dev)
    w = torch.exp(res.crude_log_posterior_weights).cpu()
    pick = torch.multinomial(w, chains, replacement=True, generator=torch.Generator().manual_seed(8))
    draws = _par_hmc_draws(torch.Generator().manual_seed(9), chains, problem.dim, warmup, samples, False)
    run = dict(num_chains=chains, num_warmup=warmup, num_samples=samples, num_leapfrog=leapfrog,
               starting_points=res.points.cpu()[pick].to(dev), draws=HMCDraws(*(a.to(dev) for a in draws)))
    before = watch.counts()
    one = parallel_hmc(problem, None, **run)
    cards = _launches_by_card()
    torch.cuda.synchronize()
    t = time.perf_counter()
    parts = parallel_hmc(problem, None, mesh=mesh, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    every_card, by_card = _cards_since(cards, devices)
    launches = {k: v - before[k] for k, v in watch.counts().items()}
    fields = ("samples", "acceptance_rates", "step_size", "inv_mass_diag")
    gap = _card_cpu_err([(getattr(parts, f), getattr(one, f)) for f in fields])
    if not (gap <= PAR_SPLIT_TOL and bool(torch.isfinite(parts.samples).all()) and every_card):
        raise AssertionError(f"20b GP parallel HMC: split against one batch {gap:.3e}; launches by card {by_card}")
    trajectories = sum(_phase_lengths(warmup)) + samples
    log(f"[20b GP parallel HMC] n={SLICE_N} d={SLICE_D} f64, {chains} chains, {trajectories} trajectories of L = "
        f"{leapfrog} from draws of phase 4's NS posterior, split over the mesh ({layout}): against the one-batch run "
        f"on the same draws {gap:.1e} (gate {PAR_SPLIT_TOL:g}); step size {float(parts.step_size):.4f}, acceptance "
        f"{float(parts.acceptance_rates.mean()):.3f}; the split run {wall:.2f} s; its launches by card: {by_card}; "
        f"both runs' launches {launches} | {smi}")
    return launches


def _stacked_sweeps(g, walkers, d, sweeps, move="stretch"):
    """``sweeps`` sweeps' ensemble draws from the host generator ``g``, each
    half's fields with a leading sweep axis."""
    from bayesianinference_tpu_torch.ops.ensemble import ensemble_draws

    rows = [ensemble_draws(g, walkers, d, move=move, dtype=torch.float64) for _ in range(sweeps)]
    return tuple(type(rows[0][h])(*(torch.stack(f) for f in zip(*(r[h] for r in rows)))) for h in range(2))


def _phase20c_ensemble(smi, watch, dev, problem, gp_posterior, walkers=PAR_ENS["walkers"],
                       warmup=PAR_ENS["warmup"], samples=PAR_ENS["samples"], batches=PAR_ENS["batches"],
                       replay_sweeps=5):
    """20c: the parallel ensemble on phase 4's GP slice through both
    kernels (each half-update one density call at B = walkers / 2), started
    at draws of phase 4's NS posterior: the card against CPU tensors on the
    same draws for ``replay_sweeps`` sweeps, and the pooled posterior mean
    against phase 4's NS posterior mean within 4 Monte Carlo standard
    errors (the ensemble's by batch means over ``batches`` batches of the
    walkers' mean, the NS mean's from its evidence resampling)."""
    from bayesianinference_tpu_torch.parallel import parallel_ensemble

    res, _, cpu_problem = gp_posterior
    d = problem.dim
    w = torch.exp(res.crude_log_posterior_weights).cpu()
    pick = torch.multinomial(w, walkers, replacement=True, generator=torch.Generator().manual_seed(5))
    start = res.points.cpu()[pick]
    draws = _stacked_sweeps(torch.Generator().manual_seed(6), walkers, d, replay_sweeps)
    on_card = tuple(type(h)(*(a.to(dev) for a in h)) for h in draws)
    kw = dict(num_walkers=walkers, num_warmup=0, num_samples=replay_sweeps)
    card = parallel_ensemble(problem, None, starting_points=start.to(dev), draws=on_card, **kw)
    cpu = parallel_ensemble(cpu_problem, None, starting_points=start, draws=draws, **kw)
    err = _card_cpu_err([(card.samples, cpu.samples), (card.acceptance_rates, cpu.acceptance_rates)])
    mesh, devices, layout = _split_mesh("walkers", dev)
    before, cards = watch.counts(), _launches_by_card()
    parts = parallel_ensemble(problem, None, starting_points=start.to(dev), draws=on_card, mesh=mesh, **kw)
    every_card, by_card = _cards_since(cards, devices)
    split_launches = {k: v - before[k] for k, v in watch.counts().items()}
    gap = _card_cpu_err([(parts.samples, card.samples), (parts.acceptance_rates, card.acceptance_rates)])
    watch.zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run = parallel_ensemble(problem, torch.Generator(device=dev).manual_seed(7), num_walkers=walkers,
                            num_warmup=warmup, num_samples=samples, starting_points=start.to(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = watch.counts()
    sweeps = warmup + samples
    series = run.samples.mean(0).cpu()  # [samples, d]: the walkers' mean at each recorded sweep
    batch_means = series[: samples // batches * batches].reshape(batches, -1, d).mean(1)
    se_ens = batch_means.std(0) / math.sqrt(batches)
    mean = series.mean(0)
    ns_mean = res.parameter_expected_values.mean.cpu()
    ns_se = res.parameter_expected_values.standard_error.cpu()
    se = torch.sqrt(se_ens**2 + ns_se**2)
    calls = 2 * sweeps + 1  # the starting walkers' call, then two half-updates a sweep
    ok_launches = launches["se_covariance"] == calls and launches["cholesky"] == calls
    if not (err <= PAR_ENS_CARD_CPU_TOL and bool(((mean - ns_mean).abs() <= 4 * se).all()) and ok_launches
            and gap <= PAR_SPLIT_TOL and every_card):
        raise AssertionError(f"20c parallel ensemble: card vs CPU {err:.3e}; mean {mean.tolist()} against NS "
                             f"{ns_mean.tolist()} (4 se {(4 * se).tolist()}); launches {launches} for {calls} calls; "
                             f"split against one batch {gap:.3e}, launches by card {by_card}")
    log(f"[20c parallel ensemble, GP slice] n={SLICE_N} d={SLICE_D} f64, {walkers} walkers (B = {walkers // 2} a "
        f"half-update), {warmup} + {samples} stretch sweeps from draws of phase 4's NS posterior: the card against "
        f"CPU tensors on the same draws for {replay_sweeps} sweeps {err:.1e} (gate {PAR_ENS_CARD_CPU_TOL:g}); pooled "
        f"mean {[round(v, 5) for v in mean.tolist()]} against phase 4's NS mean {[round(v, 5) for v in ns_mean.tolist()]}"
        f", standard errors by {batches} batch means {[f'{v:.2e}' for v in se_ens.tolist()]} and of the NS mean "
        f"{[f'{v:.2e}' for v in ns_se.tolist()]} (gate 4 x their root sum of squares); acceptance "
        f"{float(run.acceptance_rates.mean()):.3f}; {sweeps} sweeps in {wall:.2f} s = {wall / sweeps * 1e3:.2f} ms a "
        f"sweep; launches {launches}, one of each a density call; the replay split over the mesh ({layout}: B = "
        f"{walkers // 2 // MESH_SHARDS} a shard's half-update) against the one-batch card run {gap:.1e} (gate "
        f"{PAR_SPLIT_TOL:g}), its launches by card: {by_card} | {smi}")
    return {k: launches[k] + split_launches[k] for k in launches}


def _normal_mean_problem(dev, data, sigma=1.0, tau=2.0):
    """tests/test_parallel_dynamic_ibis.py's normal mean model, on ``dev``,
    its observations the problem's data (so the problem can move to
    another card), and those observations."""
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.models import define_inference_problem

    yd = torch.as_tensor(data, dtype=torch.float64, device=dev)
    full = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)  # noqa: E731
    return define_inference_problem(
        parameters=[("mu", -10.0, 10.0)], log_likelihood=lambda th, y: dists.Normal(th[0], sigma).log_prob(y).sum(),
        data=yd, prior_distribution=dists.Product((dists.Normal(full(0.0), full(tau)),)), validate=False, device=dev,
        dtype=torch.float64), yd


def _normal_mean_oracle(data, sigma=1.0, tau=2.0):
    """(posterior mean, posterior variance, logZ by quadrature on a 4001-point grid)."""
    post_var = 1.0 / (1.0 / tau**2 + data.size / sigma**2)
    grid = np.linspace(-10, 10, 4001)
    ll = (-0.5 * ((data[None, :] - grid[:, None]) / sigma) ** 2).sum(1) - data.size * math.log(sigma * math.sqrt(
        2 * math.pi))
    lp = -0.5 * (grid / tau) ** 2 - math.log(tau * math.sqrt(2 * math.pi))
    return post_var * data.sum() / sigma**2, post_var, float(np.logaddexp.reduce(ll + lp) + math.log(grid[1] - grid[0]))


PAR_DATA = np.random.default_rng(3).normal(0.8, 1.0, size=40)  # tests/test_parallel_dynamic_ibis.py's data


def _phase20d_ibis(smi, dev, particles=2048, batch=5, steps=15):
    """20d: parallel IBIS on the JAX oracle (the normal mean, 40
    observations) under its gates, and the card against CPU tensors on the
    same draws."""
    from bayesianinference_tpu_torch import dists
    from bayesianinference_tpu_torch.engines.ibis import ibis_stage_draws
    from bayesianinference_tpu_torch.parallel import parallel_ibis

    post_mean, post_var, log_z = _normal_mean_oracle(PAR_DATA)
    problem, yd = _normal_mean_problem(dev, PAR_DATA)
    cpu_problem, y_cpu = _normal_mean_problem("cpu", PAR_DATA)

    def pointwise(th, yy):
        return dists.Normal(th[0], 1.0).log_prob(yy)

    kw = dict(n_particles=particles, batch_size=batch, mcmc_steps=steps)
    t = time.perf_counter()
    res = parallel_ibis(problem, pointwise, yd, torch.Generator(device=dev).manual_seed(1), **kw)
    w = torch.softmax(res.log_weights, 0).cpu()
    x = res.particles[:, 0].cpu()
    wall = time.perf_counter() - t
    mu = float((w * x).sum())
    var = float((w * (x - mu) ** 2).sum())
    acc = float(np.nanmean(res.acceptance_history.cpu().numpy()))
    pred_err = abs(float(res.log_predictives.sum() - res.log_evidence)) / abs(float(res.log_evidence))
    g = torch.Generator().manual_seed(8)
    start = 2.0 * torch.randn((particles, 1), generator=g, dtype=torch.float64)
    stages = -(-PAR_DATA.size // batch)
    draws = [ibis_stage_draws(g, particles, 1, steps, dtype=torch.float64, device="cpu") for _ in range(stages)]
    card = parallel_ibis(problem, pointwise, yd, None, starting_points=start.to(dev),
                         draws=[type(s)(*(a.to(dev) for a in s)) for s in draws], **kw)
    cpu = parallel_ibis(cpu_problem, pointwise, y_cpu, None, starting_points=start, draws=draws, **kw)
    fields = ("particles", "log_evidence", "log_predictives", "ess_history")
    err = _card_cpu_err([(getattr(card, f), getattr(cpu, f)) for f in fields])
    mesh, _, layout = _split_mesh("particles", dev)
    parts = parallel_ibis(problem, pointwise, yd, None, starting_points=start.to(dev), mesh=mesh,
                          draws=[type(s)(*(a.to(dev) for a in s)) for s in draws], **kw)
    gap = _card_cpu_err([(getattr(parts, f), getattr(card, f)) for f in fields])
    ok = (abs(float(res.log_evidence) - log_z) < 0.25 and pred_err <= 1e-6
          and abs(mu - post_mean) < 4 * math.sqrt(post_var / 500) and abs(var / post_var - 1.0) < 0.25
          and bool(res.resampled.any()) and acc > 0.1 and err <= PAR_CARD_CPU_TOL
          and torch.equal(card.resampled.cpu(), cpu.resampled) and gap <= PAR_SPLIT_TOL
          and torch.equal(parts.resampled, card.resampled))
    if not ok:
        raise AssertionError(f"20d parallel IBIS: logZ {float(res.log_evidence)} ({log_z}), predictives {pred_err:.1e},"
                             f" mean {mu} ({post_mean}), var {var} ({post_var}), resampled {res.resampled.tolist()}, "
                             f"acceptance {acc}, card vs CPU {err:.3e}, split against one batch {gap:.3e}")
    log(f"[20d parallel IBIS] {particles} particles, batch {batch}, {steps} AM steps, f64, the normal mean with "
        f"{PAR_DATA.size} observations (the JAX oracle): logZ {float(res.log_evidence):.4f} against quadrature "
        f"{log_z:.4f} (gate 0.25), the predictives' sum {pred_err:.1e} from it (1e-6), mean {mu:.4f} ({post_mean:.4f}"
        f"), variance ratio {var / post_var:.3f}, {int(res.resampled.sum())} of {stages} stages moved, acceptance "
        f"{acc:.3f}, {wall:.2f} s; the card against CPU tensors on the same draws {err:.1e} (gate "
        f"{PAR_CARD_CPU_TOL:g}); split over the mesh ({layout}) against the one-batch card run {gap:.1e} (gate "
        f"{PAR_SPLIT_TOL:g}) | {smi}")


PAR_DNS_STEPS = 40  # 20e's chain steps a replacement, the JAX oracle's


def _dns_oracle(dev: str, runs=8, pool=48, batches=8, steps=PAR_DNS_STEPS) -> dict:
    """20e's run: parallel dynamic NS on the JAX oracle (the normal mean,
    pool 48, ``num_batches=8`` over 8 runs: one stage), the runs on an
    8-shard mesh over 20's mesh devices (``runs`` a multiple of 4).  A
    host-bound loop of batched AM steps that reaches no hand-written kernel,
    so it runs in a worker process of 18b's pool beside phases 18 and 19 (it
    fails if a kernel launched during the run).  Its readings and seconds."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.parallel import parallel_dynamic_nested_sampling

    dev = torch.device(dev)
    problem, _ = _normal_mean_problem(dev, PAR_DATA)
    mesh, _, layout = _split_mesh("runs", dev, shards=runs)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    t0 = time.perf_counter()
    res = parallel_dynamic_nested_sampling(problem, torch.Generator(device=dev).manual_seed(5), mesh=mesh,
                                           sample_pool_size=pool, num_batches=batches, monte_carlo_steps=steps,
                                           post_process_sampling_runs=50)
    w = torch.exp(res.crude_log_posterior_weights)
    out = dict(logz=float(res.log_evidence.mean), se=float(res.log_evidence.standard_error),
               mean=float(w @ res.points[:, 0]), iterations=res.iterations, evals=res.num_likelihood_evals,
               seconds=time.perf_counter() - t0, sizes=(runs, pool, batches, steps), layout=layout)
    if (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches) != before:
        raise AssertionError("20e parallel dynamic NS: a hand-written kernel launched")
    return out


def _dns_split(dev, pool=16, batches=4, steps=5) -> str:
    """Parallel dynamic NS on the 2-D Gaussian box split over 20's 4-shard
    mesh against ``num_runs=4`` as one batch, from one generator seed: bit
    for bit where the shards share one card (one device group is the
    one-batch call); where they are on four cards each card draws its
    chains' numbers from a generator of its own, so there the two logZ must
    agree within 4 joint standard errors.  A line of readings."""
    from bayesianinference_tpu_torch.parallel import parallel_dynamic_nested_sampling

    problem, _ = _gaussian_box_problem(2, dev)
    mesh, devices, layout = _split_mesh("runs", dev)
    kw = dict(sample_pool_size=pool, num_batches=batches, batch_size=pool, monte_carlo_steps=steps,
              post_process_sampling_runs=20)
    one = parallel_dynamic_nested_sampling(problem, torch.Generator(device=dev).manual_seed(11), num_runs=4, **kw)
    parts = parallel_dynamic_nested_sampling(problem, torch.Generator(device=dev).manual_seed(11), mesh=mesh, **kw)
    a, b = one.log_evidence, parts.log_evidence
    if len(set(devices)) == 1:
        ok = torch.equal(one.points, parts.points) and float(a.mean) == float(b.mean)
        gate = "bit for bit (one device group)"
    else:
        ok = abs(float(a.mean) - float(b.mean)) < 4 * math.hypot(float(a.standard_error), float(b.standard_error))
        gate = "within 4 joint sigma (each card's own generator)"
    line = (f"split over the mesh ({layout}, 4 runs of pool {pool}, {batches} batches) logZ {float(b.mean):.4f} +- "
            f"{float(b.standard_error):.4f} against the one-batch run's {float(a.mean):.4f} +- "
            f"{float(a.standard_error):.4f}, {gate}")
    if not ok:
        raise AssertionError(f"20e parallel dynamic NS: {line}")
    return line


def _phase20e_dynamic_ns(smi, dev, pending=None, split=None, **kw):
    """20e's gates on :func:`_dns_oracle`'s readings (``pending``: its
    result from 18b's pool, or None to run it here with ``kw``): |z| < 4
    against the quadrature logZ, the posterior mean within 4 posterior sd;
    and :func:`_dns_split` (``split``: its sizes)."""
    post_mean, post_var, log_z = _normal_mean_oracle(PAR_DATA)
    split_line = _dns_split(dev, **(split or {}))
    t = time.perf_counter()
    r = _dns_oracle(str(dev), **kw) if pending is None else pending.get()
    wait = time.perf_counter() - t
    runs, pool, batches, steps = r["sizes"]
    z = (r["logz"] - log_z) / r["se"]
    if not (abs(z) < 4.0 and abs(r["mean"] - post_mean) < 4 * math.sqrt(post_var) and r["iterations"] > 0):
        raise AssertionError(f"20e parallel dynamic NS: logZ {r['logz']} +- {r['se']} against {log_z} (z {z:.2f}), "
                             f"mean {r['mean']} ({post_mean})")
    where = ("in this process" if pending is None else
             f"in a worker process of 18b's pool from phase 18 on, waited for {wait:.1f} s here")
    log(f"[20e parallel dynamic NS] the normal mean (the JAX oracle): {runs} runs of pool {pool} on the mesh "
        f"({r['layout']}), {batches} batches ({-(-batches // runs)} stage), {steps} AM steps a replacement, f64: logZ "
        f"{r['logz']:.4f} +- {r['se']:.4f} against quadrature {log_z:.4f} (z {z:+.2f}, gate 4), mean {r['mean']:.4f} "
        f"({post_mean:.4f}), {r['iterations']} iterations, {r['evals']} evals in {r['seconds']:.1f} s {where}; "
        f"{split_line} | {smi}")


def phase_parallel_engines(smi: str, gp_problem, gp_posterior, dev="cuda", dns=None, **sizes):
    """Phase 20: the parallel engines, one-batch and split over a 4-shard
    mesh (module docstring).  ``dns`` is the pending result of 20e's run in
    18b's pool, or None to run it here.  ``sizes`` shrink 20a-e for a
    rehearsal (``smc``, ``hmc``, ``gp_hmc``, ``ensemble``, ``ibis``,
    ``dynamic_ns``: keyword arguments of each sub-phase).  Returns the launches of
    20b's runs (the dense mass's factor, the GP slice's HMC) and 20c's
    runs."""
    dev = torch.device(dev)
    log(f"[20 mesh] {_split_mesh('chains', dev)[2]}: {', '.join(str(d) for d in _mesh_devices(dev))}")
    t0 = time.perf_counter()
    seconds, total = [], {"se_covariance": 0, "cholesky": 0}
    with _KernelWatch() as watch:
        for tag, run in (("20a", lambda: _phase20a_smc(smi, dev, **sizes.get("smc", {}))),
                         ("20b", lambda: _phase20b_hmc(smi, watch, dev, **sizes.get("hmc", {}))),
                         ("20b GP", lambda: _phase20b_gp_hmc(smi, watch, dev, gp_problem, gp_posterior,
                                                             **sizes.get("gp_hmc", {}))),
                         ("20c", lambda: _phase20c_ensemble(smi, watch, dev, gp_problem, gp_posterior,
                                                            **sizes.get("ensemble", {}))),
                         ("20d", lambda: _phase20d_ibis(smi, dev, **sizes.get("ibis", {}))),
                         ("20e", lambda: _phase20e_dynamic_ns(smi, dev, dns, **sizes.get("dynamic_ns", {})))):
            t = time.perf_counter()
            for k, v in (run() or {}).items():
                total[k] += v
            seconds.append(f"{tag} {time.perf_counter() - t:.1f}")
        if not (total["se_covariance"] > 0 and total["cholesky"] > 0):
            raise AssertionError(f"20: launches {total}")
        log(f"[20 parallel engines] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches {total}; "
            f"{watch.check('20')}")
    return total


# ---------------------------------------------------------------------------
# Phase 21: the multi-card engines (parallel/sharding.py and the sharded_*
# modules) on a 4-shard mesh

MESH_SHARDS = 4
MESH_BLOCK = 256  # the panel width of the blocked factorizations
MESH_BIG_N = 65536  # 21g: the width the row-sharded engine exists for (a 4 GiB f32 row block a shard)
MESH_GRAD_N = 2048  # 21d
MESH_CHOL_N = 4096  # 21c
MESH_PRED_M = 512  # 21e's query points
MESH_CONJ_ROWS = 2**20  # 21f
MESH_THETA = (0.0, 0.0, -2.0)  # bench.py::bench_gp's theta: log variance, log lengthscale, log nugget


def _mesh_devices(dev="cuda") -> list:
    """The mesh's 4 shards: one per card where there are four, else all on
    ``dev`` (the one card, or the CPU in a rehearsal)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and torch.cuda.device_count() >= MESH_SHARDS:
        return [torch.device("cuda", i) for i in range(MESH_SHARDS)]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * MESH_SHARDS


def _mesh_gp_data(n: int, dev, dtype, seed: int = 0):
    """bench.py::bench_gp's data law (x ~ N(0, I_3), y = sin x_0 + 0.1 noise,
    drawn in float32) at width n."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, SLICE_D)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return torch.as_tensor(x, device=dev, dtype=dtype), torch.as_tensor(y, device=dev, dtype=dtype)


def _mesh_kernel(gk, th):
    return gk.se_kernel(torch.exp(th[0]), torch.exp(th[1])), torch.exp(th[2])


def _peaks(devices) -> str:
    """Peak device memory of each distinct device since its last reset."""
    if devices[0].type != "cuda":
        return "not measured (CPU)"
    return ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.2f} GiB" for d in dict.fromkeys(devices))


def _reset_peaks(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)


def _synced_s(fn, devices):
    """(result, host seconds) of ``fn`` ending in a synchronize of every device."""
    t = time.perf_counter()
    out = fn()
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return out, time.perf_counter() - t


class _Counted:
    """Adds the launches of the calls it wraps (counters zeroed just before
    each, read just after) to ``total``: the main path's launches; the
    reference calls that the gates compare against run outside it."""

    def __init__(self):
        self.total = {"se_covariance": 0, "cholesky": 0}

    def __call__(self, fn):
        from bayesianinference_tpu_torch.ops import gp_kernels as gk

        gk.se_covariance_cuda.launches = 0
        gk.cholesky_cuda.launches = 0
        out = fn()
        got = {"se_covariance": gk.se_covariance_cuda.launches, "cholesky": gk.cholesky_cuda.launches}
        for k, v in got.items():
            self.total[k] += v
        return out, got


def _phase21_gp(smi, counted, mesh, devices, dev, n=GRAD_N, m=MESH_PRED_M, chol_n=MESH_CHOL_N,
                grad_n=MESH_GRAD_N):
    """21a-e: the row-sharded covariance, blocked logML, Cholesky, gradient
    and prediction against the single-device kernel path and plain f64."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.parallel import (sharded_cholesky, sharded_covariance_matrix,
                                                      sharded_gp_logml_blocked, sharded_gp_predict)

    panels = n // MESH_BLOCK
    x, y = _mesh_gp_data(n, dev, torch.float32)
    th = torch.tensor(MESH_THETA, device=dev, dtype=torch.float32)
    kern, nug = _mesh_kernel(gk, th)
    # 21a: one SE launch a shard
    with torch.no_grad():
        k_sh, launches = counted(lambda: sharded_covariance_matrix(kern, x, mesh, nugget=nug))
        k_ref = gk.covariance_matrix(kern, x, nugget=nug, symmetrize=False)
        err_a = ((k_sh.gather(dev) - k_ref).abs().max() / k_ref.abs().max()).item()
    del k_sh, k_ref
    if not (err_a <= 1e-6 and launches["se_covariance"] == MESH_SHARDS):
        raise AssertionError(f"21a sharded covariance: rel err {err_a}, launches {launches}")
    log(f"[21a sharded covariance] n={n} d={SLICE_D} f32, {MESH_SHARDS} row blocks [{n // MESH_SHARDS}, {n}]: "
        f"against the single-device op's K rel err {err_a:.2e} (gate 1e-6); SE launches {launches['se_covariance']} "
        f"(one a shard) | {smi}")

    # 21b: the blocked logML, f32, against plain f64 beside the single-device kernel path
    with torch.no_grad():
        got_b, launches = counted(lambda: sharded_gp_logml_blocked(kern, x, y, mesh, nugget=nug, block=MESH_BLOCK))
        # the first call's wall and memory hold the watch's checks of its new shapes: measure a second one
        _reset_peaks(devices)
        _, wall_b = _synced_s(lambda: sharded_gp_logml_blocked(kern, x, y, mesh, nugget=nug, block=MESH_BLOCK),
                              devices)
        peaks_b = _peaks(devices)
        single = _gp_logml(th, x, y)
        x64, y64 = _mesh_gp_data(n, dev, torch.float64)
        ref = _gp_logml_plain(th.double(), x64, y64)
    err_k, err_s = abs(got_b.double() - ref).item(), abs(single.double() - ref).item()
    bound = min(2.0 * err_s + 1e-6 * abs(ref.item()), 5e-5 * abs(ref.item()))
    if not (math.isfinite(got_b.item()) and err_k <= bound and launches["cholesky"] >= panels
            and launches["se_covariance"] == MESH_SHARDS):
        raise AssertionError(f"21b sharded logML: {got_b.item()} (err {err_k}) single {single.item()} (err {err_s}) "
                             f"f64 {ref.item()}; launches {launches}")
    log(f"[21b sharded blocked logML] n={n} f32 block {MESH_BLOCK}: {got_b.item():.9g} (err {err_k:.3g}) single-device "
        f"kernel path {single.item():.9g} (err {err_s:.3g}) plain f64 {ref.item():.9g}; gate {bound:.3g}; wall "
        f"{wall_b * 1e3:.1f} ms (a second call, warm); launches {launches} ({panels} panels, a factor a device a panel); peak "
        f"memory per device in that call {peaks_b} | {smi}")

    # 21c: the sharded Cholesky, f64, against the cholesky op's factor
    xc, _ = _mesh_gp_data(chol_n, dev, torch.float64, seed=1)
    with torch.no_grad():
        kc = gk.covariance_matrix(gk.se_kernel(1.0, 1.0), xc, nugget=math.exp(-2.0), symmetrize=False)
        (l_sh, logdet), launches = counted(lambda: sharded_cholesky(kc, mesh, block=MESH_BLOCK))
        l_op = gk.cholesky(kc)
        err_l = ((l_sh.gather(dev) - l_op).abs().max() / l_op.abs().max()).item()
        ref_ld = 2.0 * torch.log(torch.diagonal(l_op)).sum()
        err_ld = abs((logdet - ref_ld) / ref_ld).item()
    del kc, l_sh, l_op
    if not (err_l <= 1e-10 and err_ld <= 1e-10 and launches["cholesky"] >= chol_n // MESH_BLOCK):
        raise AssertionError(f"21c sharded Cholesky: L rel err {err_l}, logdet rel err {err_ld}, launches {launches}")
    log(f"[21c sharded Cholesky] n={chol_n} f64 block {MESH_BLOCK}: L against the cholesky op's factor rel err "
        f"{err_l:.2e}, log det rel err {err_ld:.2e} (gate 1e-10); launches {launches} | {smi}")

    # 21d: value and theta-gradient, f64, against the single-device kernel path
    xd, yd = _mesh_gp_data(grad_n, dev, torch.float64, seed=2)
    th64 = th.double()
    (got_d, launches) = counted(lambda: _value_and_grad(
        lambda t, xx, yy: sharded_gp_logml_blocked(_mesh_kernel(gk, t)[0], xx, yy, mesh, nugget=torch.exp(t[2]),
                                                   block=MESH_BLOCK), th64, xd, yd))
    want_d = _value_and_grad(_gp_logml, th64, xd, yd)
    flat = lambda vg: torch.cat([vg[0].reshape(1), vg[1]])  # noqa: E731
    err_d = ((flat(got_d) - flat(want_d)).abs() / flat(want_d).abs()).max().item()
    if not (err_d <= 1e-7 and launches["cholesky"] >= grad_n // MESH_BLOCK):
        raise AssertionError(f"21d sharded logML gradient: {flat(got_d).tolist()} against {flat(want_d).tolist()}")
    log(f"[21d sharded logML and theta-gradient] n={grad_n} f64: against the single-device kernel path rel err "
        f"{err_d:.2e} (gate 1e-7); launches {launches} | {smi}")

    # 21e: prediction, f32, against plain f64 beside the single-device kernel path
    xq = torch.as_tensor(np.random.default_rng(3).normal(size=(m, SLICE_D)).astype(np.float32), device=dev)
    with torch.no_grad():
        (mean_e, std_e), launches = counted(lambda: sharded_gp_predict(kern, x, y, xq, mesh, nugget=nug,
                                                                        block=MESH_BLOCK))
        mean_s, std_s = gk.gp_posterior_moments(kern, x, y, xq, nugget=nug)
        with _plain_ops():
            mean_r, std_r = gk.gp_posterior_moments(gk.se_kernel(1.0, 1.0), x64, y64, xq.double(),
                                                    nugget=math.exp(-2.0))
    errs = {}
    for name, got, sgl, want in (("mean", mean_e, mean_s, mean_r), ("std", std_e, std_s, std_r)):
        scale = want.abs().max()
        errs[name] = (((got.double() - want).abs().max() / scale).item(),
                      ((sgl.double() - want).abs().max() / scale).item())
    if not (all(ek <= 2.0 * es + 1e-6 for ek, es in errs.values()) and launches["cholesky"] >= panels
            and launches["se_covariance"] == 2 * MESH_SHARDS):
        raise AssertionError(f"21e sharded predict: errors (sharded, single) {errs}; launches {launches}")
    log(f"[21e sharded predict] n={n} m={m} f32: " + "; ".join(
        f"{k} rel err {ek:.3g} (single-device kernel path {es:.3g})" for k, (ek, es) in errs.items())
        + f" against plain f64 (gate 2 x single + 1e-6); launches {launches} | {smi}")


def _phase21_conjugate(smi, counted, mesh, dev, rows=MESH_CONJ_ROWS):
    """21f: the four data-sharded conjugate models against the dense engines."""
    from bayesianinference_tpu_torch.engines import conjugate as cj
    from bayesianinference_tpu_torch.parallel import (sharded_bayesian_linear_regression,
                                                      sharded_categorical_conjugate_model,
                                                      sharded_multinormal_conjugate_model,
                                                      sharded_normal_conjugate_model)

    g = torch.Generator(device=dev).manual_seed(21)
    kw = dict(generator=g, device=dev, dtype=torch.float64)
    x = 4.0 * torch.rand((rows, 1), **kw) - 2.0
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * torch.randn(rows, **kw)
    data = 1.3 + 0.7 * torch.randn(rows, **kw)
    mv = torch.randn((rows, 3), **kw) @ torch.tensor([[1.0, 0.4, 0.0], [0.0, 1.1, -0.2], [0.0, 0.0, 0.8]],
                                                     device=dev, dtype=torch.float64)
    cats = torch.randint(0, 4, (rows,), generator=g, device=dev).double()
    cases = (
        ("BLR degree 3", lambda: sharded_bayesian_linear_regression(x, y, mesh, degree=3),
         lambda: cj.bayesian_linear_regression(x, y, degree=3),
         lambda r: [r.log_evidence, r.posterior_parameters.b, r.posterior_parameters.v]),
        ("Normal", lambda: sharded_normal_conjugate_model(data, mesh), lambda: cj.normal_conjugate_model(data),
         lambda r: [r.log_evidence, r.posterior.mu0, r.posterior.beta]),
        ("Multinormal", lambda: sharded_multinormal_conjugate_model(mv, mesh),
         lambda: cj.multinormal_conjugate_model(mv), lambda r: [r.log_evidence, r.posterior.mu0, r.posterior.psi]),
        ("Categorical", lambda: sharded_categorical_conjugate_model(cats, 4, mesh),
         lambda: cj.categorical_conjugate_model(cats, 4), lambda r: [r.log_evidence, r.posterior.alpha]),
    )
    rows_out = []
    for name, sharded, dense, fields in cases:
        got, launches = counted(sharded)
        want = dense()
        err = max(((torch.as_tensor(a) - torch.as_tensor(b)).abs().max() / torch.as_tensor(b).abs().max()).item()
                  for a, b in zip(fields(got), fields(want)))
        if not err <= 1e-10:
            raise AssertionError(f"21f {name}: sharded against dense rel err {err}")
        rows_out.append(f"{name} {err:.2e} (launches {launches})")
    log(f"[21f sharded conjugate models] {rows} rows f64 over {MESH_SHARDS} shards, against the dense engines "
        f"(gate 1e-10): " + "; ".join(rows_out) + f" | {smi}")


def _phase21_big(smi, counted, mesh, devices, dev, n=MESH_BIG_N):
    """21g: the blocked logML forward at the width the row-sharded engine
    exists for.  Returns the check to run once the shards are freed and the
    watch is closed (:func:`_phase21_big_check`: the single-device kernel
    path's K and L are n^2 f32 each, too large for the watch's plain
    copies beside them)."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.parallel import sharded_gp_logml_blocked

    x, y = _mesh_gp_data(n, dev, torch.float32)
    th = torch.tensor(MESH_THETA, device=dev, dtype=torch.float32)
    kern, nug = _mesh_kernel(gk, th)
    with torch.no_grad():
        got, launches = counted(lambda: sharded_gp_logml_blocked(kern, x, y, mesh, nugget=nug, block=MESH_BLOCK))
        # the first call's wall and memory hold the watch's check of the new SE shape: measure a second one
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _reset_peaks(devices)
        _, wall = _synced_s(lambda: sharded_gp_logml_blocked(kern, x, y, mesh, nugget=nug, block=MESH_BLOCK),
                            devices)
        peaks = _peaks(devices)
    return lambda: _phase21_big_check(smi, dev, x, y, kern, nug, got, launches, wall, peaks)


def _phase21_big_check(smi, dev, x, y, kern, nug, got, launches, wall, peaks):
    """21g's gate: against the single-device kernel path's f32 logML."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    n = x.shape[0]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        k = gk.covariance_matrix(kern, x, nugget=nug, symmetrize=False)
        factor = gk.cholesky(k)
        del k
        w = torch.linalg.solve_triangular(factor, y[:, None], upper=False)[:, 0]
        logdet = 2.0 * torch.log(torch.diagonal(factor)).sum()
        del factor
        want = -0.5 * (n * math.log(2 * math.pi) + logdet + (w * w).sum())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    err = abs((got.double() - want.double()) / want.double()).item()
    if not (math.isfinite(got.item()) and err <= 5e-5 and launches["se_covariance"] == MESH_SHARDS
            and launches["cholesky"] >= n // MESH_BLOCK):
        raise AssertionError(f"21g sharded logML at n={n}: {got.item()} against {want.item()} (rel err {err}); "
                             f"launches {launches}")
    log(f"[21g sharded blocked logML at full width] n={n} f32 ({MESH_SHARDS} row blocks of "
        f"{n // MESH_SHARDS * n * 4 / 2**30:.0f} GiB; one device would hold {n * n * 4 / 2**30:.0f} GiB): "
        f"{got.item():.9g} against the single-device kernel path's {want.item():.9g} (rel err {err:.2e}, gate 5e-5); "
        f"wall {wall:.2f} s (a second call, warm); launches {launches}; peak memory per device in that call "
        f"{peaks} | {smi}")


def _mesh_ns_oracle(dev: str, pool=128, k=8, steps=40, max_iterations=900, min_iterations=50) -> dict:
    """21h's runs: the pool-sharded NS on the headline problem (the 2-D
    Gaussian box) on phase 21's 4-shard mesh beside the single-device run
    at the same settings, and the runs x live x data NS at (2, 2, 2) (8
    shards) on the JAX test's data.  Host-bound loops that reach no
    hand-written kernel, so they run in a worker process of 18b's pool (it
    fails if a kernel launched).  Their readings and seconds."""
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu_torch.models.problem import define_inference_problem
    from bayesianinference_tpu_torch.ops import gp_kernels as gk
    from bayesianinference_tpu_torch.parallel import (make_mesh, make_multi_axis_mesh, multi_axis_nested_sampling,
                                                      sharded_pool_nested_sampling)

    dev = torch.device(dev)
    devices = _mesh_devices(dev)
    before = (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches)
    problem, analytic = _gaussian_box_problem(2, dev)
    kw = dict(sample_pool_size=pool, num_delete=k, max_iterations=max_iterations, min_iterations=min_iterations,
              monte_carlo_steps=steps)
    t0 = time.perf_counter()
    r = sharded_pool_nested_sampling(problem, torch.Generator(device=dev).manual_seed(21),
                                     mesh=make_mesh(("live",), devices=devices), **kw)
    t1 = time.perf_counter()
    r1 = nested_sampling(problem, torch.Generator(device=dev).manual_seed(7), **kw)
    t2 = time.perf_counter()
    data = torch.as_tensor(np.random.default_rng(0).normal(0.5, 1.3, 64), device=dev)
    ma_problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0), ("log_sigma", -2.0, 2.0)],
        log_likelihood=lambda th: Normal(th[0], torch.exp(th[1])).log_prob(data).sum(),
        prior_distribution=["location", "location"], validate=False, device=dev, dtype=torch.float64)
    ma_devices = [devices[i % MESH_SHARDS] for i in range(8)]
    ma = multi_axis_nested_sampling(
        ma_problem, torch.Generator(device=dev).manual_seed(21), mesh=make_multi_axis_mesh(2, 2, 2, ma_devices),
        sample_pool_size=64, num_delete=8, data=data,
        local_log_likelihood=lambda th, shard: Normal(th[0], torch.exp(th[1])).log_prob(shard).sum(),
        max_iterations=600, min_iterations=50, monte_carlo_steps=steps)
    t3 = time.perf_counter()
    if (gk.se_covariance_cuda.launches, gk.cholesky_cuda.launches) != before:
        raise AssertionError("21h: a hand-written kernel launched")
    f = lambda res: (float(res.log_evidence.mean), float(res.log_evidence.standard_error), res.iterations)  # noqa: E731
    return dict(pool=f(r), single=f(r1), multi=f(ma), analytic=analytic, data=data.cpu().numpy(),
                seconds=(t1 - t0, t2 - t1, t3 - t2), layout=[str(d) for d in devices], sizes=(pool, k, steps))


def _multi_axis_quadrature(y) -> float:
    """tests/test_parallel.py::test_multi_axis_nested_sampling's oracle: the
    mu integral in closed form, log sigma by 400-point Gauss-Legendre."""
    xb, wb = np.polynomial.legendre.leggauss(400)
    ls, wls = 2.0 * xb, 2.0 * wb
    sig2 = np.exp(2.0 * ls)
    n_obs = y.shape[0]
    log_inner = (-0.5 * (n_obs - 1) * np.log(2 * np.pi * sig2) - 0.5 * np.sum((y - y.mean()) ** 2) / sig2
                 - 0.5 * np.log(n_obs))
    mx = log_inner.max()
    return float(mx + np.log(np.sum(wls * np.exp(log_inner - mx))) - np.log(10.0) - np.log(4.0))


def _phase21h_ns(smi, dev, pending=None, **kw):
    """21h's gates on :func:`_mesh_ns_oracle`'s readings (``pending``: its
    result from 18b's pool, or None to run it here): the pool-sharded run
    within 4 sigma of the analytic logZ and within 4 combined sigma of the
    single-device run; the multi-axis run within 4 sigma + 0.1 of the
    quadrature logZ."""
    t = time.perf_counter()
    r = _mesh_ns_oracle(str(dev), **kw) if pending is None else pending.get()
    wait = time.perf_counter() - t
    (lz, se, it), (lz1, se1, _), (lzm, sem, itm) = r["pool"], r["single"], r["multi"]
    quad = _multi_axis_quadrature(r["data"])
    z = (lz - r["analytic"]) / se
    ok = (abs(z) < 4.0 and abs(lz - lz1) < 4.0 * math.hypot(se, se1) and it > 50
          and abs(lzm - quad) < 4.0 * sem + 0.1 and itm > 10)
    if not ok:
        raise AssertionError(f"21h mesh NS: {r}; quadrature {quad}")
    where = ("in this process" if pending is None else
             f"in a worker process of 18b's pool from phase 18 on, waited for {wait:.1f} s here")
    pool, k, steps = r["sizes"]
    log(f"[21h mesh NS] the headline problem (2-D Gaussian box), pool {pool}, {k} deletions, {steps} AM steps, f64, "
        f"{MESH_SHARDS} live shards ({', '.join(r['layout'])}): logZ {lz:.4f} +- {se:.4f} against analytic "
        f"{r['analytic']:.4f} (z {z:+.2f}, gate 4), single-device run {lz1:.4f} +- {se1:.4f} (gate 4 combined sigma), "
        f"{it} iterations; runs x live x data (2, 2, 2) on the JAX test's 64 observations: logZ {lzm:.4f} +- "
        f"{sem:.4f} against quadrature {quad:.4f} (gate 4 sigma + 0.1), {itm} iterations; seconds "
        f"{', '.join(f'{s:.1f}' for s in r['seconds'])} {where} | {smi}")


def _phase21_repair_check(smi, dev, n=1024):
    """The blocked Cholesky on the last card (its shared-memory limits set
    per device): one n = 1024 factor against the plain version where there
    are four cards; on one card it says the repair is untested."""
    from bayesianinference_tpu_torch.ops import gp_kernels as gk

    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if count < MESH_SHARDS:
        log(f"[21 blocked Cholesky on another card] {max(count, 1)} device(s): the per-device shared-memory "
            f"limits of csrc/cholesky.cu's blocked path are untested here (they need a second card) | {smi}")
        return
    last = torch.device("cuda", count - 1)
    x, _ = _mesh_gp_data(n, last, torch.float64, seed=4)
    with torch.no_grad():
        k = gk.covariance_matrix(gk.se_kernel(1.0, 1.0), x, nugget=0.1, symmetrize=False)
        got, want = gk.cholesky(k), gk.cholesky_plain(k)
        err = ((got - want).abs().max() / want.abs().max()).item()
    if not err <= TOL["chol"][torch.float64]:
        raise AssertionError(f"21: blocked Cholesky on {last}: rel err {err}")
    log(f"[21 blocked Cholesky on another card] n={n} f64 on {last} (the blocked path): against the plain version "
        f"rel err {err:.2e} (gate 1e-10) | {smi}")


def phase_multi_card(smi: str, dev="cuda", mesh_ns=None, **sizes):
    """Phase 21: the multi-card engines on a 4-shard mesh (module docstring).
    ``mesh_ns`` is the pending result of 21h's runs in 18b's pool, or None
    to run them here.  ``sizes`` shrink 21a-h for a rehearsal (``gp``,
    ``conjugate``, ``big``, ``ns``: keyword arguments of each sub-phase).
    Returns the launches of 21a-g's sharded calls."""
    from bayesianinference_tpu_torch.parallel import make_mesh

    dev = torch.device(dev)
    devices = _mesh_devices(dev)
    mesh = make_mesh(("data",), devices=devices)
    layout = "one shard a card" if len(set(devices)) == MESH_SHARDS else f"all {MESH_SHARDS} on {devices[0]}"
    log(f"[21 mesh] {MESH_SHARDS} shards ({layout}): {', '.join(str(d) for d in devices)}")
    t0 = time.perf_counter()
    counted, seconds = _Counted(), []
    with _KernelWatch() as watch:
        for tag, run in (("21a-e", lambda: _phase21_gp(smi, counted, mesh, devices, dev, **sizes.get("gp", {}))),
                         ("21f", lambda: _phase21_conjugate(smi, counted, mesh, dev, **sizes.get("conjugate", {}))),
                         ("21g", lambda: _phase21_big(smi, counted, mesh, devices, dev, **sizes.get("big", {})))):
            t = time.perf_counter()
            big_check = run()
            seconds.append(f"{tag} {time.perf_counter() - t:.1f}")
        checked = watch.check("21")
    t = time.perf_counter()
    big_check()
    seconds.append(f"21g's reference {time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    _phase21_repair_check(smi, dev)
    _phase21h_ns(smi, dev, mesh_ns, **sizes.get("ns", {}))
    seconds.append(f"21h {time.perf_counter() - t:.1f}")
    total = counted.total
    if not (total["se_covariance"] > 0 and total["cholesky"] > 0):
        raise AssertionError(f"21: launches {total}")
    log(f"[21 multi-card engines] {time.perf_counter() - t0:.1f} s ({', '.join(seconds)}); launches of the sharded "
        f"calls {total}; {checked}")
    return total


EXAMPLES = Path(__file__).resolve().parent / "examples_torch"
EXAMPLE_WORKERS = 4  # phase 22's example processes at once, beside phases 6-20
EXAMPLE_TIMEOUT = 1100  # seconds for one example at smoke size, its checks included
# the examples by their card seconds at smoke size, the longest first (PERF.md, phase 22's table); left out for the
# 1200 s limit (PERF.md, PR 17): 16 (714 s at smoke size on the card), 30 (no end in 1500 s), and 10, 18 and 27
# (473, 405 and 311 s: with them, six processes at a time, the script took 959 s against 740 s)
EXAMPLE_ORDER = ("03", "26", "13", "19", "09", "11", "12", "01", "25", "17", "06", "14", "20", "04", "05", "29",
                 "08", "02", "22", "31", "21", "15", "24", "23", "07", "28")
GP_EXAMPLES = ("03", "09", "17", "19", "20", "21", "22", "29")  # the examples whose path runs both kernels


class _ExamplePool:
    """Phase 22's example processes: ``python examples_torch/gates.py NN`` at
    smoke size on the card, one CPU thread each, ``EXAMPLE_WORKERS`` at a
    time, each with its own time limit; :meth:`reading` waits for one
    example's JSON line, :meth:`close` kills every process still running."""

    def __init__(self, numbers):
        from concurrent.futures import ThreadPoolExecutor

        self.numbers = tuple(numbers)
        self._procs, self._lock, self._closed = [], threading.Lock(), False
        self.started = time.perf_counter()
        self._executor = ThreadPoolExecutor(EXAMPLE_WORKERS)
        self._futures = {n: self._executor.submit(self._one, n) for n in numbers}

    def _one(self, number: str) -> dict:
        env = {k: v for k, v in os.environ.items() if k != "BI_EXAMPLE_DEVICE"}
        env.update(BI_EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1")
        with self._lock:
            if self._closed:
                raise RuntimeError("phase 22's pool was closed")
            proc = subprocess.Popen([sys.executable, str(EXAMPLES / "gates.py"), number], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=env, cwd=str(EXAMPLES.parent))
            self._procs.append(proc)
        t = time.perf_counter()
        try:
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"22 example {number}: no end within its {EXAMPLE_TIMEOUT} s") from None
        if proc.returncode != 0:
            raise AssertionError(f"22 example {number}: exit code {proc.returncode}\n{err[-4000:]}")
        reading = json.loads(out.strip().splitlines()[-1])
        reading["wall"] = time.perf_counter() - t
        reading["done_at"] = time.perf_counter() - self.started
        return reading

    def reading(self, number: str) -> dict:
        return self._futures[number].result()

    def close(self):
        with self._lock:
            self._closed = True
            for proc in self._procs:
                if proc.poll() is None:
                    proc.kill()
        self._executor.shutdown(wait=True, cancel_futures=True)


def phase_examples(smi: str, pool: _ExamplePool):
    """Phase 22: every port example's reading from ``pool`` (started after
    phase 5), its checks passed and its launches counted."""
    total = {"se_covariance": 0, "cholesky": 0}
    for number in sorted(pool.numbers):
        r = pool.reading(number)
        if r["smoke"] is not True or not r["checks"]:
            raise AssertionError(f"22 {r['example']}: not a checked smoke run: {r}")
        launches = r["launches"]
        if number in GP_EXAMPLES and min(launches.values()) == 0:
            raise AssertionError(f"22 {r['example']}: a GP example that did not launch both kernels: {launches}")
        for k in total:
            total[k] += launches[k]
        log(f"[22 {r['example']}] {r['wall']:.1f} s in its process ({r['seconds']:.1f} s the example), done "
            f"{r['done_at']:.0f} s after the pool started; launches SE {launches['se_covariance']} Cholesky "
            f"{launches['cholesky']}; peak device memory {r['peak_mib'] or 0:.0f} MiB; {len(r['checks'])} checks passed: "
            + "; ".join(r["checks"]) + f" | {smi}")
    sys.path.insert(0, str(EXAMPLES))
    import gates

    log(f"[22 examples] {len(pool.numbers)} examples at smoke size on the card, {EXAMPLE_WORKERS} at a time: all "
        f"checks passed, launches {total}, the pool's wall {time.perf_counter() - pool.started:.0f} s (left out for "
        f"the 1200 s limit: {', '.join(n for n in gates.NUMBERS if n not in pool.numbers)}) | {smi}")
    return total


def main():
    t0 = time.perf_counter()

    took = {}

    def timed(phase, *args):
        """Run a phase and print the script's seconds so far, the phase's
        seconds, and its seconds in the timing and profiling helpers."""
        before, t = _MEASURING["seconds"], time.perf_counter()
        out = phase(*args)
        took[phase.__name__] = time.perf_counter() - t
        log(f"[seconds] {phase.__name__} done at {time.perf_counter() - t0:.0f} s, took "
            f"{took[phase.__name__]:.1f} s ({_MEASURING['seconds'] - before:.1f} s of it timing and profiling)")
        return out

    smi = timed(phase_device)
    worst = timed(phase_kernel_parity)
    spine = timed(phase_ns_spine, smi)
    launches, problem, ns_logz, gp_rate, gp_posterior = timed(phase_gp_slice, smi)
    times, big = timed(phase_kernel_times, smi)
    # phase 22's examples in their own processes beside phases 6-20, after the kernel times of phase 5
    examples = _ExamplePool(EXAMPLE_ORDER)
    _BESIDE_EXAMPLES.append(examples)
    try:
        grad_launches, _ = timed(phase_gp_grad, smi)
        laplace_launches, _ = timed(phase_laplace, smi, problem, ns_logz)
        ard_launches = timed(phase_gp_ard, smi)
        timed(phase_checkpoint_dynamic, smi)
        t11 = time.perf_counter()
        par_launches = timed(phase_parallel_ns, smi, spine, gp_rate)
        conj_launches = timed(phase_conjugate, smi)
        log(f"[seconds] phases 11 and 12 took {time.perf_counter() - t11:.0f} s")
        # phase 8's runs and 16a's fits (no hand-written kernel) in two worker processes beside phases 13-17, after
        # the kernel times of phase 5; phase 8 gated after phase 17
        highdim = _ns_highdim_start()
        try:
            sampler_launches = timed(phase_samplers, smi, problem, gp_posterior)
            latent_launches = timed(phase_latent_gp, smi)
            svgp_launches = timed(phase_svgp_bo, smi)
            vi_launches = timed(phase_vi_pathfinder, smi, problem, gp_posterior, "cuda", highdim[2])
            consumption_launches = timed(phase_consumption, smi, problem, gp_posterior)
            timed(phase_ns_highdim, smi, highdim)
        finally:
            highdim[0].terminate()
            highdim[0].join()
        flow_launches, pool = timed(phase_flow_bnn, smi, problem, gp_posterior, "cuda", {}, {}, {})
        try:
            series_launches = timed(phase_time_series, smi, pool[:2])
            engines_launches = timed(phase_parallel_engines, smi, problem, gp_posterior, "cuda", pool[2])
            example_launches = timed(phase_examples, smi, examples)
            _BESIDE_EXAMPLES.clear()
            mesh_launches = timed(phase_multi_card, smi, "cuda", pool[3])
        finally:
            pool[0].terminate()
            pool[0].join()
        total_s = time.perf_counter() - t0
        log(f"[seconds] all phases {total_s:.0f} s, {_MEASURING['seconds']:.0f} s of them timing and profiling; phase 4 "
            f"(the host's yardstick) {took['phase_gp_slice']:.1f} s, phase 20 {took['phase_parallel_engines']:.1f} s, "
            f"phase 21 {took['phase_multi_card']:.1f} s, phase 22 {took['phase_examples']:.1f} s of main-process wall; "
            f"{1200 - total_s:.0f} s left of the 1200 s limit")
        launches = {k: launches[k] + grad_launches[k] + laplace_launches[k] + ard_launches[k] + par_launches[k]
                    + conj_launches[k] + sampler_launches[k] + latent_launches[k] + svgp_launches[k] + vi_launches[k]
                    + consumption_launches[k] + flow_launches[k] + series_launches[k] + engines_launches[k]
                    + mesh_launches[k] + example_launches[k] for k in launches}
        # times at the slice's shape (B = 10, n = 512, f64); the Cholesky also
        # at bench.py's width (B = 1, n = 16384, f32)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_per_call")
        print(json.dumps({"kernels": [
            {"name": "se_covariance", "route": "cuda", "source": SE_SOURCE, "replaces": SE_REPLACES,
             "launches": launches["se_covariance"], "max_abs_err": worst["se_covariance"],
             **{k: times[("se_covariance", "f64")][k] for k in keys}},
            {"name": "cholesky", "route": "cuda", "source": CHOL_SOURCE, "replaces": CHOL_REPLACES,
             "launches": launches["cholesky"], "max_abs_err": worst["cholesky"],
             **{k: times[("cholesky", "f64")][k] for k in keys}, "at_n16384_f32": big},
        ]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                "count": torch.cuda.device_count()}}))
    finally:
        examples.close()


if __name__ == "__main__":
    main()
