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
   chains; pool 400, 200 deletions, 40 updates) and d = 72 through ``auto``
   with no overrides of the chains (the constrained-HMC chains: 108
   four-step trajectories at eps = 0.8 / sqrt(72); pool 512, 384
   deletions), each within 4 max(sigma, 0.2) of the analytic logZ;
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
    with its default chain length against the analytic logZ and the static
    run's posterior ESS.

Each of phases 4, 6, 7 and 9 zeroes the kernels' launch counters before it
drives its path and fails if a kernel was not launched; the ``launches``
of the JSON line are their sum.  Phase 5 fails unless each kernel is one
CUDA kernel launch per call at the slice's shape, and unless
``covariance_matrix(se_kernel(...), x, nugget)`` is one CUDA kernel in all.

The line before the last is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time
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
    direct-difference form (at most 2^24 elements of [rows, n2, d])."""
    other = x1 if x2 is None else x2
    step = max(1, gk._DIRECT_SQDIST_MAX_ELEMS // (other.shape[1] * other.shape[2]))
    k = torch.cat([gk.se_covariance_plain(x1[:, i:i + step], other, var, scale)
                   for i in range(0, x1.shape[1], step)], dim=1)
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


def _time_ms(fn, reps: int = 20, groups: int = 5, per_group: int = 20):
    """(device ms per call, wall ms per call) of ``fn``, each a median after
    a warm-up, timed with CUDA events.

    Device time: ``per_group`` calls enqueued back to back behind a ~50 ms
    ``torch.cuda._sleep``, so the host's dispatch overlaps the sleep and
    the events see only device work; median of ``groups``.  Wall time: one
    call between the events with an idle device, host dispatch included;
    median of ``reps``."""
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
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / per_group)
    return statistics.median(device), statistics.median(wall)


def _in_turns(kern, plain, **kw):
    """plain, kernel, kernel, plain; each pair's median of
    (device ms, wall ms): (kernel device, plain device, kernel wall, plain wall)."""
    p1, k1, k2, p2 = _time_ms(plain, **kw), _time_ms(kern, **kw), _time_ms(kern, **kw), _time_ms(plain, **kw)
    return tuple(statistics.median(pair) for pair in ((k1[0], k2[0]), (p1[0], p2[0]), (k1[1], k2[1]), (p1[1], p2[1])))


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
    return launches, problem, (logz, err)


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


def _gaussian_box_problem(dim: int):
    """The analytic oracle: a standard Gaussian likelihood under the uniform
    box [-5, 5]^dim, logZ = dim * log(erf(5 / sqrt 2) / 10)."""
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models.problem import define_inference_problem

    problem = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(dim)],
        log_likelihood=lambda th: torch.sum(Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim,
        device=torch.device("cuda"), dtype=torch.float64,
    )
    return problem, dim * (math.log(math.erf(5.0 / math.sqrt(2.0))) - math.log(10.0))


def phase_ns_highdim(smi: str):
    """Nested sampling above d = 16 on the analytic oracle, float64, through
    ``monte_carlo_method="auto"``: (a) d = 32 takes the slice chains, (b)
    d = 72 the constrained-HMC chains with the dimension laws' defaults."""
    from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling, resolve_monte_carlo_method

    dev = torch.device("cuda")
    cases = (
        # the JAX tests' runs (tests/test_nested_sampling.py) with more deletions per iteration, which cuts the
        # iterations to a fifth and a half: each run is host-bound, minutes long otherwise
        ("a", 32, "slice", 50, dict(sample_pool_size=400, max_iterations=400, min_iterations=40, monte_carlo_steps=40,
                                    num_delete=200)),
        ("b", 72, "chmc", 256, dict(sample_pool_size=512, max_iterations=150, min_iterations=20, num_delete=384,
                                    post_process_sampling_runs=20)),
    )
    for tag, dim, expect, jax_delete, kw in cases:
        problem, analytic = _gaussian_box_problem(dim)
        method = resolve_monte_carlo_method("auto", dim, gradient_check=problem.gradient_sanity)
        if method != expect:
            raise AssertionError(f"NS d={dim}: auto resolved to {method}, expected {expect}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nested_sampling(problem, torch.Generator(device=dev).manual_seed(0), **kw)
        logz, err = float(res.log_evidence.mean), float(res.log_evidence.standard_error)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = float(res.acceptance_rates[: res.generated_nested_samples].mean())
        if not (math.isfinite(logz) and math.isfinite(err) and abs(logz - analytic) <= 4 * max(err, 0.2)):
            raise AssertionError(f"NS d={dim} ({method}): logZ {logz} +- {err}, analytic {analytic:.3f}")
        log(f"[8{tag} NS d={dim}] auto -> {method}, pool {kw['sample_pool_size']}, num_delete {kw['num_delete']} "
            f"({jax_delete} in the JAX test's run; more here to fit the script's time): "
            f"logZ {logz:.3f} +- {err:.3f} (analytic {analytic:.3f}), {res.iterations} iterations, "
            f"{res.num_likelihood_evals} evals in {wall:.2f} s = {res.num_likelihood_evals / wall:.4g} evals/s, "
            f"mean recorded acceptance {acc:.3f} | {smi}")


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

    # dynamic NS with its defaults (pool 100, 4 batches, chains of 200 steps) but for 20 deletions per iteration
    # instead of 1: one chain per iteration is host-bound for minutes.  The static run beside it ends by the
    # evidence criterion; the dynamic run's base goes on to the loop's default of 100 iterations.
    ess = lambda r: float(1.0 / torch.sum(torch.exp(r.crude_log_posterior_weights) ** 2))  # noqa: E731
    dkw = dict(sample_pool_size=100, num_delete=20)
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
        f"(analytic {analytic:.4f}); {wall_ckpt:.2f} s. dynamic_nested_sampling (its defaults: pool 100, 200 steps, "
        f"4 batches; num_delete {dkw['num_delete']}, not its default 1, to fit the script's time): logZ {dz:.4f} +- {derr:.4f}, {dyn.total_samples} samples, {dyn.num_likelihood_evals} evals, "
        f"posterior ESS {ess(dyn):.1f} against the static run's {ess(base):.1f} ({base.total_samples} samples, "
        f"{base.iterations} iterations); "
        f"{wall_dyn:.2f} s | {smi}")


def main():
    t0 = time.perf_counter()

    def timed(phase, *args):
        """Run a phase and print the script's seconds so far."""
        out = phase(*args)
        log(f"[seconds] {phase.__name__} done at {time.perf_counter() - t0:.0f} s")
        return out

    smi = timed(phase_device)
    worst = timed(phase_kernel_parity)
    timed(phase_ns_spine, smi)
    launches, problem, ns_logz = timed(phase_gp_slice, smi)
    times, big = timed(phase_kernel_times, smi)
    grad_launches, _ = timed(phase_gp_grad, smi)
    laplace_launches, _ = timed(phase_laplace, smi, problem, ns_logz)
    timed(phase_ns_highdim, smi)
    ard_launches = timed(phase_gp_ard, smi)
    timed(phase_checkpoint_dynamic, smi)
    launches = {k: launches[k] + grad_launches[k] + laplace_launches[k] + ard_launches[k] for k in launches}
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


if __name__ == "__main__":
    main()
