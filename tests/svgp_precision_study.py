"""The SVGP precision studies behind ``chip_smoke.py`` 15a's and 15b-c's
gates, on the CPU.  Not collected by pytest.

``python tests/svgp_precision_study.py grad``
    15a's measure (the normalized error of [ELBO, gradient in theta, z, m,
    raw] against float64, root mean square over the data of seeds 1-8 at
    bench_svgp_step's width, K_zz's jitter 1e-4 in both dtypes) for four
    float32 paths: the SE op and the ``cholesky`` op with their reverse
    rules (15a's kernel path on the card), either op swapped for plain
    PyTorch under autograd, and both swapped (15a's plain path).  The SE
    swap isolates the op's input gradient in Gram form against direct
    differences; the Cholesky swap isolates the op's reverse rule.

``python tests/svgp_precision_study.py fits [binary|multiclass|hetero ...]``
    15b-c's float64 fits (100 Adam steps on the same draws) against
    themselves with K_zz's jitter 1e-6 moved by 1e-13 to 1e-6 of itself,
    and with K_zz factored in float32 (15b-c's control): the largest
    relative difference of the compared vector, and of the minibatch ELBO
    trace at steps 1, 10, 50 and 100.
"""

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from bayesianinference_tpu_torch.engines import svgp as sv  # noqa: E402
from bayesianinference_tpu_torch.ops import gp_kernels as gk  # noqa: E402
from bayesianinference_tpu_torch.ops import svgp as ops_svgp  # noqa: E402

torch.set_num_threads(4)


def plain_se(x1, x2, variance, lengthscale=None, nugget=None):
    x2 = x1 if x2 is None else x2
    scale = 1.0 if lengthscale is None else lengthscale
    return variance * torch.exp(-0.5 * gk.squared_distances(x1 / scale, x2 / scale))


def plain_cholesky(k):
    return torch.linalg.cholesky_ex(k)[0]


def grad_study():
    elbo = cs._svgp_elbo(cs.SVGP_N)
    sizes = [1, 2, 2 * cs.SVGP_M, cs.SVGP_M, cs.SVGP_M * cs.SVGP_M]
    paths = {"both ops": (False, False), "plain SE": (True, False), "plain Cholesky": (False, True),
             "both plain": (True, True)}
    errs = {p: {q: [] for q in cs._SVGP_QUANTITIES} for p in paths}
    for seed in cs.SVGP_SEEDS:
        args = cs._args(cs._svgp_bench_values(seed), "cpu", grad=4)
        ref = cs._per_quantity(cs._vg(elbo, *args[torch.float64]), sizes)
        for path, (se_plain, chol_plain) in paths.items():
            saved = gk.se_covariance, ops_svgp.cholesky
            gk.se_covariance = plain_se if se_plain else gk.se_covariance
            ops_svgp.cholesky = plain_cholesky if chol_plain else ops_svgp.cholesky
            try:
                got = cs._per_quantity(cs._vg(elbo, *args[torch.float32]).double(), sizes)
            finally:
                gk.se_covariance, ops_svgp.cholesky = saved
            for q in cs._SVGP_QUANTITIES:
                errs[path][q].append(float((got[q] - ref[q]).norm() / ref[q].norm()))
    for q in cs._SVGP_QUANTITIES:
        print(q, "  ".join(f"{p} {math.sqrt(np.mean(np.square(errs[p][q]))):.3e}" for p in paths), flush=True)


def fit_runs():
    rng = np.random.default_rng(3)
    xs = rng.uniform(-3, 3, size=(16384, 1))
    ys = (rng.uniform(size=16384) < 1 / (1 + np.exp(-3.0 * np.sin(1.5 * xs[:, 0])))).astype(float)
    bd = sv.svgp_draws(torch.Generator().manual_seed(1), 100, 16384, 1024)
    xc, yc = cs._three_class_data(8192)
    mc = sv.svgp_draws(torch.Generator().manual_seed(2), 100, 8192, 1024, num_mc=8, num_classes=3,
                       dtype=torch.float64)
    xh, yh = cs._hetero_data(8192)
    hd = sv.svgp_draws(torch.Generator().manual_seed(3), 100, 8192, 1024)
    hp = [("amp_f", 0.05, 10.0), ("ls_f", 0.1, 5.0), ("amp_g", 0.05, 5.0), ("ls_g", 0.3, 5.0)]
    common = dict(inducing=64, minibatch=1024, steps=100)

    def binary(j):
        f = sv.fit_svgp(torch.as_tensor(xs), torch.as_tensor(ys), cs._amp_ls_kernel, cs._AMP_LS, draws=bd, jitter=j,
                        **common)
        return f, ("elbo_trace", "theta", "z")

    def multiclass(j):
        f = sv.fit_svgp_multiclass(torch.as_tensor(xc), torch.as_tensor(yc), cs._amp_ls_kernel, cs._AMP_LS,
                                   draws=mc, jitter=j, **common)
        return f, ("elbo_trace", "theta", "m")

    def hetero(j):
        f = sv.fit_svgp_heteroscedastic(torch.as_tensor(xh), torch.as_tensor(yh), cs._amp_ls_kernel,
                                        lambda th: cs._amp_ls_kernel(th[2:]), hp, learning_rate=0.03, draws=hd,
                                        jitter=j, **common)
        return f, ("elbo_trace", "theta", "noise_bias")

    return {"binary": binary, "multiclass": multiclass, "hetero": hetero}


def fits_study(which):
    runs = fit_runs()
    for name in which or list(runs):
        def run(jitter):
            f, fields = runs[name](jitter)
            return f.elbo_trace.double(), torch.cat([cs._fit_fields(f, fields), f.elbo.double().reshape(1)])

        trace0, base = run(1e-6)
        for change in (1e-13, 1e-10, 1e-8, 1e-6, "K_zz factored in float32"):
            if isinstance(change, str):
                with cs._f32_factor():
                    trace, got = run(1e-6)
                label = change
            else:
                trace, got = run(1e-6 * (1.0 + change))
                label = f"jitter x (1 + {change:g})"
            d = ((trace - trace0).abs() / trace0.abs().max()).numpy()
            print(f"{name}, {label}: {cs._rel_max(got, base):.3e}; trace at steps 1, 10, 50, 100: "
                  + " ".join(f"{d[k]:.1e}" for k in (0, 9, 49, 99)), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["grad"]:
        grad_study()
    elif args[:1] == ["fits"]:
        fits_study(args[1:])
    else:
        sys.exit(__doc__)
