"""Sparse GP regression at a data size the dense logML cannot touch.

The dense Cholesky logML is O(n^3) in time and O(n^2) in memory; the
collapsed Titsias bound (`define_sparse_gaussian_process`)
is O(n m^2)/O(n m) with m inducing points.  This example fits GP
hyperparameters on n = 20,000 points with m = 64 inducing points via a
Laplace fit over the bound, then draws calibrated posterior predictives
through the same `predict_from_gaussian_process` front-end the dense GP
uses.

Run:  python examples_torch/17_sparse_gp.py
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os as _os
import sys as _sys
import time

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the smoke runners
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import numpy as np
import torch

from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import (
    define_sparse_gaussian_process,
    laplace_posterior_fit,
    predict_from_gaussian_process,
)
from bayesianinference_tpu_torch.ops import se_kernel

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

rng = np.random.default_rng(2)
n = 2_000 if SMOKE else 20_000
x = np.sort(rng.uniform(-3, 3, size=n))[:, None]
y = np.sin(1.5 * x[:, 0]) + 0.3 * np.cos(6.0 * x[:, 0]) + 0.1 * rng.normal(size=n)

problem = define_sparse_gaussian_process(
    torch.as_tensor(x, device=DEVICE),
    torch.as_tensor(y, device=DEVICE),
    kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
    nugget_builder=lambda th: th[2] ** 2,
    parameters=[("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)],
    prior_distribution=["scale", "scale", "scale"],
    inducing=16 if SMOKE else 64,  # greedy farthest-point selection
)

t0 = time.perf_counter()
fit = laplace_posterior_fit(problem=problem, generator=torch.Generator(DEVICE).manual_seed(0))
print(f"Laplace fit over the SGPR bound: {time.perf_counter() - t0:.1f} s")
amp, length, noise = fit.mean.cpu().numpy()
print(f"MAP hyperparameters: amp={amp:.3f} length={length:.3f} noise={noise:.3f}")
print(f"log evidence (collapsed-bound Laplace): {float(fit.log_evidence):.1f}")

# posterior predictive on a dense grid, mixing 64 hyperparameter draws
xq = np.linspace(-3.2, 3.2, 300)[:, None]
thetas = fit.posterior_distribution.sample(torch.Generator(DEVICE).manual_seed(1), (64,))
mix = predict_from_gaussian_process(thetas, problem, torch.as_tensor(xq, device=DEVICE))

truth = np.sin(1.5 * xq[:, 0]) + 0.3 * np.cos(6.0 * xq[:, 0])
rmse = float(np.sqrt(np.mean((mix.mean().cpu().numpy() - truth) ** 2)))
print(f"predictive RMSE vs noiseless truth on the grid: {rmse:.4f}")

sub = rng.choice(n, 400, replace=False)  # don't scatter 20k points

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped sparse_gp_fit.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from bayesianinference_tpu_torch.viz import regression_plot_1d

    fig = regression_plot_1d(
        fit, mix, xq[:, 0], x_data=x[sub, 0], y_data=y[sub],
        title=f"Sparse GP (n=20k, m=64): RMSE {rmse:.3f}",
    )
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "sparse_gp_fit.png"), dpi=110)
    print("wrote sparse_gp_fit.png")
