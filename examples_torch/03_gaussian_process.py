"""Gaussian-process regression with full hyperparameter posteriors via
nested sampling, and batched posterior prediction.  The covariance and its
factor go through the port's hand-written CUDA kernels on the card.

Run:  python examples_torch/03_gaussian_process.py        (writes gp_fit.png)
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os as _os
import sys as _sys

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the smoke runners
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import numpy as np
import torch

from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import define_gaussian_process, predict_from_gaussian_process
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.ops import se_kernel

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

rng = np.random.default_rng(1)
x = np.sort(rng.uniform(-3, 3, size=50))[:, None]
y = np.sin(1.5 * x[:, 0]) + 0.1 * rng.normal(size=50)

problem = define_gaussian_process(
    torch.as_tensor(x, device=DEVICE),
    torch.as_tensor(y, device=DEVICE),
    kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
    nugget_builder=lambda th: th[2] ** 2,
    parameters=[("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)],
    prior_distribution=["scale", "scale", "scale"],
)
result = nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(0), sample_pool_size=100,
    monte_carlo_steps=100, max_iterations=1500,
)
print(f"logZ = {result.log_evidence}")
print("hyperparameter posterior means:",
      result.parameter_expected_values.mean.cpu().numpy().round(3))

xq = np.linspace(-3.2, 3.2, 80)[:, None]
pred = predict_from_gaussian_process(result, problem, torch.as_tensor(xq, device=DEVICE))
try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped gp_fit.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    from bayesianinference_tpu_torch.viz import regression_plot_1d

    fig = regression_plot_1d(result, pred, xq[:, 0], x_data=x, y_data=y)
    fig.savefig("gp_fit.png", dpi=120)
    print("wrote gp_fit.png")
