"""Conjugate Bayesian linear regression: polynomial fitting with exact
evidence-based model comparison (the reference README's flagship use).

Run:  python examples_torch/02_bayesian_linear_regression.py
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
from bayesianinference_tpu_torch.engines import bayesian_linear_regression

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

rng = np.random.default_rng(0)
x = rng.uniform(-2, 2, size=(80, 1))
y = 0.5 - 1.2 * x[:, 0] + 0.8 * x[:, 0] ** 2 + 0.4 * rng.normal(size=80)

print("model comparison by exact log evidence:")
results = {}
for degree in range(5):
    res = bayesian_linear_regression(torch.as_tensor(x, device=DEVICE), torch.as_tensor(y, device=DEVICE),
                                     degree=degree)
    results[degree] = res
    print(f"  degree {degree}: logZ = {float(res.log_evidence):9.3f}")

best = max(results, key=lambda k: float(results[k].log_evidence))
res = results[best]
print(f"best degree: {best} (true: 2)")
print(f"coefficients: {res.posterior_parameters.b.cpu().numpy().round(3)} "
      f"(true: [0.5, -1.2, 0.8])")

pred = res.predictive_distribution(torch.tensor([[1.0]], dtype=torch.float64, device=DEVICE))
print(f"predictive at x=1: {float(pred.mean()[0]):.3f} ± {float(pred.std()[0]):.3f} "
      f"(true value 0.1)")
coeff_dist = res.posterior["RegressionCoefficientDistribution"]
print(f"coefficient posterior covariance diag: "
      f"{coeff_dist.covariance().cpu().numpy().diagonal().round(5)}")
