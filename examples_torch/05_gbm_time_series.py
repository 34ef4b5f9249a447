"""Geometric Brownian motion: infer drift and volatility from irregularly
sampled prices by nested sampling, then the posterior predictive median
path.

Run:  python examples_torch/05_gbm_time_series.py
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

from bayesianinference_tpu_torch import dists as d
from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.results import regression_predictive_distribution

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

mu_true, sigma_true, s0 = 0.3, 0.25, 1.0
rng = np.random.default_rng(2)
t = np.sort(rng.uniform(0.05, 3.0, size=150))
y = s0 * np.exp(
    (mu_true - sigma_true**2 / 2) * t + sigma_true * rng.normal(size=150) * np.sqrt(t)
)


def gen_dist(th, times):
    mu, sigma = th[0], th[1]
    tt = times[:, 0]
    return d.LogNormal(
        loc=np.log(s0) + (mu - sigma**2 / 2) * tt, scale=sigma * torch.sqrt(tt)
    )


problem = define_inference_problem(
    parameters=[("mu", -2.0, 2.0), ("sigma", 0.01, 2.0)],
    likelihood=gen_dist,
    data=torch.as_tensor(y, device=DEVICE),
    independent_variables=torch.as_tensor(t, device=DEVICE)[:, None],
    prior_distribution=["location", "scale"],
)
result = nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(0),
    sample_pool_size=32 if SMOKE else 100,
    monte_carlo_steps=20 if SMOKE else 80,
)
est = result.parameter_expected_values.mean.cpu().numpy()
err = result.parameter_expected_values.standard_error.cpu().numpy()
print(f"mu    = {est[0]:.3f} ± {err[0]:.3f}   (true {mu_true})")
print(f"sigma = {est[1]:.3f} ± {err[1]:.3f}   (true {sigma_true})")
print(f"logZ  = {result.log_evidence}")

tq = np.linspace(0.2, 2.5, 10)[:, None]
pred = regression_predictive_distribution(result, gen_dist, torch.as_tensor(tq, device=DEVICE))
med = pred.quantile(0.5).cpu().numpy()
print("predictive median path:", med.round(3))
