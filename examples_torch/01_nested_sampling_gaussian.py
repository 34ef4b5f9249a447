"""Minimum end-to-end slice: nested sampling on a 2-D Gaussian likelihood
under a uniform prior, with the analytic evidence as the oracle.

Run:  python examples_torch/01_nested_sampling_gaussian.py
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os as _os
import sys as _sys

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the smoke runners
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import numpy as np
import scipy.stats as st
import torch

from bayesianinference_tpu_torch import dists as d
from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

A = 5.0  # prior box half-width

problem = define_inference_problem(
    parameters=[("x", -A, A), ("y", -A, A)],
    log_likelihood=lambda th: torch.sum(d.Normal(0.0, 1.0).log_prob(th)),
    prior_distribution=["location", "location"],
    device=DEVICE,
    dtype=torch.float64,
)

result = nested_sampling(
    problem,
    torch.Generator(DEVICE).manual_seed(0),
    sample_pool_size=100,
    monte_carlo_steps=100,
    max_iterations=2000,
    progress_callback=lambda it, n, lz, h: print(
        f"  iter {int(it):5d}  samples {int(n):6d}  logZ {float(lz):8.3f}  H {float(h):6.2f}"
    ),
    progress_interval=200,
)

mass = st.norm.cdf(A) - st.norm.cdf(-A)
analytic = 2 * (np.log(mass) - np.log(2 * A))
print(f"logZ = {result.log_evidence}   (analytic {analytic:.4f})")
print(f"E[x, y] = {result.parameter_expected_values.mean.cpu().numpy().round(3)}")
print(f"relative entropy = {result.relative_entropy}")
print(f"{result.num_likelihood_evals} likelihood evaluations, "
      f"{result.iterations} iterations")

# posterior summary table: weighted quantiles + Kish effective sample size
from bayesianinference_tpu_torch.results import summary

print()
print(summary(result))
