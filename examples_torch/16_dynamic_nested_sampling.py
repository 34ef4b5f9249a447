"""Dynamic nested sampling: spend likelihood evaluations where the
posterior lives.

Static NS walks the whole prior volume down at constant resolution, so
most samples carry negligible posterior weight.  Dynamic NS (Higson et
al. 2019) re-invests the budget: after a base run, batch runs inject
live points only inside the importance window, multiplying the
effective posterior sample count at equal statistical validity — the
merged variable-pool run keeps exact shrinkage bookkeeping and
calibrated logZ error bars.

Run:  python examples_torch/16_dynamic_nested_sampling.py
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
from bayesianinference_tpu_torch.engines import dynamic_nested_sampling
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# a 3-parameter regression posterior occupying a tiny prior fraction
rng = np.random.default_rng(11)
n = 60
x = np.sort(rng.uniform(-2, 2, n))
y = 0.6 + 1.3 * x + 0.35 * rng.normal(size=n)
data = {"x": torch.as_tensor(x, device=DEVICE), "y": torch.as_tensor(y, device=DEVICE)}

problem = define_inference_problem(
    parameters=[("a", -10.0, 10.0), ("b", -10.0, 10.0),
                ("sigma", 0.01, 5.0)],
    log_likelihood=lambda th, data: torch.sum(
        d.Normal(th[0] + th[1] * data["x"], th[2]).log_prob(data["y"])
    ),
    data=data,
    prior_distribution=["location", "location", "scale"],
    validate=False,
)


def ess(result):
    w = np.exp(result.crude_log_posterior_weights.cpu().numpy())
    return 1.0 / np.sum(w**2)


static = nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(0), sample_pool_size=100,
    monte_carlo_steps=100,
)
print(
    f"static   logZ {float(static.log_evidence.mean):+.3f} "
    f"± {float(static.log_evidence.standard_error):.3f}   "
    f"samples {static.total_samples:5d}  posterior ESS {ess(static):6.0f}  "
    f"evals {static.num_likelihood_evals:,}"
)

dynamic = dynamic_nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(0), sample_pool_size=100,
    num_batches=3, monte_carlo_steps=100,
    posterior_fraction=1.0,  # all batches target the posterior bulk
)
print(
    f"dynamic  logZ {float(dynamic.log_evidence.mean):+.3f} "
    f"± {float(dynamic.log_evidence.standard_error):.3f}   "
    f"samples {dynamic.total_samples:5d}  posterior ESS {ess(dynamic):6.0f}  "
    f"evals {dynamic.num_likelihood_evals:,}"
)
print(
    f"-> ESS per 1k evals: static "
    f"{1000 * ess(static) / static.num_likelihood_evals:.1f}, dynamic "
    f"{1000 * ess(dynamic) / dynamic.num_likelihood_evals:.1f}"
)

# posterior moments agree between the two estimators
ms = static.parameter_expected_values.mean.cpu().numpy()
md = dynamic.parameter_expected_values.mean.cpu().numpy()
for i, nm in enumerate(problem.param_names):
    print(f"  {nm:6s} static {ms[i]:+.3f}   dynamic {md[i]:+.3f}")
