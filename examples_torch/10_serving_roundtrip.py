"""Production serving round-trip: fit, persist the posterior artifact,
reload it in a fresh process on the card, and serve predictions from the
loaded copy; then a fit-per-request loop through ``problem.with_data``.

Run:  python examples_torch/10_serving_roundtrip.py
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os
import subprocess
import sys
import tempfile

# make the example runnable from anywhere without installing the package
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# tiny sizes under the smoke runners
SMOKE = os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import numpy as np
import torch

from bayesianinference_tpu_torch import dists as d
from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import save_result
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- fit: Gaussian mean/scale inference ----
rng = np.random.default_rng(0)
data = torch.as_tensor(rng.normal(1.2, 0.7, size=200), device=DEVICE)
problem = define_inference_problem(
    parameters=[("mu", -5.0, 5.0), ("sigma", 0.05, 5.0)],
    likelihood=lambda th: d.Normal(th[0], th[1]),
    data=data,
    prior_distribution=["location", "scale"],
)
result = nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(0),
    sample_pool_size=48 if SMOKE else 100,
    max_iterations=1500, monte_carlo_steps=25 if SMOKE else 80,
)
_tmp = tempfile.TemporaryDirectory()
path = os.path.join(_tmp.name, "posterior.npz")
save_result(path, result)
print(f"fit: logZ = {result.log_evidence}; artifact -> {path}")

# ---- serve: a FRESH interpreter loads the artifact onto the device and predicts ----
serve_code = f"""
import sys
sys.path.insert(0, {_REPO!r})
import numpy as np, torch
from bayesianinference_tpu_torch import dists as d
from bayesianinference_tpu_torch.engines import load_result
from bayesianinference_tpu_torch.results import predictive_distribution

result = load_result({path!r}, device={str(DEVICE)!r})
print("loaded: logZ =", result.log_evidence,
      "| posterior mean =", np.round(result.parameter_expected_values.mean.cpu().numpy(), 3))
pred = predictive_distribution(result, lambda th: d.Normal(th[0], th[1]))
q = pred.quantile(torch.tensor([0.05, 0.5, 0.95], dtype=torch.float64, device={str(DEVICE)!r}))
print("posterior-predictive quantiles:", np.round(q.cpu().numpy(), 3))
"""
out = subprocess.run(
    [sys.executable, "-c", serve_code],
    capture_output=True,
    text=True,
)
print(out.stdout.strip())
_tmp.cleanup()
if out.returncode != 0:
    print(out.stderr, file=sys.stderr)
    raise SystemExit(1)

# ---- serve: a fit-per-request loop over FRESH datasets ----
# The problem carries its observations as a field, so problem.with_data(new)
# reuses the problem and its likelihood; the first fit's wall also holds the
# process's first use of the device (CUDA initialisation on the card).
import time

rng = np.random.default_rng(0)
problem = define_inference_problem(
    parameters=[("mu", -5.0, 5.0), ("log_sigma", -2.0, 2.0)],
    likelihood=lambda th: d.Normal(th[0], torch.exp(th[1])),
    data=torch.as_tensor(rng.normal(0.0, 1.0, 64), device=DEVICE),
    prior_distribution=["location", "location"],
)
t0 = time.perf_counter()
nested_sampling(problem, torch.Generator(DEVICE).manual_seed(0),
                sample_pool_size=48 if SMOKE else 100,
                max_iterations=1500)
print(f"first fit: {time.perf_counter() - t0:.1f}s")
mu_hats, true_mus = [], []
for request in range(3):
    true_mu = rng.uniform(-2, 2)
    fresh = problem.with_data(torch.as_tensor(rng.normal(true_mu, 1.0, 64), device=DEVICE))
    t0 = time.perf_counter()
    res = nested_sampling(fresh, torch.Generator(DEVICE).manual_seed(request + 1),
                          sample_pool_size=48 if SMOKE else 100,
                          max_iterations=1500)
    mu_hat = float(res.parameter_expected_values.mean[0])
    mu_hats.append(mu_hat)
    true_mus.append(true_mu)
    print(f"request {request}: fit {1e3 * (time.perf_counter() - t0):.0f} ms"
          f"  mu_hat {mu_hat:+.2f} (truth {true_mu:+.2f})")
