"""Three independent engines on one problem: nested sampling, adaptive
tempered SMC, and gradient-based HMC agree on evidence and posterior.

A GBM-style lognormal regression (the reference README's time-series
example, restated): y_t ~ LogNormal(log y0 + (mu - sigma^2/2) t,
sigma sqrt(t)).  NS and SMC each estimate logZ with error bars from
unrelated mechanisms (X-shrinkage resampling vs replicate ladders); HMC
cross-checks the posterior moments with a gradient-based kernel.

Run:  python examples_torch/12_smc_hmc_crosscheck.py
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
from bayesianinference_tpu_torch.engines import hmc_sample, smc_sampler
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# --- synthetic GBM observations ---
rng = np.random.default_rng(42)
MU_TRUE, SIGMA_TRUE, Y0 = 0.15, 0.3, 1.0
t = np.arange(1, 65) / 16.0
log_y = np.log(Y0) + (MU_TRUE - SIGMA_TRUE**2 / 2) * t + SIGMA_TRUE * np.sqrt(
    t
) * rng.normal(size=t.shape)
y = np.exp(log_y)

T = torch.as_tensor(t, device=DEVICE)


def gbm_dist(theta, tt):
    mu, sigma = theta[0], theta[1]
    return d.LogNormal(
        np.log(Y0) + (mu - sigma**2 / 2) * tt, sigma * torch.sqrt(tt)
    )


problem = define_inference_problem(
    parameters=[("mu", -1.0, 1.0), ("sigma", 0.01, 2.0)],
    likelihood=gbm_dist,
    independent_variables=T,
    data=torch.as_tensor(y, device=DEVICE),
    prior_distribution=["location", "scale"],
)

# --- nested sampling ---
ns = nested_sampling(
    problem,
    torch.Generator(DEVICE).manual_seed(0),
    sample_pool_size=64 if SMOKE else 400,
    num_delete=8 if SMOKE else 64,
    monte_carlo_steps=25 if SMOKE else 100,
    max_iterations=2000,
)
print(f"NS   logZ = {ns.log_evidence}")

# --- adaptive tempered SMC (independent logZ estimator) ---
smc = smc_sampler(
    problem, torch.Generator(DEVICE).manual_seed(1),
    n_particles=128 if SMOKE else 1000,
    num_runs=2 if SMOKE else 6,
    mcmc_steps=5 if SMOKE else 15
)
print(
    f"SMC  logZ = {smc.log_evidence}   "
    f"(ladders of {smc.n_stages.cpu().numpy()} stages)"
)

delta = float(ns.log_evidence.mean) - float(smc.log_evidence.mean)
joint = (
    float(ns.log_evidence.standard_error) ** 2
    + float(smc.log_evidence.standard_error) ** 2
) ** 0.5
print(f"cross-engine |delta logZ| = {abs(delta):.4f}  ({abs(delta)/joint:.2f} joint sigma)")

# --- HMC posterior (gradient-based cross-check of the moments) ---
hmc = hmc_sample(
    problem,
    torch.Generator(DEVICE).manual_seed(2),
    num_chains=4,
    num_samples=100 if SMOKE else 1500,
    num_warmup=600,
    num_leapfrog=16,
)
hmc_mean = hmc.posterior_samples().mean().cpu().numpy()
ns_mean = ns.parameter_expected_values.mean.cpu().numpy()
smc_mean = smc.posterior_samples().mean().cpu().numpy()
print(f"posterior mean   NS {ns_mean.round(4)}  SMC {smc_mean.round(4)}  "
      f"HMC {hmc_mean.round(4)}   (truth mu={MU_TRUE}, sigma={SIGMA_TRUE})")
print(f"HMC acceptance {hmc.acceptance_rates.cpu().numpy().round(3)}, "
      f"divergences {int(hmc.divergences.sum())}, "
      f"step size {float(hmc.step_size):.4f}")

assert abs(delta) < 4 * joint, "NS and SMC evidences disagree"
assert np.all(np.abs(hmc_mean - ns_mean) < 0.05), "HMC vs NS moments disagree"
print("three engines agree.")
