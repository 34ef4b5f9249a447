"""Eight schools with the latents Laplace-collapsed out of the model.

The canonical hierarchical example (Rubin 1981; Gelman et al. BDA):
8 schools report treatment effects y_j with known standard errors s_j,

    y_j ~ N(z_j, s_j^2),   z_j ~ N(mu, tau^2),

and the question is the population (mu, tau).  Sampling all 10
parameters jointly is the textbook funnel headache; here
``marginalize_latents`` collapses the 8 conditionally-Gaussian z_j with
a nested Laplace approximation — EXACT for this model — and the engines
see a clean 2-parameter problem.  The re-attached Newton step makes the
collapsed likelihood differentiable (implicit-function-theorem
sensitivities), so gradient-based HMC runs straight through the inner
optimizer.

Three engines on the collapsed model agree with the exact closed-form
marginal (y_j ~ N(mu, s_j^2 + tau^2)):

Run:  python examples_torch/30_eight_schools_marginalized.py
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
from bayesianinference_tpu_torch.engines import (
    direct_posterior_distribution,
    hmc_sample,
)
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import (
    define_inference_problem,
    marginalize_latents,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

Y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], dtype=torch.float64, device=DEVICE)
S = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], dtype=torch.float64, device=DEVICE)


def joint(theta, z):
    """log p(y, z | mu, tau): 8 latent school effects (BDA's convention:
    tau itself is the parameter, with a uniform prior)."""
    mu, tau = theta[0], theta[1]
    return torch.sum(d.Normal(z, S).log_prob(Y)) + torch.sum(
        d.Normal(mu, tau).log_prob(z)
    )


marg = marginalize_latents(joint, latent_dim=8)


def exact_marginal(theta):
    var = S**2 + theta[1] ** 2
    return torch.sum(d.Normal(theta[0], torch.sqrt(var)).log_prob(Y))


def make_problem(loglike, batched=False):
    # the collapsed density runs one host Newton loop over a batch of theta
    # (torch.func.vmap cannot hold it): the problem hands it the batch whole
    return define_inference_problem(
        parameters=[("mu", -15.0, 25.0), ("tau", 0.05, 30.0)],
        log_likelihood=loglike,
        prior_distribution=[d.Uniform(-15.0, 25.0), d.Uniform(0.05, 30.0)],
        validate=False,
        device=DEVICE,
        dtype=torch.float64,
        batched_likelihood=batched,
    )


collapsed = make_problem(marg.log_density, batched=True)

# 1. quadrature: collapsed vs exact evidence
post_c = direct_posterior_distribution(problem=collapsed, num_points=64)
post_e = direct_posterior_distribution(
    problem=make_problem(exact_marginal), num_points=64
)
print("log evidence (direct quadrature):")
print(f"  collapsed latents : {float(post_c.log_evidence):+.6f}")
print(f"  exact marginal    : {float(post_e.log_evidence):+.6f}")

# 2. HMC differentiates THROUGH the inner Newton solve
hmc = hmc_sample(
    collapsed,
    torch.Generator(DEVICE).manual_seed(0),
    num_chains=64 if SMOKE else 512,
    num_samples=60 if SMOKE else 300,
    num_warmup=60 if SMOKE else 300,
)
mu_s = hmc.samples[..., 0].reshape(-1)
tau_s = hmc.samples[..., 1].reshape(-1)
print("\nHMC on the collapsed 2-parameter posterior (512 chains):")
print(f"  E[mu]  = {float(torch.mean(mu_s)):+.2f}  (BDA reports ~ +7.9)")
print(f"  E[tau] = {float(torch.mean(tau_s)):+.2f}  (weakly identified, ~ 6-7)")

# 3. nested sampling gives the evidence with an error bar
ns = nested_sampling(collapsed, torch.Generator(DEVICE).manual_seed(1))
print("\nnested sampling on the collapsed model:")
print(
    f"  logZ = {float(ns.log_evidence.mean):+.3f} "
    f"+- {float(ns.log_evidence.standard_error):.3f} "
    f"(quadrature: {float(post_c.log_evidence):+.3f})"
)

# 4. per-school shrinkage: the latent posterior at the posterior mean
z_hat, cov = marg.latent_posterior(
    torch.tensor([float(torch.mean(mu_s)), float(torch.mean(tau_s))], dtype=torch.float64, device=DEVICE)
)
print("\nper-school effects (posterior-mean hyperparameters):")
print("  raw y :", Y.cpu().numpy().round(1))
print("  shrunk:", z_hat.cpu().numpy().round(1), " (pulled toward E[mu])")
