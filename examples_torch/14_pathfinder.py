"""Pathfinder: approximate posteriors from one optimizer run per path.

The same correlated-Gaussian regression posterior fit three ways, cheap
to expensive: Laplace (curvature at the mode, LA:161-435 analogue),
multi-path Pathfinder (quasi-Newton VI along L-BFGS trajectories,
Zhang et al. 2022 — beyond-reference), and ADVI (stochastic-gradient
VI).  Pathfinder sits between them: deterministic optimizer cost like
Laplace, but it picks the iterate whose Gaussian best covers posterior
MASS (max ELBO), not the mode's curvature, and its pooled draws carry
importance weights with a Pareto-k quality diagnostic.

Run:  python examples_torch/14_pathfinder.py
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
    advi_fit,
    laplace_posterior_fit,
    pathfinder_fit,
)
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# --- a correlated posterior: collinear regressors ---
rng = np.random.default_rng(7)
n = 60
x1 = rng.normal(size=n)
x2 = 0.95 * x1 + 0.3 * rng.normal(size=n)  # nearly collinear
y = 1.0 + 0.8 * x1 - 0.5 * x2 + 0.4 * rng.normal(size=n)
X = torch.as_tensor(np.stack([x1, x2], axis=1), device=DEVICE)
yj = torch.as_tensor(y, device=DEVICE)

problem = define_inference_problem(
    parameters=[("b0", -5.0, 5.0), ("b1", -5.0, 5.0), ("b2", -5.0, 5.0),
                ("sigma", 0.05, 3.0)],
    log_likelihood=lambda th, data: torch.sum(
        d.Normal(
            th[0] + data["X"] @ th[1:3], th[3]
        ).log_prob(data["y"])
    ),
    data={"X": X, "y": yj},
    prior_distribution=[d.Normal(0.0, 3.0)] * 3 + ["scale"],
    validate=False,
)

# --- Laplace: curvature at the mode ---
lap = laplace_posterior_fit(problem=problem)
print(f"Laplace   logZ ~ {float(lap.log_evidence):+.3f}")

# --- Pathfinder: max-ELBO Gaussian along 8 L-BFGS paths ---
pf = pathfinder_fit(problem, torch.Generator(DEVICE).manual_seed(0), num_paths=2 if SMOKE else 8)
w = pf.samples.normalized_weights().cpu().numpy()
pts = pf.samples.points.cpu().numpy()
mean = w @ pts
sd = np.sqrt(np.sum(w[:, None] * (pts - mean) ** 2, axis=0))
print(
    f"Pathfinder ELBO {float(pf.elbo):+.3f} <= logZ,  "
    f"IS logZ ~ {float(pf.log_evidence_is):+.3f},  "
    f"pareto k {float(pf.pareto_k):.2f} (trust < 0.7)"
)
print(f"  winning iterations per path: {pf.best_iteration.cpu().numpy()}")
for i, nm in enumerate(problem.param_names):
    print(f"  {nm:6s} {mean[i]:+.3f} +- {sd[i]:.3f}")

# --- ADVI for comparison (stochastic, many more density evals) ---
vi = advi_fit(problem, torch.Generator(DEVICE).manual_seed(0), family="fullrank",
              num_steps=200 if SMOKE else 4000)
print(f"ADVI      ELBO {float(vi.elbo):+.3f} <= logZ")

# the three evidence estimates should bracket consistently:
# ELBOs below logZ, Laplace close for this near-Gaussian posterior
