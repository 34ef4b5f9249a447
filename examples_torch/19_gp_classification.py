"""GP classification with full hyperparameter posteriors.

The reference's GP stack is regression-only; this example shows the
beyond-reference latent-GP Laplace bridge: a 1-D binary classification
problem gets (1) a fast Laplace fit of the kernel hyperparameters and
(2) a full nested-sampling hyperparameter posterior, and the
posterior-averaged class probabilities are compared.  A Poisson count
regression closes with the same surface.

Run:  python examples_torch/19_gp_classification.py
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
from bayesianinference_tpu_torch.engines import (
    define_gp_classifier,
    laplace_posterior_fit,
    predict_from_gp_classifier,
)
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate: smooth latent probability, 80 noisy binary labels ----
rng = np.random.default_rng(3)
n = 80
x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
p_true = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
y = (rng.uniform(size=n) < p_true).astype(float)

problem = define_gp_classifier(
    x,
    y,
    lambda th: se_kernel(th[0] ** 2, th[1]),
    parameters=[("amplitude", 0.05, 10.0), ("lengthscale", 0.1, 5.0)],
    prior_distribution=["scale", "scale"],
    validate=False,
    device=DEVICE,
)

# ---- 1. Laplace fit of the hyperparameters (seconds) ----
fit = laplace_posterior_fit(problem=problem, generator=torch.Generator(DEVICE).manual_seed(0))
print(f"Laplace:  theta = {fit.mean.cpu().numpy().round(3)}, "
      f"logZ = {float(fit.log_evidence):.2f}")

# ---- 2. full nested-sampling posterior over the hyperparameters ----
res = nested_sampling(
    problem, torch.Generator(DEVICE).manual_seed(1),
    sample_pool_size=48 if SMOKE else 400,
    monte_carlo_steps=20 if SMOKE else 80,
)
print(f"NS:       logZ = {float(res.log_evidence.mean):.2f} "
      f"+- {float(res.log_evidence.standard_error):.2f}")

xq = np.linspace(-3.2, 3.2, 161)[:, None]
xq_t = torch.as_tensor(xq, device=DEVICE)
pred_map = predict_from_gp_classifier(fit.mean, problem, xq_t)
pred_ns = predict_from_gp_classifier(res, problem, xq_t, max_samples=128)

# ---- 3. Poisson count regression through the same surface ----
rate_true = np.exp(1.0 + np.sin(2.0 * x[:, 0]))
counts = rng.poisson(rate_true).astype(float)
count_problem = define_gp_classifier(
    x, counts, lambda th: se_kernel(th[0] ** 2, th[1]),
    parameters=[("amplitude", 0.05, 10.0), ("lengthscale", 0.1, 5.0)],
    likelihood="poisson_log",
    prior_distribution=["scale", "scale"],
    validate=False,
    device=DEVICE,
)
count_fit = laplace_posterior_fit(
    problem=count_problem, generator=torch.Generator(DEVICE).manual_seed(2)
)
pred_counts = predict_from_gp_classifier(count_fit.mean, count_problem, xq_t)
print(f"Poisson:  theta = {count_fit.mean.cpu().numpy().round(3)}, "
      f"logZ = {float(count_fit.log_evidence):.2f}")

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped gp_classify.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.plot(xq[:, 0], 1 / (1 + np.exp(-3.0 * np.sin(1.5 * xq[:, 0]))),
             "k--", lw=1, label="true p(x)")
    ax1.plot(xq[:, 0], pred_map.mean.cpu().numpy(), label="Laplace MAP")
    ax1.plot(xq[:, 0], pred_ns.mean.cpu().numpy(), label="NS posterior avg")
    ax1.scatter(x[:, 0], y, s=12, c="gray", alpha=0.6, label="labels")
    ax1.set_title("GP classification (Bernoulli logit)")
    ax1.set_xlabel("x"); ax1.set_ylabel("p(y=1|x)"); ax1.legend()

    ax2.plot(xq[:, 0], np.exp(1.0 + np.sin(2.0 * xq[:, 0])), "k--", lw=1,
             label="true rate")
    ax2.plot(xq[:, 0], pred_counts.mean.cpu().numpy(), label="posterior rate")
    ax2.scatter(x[:, 0], counts, s=12, c="gray", alpha=0.6, label="counts")
    ax2.set_title("GP count regression (Poisson, log link)")
    ax2.set_xlabel("x"); ax2.set_ylabel("rate"); ax2.legend()

    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "gp_classify.png"), dpi=110)
    print("wrote gp_classify.png")
