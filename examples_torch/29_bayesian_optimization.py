"""Bayesian optimization: GP-surrogate search for an expensive optimum.

The reference package builds GP regression (GP:201-330) but leaves its
classic consumer — sequential model-based optimization — to the user.
This engine closes the loop: the growing dataset lives in
capacity-padded masked buffers of a fixed shape, and each step adapts
the surrogate's hyperparameters, maximizes the acquisition and
evaluates the objective.

Two demos:
1. The whole loop: minimize the 2-D Six-Hump Camel.
2. Ask/tell: tune the nugget + lengthscale of a GP fit by
   cross-validation score — an "external" objective that is itself a
   numpy computation, driven through bo_suggest/bo_observe.

Run:  python examples_torch/29_bayesian_optimization.py
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
    BayesOptConfig,
    bayes_optimize,
    bo_init,
    bo_observe,
    bo_suggest,
)
from bayesianinference_tpu_torch.ops.gp_kernels import (
    gp_posterior_moments,
    se_kernel,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

F64 = dict(dtype=torch.float64, device=DEVICE)

# --- 1. BO on the Six-Hump Camel, one batched surrogate per step --------
# global minimum f* = -1.0316 at (+-0.0898, -+0.7126)


def camel(x):
    x1, x2 = x[0], x[1]
    return (
        (4.0 - 2.1 * x1**2 + x1**4 / 3.0) * x1**2
        + x1 * x2
        + (-4.0 + 4.0 * x2**2) * x2**2
    )


res = bayes_optimize(
    camel,
    lower=torch.tensor([-2.0, -1.0], **F64),
    upper=torch.tensor([2.0, 1.0], **F64),
    generator=torch.Generator(DEVICE).manual_seed(0),
    num_steps=6 if SMOKE else 28,
    num_init=4 if SMOKE else 8,
    # deterministic objective: pin the surrogate noise so EI stays sharp
    config=BayesOptConfig(acquisition="log_ei", nugget=1e-6),
    dtype=torch.float64,
)
print("Six-Hump Camel (36 evaluations total):")
print(f"  best f = {float(res.y_best):+.4f}   (global optimum -1.0316)")
print(f"  at x   = {res.x_best.cpu().numpy().round(4)}")
running = np.minimum.accumulate(res.y_history.cpu().numpy())
print(f"  best-so-far every 6 evals: {running[5::6].round(3)}")

# --- 2. ask/tell BO over hyperparameters of a downstream fit -----------
# objective: 5-fold CV negative predictive log-density of a GP fit,
# computed on the host in numpy, opaque to the optimizer.

rng = np.random.default_rng(1)
xtr = np.sort(rng.uniform(-3, 3, size=60))[:, None]
ytr = np.sin(2.0 * xtr[:, 0]) + 0.3 * rng.normal(size=60)
xtr_t, ytr_t = torch.as_tensor(xtr, device=DEVICE), torch.as_tensor(ytr, device=DEVICE)


def cv_score(theta):
    log_ell, log_nug = float(theta[0]), float(theta[1])
    folds = np.arange(60) % 5
    total = 0.0
    for f in range(5):
        tr, te = torch.as_tensor(folds != f, device=DEVICE), torch.as_tensor(folds == f, device=DEVICE)
        kern = se_kernel(variance=1.0, lengthscale=np.exp(log_ell))
        m, s = gp_posterior_moments(
            kern, xtr_t[tr], ytr_t[tr], xtr_t[te], nugget=np.exp(log_nug)
        )
        m, s = m.cpu().numpy(), s.cpu().numpy()
        total += np.sum(
            0.5 * ((ytr[folds == f] - m) / s) ** 2 + np.log(s)
        )
    return total / 60.0


state, x_init = bo_init(
    lower=torch.tensor([-3.0, -8.0], **F64),
    upper=torch.tensor([1.5, 0.0], **F64),
    capacity=24,
    generator=torch.Generator(DEVICE).manual_seed(2),
    num_init=6,
    dtype=torch.float64,
)
for i in range(6):
    state = bo_observe(state, x_init[i], cv_score(x_init[i].cpu().numpy()))
cfg = BayesOptConfig()
for i in range(18):
    state, x_next = bo_suggest(state, torch.Generator(DEVICE).manual_seed(10 + i), cfg)
    state = bo_observe(state, x_next, cv_score(x_next.cpu().numpy()))

x_best, y_best = state.best()
print("\nGP hyperparameter tuning by 5-fold CV (ask/tell, 24 evals):")
print(
    f"  best CV loss {float(y_best):.4f} at lengthscale "
    f"{float(torch.exp(x_best[0])):.3f}, nugget {float(torch.exp(x_best[1])):.4f}"
)
print("  (data generated with noise sd 0.3 -> nugget ~= 0.09)")
