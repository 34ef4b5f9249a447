"""Model comparison two ways: exact evidence vs predictive stacking.

Two competing noise models for one regression dataset with heavy-tailed
(t(2)) errors — Normal vs StudentT(3).  Nested sampling gives each model an
exact-evidence comparison (``log_bayes_factor``, the reference's only
comparison tool, BS:1138-1156 + LR logZ machinery); the model-criticism
toolkit then compares them by estimated OUT-OF-SAMPLE fit (PSIS-LOO)
and turns the pointwise elpds into averaging weights
(``results.model_weights`` — LOO stacking / pseudo-BMA+, Yao et al.
2018; no reference counterpart).

Run:  python examples_torch/13_model_comparison.py
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
from bayesianinference_tpu_torch.engines import log_bayes_factor
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.results import model_weights, psis_loo

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

rng = np.random.default_rng(5)
n = 80
x_np = np.sort(rng.uniform(-2, 2, size=n))
x = torch.as_tensor(x_np, device=DEVICE)
y = torch.as_tensor(
    1.0 - 0.7 * x_np + 0.5 * rng.standard_t(df=2, size=n), device=DEVICE
)

params = [("a", -5.0, 5.0), ("b", -5.0, 5.0), ("scale", 0.05, 5.0)]


def normal_loglike(theta, data):
    resid = data["y"] - (theta[0] + theta[1] * data["x"])
    return torch.sum(d.Normal(0.0, theta[2]).log_prob(resid))


def studentt_loglike(theta, data):
    resid = data["y"] - (theta[0] + theta[1] * data["x"])
    return torch.sum(d.StudentT(df=3.0, loc=0.0, scale=theta[2]).log_prob(resid))


def fit(loglike, seed):
    problem = define_inference_problem(
        parameters=params,
        log_likelihood=loglike,
        data={"x": x, "y": y},
        prior_distribution=["location", "location", "scale"],
        validate=False,
    )
    return problem, nested_sampling(
        problem, torch.Generator(DEVICE).manual_seed(seed),
        sample_pool_size=64 if SMOKE else 400,
        monte_carlo_steps=25 if SMOKE else 200
    )


prob_n, res_n = fit(normal_loglike, 0)
prob_t, res_t = fit(studentt_loglike, 1)

print("exact evidence comparison (the reference's tool):")
print(f"  Normal  noise: logZ = {float(res_n.log_evidence.mean):8.3f}"
      f" ± {float(res_n.log_evidence.standard_error):.3f}")
print(f"  StudentT noise: logZ = {float(res_t.log_evidence.mean):8.3f}"
      f" ± {float(res_t.log_evidence.standard_error):.3f}")
bf = log_bayes_factor(res_t, res_n)
print(f"  log B(StudentT vs Normal) = {float(bf.mean):.2f} ± {float(bf.standard_error):.2f}")

# predictive comparison: PSIS-LOO elpds -> stacking weights
pw_n = lambda th: d.Normal(th[0] + th[1] * x, th[2]).log_prob(y)  # noqa: E731
pw_t = lambda th: d.StudentT(df=3.0, loc=th[0] + th[1] * x, scale=th[2]).log_prob(y)  # noqa: E731
loo_n = psis_loo(res_n, pw_n)
loo_t = psis_loo(res_t, pw_t)
print("\npredictive comparison (beyond the reference):")
print(f"  Normal  noise: {loo_n!r}")
print(f"  StudentT noise: {loo_t!r}")

w_stack = model_weights([loo_n, loo_t], method="stacking")
w_bma = model_weights([loo_n, loo_t], method="pseudo-bma+", generator=torch.Generator(DEVICE).manual_seed(2))
print(f"  stacking weights   [Normal, StudentT]: {w_stack.cpu().numpy().round(3)}")
print(f"  pseudo-BMA+ weights [Normal, StudentT]: {w_bma.cpu().numpy().round(3)}")
assert float(w_stack[1]) > 0.5, "StudentT should dominate on heavy-tailed data"
print("\nboth views agree: the StudentT noise model wins on this data")
