"""A generative model written as a ConditionalProduct graph (Bayesian
logistic regression), fitted by the Laplace approximation straight from the
graph.

Run:  python examples_torch/08_generative_model_laplace.py
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
from bayesianinference_tpu_torch.dists.combinators import ConditionalProduct
from bayesianinference_tpu_torch.engines.laplace import laplace_posterior_fit

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

rng = np.random.default_rng(0)
n = 200
x_np = rng.uniform(-2, 2, (n, 2))
true_w = np.asarray([1.5, -2.0])
y_np = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-(0.5 + x_np @ true_w)))).astype(float)
x = torch.as_tensor(x_np, device=DEVICE)
y = torch.as_tensor(y_np, device=DEVICE)

# y | x, b0, w  ~  Bernoulli(logit = b0 + x.w);   b0, w ~ N(0, 10)
model = ConditionalProduct(
    [
        ("b0", lambda v: d.Normal(0.0, 10.0)),
        ("w", lambda v: d.Normal(torch.zeros(2, dtype=torch.float64, device=DEVICE), 10.0)),
        ("y", lambda v: d.BernoulliLogits(logits=v["b0"] + v["x"] @ v["w"])),
    ]
)

fit = laplace_posterior_fit(
    model=model,
    data={"y": y},
    parameters=[("b0", -20.0, 20.0), ("w", -20.0, 20.0, (2,))],
    model_inputs={"x": x},
    device=DEVICE,
)

print("mode:", fit.mean.cpu().numpy(), "(true ~ [0.5, 1.5, -2.0])")
print("log evidence:", float(fit.log_evidence))
post = fit.posterior_distribution
print("posterior sd:", np.sqrt(np.diagonal(np.linalg.inv(fit.precision_matrix.cpu().numpy()))))
s = post.sample(torch.Generator(DEVICE).manual_seed(1), (2000,))
acc = np.mean(
    ((x @ fit.mean[1:] + fit.mean[0]) > 0).cpu().numpy() == y_np
)
print(f"mode train accuracy: {acc:.3f}")
