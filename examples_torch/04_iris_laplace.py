"""Laplace approximation of a logistic regression on Iris (setosa vs
rest): the MAP, the Gaussian posterior and its log evidence.  The Iris
table is numpy's read of ``data/iris.csv`` (scikit-learn's bundled copy),
so the example needs no scikit-learn.

Run:  python examples_torch/04_iris_laplace.py
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
from bayesianinference_tpu_torch.engines import laplace_posterior_fit
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# scikit-learn's iris.csv: a header row (150, 4, class names), then 4 features and the class
_table = np.loadtxt(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "data", "iris.csv"),
                    delimiter=",", skiprows=1)
iris_data, iris_target = _table[:, :4], _table[:, 4].astype(int)
x = torch.as_tensor((iris_data - iris_data.mean(0)) / iris_data.std(0), device=DEVICE)
y = torch.as_tensor((iris_target == 0).astype(float), device=DEVICE)  # setosa vs rest

problem = define_inference_problem(
    parameters=[(f"b{i}", -50.0, 50.0) for i in range(5)],
    log_likelihood=lambda th: torch.sum(
        d.BernoulliLogits(th[0] + x @ th[1:]).log_prob(y)
    ),
    log_prior=lambda th: torch.sum(d.Normal(0.0, 10.0).log_prob(th)),
    validate=False,
    device=DEVICE,
    dtype=torch.float64,
)
fit = laplace_posterior_fit(
    problem=problem,
    generator=torch.Generator(DEVICE).manual_seed(0),
    predictive_builder=lambda th: d.BernoulliLogits(th[0] + x @ th[1:]),
)
print(f"log evidence = {float(fit.log_evidence):.3f}")
print(f"MAP coefficients: {fit.mean.cpu().numpy().round(3)}")
post = fit.posterior_distribution
print(f"posterior stds: {np.sqrt(post.variance().cpu().numpy()).round(3)}")

logits = (x @ fit.mean[1:] + fit.mean[0]).cpu().numpy()
acc = np.mean((logits > 0) == y.cpu().numpy())
print(f"training accuracy at the mode: {acc:.3f}")
