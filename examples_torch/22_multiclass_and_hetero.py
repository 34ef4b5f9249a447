"""Multiclass GP classification (Iris) + heteroscedastic GP regression.

Two SVGP variants beyond the reference's Gaussian-only GP stack:

1. Softmax SVGP on the full 3-class Iris problem (the reference's
   showcase dataset, used for its Laplace logistic fit) — C latent GPs
   sharing one kernel, trained jointly with the hyperparameters.
2. A heteroscedastic GP on data whose noise level rises with x: the
   latent log-noise GP recovers the noise profile, where a standard GP
   must smear one global sigma across the domain.

The Iris table is numpy's read of ``data/iris.csv`` (scikit-learn's bundled
copy), so the example needs no scikit-learn.

Run:  python examples_torch/22_multiclass_and_hetero.py
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
    fit_svgp_heteroscedastic,
    fit_svgp_multiclass,
    predict_from_svgp_heteroscedastic,
    predict_from_svgp_multiclass,
)
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- 1. Iris, all three classes ----
# scikit-learn's iris.csv: a header row (150, 4, class names), then 4 features and the class
_table = np.loadtxt(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "data", "iris.csv"),
                    delimiter=",", skiprows=1)
iris_data, iris_target = _table[:, :4], _table[:, 4].astype(int)
x = (iris_data - iris_data.mean(0)) / iris_data.std(0)
y = iris_target

fit = fit_svgp_multiclass(
    x, y, lambda th: se_kernel(th[0] ** 2, th[1]),
    [("amplitude", 0.05, 10.0), ("lengthscale", 0.1, 10.0)],
    inducing=24, steps=60 if SMOKE else 600, learning_rate=0.05,
    generator=torch.Generator(DEVICE).manual_seed(0),
    device=DEVICE,
)
probs = predict_from_svgp_multiclass(fit, torch.as_tensor(x, device=DEVICE), num_mc=512)[0].cpu().numpy()
acc = float(np.mean(np.argmax(probs, axis=-1) == y))
print(f"Iris 3-class SVGP: training accuracy {acc:.3f}, "
      f"ELBO {float(fit.elbo):.1f}, theta {fit.theta.cpu().numpy().round(2)}")

# ---- 2. heteroscedastic regression ----
rng = np.random.default_rng(4)
n = 400
xr = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
f_true = np.sin(1.2 * xr[:, 0])
sd_true = 0.05 + 0.4 * (1 + np.tanh(1.5 * xr[:, 0]))
yr = f_true + sd_true * rng.normal(size=n)

hfit = fit_svgp_heteroscedastic(
    xr, yr,
    lambda th: se_kernel(th[0] ** 2, th[1]),
    lambda th: se_kernel(th[2] ** 2, th[3]),
    [("amp_f", 0.05, 10.0), ("ls_f", 0.1, 5.0),
     ("amp_g", 0.05, 5.0), ("ls_g", 0.3, 5.0)],
    inducing=24, steps=60 if SMOKE else 900, learning_rate=0.03,
    generator=torch.Generator(DEVICE).manual_seed(1),
    device=DEVICE,
)
xq = np.linspace(-3.2, 3.2, 161)[:, None]
mean, total_sd, noise_sd, latent_sd = (
    t.cpu().numpy() for t in predict_from_svgp_heteroscedastic(hfit, torch.as_tensor(xq, device=DEVICE)))
corr_sd = np.corrcoef(
    predict_from_svgp_heteroscedastic(hfit, torch.as_tensor(xr, device=DEVICE))[2].cpu().numpy(), sd_true
)[0, 1]
print(f"heteroscedastic GP: noise-profile correlation {corr_sd:.3f}, "
      f"ELBO {float(hfit.elbo):.1f}")

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped multiclass_hetero.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11.5, 4.2))
    ax1.scatter(x[:, 2], x[:, 3], c=np.argmax(probs, -1),
                cmap="viridis", s=22, alpha=0.85)
    mis = np.argmax(probs, -1) != y
    ax1.scatter(x[mis, 2], x[mis, 3], facecolors="none", edgecolors="red",
                s=90, label="misclassified")
    ax1.set_xlabel("petal length (std)"); ax1.set_ylabel("petal width (std)")
    ax1.set_title(f"Iris softmax SVGP (accuracy {acc:.2f})"); ax1.legend()

    ax2.fill_between(xq[:, 0], mean - 1.645 * total_sd,
                     mean + 1.645 * total_sd, alpha=0.25,
                     label="90% predictive")
    ax2.plot(xq[:, 0], mean, lw=1.4, label="mean")
    ax2.plot(xq[:, 0], mean + 1.645 * noise_sd, "--", lw=0.9,
             c="tab:red", label="±1.645 noise sd")
    ax2.plot(xq[:, 0], mean - 1.645 * noise_sd, "--", lw=0.9,
             c="tab:red")
    ax2.scatter(xr[:, 0], yr, s=8, c="gray", alpha=0.6)
    ax2.set_title("heteroscedastic GP: learned noise profile")
    ax2.set_xlabel("x"); ax2.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "multiclass_hetero.png"), dpi=110)
    print("wrote multiclass_hetero.png")
