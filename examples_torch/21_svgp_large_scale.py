"""Large-scale GP classification with a stochastic variational GP.

20,000 binary observations — far beyond the O(n^3) exact bridges — fit
with M = 128 inducing points and minibatches of 512: memory is
O(M^2 + BM) regardless of n, and every Adam step is one [M, M]
Cholesky + [M, B] matmuls, both kernels on the card.

Run:  python examples_torch/21_svgp_large_scale.py
      (on the CUDA card; BI_EXAMPLE_DEVICE=cpu runs it on the host)
"""

import os as _os
import sys as _sys
import time

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the smoke runners
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import numpy as np
import torch

from bayesianinference_tpu_torch.core.device import resolve_device
from bayesianinference_tpu_torch.engines import fit_svgp, predict_from_svgp
from bayesianinference_tpu_torch.ops.gp_kernels import se_kernel

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate: 20k noisy binary labels from a smooth 2-D field ----
rng = np.random.default_rng(5)
n = 2_000 if SMOKE else 20_000
x = rng.uniform(-3, 3, size=(n, 2))
f = 2.5 * np.sin(1.2 * x[:, 0]) * np.cos(0.9 * x[:, 1])
y = (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(float)

t0 = time.time()
fit = fit_svgp(
    x,
    y,
    lambda th: se_kernel(th[0] ** 2, th[1]),
    [("amplitude", 0.05, 10.0), ("lengthscale", 0.1, 5.0)],
    likelihood="bernoulli_logit",
    inducing=32 if SMOKE else 128,
    minibatch=256 if SMOKE else 512,
    steps=60 if SMOKE else 1500,
    learning_rate=0.03,
    generator=torch.Generator(DEVICE).manual_seed(0),
    device=DEVICE,
)
print(f"fit 20k points in {time.time()-t0:.1f}s "
      f"(theta = {fit.theta.cpu().numpy().round(3)}, "
      f"full-data ELBO = {float(fit.elbo):.1f})")

# ---- predictions on a grid; accuracy vs the generating field ----
g = np.linspace(-3, 3, 60)
xq = np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2)
p, mu, sd = (t.cpu().numpy() for t in predict_from_svgp(fit, torch.as_tensor(xq, device=DEVICE)))
p_true = 1 / (1 + np.exp(-2.5 * np.sin(1.2 * xq[:, 0]) * np.cos(0.9 * xq[:, 1])))
err = float(np.mean(np.abs(p - p_true)))
acc = float(np.mean((p > 0.5) == (p_true > 0.5)))
print(f"grid mean |p - p_true| = {err:.3f}; decision agreement = {acc:.3f}")

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped svgp.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    z = fit.z.cpu().numpy()
    for ax, field, title in [
        (axes[0], p_true, "true p(y=1)"),
        (axes[1], p, "SVGP posterior p"),
        (axes[2], sd, "latent posterior sd"),
    ]:
        im = ax.imshow(
            field.reshape(60, 60).T, origin="lower", extent=(-3, 3, -3, 3),
            cmap="viridis",
        )
        ax.scatter(z[:, 0], z[:, 1], s=6, c="red", alpha=0.6)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.suptitle("SVGP on 20k binary observations (red: optimized inducing points)")
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "svgp.png"), dpi=110)
    print("wrote svgp.png")
