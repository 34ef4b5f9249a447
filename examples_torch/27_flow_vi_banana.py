"""Normalizing-flow VI on a curved posterior: the capacity ladder.

A banana-shaped 2-D posterior (curved ridge) defeats every Gaussian
family: Laplace sees only the mode's curvature, full-rank ADVI fits
the best global Gaussian, the RealNVP flow bends with the ridge.  The
evidence ladder makes the capacity gap measurable — each family's
bound/estimate vs the nested-sampling logZ:

    Laplace logZ  <~  ADVI ELBO  <  flow ELBO  <=  flow PSIS logZ  ~  NS logZ

Run:  python examples_torch/27_flow_vi_banana.py
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
    advi_fit,
    flow_vi_fit,
    laplace_posterior_fit,
)
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling
from bayesianinference_tpu_torch.models import define_inference_problem

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)


def log_likelihood(th):
    return -0.5 * (th[0] ** 2 / 4.0 + 4.0 * (th[1] - th[0] ** 2 / 2.0) ** 2)


problem = define_inference_problem(
    parameters=[("a", -6.0, 6.0), ("b", -4.0, 12.0)],
    log_likelihood=log_likelihood,
    prior_distribution=["location", "location"],
    validate=False,
    device=DEVICE,
    dtype=torch.float64,
)

la = laplace_posterior_fit(problem=problem, generator=torch.Generator(DEVICE).manual_seed(0))
fr = advi_fit(problem, torch.Generator(DEVICE).manual_seed(0), family="fullrank",
              num_steps=150 if SMOKE else 3000)
fl = flow_vi_fit(problem, torch.Generator(DEVICE).manual_seed(0), num_steps=200 if SMOKE else 4000,
                 learning_rate=2e-3)
ns = nested_sampling(problem, torch.Generator(DEVICE).manual_seed(1), sample_pool_size=800)

print("evidence ladder (higher = tighter, NS = reference):")
print(f"  Laplace logZ          {float(la.log_evidence):8.4f}")
print(f"  ADVI fullrank ELBO    {float(fr.elbo):8.4f}")
print(f"  flow ELBO             {float(fl.elbo):8.4f}")
print(
    f"  flow PSIS logZ        {float(fl.log_evidence):8.4f}"
    f"   (pareto k {float(fl.pareto_k):.2f})"
)
print(f"  nested sampling logZ  {float(ns.log_evidence.mean):8.4f}"
      f" +- {float(ns.log_evidence.standard_error):.4f}")

s_fl = fl.sample(torch.Generator(DEVICE).manual_seed(2), 8000).cpu().numpy()
s_fr = fr.sample(torch.Generator(DEVICE).manual_seed(2), 8000).cpu().numpy()

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped flow_vi.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = np.linspace(-5.5, 5.5, 300)
    ys = np.linspace(-2.5, 11, 300)
    xx, yy = np.meshgrid(xs, ys)
    zz = np.exp(-0.5 * (xx**2 / 4.0 + 4.0 * (yy - xx**2 / 2.0) ** 2))

    fig, axes = plt.subplots(1, 2, figsize=(11, 5), sharex=True, sharey=True)
    for ax, s, title in (
        (axes[0], s_fr, f"ADVI fullrank (ELBO {float(fr.elbo):.2f})"),
        (axes[1], s_fl, f"RealNVP flow (ELBO {float(fl.elbo):.2f})"),
    ):
        ax.contour(xx, yy, zz, levels=6, colors="k", linewidths=0.6, alpha=0.5)
        ax.plot(s[:, 0], s[:, 1], ".", ms=1, alpha=0.25, color="C0")
        ax.set_title(title)
        ax.set_xlabel("a")
    axes[0].set_ylabel("b")
    fig.suptitle(
        f"NS logZ {float(ns.log_evidence.mean):.3f} | "
        f"flow PSIS logZ {float(fl.log_evidence):.3f} (k={float(fl.pareto_k):.2f})"
    )
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "flow_vi.png"), dpi=110)
    print("wrote flow_vi.png")
