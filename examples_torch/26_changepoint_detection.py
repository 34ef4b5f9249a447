"""Online changepoint detection with full Bayes over the hazard rate.

A sensor stream with regime shifts in both mean and noise level:
`define_changepoint_model` gives every engine the EXACT product-
partition marginal likelihood (run-length filtering, ops/bocpd.py), so
the hazard rate and segment hyperparameters are INFERRED, not tuned —
then the run-length posterior at posterior draws Rao-Blackwellizes the
changepoint probabilities over parameter uncertainty.

Run:  python examples_torch/26_changepoint_detection.py
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
    changepoint_probability,
    define_changepoint_model,
    laplace_posterior_fit,
    run_length_posterior,
)
from bayesianinference_tpu_torch.ops import gaussian_upm

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate: segments with shifting mean AND volatility ----
rng = np.random.default_rng(7)
SEGS = [(0.0, 0.6, 70), (2.5, 0.6, 50), (2.0, 2.0, 40), (-1.0, 0.8, 80)]
y = np.concatenate([rng.normal(m, s, n) for m, s, n in SEGS])
true_cps = np.cumsum([n for _, _, n in SEGS])[:-1]
T = y.size


def builder(theta):
    # theta: hazard, prior pseudo-observations kappa0, prior scale beta0
    return gaussian_upm(mu0=0.0, kappa0=theta[1], alpha0=2.0, beta0=theta[2]), theta[0]


problem = define_changepoint_model(
    y,
    builder,
    parameters=[
        ("hazard", 1e-3, 0.3),
        ("kappa0", 1e-2, 5.0),
        ("beta0", 1e-2, 10.0),
    ],
    prior_distribution=["scale", "scale", "scale"],
    validate=False,
    device=DEVICE,
)

fit = laplace_posterior_fit(problem=problem, generator=torch.Generator(DEVICE).manual_seed(0))
h, k0, b0 = fit.mean.cpu().numpy()
print(f"MAP hazard {h:.4f}  (true segment rate ~{len(SEGS)/T:.4f})")
print(f"MAP segment prior: kappa0 {k0:.3f}, beta0 {b0:.3f}")
print(f"exact log evidence (Laplace): {float(fit.log_evidence):.1f}")

# clip Gaussian-posterior draws to the parameter box (out-of-support
# draws would be dropped by changepoint_probability anyway)
draws = fit.posterior_distribution.sample(torch.Generator(DEVICE).manual_seed(1), (16,))
draws = torch.clip(
    draws,
    torch.tensor([1e-3, 1e-2, 1e-2], dtype=draws.dtype, device=draws.device),
    torch.tensor([0.3, 5.0, 10.0], dtype=draws.dtype, device=draws.device),
)
cp = changepoint_probability(problem, draws).cpu().numpy()
# evidence for one change spreads over a few steps: score 5-step windows
win = np.convolve(cp, np.ones(5), mode="same")
found = [
    int(k)
    for k in np.nonzero(win[5:] > 0.5)[0] + 5  # skip the startup steps
    if win[k] == win[max(0, k - 4) : k + 5].max()
]
print("detected changepoints (windowed p > 0.5):", found, " true:", true_cps)

res = run_length_posterior(problem, fit.mean)
rl = np.exp(res.log_run_length.cpu().numpy())

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped changepoints.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax0, ax1, ax2) = plt.subplots(
        3, 1, figsize=(10, 8), sharex=True, height_ratios=[2, 1, 2]
    )
    t = np.arange(T)
    ax0.plot(t, y, lw=0.7, color="k")
    for c in true_cps:
        ax0.axvline(c, color="C3", ls="--", alpha=0.6)
    ax0.set_ylabel("signal")
    ax0.set_title(
        f"BOCPD: inferred hazard {h:.3f}, exact logZ {float(fit.log_evidence):.1f}"
    )
    ax1.plot(t, cp, color="C0")
    ax1.set_ylabel("P(change)")
    ax2.imshow(
        np.log(rl.T + 1e-12),
        aspect="auto",
        origin="lower",
        cmap="Blues",
        vmin=-8,
        vmax=0,
    )
    ax2.set_ylabel("run length")
    ax2.set_xlabel("t")
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "changepoints.png"), dpi=110)
    print("wrote changepoints.png")
