"""Simulation-based calibration: proving a fitting pipeline is honest.

SBC (Talts et al. 2018) closes the loop the reference's error-bar
studies (BS:1209-1291) leave open: draw truths from the prior, simulate
data, fit, and rank each truth among the posterior draws — a calibrated
pipeline gives uniform ranks for ANY model.  Here the conjugate
normal-model engine (exact) passes, while a deliberately overconfident
variant (posterior standard deviations shrunk 40%) is flagged, both in
one vectorized study each (the whole N-replication loop is a single
torch.func.vmap — hundreds of fits per dispatch).

Run:  python examples_torch/15_sbc_calibration.py
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
from bayesianinference_tpu_torch.dists import NormalInverseGamma
from bayesianinference_tpu_torch.engines import normal_conjugate_model
from bayesianinference_tpu_torch.results import sbc_ranks

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

_f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=DEVICE)  # noqa: E731
PRIOR = NormalInverseGamma(mu0=_f64(0.0), lam=_f64(1.0), beta=_f64(1.0), nu=_f64(2.0))
N_OBS, L_DRAWS, N_REPS = 12, 19, (20 if SMOKE else 300)


def prior_sample(g):
    m, v = PRIOR.sample(g)
    return torch.stack([m, v])


def simulate(g, theta):
    return theta[0] + torch.sqrt(theta[1]) * torch.randn((N_OBS,), generator=g, dtype=theta.dtype,
                                                         device=theta.device)


def make_posterior_draws(shrink):
    def posterior_draws(g, data):
        fit = normal_conjugate_model(data, prior=PRIOR)
        m, v = fit.posterior.sample(g, (L_DRAWS,))
        if shrink != 1.0:  # deliberately mis-calibrated variant
            m_c = torch.mean(m)
            v_c = torch.exp(torch.mean(torch.log(v)))
            m = m_c + shrink * (m - m_c)
            v = v_c * (v / v_c) ** shrink
        return torch.stack([m, v], dim=-1)

    return posterior_draws


pvalues = {}
for label, shrink in [("exact conjugate", 1.0), ("overconfident", 0.6)]:
    res = sbc_ranks(
        torch.Generator(DEVICE).manual_seed(0),
        prior_sample=prior_sample,
        simulate=simulate,
        posterior_draws=make_posterior_draws(shrink),
        num_replications=N_REPS,
        vectorized=True,
        param_names=("mean", "var"),
        device=DEVICE,
    )
    p = res.uniformity_pvalues().cpu().numpy()
    pvalues[label] = p
    verdict = "calibrated" if p.min() > 0.01 else "MISCALIBRATED"
    print(
        f"{label:16s} rank-uniformity p-values "
        f"mean={p[0]:.3f} var={p[1]:.3f} -> {verdict}"
    )

# the classic rank histograms, saved next to this script
try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped sbc_ranks.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    from bayesianinference_tpu_torch import viz

    res = sbc_ranks(
        torch.Generator(DEVICE).manual_seed(0),
        prior_sample=prior_sample,
        simulate=simulate,
        posterior_draws=make_posterior_draws(1.0),
        num_replications=N_REPS,
        vectorized=True,
        param_names=("mean", "var"),
        device=DEVICE,
    )
    out = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        "sbc_ranks.png")
    viz.sbc_rank_plot(res, columns=2).savefig(out, dpi=100)
    print(f"rank histograms -> {out}")
