"""Structural time-series forecasting with exact Kalman likelihoods.

A trend + weekly-seasonal series with a gap of missing observations:
`define_state_space_model` gives every engine the EXACT marginal
likelihood (no approximation), Laplace fits the variance
hyperparameters, the RTS smoother reconstructs the latent level through
the gap, and the filtered state forecasts 30 steps ahead with calibrated
uncertainty.

The series is the JAX example's own draw (``kalman_sample`` under JAX's
PRNGKey(3)), read from ``data/ssm_jax_draws.npz``, so both packages fit the
same data.

Run:  python examples_torch/18_state_space_forecasting.py
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
    define_state_space_model,
    forecast_observations,
    laplace_posterior_fit,
    level_component,
    seasonal_component,
    smoothed_states,
    structural_lgssm,
    trend_component,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate: local linear trend + period-7 seasonality ----
TRUE = dict(level_var=0.02, slope_var=1e-4, seas_var=0.01, obs_var=0.25)
T = 300
# the JAX example's kalman_sample(PRNGKey(3), gen, T) of this model
with np.load(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "data", "ssm_jax_draws.npz")) as _z:
    xs, ys = _z["xs"], _z["ys"]
y = torch.as_tensor(ys[:, 0], device=DEVICE)
mask = np.ones(T, bool)
mask[140:160] = False  # a 20-step outage, marginalized exactly

problem = define_state_space_model(
    y,
    lambda th: structural_lgssm(
        [trend_component(th[0], th[1]), seasonal_component(7, th[2])],
        obs_var=th[3],
    ),
    parameters=[
        ("level_var", 1e-6, 1.0),
        ("slope_var", 1e-8, 0.1),
        ("seas_var", 1e-6, 1.0),
        ("obs_var", 1e-4, 4.0),
    ],
    prior_distribution=["scale", "scale", "scale", "scale"],
    mask=torch.as_tensor(mask, device=DEVICE),
    validate=False,
)

fit = laplace_posterior_fit(problem=problem, generator=torch.Generator(DEVICE).manual_seed(0))
names = ("level_var", "slope_var", "seas_var", "obs_var")
print("MAP hyperparameters (true in parens):")
for n, v in zip(names, fit.mean.cpu().numpy()):
    print(f"  {n:10s} {v:.5f}  ({TRUE[n]})")
print(f"exact log evidence (Laplace): {float(fit.log_evidence):.1f}")

sm = smoothed_states(problem, fit.mean)
level = sm.means[:, 0].cpu().numpy()
level_sd = np.sqrt(sm.covs[:, 0, 0].cpu().numpy())

H = 30
fm, fv = forecast_observations(problem, fit.mean, H)
fmean = fm[:, 0].cpu().numpy()
fsd = np.sqrt(fv[:, 0, 0].cpu().numpy())
print(f"30-step forecast: last mean {fmean[-1]:.2f} ± {fsd[-1]:.2f}")

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped the forecast figure: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    t = np.arange(T)
    ax.plot(t[mask], ys[:, 0][mask], ".", ms=3, color="k", label="observed")
    ax.axvspan(140, 159, color="orange", alpha=0.15, label="missing")
    ax.plot(t, level, color="C0", label="smoothed level")
    ax.fill_between(t, level - 2 * level_sd, level + 2 * level_sd, alpha=0.2)
    tf = np.arange(T, T + H)
    ax.plot(tf, fmean, color="C3", label="forecast")
    ax.fill_between(tf, fmean - 2 * fsd, fmean + 2 * fsd, color="C3", alpha=0.2)
    ax.legend()
    ax.set_title(f"Structural SSM: exact logZ {float(fit.log_evidence):.1f}")
    # smoke runs must not overwrite a full run's figure
    _out = ("ssm_forecast_smoke.png" if SMOKE else
            _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "ssm_forecast.png"))
    fig.savefig(_out, dpi=110)
    print(f"wrote {_out}")
