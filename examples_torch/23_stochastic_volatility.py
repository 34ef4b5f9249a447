"""Stochastic volatility by particle-marginal MCMC.

The SV model  h_t = mu + phi (h_{t-1} - mu) + s e_t,
y_t ~ N(0, exp(h_t))  has no closed-form likelihood — the classic case
the linear-Gaussian Kalman stack cannot touch.  The bootstrap particle
filter estimates log p(y | theta) unbiasedly, and PMMH samples the
exact parameter posterior through those noisy estimates.  All chains'
filters advance together as one [C, P, 1] tensor program.

Run:  python examples_torch/23_stochastic_volatility.py
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
from bayesianinference_tpu_torch.engines import pmmh_sample
from bayesianinference_tpu_torch.ops import ParticleModel, particle_filter

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

# ---- simulate an SV series ----
rng = np.random.default_rng(5)
t_len, mu_true, phi_true, s_true = (60 if SMOKE else 400), -0.8, 0.96, 0.2
h = np.zeros(t_len)
h[0] = mu_true + s_true / np.sqrt(1 - phi_true**2) * rng.normal()
for t in range(1, t_len):
    h[t] = mu_true + phi_true * (h[t - 1] - mu_true) + s_true * rng.normal()
returns = np.exp(h / 2) * rng.normal(size=t_len)
y = torch.as_tensor(returns[:, None], device=DEVICE)


def builder(th):
    mu, phi, s = th[0], th[1], th[2]

    def init(g, p):  # the model is built anew at every filter step: the stationary sd is computed here only
        sd0 = s / torch.sqrt(1 - phi**2)
        return mu + sd0 * torch.randn((p, 1), generator=g, dtype=th.dtype, device=DEVICE)

    def trans(g, particles, t):
        return mu + phi * (particles - mu) + s * torch.randn(
            particles.shape, generator=g, dtype=particles.dtype, device=DEVICE
        )

    def obs_lp(particles, y_t, t):
        hh = particles[:, 0]
        return -0.5 * (hh + y_t[0] ** 2 * torch.exp(-hh)) - 0.919

    return ParticleModel(init, trans, obs_lp)


res = pmmh_sample(
    builder,
    y,
    parameters=[("mu", -3.0, 1.0), ("phi", 0.5, 0.995), ("s", 0.05, 1.0)],
    generator=torch.Generator(DEVICE).manual_seed(0),
    num_particles=64 if SMOKE else 512,
    num_samples=20 if SMOKE else 300,
    num_warmup=20 if SMOKE else 300,
    num_chains=2 if SMOKE else 8,
)
draws = res.points.cpu().numpy()
names, truths = ["mu", "phi", "s"], [mu_true, phi_true, s_true]
for i, (nm, tv) in enumerate(zip(names, truths)):
    print(f"{nm}: posterior {draws[:, i].mean():+.3f} "
          f"+- {draws[:, i].std():.3f}   (true {tv:+.3f})")
print(f"acceptance per chain: {res.acceptance_rate.cpu().numpy().round(2)}")

# filtered volatility path at the posterior mean
pf = particle_filter(
    builder(torch.as_tensor(draws.mean(axis=0), device=DEVICE)), y, 2048, torch.Generator(DEVICE).manual_seed(1)
)

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped sv_pmmh.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    ax1.plot(returns, lw=0.6, c="gray")
    ax1.set_ylabel("returns")
    ax1.set_title("stochastic volatility: data, true and filtered log-variance")
    ax2.plot(h, "k--", lw=1, label="true h_t")
    ax2.plot(pf.filter_means[:, 0].cpu().numpy(), lw=1.2,
             label="PF filtered mean (posterior-mean params)")
    ax2.set_xlabel("t"); ax2.set_ylabel("h_t"); ax2.legend()
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "sv_pmmh.png"), dpi=110)
    print("wrote sv_pmmh.png")
