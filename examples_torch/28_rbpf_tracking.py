"""Maneuvering-target tracking with a Rao-Blackwellized particle filter.

A target alternates between CRUISE (low process noise) and MANEUVER
(high process noise) — a jump-Markov linear system.  The regime is a
discrete particle substate; the 4-D kinematic state (position +
velocity in 2-D) is marginalized EXACTLY by one Kalman filter per
particle (`ops.rbpf`), so 256 particles track what a plain bootstrap
filter needs tens of thousands for.

The same filter, driven by PMMH, infers the maneuver process-noise
scale from the track alone.

Run:  python examples_torch/28_rbpf_tracking.py
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
from bayesianinference_tpu_torch.ops import RBPFModel, rbpf_filter
from bayesianinference_tpu_torch.ops.particle import (
    ParticleModel,
    particle_filter,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

F64 = dict(dtype=torch.float64, device=DEVICE)

# ---- constant-velocity kinematics, regime-switched process noise ----
DT = 1.0
F = torch.tensor(
    [[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1]], **F64
)
H = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0]], **F64)  # position only
R_OBS = 4.0 * torch.eye(2, **F64)
Q_SCALE = (0.02, 2.0)  # cruise vs maneuver acceleration variance
P_STAY = 0.95


def _q(scale):
    # white-acceleration discretization
    g = torch.tensor([0.5 * DT**2, 0.5 * DT**2, DT, DT], **F64)
    return scale * torch.diag(g * g)


def _rbpf_model(q_maneuver):
    def trans(g, u, t):
        stay = torch.rand((u.shape[0], 1), generator=g, **F64) < P_STAY
        return torch.where(stay, u, 1.0 - u)

    def lin_trans(u, t):
        q = torch.where(u[0] > 0.5, q_maneuver, Q_SCALE[0])
        return F, torch.zeros(4, **F64), _q(q)

    return RBPFModel(
        init_sampler=lambda g, p: torch.zeros((p, 1), **F64),
        transition_sampler=trans,
        linear_init=lambda u: (torch.zeros(4, **F64), 25.0 * torch.eye(4, **F64)),
        linear_transition=lin_trans,
        linear_observation=lambda u, t: (H, torch.zeros(2, **F64), R_OBS),
    )


# ---- simulate a track with two maneuver bursts ----
rng = np.random.default_rng(5)
T = 30 if SMOKE else 120
regime = np.zeros(T, int)
regime[40:55] = 1
regime[85:100] = 1
x = np.zeros(4)
x[2:] = [1.0, 0.5]
xs, ys = [], []
F_np = F.cpu().numpy()
for t in range(T):
    if t > 0:
        q = Q_SCALE[regime[t]]
        g = np.asarray([0.5, 0.5, 1.0, 1.0])
        x = F_np @ x + rng.normal(size=4) * np.sqrt(q) * g
    xs.append(x.copy())
    ys.append(x[:2] + rng.normal(size=2) * 2.0)
xs, ys = np.asarray(xs), np.asarray(ys)

# ---- filter ----
res = rbpf_filter(
    _rbpf_model(Q_SCALE[1]), torch.as_tensor(ys, device=DEVICE), 256, torch.Generator(DEVICE).manual_seed(0)
)
est = res.linear_means.cpu().numpy()
p_man = res.nonlinear_means.cpu().numpy()[:, 0]
rmse_rbpf = float(np.sqrt(np.mean((est[:, :2] - xs[:, :2]) ** 2)))
rmse_obs = float(np.sqrt(np.mean((ys - xs[:, :2]) ** 2)))
print(f"position RMSE: observations {rmse_obs:.2f} -> RBPF {rmse_rbpf:.2f}")
man_acc = np.mean((p_man > 0.5) == (regime == 1))
print(f"maneuver-regime accuracy: {man_acc:.2f}")


# ---- plain bootstrap PF at the same particle count, for contrast ----
def _plain_pf():
    def init(g, p):
        reg = torch.zeros((p, 1), **F64)
        x0 = torch.randn((p, 4), generator=g, **F64) * 5.0
        return torch.cat([reg, x0], dim=1)

    def trans(g, u, t):
        stay = torch.rand((u.shape[0], 1), generator=g, **F64) < P_STAY
        reg = torch.where(stay, u[:, :1], 1.0 - u[:, :1])
        q = torch.where(reg[:, 0] > 0.5, Q_SCALE[1], Q_SCALE[0])
        gg = torch.tensor([0.5, 0.5, 1.0, 1.0], **F64)
        eps = torch.randn((u.shape[0], 4), generator=g, **F64) * torch.sqrt(q)[:, None] * gg
        xn = u[:, 1:] @ F.T + eps
        return torch.cat([reg, xn], dim=1)

    def obs(u, y_t, t):
        e = y_t - u[:, 1:3]
        return -0.5 * torch.sum(e * e, dim=1) / 4.0 - np.log(2 * np.pi * 4.0)

    return ParticleModel(init, trans, obs)


pf = particle_filter(_plain_pf(), torch.as_tensor(ys, device=DEVICE), 256, torch.Generator(DEVICE).manual_seed(0))
est_pf = pf.filter_means.cpu().numpy()[:, 1:3]
rmse_pf = float(np.sqrt(np.mean((est_pf - xs[:, :2]) ** 2)))
print(f"plain bootstrap PF (same 256 particles) RMSE: {rmse_pf:.2f}")
print(
    f"marginal-likelihood estimates: RBPF {float(res.log_likelihood):.1f}, "
    f"PF {float(pf.log_likelihood):.1f}"
)

try:
    import matplotlib
except ImportError:  # the figure is optional: every number above is computed either way
    print("skipped rbpf_tracking.png: matplotlib is not installed")
else:
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax0, ax1) = plt.subplots(
        2, 1, figsize=(10, 7), height_ratios=[3, 1]
    )
    ax0.plot(ys[:, 0], ys[:, 1], ".", ms=3, color="0.6", label="radar returns")
    ax0.plot(xs[:, 0], xs[:, 1], "-", color="k", lw=1, label="truth")
    ax0.plot(est[:, 0], est[:, 1], "-", color="C3", lw=1.2, label="RBPF (256 particles)")
    ax0.legend()
    ax0.set_title(
        f"RBPF tracking: RMSE {rmse_rbpf:.2f} vs obs {rmse_obs:.2f} "
        f"(plain PF {rmse_pf:.2f})"
    )
    ax1.fill_between(np.arange(T), 0, p_man, color="C3", alpha=0.5)
    ax1.step(np.arange(T), regime, color="k", lw=0.8, alpha=0.6)
    ax1.set_ylabel("P(maneuver)")
    ax1.set_xlabel("t")
    fig.tight_layout()
    fig.savefig(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "rbpf_tracking.png"), dpi=110)
    print("wrote rbpf_tracking.png")
