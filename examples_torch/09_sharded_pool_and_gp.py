"""Mesh-sharded workloads: pool-sharded nested sampling and the
distributed blocked Cholesky GP logML.

The JAX example runs on a virtual 8-device CPU mesh; here the eight shards
are the cards that are present, repeated (all eight on the one card of a
one-card host, each shard's block of K through both hand-written kernels),
or eight CPU shards under BI_EXAMPLE_DEVICE=cpu.

Run:  python examples_torch/09_sharded_pool_and_gp.py
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
from bayesianinference_tpu_torch.models import define_inference_problem
from bayesianinference_tpu_torch.ops.gp_kernels import (
    covariance_matrix,
    gp_log_marginal_likelihood,
    se_kernel,
)
from bayesianinference_tpu_torch.parallel import (
    make_mesh,
    sharded_gp_logml_blocked,
    sharded_pool_nested_sampling,
)

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)


def shard_devices(count=8):
    """``count`` shards over the cards that are present, repeated; the
    host's device ``count`` times off the card."""
    if DEVICE.type != "cuda":
        return [DEVICE] * count
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(count)]


# ---- 1. one coherent NS run, live points sharded over the mesh ----
A = 5.0
problem = define_inference_problem(
    parameters=[("x", -A, A), ("y", -A, A)],
    log_likelihood=lambda th: torch.sum(d.Normal(0.0, 1.0).log_prob(th)),
    prior_distribution=["location", "location"],
    device=DEVICE,
    dtype=torch.float64,
)
result = sharded_pool_nested_sampling(
    problem,
    torch.Generator(DEVICE).manual_seed(0),
    sample_pool_size=512,       # 64 live points per shard
    mesh=make_mesh(("live",), devices=shard_devices()),
    num_delete=8,               # global worst-8, one chain per shard
    max_iterations=3000,
    monte_carlo_steps=60,
)
print(
    f"pool-sharded NS: logZ = {result.log_evidence} "
    f"(analytic {-2 * np.log(2 * A):.3f}), "
    f"{result.num_likelihood_evals} likelihood evals"
)

# ---- 2. GP logML with K row-sharded end to end (never gathered) ----
mesh = make_mesh(("data",), devices=shard_devices())
rng = np.random.default_rng(0)
n = 2048
x = torch.as_tensor(rng.uniform(-2, 2, (n, 3)), device=DEVICE)
y = torch.as_tensor(np.sin(x.cpu().numpy()[:, 0]) + 0.1 * rng.standard_normal(n), device=DEVICE)
kern = se_kernel(1.3, 0.8)
sharded = float(sharded_gp_logml_blocked(kern, x, y, mesh, nugget=0.1))
dense = float(gp_log_marginal_likelihood(covariance_matrix(kern, x, nugget=0.1), y))
print(f"sharded GP logML = {sharded:.9f}  (dense single-device {dense:.9f})")

# ---- 3. GP posterior prediction, still never gathering K ----
from bayesianinference_tpu_torch.ops.gp_kernels import gp_posterior_moments
from bayesianinference_tpu_torch.parallel import sharded_gp_predict

xq = torch.linspace(-2.0, 2.0, 9, dtype=torch.float64, device=DEVICE)[:, None] * torch.ones(
    (1, 3), dtype=torch.float64, device=DEVICE)
mean_sh, std_sh = sharded_gp_predict(kern, x, y, xq, mesh, nugget=0.1)
mean_ref, std_ref = gp_posterior_moments(kern, x, y, xq, nugget=0.1)
print(
    "sharded GP predict max |err| vs single-device: "
    f"mean {float(torch.max(torch.abs(mean_sh.to(DEVICE) - mean_ref))):.2e}, "
    f"std {float(torch.max(torch.abs(std_sh.to(DEVICE) - std_ref))):.2e}"
)

# ---- 4. long-data conjugate regression: sufficient statistics summed ----
from bayesianinference_tpu_torch.engines import bayesian_linear_regression
from bayesianinference_tpu_torch.parallel import sharded_bayesian_linear_regression

nr = 100_003  # not a multiple of 8: padding mask handles it
xr_np = rng.uniform(-2, 2, (nr, 1))
xr = torch.as_tensor(xr_np, device=DEVICE)
yr = torch.as_tensor(
    1.0 - 2.0 * xr_np[:, 0]
    + 0.5 * xr_np[:, 0] ** 3
    + 0.1 * rng.standard_normal(nr),
    device=DEVICE,
)
blr_sh = sharded_bayesian_linear_regression(xr, yr, mesh, degree=3)
blr_d = bayesian_linear_regression(xr, yr, degree=3)
print(
    f"sharded BLR logZ = {float(blr_sh.log_evidence):.6f} "
    f"(dense {float(blr_d.log_evidence):.6f}); "
    f"coefficients {np.round(blr_sh.posterior_parameters.b.cpu().numpy(), 3)}"
)
