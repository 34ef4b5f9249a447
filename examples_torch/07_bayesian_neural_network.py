"""Quasi-Bayesian regression network: alpha-divergence training with MC
dropout, the predictive mean and spread, and the network's log evidence.

Run:  python examples_torch/07_bayesian_neural_network.py
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

from bayesianinference_tpu_torch.bnn import (
    network_log_evidence,
    regression_net,
    sample_trained_net,
    train_regression_net,
)
from bayesianinference_tpu_torch.core.device import resolve_device

# the card unless BI_EXAMPLE_DEVICE names another device; raises without one
DEVICE = resolve_device(_os.environ.get("BI_EXAMPLE_DEVICE") or None)

rng = np.random.default_rng(0)
x = rng.uniform(-2, 2, size=(512, 1)).astype(np.float32)
y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=512).astype(np.float32)

net = regression_net(depth=3, layer_size=64, dropout_probability=0.1)
trained = train_regression_net(
    net, torch.Generator(DEVICE).manual_seed(0), torch.as_tensor(x, device=DEVICE),
    torch.as_tensor(y, device=DEVICE),
    alpha=0.5, sample_number=8, num_steps=100 if SMOKE else 3000,
    learning_rate=3e-3,
)
params, history = trained.params, trained.history
print(f"loss: {float(history[0]):.3f} -> {float(history[-1]):.3f}")

xq = np.linspace(-1.8, 1.8, 9)[:, None].astype(np.float32)
pred = sample_trained_net(net, params, torch.Generator(DEVICE).manual_seed(1), torch.as_tensor(xq, device=DEVICE))
for xi, m, s in zip(xq[:, 0], pred.mean().cpu().numpy(), pred.std().cpu().numpy()):
    print(f"  f({xi:+.2f}) = {m:+.3f} ± {s:.3f}   (true {np.sin(2 * xi):+.3f})")

# the trained bundle auto-extracts alpha (the reference reads it back out
# of the trained net graph, NN:361-374)
lz = network_log_evidence(
    trained, torch.Generator(DEVICE).manual_seed(2), torch.as_tensor(x, device=DEVICE),
    torch.as_tensor(y, device=DEVICE),
    lambda2=1e-4, sample_number=50,
)
print(f"network log evidence: {float(lz):.2f}")
