"""The float32 error of the latent-GP logML gradient on the CPU, the study
behind ``chip_smoke.py`` 14b's gate.  Not collected by pytest.

``python tests/f32_latent_grad_study.py [--repo PATH] [N ...]``
    For each n (default 1024 2048), Laplace and EP, the logit classifier
    at theta = [1.5, 1.0] (jitter 1e-5) on the data of seeds 0-7 of 14b's
    generator: the normalized error of [logML, gradient] against float64
    (14b's measure, root mean square over the seeds) of three float32
    paths: the port's ``covariance_matrix`` (the SE op and its reverse
    rule), the same covariance by autograd through direct differences (the
    plain path of 14b), and K alone rounded to float32 (the rest float64).
    ``--repo`` imports the port from another tree, such as a ``git
    archive`` of an earlier commit.
"""

import sys
from pathlib import Path

import numpy as np
import torch

args = sys.argv[1:]
repo = Path(__file__).resolve().parents[1]
if args[:1] == ["--repo"]:
    repo, args = Path(args[1]).resolve(), args[2:]
sys.path.insert(0, str(repo))
from bayesianinference_tpu_torch.ops import gp_ep, gp_kernels, gp_laplace  # noqa: E402

torch.set_num_threads(4)
SEEDS = 8


def class_data(n: int, seed: int):
    """chip_smoke.py's ``_class_data`` (benchmarks/latent_gp.py's)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0).astype(np.float32)
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * x[:, 0])))
    return x, (rng.uniform(size=n) < p).astype(np.float32)


def covariance(th, x, path):
    if path == "direct":
        d = x[:, None, 0] / th[1] - x[None, :, 0] / th[1]
        return th[0] ** 2 * torch.exp(-0.5 * d * d) + 1e-5 * torch.eye(x.shape[0], dtype=x.dtype)
    return gp_kernels.covariance_matrix(gp_kernels.se_kernel(th[0] ** 2, th[1]), x, 1e-5)


def value_and_grad(fn, n, seed, dtype, path):
    x_np, y_np = class_data(n, seed)
    kdtype = torch.float32 if path == "k32" else dtype
    th = torch.tensor([1.5, 1.0], dtype=kdtype, requires_grad=True)
    x = torch.as_tensor(x_np, dtype=kdtype)
    y = torch.as_tensor(y_np, dtype=torch.float64 if path == "k32" else dtype)
    k = covariance(th, x, "op" if path == "k32" else path)
    v = fn(k.double() if path == "k32" else k, y, gp_laplace.bernoulli_logit_likelihood())
    (g,) = torch.autograd.grad(v, th)
    return torch.cat([v.detach().reshape(1), g]).double()


def main():
    sizes = [int(a) for a in args] or [1024, 2048]
    for n in sizes:
        for method, fn in (("laplace", gp_laplace.gp_laplace_log_marginal), ("ep", gp_ep.gp_ep_log_marginal)):
            errs = {"op": [], "direct": [], "k32": []}
            for seed in range(SEEDS):
                ref = value_and_grad(fn, n, seed, torch.float64, "op")
                scale = torch.cat([ref[:1].abs(), torch.full_like(ref[1:], float(ref[1:].norm()))])
                for path in errs:
                    errs[path].append(((value_and_grad(fn, n, seed, torch.float32, path) - ref) / scale).norm())
            rms = {p: float(torch.stack(e).pow(2).mean().sqrt()) for p, e in errs.items()}
            print(f"n={n} {method}: normalized error over {SEEDS} seeds: the SE op {rms['op']:.2e}, direct "
                  f"autograd {rms['direct']:.2e}, K alone in float32 {rms['k32']:.2e}; per seed, the op over "
                  f"direct: {' '.join(f'{a / b:.2f}' for a, b in zip(errs['op'], errs['direct']))}", flush=True)


if __name__ == "__main__":
    main()
