"""The spread of example 24's IBIS log evidences over seeds at its smoke size
(512 particles, batches of 10, 8 AM steps) on the CPU, for both noise models:
the scale behind ``tests/test_torch_examples.py``'s tolerances for 24.

    python tests/ibis_example_spread_study.py [seeds]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesianinference_tpu_torch import dists as d  # noqa: E402
from bayesianinference_tpu_torch.engines import ibis_sampler  # noqa: E402
from bayesianinference_tpu_torch.models import define_inference_problem  # noqa: E402


def main(seeds: int) -> None:
    torch.set_num_threads(1)
    rng = np.random.default_rng(2)
    data = torch.as_tensor(1.5 + 0.6 * rng.standard_t(df=3, size=120))
    models = {"Gaussian": lambda th: d.Normal(th[0], th[1]), "Student-t3": lambda th: d.StudentT(3.0, th[0], th[1])}
    for name, noise in models.items():
        problem = define_inference_problem(
            parameters=[("mu", -10.0, 10.0), ("scale", 0.05, 5.0)],
            log_likelihood=lambda th, noise=noise: torch.sum(noise(th).log_prob(data)),
            prior_distribution=d.Product((d.Normal(0.0, 3.0), d.LogNormal(0.0, 1.0))), validate=False,
            device="cpu", dtype=torch.float64)
        lz = [float(ibis_sampler(problem, lambda th, y, noise=noise: noise(th).log_prob(y), data,
                                 torch.Generator().manual_seed(s), n_particles=512, batch_size=10,
                                 mcmc_steps=8).log_evidence) for s in range(seeds)]
        print(f"{name}: logZ over seeds 0-{seeds - 1} {np.round(lz, 3).tolist()}, mean {np.mean(lz):.4f}, "
              f"sd {np.std(lz, ddof=1):.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
