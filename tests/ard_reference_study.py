"""The reading behind ``chip_smoke.py`` 16c's ARD reference, on the CPU.
Not collected by pytest.

``python tests/ard_reference_study.py [n] [steps ...]``
    Phase 9's ARD GP (22 hyperparameters) on ``n`` points (default 64):
    Pathfinder at its defaults (ELBO, logZ_IS, pareto k, and bridge
    sampling of its own pool), then the reference 16c holds it against,
    bridge sampling of ``chip_smoke.ARD_REF_CHAINS`` HMC chains started at
    the fit's draws, for each number of warmup and sample steps (default 50
    and 150), at generator seeds 4 and 5: logZ, relative error, split R-hat.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from bayesianinference_tpu_torch.engines import pathfinder as pf  # noqa: E402
from bayesianinference_tpu_torch.engines.bridge import bridge_sampling_evidence  # noqa: E402
from bayesianinference_tpu_torch.engines.hmc import hmc_sample  # noqa: E402
from bayesianinference_tpu_torch.interop import problem_data_from_numpy  # noqa: E402
from bayesianinference_tpu_torch.results import gelman_rubin  # noqa: E402

torch.set_num_threads(2)


def main(n: int = 64, *steps: int):
    steps = steps or (50, 150)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, cs.ARD_D))
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] + 0.1 * rng.normal(size=n)
    problem = cs._ard_gp_problem(*problem_data_from_numpy(x, y, device="cpu", dtype=torch.float64))
    fit = pf.pathfinder_fit(problem, torch.Generator().manual_seed(0))
    own = bridge_sampling_evidence(problem, fit, torch.Generator().manual_seed(1))
    print(f"n = {n}: Pathfinder ELBO {float(fit.elbo):.4f}, logZ_IS {float(fit.log_evidence_is):.4f}, pareto k "
          f"{float(fit.pareto_k):.3f}; bridge of its own pool {float(own.log_evidence):.4f} (re "
          f"{float(own.relative_error):.4f})")
    chains = cs.ARD_REF_CHAINS
    for s in steps:
        for seed in (4, 5):
            t0 = time.perf_counter()
            g = torch.Generator().manual_seed(seed)
            h = hmc_sample(problem, g, num_chains=chains, num_samples=s, num_warmup=s, num_leapfrog=8,
                           starting_points=fit.posterior_samples(g, chains).points)
            br = bridge_sampling_evidence(problem, h, g)
            rhat = max(float(gelman_rubin(h.per_parameter_chains(i))) for i in range(problem.dim))
            print(f"{chains} HMC chains x {s} + {s} steps, seed {seed}: bridge logZ {float(br.log_evidence):.4f} "
                  f"(re {float(br.relative_error):.4f}), split R-hat {rhat:.3f}, "
                  f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
