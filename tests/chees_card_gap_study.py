"""Parallel HMC with ChEES (``num_leapfrog="auto"``) on the card against the
same run on CPU tensors, on the same draws, at the JAX smoke configuration
(8 chains, 60 warmup + 40 samples, the 2-D standard normal in [-5, 5]^2,
float64).  Not collected by pytest; needs a card.

``python tests/chees_card_gap_study.py [seeds]``
    For each host seed s < ``seeds`` (default 4): the draws and starting
    points from ``Generator().manual_seed(s)``, the run on ``cuda`` and on
    the CPU, and the largest relative difference (of the largest entry) of
    the samples, step size, inverse mass and trajectory length.  The last
    line is the largest over the seeds, the bound that
    ``tests/test_torch_cuda.py``'s ChEES case states.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIELDS = ("samples", "step_size", "inv_mass_diag", "trajectory_length")
RUN = dict(num_chains=8, num_warmup=60, num_samples=40, num_leapfrog="auto")


def _problem(dev):
    from bayesianinference_tpu_torch.dists.scalar import Normal
    from bayesianinference_tpu_torch.models import define_inference_problem

    return define_inference_problem(parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
                                    log_likelihood=lambda th: Normal(0.0, 1.0).log_prob(th).sum(),
                                    prior_distribution=["location", "location"], validate=False, device=dev,
                                    dtype=torch.float64)


def _rel(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def main(seeds: int) -> None:
    from bayesianinference_tpu_torch.ops.chees import ChEESDraws, chees_draws
    from bayesianinference_tpu_torch.ops.hmc import _phase_lengths
    from bayesianinference_tpu_torch.parallel import parallel_hmc

    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    card, host = _problem("cuda"), _problem("cpu")
    worst = 0.0
    for s in range(seeds):
        g = torch.Generator().manual_seed(s)
        x0 = 4.0 * torch.rand((8, 2), generator=g, dtype=torch.float64) - 2.0
        d = chees_draws(g, 8, 2, num_trajectories=sum(_phase_lengths(60)) + 40, dtype=torch.float64)
        a = parallel_hmc(card, None, starting_points=x0.cuda(), draws=ChEESDraws(*(t.cuda() for t in d)), **RUN)
        b = parallel_hmc(host, None, starting_points=x0, draws=d, **RUN)
        errs = {f: _rel(getattr(a, f), getattr(b, f)) for f in FIELDS}
        worst = max(worst, *errs.values())
        steps = float(b.trajectory_length) / float(b.step_size)
        print(f"seed {s}: the card against the CPU on the same draws: "
              + ", ".join(f"{f} {e:.2e}" for f, e in errs.items()) + f"; steps a trajectory {steps:.3f}", flush=True)
    print(f"largest over {seeds} seeds: {worst:.2e} ({torch.cuda.get_device_name(0)})", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
