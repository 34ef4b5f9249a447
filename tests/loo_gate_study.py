"""The readings behind ``chip_smoke.py`` 16f's PSIS-LOO and WAIC limits, on
the CPU.  Not collected by pytest.

``python tests/loo_gate_study.py [seeds]``
    For each of 16f's conjugate Normal models: the error against the exact
    leave-one-out elpd of PSIS-LOO, WAIC and plain importance-sampling LOO
    (no tail smoothing) on ``chip_smoke.LOO_DRAWS`` random draws of the
    exact posterior, over ``seeds`` seeds (default 40: mean, sd and largest
    magnitude), then on the quantile grid that 16f runs (no Monte-Carlo
    noise).  16f's limits are three times the grid's largest PSIS-LOO and
    WAIC errors over the models.
"""

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def plain_is_loo(mu0, tau0, draws):
    """Importance-sampling LOO with raw ratios 1 / p(y_i | theta)."""
    _, data, pm, psd, _ = cs._normal_model(torch.device("cpu"), n_obs=40, tau0=tau0, mu0=mu0)
    theta = pm + psd * draws.numpy()
    ll = -0.5 * math.log(2 * math.pi) - 0.5 * (data[None, :] - theta[:, None]) ** 2  # [S, n]
    neg = -ll
    m = neg.max(axis=0)
    return float(np.sum(-(m + np.log(np.mean(np.exp(neg - m), axis=0)))))


def main(seeds: int = 40):
    cpu = torch.device("cpu")
    grid_worst = [0.0, 0.0]
    for mu0, tau0 in cs.LOO_MODELS:
        errs = []
        for seed in range(seeds):
            draws = torch.randn(cs.LOO_DRAWS, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
            loo, wa, exact = cs._loo_case(cpu, mu0, tau0, draws)
            errs.append((loo.elpd_loo - exact, wa.elpd - exact, plain_is_loo(mu0, tau0, draws) - exact))
        errs = np.array(errs)
        for j, what in enumerate(("PSIS-LOO", "WAIC", "plain IS-LOO")):
            e = errs[:, j]
            print(f"N(mu0={mu0}, tau0={tau0}), {seeds} seeds of {cs.LOO_DRAWS} random draws, {what} - exact LOO: "
                  f"mean {e.mean():+.4e}, sd {e.std():.4e}, largest {np.abs(e).max():.4e}")
        loo, wa, exact = cs._loo_case(cpu, mu0, tau0)
        u = (torch.arange(cs.LOO_DRAWS, dtype=torch.float64) + 0.5) / cs.LOO_DRAWS
        is_err = plain_is_loo(mu0, tau0, torch.special.ndtri(u)) - exact
        print(f"N(mu0={mu0}, tau0={tau0}), quantile grid: PSIS-LOO {loo.elpd_loo - exact:+.4e}, WAIC "
              f"{wa.elpd - exact:+.4e}, plain IS-LOO {is_err:+.4e}, max k {float(loo.pareto_k.max()):.3f}")
        grid_worst = [max(grid_worst[0], abs(loo.elpd_loo - exact)), max(grid_worst[1], abs(wa.elpd - exact))]
    print(f"three times the grid's largest: PSIS-LOO {3 * grid_worst[0]:.4e} (LOO_TOL {cs.LOO_TOL}), WAIC "
          f"{3 * grid_worst[1]:.4e} (WAIC_TOL {cs.WAIC_TOL})")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
