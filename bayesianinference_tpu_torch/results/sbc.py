"""Simulation-based calibration (SBC) of inference engines (port of
``bayesianinference_tpu.results.sbc``).

SBC (Talts, Betancourt, Simpson, Vehtari & Gelman 2018) checks that a
fitting pipeline is self-consistent: draw theta ~ prior, simulate
data | theta, fit the posterior, and record the rank of the true theta
among L posterior draws.  A calibrated pipeline gives ranks uniform on
{0, ..., L} for any prior, likelihood and data size.

The stages take their randomness from a ``torch.Generator``: the host loop
(``vectorized=False``, the default) calls ``prior_sample(generator)``,
``simulate(generator, theta)`` and ``posterior_draws(generator, data)`` in
turn for each replication, on the caller's generator.  ``vectorized=True``
runs the whole study as one ``torch.func.vmap`` over replications, where a
generator cannot go: the stages are called with ``None`` and draw from the
default generator of the generator's device (``randomness="different"``),
seeded from the caller's generator inside ``torch.random.fork_rng``, so
the study is reproducible and leaves the global state as it was.

Ranks count strictly ``draws < theta``.  Use about independent draws (thin
MCMC output), or the uniformity test over-rejects.

Not ported, as an XLA workaround: the ``jax.eval_shape`` probe of the draw
count (the vmapped call's output gives it here).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["SBCResult", "sbc_ranks", "sbc_uniformity_pvalues"]


def sbc_uniformity_pvalues(ranks, num_draws: int, num_bins: int = 0) -> torch.Tensor:
    """Per-parameter chi-squared goodness-of-fit p-values against the
    uniform distribution on {0, ..., num_draws}.

    ``ranks`` is [N, d] integer ranks; the bins split {0..L} into
    ``num_bins`` (default: L+1 capped at 20, and at N // 5 so that expected
    counts stay >= 5).  Returns [d] float64 p-values on the ranks' device;
    small values flag miscalibration of that parameter's posterior."""
    ranks = torch.as_tensor(ranks)
    n, d = ranks.shape
    dev = ranks.device
    levels = num_draws + 1
    if num_bins <= 0:
        num_bins = min(levels, 20, max(n // 5, 2))
    # rank in {0..L} -> bin in {0..B-1} with near-equal level counts
    bins = torch.clamp((ranks.to(torch.int64) * num_bins) // levels, max=num_bins - 1)
    counts = torch.nn.functional.one_hot(bins, num_bins).to(torch.float64).sum(dim=0)  # [d, B]
    # expected counts per bin, proportional to how many levels map there
    lvl_bins = torch.clamp((torch.arange(levels, device=dev) * num_bins) // levels, max=num_bins - 1)
    lvl_per_bin = torch.nn.functional.one_hot(lvl_bins, num_bins).to(torch.float64).sum(dim=0)
    expected = n * lvl_per_bin / levels  # [B]
    chi2 = torch.sum((counts - expected) ** 2 / expected, dim=-1)  # [d]
    dof = torch.full_like(chi2, (num_bins - 1) / 2.0)
    # chi2 survival function: P(X > x) = Gamma_upper(k/2, x/2) / Gamma(k/2)
    return torch.special.gammaincc(dof, chi2 / 2.0)


@dataclasses.dataclass(frozen=True)
class SBCResult:
    """Output of :func:`sbc_ranks`."""

    ranks: torch.Tensor  # [num_replications, d] int64 in {0..num_draws}
    thetas: torch.Tensor  # [num_replications, d] the simulated truths
    num_draws: int = 0  # L: posterior draws per replication
    param_names: Tuple[str, ...] = ()

    @property
    def num_replications(self) -> int:
        return self.ranks.shape[0]

    def uniformity_pvalues(self, num_bins: int = 0) -> torch.Tensor:
        """[d] chi-squared p-values; see :func:`sbc_uniformity_pvalues`."""
        return sbc_uniformity_pvalues(self.ranks, self.num_draws, num_bins=num_bins)

    def histogram(self, i: int, num_bins: int = 0):
        """(bin_edges, counts) of parameter ``i``'s ranks: the raw material
        of the SBC rank histogram."""
        levels = self.num_draws + 1
        if num_bins <= 0:
            num_bins = min(levels, 20, max(self.num_replications // 5, 2))
        counts, edges = np.histogram(self.ranks[:, i].cpu().numpy(), bins=num_bins, range=(-0.5, levels - 0.5))
        return edges, counts


def sbc_ranks(
    generator: Optional[torch.Generator],
    *,
    prior_sample: Callable,
    simulate: Callable,
    posterior_draws: Callable,
    num_replications: int,
    param_names: Tuple[str, ...] = (),
    vectorized: bool = False,
    theta_from_draws: Optional[Callable] = None,
    device=None,
) -> SBCResult:
    """Run one SBC study of a fitting pipeline.

    - ``prior_sample(generator) -> theta``: one [d] prior draw;
    - ``simulate(generator, theta) -> data``: one synthetic dataset;
    - ``posterior_draws(generator, data) -> [L, d]``: fit the pipeline under
      test to ``data`` and return L about independent posterior draws;
    - ``num_replications``: N independent (theta, data, fit) triples;
    - ``vectorized``: one ``torch.func.vmap`` over replications (every stage
      batchable, fixed-shape, and drawing with ``generator=None``; see the
      module docstring) instead of the host loop;
    - ``theta_from_draws``: maps each draw row to the comparable parameter
      vector (default: identity).

    ``generator`` None is one on ``device`` (the card unless the caller asks
    for the CPU) seeded 0.  Returns an :class:`SBCResult`."""
    if num_replications < 1:
        raise ValueError("num_replications must be >= 1")
    if generator is None:
        from ..core.device import resolve_device

        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    extract = theta_from_draws or (lambda row: row)

    def one_rep(g):
        theta = torch.as_tensor(prior_sample(g))
        data = simulate(g, theta)
        draws = torch.as_tensor(posterior_draws(g, data))
        comparable = torch.func.vmap(extract)(draws)
        rank = torch.sum((comparable < theta[None, :]).to(torch.int64), dim=0)
        return theta, rank, draws.shape[0]

    if vectorized:
        dev = generator.device
        seed = int(torch.randint(0, 2**62, (), generator=generator, device=dev))
        shape = {}

        def lane(_):
            theta, rank, shape["draws"] = one_rep(None)
            return theta, rank

        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(seed)
            thetas, rks = torch.func.vmap(lane, randomness="different")(torch.zeros((num_replications,), device=dev))
        num_draws = int(shape["draws"])
    else:
        thetas, rks, num_draws = [], [], None
        for _ in range(num_replications):
            th, rk, nd = one_rep(generator)
            thetas.append(th)
            rks.append(rk)
            num_draws = int(nd)
        thetas = torch.stack(thetas)
        rks = torch.stack(rks)
    if not param_names:
        param_names = tuple(f"x{i}" for i in range(thetas.shape[-1]))
    return SBCResult(ranks=rks, thetas=thetas, num_draws=num_draws, param_names=tuple(param_names))
