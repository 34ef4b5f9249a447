"""Normalizing-flow variational inference (RealNVP couplings); port of
``bayesianinference_tpu.engines.flow_vi``.

A non-Gaussian variational family: ``num_layers`` affine coupling layers
(Dinh et al. 2017) with alternating even/odd masks and two-tanh-layer
conditioners, then a global dense affine layer, fitted in the unconstrained
space of the box bijection (:func:`..core.transforms.box_bijection`) by
stochastic reparameterization gradients.  The couplings start at the
identity and the affine layer at unit scale, so step 0 is a standard
Gaussian in z-space, as ADVI's is; the affine layer makes exactly-Gaussian
posteriors exactly representable.

Evidence comes twice: ``elbo``, the lower bound, and ``log_evidence``,
Pareto-smoothed importance sampling through the fitted flow over a fresh
batch (:func:`..results.information._psis_smooth_tail`), with its
``pareto_k`` diagnostic (trust it below 0.7).

Each Adam step (cosine-decayed, :mod:`..core.optim`) is one batched value
and gradient of the z-space log posterior at ``num_elbo_samples`` flowed
draws, so on a GP problem both hand kernels and both reverse rules run at
that batch; the final batch goes through the density in chunks of
``vi.EVAL_CHUNK``.  The random numbers are inputs: the initial parameters
(``initial_params``) and the base draws (``draws``, a
:class:`~.vi.VIDraws`) or ``generator``.

Not ported, as XLA workarounds: the ``jax.jit`` program cache keyed on
the static arguments (``_flow_vi_program``, whose retrace test
``tests/test_flow_vi.py::test_flow_serving_cache`` has no counterpart) and
the one-program ``lax.scan`` over steps (a host loop over eager steps).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.containers import WeightedSamples
from ..core.numerics import logmeanexp
from ..core.optim import adam_init, adam_step, cosine_decay_schedule
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.chmc import _safe_grad
from .vi import VIDraws, in_chunks, vi_draws, z_log_target

__all__ = ["FlowVIResult", "flow_vi_fit"]

_COUPLING_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")
_AFFINE_KEYS = ("log_diag", "off", "loc")


# --------------------------------------------------------------- the flow


def _init_flow(generator: Optional[torch.Generator], d: int, num_layers: int, hidden: int, dtype, device=None):
    """Couplings start at the identity (zero final MLP layer) and the
    affine layer at unit scale, so step 0 is a standard Gaussian in
    z-space, the same starting family as ADVI."""
    device = device or (generator.device if generator is not None else None)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) / math.sqrt(float(fan_in))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    couplings = [{"w1": normal((d, hidden), d), "b1": zeros(hidden), "w2": normal((hidden, hidden), hidden),
                  "b2": zeros(hidden), "w3": zeros(hidden, 2 * d), "b3": zeros(2 * d)} for _ in range(num_layers)]
    return {"couplings": couplings, "affine": {"log_diag": zeros(d), "off": zeros(d, d), "loc": zeros(d)}}


def _masks(d: int, num_layers: int, dtype, device=None):
    """Each layer's (mask, 1 - mask): even layers keep the odd coordinates,
    odd layers the even ones (two tensors shared by all layers)."""
    base = (torch.arange(d, device=device) % 2).to(dtype)
    pair = (base, 1.0 - base)
    return [pair if l % 2 == 0 else pair[::-1] for l in range(num_layers)]


def _conditioner(p, x_masked, d: int):
    h = torch.tanh(torch.nn.functional.linear(x_masked, p["w1"].T, p["b1"]))
    h = torch.tanh(torch.nn.functional.linear(h, p["w2"].T, p["b2"]))
    # one split, whose backward is one concatenation (two slices would each
    # scatter into a zeroed copy)
    s, t = torch.nn.functional.linear(h, p["w3"].T, p["b3"]).split(d, dim=-1)
    return 2.0 * torch.tanh(s), t  # bounded log-scale keeps inverses sane


def _tril(a):
    return torch.tril(a["off"], diagonal=-1) + torch.diag(torch.exp(a["log_diag"]))


def _flow_forward(params, z, d: int):
    """Base draw -> posterior draw; returns (x, logdet)."""
    logdet = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    for p, (m, keep) in zip(params["couplings"], _masks(d, len(params["couplings"]), z.dtype, z.device)):
        s, t = _conditioner(p, z * m, d)
        # m z + (1 - m)(z e^s + t) with the masks applied to s and t: the
        # kept coordinates take z e^0 + 0 = z exactly
        ks = keep * s
        z = torch.addcmul(keep * t, z, torch.exp(ks))
        logdet = logdet + torch.sum(ks, dim=-1)
    a = params["affine"]
    z = torch.nn.functional.linear(z, _tril(a), a["loc"])
    return z, logdet + torch.sum(a["log_diag"])


def _flow_inverse(params, x, d: int):
    """Posterior point -> base point; returns (z, logdet of FORWARD)."""
    a = params["affine"]
    diff = x - a["loc"]
    # batch axes ride as right-hand-side columns of one triangular solve
    sol = torch.linalg.solve_triangular(_tril(a), diff.reshape(-1, d).T, upper=False)
    x = sol.T.reshape(diff.shape)
    logdet = torch.sum(a["log_diag"]) * torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    for p, (m, keep) in zip(reversed(params["couplings"]),
                            reversed(_masks(d, len(params["couplings"]), x.dtype, x.device))):
        s, t = _conditioner(p, x * m, d)
        x = m * x + keep * ((x - t) * torch.exp(-s))
        logdet = logdet + torch.sum(keep * s, dim=-1)
    return x, logdet


def _base_logpdf(z):
    return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * z.shape[-1] * math.log(2.0 * math.pi)


def _leaves(params) -> list:
    """The flow's parameter tree as a list of tensors, in a fixed order."""
    return [params["affine"][k] for k in _AFFINE_KEYS] + [c[k] for c in params["couplings"] for k in _COUPLING_KEYS]


def _tree(flat: torch.Tensor, like: list) -> dict:
    """The parameter tree as views of one flat vector (the shapes of
    ``like``'s leaves): a step's gradient is then one vector, and Adam and
    the finite-gradient guard one elementwise pass over it."""
    parts = [v.view(t.shape) for v, t in zip(torch.split(flat, [t.numel() for t in like]), like)]
    n = len(_AFFINE_KEYS)
    couplings = [dict(zip(_COUPLING_KEYS, parts[i:i + len(_COUPLING_KEYS)]))
                 for i in range(n, len(parts), len(_COUPLING_KEYS))]
    return {"couplings": couplings, "affine": dict(zip(_AFFINE_KEYS, parts[:n]))}


# --------------------------------------------------------------- results


@dataclasses.dataclass(frozen=True)
class FlowVIResult:
    """A fitted flow posterior (RealNVP in unconstrained space)."""

    params: dict  # flow parameters: {"couplings": [{w1, b1, ...}], "affine": {log_diag, off, loc}}
    elbo: torch.Tensor  # lower-bounds log evidence
    elbo_history: torch.Tensor  # [num_steps]
    log_evidence: torch.Tensor  # PSIS importance estimate of logZ
    pareto_k: torch.Tensor  # tail diagnostic (trust logZ when < 0.7)
    lower: torch.Tensor  # [d] problem box
    upper: torch.Tensor  # [d]
    param_names: Tuple[str, ...] = ()

    @property
    def dim(self) -> int:
        return self.lower.shape[-1]

    def sample(self, generator: Optional[torch.Generator], num_samples: int, *,
               normals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[num_samples, d] draws, constrained space; ``normals``
        [num_samples, d] replaces the generator's."""
        bij = box_bijection(self.lower, self.upper)
        if normals is None:
            normals = torch.randn((num_samples, self.dim), generator=generator, dtype=self.lower.dtype,
                                  device=self.lower.device)
        z, _ = _flow_forward(self.params, normals.to(self.lower), self.dim)
        return bij.to_x(z)

    def posterior_samples(self, generator: Optional[torch.Generator], num_samples: int = 4000, *,
                          normals: Optional[torch.Tensor] = None) -> WeightedSamples:
        pts = self.sample(generator, num_samples, normals=normals)
        return WeightedSamples(points=pts, log_weights=torch.zeros((pts.shape[0],), dtype=pts.dtype,
                                                                  device=pts.device))

    def log_prob(self, x) -> torch.Tensor:
        """Fitted-posterior log density at constrained-space ``x`` [..., d]
        (the flow's exact inverse pass minus the bijection volume)."""
        bij = box_bijection(self.lower, self.upper)
        z = bij.to_z(torch.as_tensor(x, dtype=self.lower.dtype, device=self.lower.device))
        eps, logdet = _flow_inverse(self.params, z, self.dim)
        return _base_logpdf(eps) - logdet - bij.log_jacobian(z)


# --------------------------------------------------------------- engine


def flow_vi_fit(
    problem: InferenceProblem,
    generator: Optional[torch.Generator] = None,
    *,
    num_layers: int = 6,
    hidden: int = 32,
    num_steps: int = 3000,
    num_elbo_samples: int = 64,
    learning_rate: float = 0.01,
    final_evidence_samples: int = 8192,
    initial_params: Optional[dict] = None,
    draws: Optional[VIDraws] = None,
) -> FlowVIResult:
    """Fit a RealNVP flow posterior by stochastic-gradient VI.

    Returns both the ``elbo`` lower bound and a PSIS importance estimate
    ``log_evidence`` with its ``pareto_k`` tail diagnostic: with a
    well-fitted flow (k < 0.7) the importance estimate is a nearly unbiased
    logZ, typically a factor sharper than the bound.

    ``num_layers`` couplings alternate even/odd masks; ``hidden`` sizes the
    two-tanh-layer conditioners.  Defaults fit low-dimensional (d <= ~30)
    problems; scale ``hidden`` with d.  The fit runs on the problem's
    device; ``generator`` None is one there seeded 0; ``initial_params``
    (the parameter tree) and ``draws`` (:func:`~.vi.vi_draws`: step normals
    [num_steps, num_elbo_samples, d], final [final_evidence_samples, d])
    replace its numbers."""
    dev, dtype, d = problem.device, problem.dtype, problem.dim
    if initial_params is None or draws is None:
        generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
    params = _init_flow(generator, d, num_layers, hidden, dtype, dev) if initial_params is None else initial_params
    if draws is None:
        draws = vi_draws(generator, num_steps, num_elbo_samples, final_evidence_samples, d, dtype)
    if tuple(draws.steps.shape) != (num_steps, num_elbo_samples, d) or tuple(draws.final.shape) != (
            final_evidence_samples, d):
        raise ValueError(f"draws must be [{num_steps}, {num_elbo_samples}, {d}] and [{final_evidence_samples}, {d}]")
    log_target = z_log_target(problem, box_bijection(problem.lower, problem.upper))

    def log_weights(tree, eps):
        z, logdet = _flow_forward(tree, eps, d)
        return log_target(z) - (_base_logpdf(eps) - logdet)

    schedule = cosine_decay_schedule(learning_rate, num_steps, alpha=0.01)
    like = _leaves(params)
    flat = {"theta": torch.cat([t.to(dtype).reshape(-1) for t in like])}
    state = adam_init(flat)
    history = []
    for t in range(num_steps):
        with torch.enable_grad():
            theta = flat["theta"].detach().requires_grad_(True)
            loss = -torch.mean(log_weights(_tree(theta, like), draws.steps[t]))
            (grad,) = torch.autograd.grad(loss, theta)
        # a draw far in the tail can touch guarded regions whose gradients
        # are not finite: those entries skip the update
        flat, state = adam_step(flat, {"theta": _safe_grad(grad)}, state, schedule(state.count))
        history.append(-loss.detach())
    params = _tree(flat["theta"], like)
    with torch.no_grad():
        lw = in_chunks(lambda eps: log_weights(params, eps), draws.final)
    # PSIS smoothing of the importance tail (host-side numpy, as Pathfinder's
    # pooled weights)
    from ..results.information import _psis_smooth_tail

    shift = torch.max(lw)
    smoothed, khat = _psis_smooth_tail((lw - shift).cpu().numpy())
    log_z = shift + logmeanexp(torch.as_tensor(smoothed, dtype=dtype, device=dev))
    return FlowVIResult(
        params=params, elbo=torch.mean(lw),
        elbo_history=torch.stack(history) if history else torch.zeros((0,), dtype=dtype, device=dev),
        log_evidence=log_z, pareto_k=torch.as_tensor(float(khat), dtype=dtype, device=dev),
        lower=problem.lower, upper=problem.upper, param_names=problem.param_names,
    )
