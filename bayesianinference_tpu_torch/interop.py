"""Carry data and state between numpy arrays and the port's tensors.

The JAX package's ``NSState``, ``AMState``, ``SliceState`` and ``CHMCState``
are pytrees of arrays, and its ``NSSegment`` a dataclass of numpy arrays;
taken field by field as ``np.asarray``, they become dicts of numpy arrays,
which the functions here turn into the port's states on a given device and
dtype (and back).  The conjugate parameter sets (``BLRParameters``,
``NormalInverseGamma``, ``NormalInverseWishart``) are taken as such a dict
or as the object itself, read by attribute.  A type-II maximum-likelihood fit
of the latent-GP classifier or of the sparse GP, and the coregionalization
parameters of the multi-output GP, carry over the same way, and so do the
stochastic variational GP's parameter sets (``SVGPVariational`` and the
three fits), Bayesian optimization's ``BayesOptState``, and the fitted
``VIResult`` and ``PathfinderResult``; so do the predictive laws, a
``Mixture``, ``PointwiseMixture`` or ``GaussianKDE`` (their component
taken as the port's family of the same name, its parameters by field
name), so that both packages' scores and quantiles can be computed on one
object.  Without
``device=`` the tensors go to the CUDA card,
and the call raises where there is none: ``device="cpu"`` asks for the
host.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import dataclasses

from . import dists
from .core.device import resolve_device
from .dists.conjugate_structs import NormalInverseGamma, NormalInverseWishart
from .engines.conjugate import BLRParameters
from .engines.dynamic_ns import NSSegment
from .engines.bayesopt import BayesOptState
from .engines.gp_classify import _NAMED_LIKELIHOODS, GPClassifierOptimization
from .engines.sparse_gp import SGPROptimization, with_inducing
from .engines.svgp import SVGPFit, SVGPHeteroFit, SVGPMulticlassFit
from .core.containers import WeightedSamples
from .engines.nested_sampling import NSState
from .engines.pathfinder import PathfinderResult
from .engines.vi import VIResult
from .ops.chmc import CHMCState
from .ops.metropolis import AMState
from .ops.slice import SliceState
from .ops.svgp import SVGPVariational

__all__ = [
    "problem_data_from_numpy",
    "ns_state_from_numpy",
    "ns_state_to_numpy",
    "am_state_from_numpy",
    "am_state_to_numpy",
    "slice_state_from_numpy",
    "slice_state_to_numpy",
    "chmc_state_to_numpy",
    "ns_segment_from_numpy",
    "blr_parameters_from_numpy",
    "normal_inverse_gamma_from_numpy",
    "normal_inverse_wishart_from_numpy",
    "gp_classifier_optimization_from_numpy",
    "sgpr_optimization_from_numpy",
    "coregional_parameters_from_numpy",
    "svgp_variational_from_numpy",
    "svgp_fit_from_numpy",
    "svgp_multiclass_fit_from_numpy",
    "svgp_hetero_fit_from_numpy",
    "bayes_opt_state_from_numpy",
    "bayes_opt_state_to_numpy",
    "vi_result_from_numpy",
    "pathfinder_result_from_numpy",
    "mixture_from_numpy",
    "pointwise_mixture_from_numpy",
    "gaussian_kde_from_numpy",
]

_EVAL_BASE = 1 << 30  # radix of the JAX package's (hi, lo) int32 eval counter
_NS_TENSORS = (
    "live_points", "live_logl", "live_logp", "dead_points", "dead_logl",
    "dead_logp", "dead_acc", "mean_est", "cov_est", "log_z", "entropy", "log_missing",
)
_AM_FLOATS = ("x", "log_density", "mean", "chol")
_AM_COUNTS = ("step", "accepted", "proposed")


def _float(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype or torch.get_default_dtype())


def problem_data_from_numpy(x, y, *, device=None, dtype: Optional[torch.dtype] = None):
    """(x [n, d], y [n]) as float tensors on ``device`` (default: the card)."""
    device = resolve_device(device)
    return _float(x, device, dtype), _float(y, device, dtype)


def _decode_evals(counter) -> int:
    c = np.asarray(counter)
    if c.shape == (2,):
        return int(c[0]) * _EVAL_BASE + int(c[1])
    return int(c)


def ns_state_from_numpy(arrays: dict, *, device=None, dtype: Optional[torch.dtype] = None) -> NSState:
    """An :class:`NSState` from the fields of the JAX package's ``NSState``
    (``key`` is ignored; the (hi, lo) eval counter becomes one int64), on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    fields = {name: _float(arrays[name], device, dtype) for name in _NS_TENSORS}
    return NSState(
        **fields,
        n_dead=int(np.asarray(arrays["n_dead"])),
        iteration=int(np.asarray(arrays["iteration"])),
        num_likelihood_evals=torch.tensor(
            _decode_evals(arrays["num_likelihood_evals"]), dtype=torch.int64, device=device
        ),
        interrupted=bool(np.asarray(arrays.get("interrupted", False))),
    )


def ns_state_to_numpy(state: NSState) -> dict:
    """The reverse of :func:`ns_state_from_numpy`, with the eval counter as
    the JAX package's (hi, lo) int32 pair."""
    out = {name: getattr(state, name).detach().cpu().numpy() for name in _NS_TENSORS}
    evals = int(state.num_likelihood_evals)
    out["num_likelihood_evals"] = np.asarray(divmod(evals, _EVAL_BASE), np.int32)
    out["n_dead"] = np.asarray(state.n_dead, np.int32)
    out["iteration"] = np.asarray(state.iteration, np.int32)
    out["interrupted"] = np.asarray(state.interrupted)
    return out


def am_state_from_numpy(arrays: dict, *, device=None, dtype: Optional[torch.dtype] = None) -> AMState:
    """An :class:`AMState` of C chains from the fields of the JAX package's
    ``AMState`` vmapped over chains ([C, d], [C], [C, d, d], ...); a single
    chain's fields ([d], scalars, [d, d]) become a batch of one.  On
    ``device`` (default: the card)."""
    device = resolve_device(device)
    x = np.asarray(arrays["x"])
    single = x.ndim == 1
    fix = (lambda a: np.asarray(a)[None]) if single else np.asarray
    floats = {name: _float(fix(arrays[name]), device, dtype) for name in _AM_FLOATS}
    counts = {
        name: torch.as_tensor(np.array(fix(arrays[name])), device=device).to(torch.int64) for name in _AM_COUNTS
    }
    return AMState(**floats, **counts)


def am_state_to_numpy(state: AMState) -> dict:
    """The fields of an :class:`AMState` as numpy arrays (leading chain axis)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in AMState._fields}


def slice_state_from_numpy(arrays: dict, *, device=None, dtype: Optional[torch.dtype] = None) -> SliceState:
    """A :class:`SliceState` of C chains from the fields of the JAX package's
    ``SliceState`` vmapped over chains; a single chain's fields become a
    batch of one.  On ``device`` (default: the card)."""
    device = resolve_device(device)
    fix = (lambda a: np.asarray(a)[None]) if np.asarray(arrays["x"]).ndim == 1 else np.asarray
    count = lambda a: torch.as_tensor(np.array(fix(a)), device=device).to(torch.int64)  # noqa: E731
    return SliceState(
        x=_float(fix(arrays["x"]), device, dtype),
        log_density=_float(fix(arrays["log_density"]), device, dtype),
        evals=count(arrays["evals"]),
        moved=count(arrays["moved"]),
    )


def slice_state_to_numpy(state: SliceState) -> dict:
    """The fields of a :class:`SliceState` as numpy arrays (leading chain axis)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in SliceState._fields}


def chmc_state_to_numpy(state: CHMCState) -> dict:
    """The fields of a :class:`CHMCState` as numpy arrays (leading chain axis)."""
    return {name: getattr(state, name).detach().cpu().numpy() for name in CHMCState._fields}


_SEGMENT_ARRAYS = ("points", "log_likelihoods", "log_priors")
_SEGMENT_INTS = ("n_live", "num_delete", "n_dead", "num_likelihood_evals")


def ns_segment_from_numpy(fields: dict) -> NSSegment:
    """An :class:`NSSegment` from the fields of the JAX package's
    ``NSSegment`` (a segment lives on the host in both packages)."""
    return NSSegment(
        **{name: np.asarray(fields[name]) for name in _SEGMENT_ARRAYS},
        **{name: int(fields[name]) for name in _SEGMENT_INTS if name in fields},
        constraint_logl=float(fields["constraint_logl"]),
    )


def _params_from(fields, names, device, dtype: Optional[torch.dtype]) -> dict:
    """Named fields of a dict or an object as tensors on ``device`` (default:
    the card) in ``dtype`` (default: each array's own float dtype)."""
    device = resolve_device(device)
    out = {}
    for name in names:
        t = torch.as_tensor(np.array(fields[name] if isinstance(fields, dict) else getattr(fields, name)),
                            device=device)
        out[name] = t.to(dtype or (t.dtype if t.is_floating_point() else torch.get_default_dtype()))
    return out


def blr_parameters_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> BLRParameters:
    """A :class:`~.engines.conjugate.BLRParameters` from the JAX package's
    ``BLRParameters`` (``b``, ``lam``, ``lam_inv``, ``v``, ``nu``): a prior
    or posterior of its Bayesian linear regression, to seed the port's."""
    return BLRParameters(**_params_from(fields, ("b", "lam", "lam_inv", "v", "nu"), device, dtype))


def normal_inverse_gamma_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> NormalInverseGamma:
    """A :class:`~.dists.conjugate_structs.NormalInverseGamma` from the JAX
    package's (``mu0``, ``lam``, ``beta``, ``nu``)."""
    return NormalInverseGamma(**_params_from(fields, ("mu0", "lam", "beta", "nu"), device, dtype))


def normal_inverse_wishart_from_numpy(fields, *, device=None,
                                      dtype: Optional[torch.dtype] = None) -> NormalInverseWishart:
    """A :class:`~.dists.conjugate_structs.NormalInverseWishart` from the
    JAX package's (``mu0``, ``lam``, ``psi``, ``nu``)."""
    return NormalInverseWishart(**_params_from(fields, ("mu0", "lam", "psi", "nu"), device, dtype))


def gp_classifier_optimization_from_numpy(fields, *, device=None,
                                          dtype: Optional[torch.dtype] = None) -> GPClassifierOptimization:
    """A :class:`~.engines.gp_classify.GPClassifierOptimization` from the JAX
    package's (``theta``, ``log_marginal``, ``trace``)."""
    return GPClassifierOptimization(**_params_from(fields, ("theta", "log_marginal", "trace"), device, dtype))


def sgpr_optimization_from_numpy(fields, problem) -> SGPROptimization:
    """A :class:`~.engines.sparse_gp.SGPROptimization` from the JAX
    package's (``theta``, ``z``, ``bound``, ``bound_trace``), on the device
    and in the dtype of ``problem``, the port's problem of the same data
    (built by ``define_sparse_gaussian_process``); its ``problem`` is that
    one with its bound at the optimized ``z``."""
    out = _params_from(fields, ("theta", "z", "bound", "bound_trace"), problem.device, problem.dtype)
    return SGPROptimization(**out, problem=with_inducing(problem, out["z"]))


def coregional_parameters_from_numpy(a, d=None, *, device=None, dtype: Optional[torch.dtype] = None):
    """The multi-output GP's coregionalization parameters (``a`` [T, r] or
    [T], ``d`` [T] or None) as tensors for ``ops.mogp.coregional_matrix``."""
    out = _params_from({"a": a, **({} if d is None else {"d": d})}, ("a",) + (() if d is None else ("d",)),
                       device, dtype)
    return out["a"], out.get("d")


def _field(fields, name):
    return fields[name] if isinstance(fields, dict) else getattr(fields, name)


def svgp_variational_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> SVGPVariational:
    """An :class:`~.ops.svgp.SVGPVariational` from the JAX package's
    (``m``, ``raw_scale``)."""
    return SVGPVariational(**_params_from(fields, ("m", "raw_scale"), device, dtype))


def _jitter(fields):
    j = fields.get("jitter") if isinstance(fields, dict) else getattr(fields, "jitter", None)
    return None if j is None else float(j)


def svgp_fit_from_numpy(fields, kernel_builder, likelihood="bernoulli_logit", *, device=None,
                        dtype: Optional[torch.dtype] = None) -> SVGPFit:
    """An :class:`~.engines.svgp.SVGPFit` from the JAX package's fit: its
    (``theta``, ``z``, ``variational``, ``elbo``, ``elbo_trace``), with the
    port's ``kernel_builder`` and likelihood (a name or a port
    ``LatentLikelihood``)."""
    out = _params_from(fields, ("theta", "z", "elbo", "elbo_trace"), device, dtype)
    var = svgp_variational_from_numpy(_field(fields, "variational"), device=device, dtype=dtype)
    lik = _NAMED_LIKELIHOODS[likelihood]() if isinstance(likelihood, str) else likelihood
    return SVGPFit(**out, variational=var, kernel_builder=kernel_builder, likelihood=lik, jitter=_jitter(fields))


def svgp_multiclass_fit_from_numpy(fields, kernel_builder, *, device=None,
                                   dtype: Optional[torch.dtype] = None) -> SVGPMulticlassFit:
    """An :class:`~.engines.svgp.SVGPMulticlassFit` from the JAX package's
    (``theta``, ``z``, ``m``, ``raw_scale``, ``elbo``, ``elbo_trace``,
    ``num_classes``)."""
    out = _params_from(fields, ("theta", "z", "m", "raw_scale", "elbo", "elbo_trace"), device, dtype)
    return SVGPMulticlassFit(**out, num_classes=int(_field(fields, "num_classes")), kernel_builder=kernel_builder,
                             jitter=_jitter(fields))


def svgp_hetero_fit_from_numpy(fields, mean_kernel_builder, noise_kernel_builder, *, device=None,
                               dtype: Optional[torch.dtype] = None) -> SVGPHeteroFit:
    """An :class:`~.engines.svgp.SVGPHeteroFit` from the JAX package's
    (``theta``, ``z``, ``var_f``, ``var_g``, ``noise_bias``, ``elbo``,
    ``elbo_trace``)."""
    out = _params_from(fields, ("theta", "z", "noise_bias", "elbo", "elbo_trace"), device, dtype)
    var = {k: svgp_variational_from_numpy(_field(fields, k), device=device, dtype=dtype) for k in ("var_f", "var_g")}
    return SVGPHeteroFit(**out, **var, mean_kernel_builder=mean_kernel_builder,
                         noise_kernel_builder=noise_kernel_builder, jitter=_jitter(fields))


_BO_FLOATS = ("x", "y", "log_var", "log_ell", "log_nugget", "lower", "upper")


def bayes_opt_state_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> BayesOptState:
    """A :class:`~.engines.bayesopt.BayesOptState` from the JAX package's
    state (its capacity-padded ``x``, ``y``, ``mask``, the count ``n``, the
    surrogate's hyperparameters and the box)."""
    out = _params_from(fields, _BO_FLOATS, device, dtype)
    mask = torch.as_tensor(np.array(_field(fields, "mask")), device=out["x"].device).to(torch.bool)
    return BayesOptState(**out, mask=mask, n=int(_field(fields, "n")))


def bayes_opt_state_to_numpy(state: BayesOptState) -> dict:
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _BO_FLOATS}
    return {**out, "mask": state.mask.cpu().numpy(), "n": state.n}


def _names(fields) -> tuple:
    return tuple(fields.get("param_names", ()) if isinstance(fields, dict) else getattr(fields, "param_names", ()))


def vi_result_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> VIResult:
    """A :class:`~.engines.vi.VIResult` from the JAX package's fit (``loc``,
    ``scale_tril``, ``elbo``, ``elbo_history``, ``lower``, ``upper``,
    ``param_names``, ``family``)."""
    out = _params_from(fields, ("loc", "scale_tril", "elbo", "elbo_history", "lower", "upper"), device, dtype)
    return VIResult(**out, param_names=_names(fields), family=str(_field(fields, "family")))


def pathfinder_result_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> PathfinderResult:
    """A :class:`~.engines.pathfinder.PathfinderResult` from the JAX
    package's (its pooled ``samples``, a ``WeightedSamples`` or a dict of
    ``points`` and ``log_weights``; ``elbo_per_path``, ``best_iteration``,
    ``log_evidence_is``, ``pareto_k``, ``path_loc``, ``lower``, ``upper``,
    ``param_names``)."""
    out = _params_from(fields, ("elbo_per_path", "log_evidence_is", "pareto_k", "path_loc", "lower", "upper"),
                       device, dtype)
    pool = _params_from(_field(fields, "samples"), ("points", "log_weights"), device, dtype)
    best = torch.as_tensor(np.array(_field(fields, "best_iteration")), device=out["lower"].device)
    return PathfinderResult(samples=WeightedSamples(**pool), best_iteration=best, **out,
                            param_names=_names(fields))


def _distribution_from(obj, device, dtype: Optional[torch.dtype]):
    """The port's family of ``obj``'s class name, its fields read from
    ``obj`` by name (a dict needs ``family`` beside the fields)."""
    name = obj["family"] if isinstance(obj, dict) else type(obj).__name__
    cls = getattr(dists, name, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise ValueError(f"no port family named {name!r}")
    names = [f.name for f in dataclasses.fields(cls)]
    return cls(**_params_from(obj, names, device, dtype))


def mixture_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> dists.Mixture:
    """A :class:`~.dists.combinators.Mixture` from the JAX package's
    (``log_weights`` [S] and a ``component`` with [S, ...] parameters)."""
    lw = _params_from(fields, ("log_weights",), device, dtype)["log_weights"]
    return dists.Mixture(log_weights=lw, component=_distribution_from(_field(fields, "component"), device, dtype))


def pointwise_mixture_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> dists.PointwiseMixture:
    """A :class:`~.dists.pointwise.PointwiseMixture` from the JAX package's
    (``log_weights`` [S] and a ``component`` with [S, m, ...] parameters)."""
    lw = _params_from(fields, ("log_weights",), device, dtype)["log_weights"]
    return dists.PointwiseMixture(log_weights=lw,
                                  component=_distribution_from(_field(fields, "component"), device, dtype))


def gaussian_kde_from_numpy(fields, *, device=None, dtype: Optional[torch.dtype] = None) -> dists.GaussianKDE:
    """A :class:`~.dists.empirical.GaussianKDE` from the JAX package's
    (``points`` [n, d], ``log_weights`` [n], ``bandwidth`` [d])."""
    return dists.GaussianKDE(**_params_from(fields, ("points", "log_weights", "bandwidth"), device, dtype))
