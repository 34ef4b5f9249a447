"""A problem carried whole to another device.

A run that splits its batch over devices evaluates each device's part
against that device's copy of the problem (:func:`problem_on`): its box,
its data, its prior and its likelihood's model go with it.  What cannot go
(a density that closes over another device's tensors) raises and names
itself (:func:`check_movable`); nothing is evaluated on the problem's own
device behind the caller's back."""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.shards import canonical_device
from ..dists.base import tensor_leaves, with_leaves
from .problem import InferenceProblem, _tree_map

__all__ = ["check_movable", "problem_on"]


def _cell(c):
    try:
        return c.cell_contents
    except ValueError:  # a cell not yet filled
        return None


def _stray_tensors(obj, device, where: str, seen: set):
    """(path, tensor) of the tensors that ``obj`` (a callable, or what one
    holds) reaches through closures, defaults, module tensors read by name,
    bound instances, partials, dataclass fields and containers, and that
    cannot be used beside
    tensors on ``device``: any not on it but a 0-d CPU tensor."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        if obj.device != device and not (obj.device.type == "cpu" and obj.dim() == 0):
            yield where, obj
        return
    if isinstance(obj, functools.partial):
        kids = [("func", obj.func)] + [(f"arg{i}", a) for i, a in enumerate(obj.args)] + list(obj.keywords.items())
    elif hasattr(obj, "__func__") and hasattr(obj, "__self__"):  # a bound method
        kids = [("self", obj.__self__), ("func", obj.__func__)]
    elif hasattr(obj, "__code__"):  # a Python function
        cells = zip(obj.__code__.co_freevars, obj.__closure__ or ())
        kids = [(n, _cell(c)) for n, c in cells]
        kids += [(f"default{i}", v) for i, v in enumerate(obj.__defaults__ or ())]
        kids += list((obj.__kwdefaults__ or {}).items())
        kids += [(n, obj.__globals__[n]) for n in obj.__code__.co_names
                 if isinstance(obj.__globals__.get(n), torch.Tensor)]  # a module's tensors it reads by name
        where = f"{where} ({obj.__qualname__})"
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kids = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        kids = list(enumerate(obj))
    elif isinstance(obj, dict):
        kids = list(obj.items())
    else:
        return
    for name, kid in kids:
        yield from _stray_tensors(kid, device, f"{where}.{name}", seen)


def _moved(obj, device, memo: dict):
    """``obj`` with its tensor fields on ``device``: a tensor, a
    distribution or other dataclass (by its tensor leaves), or a method
    bound to such a dataclass (rebound to the moved instance); anything
    else is returned as it is.  ``memo`` keeps one moved copy per object."""
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = with_leaves(obj, {p: t.to(device) for p, t in tensor_leaves(obj)})
    elif hasattr(obj, "__func__") and dataclasses.is_dataclass(getattr(obj, "__self__", None)):
        out = getattr(_moved(obj.__self__, device, memo), obj.__func__.__name__)
    elif isinstance(obj, functools.partial):
        out = functools.partial(obj.func, *(_moved(a, device, memo) for a in obj.args),
                                **{k: _moved(v, device, memo) for k, v in obj.keywords.items()})
    else:
        out = obj
    memo[id(obj)] = out
    return out


def problem_on(problem: InferenceProblem, device) -> InferenceProblem:
    """``problem`` carried whole to ``device``: its box, its data, its prior
    distribution (and a log prior that is that distribution's density),
    its metadata's models, and a likelihood that is a method of a model
    holding tensors (a GP problem's ``GPModel.log_marginal_likelihood``,
    rebound to the model with ``x`` and ``y`` moved; ``metadata
    ["gaussian_process"]`` is that same moved model).  A density that
    closes over another device's tensors cannot move: that raises and names
    it, rather than evaluating on the problem's device behind the caller's
    back."""
    device = canonical_device(device)
    if problem.device == device:
        return problem
    memo = {}
    move = functools.partial(_moved, device=device, memo=memo)
    metadata = None if problem.metadata is None else {k: move(v) for k, v in problem.metadata.items()}
    moved = dataclasses.replace(
        problem, lower=problem.lower.to(device), upper=problem.upper.to(device), metadata=metadata,
        prior_distribution=move(problem.prior_distribution), log_prior=move(problem.log_prior),
        log_likelihood=move(problem.log_likelihood), data=None if problem.data is None else _tree_map(
            lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, problem.data))
    for name in ("log_likelihood", "log_prior", "constraint"):
        check_movable(getattr(moved, name), device, f"the problem's {name}")
    return moved


def check_movable(fn, device, name: str) -> None:
    """Raise, naming it, if ``fn`` reaches a tensor that cannot be used
    beside tensors on ``device`` (see :func:`_stray_tensors`)."""
    placed = torch.empty((0,), device=device).device  # "cpu:0" places tensors on "cpu"
    for where, t in _stray_tensors(fn, placed, name, set()):
        raise ValueError(
            f"{where} holds a tensor of shape {tuple(t.shape)} on {t.device}, which cannot move to {device}: pass it "
            "as data (define_inference_problem(data=)) or build the problem on each device")
