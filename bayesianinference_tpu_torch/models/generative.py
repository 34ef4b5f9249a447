"""Generative-model front end (port of
``bayesianinference_tpu.models.generative``): a
:class:`~..dists.combinators.ConditionalProduct` plus observed data
becomes an :class:`~.problem.InferenceProblem`.

The model's observed variables are named in ``data``, its independent
variables (regression inputs) in ``inputs``, and every other node is a
free parameter packed into the flat theta vector.  The model graph is
validated as ``laplacePosteriorFit`` validates it (LaplaceApproximation.wl:
485-504): acyclic, inputs without parents, parameters not depending on
observed variables.  The densities are per point (theta [d] -> scalar),
batched by the problem with ``torch.func.vmap`` like any other.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..core.device import resolve_device
from ..dists.combinators import ConditionalProduct
from ..utils.graph import model_graph
from .problem import InferenceProblem

__all__ = ["generative_model_problem"]


def _parse_specs(parameters: Sequence):
    """Each spec: name | (name, lo, hi) | (name, lo, hi, shape)."""
    names, lows, highs, shapes = [], [], [], []
    for p in parameters:
        if isinstance(p, str):
            name, lo, hi, shape = p, -math.inf, math.inf, ()
        elif len(p) == 3:
            (name, lo, hi), shape = p, ()
        elif len(p) == 4:
            name, lo, hi, shape = p
            shape = tuple(int(s) for s in torch.atleast_1d(torch.as_tensor(shape)))
        else:
            raise ValueError(f"bad parameter spec: {p!r}")
        names.append(str(name))
        lows.append(float(lo))
        highs.append(float(hi))
        shapes.append(shape)
    if len(set(names)) != len(names):
        raise ValueError("duplicate parameter names")
    return names, lows, highs, shapes


def _on_device(values: dict, device) -> dict:
    """Each value as a tensor: a tensor stays where it is, anything else
    goes to ``device``."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device) for k, v in values.items()}


def generative_model_problem(
    model: ConditionalProduct,
    data: dict,
    parameters: Sequence,
    inputs: Optional[dict] = None,
    constraint=None,
    *,
    device=None,
    **problem_metadata,
) -> InferenceProblem:
    """Condition a generative model on observed data.

    * ``model``: a :class:`ConditionalProduct` over named variables.
    * ``data``: observed variables, name -> array.  Each observed node's
      conditional density, summed over the observation axis, enters the
      log-likelihood.
    * ``parameters``: specs of the free variables, ``name``,
      ``(name, lo, hi)`` (scalar) or ``(name, lo, hi, shape)`` (array);
      they pack in order into theta, and their node densities form the
      log-prior.
    * ``inputs``: independent (conditioning-only) variables, such as
      regression features; they enter builders but carry no density.

    The problem lives where the first tensor among ``data`` and
    ``inputs`` lies, with the bounds in the first floating dtype among
    them (PyTorch's default if none); data that are not tensors go to
    ``device``, the card unless it names the CPU."""
    names, lows, highs, shapes = _parse_specs(parameters)
    given = list((data or {}).values()) + list((inputs or {}).values())
    ref = next((v for v in given if isinstance(v, torch.Tensor)), None)
    device = ref.device if ref is not None and device is None else resolve_device(device)
    inputs = _on_device(dict(inputs or {}), device)
    data = _on_device(dict(data), device)
    dtype = next((v.dtype for v in list(data.values()) + list(inputs.values()) if v.is_floating_point()),
                 torch.get_default_dtype())

    node_names = set(model.names)
    for k in data:
        if k not in node_names:
            raise ValueError(f"observed variable {k!r} is not a model node")
    for k in names:
        if k not in node_names:
            raise ValueError(f"parameter {k!r} is not a model node")
    unaccounted = node_names - set(data) - set(names) - set(inputs)
    if unaccounted:
        raise ValueError(
            f"model variables {sorted(unaccounted)} are neither observed, "
            "parameters, nor inputs (marginalizing latents is not supported "
            "here; reference behavior LA:466-477 treats them as parameters)"
        )
    overlap = set(data) & set(names)
    if overlap:
        raise ValueError(f"{sorted(overlap)} marked both observed and free")

    # structural validation (modelGraph + the checks of LA:485-504)
    graph = model_graph(model.graph(), inputs=tuple(inputs), outputs=tuple(data), extra_vertices=tuple(model.names))
    graph.validate_dependencies()

    # theta packing: a flat [dim] vector in spec order
    sizes = [math.prod(s) if s else 1 for s in shapes]
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    on = dict(dtype=dtype, device=device)
    lower = torch.cat([torch.full((s,), lo, **on) for s, lo in zip(sizes, lows)])
    upper = torch.cat([torch.full((s,), hi, **on) for s, hi in zip(sizes, highs)])
    flat_names = []
    for nm, shape, s in zip(names, shapes, sizes):
        flat_names.extend([nm] if not shape else [f"{nm}[{i}]" for i in range(s)])

    def unpack(theta):
        out = {}
        for nm, shape, o, s in zip(names, shapes, offsets, sizes):
            block = theta[..., o: o + s]
            out[nm] = block[..., 0] if not shape else block.reshape(theta.shape[:-1] + shape)
        return out

    def log_likelihood(theta):
        params = unpack(theta)
        known = dict(inputs)
        total = torch.zeros((), dtype=theta.dtype, device=theta.device)
        for name, builder in model.nodes:
            if name in inputs:  # conditioning-only: value given, density ignored
                continue
            if name in data:
                dist = builder(known) if callable(builder) else builder
                total = total + torch.sum(dist.log_prob(data[name]))
                known[name] = data[name]
            else:  # a parameter node: its density belongs to the prior
                known[name] = params[name]
        return total

    def log_prior(theta):
        params = unpack(theta)
        known = dict(inputs)
        total = torch.zeros((), dtype=theta.dtype, device=theta.device)
        for name, builder in model.nodes:
            if name in inputs:
                continue
            if name in data:
                known[name] = data[name]
                continue
            dist = builder(known) if callable(builder) else builder
            total = total + torch.sum(dist.log_prob(params[name]))
            known[name] = params[name]
        return total

    return InferenceProblem(
        lower=lower,
        upper=upper,
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        param_names=tuple(flat_names),
        constraint=constraint,
        metadata=dict(generative_model=model, model_graph=graph, **problem_metadata),
    )
