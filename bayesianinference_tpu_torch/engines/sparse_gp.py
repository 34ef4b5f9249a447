"""Sparse (inducing-point) Gaussian-process regression (port of
``bayesianinference_tpu.engines.sparse_gp``).

The ``define_gaussian_process`` surface with the dense logML swapped for
the collapsed Titsias bound (:mod:`..ops.sgpr`), so n is limited by O(n m)
memory rather than an n x n factorization; the attached :class:`SGPRModel`
is a duck type of :class:`.gp.GPModel`, so
``predict_from_gaussian_process`` works on it unchanged.

With ``mesh=`` (the port's :class:`~..parallel.sharding.Mesh`) the bound
shards the data axis: each shard builds its ``K_uf`` block with one call of
the SE op on its device and its ([m, m], [m], scalar) statistics, and one
sum over the shards (the ``psum``) feeds the m x m finish on the mesh's
first device.

Not ported: the ``jax.jit``/``lax.scan`` form of the Adam loop (a host
loop over eager steps here, with optax's update from
:mod:`..core.optim`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.device import as_float_on
from ..core.numerics import as_float
from ..core.optim import adam_init, adam_step
from ..core.standardize import NormalizedData, normalize_data
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.sgpr import sgpr_data_stats, sgpr_kuu_inv_chol, sgpr_predict, sgpr_state, sgpr_state_from_stats

__all__ = [
    "SGPRModel",
    "SGPROptimization",
    "define_sparse_gaussian_process",
    "optimize_sparse_gp",
    "select_inducing_points",
]


def select_inducing_points(x, m: int, method: str = "farthest", generator: Optional[torch.Generator] = None):
    """Pick ``m`` inducing inputs from the training inputs.

    ``"farthest"`` (default): greedy k-center, starting at the point
    nearest the data mean and adding the point farthest from the chosen
    set (the JAX package's ``lax.scan``: the same indices).  ``"random"``:
    a uniform subset without replacement drawn by ``generator`` (default:
    one on x's device seeded 0)."""
    x = torch.atleast_2d(as_float(x))
    n = x.shape[0]
    if m >= n:
        return x
    if method == "random":
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        idx = torch.randperm(n, generator=generator, device=generator.device)[:m].to(x.device)
        return x[idx]
    if method != "farthest":
        raise ValueError(f"unknown inducing selection method {method!r}")
    first = torch.argmin(torch.sum((x - x.mean(dim=0)) ** 2, dim=-1))
    chosen = [first]
    min_d = torch.sum((x - x[first]) ** 2, dim=-1)
    for _ in range(m - 1):
        nxt = torch.argmax(min_d)
        min_d = torch.minimum(min_d, torch.sum((x - x[nxt]) ** 2, dim=-1))
        chosen.append(nxt)
    return x[torch.stack(chosen)]


@dataclasses.dataclass(frozen=True)
class SGPRModel:
    """Model functions attached to a sparse-GP problem (a duck type of
    :class:`.gp.GPModel`).  ``nugget_builder(theta)`` must return the
    SCALAR observation-noise variance sigma^2."""

    x: torch.Tensor  # [n, d]
    y: torch.Tensor  # [n]
    z: torch.Tensor  # [m, d] inducing inputs (fixed)
    kernel_builder: Callable
    nugget_builder: Callable
    mean_builder: Optional[Callable] = None
    jitter: Optional[float] = None

    def _pieces(self, theta):
        noise = self.nugget_builder(theta)
        if callable(noise) or torch.as_tensor(noise).shape != ():
            raise ValueError(
                "SGPR needs a SCALAR noise variance from nugget_builder "
                "(iid Gaussian likelihood); heteroscedastic nuggets have "
                "no collapsed bound — use the dense GP for those"
            )
        mean_fn = self.mean_builder(theta) if self.mean_builder else None
        return self.kernel_builder(theta), noise, mean_fn

    def log_marginal_likelihood(self, theta) -> torch.Tensor:
        """Collapsed SGPR evidence lower bound (exact at z = x)."""
        kernel, noise, mean_fn = self._pieces(theta)
        return sgpr_state(kernel, self.x, self.y, self.z, noise, mean_fn=mean_fn, jitter=self.jitter).bound

    def posterior_moments(self, theta, x_query, query_nugget: bool = True):
        kernel, noise, mean_fn = self._pieces(theta)
        state = sgpr_state(kernel, self.x, self.y, self.z, noise, mean_fn=mean_fn, jitter=self.jitter)
        return sgpr_predict(kernel, state, self.z, x_query, noise_variance=noise if query_nugget else None,
                            mean_fn=mean_fn)

    def predict_bytes_per_sample(self) -> int:
        """Bytes per mapped posterior sample (the [m, n] whitened
        cross-covariance dominates)."""
        return 12 * self.z.shape[0] * self.x.shape[0]


def _sharded_bound_fn(model: SGPRModel, mesh, axis_name: str) -> Callable:
    """theta -> bound with the data axis sharded over ``mesh``: L^-1 of
    K_uu once, each shard's statistics of its rows (zero-padded, a 0/1
    weight column), one sum over the shards, the m x m finish once."""
    from ..parallel.sharding import axis_blocks, check_mesh, sum_to

    mesh = check_mesh(mesh, "define_sparse_gaussian_process")
    xs, ys, ws = axis_blocks(mesh, axis_name, model.x, model.y)

    def bound(theta):
        kernel, noise, mean_fn = model._pieces(theta)
        linv, ok_l = sgpr_kuu_inv_chol(kernel, model.z, model.jitter)
        stats = []
        for x_s, y_s, w_s in zip(xs, ys, ws):
            dev = x_s.device
            err = y_s - (mean_fn(x_s) if mean_fn is not None else 0.0)
            stats.append(sgpr_data_stats(kernel, linv.to(dev), model.z.to(dev), x_s, err,
                                         torch.as_tensor(noise).to(dev), weights=w_s))
        first = linv.device
        return sgpr_state_from_stats(linv, ok_l, sum_to(stats, first), noise).bound

    return bound


@dataclasses.dataclass(frozen=True)
class SGPROptimization:
    """Result of a type-II maximum-likelihood SGPR fit; ``problem`` is a new
    :class:`InferenceProblem` whose bound closes over the OPTIMIZED
    inducing points."""

    theta: torch.Tensor  # [d] hyperparameters at the optimum
    z: torch.Tensor  # [m, q] optimized inducing inputs
    bound: torch.Tensor  # scalar final collapsed bound
    bound_trace: torch.Tensor  # [steps] bound before each Adam step
    problem: InferenceProblem


def with_inducing(problem: InferenceProblem, z) -> InferenceProblem:
    """``problem`` (built by :func:`define_sparse_gaussian_process`) with its
    bound at the inducing inputs ``z``."""
    model = problem.metadata["gaussian_process"]
    z = torch.as_tensor(z, dtype=model.x.dtype, device=model.x.device)
    new_model = dataclasses.replace(model, z=z)
    mesh_spec = problem.metadata.get("sgpr_mesh")  # a data-sharded bound stays sharded
    new_ll = _sharded_bound_fn(new_model, *mesh_spec) if mesh_spec is not None else new_model.log_marginal_likelihood
    return dataclasses.replace(problem, log_likelihood=new_ll,
                               metadata={**problem.metadata, "gaussian_process": new_model})


def optimize_sparse_gp(
    problem: InferenceProblem,
    *,
    steps: int = 300,
    learning_rate: float = 0.05,
    optimize_inducing: bool = True,
    initial_theta=None,
    include_prior: bool = False,
) -> SGPROptimization:
    """Type-II maximum likelihood for a sparse GP: maximize the collapsed
    bound jointly over the hyperparameters and (by default) the inducing
    inputs with Adam.  The hyperparameters move in the problem's
    unconstrained bijection space; z is a free [m, q] tensor.
    ``include_prior=True`` adds the problem's log prior (MAP-II)."""
    model = (problem.metadata or {}).get("gaussian_process")
    if not isinstance(model, SGPRModel):
        raise ValueError("optimize_sparse_gp needs a problem built by define_sparse_gaussian_process")
    bij = box_bijection(problem.lower, problem.upper)
    if initial_theta is not None:
        u0 = bij.to_z(torch.as_tensor(initial_theta, dtype=model.y.dtype, device=model.y.device))
    else:
        u0 = torch.zeros((problem.dim,), dtype=model.y.dtype, device=model.y.device)  # box midpoint

    def value_and_grad(params):
        with torch.enable_grad():
            u = params["u"].detach().requires_grad_(True)
            z = params["z"].detach().requires_grad_(optimize_inducing)
            theta = bij.to_x(u)
            kernel, noise, mean_fn = model._pieces(theta)
            bound = sgpr_state(kernel, model.x, model.y, z, noise, mean_fn=mean_fn, jitter=model.jitter).bound
            total = bound + problem.log_prior(theta) if include_prior else bound
            wrt = (u, z) if optimize_inducing else (u,)
            grads = torch.autograd.grad(-total, wrt)
        gz = grads[1] if optimize_inducing else torch.zeros_like(params["z"])
        return bound.detach(), {"u": grads[0], "z": gz}

    params = {"u": u0, "z": model.z}
    state, trace = adam_init(params), []
    for _ in range(steps):
        bound, g = value_and_grad(params)
        trace.append(bound)
        params, state = adam_step(params, g, state, learning_rate)
    theta = bij.to_x(params["u"])
    z_opt = params["z"] if optimize_inducing else model.z
    new_problem = with_inducing(problem, z_opt)
    with torch.no_grad():
        final = new_problem.metadata["gaussian_process"].log_marginal_likelihood(theta)
    trace = torch.stack(trace) if trace else torch.zeros((0,), dtype=model.y.dtype, device=model.y.device)
    return SGPROptimization(theta=theta, z=z_opt, bound=final, bound_trace=trace, problem=new_problem)


def define_sparse_gaussian_process(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    nugget_builder: Callable,
    inducing=512,
    inducing_method: str = "farthest",
    inducing_generator: Optional[torch.Generator] = None,
    mean_builder: Optional[Callable] = None,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    normalize: bool = False,
    validate: bool = True,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[float] = None,
    mesh=None,
    axis_name: str = "data",
    device=None,
) -> InferenceProblem:
    """Build the hyperparameter-inference problem for a SPARSE GP: the
    ``define_gaussian_process`` surface with the collapsed Titsias bound.

    ``inducing``: an int m (selected from the training inputs by
    ``inducing_method``) or an explicit [m, d] array.  ``nugget_builder``
    is required (the bound's iid Gaussian noise).  With ``mesh=`` the
    likelihood shards the data axis over ``mesh.shape[axis_name]`` devices
    (one sum of the statistics per evaluation)."""
    x = torch.atleast_2d(as_float_on(x, device))
    y = torch.as_tensor(y, device=x.device, dtype=x.dtype)
    if y.dim() == 2:
        if y.shape[1] != 1:
            raise ValueError(f"only 1-D output supported for GP regression, got {tuple(y.shape)}")
        y = y[:, 0]
    if x.shape[0] != y.shape[0]:
        raise ValueError("input and output data are not of the same length")
    if nugget_builder is None:
        raise ValueError("SGPR requires nugget_builder (noise variance)")
    norm: Optional[NormalizedData] = None
    if normalize:
        norm = normalize_data(x, y[:, None])
        x, y = norm.x, norm.y[:, 0]
    if isinstance(inducing, int):
        z = select_inducing_points(x, inducing, inducing_method, inducing_generator)
    else:
        z = torch.atleast_2d(torch.as_tensor(inducing, device=x.device, dtype=x.dtype))
        if z.shape[1] != x.shape[1]:
            raise ValueError(f"inducing points have dim {z.shape[1]}, data {x.shape[1]}")
    model = SGPRModel(x=x, y=y, z=z, kernel_builder=kernel_builder, nugget_builder=nugget_builder,
                      mean_builder=mean_builder, jitter=jitter)
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=_sharded_bound_fn(model, mesh, axis_name) if mesh is not None else model.log_marginal_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        generator=generator,
        device=x.device,
        dtype=x.dtype,
        gaussian_process=model,
        data_preprocessors=norm,
        sgpr_mesh=(mesh, axis_name) if mesh is not None else None,
    )
