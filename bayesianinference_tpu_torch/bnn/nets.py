"""Quasi-Bayesian regression networks (MC dropout); port of
``bayesianinference_tpu.bnn.nets``.

The reference's ``regressionNet`` (NN:58-119): an MLP of ``depth`` x
(Linear -> [BatchNorm] -> SELU -> Dropout) blocks with either a
heteroscedastic 2-output head (mean, log-precision) or a homoscedastic
1-output head plus a learned constant log-precision (NN:104-117).

Dropout stays active at prediction time, and its masks are an input: a
list of one ``[..., n, width]`` tensor per block holding keep / (1 - p)
(:meth:`RegressionNet.draw_masks` draws them from a generator).  Without
masks the pass is deterministic and batch normalization uses its running
averages; with masks it uses the batch statistics.  Masks with a leading
``k`` axis run ``k`` stochastic passes as one batched pass (the JAX
package's ``vmap`` over keys), and batch statistics then reduce over each
pass's own ``n`` examples.

The module holds only the architecture.  Parameters are a state dict
passed to every call (``RegressionNet.init`` makes a fresh one, as flax's
``init`` does).  Batch normalization is written out to keep flax's conventions: the
biased batch variance E[x^2] - E[x]^2, and running averages
``0.99 ra + 0.01 batch`` (``torch.nn.BatchNorm1d`` weighs the other way
and keeps the unbiased variance).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import torch

__all__ = ["RegressionNet", "regression_net", "selu"]

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946
BN_MOMENTUM, BN_EPSILON = 0.99, 1e-5  # flax.linen.BatchNorm's defaults
# lecun_normal: a normal truncated at two standard deviations, rescaled to
# unit variance (jax.nn.initializers.variance_scaling's constant)
_TRUNC_STD = 0.87962566103423978


def selu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.selu``: scale * (x if x > 0 else alpha * expm1(x))."""
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(torch.where(x > 0, 0.0, x)))


def _promote(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` in the promoted dtype of ``t`` and ``x`` (flax's ``promote_dtype``)."""
    return t.to(torch.promote_types(t.dtype, x.dtype))


class RegressionNet(torch.nn.Module):
    """MLP regression net with (mean, log-precision) output.

    ``error_model``: ``"HeteroScedastic"`` (2 network outputs) or
    ``"HomoScedastic"`` (1 network output and a learned constant
    log-precision, NN:102-119)."""

    def __init__(self, depth: int = 4, layer_size: Union[int, Sequence[int]] = 100, activation: Callable = selu,
                 dropout_probability: float = 0.25, batch_normalization: bool = False,
                 error_model: str = "HeteroScedastic"):
        super().__init__()
        if error_model not in ("HeteroScedastic", "HomoScedastic"):
            raise ValueError(f"unknown error_model {error_model!r}")
        self.depth = int(depth)
        self.layer_size = layer_size
        self.activation = activation
        self.dropout_probability = float(dropout_probability)
        self.batch_normalization = bool(batch_normalization)
        self.error_model = error_model

    @property
    def widths(self) -> List[int]:
        """The hidden widths, one per block."""
        if isinstance(self.layer_size, (tuple, list)):
            return [int(s) for s in self.layer_size[: self.depth]]
        return [int(self.layer_size)] * self.depth

    def init(self, generator: Optional[torch.Generator], x) -> dict:
        """A fresh state dict for inputs like ``x`` [n, features] (its dtype
        and device): weights [out, in] by lecun normal (truncated at 2 sd),
        zero biases, batch-norm scale 1 and bias 0, running mean 0 and
        variance 1, log-precision 0.  ``generator`` None is one seeded 0 on
        ``x``'s device."""
        x = torch.atleast_2d(torch.as_tensor(x))
        dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
        dev = x.device
        generator = torch.Generator(device=dev).manual_seed(0) if generator is None else generator

        def lecun(fan_in, fan_out):
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty((fan_out, fan_in), dtype=dtype, device=dev)
            return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

        state, fan_in = {}, x.shape[-1]
        for i, width in enumerate(self.widths):
            state[f"dense{i}_weight"] = lecun(fan_in, width)
            state[f"dense{i}_bias"] = torch.zeros((width,), dtype=dtype, device=dev)
            if self.batch_normalization:
                state[f"norm{i}_weight"] = torch.ones((width,), dtype=dtype, device=dev)
                state[f"norm{i}_bias"] = torch.zeros((width,), dtype=dtype, device=dev)
                state[f"norm{i}_mean"] = torch.zeros((width,), dtype=dtype, device=dev)
                state[f"norm{i}_var"] = torch.ones((width,), dtype=dtype, device=dev)
            fan_in = width
        outputs = 2 if self.error_model == "HeteroScedastic" else 1
        state["head_weight"] = lecun(fan_in, outputs)
        state["head_bias"] = torch.zeros((outputs,), dtype=dtype, device=dev)
        if self.error_model == "HomoScedastic":
            state["log_precision"] = torch.zeros((1,), dtype=dtype, device=dev)
        return state

    def compute_dtype(self, x, params: dict) -> torch.dtype:
        """The dtype a pass on ``x`` computes in: ``x``'s promoted with the
        parameters'."""
        return torch.promote_types(torch.as_tensor(x).dtype, params["head_weight"].dtype)

    def draw_masks(self, generator: Optional[torch.Generator], n: int, k: Optional[int] = None, *,
                   dtype=torch.float32, device=None) -> List[torch.Tensor]:
        """Dropout masks, one [k, n, width] (or [n, width] for ``k`` None)
        tensor per block, holding 1 / (1 - p) where a unit is kept and 0
        where it is dropped (all ones at p = 0); on ``device`` (default:
        the generator's)."""
        p = self.dropout_probability
        device = device or (generator.device if generator is not None else None)
        lead = () if k is None else (k,)
        masks = []
        for width in self.widths:
            u = torch.rand(lead + (n, width), generator=generator, dtype=dtype, device=device)
            masks.append((u < 1.0 - p).to(dtype) / (1.0 - p))
        return masks

    def forward(self, x, masks: Optional[Sequence[torch.Tensor]] = None, *, params: dict, mutable: bool = False):
        """Outputs [..., n, 2] (mean, log-precision) of the state dict
        ``params``.  ``masks`` None is the deterministic pass.  ``mutable=True`` also returns the batch-norm running averages
        updated by this pass's batch statistics (flax's
        ``mutable=["batch_stats"]``; none in a deterministic pass), with the
        masks' leading axis where they have one."""
        p = params
        x = torch.as_tensor(x)
        x = x.reshape(1, -1) if x.dim() < 2 else x
        x = _promote(x, p["head_weight"])
        deterministic = masks is None
        if masks is not None and len(masks) != self.depth:
            raise ValueError(f"{self.depth} masks expected, got {len(masks)}")
        updates = {}
        h = x
        for i in range(self.depth):
            h = torch.nn.functional.linear(h, _promote(p[f"dense{i}_weight"], h), _promote(p[f"dense{i}_bias"], h))
            if self.batch_normalization:
                if masks is not None and h.dim() < masks[i].dim():
                    h = h.expand(masks[i].shape[:-2] + h.shape[-2:])
                h, stats = self._batch_norm(h, p, i, deterministic)
                if mutable:
                    updates.update(stats)
            h = self.activation(h)
            if masks is not None:
                h = h * masks[i].to(h.dtype)
        out = torch.nn.functional.linear(h, _promote(p["head_weight"], h), _promote(p["head_bias"], h))
        if self.error_model == "HomoScedastic":
            out = torch.cat([out, _promote(p["log_precision"], out).expand(out.shape)], dim=-1)
        return (out, updates) if mutable else out

    def _batch_norm(self, h, p, i, deterministic):
        if deterministic:
            mean, var = p[f"norm{i}_mean"], p[f"norm{i}_var"]
            stats = {}
        else:
            mean = h.mean(dim=-2)
            var = torch.clamp(torch.mean(h * h, dim=-2) - mean * mean, min=0.0)
            stats = {f"norm{i}_mean": BN_MOMENTUM * p[f"norm{i}_mean"] + (1 - BN_MOMENTUM) * mean,
                     f"norm{i}_var": BN_MOMENTUM * p[f"norm{i}_var"] + (1 - BN_MOMENTUM) * var}
        mul = torch.rsqrt(_promote(var, h) + BN_EPSILON).unsqueeze(-2) * _promote(p[f"norm{i}_weight"], h)
        y = (h - _promote(mean, h).unsqueeze(-2)) * mul + _promote(p[f"norm{i}_bias"], h)
        return y, stats


def regression_net(
    error_model: str = "HeteroScedastic",
    *,
    depth: int = 4,
    layer_size: Union[int, Sequence[int]] = 100,
    activation: Callable = selu,
    dropout_probability: float = 0.25,
    batch_normalization: bool = False,
) -> RegressionNet:
    """A :class:`RegressionNet` with ``regressionNet``'s options (NN:58-64);
    :meth:`RegressionNet.init` makes its parameters."""
    return RegressionNet(depth=depth, layer_size=layer_size, activation=activation,
                         dropout_probability=dropout_probability, batch_normalization=batch_normalization,
                         error_model=error_model)
