"""Data standardization with invertible transforms (port of
``bayesianinference_tpu.core.standardize``): center and scale the inputs
and outputs of a regression problem and keep the forward and inverse
transforms with it, so predictions map back to the original units."""

from __future__ import annotations

import dataclasses

import torch

from .numerics import as_float

__all__ = ["Standardizer", "standardize", "NormalizedData", "normalize_data", "data_normal_form"]


@dataclasses.dataclass(frozen=True)
class Standardizer:
    mean: torch.Tensor  # [d]
    scale: torch.Tensor  # [d]

    def __call__(self, x):
        return (as_float(x) - self.mean) / self.scale

    def inverse(self, z):
        return as_float(z) * self.scale + self.mean

    def scale_only(self, x):
        """Scale without centering (for standard deviations)."""
        return as_float(x) / self.scale

    def inverse_scale_only(self, z):
        return as_float(z) * self.scale


def standardize(data) -> tuple[torch.Tensor, Standardizer]:
    """Fit a standardizer to ``data`` [n, d] (population standard
    deviation; a constant column keeps scale 1) and return
    (transformed, tf)."""
    data = torch.atleast_2d(as_float(data))
    mean = data.mean(dim=0)
    scale = data.std(dim=0, correction=0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    tf = Standardizer(mean=mean, scale=scale)
    return tf(data), tf


@dataclasses.dataclass(frozen=True)
class NormalizedData:
    """Standardized regression data with its transforms."""

    x: torch.Tensor  # [n, d_in]  (standardized)
    y: torch.Tensor  # [n, d_out] (standardized)
    x_tf: Standardizer
    y_tf: Standardizer


def normalize_data(x, y) -> NormalizedData:
    """Standardize regression data, keeping the transforms with it."""
    xs, x_tf = standardize(data_normal_form(x))
    ys, y_tf = standardize(data_normal_form(y))
    return NormalizedData(x=xs, y=ys, x_tf=x_tf, y_tf=y_tf)


def data_normal_form(data) -> torch.Tensor:
    """Data as a 2-D tensor ([n] -> [n, 1])."""
    arr = as_float(data)
    return arr[:, None] if arr.dim() == 1 else arr
