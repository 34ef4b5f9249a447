"""Distributions of the nested-sampling and GP path."""

from .base import Distribution
from .combinators import ImproperUniform, Product, Truncated
from .empirical import Empirical
from .pointwise import PointwiseMixture
from .scalar import Cauchy, LogUniform, Normal, Uniform
