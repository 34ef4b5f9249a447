"""Distributions of the nested-sampling, GP and Laplace paths."""

from .base import Distribution
from .combinators import ImproperUniform, Product, Truncated
from .empirical import Empirical, ParameterMixture
from .multivariate import MultivariateNormal, MultivariateNormalPrecision, MultivariateT, mvgammaln
from .pointwise import PointwiseMixture
from .scalar import Bernoulli, BernoulliLogits, Cauchy, LogNormal, LogUniform, Normal, Uniform
