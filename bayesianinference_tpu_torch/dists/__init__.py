"""Distributions of the nested-sampling, GP, Laplace and conjugate paths."""

from .base import Distribution
from .combinators import ConditionalProduct, ImproperUniform, Product, Truncated
from .conjugate_structs import NormalInverseGamma, NormalInverseWishart
from .empirical import Empirical, ParameterMixture
from .multivariate import (
    Dirichlet,
    InverseWishart,
    MatrixNormal,
    MatrixT,
    Multinomial,
    MultivariateNormal,
    MultivariateNormalPrecision,
    MultivariateT,
    Wishart,
    mvgammaln,
)
from .pointwise import PointwiseMixture
from .scalar import (
    Bernoulli,
    BernoulliLogits,
    Beta,
    Categorical,
    Cauchy,
    Gamma,
    InverseGamma,
    LogNormal,
    LogUniform,
    Normal,
    StudentT,
    Uniform,
)
