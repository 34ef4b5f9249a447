"""Problem definition, the generative-model front end and Laplace-marginalized latents."""

from .generative import generative_model_problem
from .marginalize import LaplaceMarginal, marginalize_latents
from .problem import (
    InferenceProblem,
    ParamSpec,
    define_inference_problem,
    ignorance_prior,
    iid_likelihood,
    random_domain_points,
    regression_likelihood,
    validate_problem,
)
