"""Problem definition."""

from .problem import (
    InferenceProblem,
    ParamSpec,
    define_inference_problem,
    ignorance_prior,
    random_domain_points,
    validate_problem,
)
