"""Problem definition."""

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
