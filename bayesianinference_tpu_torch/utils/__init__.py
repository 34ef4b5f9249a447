"""Utilities: model dependency graphs, the options dataclasses, function
checks and profiling."""

from .config import EvidenceOptions, MCMCOptions, NestedSamplingOptions
from .graph import ModelGraph, dependency_data, model_graph
from .profiling import timed, trace
from .validation import check_traceable, distribution_dimension

__all__ = [
    "timed",
    "trace",
    "EvidenceOptions",
    "MCMCOptions",
    "NestedSamplingOptions",
    "ModelGraph",
    "dependency_data",
    "model_graph",
    "check_traceable",
    "distribution_dimension",
]
