"""Utilities: model dependency graphs."""

from .graph import ModelGraph, dependency_data, model_graph
