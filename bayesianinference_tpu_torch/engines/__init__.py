"""Inference engines: nested sampling, evidence resampling, GP regression."""
