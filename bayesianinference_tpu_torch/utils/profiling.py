"""Profiling helpers (port of ``bayesianinference_tpu.utils.profiling``):
a ``torch.profiler`` trace of a block, and a wall clock around a block that
waits for the card."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(log_dir: str = "bayesianinference_trace"):
    """Profile a block with ``torch.profiler`` (the CPU, and CUDA where
    there is a card) and write a Chrome trace (``trace.json``, for
    Perfetto or ``chrome://tracing``) into ``log_dir``; yields the file's
    path::

        with profiling.trace("traces") as path:
            nested_sampling(problem, generator, ...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _on_card(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_on_card(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return any(_on_card(v) for v in obj)
    return False


@contextlib.contextmanager
def timed(label: str = "", sync=None):
    """Wall-clock a block; the yielded dict gets ``seconds``.  When
    ``sync`` (or ``box["sync"]``, set inside the block) holds a tensor on
    the card, the clock stops after ``torch.cuda.synchronize()``."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if _on_card(box.get("sync", sync)):
            torch.cuda.synchronize()
        box["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[timed] {label}: {box['seconds']:.4f}s")
