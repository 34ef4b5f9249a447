"""The device an entry point puts new state on when the caller names none."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the CUDA card.

    There is no fallback to the host: without CUDA, ``None`` raises.  A
    caller asks for the CPU with ``device="cpu"`` (or by passing CPU
    tensors to an entry point that takes its device from its data)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "asked otherwise; pass device='cpu' (or CPU tensors) to run on the host"
        )
    return torch.device("cuda")
