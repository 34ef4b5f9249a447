"""The device an entry point puts new state on when the caller names none."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "as_float_on"]


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


def as_float_on(x, device=None) -> torch.Tensor:
    """``x`` as a floating tensor for an entry point: a tensor keeps its
    device unless ``device`` names another; anything else (a list, a numpy
    array, a number) goes to :func:`resolve_device`, which is the card
    unless the caller asked for the CPU."""
    if isinstance(x, torch.Tensor):
        x = x if device is None else x.to(torch.device(device))
    else:
        x = torch.as_tensor(x, device=resolve_device(device))
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())
