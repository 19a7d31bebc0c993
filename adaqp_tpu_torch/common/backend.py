"""Device selection for the port's entry points.

Entry points (``Trainer``, ``StripLayout.to_device``) run on the CUDA card
unless the caller asks for the CPU. Without a card they raise instead of
falling back: a run that silently lands on the CPU would be timed and
reported as if it were the card's.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA card; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as given, or :func:`default_device` when it is None."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev
