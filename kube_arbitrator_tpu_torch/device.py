"""The device seam: every entry point resolves its device here.

``resolve_device()`` returns the GPU.  The CPU is used only when the
caller names it; without CUDA and without ``"cpu"`` it raises, so nothing
falls back to the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or a ``cuda`` device -> that CUDA device (raises when CUDA
    is unavailable); ``"cpu"`` -> the CPU.  Any other device type raises."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
