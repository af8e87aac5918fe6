"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``torch.device(device)``; a CUDA request without a usable GPU
    raises instead of silently running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
