"""Where an entry point of the port runs.

Entry points (``CanonSwapCore``, ``XPoseRunner``) take ``device="cuda"`` by
default: the port is for the card, and the CPU is asked for by name
(``device="cpu"``), as the tests do.  A CUDA device that is not there raises
here, before any weight is built, instead of the path running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for, but no CUDA device is available "
            "(torch.cuda.is_available() is false); pass device='cpu' to run "
            "on the CPU")
    return dev


def on_device(img, device: torch.device) -> torch.Tensor:
    """An image (numpy array or tensor) as a tensor on ``device``: uploaded
    once, or used as it is where it is already there, so a caller that
    uploads a frame once can hand it to every runner."""
    if isinstance(img, torch.Tensor):
        return img.to(device)
    return torch.from_numpy(np.ascontiguousarray(img)).to(device)
