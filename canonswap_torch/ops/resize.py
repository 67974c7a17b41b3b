"""Resizing and pooling primitives on NC* tensors.

Port of ``canonswap_tpu/ops/resize.py`` (the parts the generator uses).  The
JAX package is channels-last and needs transposes for these; in PyTorch's
NCDHW layout the depth flatten of the reference (``view(B, C*D, H, W)``,
flat channel = c*D + d) is a plain view.
"""

from __future__ import annotations

import torch


def volume_to_2d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C*D, H, W), flat channel = c*D + d."""
    b, c, d, h, w = x.shape
    return x.reshape(b, c * d, h, w)


def volume_from_2d(x: torch.Tensor, depth: int) -> torch.Tensor:
    """Inverse of :func:`volume_to_2d`: (B, C*D, H, W) -> (B, C, D, H, W)."""
    b, cd, h, w = x.shape
    return x.reshape(b, cd // depth, depth, h, w)


def nearest_upsample(x: torch.Tensor, factors: tuple[int, ...]) -> torch.Tensor:
    """Integer nearest-neighbour upsample of (N, C, *spatial), one factor per
    spatial dim (torch ``F.interpolate(mode="nearest")`` at integer scale)."""
    for i, f in enumerate(factors):
        if f != 1:
            x = x.repeat_interleave(f, dim=2 + i)
    return x


def avg_pool(x: torch.Tensor, window: tuple[int, ...]) -> torch.Tensor:
    """Average pool with stride == window (VALID) over the spatial dims of
    (N, C, *spatial): a reshape and a mean, so any dtype on any device."""
    n, c, *spatial = x.shape
    out = [s // k for s, k in zip(spatial, window)]
    x = x[(..., *(slice(0, o * k) for o, k in zip(out, window)))]
    split = [d for o, k in zip(out, window) for d in (o, k)]
    dims = tuple(3 + 2 * i for i in range(len(window)))
    return x.reshape(n, c, *split).mean(dim=dims)

