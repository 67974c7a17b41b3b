"""Mask feathering: SoftErosion.

Port of ``canonswap_tpu/ops/affine.py::_radial_kernel`` and
``soft_erosion`` (the reference's SoftErosion, crop.py:21-47): a radial
kernel blurs a single-channel mask, the first ``iterations - 1`` passes
keep the minimum of the mask and its blur, and the last blur is split at
``threshold``: 1 above it, and below it renormalized by its own maximum per
image.  Channels-last at the public function, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _radial_kernel(kernel_size: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(k, k) weights falling linearly with the distance from the centre,
    zero at the farthest corner, summing to 1."""
    r = kernel_size // 2
    ax = torch.arange(kernel_size, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    dist = torch.sqrt((xx - r) ** 2 + (yy - r) ** 2)
    k = dist.max() - dist
    return k / k.sum()


def soft_erosion(x: torch.Tensor, kernel_size: int = 21,
                 threshold: float = 0.9, iterations: int = 3):
    """x: (B, H, W, 1) in [0, 1] -> (soft mask, hard mask), both
    (B, H, W, 1); the blur is a SAME (zero-padded) conv."""
    k = _radial_kernel(kernel_size, x.dtype, x.device)[None, None]
    pad = kernel_size // 2
    v = x.permute(0, 3, 1, 2)

    def blur(t):
        return F.conv2d(t, k, padding=pad)

    for _ in range(iterations - 1):
        v = torch.minimum(v, blur(v))
    v = blur(v).permute(0, 2, 3, 1)
    hard = v >= threshold
    below_max = torch.where(hard, 0.0, v).amax(dim=(1, 2, 3), keepdim=True)
    soft = torch.where(hard, 1.0, v / below_max.clamp_min(1e-6))
    return soft, hard
