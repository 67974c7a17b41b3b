"""Normalized coordinate grids and keypoint gaussians.

Port of ``canonswap_tpu/ops/heatmap.py``.  The grid is corner-aligned,
``2i/(n-1) - 1``, while the warp that consumes it unnormalizes with
``align_corners=False``: that mismatch is the reference's own and is kept.
"""

from __future__ import annotations

import torch


def make_coordinate_grid_3d(
    spatial_size: tuple[int, int, int], dtype=torch.float32, device=None
) -> torch.Tensor:
    """(D, H, W, 3) grid of xyz coordinates in [-1, 1]."""
    d, h, w = spatial_size

    def axis(n):
        return 2.0 * (torch.arange(n, dtype=dtype, device=device) / (n - 1)) - 1.0

    zz, yy, xx = torch.meshgrid(axis(d), axis(h), axis(w), indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def kp2gaussian(
    kp: torch.Tensor, spatial_size: tuple[int, int, int], kp_variance: float
) -> torch.Tensor:
    """(B, K, 3) keypoints -> (B, K, D, H, W) isotropic gaussian blobs."""
    grid = make_coordinate_grid_3d(spatial_size, kp.dtype, kp.device)
    diff = grid[None, None] - kp[:, :, None, None, None, :]
    return torch.exp(-0.5 * (diff * diff).sum(-1) / kp_variance)
