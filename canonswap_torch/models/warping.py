"""Warping module W: dense motion, then the trilinear warp.

Port of ``canonswap_tpu/models/warping.py``: ``warp`` (dense motion + warp),
``warp_out`` (volume -> 2D decoder input, times occlusion) and ``forward``
(both).  The warp is :func:`canonswap_torch.ops.grid_sample.grid_sample_3d`:
the CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from canonswap_torch.configs import WarpingConfig
from canonswap_torch.models.dense_motion import DenseMotionNetwork
from canonswap_torch.nn.blocks import SameBlock2d
from canonswap_torch.ops.grid_sample import grid_sample_3d
from canonswap_torch.ops.resize import volume_to_2d


class WarpingNetwork(nn.Module):
    def __init__(self, cfg: WarpingConfig = WarpingConfig()):
        super().__init__()
        self.dense_motion_network = DenseMotionNetwork(
            cfg.dense_motion, cfg.num_kp, cfg.reshape_channel)
        out_ch = cfg.block_expansion * 2**cfg.num_down_blocks
        self.third = SameBlock2d(cfg.max_features, out_ch, lrelu=True)
        self.fourth = nn.Conv2d(out_ch, out_ch, 1)

    def warp(self, feature_3d, kp_driving, kp_source):
        """feature_3d: (B, C, D, H, W); kp_*: (B, K, 3).

        Returns (warped volume, occlusion map (B, 1, H, W), dense motion
        dict)."""
        dense = self.dense_motion_network(feature_3d, kp_driving, kp_source)
        warped = grid_sample_3d(feature_3d.contiguous(), dense["deformation"])
        return warped, dense["occlusion_map"], dense

    def warp_out(self, volume, occlusion_map):
        """(B, C, D, H, W) volume, (B, 1, H, W) occlusion -> (B, out_ch, H, W)
        decoder input."""
        return self.fourth(self.third(volume_to_2d(volume))) * occlusion_map

    def forward(self, feature_3d, kp_driving, kp_source) -> dict:
        warped, occ, dense = self.warp(feature_3d, kp_driving, kp_source)
        return {"out": self.warp_out(warped, occ), "occlusion_map": occ,
                "deformation": dense["deformation"]}
