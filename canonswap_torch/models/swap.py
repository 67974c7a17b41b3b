"""Canonical-space identity injection (the "transfer" / swap module).

Port of ``canonswap_tpu/models/swap.py``: adaptive 2D residual blocks on the
depth-flattened volume, each blending a demodulated ID-style conv with the
plain conv through a learned mask, then plain 3D residual blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.configs import SwapConfig
from canonswap_torch.nn.blocks import ResBlock3d
from canonswap_torch.ops.modulated_conv import adaptive_blend_conv
from canonswap_torch.ops.resize import volume_from_2d, volume_to_2d


class AdaptiveConv2d(nn.Module):
    """Shared-weight conv blended with its ID-modulated twin through a
    learned mask."""

    def __init__(self, in_features: int, features: int, latent_dim: int,
                 int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.weight = nn.Parameter(torch.zeros(features, in_features, 3, 3))
        self.bias_param = nn.Parameter(torch.zeros(features))
        self.style_fc = nn.Sequential(
            nn.Linear(latent_dim, in_features), nn.LeakyReLU(0.2),
            nn.Linear(in_features, in_features))
        self.mask_conv = nn.Sequential(
            nn.Conv2d(in_features, 1, 3, padding=1), nn.Sigmoid())

    def forward(self, x, latent):
        return adaptive_blend_conv(x, self.weight, self.style_fc(latent),
                                   self.mask_conv(x), self.bias_param,
                                   int8=self.int8)


class AdaptiveResBlock2d(nn.Module):
    def __init__(self, features: int, latent_dim: int, int8: bool = False):
        super().__init__()
        self.conv1 = AdaptiveConv2d(features, features, latent_dim, int8)
        self.conv2 = AdaptiveConv2d(features, features, latent_dim, int8)

    def forward(self, x, latent):
        return x + self.conv2(F.relu(self.conv1(x, latent)), latent)


class SwapModule(nn.Module):
    def __init__(self, cfg: SwapConfig, channels: int, depth: int):
        """``channels``/``depth``: the volume's C and D (appearance
        reshape_channel / reshape_depth)."""
        super().__init__()
        self.BottleNeck_2d = nn.ModuleList(
            AdaptiveResBlock2d(channels * depth, cfg.latent_dim,
                               cfg.int8_conv)
            for _ in range(cfg.n_blocks))
        self.resblocks_3d = nn.Sequential()
        for i in range(cfg.n_resblocks_3d):
            self.resblocks_3d.add_module(
                f"3dr{i}", ResBlock3d(channels, cfg.int8_conv))

    def forward(self, volume: torch.Tensor, id_latent: torch.Tensor):
        """volume: (B, C, D, H, W); id_latent: (B, latent_dim)."""
        d = volume.shape[2]
        x = volume_to_2d(volume)
        for block in self.BottleNeck_2d:
            x = block(x, id_latent)
        return self.resblocks_3d(volume_from_2d(x, d))
