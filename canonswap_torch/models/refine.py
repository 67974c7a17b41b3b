"""Post-swap 3D refine module: 3 GroupNorm-leaky 3D resblocks -> 3 2D
resblocks on the depth-flattened volume -> 3 GroupNorm-leaky 3D resblocks.

Port of ``canonswap_tpu/models/refine.py`` in the plain volume layout.
"""

from __future__ import annotations

import torch
from torch import nn

from canonswap_torch.nn.blocks import ResBlock2d, ResBlock3dLeakGN
from canonswap_torch.ops.resize import volume_from_2d, volume_to_2d


class RefineModule(nn.Module):
    def __init__(self, channels: int = 32, depth: int = 16):
        super().__init__()
        self.resblocks1 = nn.Sequential(
            *(ResBlock3dLeakGN(channels, channels) for _ in range(3)))
        self.resblocks2 = nn.Sequential(
            *(ResBlock2d(channels * depth) for _ in range(3)))
        self.resblocks3 = nn.Sequential(
            *(ResBlock3dLeakGN(channels, channels) for _ in range(3)))

    def forward(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, C, D, H, W) -> (B, C, D, H, W)."""
        x = self.resblocks1(volume)
        x = volume_from_2d(self.resblocks2(volume_to_2d(x)), volume.shape[2])
        return self.resblocks3(x)
