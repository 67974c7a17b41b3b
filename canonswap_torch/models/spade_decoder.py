"""SPADE decoder G: warped 2D feature -> output image.

Port of ``canonswap_tpu/models/spade_decoder.py``: (B, 256, 64, 64) ->
(B, 3, 512, 512) at CANONICAL.  The input feature is the SPADE segmap of
every block; spectral norm is baked into the converted conv weights.
``SpadeConfig.int8_conv`` makes the middle blocks and ``up_0`` W8A8 where
their gates hold; ``up_1`` (at 4x the segmap's size) stays exact, as in the
JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.configs import SpadeConfig
from canonswap_torch.nn.blocks import SPADEResnetBlock
from canonswap_torch.ops.resize import nearest_upsample


class SPADEDecoder(nn.Module):
    def __init__(self, cfg: SpadeConfig = SpadeConfig()):
        super().__init__()
        ic = min(cfg.max_features, cfg.block_expansion * 2**cfg.num_down_blocks)
        self.fc = nn.Conv2d(ic, 2 * ic, 3, padding=1)
        q = cfg.int8_conv
        for i in range(6):
            setattr(self, f"G_middle_{i}",
                    SPADEResnetBlock(2 * ic, 2 * ic, ic, q))
        self.up_0 = SPADEResnetBlock(2 * ic, ic, ic, q)
        self.up_1 = SPADEResnetBlock(ic, cfg.out_channels, ic)
        self.conv_img = nn.Sequential(
            nn.Conv2d(cfg.out_channels, 3 * 4, 3, padding=1),
            nn.PixelShuffle(2))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """(B, ic, H, W) -> (B, 3, 8H, 8W) in [0, 1]."""
        seg = feature
        x = self.fc(feature)
        for i in range(6):
            x = getattr(self, f"G_middle_{i}")(x, seg)
        x = self.up_0(nearest_upsample(x, (2, 2)), seg)
        x = self.up_1(nearest_upsample(x, (2, 2)), seg)
        return torch.sigmoid(self.conv_img(F.leaky_relu(x, 0.2)))
