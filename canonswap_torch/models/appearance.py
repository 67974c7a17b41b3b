"""Appearance feature extractor F: source crop -> 3D feature volume.

Port of ``canonswap_tpu/models/appearance.py``: (B, 3, S, S) ->
(B, C, D, S/4, S/4).  The 2D feature's channels split C outer, D inner, which
in NCDHW is a plain view.
"""

from __future__ import annotations

import torch
from torch import nn

from canonswap_torch.configs import AppearanceConfig
from canonswap_torch.nn.blocks import DownBlock2d, ResBlock3d, SameBlock2d


class AppearanceFeatureExtractor(nn.Module):
    def __init__(self, cfg: AppearanceConfig = AppearanceConfig()):
        super().__init__()
        self.cfg = cfg
        self.first = SameBlock2d(cfg.image_channel, cfg.block_expansion)
        self.down_blocks = nn.ModuleList(
            DownBlock2d(
                min(cfg.max_features, cfg.block_expansion * 2**i),
                min(cfg.max_features, cfg.block_expansion * 2 ** (i + 1)))
            for i in range(cfg.num_down_blocks))
        self.second = nn.Conv2d(
            min(cfg.max_features,
                cfg.block_expansion * 2**cfg.num_down_blocks),
            cfg.max_features, 1)
        self.resblocks_3d = nn.Sequential()
        for i in range(cfg.num_resblocks):
            self.resblocks_3d.add_module(f"3dr{i}",
                                         ResBlock3d(cfg.reshape_channel))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (B, 3, S, S) in [0, 1] -> (B, C, D, S/4, S/4)."""
        x = self.first(image)
        for block in self.down_blocks:
            x = block(x)
        x = self.second(x)
        b, _, h, w = x.shape
        x = x.reshape(b, self.cfg.reshape_channel, self.cfg.reshape_depth, h, w)
        return self.resblocks_3d(x)
