"""ConvNeXtV2 trunk with the seven motion heads.

Port of ``canonswap_tpu/nn/convnext.py``, in the reference's own form: NCHW
convs, channels-last LayerNorm / Linear / GRN inside each block.  Keys follow
the reference checkpoint (``downsample_layers.{i}.{j}``, ``stages.{i}.{j}``,
``norm``, ``fc_*``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channel axis of (N, C, H, W)."""

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


class GRN(nn.Module):
    """Global response normalization on (N, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        gx = torch.linalg.vector_norm(x, dim=(1, 2), keepdim=True)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class Block(nn.Module):
    """dwconv 7x7 -> LN -> pw 4x -> GELU (exact) -> GRN -> pw, + skip."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        h = self.dwconv(x).permute(0, 2, 3, 1)
        h = F.gelu(self.pwconv1(self.norm(h)))
        h = self.pwconv2(self.grn(h)).permute(0, 3, 1, 2)
        return x + h


class ConvNeXtV2(nn.Module):
    """4-stage trunk (stem 4x4/4, downsamples 2x2/2) + global pool + LN +
    the heads kp/pitch/yaw/roll/t/exp/scale.  Returns a dict of raw head
    outputs."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int],
                 num_kp: int, num_bins: int):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(3, dims[0], 4, stride=4),
            LayerNorm2d(dims[0], eps=1e-6))])
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm2d(dims[i - 1], eps=1e-6),
                nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        self.stages = nn.ModuleList(
            nn.Sequential(*(Block(dims[i]) for _ in range(depths[i])))
            for i in range(4))
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        c = dims[-1]
        self.fc_kp = nn.Linear(c, 3 * num_kp)
        self.fc_pitch = nn.Linear(c, num_bins)
        self.fc_yaw = nn.Linear(c, num_bins)
        self.fc_roll = nn.Linear(c, num_bins)
        self.fc_t = nn.Linear(c, 3)
        self.fc_exp = nn.Linear(c, 3 * num_kp)
        self.fc_scale = nn.Linear(c, 1)

    def forward(self, x):
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
        x = self.norm(x.mean(dim=(-2, -1)))
        return {
            "kp": self.fc_kp(x), "pitch": self.fc_pitch(x),
            "yaw": self.fc_yaw(x), "roll": self.fc_roll(x),
            "t": self.fc_t(x), "exp": self.fc_exp(x),
            "scale": self.fc_scale(x),
        }
