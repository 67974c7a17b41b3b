"""Building blocks of the generator (NCHW / NCDHW), in eval mode.

Port of ``canonswap_tpu/nn/blocks.py`` in its plain volume form; the TPU
layouts of the JAX package (pack_hw2, z-slab, stacked convs) are not ported:
their parameters are stored in the plain layout and cuDNN runs these convs
directly.  Attribute names are the reference checkpoint's ``state_dict`` keys
(``conv``/``norm``, ``norm1``/``conv1``..., ``encoder.down_blocks.{i}``,
``mlp_shared.0``).

``int8=True`` (the fast bundle) runs the blocks' convs through the W8A8 conv
(``ops/qconv.py``) where the JAX package does, with the same gates; the
parameters stay those of the ``nn.Conv2d`` / ``nn.Conv3d`` modules, so the
``state_dict`` keys do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.nn.spectral import SNConv2d
from canonswap_torch.ops.qconv import conv_w8a8, int8_worthwhile
from canonswap_torch.ops.resize import avg_pool, nearest_upsample


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm without affine (torch's default): per sample and channel
    over the spatial dims, biased variance, eps 1e-5."""
    dims = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def conv_int8(conv: nn.Conv2d | nn.Conv3d, x: torch.Tensor,
              int8: bool) -> torch.Tensor:
    """``conv(x)``, or with ``int8`` the same weight and bias through the
    W8A8 conv (stride 1, SAME, as every conv these blocks quantize)."""
    return conv_w8a8(x, conv.weight, conv.bias) if int8 else conv(x)


class _TrainableStats:
    """BatchNorm in eval mode whose running statistics may take gradients.
    The JAX trainer differentiates its whole variable tree, flax's
    batch_stats included (they enter the eval-mode normalization), and Adam
    updates them; PyTorch's batch_norm refuses statistics that require
    grad.  So where they do, the normalization is written out as flax
    computes it: (x - mean) * (scale * rsqrt(var + eps)) + bias."""

    def forward(self, x):
        if self.training or not (torch.is_grad_enabled()
                                 and self.running_var.requires_grad):
            return super().forward(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape))


class BatchNorm2d(_TrainableStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_TrainableStats, nn.BatchNorm3d):
    pass


class SameBlock2d(nn.Module):
    """Conv3x3 -> BN -> ReLU (or LeakyReLU 0.01), resolution kept."""

    def __init__(self, in_features: int, out_features: int,
                 lrelu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm2d(out_features)
        self.lrelu = lrelu

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.leaky_relu(x, 0.01) if self.lrelu else F.relu(x)


class DownBlock2d(nn.Module):
    """Conv3x3 -> BN -> ReLU -> AvgPool 2x2."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm2d(out_features)

    def forward(self, x):
        return avg_pool(F.relu(self.norm(self.conv(x))), (2, 2))


class DownBlock3d(nn.Module):
    """Conv3d 3^3 -> BN -> ReLU -> AvgPool (1, 2, 2): in-plane only."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv3d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm3d(out_features)

    def forward(self, x):
        return avg_pool(F.relu(self.norm(self.conv(x))), (1, 2, 2))


class UpBlock3d(nn.Module):
    """Nearest (1, 2, 2) -> Conv3d 3^3 -> BN -> ReLU."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv3d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm3d(out_features)

    def forward(self, x):
        x = nearest_upsample(x, (1, 2, 2))
        return F.relu(self.norm(self.conv(x)))


class ResBlock2d(nn.Module):
    """Pre-activation residual block: (BN -> LeakyReLU 0.01 -> Conv3x3) x2
    + skip.  ``int8``: both convs W8A8 where :func:`int8_worthwhile`."""

    def __init__(self, features: int, int8: bool = False):
        super().__init__()
        self.norm1 = BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.int8 = int8

    def forward(self, x):
        q = self.int8 and int8_worthwhile(x)
        h = conv_int8(self.conv1, F.leaky_relu(self.norm1(x), 0.01), q)
        h = conv_int8(self.conv2, F.leaky_relu(self.norm2(h), 0.01), q)
        return x + h


class ResBlock3d(nn.Module):
    """Pre-activation 3D residual block: (BN -> ReLU -> Conv3d 3^3) x2 + skip.
    ``int8``: both convs W8A8 (no shape gate, as in the JAX package)."""

    def __init__(self, features: int, int8: bool = False):
        super().__init__()
        self.norm1 = BatchNorm3d(features)
        self.conv1 = nn.Conv3d(features, features, 3, padding=1)
        self.norm2 = BatchNorm3d(features)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.int8 = int8

    def forward(self, x):
        h = conv_int8(self.conv1, F.relu(self.norm1(x)), self.int8)
        h = conv_int8(self.conv2, F.relu(self.norm2(h)), self.int8)
        return x + h


class ResBlock3dLeakGN(nn.Module):
    """(Conv3d -> GroupNorm -> LeakyReLU 0.01) x2 with a residual,
    post-activation; GroupNorm has min(32, C) groups, eps 1e-5.  A 1^3
    ``shortcut`` conv when the channel count changes.  ``int8``: the two
    3^3 convs W8A8 (no gate); the shortcut stays exact."""

    def __init__(self, in_features: int, features: int, int8: bool = False):
        super().__init__()
        self.int8 = int8
        groups = min(32, features)
        self.conv1 = nn.Conv3d(in_features, features, 3, padding=1)
        self.gn1 = nn.GroupNorm(groups, features, eps=1e-5)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.gn2 = nn.GroupNorm(groups, features, eps=1e-5)
        self.shortcut = (nn.Conv3d(in_features, features, 1)
                         if in_features != features else None)

    def forward(self, x):
        short = x if self.shortcut is None else self.shortcut(x)
        h = F.leaky_relu(self.gn1(conv_int8(self.conv1, x, self.int8)), 0.01)
        h = self.gn2(conv_int8(self.conv2, h, self.int8)) + short
        return F.leaky_relu(h, 0.01)


class HourglassEncoder(nn.Module):
    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int, max_features: int):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock3d(
                in_features if i == 0
                else min(max_features, block_expansion * 2**i),
                min(max_features, block_expansion * 2 ** (i + 1)))
            for i in range(num_blocks))

    def forward(self, x):
        outs = [x]
        for block in self.down_blocks:
            outs.append(block(outs[-1]))
        return outs


class HourglassDecoder(nn.Module):
    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int, max_features: int):
        super().__init__()
        blocks = []
        for i in reversed(range(num_blocks)):
            fin = (1 if i == num_blocks - 1 else 2) * min(
                max_features, block_expansion * 2 ** (i + 1))
            blocks.append(UpBlock3d(fin, min(max_features,
                                             block_expansion * 2**i)))
        self.up_blocks = nn.ModuleList(blocks)
        self.out_filters = block_expansion + in_features
        self.conv = nn.Conv3d(self.out_filters, self.out_filters, 3, padding=1)
        self.norm = BatchNorm3d(self.out_filters)

    def forward(self, feats):
        feats = list(feats)
        out = feats.pop()
        for block in self.up_blocks:
            out = torch.cat([block(out), feats.pop()], dim=1)
        return F.relu(self.norm(self.conv(out)))


class Hourglass(nn.Module):
    """3D U-Net; out channels = block_expansion + in_features."""

    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int, max_features: int):
        super().__init__()
        self.encoder = HourglassEncoder(block_expansion, in_features,
                                        num_blocks, max_features)
        self.decoder = HourglassDecoder(block_expansion, in_features,
                                        num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))


class SPADE(nn.Module):
    """Spatially-adaptive denormalization: instance_norm(x) * (1 + gamma)
    + beta, with gamma/beta convolved from the segmap nearest-upsampled to
    x's size (x is always an integer multiple of the segmap here).

    ``int8``: gamma and beta as ONE W8A8 conv over the concatenated kernel
    where :func:`int8_worthwhile` holds for its input, as the JAX package
    does; with per-output-channel steps that equals two.  ``mlp_shared``
    stays exact."""

    def __init__(self, norm_nc: int, label_nc: int, int8: bool = False):
        super().__init__()
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, 128, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(128, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(128, norm_nc, 3, padding=1)
        self.int8 = int8

    def forward(self, x, segmap, normalized=None):
        """``normalized`` passes a precomputed instance_norm(x)."""
        if normalized is None:
            normalized = instance_norm(x)
        seg = nearest_upsample(segmap, (x.shape[2] // segmap.shape[2],
                                        x.shape[3] // segmap.shape[3]))
        actv = self.mlp_shared(seg)
        if self.int8 and int8_worthwhile(actv):
            g, b = self.mlp_gamma, self.mlp_beta
            gb = conv_w8a8(actv, torch.cat([g.weight, b.weight]),
                           torch.cat([g.bias, b.bias]))
            gamma, beta = gb.split(g.out_channels, dim=1)
        else:
            gamma, beta = self.mlp_gamma(actv), self.mlp_beta(actv)
        return normalized * (1 + gamma) + beta


class SPADEResnetBlock(nn.Module):
    """SPADE residual block; spectral norm is baked into the conv weights,
    or with ``sn`` applied live (``nn/spectral.py``; the same parameter
    names, which takes precedence over int8 for the convs, as in the JAX
    block).  ``int8``: ``conv_0``, ``conv_1`` and ``conv_s`` W8A8 each
    where :func:`int8_worthwhile` holds for its input, and the SPADEs'
    int8."""

    def __init__(self, fin: int, fout: int, label_nc: int,
                 int8: bool = False, sn: bool = False):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.int8 = int8
        self.sn = sn

        def conv(cin, cout, k, bias=True):
            if sn:
                return SNConv2d(cin, cout, k, bias=bias)
            return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)

        self.conv_0 = conv(fin, fmiddle, 3)
        self.conv_1 = conv(fmiddle, fout, 3)
        self.norm_0 = SPADE(fin, label_nc, int8)
        self.norm_1 = SPADE(fmiddle, label_nc, int8)
        if self.learned_shortcut:
            self.conv_s = conv(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, label_nc, int8)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv_int8(conv, x, self.int8 and not self.sn
                         and int8_worthwhile(x))

    def forward(self, x, seg):
        if self.learned_shortcut:
            xn = instance_norm(x)  # shared by norm_s and norm_0
            x_s = self._conv(self.conv_s, self.norm_s(x, seg, normalized=xn))
        else:
            xn = None
            x_s = x
        dx = self._conv(self.conv_0,
                        F.leaky_relu(self.norm_0(x, seg, normalized=xn), 0.2))
        dx = self._conv(self.conv_1, F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx
