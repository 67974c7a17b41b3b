"""ArcFace identity encoder (SE-IR ResNet), the swap's source-ID embedder.

Port of ``canonswap_tpu/models/arcface.py`` (the reference's
models/arcface_models.py:10-136).  The reference ships this net as a whole
pickled module, which needs the reference's classes to unpickle; the port
loads a ``state_dict`` instead, and its module names are the reference's
keys (``layer{1..4}.{i}.bn0/conv1/bn1/prelu/conv2/bn2``, ``se.fc.{0,1,2}``,
``downsample.{0,1}``, ``bn2``, ``fc``, ``bn3``), so a reference ArcFace
``state_dict`` loads strictly.  Default depths (3, 4, 23, 3), the r100
checkpoint's.

NCHW; BatchNorm in eval mode, eps 1e-5.  The PReLUs hold one slope each,
and an IR block applies its one PReLU twice.  ``conv1`` has no padding
(112 -> 110).  The forward returns (embedding, mid): mid is layer3's output
pooled to 7 x 7 and flattened channel-major.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.resize import adaptive_avg_pool, max_pool, \
    nearest_resize
from canonswap_torch.runtime.device import resolve_device


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5)


class SEBlock(nn.Module):
    """Squeeze-excitation: spatial mean -> Linear -> PReLU -> Linear ->
    sigmoid, scaling the channels."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction), nn.PReLU(),
            nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class IRBlock(nn.Module):
    """BN -> 3x3 conv -> BN -> PReLU -> 3x3 conv (stride) -> BN -> SE, plus
    the input (or its 1x1 strided conv + BN), then the same PReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_se: bool = True, downsample: bool = False):
        super().__init__()
        self.bn0 = _bn(inplanes)
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, padding=1, bias=False)
        self.bn1 = _bn(inplanes)
        self.prelu = nn.PReLU()
        self.conv2 = nn.Conv2d(inplanes, planes, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.se = SEBlock(planes) if use_se else None
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
            _bn(planes)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu(self.bn1(self.conv1(self.bn0(x))))
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = self.se(out)
        residual = x if self.downsample is None else self.downsample(x)
        return self.prelu(out + residual)


class ArcFaceResNet(nn.Module):
    """(N, 3, 112, 112) normalized -> ((N, 512) embedding, (N, 256 * 7 * 7)
    mid)."""

    def __init__(self, layers=(3, 4, 23, 3), use_se: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, bias=False)  # VALID: 112 -> 110
        self.bn1 = _bn(64)
        self.prelu = nn.PReLU()
        inplanes = 64
        for li, ((planes, stride), n) in enumerate(
                zip(((64, 1), (128, 2), (256, 2), (512, 2)), layers)):
            blocks = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                ds = bi == 0 and (s != 1 or inplanes != planes)
                blocks.append(IRBlock(inplanes, planes, s, use_se, ds))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.bn2 = _bn(512)
        self.fc = nn.Linear(512 * 7 * 7, 512)
        self.bn3 = nn.BatchNorm1d(512, eps=1e-5)

    def forward(self, x: torch.Tensor):
        x = max_pool(self.prelu(self.bn1(self.conv1(x))), (2, 2))
        x = self.layer3(self.layer2(self.layer1(x)))
        mid = adaptive_avg_pool(x, (7, 7)).flatten(1)  # channel-major
        x = self.bn2(self.layer4(x))  # dropout: identity at inference
        return self.bn3(self.fc(x.flatten(1))), mid


def get_id(model: ArcFaceResNet, img: torch.Tensor) -> torch.Tensor:
    """img (N, 3, H, W), ImageNet-normalized -> (N, 512) L2-normalized
    embedding (can_swap_e2e.py:102-107): resized to 112 by
    ``F.interpolate``'s default nearest mode first."""
    with torch.inference_mode():
        emb, _ = model(nearest_resize(img, (112, 112)))
    return F.normalize(emb, dim=-1, eps=0.0)


class ArcFaceRunner:
    """ArcFace on a device, for the source-ID step.

    Args:
      state_dict: reference-keyed weights (a reference ArcFace state_dict,
        or ``runtime/weights.py::arcface_from_jax``), or None for seeded
        random weights.
      layers: the four stages' depths.
      seed: the random weights' seed.
      device: where it runs; the card unless the caller asks for the CPU
        (raises if no card is there).
    """

    def __init__(self, state_dict: dict | None = None,
                 layers=(3, 4, 23, 3), seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        net = ArcFaceResNet(tuple(layers))
        if state_dict is None:
            init_random_(net, seed)  # on the CPU: one seed, one model
        else:
            net.load_state_dict(state_dict, strict=True)
        self.net = net.eval().requires_grad_(False).to(self.device)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, 112, 112) normalized -> (N, 512) embedding (not
        normalized), on the device."""
        with torch.inference_mode():
            return self.net(x.to(self.device))[0]
