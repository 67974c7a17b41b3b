"""SCRFD-10GF face detector (the det_10g topology) in PyTorch.

Port of ``canonswap_tpu/models/scrfd.py``, the published SCRFD-10GF
architecture (Guo et al., "Sample and Computation Redistribution for
Efficient Face Detection"):

  backbone  ResNetV1e: deep 3-conv stem (28, 28, 56) + 3x3/2 max-pool,
            BasicBlock stages (3, 4, 2, 3) x (56, 88, 88, 224), strides
            (1, 2, 2, 2), avg-down shortcuts
  neck      PAFPN over C3/C4/C5 (88, 88, 224), 56 channels, 3 levels
  head      one instance shared across the three strides: 4 x (3x3 conv,
            BatchNorm, ReLU) at 80 channels, then 3x3 score / bbox / kps
            convs, 2 anchors per position

NCHW throughout; BatchNorm in eval mode, eps 1e-5.  Module names are the
JAX tree's (``runtime/weights.py::scrfd_from_jax``).  The letterbox of
:func:`preprocess` runs on the image's device, with
``ops/resize.py::resize_like_cv2`` in place of ``cv2.resize`` (at most one
grey level apart); :func:`detect` decodes with ``ops/detection.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.ops.detection import decode_scrfd
from canonswap_torch.ops.resize import avg_pool, max_pool, resize_like_cv2


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5)


class ConvBNReLU(nn.Module):
    def __init__(self, c_in: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, features, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """ResNet BasicBlock with the V1d/V1e avg-down shortcut: where the block
    downsamples or changes width, the identity path is a 2x2 average pool
    (stride 2) then a 1x1 conv + BatchNorm."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvBNReLU(c_in, features, stride=stride)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.shortcut = stride != 1 or c_in != features
        if self.shortcut:
            self.downsample = nn.Conv2d(c_in, features, 1, bias=False)
            self.downsample_bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(self.conv1(x)))
        residual = x
        if self.shortcut:
            if self.stride != 1:
                residual = avg_pool(residual, (self.stride, self.stride))
            residual = self.downsample_bn(self.downsample(residual))
        return F.relu(h + residual)


class ResNetV1e(nn.Module):
    """Deep stem + BasicBlock stages; returns C3, C4, C5 (strides 8, 16,
    32)."""

    def __init__(self, stem_channels: int = 56,
                 stage_planes=(56, 88, 88, 224), stage_blocks=(3, 4, 2, 3)):
        super().__init__()
        c = stem_channels
        self.stem0 = ConvBNReLU(3, c // 2, stride=2)
        self.stem1 = ConvBNReLU(c // 2, c // 2)
        self.stem2 = ConvBNReLU(c // 2, c)
        self.names = []
        c_in = c
        for i, (w, d) in enumerate(zip(stage_planes, stage_blocks)):
            for j in range(d):
                stride = 2 if (j == 0 and i > 0) else 1
                setattr(self, f"layer{i}_{j}", BasicBlock(c_in, w, stride))
                c_in = w
            self.names.append([f"layer{i}_{j}" for j in range(d)])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem2(self.stem1(self.stem0(x)))
        x = max_pool(x, (3, 3), (2, 2), padding=1)  # -inf pad, VALID pool
        feats = []
        for i, names in enumerate(self.names):
            for name in names:
                x = getattr(self, name)(x)
            if i >= 1:
                feats.append(x)
        return feats


class PAFPN(nn.Module):
    """Path-aggregation FPN (mmdet PAFPN): 1x1 laterals, top-down nearest
    2x upsample adds, 3x3 fpn convs, bottom-up stride-2 adds, 3x3 pafpn
    convs on the aggregated levels."""

    def __init__(self, in_channels=(88, 88, 224), out_channels: int = 56):
        super().__init__()
        c, n = out_channels, len(in_channels)
        self.n = n
        for i, c_in in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c_in, c, 1))
            setattr(self, f"fpn_conv{i}", nn.Conv2d(c, c, 3, padding=1))
        for i in range(1, n):
            setattr(self, f"down_conv{i}",
                    nn.Conv2d(c, c, 3, stride=2, padding=1))
            setattr(self, f"pafpn_conv{i}", nn.Conv2d(c, c, 3, padding=1))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        n = self.n
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        td = [None] * n
        td[-1] = lat[-1]
        for i in range(n - 2, -1, -1):
            up = td[i + 1].repeat_interleave(2, dim=2).repeat_interleave(
                2, dim=3)
            td[i] = lat[i] + up
        td = [getattr(self, f"fpn_conv{i}")(t) for i, t in enumerate(td)]
        out = [td[0]]
        for i in range(1, n):
            out.append(td[i] + getattr(self, f"down_conv{i}")(out[-1]))
        return [out[0]] + [getattr(self, f"pafpn_conv{i}")(o)
                           for i, o in enumerate(out[1:], start=1)]


class SCRFDHead(nn.Module):
    """4 x (3x3 conv + BatchNorm + ReLU) at 80 channels, then the score,
    bbox and kps 3x3 convs; 2 anchors per position.  Outputs are flattened
    as the JAX head's channels-last reshape: anchor index (y, x, a)."""

    def __init__(self, in_channels: int = 56, channels: int = 80,
                 stacked: int = 4, num_anchors: int = 2):
        super().__init__()
        self.stacked = stacked
        for i in range(stacked):
            setattr(self, f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else channels, channels, 3, padding=1,
                bias=False))
            setattr(self, f"bn{i}", _bn(channels))
        a = num_anchors
        self.cls = nn.Conv2d(channels, a * 1, 3, padding=1)
        self.reg = nn.Conv2d(channels, a * 4, 3, padding=1)
        self.kps = nn.Conv2d(channels, a * 10, 3, padding=1)

    def forward(self, x: torch.Tensor) -> dict:
        h = x
        for i in range(self.stacked):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        b = x.shape[0]

        def flat(t, n):
            return t.permute(0, 2, 3, 1).reshape(b, -1, n)

        return {"score": flat(torch.sigmoid(self.cls(h)), 1),
                "bbox": flat(self.reg(h), 4),
                "kps": flat(self.kps(h), 10)}


class SCRFD(nn.Module):
    """The whole detector: (B, 3, S, S) preprocessed -> {stride: head
    outputs}; one head instance serves every stride."""

    def __init__(self, strides=(8, 16, 32)):
        super().__init__()
        self.strides = tuple(strides)
        self.backbone = ResNetV1e()
        self.neck = PAFPN()
        self.head = SCRFDHead()

    def forward(self, x: torch.Tensor) -> dict:
        feats = self.neck(self.backbone(x))
        return {s: self.head(f) for s, f in zip(self.strides, feats)}


def preprocess(img: torch.Tensor, input_size=(640, 640)):
    """Aspect-preserving letterbox into ``input_size`` (w, h), then
    (x - 127.5) / 128 (scrfd.py:154, 220-235), on the image's device.

    img: (H, W, 3) uint8 tensor.  Returns (blob (1, 3, h, w) f32,
    det_scale)."""
    h, w = img.shape[:2]
    im_ratio = h / w
    model_ratio = input_size[1] / input_size[0]
    if im_ratio > model_ratio:
        new_h = input_size[1]
        new_w = int(new_h / im_ratio)
    else:
        new_w = input_size[0]
        new_h = int(new_w * im_ratio)
    det_scale = new_h / h
    det_img = torch.zeros((input_size[1], input_size[0], 3),
                          dtype=torch.uint8, device=img.device)
    det_img[:new_h, :new_w] = resize_like_cv2(img, (new_h, new_w))
    blob = (det_img.permute(2, 0, 1).float() - 127.5) / 128.0
    return blob[None], det_scale


def detect(model: SCRFD, blob: torch.Tensor, *, input_size=(640, 640),
           score_thresh: float = 0.5, iou_thresh: float = 0.4,
           topk: int = 128) -> dict:
    """blob (B, 3, H, W) -> fixed-size detections (``ops/detection.py``)."""
    with torch.inference_mode():
        return decode_scrfd(model(blob), input_size=input_size,
                            score_thresh=score_thresh,
                            iou_thresh=iou_thresh, topk=topk)
