"""The landmark nets and runners: 106 points per clip, 203 per frame.

Port of ``canonswap_tpu/models/landmark.py``: the mobile trunk, the residual
trunk (``LandmarkNet``), the trunk switch, the 106-point runner (insightface
2d106det, model_zoo/landmark.py:80-112) and the 203-point runner (the
reference runs LivePortrait's landmark.onnx, human_landmark_runner.py:
26-95).  The mobile net is a MobileNetV1-0.5 body of depthwise-separable
blocks with per-channel PReLU, a global depthwise conv
(GDC) head over the whole remaining extent, and two dense layers to
``num_points * dims`` coordinates in [0, 1] of the 224 crop.  The convs carry
a bias (BatchNorm folded, as in the deployed ONNX graphs) and pad (1, 1)
explicitly.  Its module names are the JAX tree's, so ``runtime/weights.py::
landmark_from_jax`` carries its variables over.

The residual trunk is the JAX package's ONNX-import stand-in: a stride-2
conv stem, two GroupNorm residual blocks per width (eps 1e-5, gcd(width,
16) groups), a spatial mean and two dense layers; ``widths`` narrows it for
tests.  ``runtime/weights.py::landmark_net_from_jax`` maps flax's automatic
names inside its blocks onto ``conv0``/``norm0``/``conv1``/``norm1``.

The 106-point runner crops 192 x 192 around a detection box (centre, scale
1.5 of its longer side), feeds the raw 0..255 crop (no mean or std), and
decodes (pred + 1) * 96, mapped back by the crop's inverse.

The 203-point runner tracks frame to frame: a 224 crop around the previous
frame's points (scale 1.5, vy -0.1), or the whole frame resized when there
are none; the input is the crop / 255 (no mean or std); the points are the
prediction times 224, mapped back by the crop's inverse transform.  The crops and the
resize run in torch on the runner's device (``utils/geometry.py::
warp_affine``, ``ops/resize.py::resize_like_cv2``), at most one grey level
from the JAX runners' cv2 calls.  Both runners take a frame as a numpy
array or as a tensor; a tensor already on the runner's device is used as it
is, so a caller that uploads a frame once can hand it to every runner.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.resize import resize_like_cv2
from canonswap_torch.runtime.device import on_device, resolve_device
from canonswap_torch.utils import geometry as G


class _PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (the insightface convention), slope
    0.25 at init."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, alpha * x)


class _DWSep(nn.Module):
    """Depthwise-separable block on NCHW: dw 3x3 (stride, pad 1) -> PReLU
    -> pw 1x1 -> PReLU."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.dw = nn.Conv2d(c_in, c_in, 3, stride=stride, padding=1,
                            groups=c_in)
        self.dw_act = _PReLU(c_in)
        self.pw = nn.Conv2d(c_in, features, 1)
        self.pw_act = _PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw_act(self.pw(self.dw_act(self.dw(x))))


# (features, stride) of the 13 depthwise-separable blocks, before the width
PLAN = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
        (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))


class MobileLandmarkNet(nn.Module):
    """(B, H, W, 3) in [0, 1] -> (B, num_points * dims).

    ``input_size`` fixes the GDC head's kernel: the extent left after the
    stem's and the plan's five stride-2 convs (7 at 224)."""

    def __init__(self, num_points: int, dims: int = 2, width: float = 0.5,
                 input_size: int = 224):
        super().__init__()

        def c(n):  # width-multiplied channel count, at least 8
            return max(8, int(n * width))

        self.stem = nn.Conv2d(3, c(32), 3, stride=2, padding=1)
        self.stem_act = _PReLU(c(32))
        extent, c_in = (input_size - 1) // 2 + 1, c(32)
        for i, (f, s) in enumerate(PLAN):
            setattr(self, f"dw{i}", _DWSep(c_in, c(f), s))
            extent, c_in = (extent - 1) // s + 1, c(f)
        self.gdc = nn.Conv2d(c_in, c_in, extent, groups=c_in)
        self.fc0 = nn.Linear(c_in, 256)
        self.fc0_act = _PReLU(256)
        self.head = nn.Linear(256, num_points * dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem_act(self.stem(x.permute(0, 3, 1, 2)))
        for i in range(len(PLAN)):
            h = getattr(self, f"dw{i}")(h)
        h = self.gdc(h).flatten(1)
        return self.head(self.fc0_act(self.fc0(h)))


class _TrunkBlock(nn.Module):
    """Residual block on NCHW: 3x3 conv (stride, pad 1) -> GroupNorm ->
    ReLU -> 3x3 conv -> GroupNorm, plus the input, or a 1x1 strided conv of
    it where the block downsamples or changes width; then ReLU."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        groups = math.gcd(features, 16)
        self.conv0 = nn.Conv2d(c_in, features, 3, stride=stride, padding=1,
                               bias=False)
        self.norm0 = nn.GroupNorm(groups, features, eps=1e-5)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm1 = nn.GroupNorm(groups, features, eps=1e-5)
        if stride != 1 or c_in != features:
            self.short = nn.Conv2d(c_in, features, 1, stride=stride,
                                   bias=False)
        else:
            self.short = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(self.conv1(F.relu(self.norm0(self.conv0(x)))))
        residual = x if self.short is None else self.short(x)
        return F.relu(h + residual)


DEFAULT_WIDTHS = (32, 64, 128, 256)


class LandmarkNet(nn.Module):
    """The residual trunk: (B, H, W, 3) -> (B, num_points * dims)."""

    def __init__(self, num_points: int, dims: int = 2,
                 widths: tuple[int, ...] = DEFAULT_WIDTHS):
        super().__init__()
        self.widths = tuple(widths)
        self.stem = nn.Conv2d(3, widths[0], 3, stride=2, padding=1)
        c_in = widths[0]
        for i, w in enumerate(widths):
            setattr(self, f"block{i}", _TrunkBlock(c_in, w, 2 if i else 1))
            setattr(self, f"block{i}b", _TrunkBlock(w, w))
            c_in = w
        self.fc0 = nn.Linear(c_in, 512)
        self.head = nn.Linear(512, num_points * dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        for i in range(len(self.widths)):
            h = getattr(self, f"block{i}b")(getattr(self, f"block{i}")(h))
        return self.head(F.relu(self.fc0(h.mean(dim=(2, 3)))))


def _make_trunk(num_points: int, trunk: str, widths, input_size: int
                ) -> nn.Module:
    """``mobile`` (the coordinateReg default; its GDC head spans what is
    left of ``input_size``) or ``residual`` (``widths`` is its test-speed
    knob and applies only there)."""
    if trunk == "mobile":
        if widths is not None:
            raise ValueError(
                "widths only applies to trunk='residual' (the mobile trunk "
                "has a fixed MobileNetV1-0.5 plan); got widths="
                f"{widths!r}")
        return MobileLandmarkNet(num_points, input_size=input_size)
    if trunk == "residual":
        return LandmarkNet(num_points, widths=tuple(widths)
                           if widths is not None else DEFAULT_WIDTHS)
    raise ValueError(f"unknown landmark trunk {trunk!r} "
                     "(expected 'mobile' or 'residual')")


def _build(num_points: int, trunk: str, widths, input_size: int,
           state_dict: dict | None, seed: int, device: torch.device):
    net = _make_trunk(num_points, trunk, widths, input_size)
    if state_dict is None:
        init_random_(net, seed)  # on the CPU: one seed, one model
    else:
        net.load_state_dict(state_dict, strict=True)
    return net.eval().requires_grad_(False).to(device)


class Landmark106Runner:
    """2d106det's counterpart: detection box -> 192 crop -> net -> points
    in the image.

    Args:
      state_dict: the net's weights (``runtime/weights.py::landmark_from_jax``
        or ``landmark_net_from_jax``), or None for seeded random weights.
      seed: the random weights' seed.
      trunk, widths: ``mobile`` (default) or ``residual`` at ``widths``.
      device: where the crop and the net run; the card unless the caller
        asks for the CPU (raises if no card is there).
    """

    input_size = 192

    def __init__(self, state_dict: dict | None = None, seed: int = 0,
                 trunk: str = "mobile", widths=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.trunk = trunk
        self.net = _build(106, trunk, widths, self.input_size, state_dict,
                          seed, self.device)

    def crop_transform(self, bbox) -> np.ndarray:
        """bbox -> 2x3 image-to-crop affine (centre crop, scale 1.5 of the
        longer side, zero-size boxes guarded)."""
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        cx, cy = (bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2
        s = self.input_size / (max(w, h, 1e-3) * 1.5)
        t = self.input_size / 2
        return np.array([[s, 0, t - s * cx], [0, s, t - s * cy]], np.float32)

    def crop(self, img, bbox) -> tuple[torch.Tensor, np.ndarray]:
        """(crop (192, 192, 3) uint8 on the device, its 2x3 transform)."""
        M = self.crop_transform(bbox)
        return (G.warp_affine(on_device(img, self.device), M,
                              self.input_size), M)

    def predict(self, crop: torch.Tensor) -> np.ndarray:
        """The net on one raw 0..255 crop -> (106, 2) points in the crop's
        pixels."""
        with torch.inference_mode():
            pred = self.net(crop.float()[None])[0]
        pts = pred.cpu().numpy().reshape(-1, 2)
        return (pts + 1.0) * (self.input_size // 2)

    def get(self, img, bbox) -> np.ndarray:
        """uint8 RGB frame (H, W, 3) and a box x1y1x2y2 -> (106, 2) points
        in the frame's pixels."""
        crop, M = self.crop(img, bbox)
        Minv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
        return G.transform_pts(self.predict(crop), Minv)


class Landmark203Runner:
    """LivePortrait's 203-point refiner: a 224 crop around the previous
    landmarks, the net, the points mapped back to the image.

    Args:
      state_dict: the net's weights (``runtime/weights.py::
        landmark_from_jax`` or ``landmark_net_from_jax``), or None for
        seeded random weights.
      seed: the random weights' seed.
      trunk, widths: ``mobile`` (default) or ``residual`` at ``widths``.
      device: where the crop and the net run; the card unless the caller
        asks for the CPU (raises if no card is there).
    """

    input_size = 224

    def __init__(self, state_dict: dict | None = None, seed: int = 1,
                 trunk: str = "mobile", widths=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.trunk = trunk
        self.net = _build(203, trunk, widths, self.input_size, state_dict,
                          seed, self.device)

    def crop(self, img_rgb, lmk=None):
        """(crop (224, 224, 3) uint8 on the device, M_c2o 3x3): the crop
        around ``lmk``, or the whole frame resized to 224 x 224 with the
        reference's uniform scale back (max side / 224) when ``lmk`` is
        None."""
        img = on_device(img_rgb, self.device)
        size = self.input_size
        if lmk is not None:
            got = G.crop_image(img, lmk, dsize=size, scale=1.5,
                               vy_ratio=-0.1)
            return got["img_crop"], got["M_c2o"]
        scale = max(img_rgb.shape[:2]) / size
        return (resize_like_cv2(img, (size, size)),
                np.diag([scale, scale, 1.0]).astype(np.float32))

    def predict(self, crop: torch.Tensor) -> np.ndarray:
        """The net on one (224, 224, 3) uint8 crop -> (203, 2) points in
        the crop's pixels."""
        with torch.inference_mode():
            pred = self.net((crop.float() / 255.0)[None])[0]
        return pred.cpu().numpy().reshape(-1, 2) * self.input_size

    def run(self, img_rgb, lmk=None) -> np.ndarray:
        """uint8 RGB frame (H, W, 3) and the previous frame's (203, 2)
        points, or None -> (203, 2) points in the frame's pixels."""
        crop, M_c2o = self.crop(img_rgb, lmk)
        return G.transform_pts(self.predict(crop), M_c2o)
