"""The 203-point landmark tracker: MobileLandmarkNet and Landmark203Runner.

Port of ``canonswap_tpu/models/landmark.py`` (the mobile trunk and the
203-point runner; the reference runs LivePortrait's landmark.onnx,
human_landmark_runner.py:26-95).  The net is a MobileNetV1-0.5 body of
depthwise-separable blocks with per-channel PReLU, a global depthwise conv
(GDC) head over the whole remaining extent, and two dense layers to
``num_points * dims`` coordinates in [0, 1] of the 224 crop.  The convs carry
a bias (BatchNorm folded, as in the deployed ONNX graphs) and pad (1, 1)
explicitly.  Module names are the JAX tree's, so ``runtime/weights.py::
landmark_from_jax`` carries its variables over.

The runner tracks frame to frame: a 224 crop around the previous frame's
points (scale 1.5, vy -0.1), or the whole frame resized when there are none;
the input is the crop / 255 (no mean or std); the points are the prediction
times 224, mapped back by the crop's inverse transform.  The crop and the
resize run in torch on the runner's device (``utils/geometry.py::
warp_affine``, ``ops/resize.py::resize_like_cv2``), at most one grey level
from the JAX runner's cv2 calls.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.resize import resize_like_cv2
from canonswap_torch.runtime.device import resolve_device
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


class Landmark203Runner:
    """LivePortrait's 203-point refiner: a 224 crop around the previous
    landmarks, the net, the points mapped back to the image.

    Args:
      state_dict: the net's weights (``runtime/weights.py::
        landmark_from_jax``), or None for seeded random weights.
      seed: the random weights' seed.
      device: where the crop and the net run; the card unless the caller
        asks for the CPU (raises if no card is there).
    """

    input_size = 224

    def __init__(self, state_dict: dict | None = None, seed: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        net = MobileLandmarkNet(203, input_size=self.input_size)
        if state_dict is None:
            init_random_(net, seed)  # on the CPU: one seed, one model
        else:
            net.load_state_dict(state_dict, strict=True)
        self.net = net.eval().requires_grad_(False).to(self.device)

    def crop(self, img_rgb: np.ndarray, lmk=None):
        """(crop (224, 224, 3) uint8 on the device, M_c2o 3x3): the crop
        around ``lmk``, or the whole frame resized to 224 x 224 with the
        reference's uniform scale back (max side / 224) when ``lmk`` is
        None."""
        img = torch.from_numpy(np.ascontiguousarray(img_rgb)).to(self.device)
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

    def run(self, img_rgb: np.ndarray, lmk=None) -> np.ndarray:
        """uint8 RGB frame (H, W, 3) and the previous frame's (203, 2)
        points, or None -> (203, 2) points in the frame's pixels."""
        crop, M_c2o = self.crop(img_rgb, lmk)
        return G.transform_pts(self.predict(crop), M_c2o)
