"""Motion extractor M: image -> implicit keypoints, pose and expression.

Port of ``canonswap_tpu/models/motion.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from canonswap_torch.configs import MotionConfig
from canonswap_torch.nn.convnext import ConvNeXtV2
from canonswap_torch.ops.pose import headpose_to_degree


class MotionExtractor(nn.Module):
    def __init__(self, cfg: MotionConfig = MotionConfig()):
        super().__init__()
        self.detector = ConvNeXtV2(cfg.depths, cfg.dims, cfg.num_kp,
                                   cfg.num_bins)

    def forward(self, image: torch.Tensor) -> dict[str, torch.Tensor]:
        """image: (B, 3, S, S) in [0, 1] -> dict of raw head outputs."""
        return self.detector(image)


def refine_kp_info(kp_info: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Raw head outputs -> motion dict: pitch/yaw/roll (B, 1) degrees, kp/exp
    (B, K, 3), t (B, 3), scale (B, 1).  Keypoint math is f32 whatever the
    network's dtype."""
    out = {k: v.float() for k, v in kp_info.items()}
    b = out["kp"].shape[0]
    for k in ("pitch", "yaw", "roll"):
        out[k] = headpose_to_degree(out[k])[:, None]
    out["kp"] = out["kp"].reshape(b, -1, 3)
    out["exp"] = out["exp"].reshape(b, -1, 3)
    return out
