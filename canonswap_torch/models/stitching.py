"""Stitching and eye / lip retargeting MLPs.

Port of ``canonswap_tpu/models/stitching.py`` (the reference's
stitching_retargeting_network.py:18-38, sizes models.yaml:31-43): three
ReLU MLPs from concat(keypoints, ratio) to keypoint deltas, with the
LivePortrait retarget and stitch arithmetic.  The nets are named as the JAX
module's (``stitching``, ``eye``, ``lip``); each holds an ``mlp`` Sequential
of Linear and ReLU, so its Linears are ``mlp.{2i}`` as in the reference
checkpoint, whose nets are ``retarget_shoulder``, ``retarget_eye`` and
``retarget_mouth`` (:data:`CHECKPOINT_KEYS`).

The hidden sizes come from :class:`StitchingConfig`; the input and output
sizes from the keypoint count, as the JAX module takes them (the config's
are those of 21 keypoints).  The nets run in f32, as the keypoint math does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.configs import StitchingConfig


# the reference checkpoint's name of each net
CHECKPOINT_KEYS = {"stitching": "retarget_shoulder", "eye": "retarget_eye",
                   "lip": "retarget_mouth"}


class StitchingRetargetingNetwork(nn.Module):
    def __init__(self, input_size: int, hidden_sizes, output_size: int):
        super().__init__()
        layers: list[nn.Module] = []
        for h in hidden_sizes:
            layers += [nn.Linear(input_size, h), nn.ReLU()]
            input_size = h
        layers.append(nn.Linear(input_size, output_size))
        self.mlp = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


def concat_feat(kp: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """concat(flatten(kp), flatten(ratio)) per batch row."""
    b = kp.shape[0]
    return torch.cat([kp.reshape(b, -1), ratio.reshape(b, -1)], dim=1)


class StitchingModule(nn.Module):
    """The stitching net S and the retargeting nets R_eye and R_lip."""

    def __init__(self, num_kp: int = 21,
                 cfg: StitchingConfig = StitchingConfig()):
        super().__init__()
        k3 = num_kp * 3
        self.stitching = StitchingRetargetingNetwork(
            2 * k3, cfg.stitching[1], k3 + 2)
        self.eye = StitchingRetargetingNetwork(k3 + 3, cfg.eye[1], k3)
        self.lip = StitchingRetargetingNetwork(k3 + 2, cfg.lip[1], k3)

    def stitch(self, kp_source: torch.Tensor,
               kp_driving: torch.Tensor) -> torch.Tensor:
        """kp_driving plus the net's delta, and its last two outputs added
        to every keypoint's x and y."""
        b, k, _ = kp_driving.shape
        delta = self.stitching(concat_feat(kp_source, kp_driving))
        kp = kp_driving + delta[:, :k * 3].reshape(b, k, 3)
        return kp + F.pad(delta[:, None, k * 3:k * 3 + 2], (0, 1))

    def retarget_eye(self, kp_source: torch.Tensor,
                     eye_close_ratio: torch.Tensor) -> torch.Tensor:
        """(B, K, 3) and (B, 3) -> (B, K, 3) delta (can_swap_e2e.py:258-269)."""
        delta = self.eye(concat_feat(kp_source, eye_close_ratio))
        return delta.reshape(-1, kp_source.shape[1], 3)

    def retarget_lip(self, kp_source: torch.Tensor,
                     lip_close_ratio: torch.Tensor) -> torch.Tensor:
        """(B, K, 3) and (B, 2) -> (B, K, 3) delta (can_swap_e2e.py:271-282)."""
        delta = self.lip(concat_feat(kp_source, lip_close_ratio))
        return delta.reshape(-1, kp_source.shape[1], 3)
