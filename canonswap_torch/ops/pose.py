"""Head-pose math: bin-softmax pose regression, Euler rotations and the
implicit-keypoint transform.  Port of ``canonswap_tpu/ops/pose.py``."""

from __future__ import annotations

import math

import torch

NUM_BINS = 66


def headpose_to_degree(pred: torch.Tensor) -> torch.Tensor:
    """(B, 66) pose-bin logits -> (B,) degrees via the softmax expectation."""
    idx = torch.arange(NUM_BINS, dtype=pred.dtype, device=pred.device)
    prob = torch.softmax(pred, dim=-1)
    return (prob * idx).sum(-1) * 3.0 - 97.5


def rotation_matrix(pitch: torch.Tensor, yaw: torch.Tensor,
                    roll: torch.Tensor) -> torch.Tensor:
    """Batched Euler angles in degrees -> (B, 3, 3): the transpose of
    rot_z @ rot_y @ rot_x, so keypoints are right-multiplied (``kp @ R``)."""
    pitch = pitch.reshape(-1) / 180.0 * math.pi
    yaw = yaw.reshape(-1) / 180.0 * math.pi
    roll = roll.reshape(-1) / 180.0 * math.pi
    one = torch.ones_like(pitch)
    zero = torch.zeros_like(pitch)
    cx, sx = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cz, sz = torch.cos(roll), torch.sin(roll)
    rot_x = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                        -1).reshape(-1, 3, 3)
    rot_y = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                        -1).reshape(-1, 3, 3)
    rot_z = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                        -1).reshape(-1, 3, 3)
    return (rot_z @ rot_y @ rot_x).transpose(-1, -2)


def transform_keypoint(kp, pitch, yaw, roll, t, exp, scale) -> torch.Tensor:
    """``s * (kp @ R + exp) + t_xy``.

    kp/exp: (B, K, 3); pitch/yaw/roll: (B,) or (B, 1) degrees; t: (B, 3)
    (tz is dropped); scale: (B, 1).  Returns (B, K, 3)."""
    out = (kp @ rotation_matrix(pitch, yaw, roll) + exp) * scale[..., None]
    shift = torch.zeros_like(t)
    shift[:, 0:2] = t[:, 0:2]
    return out + shift[:, None, :]
