"""Dense motion network: keypoint pairs -> dense 3D deformation field.

Port of ``canonswap_tpu/models/dense_motion.py``:

  compress (1^3 conv + BN + ReLU)
  -> [field_scale > 1: average pool (1, fs, fs)]
  -> hourglass input: K+1 translated copies of the compressed volume plus the
     keypoint gaussian difference, kp-major, the heatmap first in each group
  -> 3D hourglass -> 7^3 mask conv -> softmax over the K+1 motions
  -> deformation = identity grid + softmax-weighted sum of the shifts
  -> occlusion: a 7x7 conv with one output on the depth-flattened prediction.

At ``field_scale = fs > 1`` (the fast bundle's ``dense_motion_scale``) every
step from the hourglass input on runs at (D, H/fs, W/fs); the displacement
(not the grid: the corner-aligned identity grids of the two sizes differ)
and the occlusion logits are upsampled x fs with half-pixel bilinear
interpolation, and the full-resolution identity grid is added back.

Every sparse motion is identity + (kp_source_k - kp_driving_k), a constant
shift, so the K+1 copies are separable banded-matrix resamples
(:func:`axis_resample_matrix`), not gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.configs import DenseMotionConfig
from canonswap_torch.nn.blocks import Hourglass
from canonswap_torch.ops.grid_sample import axis_resample_matrix
from canonswap_torch.ops.heatmap import kp2gaussian, make_coordinate_grid_3d
from canonswap_torch.ops.resize import avg_pool, volume_to_2d


KP_VARIANCE = 0.01  # of the keypoint gaussians (reference dense_motion.py)


def build_hourglass_input(feature: torch.Tensor, kp_driving: torch.Tensor,
                          kp_source: torch.Tensor) -> torch.Tensor:
    """(B, Cc, D, H, W) volume + (B, K, 3) kp pairs ->
    (B, (K+1)(Cc+1), D, H, W): per motion k (0 = identity), the gaussian
    difference then the Cc channels of the volume sampled at
    identity + shift_k."""
    b, _, d, h, w = feature.shape
    shifts = torch.cat([torch.zeros_like(kp_driving[:, :1]),
                        kp_source - kp_driving], dim=1)  # (B, K+1, 3)
    wz = axis_resample_matrix(d, shifts[..., 2])  # (B, K+1, D, D)
    wy = axis_resample_matrix(h, shifts[..., 1])
    wx = axis_resample_matrix(w, shifts[..., 0])
    t = torch.einsum("bkad,bcdhw->bkcahw", wz, feature)
    t = torch.einsum("bkah,bkcdhw->bkcdaw", wy, t)
    t = torch.einsum("bkaw,bkcdhw->bkcdha", wx, t)  # (B, K+1, Cc, D, H, W)
    heat = (kp2gaussian(kp_driving, (d, h, w), KP_VARIANCE)
            - kp2gaussian(kp_source, (d, h, w), KP_VARIANCE))
    heat = torch.cat([torch.zeros_like(heat[:, :1]), heat], dim=1)
    return torch.cat([heat[:, :, None], t], dim=2).reshape(b, -1, d, h, w)


def bilinear_upsample_plane(x: torch.Tensor, fs: int) -> torch.Tensor:
    """Half-pixel bilinear x``fs`` upsample over H, W of (N, C, H, W).  At
    an integer factor, PyTorch's edge clamp gives the values of
    ``jax.image.resize(..., "linear")``, whose edge taps renormalize."""
    return F.interpolate(x, scale_factor=fs, mode="bilinear",
                         align_corners=False)


class DenseMotionNetwork(nn.Module):
    def __init__(self, cfg: DenseMotionConfig, num_kp: int,
                 feature_channel: int, field_scale: int = 1):
        super().__init__()
        self.num_blocks = cfg.num_blocks
        self.field_scale = field_scale
        self.compress = nn.Conv3d(feature_channel, cfg.compress, 1)
        self.norm = nn.BatchNorm3d(cfg.compress)
        self.hourglass = Hourglass(
            cfg.block_expansion, (num_kp + 1) * (cfg.compress + 1),
            cfg.num_blocks, cfg.max_features)
        out = self.hourglass.out_filters
        self.mask = nn.Conv3d(out, num_kp + 1, 7, padding=3)
        self.occlusion = nn.Conv2d(out * cfg.reshape_depth, 1, 7, padding=3)

    def forward(self, feature, kp_driving, kp_source) -> dict:
        """feature: (B, C, D, H, W); kp_*: (B, K, 3).

        Returns dict(deformation=(B, D, H, W, 3), mask=(B, K+1, D, Hs, Ws),
        occlusion_map=(B, 1, H, W)), with (Hs, Ws) = (H, W) / field_scale."""
        b, _, d, h, w = feature.shape
        fs = self.field_scale
        hs, ws = h // fs, w // fs
        if min(hs, ws) < 2**self.num_blocks:
            # the hourglass halves the plane num_blocks times
            raise ValueError(
                f"field_scale={fs} leaves a {hs}x{ws} field, too small for "
                f"a {self.num_blocks}-block hourglass (needs >= "
                f"{2**self.num_blocks})")
        # keypoints may arrive f32 under half-precision inference
        kp_driving = kp_driving.to(feature.dtype)
        kp_source = kp_source.to(feature.dtype)
        x = F.relu(self.norm(self.compress(feature)))
        if fs > 1:
            x = avg_pool(x, (1, fs, fs))
        prediction = self.hourglass(
            build_hourglass_input(x, kp_driving, kp_source))
        mask = torch.softmax(self.mask(prediction), dim=1)
        # sum_k mask_k * (grid + shift_k) with shift_0 = 0 and sum_k mask_k = 1
        disp = torch.einsum("bkdhw,bkc->bdhwc", mask[:, 1:],
                            kp_source - kp_driving)
        occ = self.occlusion(volume_to_2d(prediction))
        if fs > 1:
            disp = bilinear_upsample_plane(
                disp.reshape(b * d, hs, ws, 3).permute(0, 3, 1, 2), fs)
            disp = disp.permute(0, 2, 3, 1).reshape(b, d, h, w, 3)
            occ = bilinear_upsample_plane(occ, fs)
        grid = make_coordinate_grid_3d((d, h, w), mask.dtype, mask.device)
        return {"deformation": (grid[None] + disp).contiguous(), "mask": mask,
                "occlusion_map": torch.sigmoid(occ)}
