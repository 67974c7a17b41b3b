"""The CanonSwap generator core: six networks and the per-batch swap path.

Port of ``canonswap_tpu/runtime/core.py``.  :class:`CanonSwapCore` holds the
six networks under the reference checkpoint's keys (appearance_feature_extractor,
motion_extractor, warping_module, spade_generator, transfer, refine), so
``core.state_dict()`` has the checkpoint's layout.  The stage functions mirror
the JAX package's, without the params argument.

Layouts: frames are (B, S, S, 3) in [0, 1] and output images (B, 2S, 2S, 3),
as in the JAX package; volumes between stages are the port's (B, C, D, H, W).
Half precision (the JAX session's ``flag_use_half_precision`` default) is
``core.to(torch.bfloat16)`` with bf16 frames: weights and compute are bf16,
while keypoint math stays f32.
"""

from __future__ import annotations

import torch
from torch import nn

from canonswap_torch.configs import CANONICAL, CanonSwapModelConfig
from canonswap_torch.models.appearance import AppearanceFeatureExtractor
from canonswap_torch.models.motion import MotionExtractor, refine_kp_info
from canonswap_torch.models.refine import RefineModule
from canonswap_torch.models.spade_decoder import SPADEDecoder
from canonswap_torch.models.swap import SwapModule
from canonswap_torch.models.warping import WarpingNetwork
from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.pose import transform_keypoint


class CanonSwapCore(nn.Module):
    """The six generator networks, in eval mode, without gradients."""

    def __init__(self, cfg: CanonSwapModelConfig = CANONICAL,
                 seed: int | None = 0):
        """``seed``: random weights from this seed (no checkpoint ships);
        None leaves PyTorch's default init for a state_dict to replace."""
        super().__init__()
        self.cfg = cfg
        c, d = cfg.appearance.reshape_channel, cfg.appearance.reshape_depth
        self.appearance_feature_extractor = AppearanceFeatureExtractor(
            cfg.appearance)
        self.motion_extractor = MotionExtractor(cfg.motion)
        self.warping_module = WarpingNetwork(cfg.warping)
        self.spade_generator = SPADEDecoder(cfg.spade)
        self.transfer = SwapModule(cfg.swap, c, d)
        self.refine = RefineModule(c, d)
        if seed is not None:
            init_random_(self, seed)
        self.eval()
        self.requires_grad_(False)


def _nchw(frames: torch.Tensor) -> torch.Tensor:
    return frames.permute(0, 3, 1, 2).contiguous()


def extract_motion(core: CanonSwapCore, frames: torch.Tensor) -> dict:
    """frames (B, S, S, 3) -> motion dict (f32): kp/exp (B, K, 3),
    pitch/yaw/roll (B, 1) degrees, t (B, 3), scale (B, 1) and x_t (B, K, 3)
    the posed keypoints."""
    info = refine_kp_info(core.motion_extractor(_nchw(frames)))
    info["x_t"] = transform_keypoint(
        info["kp"], info["pitch"][:, 0], info["yaw"][:, 0], info["roll"][:, 0],
        info["t"], info["exp"], info["scale"])
    return info


def appearance_features(core: CanonSwapCore, frames: torch.Tensor):
    """frames (B, S, S, 3) -> feature volume (B, C, D, S/4, S/4)."""
    return core.appearance_feature_extractor(_nchw(frames))


def warp_to_canonical(core: CanonSwapCore, f_s, x_t, x_can):
    """Posed volume -> canonical volume, and the occlusion map."""
    warped, occ, _ = core.warping_module.warp(f_s, kp_driving=x_can,
                                              kp_source=x_t)
    return warped, occ


def inject_identity(core: CanonSwapCore, f_can, source_id):
    return core.transfer(f_can, source_id.to(f_can.dtype))


def refine_volume(core: CanonSwapCore, f_swap):
    return core.refine(f_swap)


def warp_decode(core: CanonSwapCore, volume, x_can, x_t):
    """Canonical volume -> driving pose -> image (B, 2S, 2S, 3)."""
    ret = core.warping_module(volume, kp_driving=x_t, kp_source=x_can)
    return core.spade_generator(ret["out"]).permute(0, 2, 3, 1)


def swap_step(core: CanonSwapCore, frames: torch.Tensor,
              source_id: torch.Tensor, motion: dict) -> dict:
    """One frame batch: F -> warp to canonical -> swap -> refine -> warp back
    and decode.

    frames: (B, S, S, 3) in [0, 1]; source_id: (1 or B, latent)
    L2-normalized ID embedding; motion: 'kp', 'scale', 'x_t' of these frames.
    Returns dict(out=(B, 2S, 2S, 3))."""
    b = frames.shape[0]
    if source_id.shape[0] == 1 and b != 1:
        source_id = source_id.expand(b, source_id.shape[1])
    f_s = appearance_features(core, frames)
    # keypoint math arrives in f32; the compute path follows the frame dtype
    x_can = (motion["scale"][..., None] * motion["kp"]).to(frames.dtype)
    x_t = motion["x_t"].to(frames.dtype)
    f_can, _ = warp_to_canonical(core, f_s, x_t, x_can)
    f_swap = refine_volume(core, inject_identity(core, f_can, source_id))
    return {"out": warp_decode(core, f_swap, x_can, x_t)}


def swap_with_motion(core: CanonSwapCore, frames: torch.Tensor,
                     source_id: torch.Tensor, *, as_uint8: bool = False):
    """Motion extraction + swap step for one frame batch.

    ``as_uint8`` quantizes the images on the device, clip(255 * v) truncated
    as the JAX package does.  Returns (outputs dict, motion dict)."""
    with torch.inference_mode():
        motion = extract_motion(core, frames)
        out = swap_step(core, frames, source_id, motion)
        if as_uint8:
            out = {k: torch.clamp(v.float() * 255.0, 0, 255).to(torch.uint8)
                   for k, v in out.items()}
    return out, motion
