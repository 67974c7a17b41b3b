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
from canonswap_torch.runtime.device import resolve_device


class CanonSwapCore(nn.Module):
    """The six generator networks, in eval mode, without gradients."""

    def __init__(self, cfg: CanonSwapModelConfig = CANONICAL,
                 seed: int | None = 0, device: str | torch.device = "cuda"):
        """``seed``: random weights from this seed (no checkpoint ships);
        None leaves PyTorch's default init for a state_dict to replace.
        The weights are made on the CPU, so a seed gives the same weights on
        every device, then moved to ``device`` (the card unless the caller
        asks for the CPU; raises if no card is there)."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        c, d = cfg.appearance.reshape_channel, cfg.appearance.reshape_depth
        self.appearance_feature_extractor = AppearanceFeatureExtractor(
            cfg.appearance)
        self.motion_extractor = MotionExtractor(cfg.motion)
        self.warping_module = WarpingNetwork(cfg.warping)
        self.spade_generator = SPADEDecoder(cfg.spade)
        self.transfer = SwapModule(cfg.swap, c, d)
        # the refine chain runs on the swap chain's volume and takes its
        # int8 flag, as the JAX core does
        self.refine = RefineModule(c, d, cfg.swap.int8_conv)
        if seed is not None:
            init_random_(self, seed)
        self.eval()
        self.requires_grad_(False)
        self.to(device)


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


def conv_decode(core: CanonSwapCore, volume, occlusion_map=None):
    """A volume decoded without a warp (the reference's conv_decode,
    can_swap_e2e.py:309-312): ``warp_out`` (times the occlusion map where
    given), then SPADE -> (B, 2S, 2S, 3).  The canonical debug strips and
    the v2i swap-once path."""
    out = core.warping_module.warp_out(volume, occlusion_map)
    return core.spade_generator(out).permute(0, 2, 3, 1)


def swap_step(core: CanonSwapCore, frames: torch.Tensor,
              source_id: torch.Tensor, motion: dict, *,
              with_debug: bool = False) -> dict:
    """One frame batch: F -> warp to canonical -> swap -> refine -> warp back
    and decode.

    frames: (B, S, S, 3) in [0, 1]; source_id: (1 or B, latent)
    L2-normalized ID embedding; motion: 'kp', 'scale', 'x_t' of these frames.
    ``with_debug`` also decodes the canonical reconstruction and the
    canonical swap, before refine (the reference's debug strips).
    Returns dict(out=(B, 2S, 2S, 3) [, rec_can, swap_can])."""
    b = frames.shape[0]
    if source_id.shape[0] == 1 and b != 1:
        source_id = source_id.expand(b, source_id.shape[1])
    f_s = appearance_features(core, frames)
    # keypoint math arrives in f32; the compute path follows the frame dtype
    x_can = (motion["scale"][..., None] * motion["kp"]).to(frames.dtype)
    x_t = motion["x_t"].to(frames.dtype)
    f_can, occ = warp_to_canonical(core, f_s, x_t, x_can)
    f_swap = inject_identity(core, f_can, source_id)
    out = {}
    if with_debug:
        out["rec_can"] = conv_decode(core, f_can, occ)
        out["swap_can"] = conv_decode(core, f_swap, occ)
    out["out"] = warp_decode(core, refine_volume(core, f_swap), x_can, x_t)
    return out


def reanimate_step(core: CanonSwapCore, volume, x_swap, kp_swap, rot_swap,
                   t_swap, scale_swap, delta_t) -> torch.Tensor:
    """The v2i batch (can_swap_pipeline_v2i.py:260-309): one swapped
    canonical volume re-animated by the driving expressions.

    ``x_t_2 = scale_swap * (kp_swap @ rot_swap + delta_t)`` plus t_swap's
    xy, then ``warp_decode(volume, kp_source=x_swap, kp_driving=x_t_2)``.
    volume: (1, C, D, H, W); x_swap, kp_swap: (1, K, 3); rot_swap:
    (1, 3, 3); t_swap: (1, 3); scale_swap: (1, 1); delta_t: (B, K, 3).
    The keypoint math runs in f32, then follows the volume's dtype; the
    volume and x_swap are broadcast to the batch.  Returns (B, 2S, 2S, 3)."""
    b = delta_t.shape[0]
    f32 = torch.float32
    x_t_2 = scale_swap.to(f32)[..., None] * (
        kp_swap.to(f32) @ rot_swap.to(f32) + delta_t.to(f32))
    x_t_2 = torch.cat([x_t_2[..., :2] + t_swap.to(f32)[:, None, :2],
                       x_t_2[..., 2:]], dim=-1)
    vol = volume.expand(b, *volume.shape[1:])
    x_swap_b = x_swap.expand(b, *x_swap.shape[1:])
    return warp_decode(core, vol, x_swap_b.to(vol.dtype),
                       x_t_2.to(vol.dtype))


def adjust_driving_kp(stitching, x_t: torch.Tensor,
                      eye_ratio: torch.Tensor | None = None,
                      lip_ratio: torch.Tensor | None = None, *,
                      use_stitching: bool = False,
                      normalize_lip: bool = False,
                      lip_normalize_threshold: float = 0.03) -> torch.Tensor:
    """Eye and lip retargeting and stitching on the posed driving keypoints
    (``canonswap_tpu/runtime/core.py::adjust_driving_kp``): the eye net's
    delta from the (B, 3) eye ratio, then the lip net's from the (B, 2) lip
    ratio, zeroed per row where ``normalize_lip`` and the ratio's second
    (driving) column is below ``lip_normalize_threshold``, then the
    stitching net from the original and the modified keypoints.
    ``stitching``: a :class:`~canonswap_torch.models.stitching.StitchingModule`."""
    dt = x_t.dtype
    x_new = x_t
    if eye_ratio is not None:
        x_new = x_new + stitching.retarget_eye(x_t, eye_ratio.to(dt))
    if lip_ratio is not None:
        lr = lip_ratio.to(dt)
        delta = stitching.retarget_lip(x_t, lr)
        if normalize_lip:
            gate = (lr[:, 1:2] >= lip_normalize_threshold).to(dt)
            delta = delta * gate[:, :, None]
        x_new = x_new + delta
    if use_stitching:
        x_new = stitching.stitch(x_t, x_new)
    return x_new


def swap_with_motion(core: CanonSwapCore, frames: torch.Tensor,
                     source_id: torch.Tensor, *, stitching=None,
                     eye_ratio: torch.Tensor | None = None,
                     lip_ratio: torch.Tensor | None = None,
                     use_stitching: bool = False, normalize_lip: bool = False,
                     with_debug: bool = False, as_uint8: bool = False):
    """Motion extraction + swap step for one frame batch.

    ``stitching`` with ``use_stitching`` or a ratio swaps at the adjusted
    keypoints (:func:`adjust_driving_kp`).  The motion returned is the
    extracted one, x_t unadjusted: a template dumped from it and adjusted
    again on the cached run swaps as this run did (the JAX package returns
    the adjusted x_t, so its cached run adjusts twice).
    ``with_debug`` adds the canonical strips (:func:`swap_step`);
    ``as_uint8`` quantizes the images on the device, clip(255 * v)
    truncated as the JAX package does.  Returns (outputs dict, motion
    dict)."""
    with torch.inference_mode():
        motion = extract_motion(core, frames)
        swap_motion = motion
        if stitching is not None and (use_stitching or eye_ratio is not None
                                      or lip_ratio is not None):
            swap_motion = dict(motion, x_t=adjust_driving_kp(
                stitching, motion["x_t"], eye_ratio, lip_ratio,
                use_stitching=use_stitching, normalize_lip=normalize_lip))
        out = swap_step(core, frames, source_id, swap_motion,
                        with_debug=with_debug)
        if as_uint8:
            out = {k: to_uint8(v) for k, v in out.items()}
    return out, motion


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> uint8 on their device: clip(255 v) in f32, then
    truncated, as the JAX package quantizes."""
    return torch.clamp(x.float() * 255.0, 0, 255).to(torch.uint8)
