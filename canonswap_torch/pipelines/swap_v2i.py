"""Video-to-image swap: a driving clip's motion re-animates a swapped
source.

The port's counterpart of ``canonswap_tpu/pipelines/swap_v2i.py`` (the
reference's v2i execute, can_swap_pipeline_v2i.py:184-373): the source
image goes to canonical space, is swapped once with the driving clip's
identity (frame 0's), then re-animated batch by batch with the driving
expressions (``runtime/core.py::reanimate_step``) and pasted back into the
source image, on the device.  As in the JAX package, the appearance
features of the constant swapped source are computed once, not per frame.

Outputs: ``<source>--<driving>`` (the re-animated source) and ``_concat``
(driving crop | re-animated crop) in the driving clip's container, and
``source_can`` / ``swap_can`` (the canonical source and swap) in the
source image's format.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from canonswap_torch.configs import ArgumentConfig
from canonswap_torch.ops.pose import rotation_matrix
from canonswap_torch.ops.resize import bilinear_resize, resize_like_cv2
from canonswap_torch.pipelines.session import FaceSwapSession
from canonswap_torch.pipelines.swap_e2e import (batched, upload_clip,
                                                video_ext, write_clip)
from canonswap_torch.runtime import core as C
from canonswap_torch.utils import geometry as G
from canonswap_torch.utils import io as IO
from canonswap_torch.utils import video as V
from canonswap_torch.utils.rlog import log


def execute(session: FaceSwapSession, args: ArgumentConfig):
    """Returns (result path, concat path)."""
    inf_cfg = session.inference_cfg
    batch = inf_cfg.batch_size
    core = session.core
    dev = session.device

    # 1) source -> canonical (execute_face_canonical, v2i:61-106) ----------
    source_img = IO.load_image_rgb(args.source)
    source_img = IO.resize_to_limit(
        source_img, inf_cfg.source_max_dim, inf_cfg.source_division)
    source = torch.from_numpy(np.ascontiguousarray(source_img)).to(dev)
    crop_info = session.cropper.crop_source_image(source)
    if crop_info is None:
        raise RuntimeError("No face detected in the source image.")
    crop256 = crop_info["img_crop_256x256"]
    source_M_c2o = crop_info["M_c2o"]

    with torch.inference_mode():
        I_s = session.prepare_frames(crop256[None])
        x_s_info = session.motion_template(I_s)
        f_s = C.appearance_features(core, I_s)
        x_s = x_s_info["x_t"].to(f_s.dtype)
        x_d_new = (x_s_info["scale"][..., None] * x_s_info["kp"]).to(
            f_s.dtype)
        f_s_can, occ_map = C.warp_to_canonical(core, f_s, x_s, x_d_new)
        source_can = C.to_uint8(C.conv_decode(core, f_s_can, occ_map))[0]

    # 2) driving clip + crops (v2i:201-238) ---------------------------------
    output_fps = int(V.get_fps(args.driving))
    driving_rgb_lst = V.load_video(args.driving)
    frames = upload_clip(driving_rgb_lst, dev)
    ret_d = session.cropper.crop_source_video(frames)
    if not ret_d["frame_crop_lst"]:
        raise RuntimeError(
            f"No face detected in the driving clip {args.driving}")
    crops = torch.stack(ret_d["frame_crop_lst"])
    n_frames = len(crops)
    log(f"Driving video: {n_frames} frames @ {output_fps} fps")

    # the driving identity from frame 0 (get_driving_id, v2i:135-147)
    driving_id = session.get_source_id(frames[0])

    # 3) swap once in canonical space (v2i:285-304) -------------------------
    s_in = session.model_cfg.input_size
    with torch.inference_mode():
        f_can_swap = C.inject_identity(core, f_s_can, driving_id)
        swap_can = C.conv_decode(core, f_can_swap, occ_map)
        I_can = C.to_uint8(swap_can)[0]
        swap_can_256 = bilinear_resize(swap_can.permute(0, 3, 1, 2),
                                       (s_in, s_in)).permute(0, 2, 3, 1)
        x_swap_info = session.motion_template(swap_can_256)
        x_swap = x_swap_info["x_t"]
        kp_swap = x_swap_info["kp"]
        rot_swap = rotation_matrix(x_s_info["pitch"], x_s_info["yaw"],
                                   x_s_info["roll"])
        t_swap = x_s_info["t"].clone()
        t_swap[..., 2] = 0.0
        scale_swap = x_s_info["scale"]
        # constant over the clip: once (the reference recomputed it per
        # frame, v2i:308)
        f_swap_can_2 = C.appearance_features(core, swap_can_256)

    # the paste-back mask in source-image space (v2i:255-258)
    mask = session.parse_masks(crop256[None])[0]
    mask_ori = G.prepare_paste_back(
        mask, source_M_c2o, (source_img.shape[1], source_img.shape[0]),
        if_float=True)

    # 4) batched re-animation (v2i:260-321) ---------------------------------
    results, concats = [], []
    for lo, hi, idx in batched(n_frames, batch):
        n = hi - lo
        with torch.inference_mode():
            frames01 = session.prepare_frames(crops[idx])
            motion = session.motion_template(frames01)
            out = C.reanimate_step(core, f_swap_can_2, x_swap, kp_swap,
                                   rot_swap, t_swap, scale_swap,
                                   motion["exp"])
        res = C.to_uint8(out[:n])
        side = tuple(res.shape[1:3])
        concats.append(torch.cat([
            torch.stack([resize_like_cv2(c, side) for c in crops[lo:hi]]),
            res], dim=2).cpu().numpy())
        results.append(torch.stack([
            G.paste_back(res[j], source_M_c2o, source, mask_ori)
            for j in range(n)]).cpu().numpy())
        log(f"Re-animated frames {lo}..{hi - 1}")

    # 5) encode --------------------------------------------------------------
    os.makedirs(args.output_dir, exist_ok=True)
    stem = f"{IO.basename(args.source)}--{IO.basename(args.driving)}"
    img_ext = osp.splitext(args.source)[1]
    IO.save_image_rgb(osp.join(args.output_dir, f"source_can{img_ext}"),
                      source_can.cpu().numpy())
    IO.save_image_rgb(osp.join(args.output_dir, f"swap_can{img_ext}"),
                      I_can.cpu().numpy())
    ext = video_ext(args.driving)
    wfp = osp.join(args.output_dir, f"{stem}{ext}")
    write_clip(np.concatenate(results), wfp, output_fps, inf_cfg.crf,
               args.driving)
    wfp_concat = osp.join(args.output_dir, f"{stem}_concat{ext}")
    write_clip(np.concatenate(concats), wfp_concat, output_fps, inf_cfg.crf)
    log(f"Results: {wfp}")
    return wfp, wfp_concat
