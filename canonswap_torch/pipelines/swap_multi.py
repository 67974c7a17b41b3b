"""Multi-face video swap: every face found on the first frame is swapped to
the source ID.

The port's counterpart of ``canonswap_tpu/pipelines/swap_multi.py``:
detect up to ``max_faces`` faces on frame 0, track each face's landmarks on
its own, batch each face's crops through the generator, and paste every
swapped face back into the same frames, on the device.
"""

from __future__ import annotations

import os
import os.path as osp

import torch

from canonswap_torch.configs import ArgumentConfig
from canonswap_torch.ops.resize import area_resize_like_cv2
from canonswap_torch.pipelines.session import FaceSwapSession
from canonswap_torch.pipelines.swap_e2e import (batched, upload_clip,
                                                video_ext, write_clip)
from canonswap_torch.utils import geometry as G
from canonswap_torch.utils import io as IO
from canonswap_torch.utils import video as V
from canonswap_torch.utils.rlog import log


def _track_face(session, frames, first_lmk106):
    """One face's landmark track and crops (``Cropper.crop_source_video``
    seeded from this face's 106 points) -> (crops (N, S, S, 3) uint8 on
    the device, M_c2o per frame)."""
    cfg = session.crop_cfg
    nis = session.cropper.network_input_size
    lmk = session.landmark203.run(frames[0], first_lmk106)
    crops, M_c2o_lst = [], []
    for frame in frames:
        lmk = session.landmark203.run(frame, lmk)
        ret = G.crop_image(frame, lmk, dsize=cfg.dsize, scale=cfg.scale,
                           vy_ratio=cfg.vy_ratio,
                           flag_do_rot=cfg.flag_do_rot)
        crops.append(area_resize_like_cv2(ret["img_crop"], (nis, nis)))
        M_c2o_lst.append(ret["M_c2o"])
    return torch.stack(crops), M_c2o_lst


def execute(session: FaceSwapSession, args: ArgumentConfig,
            max_faces: int = 4):
    """Returns the result's path."""
    inf_cfg = session.inference_cfg
    batch = inf_cfg.batch_size

    source_rgb = IO.load_image_rgb(args.source)
    source_id = session.get_source_id(source_rgb)

    output_fps = int(V.get_fps(args.driving))
    frames = upload_clip(V.load_video(args.driving), session.device)
    n_frames, h, w = frames.shape[:3]

    faces = session.face_analysis.get(
        frames[0], flag_do_landmark_2d_106=True, direction="large-small",
        max_face_num=max_faces)
    if not faces:
        raise RuntimeError("No face detected in the first driving frame.")
    log(f"Tracking {len(faces)} faces over {n_frames} frames")

    results = frames.clone()
    for fi, face in enumerate(faces):
        crops, M_c2o_lst = _track_face(session, frames, face.landmark_2d_106)
        swapped, masks = [], []
        for lo, hi, idx in batched(n_frames, batch):
            frames01 = session.prepare_frames(crops[idx])
            out, _ = session.swap_with_motion(frames01, source_id,
                                              as_uint8=True)
            m = session.parse_masks_uint8(crops[idx]).float() / 255.0
            swapped.append(out["out"][:hi - lo])
            masks.append(m[:hi - lo])
        swapped, masks = torch.cat(swapped), torch.cat(masks)
        for t in range(n_frames):
            mask_ori = G.prepare_paste_back(masks[t], M_c2o_lst[t], (w, h),
                                            if_float=True)
            results[t] = G.paste_back(swapped[t], M_c2o_lst[t], results[t],
                                      mask_ori)
        log(f"Face {fi + 1}/{len(faces)} swapped")

    os.makedirs(args.output_dir, exist_ok=True)
    stem = f"{IO.basename(args.source)}--{IO.basename(args.driving)}_multi"
    wfp = osp.join(args.output_dir, f"{stem}{video_ext(args.driving)}")
    write_clip(results.cpu().numpy(), wfp, output_fps, inf_cfg.crf,
               args.driving)
    log(f"Results: {wfp}")
    return wfp
