"""End-to-end video face swap (the flagship path).

The port's counterpart of ``canonswap_tpu/pipelines/swap_e2e.py`` (the
reference's CanSwapPipeline.execute, can_swap_pipeline_e2e.py:137-350),
step for step: the source ID; the driving clip (uploaded to the device
once); the tracking crop, or on a square clip without ``--flag-crop-
driving-video`` the resize and the blend; the eye and lip ratios; the
motion template cached beside the driving file; batches padded to the
batch size by repeating the last frame; the swap with its canonical debug
strips, parsing, quantization and the paste-back on the device; one copy
of each batch to the host.

Outputs: ``<output_dir>/<source>--<driving>`` (the pasted-back result) and
``..._concat`` (driving crop | canonical swap | result | canonical
reconstruction), in the driving file's container: ``.npy`` for a ``.npy``
clip, ``.mp4`` for a codec container, and an image target's own format.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from canonswap_torch.configs import ArgumentConfig
from canonswap_torch.ops.affine import blend_images
from canonswap_torch.ops.resize import resize_like_cv2
from canonswap_torch.pipelines.session import FaceSwapSession
from canonswap_torch.runtime.core import to_uint8
from canonswap_torch.utils import geometry as G
from canonswap_torch.utils import io as IO
from canonswap_torch.utils import video as V
from canonswap_torch.utils.ratios import (calc_eye_close_ratio,
                                          calc_lip_close_ratio)
from canonswap_torch.utils.rlog import log
from canonswap_torch.utils.timing import StageTimer


def batched(n: int, batch: int):
    """(lo, hi, idx) per batch of ``batch`` frames: ``idx`` the frame
    indices lo..hi-1, padded to ``batch`` by repeating the last, so every
    generator call has one shape."""
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        idx = np.arange(lo, hi)
        if len(idx) < batch:
            idx = np.concatenate([idx, np.full(batch - len(idx), hi - 1)])
        yield lo, hi, idx


def upload_clip(frames_rgb: list, device: torch.device) -> torch.Tensor:
    """A decoded clip (frames (H, W, 3) uint8) as one (N, H, W, 3) tensor on
    the device: the one upload."""
    if not frames_rgb:
        raise ValueError("the driving clip has no frames")
    return torch.from_numpy(np.stack(frames_rgb)).to(device)


def write_clip(frames, path: str, fps: float, crf: int,
               audio_src: str | None = None) -> None:
    """Encode (N, H, W, 3) uint8 frames to ``path``; mux ``audio_src``'s
    audio in where ffmpeg finds a stream (the reference's audio priority
    "driving")."""
    V.images2video(frames, path, fps=fps, crf=crf)
    if audio_src is not None and V.has_audio_stream(audio_src):
        tmp = path + ".audio.mp4"
        if V.add_audio_to_video(path, audio_src, tmp):
            os.replace(tmp, path)


def video_ext(driving: str) -> str:
    """Outputs take the driving file's container: ``.npy`` or ``.mp4``."""
    return ".npy" if V.is_npy(driving) else ".mp4"


def execute(session: FaceSwapSession, args: ArgumentConfig,
            timer: StageTimer | None = None):
    """Returns (result path, concat path).  ``timer`` collects the stages'
    host-clock times (each ends in a synchronize)."""
    inf_cfg = session.inference_cfg
    batch = inf_cfg.batch_size
    dev = session.device
    timer = timer or StageTimer()
    sync = session.synchronize

    # 1) source identity ---------------------------------------------------
    log("Get source ID...")
    with timer.stage("source_id", sync=sync):
        source_rgb = IO.load_image_rgb(args.source)
        source_id = session.get_source_id(source_rgb)

    # 2) driving load + crop ----------------------------------------------
    with timer.stage("load", sync=sync):
        flag_is_video = IO.is_video(args.driving)
        if flag_is_video:
            output_fps = int(V.get_fps(args.driving))
            driving_rgb_lst = V.load_video(args.driving)
            log(f"Loaded driving video: {args.driving} "
                f"({len(driving_rgb_lst)} frames @ {output_fps} fps)")
        elif IO.is_image(args.driving):
            driving_rgb_lst = [IO.load_image_rgb(args.driving)]
            output_fps = 25
        else:
            raise ValueError(f"{args.driving} is not a supported type!")
        frames = upload_clip(driving_rgb_lst, dev)
    n_frames, h0, w0 = frames.shape[:3]
    with timer.stage("crop", items=n_frames, sync=sync):
        if inf_cfg.flag_crop_driving_video or h0 != w0:
            ret_d = session.cropper.crop_source_video(frames)
            n_frames = min(n_frames, len(ret_d["frame_crop_lst"]))
            if n_frames == 0:
                raise RuntimeError(
                    f"No face detected in the driving clip {args.driving}")
            crops = torch.stack(ret_d["frame_crop_lst"][:n_frames])
            lmk_crop_lst = ret_d["lmk_crop_lst"][:n_frames]
            M_c2o_lst = ret_d["M_c2o_lst"][:n_frames]
            log(f"Driving video cropped: {n_frames} frames")
        else:
            lmk_crop_lst = session.cropper.calc_lmks_from_cropped_video(
                frames)
            nis = session.cropper.network_input_size
            crops = torch.stack([resize_like_cv2(f, (nis, nis))
                                 for f in frames])
            M_c2o_lst = None  # no crop -> no paste-back transform

    # 3) eye/lip ratios (motion template metadata) ------------------------
    c_d_eyes_lst = [calc_eye_close_ratio(lmk[None]) for lmk in lmk_crop_lst]
    c_d_lip_lst = [calc_lip_close_ratio(lmk[None]) for lmk in lmk_crop_lst]

    # 4) motion template, cached on disk beside the driving clip ----------
    template_path = (osp.splitext(args.driving)[0] + ".pkl"
                     if flag_is_video else None)
    motion_all = None
    if template_path and osp.exists(template_path):
        cached = IO.load(template_path)
        if cached.get("n_frames") == n_frames:
            motion_all = {k: np.asarray(v)
                          for k, v in cached["motion"].items()}
            log(f"Loaded motion template from {template_path}")
    # Kalman smoothing needs the whole sequence: the template first, then
    # the swap
    if (inf_cfg.flag_smooth_motion and flag_is_video and n_frames > 1
            and motion_all is None):
        from canonswap_torch.utils.smoothing import smooth

        chunks = []
        for lo, hi, idx in batched(n_frames, batch):
            m = session.motion_template(session.prepare_frames(crops[idx]))
            chunks.append({k: v[:hi - lo].cpu().numpy()
                           for k, v in m.items()})
        motion_all = {k: smooth(np.concatenate([c[k] for c in chunks]))
                      for k in chunks[0]}
        log("Motion template Kalman-smoothed")

    use_fused = motion_all is None  # no template: motion + swap per batch
    motion_chunks = []

    # 5..6) batched swap, parsing, paste-back -----------------------------
    do_pstbk = (inf_cfg.flag_pasteback and inf_cfg.flag_do_crop
                and M_c2o_lst is not None)
    results, concats = [], []
    for lo, hi, idx in batched(n_frames, batch):
        n = hi - lo
        with timer.stage("generator", items=n, sync=sync):
            crops_b = crops[idx]
            frames01 = session.prepare_frames(crops_b)
            if use_fused:
                out, motion = session.swap_with_motion(
                    frames01, source_id, with_debug=True)
                motion_chunks.append({k: v[:n].cpu().numpy()
                                      for k, v in motion.items()})
            else:
                out = session.swap_batch(
                    frames01, source_id,
                    {k: v[idx] for k, v in motion_all.items()},
                    with_debug=True)
        with timer.stage("parsing", items=n, sync=sync):
            masks = session.parse_masks(crops_b)
        with timer.stage("paste_back", items=n, sync=sync):
            if not do_pstbk:
                # blend the output with the input crop through the mask
                # (can_swap_pipeline_e2e.py:269, crop.py:93-96)
                out = dict(out, out=blend_images(out["out"], frames01.float(),
                                                 masks))
            res = to_uint8(out["out"][:n])
            side = tuple(res.shape[1:3])
            concat = torch.cat([
                torch.stack([resize_like_cv2(c, side) for c in crops_b[:n]]),
                to_uint8(out["swap_can"][:n]), res,
                to_uint8(out["rec_can"][:n])], dim=2)
            if do_pstbk:
                pasted = []
                for j in range(n):
                    m_c2o = M_c2o_lst[lo + j]
                    mask_ori = G.prepare_paste_back(
                        masks[j], m_c2o, (w0, h0), if_float=True)
                    pasted.append(G.paste_back(res[j], m_c2o, frames[lo + j],
                                               mask_ori))
                res = torch.stack(pasted)
        with timer.stage("download", items=n, sync=sync):
            results.append(res.cpu().numpy())
            concats.append(concat.cpu().numpy())
        log(f"Swapped frames {lo}..{hi - 1}")

    if use_fused and motion_chunks and template_path:
        motion_all = {k: np.concatenate([c[k] for c in motion_chunks])
                      for k in motion_chunks[0]}
        try:
            IO.dump(template_path, {
                "n_frames": n_frames, "output_fps": output_fps,
                "motion": motion_all, "c_eyes_lst": c_d_eyes_lst,
                "c_lip_lst": c_d_lip_lst})
            log(f"Dumped motion template to {template_path}")
        except OSError as e:  # a read-only driving directory
            log(f"Motion template not dumped: {e}")

    # 7) encode ------------------------------------------------------------
    os.makedirs(args.output_dir, exist_ok=True)
    stem = f"{IO.basename(args.source)}--{IO.basename(args.driving)}"
    results = np.concatenate(results)
    concats = np.concatenate(concats)
    with timer.stage("encode", items=n_frames):
        if flag_is_video:
            ext = video_ext(args.driving)
            wfp_concat = osp.join(args.output_dir, f"{stem}_concat{ext}")
            write_clip(concats, wfp_concat, output_fps, inf_cfg.crf)
            wfp = osp.join(args.output_dir, f"{stem}{ext}")
            write_clip(results, wfp, output_fps, inf_cfg.crf, args.driving)
            log(f"Results: {wfp}")
            log(f"Results with concat: {wfp_concat}")
        else:
            ext = osp.splitext(args.driving)[1]
            wfp_concat = osp.join(args.output_dir, f"{stem}_concat{ext}")
            IO.save_image_rgb(wfp_concat, concats[0])
            wfp = osp.join(args.output_dir, f"{stem}{ext}")
            IO.save_image_rgb(wfp, results[0])
            log(f"Swapped image: {wfp}")
    return wfp, wfp_concat
