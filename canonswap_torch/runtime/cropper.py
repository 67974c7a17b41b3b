"""Crop orchestration with frame-to-frame landmark tracking.

Port of ``canonswap_tpu/runtime/cropper.py`` (the reference's Cropper,
src/utils/cropper.py:43-369): frame 0 runs detection and the 106-point
landmarks, every frame is refined by the 203-point net tracking from the
previous frame's points, then the eye-lip similarity crop is taken and
resized to the network's input by area.  On a miss after the first face,
the previous frame's landmarks are reused (cropper.py:190).  Animal faces
(``image_type="animal_face"``) take their landmarks from the port's
``XPoseRunner`` instead.

Each frame is uploaded once: the detector, the landmark runners and the
crop all take the same device tensor.  Crops come back as uint8 tensors on
the device, the transforms (``M_c2o``, ``M_o2c``) and landmarks in numpy.
"""

from __future__ import annotations

import dataclasses

import torch

from canonswap_torch.configs import CropConfig
from canonswap_torch.models.landmark import Landmark203Runner
from canonswap_torch.ops.resize import area_resize_like_cv2
from canonswap_torch.runtime.device import on_device, resolve_device
from canonswap_torch.runtime.face_analysis import FaceAnalysis
from canonswap_torch.utils import geometry as G


@dataclasses.dataclass
class Trajectory:
    start: int = -1
    end: int = -1
    lmk_lst: list = dataclasses.field(default_factory=list)
    lmk_crop_lst: list = dataclasses.field(default_factory=list)
    frame_rgb_lst: list = dataclasses.field(default_factory=list)
    frame_rgb_crop_lst: list = dataclasses.field(default_factory=list)
    bbox_lst: list = dataclasses.field(default_factory=list)
    M_c2o_lst: list = dataclasses.field(default_factory=list)
    M_o2c_lst: list = dataclasses.field(default_factory=list)


class Cropper:
    """Args:
      crop_cfg: the crop geometry.
      face_analysis: SCRFD with the 106-point runner (human faces).
      landmark_runner: the 203-point tracker.
      network_input_size: the side of the crops handed to the generator.
      image_type: ``human_face`` or ``animal_face``.
      animal_landmark_runner: an ``XPoseRunner``, needed for animal faces.
      device: where frames are uploaded and cropped; the card unless the
        caller asks for the CPU (raises if no card is there).
    """

    def __init__(self, crop_cfg: CropConfig, face_analysis: FaceAnalysis,
                 landmark_runner: Landmark203Runner,
                 network_input_size: int = 256,
                 image_type: str = "human_face",
                 animal_landmark_runner=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.crop_cfg = crop_cfg
        self.face_analysis = face_analysis
        self.landmark_runner = landmark_runner
        self.network_input_size = network_input_size
        self.image_type = image_type
        self.animal_landmark_runner = animal_landmark_runner
        if image_type == "animal_face" and animal_landmark_runner is None:
            raise ValueError(
                "image_type='animal_face' needs an XPoseRunner "
                "(models/xpose) with its CLIP embeddings")

    def _detect_lmk(self, frame: torch.Tensor):
        if self.image_type == "animal_face":
            # 'animal_face_9' -> the 9-point prompt, 'animal_face_68' -> the
            # 68-point 'face' prompt (cropper.py:128-140)
            n = 9 if self.crop_cfg.animal_face_type == "animal_face_9" \
                else 68
            return self.animal_landmark_runner.run(
                frame, num_keypoints=n, box_threshold=0.0, iou_threshold=0.0)
        faces = self.face_analysis.get(
            frame, flag_do_landmark_2d_106=True,
            direction=self.crop_cfg.direction,
            max_face_num=self.crop_cfg.max_face_num)
        if not faces:
            return None
        return faces[0].landmark_2d_106

    def _resize(self, crop: torch.Tensor) -> torch.Tensor:
        nis = self.network_input_size
        return area_resize_like_cv2(crop, (nis, nis))

    def _track(self, frame: torch.Tensor, traj: Trajectory, idx: int):
        """This frame's landmarks for the video crops: detected on the first
        frame with a face, tracked after (human faces; the 203-point
        tracker is a human-face net) or detected again every frame, with
        the previous frame's on a miss (animal faces); None while no face
        was found."""
        if idx == 0 or traj.start == -1:
            lmk106 = self._detect_lmk(frame)
            if lmk106 is None:
                return None
            traj.start = idx
            traj.end = idx
            if self.image_type == "human_face":
                return self.landmark_runner.run(frame, lmk106)
            return lmk106
        traj.end = idx
        if self.image_type == "human_face":
            return self.landmark_runner.run(frame, traj.lmk_lst[-1])
        lmk = self._detect_lmk(frame)
        return traj.lmk_lst[-1] if lmk is None else lmk

    def crop_source_image(self, img_rgb, lmk=None):
        """One image's crop (cropper.py:95-164), or None if no face."""
        cfg = self.crop_cfg
        img = on_device(img_rgb, self.device)
        if lmk is None:
            lmk = self._detect_lmk(img)
            if lmk is None:
                return None
        ret = G.crop_image(img, lmk, dsize=cfg.dsize, scale=cfg.scale,
                           vx_ratio=cfg.vx_ratio, vy_ratio=cfg.vy_ratio,
                           flag_do_rot=cfg.flag_do_rot)
        nis = self.network_input_size
        ret["img_crop_256x256"] = self._resize(ret["img_crop"])
        if self.image_type == "human_face":
            # the 203-point refinement is a human-face net; animal faces
            # keep the XPose landmarks (cropper.py:158-165)
            lmk = self.landmark_runner.run(img, lmk)
            ret["lmk_crop"] = lmk
            ret["lmk_crop_256x256"] = lmk * nis / cfg.dsize
        else:
            ret["lmk_crop"] = lmk
        return ret

    def crop_source_video(self, frames_rgb,
                          crop_cfg: CropConfig | None = None):
        """The tracking crop over a frame sequence (cropper.py:167-222)."""
        cfg = crop_cfg or self.crop_cfg
        nis = self.network_input_size
        traj = Trajectory()
        for idx, frame_rgb in enumerate(frames_rgb):
            frame = on_device(frame_rgb, self.device)
            lmk = self._track(frame, traj, idx)
            if lmk is None:
                continue
            traj.lmk_lst.append(lmk)
            ret = G.crop_image(frame, lmk, dsize=cfg.dsize, scale=cfg.scale,
                               vx_ratio=cfg.vx_ratio, vy_ratio=cfg.vy_ratio,
                               flag_do_rot=cfg.flag_do_rot)
            traj.frame_rgb_crop_lst.append(self._resize(ret["img_crop"]))
            traj.lmk_crop_lst.append(lmk * nis / cfg.dsize)
            traj.M_c2o_lst.append(ret["M_c2o"])
            traj.M_o2c_lst.append(ret["M_o2c"])
        return {
            "frame_crop_lst": traj.frame_rgb_crop_lst,
            "lmk_crop_lst": traj.lmk_crop_lst,
            "M_c2o_lst": traj.M_c2o_lst,
            "M_o2c_lst": traj.M_o2c_lst,
        }

    def crop_driving_video(self, driving_rgb_lst, dsize: int = 512):
        """The averaged-box crop of a driving video (cropper.py:225-283):
        landmarks per frame, the mean of the per-frame face boxes (the
        ``*_crop_driving_video`` knobs), then every frame cropped by that
        one axis-aligned box."""
        cfg = self.crop_cfg
        traj = Trajectory()
        for idx, frame_rgb in enumerate(driving_rgb_lst):
            frame = on_device(frame_rgb, self.device)
            lmk = self._track(frame, traj, idx)
            if lmk is None:
                continue
            traj.lmk_lst.append(lmk)
            box = G.parse_bbox_from_landmark(
                lmk, scale=cfg.scale_crop_driving_video,
                vx_ratio=cfg.vx_ratio_crop_driving_video,
                vy_ratio=cfg.vy_ratio_crop_driving_video)["bbox"]
            traj.bbox_lst.append([box[0, 0], box[0, 1], box[2, 0],
                                  box[2, 1]])
            traj.frame_rgb_lst.append(frame)
        global_bbox = G.average_bbox(traj.bbox_lst)
        for frame, lmk in zip(traj.frame_rgb_lst, traj.lmk_lst):
            ret = G.crop_image_by_bbox(frame, global_bbox, lmk=lmk,
                                       dsize=dsize)
            traj.frame_rgb_crop_lst.append(ret["img_crop"])
            traj.lmk_crop_lst.append(ret["lmk_crop"])
        return {
            "frame_crop_lst": traj.frame_rgb_crop_lst,
            "lmk_crop_lst": traj.lmk_crop_lst,
            "M_c2o_lst": [],
        }

    def crop_video_with_mo2c(self, frames_rgb, mo2c_lst,
                             crop_cfg: CropConfig | None = None):
        """Crop a video by per-frame original-to-crop transforms computed
        before (cropper.py:285-341), tracking landmarks as usual, so that two
        videos stay aligned pixel for pixel."""
        cfg = crop_cfg or self.crop_cfg
        nis = self.network_input_size
        traj = Trajectory()
        for idx, frame_rgb in enumerate(frames_rgb):
            frame = on_device(frame_rgb, self.device)
            lmk = self._track(frame, traj, idx)
            if lmk is None:
                continue
            traj.lmk_lst.append(lmk)
            ret = G.crop_image_mo2c(frame, lmk, mo2c_lst[idx],
                                    dsize=cfg.dsize)
            traj.frame_rgb_crop_lst.append(self._resize(ret["img_crop"]))
            traj.lmk_crop_lst.append(lmk * nis / cfg.dsize)
            traj.M_c2o_lst.append(ret["M_c2o"])
            traj.M_o2c_lst.append(ret["M_o2c"])
        return {
            "frame_crop_lst": traj.frame_rgb_crop_lst,
            "lmk_crop_lst": traj.lmk_crop_lst,
            "M_c2o_lst": traj.M_c2o_lst,
            "M_o2c_lst": traj.M_o2c_lst,
        }

    def calc_lmks_from_cropped_video(self, frames_rgb):
        """Landmark tracking alone (cropper.py:343-369); raises if the first
        frame has no face, as the reference does."""
        traj = Trajectory()
        for idx, frame_rgb in enumerate(frames_rgb):
            frame = on_device(frame_rgb, self.device)
            if idx == 0 or traj.start == -1:
                lmk106 = self._detect_lmk(frame)
                if lmk106 is None:
                    raise RuntimeError(
                        f"No face detected in the frame #{idx}")
                lmk = self.landmark_runner.run(frame, lmk106)
                traj.start, traj.end = idx, idx
            else:
                lmk = self.landmark_runner.run(frame, traj.lmk_lst[-1])
                traj.end = idx
            traj.lmk_lst.append(lmk)
        return traj.lmk_lst
