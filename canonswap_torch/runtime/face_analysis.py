"""Face analysis: detection, 106-point landmarks, aligned ID crops, and the
source identity.

Port of ``canonswap_tpu/runtime/face_analysis.py`` (the reference's
FaceAnalysisDIY, face_analysis_diy.py:35-79, and Face_detect_crop,
insightface_func/face_detect_crop_{single,multi}.py) and of the session's
source-ID step (``canonswap_tpu/pipelines/session.py:286-300``).  SCRFD and
its fixed-capacity decode run on the device, and the detections come to
the host in one copy; sorting and the alignment geometry run on the host.
The JAX version's ``det_onnx`` branch (a real det_10g.onnx through its ONNX
executor) has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from canonswap_torch.models import scrfd as S
from canonswap_torch.models.arcface import ArcFaceRunner
from canonswap_torch.models.landmark import Landmark106Runner
from canonswap_torch.nn.init import init_random_
from canonswap_torch.runtime.device import on_device, resolve_device
from canonswap_torch.utils import face_align as FA
from canonswap_torch.utils.geometry import warp_affine

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class Face:
    bbox: np.ndarray  # (4,) x1y1x2y2 in image pixels
    kps: np.ndarray  # (5, 2)
    det_score: float
    landmark_2d_106: np.ndarray | None = None


def sort_faces(faces: list[Face], direction: str = "large-small",
               face_center=None) -> list[Face]:
    """The reference's sort_by_direction (face_analysis_diy.py:14-32)."""
    if not faces:
        return faces
    if direction == "left-right":
        return sorted(faces, key=lambda f: f.bbox[0])
    if direction == "right-left":
        return sorted(faces, key=lambda f: f.bbox[0], reverse=True)
    if direction == "top-bottom":
        return sorted(faces, key=lambda f: f.bbox[1])
    if direction == "bottom-top":
        return sorted(faces, key=lambda f: f.bbox[1], reverse=True)

    def area(f):
        return (f.bbox[2] - f.bbox[0]) * (f.bbox[3] - f.bbox[1])

    if direction == "small-large":
        return sorted(faces, key=area)
    if direction == "large-small":
        return sorted(faces, key=area, reverse=True)
    if direction == "distance-from-retarget-face" and face_center is not None:
        def dist(f):
            cx = (f.bbox[2] + f.bbox[0]) / 2 - face_center[0]
            cy = (f.bbox[3] + f.bbox[1]) / 2 - face_center[1]
            return (cx**2 + cy**2) ** 0.5
        return sorted(faces, key=dist)
    return faces


class FaceAnalysis:
    """SCRFD, and the 106-point landmarks of each face where a runner is
    given, with the faces sorted by direction.

    Args:
      det_state_dict: SCRFD's weights (``runtime/weights.py::
        scrfd_from_jax``), or None for seeded random weights.
      lmk106: the 106-point runner, or None for detection alone.
      det_size: the detector's input (w, h); the letterbox's target.
      det_thresh: the score threshold.
      seed: the random weights' seed.
      device: where the detector runs; the card unless the caller asks for
        the CPU (raises if no card is there).
    """

    def __init__(self, det_state_dict: dict | None = None,
                 lmk106: Landmark106Runner | None = None,
                 det_size: tuple[int, int] = (512, 512),
                 det_thresh: float = 0.5, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.det_size = tuple(det_size)
        self.det_thresh = det_thresh
        self.lmk106 = lmk106
        model = S.SCRFD()
        if det_state_dict is None:
            init_random_(model, seed)  # on the CPU: one seed, one model
        else:
            model.load_state_dict(det_state_dict, strict=True)
        self.det_model = model.eval().requires_grad_(False).to(self.device)

    def detect(self, img, max_num: int = 0):
        """One frame (numpy or tensor) -> (bboxes (N, 5) with the score
        last, kpss (N, 5, 2)) in image pixels, by descending score.  The
        letterbox, SCRFD and the decode run on the device."""
        blob, det_scale = S.preprocess(on_device(img, self.device),
                                       self.det_size)
        # decode_scrfd takes input_size as (h, w): the JAX call passes
        # det_size, and a square det_size makes the two agree
        res = S.detect(self.det_model, blob, input_size=self.det_size,
                       score_thresh=self.det_thresh)
        packed = torch.cat([
            res["bboxes"][0], res["kps"][0].flatten(1),
            res["scores"][0][:, None], res["valid"][0][:, None].float(),
        ], dim=1).cpu().numpy()  # the one copy to the host
        kept = packed[packed[:, 15] > 0]
        boxes = kept[:, :4] / det_scale
        kps = kept[:, 4:14].reshape(-1, 5, 2) / det_scale
        scores = kept[:, 14]
        order = np.argsort(-scores)
        boxes, scores, kps = boxes[order], scores[order], kps[order]
        if max_num > 0:
            boxes, scores, kps = boxes[:max_num], scores[:max_num], \
                kps[:max_num]
        return np.concatenate([boxes, scores[:, None]], axis=1), kps

    def get(self, img, flag_do_landmark_2d_106: bool = True,
            direction: str = "large-small",
            max_face_num: int = 0) -> list[Face]:
        img = on_device(img, self.device)
        bboxes, kpss = self.detect(img, max_num=max_face_num)
        faces = []
        for i in range(bboxes.shape[0]):
            face = Face(bbox=bboxes[i, :4], kps=kpss[i],
                        det_score=float(bboxes[i, 4]))
            if flag_do_landmark_2d_106 and self.lmk106 is not None:
                face.landmark_2d_106 = self.lmk106.get(img, face.bbox)
            faces.append(face)
        return sort_faces(faces, direction)

    def warmup(self):
        self.get(np.zeros((*self.det_size[::-1], 3), np.uint8))


class FaceIDCropper:
    """Detection + 5-point multiview alignment for ArcFace ID crops (the
    reference's Face_detect_crop, face_detect_crop_single.py:63-82 /
    _multi.py:79-100); crops are uint8 tensors on the detector's device."""

    def __init__(self, analysis: FaceAnalysis, mode: str = "newarc"):
        self.analysis = analysis
        self.mode = mode

    def get_single(self, img, crop_size: int = 112, max_num: int = 0):
        """The best-scoring face -> ([crop], [M]), or None."""
        img = on_device(img, self.analysis.device)
        bboxes, kpss = self.analysis.detect(img, max_num=max_num)
        if bboxes.shape[0] == 0:
            return None
        best = int(np.argmax(bboxes[:, 4]))
        M, _ = FA.estimate_norm_multiview(kpss[best], crop_size, self.mode)
        return [warp_affine(img, M, crop_size)], [M]

    def get_multi(self, img, crop_size: int = 112, max_num: int = 0):
        """Every face -> (crops, Ms), or None."""
        img = on_device(img, self.analysis.device)
        bboxes, kpss = self.analysis.detect(img, max_num=max_num)
        if bboxes.shape[0] == 0:
            return None
        crops, Ms = [], []
        for i in range(bboxes.shape[0]):
            M, _ = FA.estimate_norm_multiview(kpss[i], crop_size, self.mode)
            crops.append(warp_affine(img, M, crop_size))
            Ms.append(M)
        return crops, Ms


def id_blob(crop: torch.Tensor) -> torch.Tensor:
    """A (112, 112, 3) uint8 ID crop -> (1, 3, 112, 112) ImageNet-normalized
    f32, as the session computes it."""
    mean = torch.tensor(IMAGENET_MEAN, device=crop.device)
    std = torch.tensor(IMAGENET_STD, device=crop.device)
    return ((crop.float() / 255.0 - mean) / std).permute(2, 0, 1)[None]


def source_id(id_cropper: FaceIDCropper, arcface: ArcFaceRunner, img,
              latent_dim: int = 512) -> torch.Tensor:
    """The source image -> its (1, latent_dim) L2-normalized ID embedding on
    ArcFace's device (the session's get_source_id, can_swap_pipeline_e2e.py:
    90-99): the best face's 112 multiview crop, ImageNet normalization,
    ArcFace, the embedding cut to ``latent_dim`` where it is wider (reduced
    test configurations), L2 normalization.  Raises if no face is found."""
    got = id_cropper.get_single(img, crop_size=112, max_num=1)
    if got is None:
        raise RuntimeError("No face detected in the source image.")
    emb = arcface.embed(id_blob(got[0][0]))
    if emb.shape[-1] != latent_dim:
        emb = emb[..., :latent_dim]
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
