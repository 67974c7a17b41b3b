"""XPoseRunner: animal-landmark inference with UniPose.

Port of ``canonswap_tpu/models/xpose/runner.py`` (the reference's
src/utils/animal_landmark_runner.py:25-138).  An image is resized with its
short side to 800 (long side at most 1333) and letterboxed into a fixed
canvas with a padding mask, normalized with the ImageNet statistics; the
CLIP text embeddings come in as arrays, or from the reference's pickles
(clip_embedding_{9,68}.pkl) where they exist.

The resize runs in torch on the runner's device
(``ops/resize.py::resize_like_cv2``), at most one grey level (1/255 before
the normalization) from ``cv2.resize(INTER_LINEAR)``; the canvas is
otherwise the JAX runner's.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from canonswap_torch.models.xpose.unipose import UniPose, UniPoseConfig
from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.resize import resize_like_cv2
from canonswap_torch.runtime.device import on_device, resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_thr: float):
    """Greedy NMS, highest score first; returns the kept indices."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _iou_xyxy(boxes[i][None], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_thr]
    return np.asarray(keep, np.int64)


class XPoseRunner:
    """Open-vocabulary keypoint detection on a fixed canvas.

    Args:
      state_dict: the port's UniPose weights (``convert.unipose_from_jax``),
        or None for seeded random weights (no checkpoint ships).
      embeddings_cache_path: prefix of the CLIP embedding pickles; the
        reference ships clip_embedding_9.pkl / _68.pkl (ins, kpt) tuples.
      canvas: (H, W) input canvas (reference: short side 800, long side
        <= 1333 -> (800, 1344) covers every aspect it sees).
      seed: the random weights' seed.
      device: where the model runs; the card unless the caller asks for the
        CPU (raises if no card is there).
    """

    def __init__(self, state_dict: dict | None = None,
                 embeddings_cache_path: str | None = None,
                 cfg: UniPoseConfig = UniPoseConfig(),
                 canvas: tuple[int, int] = (800, 1344),
                 max_text_len: int = 350, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.canvas = canvas
        self.max_text_len = max_text_len
        self.embeddings: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if embeddings_cache_path:
            for n in (9, 68):
                with open(f"{embeddings_cache_path}_{n}.pkl", "rb") as f:
                    ins, kpt = pickle.load(f)
                self.embeddings[n] = (np.asarray(ins, np.float32),
                                      np.asarray(kpt, np.float32))
        model = UniPose(cfg)
        if state_dict is None:
            init_random_(model, seed)  # on the CPU: one seed, one model
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().requires_grad_(False).to(self.device)

    def preprocess(self, img_rgb):
        """uint8 RGB (H, W, 3), numpy or tensor -> (canvas (1, ch, cw, 3),
        mask (1, ch, cw), (nh, nw)) on the runner's device, short side 800
        capped by the canvas (animal_landmark_runner.py:52-60)."""
        h0, w0 = img_rgb.shape[:2]
        ch, cw = self.canvas
        scale = min(800.0 / min(h0, w0), 1333.0 / max(h0, w0))
        scale = min(scale, ch / h0, cw / w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        img = on_device(img_rgb, self.device)
        resized = resize_like_cv2(img, (nh, nw)).float()
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        std = torch.tensor(IMAGENET_STD, device=self.device)
        canvas = torch.zeros((1, ch, cw, 3), device=self.device)
        canvas[0, :nh, :nw] = (resized / 255.0 - mean) / std
        mask = torch.ones((1, ch, cw), dtype=torch.bool, device=self.device)
        mask[0, :nh, :nw] = False
        return canvas, mask, (nh, nw)

    def _text_inputs(self, num_keypoints: int, ins_embed, kpt_embed):
        if ins_embed is None or kpt_embed is None:
            ins_embed, kpt_embed = self.embeddings[num_keypoints]
        k, t = self.cfg.num_body_points, self.max_text_len
        ins = np.zeros((t, 512), np.float32)
        ins[: ins_embed.shape[0]] = ins_embed
        kpt = np.zeros((k, 512), np.float32)
        kpt[: kpt_embed.shape[0]] = kpt_embed[:k]
        kvis = np.zeros((k,), np.float32)
        kvis[: kpt_embed.shape[0]] = 1.0
        tmask = np.zeros((t,), bool)
        tmask[: ins_embed.shape[0]] = True
        pos_ids = tmask.astype(np.float32)
        return [torch.from_numpy(a)[None].to(self.device)
                for a in (ins, tmask, pos_ids, kpt, kvis)]

    def predict(self, img_rgb: np.ndarray, num_keypoints: int,
                ins_embed=None, kpt_embed=None) -> dict:
        """The model's outputs for one image (tensors on the device)."""
        ins, tmask, pos_ids, kpt, kvis = self._text_inputs(
            num_keypoints, ins_embed, kpt_embed)
        with torch.inference_mode():
            canvas, mask, _ = self.preprocess(img_rgb)
            return self.model(canvas, mask, ins, tmask, pos_ids, kpt, kvis)

    def get_unipose_output(self, img_rgb: np.ndarray, num_keypoints: int,
                           box_threshold: float = 0.0,
                           iou_threshold: float = 0.5,
                           ins_embed: np.ndarray | None = None,
                           kpt_embed: np.ndarray | None = None):
        """Returns (boxes cxcywh [M, 4], keypoints [M, 2K], scores [M]) in
        normalized VALID-region coordinates, after NMS."""
        out = self.predict(img_rgb, num_keypoints, ins_embed, kpt_embed)
        scores = out["pred_logits"][0].sigmoid().max(dim=-1).values
        scores = scores.cpu().numpy()
        boxes = out["pred_boxes"][0].cpu().numpy()
        kpts = out["pred_keypoints"][0][:, : 2 * num_keypoints].cpu().numpy()
        keep = scores > box_threshold
        boxes, kpts, scores = boxes[keep], kpts[keep], scores[keep]
        if len(boxes) == 0:
            return boxes, kpts, scores
        xyxy = np.concatenate(
            [boxes[:, :2] - boxes[:, 2:] / 2, boxes[:, :2] + boxes[:, 2:] / 2],
            axis=-1)
        keep_idx = nms_xyxy(xyxy, scores, iou_threshold)
        return boxes[keep_idx], kpts[keep_idx], scores[keep_idx]

    def run(self, img_rgb: np.ndarray, num_keypoints: int = 9,
            box_threshold: float = 0.0, iou_threshold: float = 0.5,
            ins_embed=None, kpt_embed=None):
        """The top detection's landmarks (K, 2) in PIXEL coordinates of the
        input image (animal_landmark_runner.py:105-128), or None when no
        detection survives."""
        boxes, kpts, scores = self.get_unipose_output(
            img_rgb, num_keypoints, box_threshold, iou_threshold,
            ins_embed=ins_embed, kpt_embed=kpt_embed)
        if len(kpts) == 0:
            return None
        h0, w0 = img_rgb.shape[:2]
        # normalized coordinates are relative to the VALID region
        z = kpts[0] * np.array([w0, h0] * num_keypoints, np.float32)
        return np.stack([z[0::2], z[1::2]], axis=1)
