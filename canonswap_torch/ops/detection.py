"""Fixed-capacity SCRFD post-processing, batched, on the tensors' device.

Port of ``canonswap_tpu/ops/detection.py`` (the reference decodes with
dynamic-shape numpy, scrfd.py:26-70, 190-303): scores over all anchors ->
the top ``topk`` by a stable descending sort -> greedy NMS over the
candidates' IoU matrix -> fixed-size (B, topk) results with a validity mask.

Two points of the JAX version are kept on purpose:

- ``lax.top_k`` puts the lower index first among equal scores, and after the
  threshold most anchors score exactly 0; ``torch.topk`` promises no order,
  so the selection is a stable descending sort.
- ``decode_scrfd`` unpacks ``input_size`` as (h, w), while the detector's
  ``det_size`` is (w, h) elsewhere; the two agree at a square size, the
  session's (512, 512), and the port computes what the JAX package does.
"""

from __future__ import annotations

import torch


def anchor_centers(height: int, width: int, stride: int,
                   num_anchors: int = 2, device=None) -> torch.Tensor:
    """(H*W*A, 2) anchor centres (x, y) in input pixels, row-major over the
    grid, each repeated ``num_anchors`` times (scrfd.py:239-247)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    centers = torch.stack([xs, ys], dim=-1).reshape(-1, 1, 2) * stride
    return centers.expand(-1, num_anchors, 2).reshape(-1, 2)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor
                  ) -> torch.Tensor:
    """(N, 2) centres + (..., N, 4) distances -> (..., N, 4) x1y1x2y2
    (scrfd.py:26-41)."""
    return torch.cat([points - distance[..., :2],
                      points + distance[..., 2:]], dim=-1)


def distance2kps(points: torch.Tensor, distance: torch.Tensor
                 ) -> torch.Tensor:
    """(N, 2) centres + (..., N, 2K) distances -> (..., N, K, 2) keypoints
    (scrfd.py:44-70)."""
    d = distance.reshape(*distance.shape[:-1], -1, 2)
    return points[:, None, :] + d


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) -> (..., K, K) pairwise IoU."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp_min(0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0))
    x1 = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    y1 = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    x2 = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    y2 = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_thresh: float = 0.4) -> torch.Tensor:
    """Greedy NMS over score-sorted fixed-size candidates, batched.

    Args:
      boxes: (..., K, 4) sorted by descending score.
      scores: (..., K); score <= 0 marks padding.

    Returns the (..., K) bool keep mask of the reference's sequential NMS
    (scrfd.py:275-303), as the JAX ``fori_loop``: candidate i is dropped
    when a kept candidate j < i overlaps it by more than ``iou_thresh``.
    The K steps run on the device, each on one row of the boolean
    "overlaps an earlier candidate" matrix."""
    k = boxes.shape[-2]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=boxes.device).tril(-1)
    over = (_iou_matrix(boxes) > iou_thresh) & earlier
    keep = scores > 0
    for i in range(1, k):  # row 0 has no earlier candidate
        keep[..., i] &= ~(over[..., i, :] & keep).any(dim=-1)
    return keep


def decode_scrfd(outputs: dict, *, input_size: tuple[int, int] = (640, 640),
                 strides: tuple[int, ...] = (8, 16, 32),
                 num_anchors: int = 2, score_thresh: float = 0.5,
                 iou_thresh: float = 0.4, topk: int = 128) -> dict:
    """Batched SCRFD decode: head outputs -> fixed-size detections.

    Args:
      outputs: {stride: {"score": (B, N_s, 1), "bbox": (B, N_s, 4),
        "kps": (B, N_s, 10)}}, distances in stride units.
      input_size: unpacked as (h, w), as the JAX version does.

    Returns dict(bboxes (B, topk, 4), kps (B, topk, 5, 2), scores (B, topk),
    valid (B, topk) bool, index (B, topk) the anchors selected),
    score-sorted, NMS applied."""
    h, w = input_size
    all_scores, all_boxes, all_kps = [], [], []
    for s in strides:
        out = outputs[s]
        ac = anchor_centers(h // s, w // s, s, num_anchors,
                            device=out["score"].device)
        all_scores.append(out["score"][..., 0])
        all_boxes.append(distance2bbox(ac, out["bbox"] * s))
        all_kps.append(distance2kps(ac, out["kps"] * s))
    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    kps = torch.cat(all_kps, dim=1)

    scores = torch.where(scores >= score_thresh, scores, 0.0)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    idx = order[:, :topk]
    top_scores = torch.gather(scores, 1, idx)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_kps = torch.gather(kps, 1, idx[..., None, None].expand(
        -1, -1, *kps.shape[2:]))
    keep = nms_fixed(top_boxes, top_scores, iou_thresh)
    return {"bboxes": top_boxes, "kps": top_kps, "scores": top_scores,
            "valid": keep & (top_scores > 0), "index": idx}
