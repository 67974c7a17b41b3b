"""Crop geometry around landmarks: eye-lip-axis similarity transforms.

The port's own copy of the parts of ``canonswap_tpu/utils/geometry.py`` that
the 203-point landmark tracker needs (the reference's src/utils/crop.py:
244-300, 381-455): the crop axis runs from the eye centre to the lip centre
(cancelling roll), and the crop box is the square rotated bounding box of all
landmarks, scaled by ``scale`` and shifted by ``vx_ratio``/``vy_ratio`` along
the face axes.  The landmark math stays in numpy on the host, as there; the
warp runs in torch on the image's device (the card's machine has no cv2).

:func:`warp_affine` stands in for ``cv2.warpAffine(INTER_LINEAR)`` with its
constant zero border: bilinear sampling at the inverse map (grid_sample's
pixel-centre arithmetic), rounded half up to uint8 as cv2 rounds.  cv2 forms
its sample positions in 1/32 pixel and its weights in fixed point, so the two
differ by at most one grey level where a value falls near a rounding step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DTYPE = np.float32


def _eye_lip_points(pts: np.ndarray, use_lip: bool = True) -> np.ndarray:
    """The 2 anchor points (eye centre, lip centre) for any of the
    supported landmark counts (5/9/68/101/106/203)."""
    n = pts.shape[0]
    if n == 106:
        left_eye = pts[[33, 35, 40, 39]].mean(0)
        right_eye = pts[[87, 89, 94, 93]].mean(0)
        lip = (pts[52] + pts[61]) / 2
    elif n == 203:
        left_eye = pts[[0, 6, 12, 18]].mean(0)
        right_eye = pts[[24, 30, 36, 42]].mean(0)
        lip = (pts[48] + pts[66]) / 2
    elif n >= 101:
        p = pts[:101]
        left_eye = p[[39, 42, 45, 48]].mean(0)
        right_eye = p[[51, 54, 57, 60]].mean(0)
        lip = (p[75] + p[81]) / 2
    elif n == 68:
        idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
        left_eye = pts[idx[[1, 2]]].mean(0)
        right_eye = pts[idx[[3, 4]]].mean(0)
        lip = (pts[idx[5]] + pts[idx[6]]) / 2
    elif n == 5:
        left_eye, right_eye = pts[0], pts[1]
        lip = (pts[3] + pts[4]) / 2
    elif n == 9:
        left_eye = (pts[2] + pts[3]) / 2
        right_eye = (pts[0] + pts[1]) / 2
        lip = (pts[5] + pts[6]) / 2
    else:
        raise ValueError(f"unsupported landmark count: {n}")

    eye_center = (left_eye + right_eye) / 2
    if use_lip:
        return np.stack([eye_center, lip]).astype(DTYPE)
    # without lip: rotate the eye axis 90 deg clockwise to get a vertical axis
    pt2 = np.stack([left_eye, right_eye]).astype(DTYPE)
    v = pt2[1] - pt2[0]
    pt2[1] = [pt2[0, 0] - v[1], pt2[0, 1] + v[0]]
    return pt2


def parse_rect_from_landmark(pts: np.ndarray, scale: float = 1.5,
                             vx_ratio: float = 0.0, vy_ratio: float = 0.0,
                             use_lip: bool = True):
    """-> (center (2,), size (2,), angle rad) of the face-axis-aligned square
    covering all landmarks."""
    pt2 = _eye_lip_points(pts, use_lip)
    uy = pt2[1] - pt2[0]
    length = np.linalg.norm(uy)
    uy = np.array([0.0, 1.0], DTYPE) if length <= 1e-3 else uy / length
    ux = np.array([uy[1], -uy[0]], DTYPE)

    angle = float(np.arccos(np.clip(ux[0], -1, 1)))
    if ux[1] < 0:
        angle = -angle

    M = np.stack([ux, uy])
    center0 = pts.mean(0)
    rpts = (pts - center0) @ M.T
    lt, rb = rpts.min(0), rpts.max(0)
    center1 = (lt + rb) / 2
    size = rb - lt
    m = max(size[0], size[1])
    size = np.array([m, m], DTYPE) * scale
    center = center0 + ux * center1[0] + uy * center1[1]
    center = center + ux * (vx_ratio * size) + uy * (vy_ratio * size)
    return center.astype(DTYPE), size, angle


def estimate_similar_transform(pts: np.ndarray, dsize: int,
                               scale: float = 1.5, vx_ratio: float = 0.0,
                               vy_ratio: float = -0.1,
                               flag_do_rot: bool = True,
                               use_lip: bool = True):
    """Landmarks -> (M_o2c, M_c2o) 3x3 similarity transforms between the
    original image and the dsize x dsize crop."""
    center, size, angle = parse_rect_from_landmark(
        pts, scale=scale, vx_ratio=vx_ratio, vy_ratio=vy_ratio,
        use_lip=use_lip)
    s = dsize / max(float(size[0]), 1e-3)  # guard degenerate landmarks
    tc = dsize / 2.0
    if flag_do_rot:
        ct, st = np.cos(angle), np.sin(angle)
        cx, cy = center
        M = np.array([
            [s * ct, s * st, tc - s * (ct * cx + st * cy)],
            [-s * st, s * ct, tc - s * (-st * cx + ct * cy)],
        ], DTYPE)
    else:
        M = np.array([[s, 0, tc - s * center[0]], [0, s, tc - s * center[1]]],
                     DTYPE)
    M_o2c = np.vstack([M, np.array([0, 0, 1], DTYPE)])
    M_c2o = np.linalg.inv(M_o2c).astype(DTYPE)
    return M_o2c, M_c2o


def transform_pts(pts: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Apply a 2x3/3x3 affine to Nx2 points."""
    return pts @ M[:2, :2].T + M[:2, 2]


def warp_affine(img: torch.Tensor, M: np.ndarray, dsize) -> torch.Tensor:
    """``cv2.warpAffine(img, M, dsize, INTER_LINEAR)`` on a (H, W, C) uint8
    tensor, on its device: ``dst(p) = src(M^-1 p)``, bilinear, zero outside
    the image, rounded half up to uint8.  ``M`` maps source to destination
    pixels (2x3 or 3x3); ``dsize`` is (w, h) or an int."""
    w_out, h_out = (dsize, dsize) if isinstance(dsize, int) else dsize
    h, w = img.shape[:2]
    minv = np.linalg.inv(np.vstack([np.asarray(M, np.float64)[:2],
                                    [0.0, 0.0, 1.0]]))[:2]
    ys, xs = torch.meshgrid(
        torch.arange(h_out, dtype=torch.float64, device=img.device),
        torch.arange(w_out, dtype=torch.float64, device=img.device),
        indexing="ij")
    sx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    sy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    # pixel centres at align_corners=False: x = ((g + 1) * W - 1) / 2
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1)
    src = img.permute(2, 0, 1)[None].float()
    out = F.grid_sample(src, grid[None].float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return torch.floor(out + 0.5).clamp(0, 255)[0].permute(1, 2, 0).to(
        torch.uint8)


def crop_image(img: torch.Tensor, pts: np.ndarray, dsize: int = 224,
               scale: float = 1.5, vx_ratio: float = 0.0,
               vy_ratio: float = -0.1, flag_do_rot: bool = True) -> dict:
    """Crop a (H, W, C) uint8 tensor around landmarks: ``img_crop`` a
    (dsize, dsize, C) uint8 tensor on the image's device, ``pt_crop``,
    ``M_o2c`` and ``M_c2o`` in numpy."""
    M_o2c, M_c2o = estimate_similar_transform(
        pts, dsize=dsize, scale=scale, vx_ratio=vx_ratio, vy_ratio=vy_ratio,
        flag_do_rot=flag_do_rot)
    return {
        "img_crop": warp_affine(img, M_o2c, dsize),
        "pt_crop": transform_pts(pts, M_o2c),
        "M_o2c": M_o2c,
        "M_c2o": M_c2o,
    }
