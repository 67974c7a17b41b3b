"""Crop geometry around landmarks: eye-lip-axis similarity transforms.

The port's own copy of ``canonswap_tpu/utils/geometry.py`` (the reference's
src/utils/crop.py:244-529): the crop axis runs from the eye centre to the lip
centre (cancelling roll), and the crop box is the square rotated bounding box
of all landmarks, scaled by ``scale`` and shifted by ``vx_ratio``/
``vy_ratio`` along the face axes; crops by a given transform or an
axis-aligned box; and the paste-back of a swapped crop into its frame.  The
landmark math stays in numpy on the host, as there; the warps and the blend
run in torch on the image's device (the card's machine has no cv2).

:func:`warp_affine` stands in for ``cv2.warpAffine(INTER_LINEAR)`` with its
constant zero border: bilinear sampling at the inverse map (grid_sample's
pixel-centre arithmetic).  A uint8 image is rounded half up to uint8, as cv2
rounds; cv2 forms its sample positions in 1/32 pixel and its weights in
fixed point, so the two differ by at most one grey level where a value falls
near a rounding step.  A float image stays float, unrounded, as cv2 warps
one (the paste-back mask).

:func:`paste_back` follows the JAX package's native C++ paste-back
(``native/canonswap_native.cpp``), not its cv2 fallback; its docstring says
how the two differ.  It has one path, and a failure raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from canonswap_torch.ops.affine import sample_bilinear

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
    """``cv2.warpAffine(img, M, dsize, INTER_LINEAR)`` on a (H, W, C) or
    (H, W) tensor, on its device: ``dst(p) = src(M^-1 p)``, bilinear, zero
    outside the image.  uint8 is rounded half up to uint8; a float image
    keeps its dtype, unrounded.  ``M`` maps source to destination pixels
    (2x3 or 3x3); ``dsize`` is (w, h) or an int."""
    w_out, h_out = (dsize, dsize) if isinstance(dsize, int) else dsize
    if img.dim() == 2:
        return warp_affine(img[..., None], M, dsize)[..., 0]
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
    src = img.permute(2, 0, 1)[None]
    if not src.is_floating_point():
        src = src.float()
    out = F.grid_sample(src, grid[None].to(src.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    if img.is_floating_point():
        return out[0].permute(1, 2, 0)
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


def parse_bbox_from_landmark(pts: np.ndarray, scale: float = 1.5,
                             vx_ratio: float = 0.0, vy_ratio: float = 0.0,
                             use_lip: bool = True) -> dict:
    """Landmarks -> the face rect as axis-aligned and rotated corner sets
    (crop.py:303-332); ``bbox`` rows are (lt, rt, rb, lb)."""
    center, size, angle = parse_rect_from_landmark(
        pts, scale=scale, vx_ratio=vx_ratio, vy_ratio=vy_ratio,
        use_lip=use_lip)
    cx, cy = center
    w, h = size
    bbox = np.array(
        [[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
         [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]], DTYPE)
    R = np.array([[np.cos(angle), -np.sin(angle)],
                  [np.sin(angle), np.cos(angle)]], DTYPE)
    bbox_rot = (bbox - center) @ R.T + center
    return {"center": center, "size": size, "angle": angle,
            "bbox": bbox, "bbox_rot": bbox_rot}


def crop_image_mo2c(img: torch.Tensor, pts: np.ndarray, mo2c: np.ndarray,
                    dsize: int = 224) -> dict:
    """Crop by a given original-to-crop transform (crop.py:457-476)."""
    M = np.asarray(mo2c, DTYPE)[:2, :]
    M_o2c = np.vstack([M, np.array([0, 0, 1], DTYPE)])
    return {
        "img_crop": warp_affine(img, M, dsize),
        "pt_crop": transform_pts(pts, M),
        "M_o2c": M_o2c,
        "M_c2o": np.linalg.inv(M_o2c).astype(DTYPE),
    }


def crop_image_by_bbox(img: torch.Tensor, bbox, lmk=None,
                       dsize: int = 512) -> dict:
    """Axis-aligned square crop of a box (left, top, right, bottom), the
    scale taken from its width (crop.py:335-378, no-rotation branch)."""
    left, top, right, bot = bbox
    s = dsize / (right - left)
    src_c = np.array([(left + right) / 2, (top + bot) / 2], DTYPE)
    M = np.array(
        [[s, 0, dsize / 2 - s * src_c[0]], [0, s, dsize / 2 - s * src_c[1]]],
        DTYPE)
    M_o2c = np.vstack([M, np.array([0, 0, 1], DTYPE)])
    return {
        "img_crop": warp_affine(img, M, dsize),
        "lmk_crop": transform_pts(lmk, M) if lmk is not None else None,
        "M_o2c": M_o2c,
        "M_c2o": np.linalg.inv(M_o2c).astype(DTYPE),
    }


def average_bbox(bbox_lst):
    if not bbox_lst:
        return None
    return np.mean(np.asarray(bbox_lst), axis=0).tolist()


def prepare_paste_back(mask_crop: torch.Tensor, M_c2o: np.ndarray, dsize,
                       if_float: bool = False) -> torch.Tensor:
    """Warp the crop-space mask into the frame (crop.py:515-521): a float
    mask warps unrounded; without ``if_float`` the result is scaled by
    1/255 (a uint8 mask's range), as the JAX version does."""
    mask_ori = warp_affine(mask_crop, M_c2o, dsize)
    if not if_float:
        mask_ori = mask_ori.float() / 255.0
    return mask_ori


def paste_back(img_crop: torch.Tensor, M_c2o: np.ndarray,
               img_ori: torch.Tensor, mask_ori: torch.Tensor
               ) -> torch.Tensor:
    """Blend the swapped crop back into its frame (crop.py:523-529), on the
    frame's device.

    img_crop (ch, cw, 3) uint8 or float on the 0..255 scale; M_c2o the 2x3
    or 3x3 crop-to-frame transform; img_ori (H, W, 3) uint8; mask_ori
    (H, W) or (H, W, k) float in [0, 1], its first channel used.  Returns
    (H, W, 3) uint8.

    The arithmetic is the native C++ paste-back's
    (``native/canonswap_native.cpp:32-77``), in f32: the frame-to-crop map
    inverted from the f32 matrix, exact bilinear sampling of the crop at it
    (corners outside the crop count zero), ``m * crop + (1 - m) * frame``
    rounded once, half away from zero, and the frame's pixels copied where
    m <= 0.  The JAX package's cv2 fallback instead warps the crop to uint8
    first (1/32-pixel positions, rounded) and truncates the blend; the two
    differ by at most one grey level."""
    h, w = img_ori.shape[:2]
    ch, cw = img_crop.shape[:2]
    dev = img_ori.device
    f32 = np.float32
    (a, b, tx), (c, d, ty) = np.asarray(M_c2o, f32)[:2]
    det = f32(a * d - b * c)  # numpy f32 scalars: f32 arithmetic
    ia, ib, ic, id_ = f32(d / det), f32(-b / det), f32(-c / det), f32(
        a / det)
    itx, ity = f32(-(ia * tx + ib * ty)), f32(-(ic * tx + id_ * ty))
    # as Python floats (exact), so the products below are f32 tensor ops
    ia, ib, ic, id_, itx, ity = map(float, (ia, ib, ic, id_, itx, ity))
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    sx = ia * xs + ib * ys + itx
    sy = ic * xs + id_ * ys + ity
    px = sample_bilinear(img_crop.reshape(1, ch, cw, -1), sx[None],
                         sy[None])[0]
    m = mask_ori if mask_ori.dim() == 2 else mask_ori[..., 0]
    m = m.float()[..., None]
    v = m * px + (1.0 - m) * img_ori.float()
    r = torch.floor(v)
    r = (r + (v - r >= 0.5)).clamp(0, 255).to(torch.uint8)
    return torch.where(m <= 0, img_ori, r)


def paste_back_value(img_crop: np.ndarray, M_c2o: np.ndarray,
                     img_ori: np.ndarray, mask_ori: np.ndarray) -> np.ndarray:
    """:func:`paste_back`'s blend before its one rounding, in f64 (numpy,
    on the host): the reference that tells a rounding tie, where two f32
    arithmetics may round one grey level apart, from a fault."""
    h, w = img_ori.shape[:2]
    ch, cw = img_crop.shape[:2]
    minv = np.linalg.inv(np.vstack([np.asarray(M_c2o, np.float64)[:2],
                                    [0, 0, 1]]))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    sy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    x0, y0 = np.floor(sx), np.floor(sy)
    px = np.zeros((h, w, img_crop.shape[2]))
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0.astype(int) + dy, x0.astype(int) + dx
            wgt = ((sy - y0) if dy else (1 - (sy - y0))) * (
                (sx - x0) if dx else (1 - (sx - x0)))
            ok = (yi >= 0) & (yi < ch) & (xi >= 0) & (xi < cw)
            px += (wgt * ok)[..., None] * img_crop[yi.clip(0, ch - 1),
                                                   xi.clip(0, cw - 1)]
    m = (mask_ori if mask_ori.ndim == 2 else mask_ori[..., 0])[
        ..., None].astype(np.float64)
    return m * px + (1 - m) * img_ori
