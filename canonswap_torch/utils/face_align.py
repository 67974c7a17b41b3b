"""5-point face alignment (ArcFace / FFHQ templates) without skimage.

The port's own copy of ``canonswap_tpu/utils/face_align.py`` (the
reference's face_align.py:6-30 and insightface_func/utils/
face_align_ffhqandnewarc.py:14-78; the templates are the published ArcFace
and FFHQ alignment points).  The similarity is a least-squares Umeyama fit
(what skimage's ``SimilarityTransform.estimate`` computes), in numpy on the
host; :func:`norm_crop` warps on the image's device through
``utils/geometry.py::warp_affine`` (at most one grey level from
``cv2.warpAffine``).
"""

from __future__ import annotations

import numpy as np
import torch

from canonswap_torch.utils.geometry import warp_affine

# Standard ArcFace 112x112 5-point template.
ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]],
    dtype=np.float32,
)

# Multi-view templates (left..right profile) on 112, and FFHQ on 512.
MULTIVIEW_SRC = np.array(
    [
        [[51.642, 50.115], [57.617, 49.990], [35.740, 69.007],
         [51.157, 89.050], [57.025, 89.702]],
        [[45.031, 50.118], [65.568, 50.872], [39.677, 68.111],
         [45.177, 86.190], [64.246, 86.758]],
        [[39.730, 51.138], [72.270, 51.138], [56.000, 68.493],
         [42.463, 87.010], [69.537, 87.010]],
        [[46.845, 50.872], [67.382, 50.118], [72.737, 68.111],
         [48.167, 86.758], [67.236, 86.190]],
        [[54.796, 49.990], [60.771, 50.115], [76.673, 69.007],
         [55.388, 89.702], [61.257, 89.050]],
    ],
    dtype=np.float32,
)

FFHQ_SRC = np.array(
    [[[192.98138, 239.94708], [318.90277, 240.1936], [256.63416, 314.01935],
      [201.26117, 371.41043], [313.08905, 371.15118]]],
    dtype=np.float32,
)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform src->dst (Umeyama 1991), as 2x3.

    Matches skimage.transform.SimilarityTransform.estimate."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / n
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.ones(d)
    if np.linalg.det(cov) < 0:
        sgn[-1] = -1
    R = U @ np.diag(sgn) @ Vt
    var_src = (src_c**2).sum() / n
    scale = (S * sgn).sum() / var_src if var_src > 0 else 1.0
    t = dst_mean - scale * R @ src_mean
    M = np.zeros((2, 3), np.float32)
    M[:, :2] = scale * R
    M[:, 2] = t
    return M


def estimate_norm_arcface(lmk: np.ndarray, image_size: int = 112) -> np.ndarray:
    """5-pt landmark -> 2x3 affine to the ArcFace template (face_align.py:11-25)."""
    if lmk.shape != (5, 2):
        raise ValueError(f"5 landmarks (5, 2) expected, got {lmk.shape}")
    if image_size % 112 == 0:
        ratio, diff_x = image_size / 112.0, 0.0
    else:
        ratio = image_size / 128.0
        diff_x = 8.0 * ratio
    dst = ARCFACE_DST * ratio
    dst = dst + np.array([diff_x, 0], np.float32)
    return umeyama_similarity(lmk, dst)


def estimate_norm_multiview(
    lmk: np.ndarray, image_size: int = 112, mode: str = "newarc"
) -> tuple[np.ndarray, int]:
    """Min-error template selection over the 5 view templates (or FFHQ)
    (face_align_ffhqandnewarc.py:55-78)."""
    if lmk.shape != (5, 2):
        raise ValueError(f"5 landmarks (5, 2) expected, got {lmk.shape}")
    if mode == "ffhq":
        src = FFHQ_SRC * (image_size / 512.0)
    else:
        src = MULTIVIEW_SRC * (image_size / 112.0)
    lmk_h = np.concatenate([lmk, np.ones((5, 1), lmk.dtype)], axis=1)
    best = (None, -1, np.inf)
    for i in range(src.shape[0]):
        M = umeyama_similarity(lmk, src[i])
        proj = lmk_h @ M.T
        err = np.sum(np.sqrt(np.sum((proj - src[i]) ** 2, axis=1)))
        if err < best[2]:
            best = (M, i, err)
    return best[0], best[1]


def norm_crop(img: torch.Tensor, lmk: np.ndarray, image_size: int = 112,
              mode: str = "arcface"):
    """Aligned crop of a (H, W, 3) uint8 tensor; returns (crop on the
    image's device, M) (face_align.py:27-35)."""
    if mode == "arcface":
        M = estimate_norm_arcface(lmk, image_size)
    else:
        M, _ = estimate_norm_multiview(lmk, image_size, mode)
    return warp_affine(img, M, image_size), M
