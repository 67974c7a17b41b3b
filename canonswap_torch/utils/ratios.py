"""Eye / lip closing-ratio features from 203-point landmarks.

The port's own copy of ``canonswap_tpu/utils/ratios.py`` (numpy), which
re-implements the reference's src/utils/retargeting_utils.py:9-24 (the
landmark index pairs are properties of the 203-point layout).  The
pipelines store the eye and lip ratios in the motion template; the combined
ratios feed the retargeting nets (``models/stitching.py``).
"""

from __future__ import annotations

import numpy as np


def _distance_ratio(lmk: np.ndarray, i1: int, i2: int, i3: int, i4: int,
                    eps: float = 1e-6) -> np.ndarray:
    a = np.linalg.norm(lmk[:, i1] - lmk[:, i2], axis=1, keepdims=True)
    b = np.linalg.norm(lmk[:, i3] - lmk[:, i4], axis=1, keepdims=True)
    return a / (b + eps)


def calc_eye_close_ratio(lmk: np.ndarray, target_eye_ratio=None) -> np.ndarray:
    """lmk: (B, 203, 2) -> (B, 2[+1]) [left, right(, target)]."""
    left = _distance_ratio(lmk, 6, 18, 0, 12)
    right = _distance_ratio(lmk, 30, 42, 24, 36)
    parts = [left, right]
    if target_eye_ratio is not None:
        parts.append(target_eye_ratio)
    return np.concatenate(parts, axis=1)


def calc_lip_close_ratio(lmk: np.ndarray) -> np.ndarray:
    """lmk: (B, 203, 2) -> (B, 1)."""
    return _distance_ratio(lmk, 90, 102, 48, 66)


def calc_combined_eye_ratio(c_d_eyes_i, source_lmk: np.ndarray) -> np.ndarray:
    """[c_s_eyes(1,2) | c_d_eyes_i(1,1)] -> (1, 3) retarget_eye input
    (reference can_swap_e2e.py:334-341)."""
    c_s_eyes = calc_eye_close_ratio(source_lmk[None])
    c_d = np.asarray(c_d_eyes_i, np.float32).reshape(-1)[:1].reshape(1, 1)
    return np.concatenate([c_s_eyes.astype(np.float32), c_d], axis=1)


def calc_combined_lip_ratio(c_d_lip_i, source_lmk: np.ndarray) -> np.ndarray:
    """[c_s_lip(1,1) | c_d_lip_i(1,1)] -> (1, 2) retarget_lip input
    (reference can_swap_e2e.py:343-348)."""
    c_s_lip = calc_lip_close_ratio(source_lmk[None])
    c_d = np.asarray(c_d_lip_i, np.float32).reshape(-1)[:1].reshape(1, 1)
    return np.concatenate([c_s_lip.astype(np.float32), c_d], axis=1)
