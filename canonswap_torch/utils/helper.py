"""Misc pipeline helpers (the reference's src/utils/helper.py), the port's
counterpart of ``canonswap_tpu/utils/helper.py``."""

from __future__ import annotations

import numpy as np


def calc_motion_multiplier(kp_source: np.ndarray,
                           kp_driving_initial: np.ndarray) -> float:
    """sqrt of the convex-hull volume ratio between the source and the first
    driving keypoints (helper.py:29-42): scales relative motion."""
    from scipy.spatial import ConvexHull

    src = np.asarray(kp_source).reshape(-1, 3)
    drv = np.asarray(kp_driving_initial).reshape(-1, 3)
    return float(np.sqrt(ConvexHull(src).volume)
                 / np.sqrt(ConvexHull(drv).volume))


def is_square_video(video_path: str) -> bool:
    from canonswap_torch.utils.video import frame_size

    w, h = frame_size(video_path)
    return w == h
