"""Temporal smoothing of motion parameters (a Kalman smoother).

The port's own copy of ``canonswap_tpu/utils/smoothing.py``.  The reference
fits pykalman's KalmanFilter over flattened per-frame motion arrays
(src/utils/filter.py:8-19, imported but unused in its active paths); this
is a constant-state Kalman filter with an RTS backward pass and the same
call surface, ``smooth(observations, observation_variance)``, in numpy on
the host between device batches.
"""

from __future__ import annotations

import numpy as np


def smooth(
    x_lst: list | np.ndarray,
    observation_variance: float = 3e-7,
    process_variance: float = 1e-5,
) -> np.ndarray:
    """Kalman-smooth a sequence of arrays along the frame axis.

    Args:
      x_lst: (T, ...) observations.
      observation_variance: larger -> smoother (trusts measurements less).
      process_variance: state transition noise.

    Returns (T, ...) smoothed sequence (RTS smoother, identity dynamics).
    """
    x = np.asarray(x_lst, np.float32)
    t_len = x.shape[0]
    flat = x.reshape(t_len, -1).astype(np.float64)

    q = process_variance
    r = observation_variance

    # forward filter
    means = np.zeros_like(flat)
    variances = np.zeros(t_len)
    mean = flat[0]
    var = 1.0
    means[0], variances[0] = mean, var
    for t in range(1, t_len):
        var_pred = var + q
        k = var_pred / (var_pred + r)
        mean = mean + k * (flat[t] - mean)
        var = (1 - k) * var_pred
        means[t], variances[t] = mean, var

    # RTS backward smoother
    smoothed = means.copy()
    for t in range(t_len - 2, -1, -1):
        var_pred = variances[t] + q
        c = variances[t] / var_pred
        smoothed[t] = means[t] + c * (smoothed[t + 1] - means[t])

    return smoothed.reshape(x.shape).astype(np.float32)
