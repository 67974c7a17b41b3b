"""Trilinear sampling: the warp and the constant-shift resample.

Port of ``canonswap_tpu/ops/grid_sample.py``.  :func:`grid_sample_3d` is the
warp and :func:`grid_sample_3d_quant` its W8A8 form (the fast bundle's): the
plain versions for CPU tensors and the hand-written CUDA kernels for CUDA
tensors (``ops/cuda/warp.py``).  :func:`axis_resample_matrix` gives the
same function at a constant shift, one axis at a time, as a banded matrix:
dense motion's sparse motions are such shifts.
"""

from __future__ import annotations

import torch

from canonswap_torch.ops.cuda.warp import grid_sample_3d, grid_sample_3d_quant

__all__ = ["axis_resample_matrix", "grid_sample_3d", "grid_sample_3d_quant"]


def axis_resample_matrix(size: int, shift: torch.Tensor) -> torch.Tensor:
    """(..., S, S) banded linear-resample matrices for sampling one axis at
    ``identity_grid + shift`` (one matrix per entry of ``shift``).

    The identity grid is corner-aligned while the sampler unnormalizes with
    align_corners=False, so the sample position is affine in the output
    index: ``t(p) = p * S/(S-1) + shift * S/2 - 0.5``.  Taps outside
    [0, S) get no column: zero padding."""
    dt, dev = shift.dtype, shift.device
    p = torch.arange(size, dtype=dt, device=dev)
    t = p * (size / (size - 1.0)) + shift[..., None] * (size / 2.0) - 0.5
    x0 = torch.floor(t)
    f = (t - x0)[..., None]
    x0 = x0.to(torch.int64)[..., None]
    cols = torch.arange(size, device=dev)
    return (1.0 - f) * (cols == x0).to(dt) + f * (cols == x0 + 1).to(dt)

