"""The trilinear warp: CUDA kernel wrapper and its plain PyTorch version.

Replaces ``canonswap_tpu/ops/pallas/warp.py::grid_sample_3d_onehot``
(``_kernel`` / ``_kernel_win``, quant=False).  The kernel is
``canonswap_torch/csrc/warp3d.cu``; its header says what bounds it on the
H100 and how its layout keeps corner reads coalesced.

Device rule: a CPU volume goes to :func:`grid_sample_3d_plain`; a CUDA volume
launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from canonswap_torch.ops.cuda.build import CudaKernel

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

WARP3D = CudaKernel(
    "warp3d.cu", "warp3d_forward",
    [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int,
     _c_int, _c_int, _c_int, _c_ptr],
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def grid_sample_3d_plain(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: coordinates, weights and sums
    in f32, the result in the volume's dtype.

    vol: (B, C, D, H, W); grid: (B, Do, Ho, Wo, 3), xyz in [-1, 1].
    Returns (B, C, Do, Ho, Wo)."""
    out = F.grid_sample(vol.float(), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.to(vol.dtype)


def grid_sample_3d_cuda(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``vol`` / ``grid`` (both on one card)."""
    if not (vol.is_cuda and grid.is_cuda and vol.device == grid.device):
        raise ValueError(
            f"warp3d needs vol and grid on one CUDA device, got {vol.device} "
            f"and {grid.device}")
    if vol.dtype not in _DTYPE_CODE or grid.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"warp3d takes float32/bfloat16, got vol {vol.dtype}, "
            f"grid {grid.dtype}")
    if vol.dim() != 5 or grid.dim() != 5 or grid.shape[-1] != 3 \
            or grid.shape[0] != vol.shape[0]:
        raise ValueError(
            f"warp3d wants vol (B, C, D, H, W) and grid (B, Do, Ho, Wo, 3), "
            f"got {tuple(vol.shape)} and {tuple(grid.shape)}")
    if not (vol.is_contiguous() and grid.is_contiguous()):
        raise ValueError("warp3d needs contiguous vol and grid")
    b, c, d, h, w = vol.shape
    do, ho, wo = grid.shape[1:4]
    p = do * ho * wo
    if max(c * d * h * w, p) >= 2**31:
        raise ValueError("warp3d: a plane or point count over 2**31")
    out = torch.empty((b, c, do, ho, wo), dtype=vol.dtype, device=vol.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        WARP3D.launch(
            vol.data_ptr(), grid.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[vol.dtype], _DTYPE_CODE[grid.dtype],
            b, c, d, h, w, p, stream)
    return out


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinear grid sample, zero padding, align_corners=False.

    vol: (B, C, D, H, W); grid: (B, Do, Ho, Wo, 3), xyz in [-1, 1].
    Returns (B, C, Do, Ho, Wo) in vol's dtype.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if vol.device.type == "cpu" and grid.device.type == "cpu":
        return grid_sample_3d_plain(vol, grid)
    return grid_sample_3d_cuda(vol, grid)
