"""The W8A8 conv: CUDA kernel wrapper.

Replaces ``canonswap_tpu/ops/pallas/qconv.py::qconv2d_pallas`` (``_run`` ->
``_kernel``), whose function is ``canonswap_tpu/ops/qconv.py::conv2d_w8a8``;
the plain version is ``canonswap_torch/ops/qconv.py::conv_w8a8_plain``.  The
kernel is ``canonswap_torch/csrc/qconv.cu``: its header says what bounds it
on the H100 and the layout it takes.

One call launches the kernel's four parts on the current stream: the
per-sample activation max, the weight's quantization into the kernel's
layout (at every call, as the JAX package quantizes inside its jitted
function, so a weight that was changed, cast or moved is never read stale),
the activation's quantization and the GEMM (``wgmma``; the C entry point
picks its tile and its A path from the shape, and a launch that fails
raises).
"""

from __future__ import annotations

import ctypes

import torch

from canonswap_torch.ops.cuda.build import CudaKernel, forbid_grad

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

QCONV = CudaKernel(
    "qconv.cu", "qconv_forward",
    [_c_ptr] * 7 + [_c_int] * 13 + [_c_ptr],
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 32  # int8 channels per k-chunk of the kernel's GEMM


def check_args(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None) -> None:
    """Raise on what the W8A8 conv does not take."""
    if x.dim() not in (4, 5) or weight.dim() != x.dim():
        raise ValueError(
            f"w8a8 conv wants x (N, C, [D,] H, W) and a weight of the same "
            f"rank, got {tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.shape[1] != x.shape[1]:
        raise ValueError(
            f"w8a8 conv: x has {x.shape[1]} channels, weight takes "
            f"{weight.shape[1]}")
    if any(k % 2 == 0 or k > 7 for k in weight.shape[2:]):
        raise ValueError(
            f"w8a8 conv takes odd kernel sizes up to 7, got "
            f"{tuple(weight.shape[2:])}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"w8a8 conv: bias {tuple(bias.shape)} for "
                         f"{weight.shape[0]} output channels")
    if not (x.is_floating_point() and weight.is_floating_point()):
        raise TypeError(f"w8a8 conv takes float tensors, got {x.dtype}, "
                        f"{weight.dtype}")


def conv_w8a8_cuda(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (x, weight and bias on one card).  It has no
    backward: raises under grad on an input that requires it."""
    forbid_grad("qconv (the W8A8 conv)", x, weight, bias)
    check_args(x, weight, bias)
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(
            "w8a8 conv needs x, weight and bias on one CUDA device, got "
            + ", ".join(str(t.device) for t in tensors))
    if any(t.dtype not in _DTYPE_CODE for t in tensors):
        raise TypeError("w8a8 conv takes float32/bfloat16 tensors, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if not x.is_contiguous():
        raise ValueError("w8a8 conv needs a contiguous x")
    n, cin = x.shape[:2]
    spatial = tuple(x.shape[2:]) if x.dim() == 5 else (1, *x.shape[2:])
    ksize = tuple(weight.shape[2:]) if x.dim() == 5 else (1, *weight.shape[2:])
    cout = weight.shape[0]
    cp = -(-cin // _CHUNK) * _CHUNK
    plane = spatial[0] * spatial[1] * spatial[2]
    taps = ksize[0] * ksize[1] * ksize[2]
    if (max(n * plane * cp, n * cout * plane, cout * taps * cp) >= 2**31
            or n >= 65536):
        raise ValueError("w8a8 conv: a size over the kernel's index range")
    out = torch.empty((n, cout, *x.shape[2:]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    weight = weight.contiguous()
    bias = None if bias is None else bias.contiguous()
    xq = torch.empty((n, plane, cp), dtype=torch.int8, device=x.device)
    wk = torch.empty((cout, taps * cp), dtype=torch.int8, device=x.device)
    scratch = torch.empty(n + 2 * cout, dtype=torch.float32, device=x.device)
    QCONV.launch_on(
        x.device, x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        xq.data_ptr(), wk.data_ptr(), scratch.data_ptr(),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype],
        0 if bias is None else _DTYPE_CODE[bias.dtype],
        n, cin, cp, *spatial, cout, *ksize)
    return out
