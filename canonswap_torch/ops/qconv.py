"""Dynamic W8A8 convolution: int8 weights and activations, an int32 sum.

Port of ``canonswap_tpu/ops/qconv.py`` (``conv2d_w8a8``, ``int8_worthwhile``,
and the int8 3D chains of ``nn/conv3d.py``, which are the same conv with a
depth axis) and of the fused Pallas form
``canonswap_tpu/ops/pallas/qconv.py::qconv2d_pallas``, which computes the
same function.  One function serves every int8 site of the fast bundle: 2D
(NCHW) and 3D (NCDHW), stride 1, SAME padding, odd kernel sizes up to 7:

- per-sample activation step ``sx`` and per-output-channel weight step
  ``sw`` (``ops/quant.py``), int8 values by division and round half to even;
- ``acc``: the conv of the int8 tensors, zero padding in the int8 domain,
  an exact integer sum;
- ``y = acc * (sx[n] * sw[co]) + bias`` in f32, the scale product first,
  then x's dtype.  The multiply and the bias add are one fused multiply-add,
  as XLA evaluates the JAX expression.

A CPU tensor takes :func:`conv_w8a8_plain`; a CUDA tensor the hand-written
kernel (``csrc/qconv.cu`` through ``ops/cuda/qconv.py``), or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from canonswap_torch.ops.cuda.qconv import check_args, conv_w8a8_cuda
from canonswap_torch.ops.quant import quantize, quantize_weight, sample_step


def int8_worthwhile(x: torch.Tensor) -> bool:
    """The JAX package's static gate: int8 where the conv is compute-bound,
    H <= 128 and Cin >= 128 (x NCHW)."""
    return x.shape[2] <= 128 and x.shape[1] >= 128


def _dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
    """f32 ``fma(acc, sx[n] * sw[co], bias[co])`` of an integer-valued
    (N, Cout, ...) sum.  The product of two f32 values is exact in f64, so
    the f64 multiply-add rounds once to f64 and once to f32, which equals
    the fused f32 multiply-add save where the f64 sum lands on an f32
    rounding tie (about 2**-29 of the elements)."""
    shape = (acc.shape[0], acc.shape[1]) + (1,) * (acc.dim() - 2)
    scale = (sx[:, None] * sw[None, :]).view(shape)
    y = acc.float().double() * scale.double()
    if bias is not None:
        y = y + bias.float().double().view(1, -1, *shape[2:])
    return y.float()


def conv_w8a8_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch; output in x's dtype.

    x: (N, Cin, [D,] H, W); weight: (Cout, Cin, [kd,] kh, kw); bias (Cout,).
    The integer sum runs as an f64 conv: every product and partial sum is
    an integer below 2**53, so it is exact in any order."""
    check_args(x, weight, bias)
    sx = sample_step(x)
    xq = quantize(x, sx.view(-1, *([1] * (x.dim() - 1))))
    wq, sw = quantize_weight(weight)
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    acc = conv(xq.double(), wq.double(),
               padding=tuple(k // 2 for k in weight.shape[2:]))
    return _dequantize(acc, sx, sw, bias).to(x.dtype)


def conv_w8a8(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 stride-1 SAME conv: the plain version on CPU tensors, the CUDA
    kernel on CUDA tensors."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return conv_w8a8_plain(x, weight, bias)
    return conv_w8a8_cuda(x, weight, bias)
