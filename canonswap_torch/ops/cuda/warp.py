"""The trilinear warps: CUDA kernel wrappers and their plain versions.

Replace ``canonswap_tpu/ops/pallas/warp.py::grid_sample_3d_onehot``
(``_kernel`` / ``_kernel_win``): the exact form (quant=False) is
``canonswap_torch/csrc/warp3d.cu``, the W8A8 form of the fast bundle
(quant=True) ``canonswap_torch/csrc/warp3d_q.cu``.  Their headers say what
bounds them on the H100 and how the layout keeps corner reads coalesced;
the W8A8 kernel computes its per-sample steps on the card and gathers from
an int8 copy laid out channels last.

Device rule: a CPU volume goes to :func:`grid_sample_3d_plain`; a CUDA volume
launches the kernel or raises.  Nothing falls back.

Gradients: the exact warp on the card is an autograd function whose backward
is the kernel ``warp3d_backward`` (same source, f32 only; the JAX trainer
runs in f32): a copy of the volume laid out channels last, vector REDs into
a channels-last accumulator, and a transpose back, in one chained launch.
The W8A8 warp has no backward and raises under grad, as the other int8
kernels do: the JAX package never differentiates them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from canonswap_torch.ops.cuda.build import CudaKernel, forbid_grad
from canonswap_torch.ops.quant import INV127, quantize, sample_step

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

WARP3D = CudaKernel(
    "warp3d.cu", "warp3d_forward",
    [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int,
     _c_int, _c_int, _c_int, _c_ptr],
)

WARP3D_BWD = CudaKernel(
    "warp3d.cu", "warp3d_backward",
    [_c_ptr] * 6 + [_c_int] * 9 + [_c_ptr],
)

WARP3D_Q = CudaKernel(
    "warp3d_q.cu", "warp3d_q_forward",
    [_c_ptr] * 5 + [_c_int] * 8 + [_c_ptr],
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


def _check_cuda_args(vol: torch.Tensor, grid: torch.Tensor) -> None:
    """Raise on what the warp kernels do not take."""
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


def _launch_forward(vol: torch.Tensor, grid: torch.Tensor,
                    out: torch.Tensor) -> None:
    b, c, d, h, w = vol.shape
    WARP3D.launch_on(
        vol.device, vol.data_ptr(), grid.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[vol.dtype], _DTYPE_CODE[grid.dtype], b, c, d, h, w,
        out[0, 0].numel())


def backward_scratch(vol: torch.Tensor) -> tuple[int, torch.Tensor]:
    """The backward kernel's scratch: (Cp, buffer).  Cp is C rounded up to
    a multiple of 4, so a voxel's channels start on 16 bytes; the buffer
    (2, B, D, H, W, Cp) f32 holds the volume laid out channels last, then
    the grad_vol accumulator in that layout."""
    b, c, d, h, w = vol.shape
    cp = -(-c // 4) * 4
    return cp, torch.empty((2, b, d, h, w, cp), dtype=torch.float32,
                           device=vol.device)


def _launch_backward(vol: torch.Tensor, grid: torch.Tensor,
                     grad_out: torch.Tensor, grad_vol: torch.Tensor,
                     grad_grid: torch.Tensor) -> None:
    """Launch the backward; it writes grad_vol and grad_grid whole."""
    b, c, d, h, w = vol.shape
    cp, scratch = backward_scratch(vol)
    WARP3D_BWD.launch_on(
        vol.device, vol.data_ptr(), grid.data_ptr(), grad_out.data_ptr(),
        grad_vol.data_ptr(), grad_grid.data_ptr(), scratch.data_ptr(), b, c,
        cp, d, h, w, *grid.shape[1:4])


def _forward(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    b, c = vol.shape[:2]
    out = torch.empty((b, c, *grid.shape[1:4]), dtype=vol.dtype,
                      device=vol.device)
    if out.numel():
        _launch_forward(vol, grid, out)
    return out


def warp3d_backward_cuda(vol: torch.Tensor, grid: torch.Tensor,
                         grad_out: torch.Tensor):
    """Launch the backward kernel: (grad_vol, grad_grid) of the warp at
    ``vol`` / ``grid`` for ``grad_out`` (B, C, Do, Ho, Wo), all f32 and
    contiguous on one card.  The kernel writes both outputs whole, so they
    are allocated empty."""
    _check_cuda_args(vol, grid)
    if any(t.dtype != torch.float32 for t in (vol, grid, grad_out)):
        raise TypeError(
            f"warp3d_backward takes float32 only, got vol {vol.dtype}, grid "
            f"{grid.dtype}, grad_out {grad_out.dtype}")
    if (tuple(grad_out.shape) != (*vol.shape[:2], *grid.shape[1:4])
            or grad_out.device != vol.device
            or not grad_out.is_contiguous()):
        raise ValueError(
            f"warp3d_backward wants a contiguous grad_out "
            f"{(*vol.shape[:2], *grid.shape[1:4])} on {vol.device}, got "
            f"{tuple(grad_out.shape)} on {grad_out.device}")
    grad_vol, grad_grid = torch.empty_like(vol), torch.empty_like(grid)
    if grad_out.numel() and vol.numel():
        _launch_backward(vol, grid, grad_out, grad_vol, grad_grid)
    else:  # nothing to sample: both gradients are 0
        grad_vol.zero_()
        grad_grid.zero_()
    return grad_vol, grad_grid


def warp3d_backward_plain(vol: torch.Tensor, grid: torch.Tensor,
                          grad_out: torch.Tensor):
    """The backward kernel's function in plain PyTorch: the autograd
    gradient of :func:`grid_sample_3d_plain` (``F.grid_sample`` in f32)."""
    with torch.enable_grad():
        v = vol.detach().float().requires_grad_()
        g = grid.detach().float().requires_grad_()
        out = grid_sample_3d_plain(v, g)
        return torch.autograd.grad(out, (v, g), grad_out.float())


class Warp3d(torch.autograd.Function):
    """The exact warp on the card with its hand-written backward."""

    @staticmethod
    def forward(ctx, vol, grid):
        ctx.save_for_backward(vol, grid)
        return _forward(vol, grid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        vol, grid = ctx.saved_tensors
        grad_vol, grad_grid = warp3d_backward_cuda(
            vol, grid, grad_out.contiguous())
        return (grad_vol if ctx.needs_input_grad[0] else None,
                grad_grid if ctx.needs_input_grad[1] else None)


def grid_sample_3d_cuda(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``vol`` / ``grid`` (both on one card).
    Under grad mode with an input that requires grad, the result carries
    :class:`Warp3d`'s backward (f32 only)."""
    _check_cuda_args(vol, grid)
    if torch.is_grad_enabled() and (vol.requires_grad or grid.requires_grad):
        if vol.dtype != torch.float32 or grid.dtype != torch.float32:
            raise TypeError(
                f"warp3d_backward takes float32 only (the JAX trainer runs "
                f"in f32), got vol {vol.dtype}, grid {grid.dtype} that "
                f"require grad")
        return Warp3d.apply(vol, grid)
    return _forward(vol, grid)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinear grid sample, zero padding, align_corners=False.

    vol: (B, C, D, H, W); grid: (B, Do, Ho, Wo, 3), xyz in [-1, 1].
    Returns (B, C, Do, Ho, Wo) in vol's dtype.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if vol.device.type == "cpu" and grid.device.type == "cpu":
        return grid_sample_3d_plain(vol, grid)
    return grid_sample_3d_cuda(vol, grid)


def _taps(g: torch.Tensor, size: int):
    """One axis, as the JAX kernel computes it: the coordinate
    ((g + 1) * size - 1) * 0.5, the two taps floor(c) and floor(c) + 1 (as
    f32), their tents max(0, 1 - |a - c|) and whether each is inside."""
    c = ((g + 1.0) * size - 1.0) * 0.5
    a0 = torch.floor(c)
    a1 = a0 + 1.0
    taps = []
    for a in (a0, a1):
        tent = torch.clamp(1.0 - (a - c).abs(), min=0.0)
        taps.append((a, tent, (a >= 0) & (a <= size - 1)))
    return taps


def grid_sample_3d_quant_plain(vol: torch.Tensor,
                               grid: torch.Tensor) -> torch.Tensor:
    """The W8A8 kernel's function in plain PyTorch (an explicit 8-corner
    gather, not ``F.grid_sample``, whose weights are formed differently).

    Per sample, the volume is quantized with the step max|vol|/127 + 1e-12;
    each in-volume xy corner gets the int8 weight round(127 t_y t_x); per
    in-volume z tap the integer sum is dequantized with step * f32(1/127)
    and weighted by the z tent in f32.  The integer sums are exact in f32
    (at most 4 * 127**2 < 2**24).

    vol: (B, C, D, H, W); grid: (B, Do, Ho, Wo, 3), xyz in [-1, 1].
    Returns (B, C, Do, Ho, Wo) in vol's dtype."""
    b, c, d, h, w = vol.shape
    step = sample_step(vol)
    q = quantize(vol, step.view(b, 1, 1, 1, 1)).float().reshape(b, c, -1)
    g = grid.float().reshape(b, 1, -1, 3)
    tx, ty, tz = _taps(g[..., 0], w), _taps(g[..., 1], h), _taps(g[..., 2], d)
    scale = step * INV127
    out = torch.zeros((b, c, g.shape[2]), dtype=torch.float32,
                      device=vol.device)
    for zi, tzw, zok in tz:
        acc = torch.zeros_like(out)
        for yi, tyw, yok in ty:
            for xi, txw, xok in tx:
                qw = torch.round(tyw * txw * 127.0)
                ok = zok & yok & xok
                idx = torch.where(ok, (zi * h + yi) * w + xi, 0).long()
                vals = torch.gather(q, 2, idx.expand(b, c, -1))
                acc = acc + torch.where(ok, qw, 0.0) * vals
        s = acc * scale.view(b, 1, 1)
        out = out + torch.where(zok, s * tzw, 0.0)
    return out.reshape(b, c, *grid.shape[1:4]).to(vol.dtype)


def grid_sample_3d_quant_cuda(vol: torch.Tensor,
                              grid: torch.Tensor) -> torch.Tensor:
    """Launch the W8A8 CUDA kernel on ``vol`` / ``grid`` (one card).
    It has no backward: raises under grad on an input that requires it."""
    forbid_grad("warp3d_q (the W8A8 warp)", vol, grid)
    _check_cuda_args(vol, grid)
    b, c, d, h, w = vol.shape
    do, ho, wo = grid.shape[1:4]
    p = do * ho * wo
    out = torch.empty((b, c, do, ho, wo), dtype=vol.dtype, device=vol.device)
    if out.numel() == 0:
        return out
    # scratch: the int8 copy, channels last and zero-padded to a multiple
    # of 16, and the per-sample maxima the kernel's steps come from
    cp = -(-c // 16) * 16
    q = torch.empty((b, d, h, w, cp), dtype=torch.int8, device=vol.device)
    amax = torch.empty(b, dtype=torch.float32, device=vol.device)
    WARP3D_Q.launch_on(
        vol.device, vol.data_ptr(), grid.data_ptr(), out.data_ptr(),
        q.data_ptr(), amax.data_ptr(), _DTYPE_CODE[vol.dtype],
        _DTYPE_CODE[grid.dtype], b, c, cp, d, h, w, p)
    return out


def grid_sample_3d_quant(vol: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """W8A8 trilinear grid sample (the fast bundle's warp), zero padding,
    align_corners=False.  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if vol.device.type == "cpu" and grid.device.type == "cpu":
        return grid_sample_3d_quant_plain(vol, grid)
    return grid_sample_3d_quant_cuda(vol, grid)
