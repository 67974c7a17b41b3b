"""Multi-scale deformable attention: CUDA kernel wrapper and plain version.

Replaces ``canonswap_tpu/ops/pallas/ms_deform_attn.py::ms_deform_attn_pallas``
(``_run_level`` -> ``_level_kernel``), whose function is
``canonswap_tpu/ops/ms_deform_attn.py::ms_deform_attn_ref``.  The kernel is
``canonswap_torch/csrc/ms_deform_attn.cu``: its header says what bounds it
on the H100 and how a block gathers all levels for a run of queries of one
head, with every corner load of a query in flight before the first sum.

The JAX contract:

  value               (N, sum_l H_l*W_l, M, D)
  spatial_shapes      ((H_0, W_0), ..., (H_{L-1}, W_{L-1}))  (static)
  sampling_locations  (N, Lq, M, L, P, 2), (x, y) in [0, 1]
  attention_weights   (N, Lq, M, L, P)
  output              (N, Lq, M*D)

Per query and head, P points per level are sampled bilinearly
(``align_corners=False``, zero padding) and summed with the weights.

Device rule: CPU tensors take :func:`ms_deform_attn_plain`; CUDA tensors
launch the kernel or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from canonswap_torch.ops.cuda.build import CudaKernel, forbid_grad

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

MAX_LEVELS = 8  # the kernel's level table (csrc/ms_deform_attn.cu)
MAX_CHANNELS = 128  # D per head: four 32-lane chunks of one warp

MSDA = CudaKernel(
    "ms_deform_attn.cu", "ms_deform_attn_forward",
    [_c_ptr] * 5 + [_c_int] * 7 + [_c_ptr],
)


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in ``ms_deform_attn_ref``'s
    form: per level ``F.grid_sample`` (bilinear, zeros, align_corners=False)
    at ``2 * loc - 1``, then the weighted sum over levels and points."""
    n, _, m, d = value.shape
    _, lq, _, n_levels, p, _ = sampling_locations.shape
    sizes = [h * w for h, w in spatial_shapes]
    grids = 2.0 * sampling_locations - 1.0
    sampled = []
    for lvl, (v, (h, w)) in enumerate(zip(value.split(sizes, dim=1),
                                          spatial_shapes)):
        # (N, H*W, M, D) -> (N*M, D, H, W); grid (N*M, Lq, P, 2)
        v = v.permute(0, 2, 3, 1).reshape(n * m, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(n * m, lq, p, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))  # (N*M, D, Lq, P)
    att = attention_weights.transpose(1, 2).reshape(n * m, 1, lq,
                                                    n_levels * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * att).sum(-1)
    return out.view(n, m * d, lq).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=64)
def _level_table(shapes: tuple) -> tuple[ctypes.Array, int, int]:
    """((H, W) per level as the C ints the entry point reads, its address,
    the rows the levels cover); cached, so a call builds no ctypes array."""
    table = (ctypes.c_int * (2 * len(shapes)))(*[int(x) for hw in shapes
                                                  for x in hw])
    return table, ctypes.addressof(table), sum(int(h) * int(w)
                                               for h, w in shapes)


def _levels(spatial_shapes) -> tuple[ctypes.Array, int, int]:
    """:func:`_level_table` of the shapes as given where they hash (a tuple
    of pairs, as the models pass them), else of the same shapes as tuples."""
    try:
        return _level_table(spatial_shapes)
    except TypeError:  # a list: unhashable, so no cache key as it stands
        return _level_table(tuple(tuple(hw) for hw in spatial_shapes))


def _fits(value, n_shapes: int, rows: int, loc, weights) -> bool:
    """Whether the kernel takes these arguments: one pass, the launch's host
    cost where all is well (:func:`_refuse` says what is wrong)."""
    if value.dim() != 4 or loc.dim() != 6 or weights.dim() != 5:
        return False
    n, s, m, d = value.shape
    lshape = loc.shape
    dev = value.get_device()
    return (value.dtype == loc.dtype == weights.dtype == torch.float32
            and dev >= 0 and loc.get_device() == dev
            and weights.get_device() == dev
            and value.is_contiguous() and loc.is_contiguous()
            and weights.is_contiguous() and lshape[0] == n
            and lshape[2] == m and lshape[5] == 2
            and weights.shape == lshape[:5]
            and n_shapes == lshape[3] and 1 <= n_shapes <= MAX_LEVELS
            and rows == s and 1 <= d <= MAX_CHANNELS
            and max(n * lshape[1] * m, n * s) < 2**31)


def _refuse(value, spatial_shapes, loc, weights) -> None:
    """Raise on what the kernel does not take: shapes, then dtype, then
    devices."""
    tensors = (value, loc, weights)
    if value.dim() != 4 or loc.dim() != 6 or weights.dim() != 5:
        raise ValueError(
            f"ms_deform_attn wants value (N, S, M, D), locations "
            f"(N, Lq, M, L, P, 2) and weights (N, Lq, M, L, P), got "
            f"{tuple(value.shape)}, {tuple(loc.shape)}, "
            f"{tuple(weights.shape)}")
    n, s, m, d = value.shape
    _, lq, _, n_levels, p, _ = loc.shape
    if (loc.shape[0] != n or loc.shape[2] != m or loc.shape[5] != 2
            or tuple(weights.shape) != (n, lq, m, n_levels, p)):
        raise ValueError(
            f"ms_deform_attn: locations {tuple(loc.shape)} and weights "
            f"{tuple(weights.shape)} do not fit value {tuple(value.shape)}")
    if len(spatial_shapes) != n_levels or not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(
            f"ms_deform_attn: {len(spatial_shapes)} spatial shapes for "
            f"{n_levels} levels (the kernel takes 1 to {MAX_LEVELS})")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(
            f"ms_deform_attn: spatial shapes {spatial_shapes} cover "
            f"{sum(h * w for h, w in spatial_shapes)} rows, value has {s}")
    if not 1 <= d <= MAX_CHANNELS:
        raise ValueError(f"ms_deform_attn: D = {d} per head, the kernel "
                         f"takes 1 to {MAX_CHANNELS}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "ms_deform_attn takes float32 only, got "
            + ", ".join(str(t.dtype) for t in tensors))
    if not all(t.is_cuda and t.device == value.device for t in tensors):
        raise ValueError(
            "ms_deform_attn needs value, locations and weights on one CUDA "
            "device, got " + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ms_deform_attn needs contiguous tensors")
    raise ValueError("ms_deform_attn: a size over the kernel's int range")


def ms_deform_attn_cuda(value: torch.Tensor, spatial_shapes,
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (all three tensors on one card, f32).  It has
    no backward: raises under grad on an input that requires it."""
    forbid_grad("ms_deform_attn", value, sampling_locations,
                attention_weights)
    _, table, rows = _levels(spatial_shapes)
    if not _fits(value, len(spatial_shapes), rows, sampling_locations,
                 attention_weights):
        _refuse(value, spatial_shapes, sampling_locations, attention_weights)
    n, s, m, d = value.shape
    _, lq, _, n_levels, p, _ = sampling_locations.shape
    out = value.new_empty((n, lq, m * d))
    if out.numel() == 0:
        return out
    # (H, W) per level, read by the C entry point from host memory
    MSDA.launch_on(
        value.device, value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(), table, n, s, m, d, lq,
        n_levels, p)
    return out


def ms_deform_attn(value: torch.Tensor, spatial_shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention (the module docstring's contract).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if all(t.device.type == "cpu"
           for t in (value, sampling_locations, attention_weights)):
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                               attention_weights)
