"""The toolchain probes: CUDA kernel wrappers and plain versions.

Replace the three Pallas probes of the JAX package's tools, whose kernels
``canonswap_torch/csrc/probes.cu`` computes (its header says what bounds
each on the H100):

  dyn_gather  ``tools/profile_r2b.py::dyn_gather`` -> ``dg_kernel``:
              ``out[b, r, c] = x[b, idx[b, r, c], c]``, i.e.
              ``take_along_axis(x[b], idx[b], axis=0)`` for each b (the
              probe maps it over a batch with ``jax.vmap``);
  dbl         ``tools/profile_r2c.py::dbl`` -> ``dbl_kernel``: ``x * 2``;
  mm          ``tools/profile_r2c.py::mm`` -> ``mm_kernel``: ``a @ b``,
              f32 in, f32 sums, f32 out.

The gather follows JAX's index semantics: an index in [-R, 0) wraps to
index + R and one outside [-R, R) gives NaN.  ``torch.gather`` raises on
both, so the plain version wraps and fills itself.  Its kernel has two
paths, chosen by shape alone (:func:`gather_strip_ok`), both counted as
the one ``GATHER`` launch and by path in ``GATHER_PATHS``:

  strip   R <= GATHER_R_MAX (1815), any C: a block stages a 32-column strip
          of one batch element's x in shared memory (bulk copies where C % 4
          == 0 and x is 16-byte aligned, else 4-byte copies), so x is read
          once in whole lines, then gathers from it.  Bound: the bytes of x,
          idx and out, moved in two phases per block;
  direct  past that: one thread per output element, reading x where the
          indices point.  Bound: one 32-byte sector of x per 4-byte value.

Device rule: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from canonswap_torch.ops.cuda.build import CudaKernel

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p

# three entry points of one source: one library, built once
GATHER = CudaKernel("probes.cu", "probes_gather",
                    [_c_ptr] * 3 + [_c_int] * 4 + [_c_ptr])
DOUBLE = CudaKernel("probes.cu", "probes_double",
                    [_c_ptr] * 2 + [ctypes.c_int64, _c_ptr])
MATMUL = CudaKernel("probes.cu", "probes_matmul",
                    [_c_ptr] * 3 + [_c_int] * 3 + [_c_ptr])

_INT_MAX = 2**31 - 1
MM_TILE_M = 64  # rows of the matmul's output tile (csrc/probes.cu kBM)
# the gather's strip: 32 f32 columns, one 128-byte line a row (csrc/probes.cu
# kStripCols), staged in the shared memory one block may use on Hopper
# (227 KB, 232,448 bytes) with its 8-byte barrier after it
GATHER_STRIP_BYTES = 4 * 32
GATHER_SMEM = 232_448
GATHER_R_MAX = (GATHER_SMEM - 8) // GATHER_STRIP_BYTES  # 1815
# launches of the gather by path, beside GATHER.launches (their sum)
GATHER_PATHS = {"strip": 0, "direct": 0}


def _check_cuda(name: str, tensors, dtypes) -> torch.device:
    """Raise on what the kernels do not take, dtypes first, then devices,
    then layout; returns the tensors' device.  One pass where all is well
    (the launch's host cost); :func:`_refuse` says what is wrong."""
    first = tensors[0]
    device = first.device
    for t, dtype in zip(tensors, dtypes):
        if (t.dtype != dtype or not t.is_cuda or not t.is_contiguous()
                or (t is not first and t.device != device)):
            _refuse(name, tensors, dtypes)
    return device


def _refuse(name: str, tensors, dtypes) -> None:
    for t, dtype in zip(tensors, dtypes):
        if t.dtype != dtype:
            raise TypeError(f"{name} takes {dtype}, got {t.dtype}")
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{name} needs its tensors on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    raise ValueError(f"{name} needs contiguous tensors")


# ---- gather --------------------------------------------------------------


def _check_gather_shapes(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dim() != 3 or idx.shape != x.shape:
        raise ValueError(f"dyn_gather wants x and idx of one shape (B, R, C), "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)}")


def dyn_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, r, c] = x[b, idx[b, r, c], c]`` with JAX's wrap of negative
    indices and NaN for an index outside [-R, R)."""
    _check_gather_shapes(x, idx)
    rows = x.shape[1]
    j = idx.long()
    j = torch.where(j < 0, j + rows, j)
    inside = (j >= 0) & (j < rows)
    got = torch.gather(x, 1, torch.where(inside, j, 0))
    return torch.where(inside, got, torch.full_like(got, float("nan")))


def gather_strip_ok(rows: int, cols: int) -> bool:
    """Whether the gather of (B, rows, cols) takes the strip path: a
    strip's ``rows`` x 128 bytes and its barrier fit the shared memory of
    one block.  Any ``cols`` >= 1 does (ragged strips included); past
    GATHER_R_MAX rows the direct path runs.  Shape alone decides."""
    return cols >= 1 and 1 <= rows <= GATHER_R_MAX


def dyn_gather_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel (x f32 and idx int32 on one card), on the
    strip path where :func:`gather_strip_ok`, else the direct path."""
    _check_gather_shapes(x, idx)
    device = _check_cuda("dyn_gather", (x, idx), (torch.float32, torch.int32))
    b, r, c = x.shape
    if max(b, r, c) > _INT_MAX:
        raise ValueError(f"dyn_gather: shape {tuple(x.shape)} out of range")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    strip = gather_strip_ok(r, c)
    GATHER.launch_on(device, x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     b, r, c, int(strip))
    GATHER_PATHS["strip" if strip else "direct"] += 1
    return out


def dyn_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The batched row gather (module docstring).  CPU tensors take the
    plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return dyn_gather_plain(x, idx)
    return dyn_gather_cuda(x, idx)


# ---- doubling ------------------------------------------------------------


def dbl_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def dbl_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the doubling kernel (f32 on a card)."""
    device = _check_cuda("dbl", (x,), (torch.float32,))
    out = torch.empty_like(x)
    n = out.numel()
    if n:
        DOUBLE.launch_on(device, x.data_ptr(), out.data_ptr(), n)
    return out


def dbl(x: torch.Tensor) -> torch.Tensor:
    """``x * 2``.  A CPU tensor takes the plain version; a CUDA tensor the
    kernel."""
    if x.device.type == "cpu":
        return dbl_plain(x)
    return dbl_cuda(x)


# ---- matmul --------------------------------------------------------------


def _check_mm_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mm wants a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in f64, rounded once to f32."""
    _check_mm_shapes(a, b)
    return (a.double() @ b.double()).float()


def mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the split-K f32 matmul kernel (f32 on one card)."""
    _check_mm_shapes(a, b)
    device = _check_cuda("mm", (a, b), (torch.float32, torch.float32))
    (m, k), n = a.shape, b.shape[1]
    if max(m, k, n) > _INT_MAX:
        raise ValueError(f"mm: shapes {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"out of range")
    if -(-m // MM_TILE_M) > 65535:
        raise ValueError(f"mm: M = {m} over the kernel's grid "
                         f"(65535 x {MM_TILE_M} rows)")
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if m and n:
        MATMUL.launch_on(device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         m, k, n)
    return out


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 (module docstring).  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mm_plain(a, b)
    return mm_cuda(a, b)
