"""Resizing and pooling primitives on NC* tensors.

Port of ``canonswap_tpu/ops/resize.py`` (the parts the generator, the
sidecars, SCRFD and ArcFace use), plus the stand-ins for ``cv2.resize``
(bilinear, and INTER_AREA) that the runners and the Cropper use on the
card.  The JAX package is channels-last and needs transposes for these;
in PyTorch's NCDHW layout the depth flatten of the reference
(``view(B, C*D, H, W)``, flat channel = c*D + d) is a plain view.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size): ``jax.image.resize(method="linear")``.
    Where it upsamples, the half-pixel bilinear map of
    ``F.interpolate(align_corners=False)``: the triangle kernel, whose
    out-of-image taps jax drops and renormalizes, which is the edge clamp.
    Where it downsamples, jax widens the kernel by the scale (antialiasing),
    which is ``antialias=True``; that form is computed in f32 and cast back,
    as XLA sums the scaled weights in f32 and rounds once."""
    if size[0] < x.shape[-2] or size[1] < x.shape[-1]:
        return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=True).to(x.dtype)
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def resize_like_cv2(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) on a (H, W, C) uint8
    tensor, on its device: bilinear at half-pixel centres, no antialias,
    rounded half up to uint8 as cv2 rounds.  cv2 forms its weights in
    11-bit fixed point, so the two differ by at most one grey level where a
    value falls near a rounding step."""
    out = F.interpolate(img.permute(2, 0, 1)[None].float(), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=False)
    return torch.floor(out + 0.5).clamp(0, 255)[0].permute(1, 2, 0).to(
        torch.uint8)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of cv2's area decimation along one axis
    (``computeResizeAreaTab``): output cell [i s, (i + 1) s), s = n_in /
    n_out, covers each source pixel by its overlap, over the cell's width;
    slivers of at most 1e-3 pixel are dropped, as cv2 drops them."""
    s = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        f1 = i * s
        f2 = f1 + s
        cell = min(s, n_in - f1)
        x2 = min(math.floor(f2), n_in - 1)
        x1 = min(math.ceil(f1), x2)
        if x1 - f1 > 1e-3:
            w[i, x1 - 1] = (x1 - f1) / cell
        w[i, x1:x2] = 1.0 / cell
        if f2 - x2 > 1e-3:
            w[i, x2] = min(f2 - x2, 1.0, cell) / cell
    return w


def area_resize_like_cv2(img: torch.Tensor, size: tuple[int, int]
                         ) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` on a
    (H, W, C) uint8 tensor, on its device, for a downscale (``size`` is
    (h, w), at most the input's).

    At integer factors cv2 takes the box mean: at 2 x 2 rounded half up,
    ``(sum + 2) >> 2``, else ``sum * (1 / area)`` in f32 rounded half to
    even; here the same, bit for bit.  At a fractional factor each source
    pixel counts by its fractional coverage of the output cell
    (:func:`_area_weights`, a separable weighting in f32, rounded half to
    even), which ``F.interpolate(mode="area")`` does not do (it takes whole
    pixels); cv2 sums in another order, so the two differ by at most one
    grey level where a value falls near a rounding step."""
    h, w, c = img.shape
    oh, ow = size
    if oh > h or ow > w:
        raise ValueError(f"area_resize_like_cv2 downscales only: "
                         f"{(h, w)} -> {(oh, ow)}")
    if h % oh == 0 and w % ow == 0:
        fy, fx = h // oh, w // ow
        s = img.reshape(oh, fy, ow, fx, c).to(torch.int32).sum(dim=(1, 3))
        if (fy, fx) == (2, 2):
            return ((s + 2) >> 2).to(torch.uint8)
        inv = torch.tensor(1.0 / (fy * fx), dtype=torch.float32)
        return torch.round(s.float() * inv.to(img.device)).clamp(
            0, 255).to(torch.uint8)
    wy = torch.from_numpy(_area_weights(h, oh)).float().to(img.device)
    wx = torch.from_numpy(_area_weights(w, ow)).float().to(img.device)
    x = img.permute(2, 0, 1).float()  # (C, H, W)
    out = wy @ x @ wx.T  # (C, oh, ow)
    return torch.round(out).clamp(0, 255).permute(1, 2, 0).to(torch.uint8)


def max_pool(x: torch.Tensor, window: tuple[int, int],
             strides: tuple[int, int] | None = None,
             padding: int = 0) -> torch.Tensor:
    """Max pool over (N, C, H, W); stride defaults to the window.
    ``padding`` pads with -inf on every side, as the JAX package's
    ``jnp.pad(-inf)`` before a VALID pool (SCRFD's stem)."""
    return F.max_pool2d(x, window, strides if strides is not None
                        else window, padding=padding)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]
                      ) -> torch.Tensor:
    """torch ``F.adaptive_avg_pool2d`` on (N, C, H, W): bin i covers rows
    [floor(i H / oh), ceil((i + 1) H / oh)), as the JAX version computes
    (ArcFace: 14 -> 7)."""
    return F.adaptive_avg_pool2d(x, out_hw)


def nearest_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(mode="nearest")`` on (N, C, H, W): floor
    mapping, source index = floor(i * in / out) in integers."""
    h, w = x.shape[-2:]
    oh, ow = size
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x[..., rows, :][..., cols]


def volume_to_2d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C*D, H, W), flat channel = c*D + d."""
    b, c, d, h, w = x.shape
    return x.reshape(b, c * d, h, w)


def volume_from_2d(x: torch.Tensor, depth: int) -> torch.Tensor:
    """Inverse of :func:`volume_to_2d`: (B, C*D, H, W) -> (B, C, D, H, W)."""
    b, cd, h, w = x.shape
    return x.reshape(b, cd // depth, depth, h, w)


def nearest_upsample(x: torch.Tensor, factors: tuple[int, ...]) -> torch.Tensor:
    """Integer nearest-neighbour upsample of (N, C, *spatial), one factor per
    spatial dim (torch ``F.interpolate(mode="nearest")`` at integer scale)."""
    for i, f in enumerate(factors):
        if f != 1:
            x = x.repeat_interleave(f, dim=2 + i)
    return x


def avg_pool(x: torch.Tensor, window: tuple[int, ...]) -> torch.Tensor:
    """Average pool with stride == window (VALID) over the spatial dims of
    (N, C, *spatial): a reshape and a mean, so any dtype on any device."""
    n, c, *spatial = x.shape
    out = [s // k for s, k in zip(spatial, window)]
    x = x[(..., *(slice(0, o * k) for o, k in zip(out, window)))]
    split = [d for o, k in zip(out, window) for d in (o, k)]
    dims = tuple(3 + 2 * i for i in range(len(window)))
    return x.reshape(n, c, *split).mean(dim=dims)

