"""Resizing and pooling primitives on NC* tensors.

Port of ``canonswap_tpu/ops/resize.py`` (the parts the generator and the
sidecars use), plus the stand-in for ``cv2.resize`` that the runners use on
the card.  The JAX package is channels-last and needs transposes for these;
in PyTorch's NCDHW layout the depth flatten of the reference
(``view(B, C*D, H, W)``, flat channel = c*D + d) is a plain view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size): ``jax.image.resize(method="linear")``
    where it upsamples.  There it is the half-pixel bilinear map of
    ``F.interpolate(align_corners=False)``: the triangle kernel, whose
    out-of-image taps jax drops and renormalizes, which is the edge clamp.
    Downsampling raises: jax then widens the kernel (antialiasing), which
    nothing of the port needs."""
    if size[0] < x.shape[-2] or size[1] < x.shape[-1]:
        raise ValueError(
            f"bilinear_resize upsamples only (jax.image.resize antialiases "
            f"a downsample): {tuple(x.shape[-2:])} -> {tuple(size)}")
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

