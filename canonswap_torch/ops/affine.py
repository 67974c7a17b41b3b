"""Batched affine warping and mask ops on the device.

Port of ``canonswap_tpu/ops/affine.py`` (the reference's crop.py:21-96,
515-529).  SoftErosion: a radial kernel blurs a single-channel mask, the
first ``iterations - 1`` passes keep the minimum of the mask and its blur,
and the last blur is split at ``threshold``: 1 above it, and below it
renormalized by its own maximum per image.  The binary dilation, erosion
and box blur pad as XLA's SAME does.  :func:`warp_affine_batch` and
:func:`paste_back_batch` warp in pixel coordinates, bilinear, zero outside,
in the images' dtype, as the JAX versions do; their sampler,
:func:`sample_bilinear`, also serves ``utils/geometry.py::paste_back``.
Channels-last at the public functions, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from canonswap_torch.ops.resize import bilinear_resize


def _radial_kernel(kernel_size: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(k, k) weights falling linearly with the distance from the centre,
    zero at the farthest corner, summing to 1."""
    r = kernel_size // 2
    ax = torch.arange(kernel_size, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    dist = torch.sqrt((xx - r) ** 2 + (yy - r) ** 2)
    k = dist.max() - dist
    return k / k.sum()


def soft_erosion(x: torch.Tensor, kernel_size: int = 21,
                 threshold: float = 0.9, iterations: int = 3):
    """x: (B, H, W, 1) in [0, 1] -> (soft mask, hard mask), both
    (B, H, W, 1); the blur is a SAME (zero-padded) conv."""
    k = _radial_kernel(kernel_size, x.dtype, x.device)[None, None]
    pad = kernel_size // 2
    v = x.permute(0, 3, 1, 2)

    def blur(t):
        return F.conv2d(t, k, padding=pad)

    for _ in range(iterations - 1):
        v = torch.minimum(v, blur(v))
    v = blur(v).permute(0, 2, 3, 1)
    hard = v >= threshold
    below_max = torch.where(hard, 0.0, v).amax(dim=(1, 2, 3), keepdim=True)
    soft = torch.where(hard, 1.0, v / below_max.clamp_min(1e-6))
    return soft, hard


def _same_pool(mask: torch.Tensor, kernel_size: int, value: float,
               pool) -> torch.Tensor:
    """``pool`` (stride 1) over (B, H, W, C) with XLA's SAME padding of
    ``value``: (k - 1) // 2 before, k // 2 after."""
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    x = F.pad(mask.permute(0, 3, 1, 2), (lo, hi, lo, hi), value=value)
    return pool(x, kernel_size, stride=1).permute(0, 2, 3, 1)


def dilate_mask(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """(B, H, W, C) binary dilation (crop.py:75-79): 1 where the k x k
    window holds a positive value."""
    out = _same_pool(mask, kernel_size, float("-inf"), F.max_pool2d)
    return (out > 0).to(mask.dtype)


def erode_mask(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """(B, H, W, C) binary erosion via a min pool (crop.py:81-85)."""
    out = -_same_pool(-mask, kernel_size, float("-inf"), F.max_pool2d)
    return (out > 0).to(mask.dtype)


def smooth_mask(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """(B, H, W, C) box blur with zero padding, over k * k (crop.py:87-91)."""
    # the zeros are padded in, so avg_pool2d divides every window by k * k
    return _same_pool(mask, kernel_size, 0.0, F.avg_pool2d)


def blend_images(fg: torch.Tensor, bg: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """mask * fg + (1 - mask) * bg, (B, H, W, C), with bg bilinearly
    upsampled to fg's size first where it is smaller (crop.py:93-96)."""
    if bg.shape[1:3] != fg.shape[1:3]:
        bg = bilinear_resize(bg.permute(0, 3, 1, 2),
                             tuple(fg.shape[1:3])).permute(0, 2, 3, 1)
    return fg * mask + bg * (1.0 - mask)


def sample_bilinear(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear samples of img (B, H, W, C) at pixel positions ``sx``,
    ``sy`` (B, oh, ow) -> (B, oh, ow, C) in ``sx``'s dtype: the four
    corners weighted exactly, each corner outside the image counting zero,
    summed in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    b, h, w, c = img.shape
    oh, ow = sx.shape[1:]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(b, h * w, c).to(sx.dtype)
    out = torch.zeros((b, oh, ow, c), dtype=sx.dtype, device=sx.device)
    for dy in (0, 1):
        yi = y0 + dy
        wy = fy if dy else 1.0 - fy
        for dx in (0, 1):
            xi = x0 + dx
            wt = wy * (fx if dx else 1.0 - fx)
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
            g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            out = out + torch.where(inside, wt, 0.0)[..., None] * g.reshape(
                b, oh, ow, c)
    return out


def warp_affine_batch(img: torch.Tensor, M: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    """Batched affine warp in pixel coordinates: img (B, H, W, C), M
    (B, 2, 3) or (B, 3, 3) mapping source to destination pixels ->
    (B, oh, ow, C), ``dst(p) = src(M^-1 p)``, bilinear, zeros outside."""
    b = img.shape[0]
    oh, ow = out_hw
    last = torch.tensor([[0.0, 0.0, 1.0]], dtype=M.dtype,
                        device=M.device).expand(b, 1, 3)
    minv = torch.linalg.inv(torch.cat([M[:, :2, :], last], dim=1))
    gy, gx = torch.meshgrid(
        torch.arange(oh, dtype=img.dtype, device=img.device),
        torch.arange(ow, dtype=img.dtype, device=img.device), indexing="ij")
    dst = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (oh, ow, 3)
    src = torch.einsum("bij,hwj->bhwi", minv[:, :2, :].to(img.dtype), dst)
    return sample_bilinear(img, src[..., 0], src[..., 1])


def paste_back_batch(crops: torch.Tensor, M_c2o: torch.Tensor,
                     originals: torch.Tensor,
                     masks_ori: torch.Tensor) -> torch.Tensor:
    """Batched paste-back (crop.py:523-529): warp the crops (B, hc, wc, 3)
    into the frames by M_c2o (B, 3, 3) and blend through masks_ori
    (B, H, W, 1 or 3); float in, float out."""
    h, w = originals.shape[1:3]
    warped = warp_affine_batch(crops, M_c2o, (h, w))
    return masks_ori * warped + (1.0 - masks_ori) * originals
