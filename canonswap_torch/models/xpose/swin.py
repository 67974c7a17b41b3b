"""Swin Transformer backbone of UniPose (Swin-T), channels-last at its
interface.

Port of ``canonswap_tpu/models/xpose/swin.py`` (the reference's vendored
swin_transformer.py, 'swin_T_224_1k'): patch embed, four stages of window
attention with a relative position bias and shifted windows, a per-stage
LayerNorm on the stages it returns.  Windows are padded at the bottom and
right with zeros, as the reference's F.pad does.  Module names are the
reference checkpoint's (``backbone.0.patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm{i}``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The port's copy of the JAX package's ``SwinConfig`` (a test holds
    them equal)."""

    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    out_indices: tuple[int, ...] = (1, 2, 3)

    @property
    def num_features(self) -> tuple[int, ...]:
        return tuple(int(self.embed_dim * 2**i) for i in range(len(self.depths)))


def rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) relative-position bias index (swin_transformer.py:78-90)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int64)


def shift_attn_mask(hp: int, wp: int, ws: int, shift: int,
                    device) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) mask of shifted windows (swin_transformer.py:
    232-247): -100 between tokens of different regions of the rolled canvas,
    0 within one.  A row's region is 0 above hp - ws, 1 above hp - shift,
    else 2 (the reference's three slices); the label is 3 * row + column."""
    def region(n):
        i = torch.arange(n, device=device)
        return (i >= n - ws).long() + (i >= n - shift).long()

    img = region(hp)[:, None] * 3 + region(wp)[None, :]
    wins = img.view(hp // ws, ws, wp // ws, ws).transpose(1, 2).reshape(
        -1, ws * ws)
    diff = wins[:, None, :] != wins[:, :, None]
    return torch.where(diff, -100.0, 0.0).to(torch.float32)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias (swin_transformer.py:95-160)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(rel_pos_index(window_size)).reshape(-1),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        """x (nW*B, ws*ws, C); mask (nW, ws*ws, ws*ws) or None."""
        bnw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(bnw, n, 3, h, hd).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * (hd**-0.5), k)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bnw // nw, nw, h, n, n) + mask[None, :, None]
            attn = attn.reshape(bnw, h, n, n)
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bnw, n, c)
        return self.proj(out)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C); H, W multiples of ws."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // ws, ws, ww // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, hh: int, ww: int):
    b = wins.shape[0] // ((hh // ws) * (ww // ws))
    x = wins.reshape(b, hh // ws, ww // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, -1)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hh: int, ww: int) -> torch.Tensor:
        """x (B, H*W, C)."""
        b, _, c = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).reshape(b, hh, ww, c)
        pad_b = (ws - hh % ws) % ws
        pad_r = (ws - ww % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = hh + pad_b, ww + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = shift_attn_mask(hp, wp, ws, shift, x.device)
        wins = self.attn(window_partition(x, ws), mask)
        x = window_reverse(wins, ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :hh, :ww].reshape(b, hh * ww, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 patch merge (swin_transformer.py:163-199): (x0 x1 x2 x3) with
    x{i} = x[i % 2::2, i // 2::2], after a zero pad to even sizes; LN;
    linear 4C -> 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hh: int, ww: int):
        b, _, c = x.shape
        x = F.pad(x.reshape(b, hh, ww, c), (0, 0, 0, ww % 2, 0, hh % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        hh2, ww2 = (hh + 1) // 2, (ww + 1) // 2
        x = self.norm(x.reshape(b, hh2 * ww2, 4 * c))
        return self.reduction(x), hh2, ww2


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)


class _Stage(nn.Module):
    def __init__(self, c: SwinConfig, i: int):
        super().__init__()
        dim = c.num_features[i]
        self.blocks = nn.ModuleList(
            SwinBlock(dim, c.num_heads[i], c.window_size,
                      0 if j % 2 == 0 else c.window_size // 2, c.mlp_ratio)
            for j in range(c.depths[i]))
        if i < len(c.depths) - 1:
            self.downsample = PatchMerging(dim)


class SwinTransformer(nn.Module):
    """image (B, H, W, 3) -> {stage: (B, Hi, Wi, Ci)} for cfg.out_indices."""

    def __init__(self, cfg: SwinConfig = SwinConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg.patch_size, cfg.embed_dim)
        self.layers = nn.ModuleList(
            _Stage(cfg, i) for i in range(len(cfg.depths)))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}",
                            nn.LayerNorm(cfg.num_features[i], eps=1e-5))

    def forward(self, image: torch.Tensor) -> dict[int, torch.Tensor]:
        x = self.patch_embed.proj(image.permute(0, 3, 1, 2))
        b, _, hh, ww = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = {}
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = block(x, hh, ww)
            if i in self.cfg.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs[i] = y.reshape(b, hh, ww, -1)
            if i < len(self.layers) - 1:
                x, hh, ww = stage.downsample(x, hh, ww)
        return outs
