"""Segformer face parsing and its mask post-processing.

Port of ``canonswap_tpu/models/parsing.py`` (the reference calls HF's
``SegformerForSemanticSegmentation``, "jonathandinu/face-parsing", 19
classes, per frame: can_swap_pipeline_e2e.py:51-54, 177-191).  The MiT
encoder (overlapping patch embeddings, efficient attention with spatial
reduction, Mix-FFN with a depthwise conv) and the all-MLP decode head.
Module names are HF's state-dict keys, so a HF checkpoint loads with
``load_state_dict(strict=True)``; ``runtime/weights.py::segformer_from_jax``
carries the JAX variables over.

The modules take and give channels-last tensors, (B, H, W, C), as the JAX
modules do.  What is copied exactly from the JAX package: LayerNorm epsilon
1e-5 on the patch and ``sr`` norms and 1e-6 on the block and stage norms;
exact GELU; BatchNorm in eval mode; the decode head's concat in reversed
(HF) order; the ``sr`` conv's SAME padding (flax's default, which equals HF's
zero padding where each stage's size divides by its ratio); argmax ties to
the first index.  Attention is plain matmul and softmax, as the JAX module
computes it.

:class:`FaceParser` is the JAX session's ``parse_masks``
(``pipelines/session.py:302-312``): preprocess, Segformer on the 256 crops,
the swap-region mask at the output size, SoftErosion.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.affine import soft_erosion
from canonswap_torch.ops.resize import bilinear_resize
from canonswap_torch.runtime.device import resolve_device

# face-swap region classes (skin/brows/eyes/ears/nose/mouth),
# can_swap_pipeline_e2e.py:53
VALID_CLASSES = (1, 2, 4, 5, 6, 7, 10, 11, 12)

# HF SegformerImageProcessor: rescale 1/255, then the ImageNet statistics
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    hidden_sizes: tuple[int, ...] = (64, 128, 320, 512)  # MiT-B1 (face-parsing)
    depths: tuple[int, ...] = (2, 2, 2, 2)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: tuple[int, ...] = (7, 3, 3, 3)
    strides: tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden: int = 256
    num_labels: int = 19


# test width (tests/test_parsing_parity.py's): one block a stage
TINY = SegformerConfig(hidden_sizes=(16, 24, 40, 64), depths=(1, 1, 1, 1),
                       num_heads=(1, 2, 5, 8), decoder_hidden=64)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax's SAME padding of an NCHW input for a (kernel, stride) conv:
    ceil(n / stride) outputs, the low side padded by half the total."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad's order: W, then H
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class EfficientAttention(nn.Module):
    """Multi-head attention whose keys and values come from the input
    reduced by a ``sr_ratio``-strided conv.  (B, H, W, C) -> (B, H, W, C).
    Keys: HF's ``attention.self.*`` and ``attention.output.dense``."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        attn = nn.Module()
        attn.query = nn.Linear(dim, dim)
        attn.key = nn.Linear(dim, dim)
        attn.value = nn.Linear(dim, dim)
        if sr_ratio > 1:
            attn.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            attn.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.self = attn
        self.output = nn.Module()
        self.output.dense = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hd = c // self.heads
        a = self.self
        q = a.query(x.reshape(b, h * w, c))
        if self.sr_ratio > 1:
            r = self.sr_ratio
            kv = _nhwc(a.sr(_same_pad(_nchw(x), r, r))).reshape(b, -1, c)
            kv = a.layer_norm(kv)
        else:
            kv = x.reshape(b, h * w, c)
        k, v = a.key(kv), a.value(kv)

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, h * w, c)
        return self.output.dense(out).reshape(b, h, w, c)


class MixFFN(nn.Module):
    """dense1 -> depthwise 3x3 (SAME) -> exact GELU -> dense2, channels
    last.  Keys: HF's ``mlp.dense1``, ``mlp.dwconv.dwconv``,
    ``mlp.dense2``."""

    def __init__(self, dim: int, ratio: int):
        super().__init__()
        hidden = dim * ratio
        self.dense1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1,
                                       groups=hidden)
        self.dense2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _nhwc(self.dwconv.dwconv(_nchw(self.dense1(x))))
        return self.dense2(F.gelu(y, approximate="none"))


class SegformerBlock(nn.Module):
    """Pre-norm attention and Mix-FFN, each with a residual."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(dim, eps=1e-6)
        self.attention = EfficientAttention(dim, heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x))
        return x + self.mlp(self.layer_norm_2(x))


class Segformer(nn.Module):
    """(B, H, W, 3) preprocessed -> logits (B, H/4, W/4, num_labels)."""

    def __init__(self, cfg: SegformerConfig = SegformerConfig()):
        super().__init__()
        self.cfg = c = cfg
        enc = nn.Module()
        enc.patch_embeddings = nn.ModuleList()
        enc.block = nn.ModuleList()
        enc.layer_norm = nn.ModuleList()
        c_in = 3
        for i in range(4):
            p, dim = c.patch_sizes[i], c.hidden_sizes[i]
            embed = nn.Module()
            embed.proj = nn.Conv2d(c_in, dim, p, stride=c.strides[i],
                                   padding=p // 2)
            embed.layer_norm = nn.LayerNorm(dim, eps=1e-5)
            enc.patch_embeddings.append(embed)
            enc.block.append(nn.ModuleList(
                SegformerBlock(dim, c.num_heads[i], c.sr_ratios[i],
                               c.mlp_ratio) for _ in range(c.depths[i])))
            enc.layer_norm.append(nn.LayerNorm(dim, eps=1e-6))
            c_in = dim
        self.segformer = nn.Module()
        self.segformer.encoder = enc

        head = nn.Module()
        head.linear_c = nn.ModuleList()
        for dim in c.hidden_sizes:
            mlp = nn.Module()
            mlp.proj = nn.Linear(dim, c.decoder_hidden)
            head.linear_c.append(mlp)
        head.linear_fuse = nn.Conv2d(4 * c.decoder_hidden, c.decoder_hidden,
                                     1, bias=False)
        head.batch_norm = nn.BatchNorm2d(c.decoder_hidden, eps=1e-5)
        head.classifier = nn.Conv2d(c.decoder_hidden, c.num_labels, 1)
        self.decode_head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc, head = self.segformer.encoder, self.decode_head
        feats = []
        for i in range(4):
            embed = enc.patch_embeddings[i]
            x = embed.layer_norm(_nhwc(embed.proj(_nchw(x))))
            for block in enc.block[i]:
                x = block(x)
            x = enc.layer_norm[i](x)
            feats.append(x)
        # all-MLP decode head: each stage to decoder_hidden, upsampled to
        # the first stage's size, concatenated in reversed (HF) order
        target = feats[0].shape[1:3]
        projected = [bilinear_resize(_nchw(mlp.proj(f)), target)
                     for mlp, f in zip(head.linear_c, feats)]
        y = head.linear_fuse(torch.cat(projected[::-1], dim=1))
        y = F.relu(head.batch_norm(y))
        return _nhwc(head.classifier(y))


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> normalized f32 input."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    return (frames.float() / 255.0 - mean) / std


def face_mask_from_logits(logits: torch.Tensor,
                          out_size: tuple[int, int] = (512, 512)
                          ) -> torch.Tensor:
    """logits (B, h, w, num_labels) -> (B, H, W, 1) f32 mask of the swap
    region's classes: bilinear upsample, argmax (ties to the first index,
    as ``jnp.argmax``), class in VALID_CLASSES."""
    up = bilinear_resize(_nchw(logits), out_size)
    labels = up.argmax(dim=1)
    valid = torch.tensor(VALID_CLASSES, device=logits.device)
    return torch.isin(labels, valid).float()[..., None]


class FaceParser:
    """Swap-region masks of face crops: preprocess, Segformer, the mask at
    ``output_size``, SoftErosion (the JAX session's ``parse_masks``).

    Args:
      cfg: the Segformer's configuration (MiT-B1, 19 labels by default).
      state_dict: HF-keyed weights, or None for seeded random weights.
      seed: the random weights' seed.
      output_size: the masks' side (the generator's output, 512).
      device: where it runs; the card unless the caller asks for the CPU
        (raises if no card is there).
    """

    def __init__(self, cfg: SegformerConfig = SegformerConfig(),
                 state_dict: dict | None = None, seed: int = 0,
                 output_size: int = 512,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.output_size = output_size
        model = Segformer(cfg)
        if state_dict is None:
            init_random_(model, seed)  # on the CPU: one seed, one model
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().requires_grad_(False).to(self.device)

    def logits(self, crops) -> torch.Tensor:
        """(B, S, S, 3) uint8 crops (numpy or tensor) -> (B, S/4, S/4,
        num_labels) logits on the device."""
        crops = torch.as_tensor(crops).to(self.device)
        with torch.inference_mode():
            return self.model(preprocess(crops))

    def parse_masks(self, crops) -> torch.Tensor:
        """(B, S, S, 3) uint8 crops -> (B, out, out, 1) feathered swap
        masks in [0, 1] on the device."""
        out = self.output_size
        with torch.inference_mode():
            mask = face_mask_from_logits(self.logits(crops), (out, out))
            soft, _ = soft_erosion(mask, kernel_size=21, threshold=0.9,
                                   iterations=3)
        return soft
