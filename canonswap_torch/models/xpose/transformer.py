"""Deformable transformer with vision<->text fusion for UniPose.

Port of ``canonswap_tpu/models/xpose/transformer.py`` (the reference's
ED-Pose deformable_transformer.py, fuse_modules.py, transformer_vanilla.py
and ops/modules/ms_deform_attn.py): the encoder layer (BiAttention, text
self-attention, deformable self-attention, FFN), the decoder layer (masked
self-attention, text cross-attention, deformable cross-attention, FFN) and
the helpers of the two-stage query selection.  Inputs are (B, L, C) as in
the JAX package; module names are the reference checkpoint's.

The deformable attention calls ``ops/cuda/ms_deform_attn.py``: the CUDA
kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from canonswap_torch.ops.cuda.ms_deform_attn import ms_deform_attn

_NEG = torch.finfo(torch.float32).min


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """util/misc.py:689-693 semantics (independent clamps)."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


class MLP(nn.Module):
    """utils.py:162-174: n-layer perceptron, relu between layers."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention's parameters (packed in-proj, out-proj)
    with the JAX package's masking: masked logits take the float's min, not
    -inf, so a fully masked row is uniform instead of NaN.

    Inputs (B, L, E); ``attn_mask`` True = masked, (Lq, Lk) or
    (B*H, Lq, Lk); ``key_padding_mask`` True = masked, (B, Lk)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, attn_mask=None, key_padding_mask=None):
        e = q.shape[-1]
        h = self.num_heads
        hd = e // h
        w, bias = self.in_proj_weight, self.in_proj_bias
        b, lq, _ = q.shape
        lk = k.shape[1]
        qp = F.linear(q, w[:e], bias[:e]).reshape(b, lq, h, hd)
        kp = F.linear(k, w[e:2 * e], bias[e:2 * e]).reshape(b, lk, h, hd)
        vp = F.linear(v, w[2 * e:], bias[2 * e:]).reshape(b, lk, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qp * (hd**-0.5), kp)
        if attn_mask is not None:
            m = (attn_mask[None, None] if attn_mask.dim() == 2
                 else attn_mask.reshape(b, h, lq, lk))
            logits = logits.masked_fill(m, _NEG)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        _NEG)
        attn = logits.softmax(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vp).reshape(b, lq, e)
        return self.out_proj(out)


class MSDeformAttn(nn.Module):
    """ops/modules/ms_deform_attn.py:40-140, channels-last."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model,
                                           n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, input_flatten,
                spatial_shapes: tuple[tuple[int, int], ...],
                input_padding_mask=None):
        """query (B, Lq, C); reference_points (B, Lq, L, 2|4) in [0, 1];
        input_flatten (B, sum(HW), C); padding mask (B, sum(HW)) True =
        padding, whose value rows are zeroed."""
        n, lq, c = query.shape
        m, lvls, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        value = value.reshape(n, -1, m, c // m)
        off = self.sampling_offsets(query).reshape(n, lq, m, lvls, p, 2)
        w = self.attention_weights(query).reshape(n, lq, m, lvls * p)
        w = w.softmax(dim=-1).reshape(n, lq, m, lvls, p)
        ref = reference_points[:, :, None, :, None, :]
        if reference_points.shape[-1] == 2:
            shapes_wh = torch.tensor([(ww, hh) for hh, ww in spatial_shapes],
                                     dtype=off.dtype, device=off.device)
            loc = ref + off / shapes_wh[None, None, None, :, None, :]
        else:
            loc = ref[..., :2] + off / p * ref[..., 2:] * 0.5
        out = ms_deform_attn(value.contiguous(), spatial_shapes,
                             loc.contiguous(), w.contiguous())
        return self.output_proj(out)


class BiMultiHeadAttention(nn.Module):
    """fuse_modules.py:98-240: bidirectional vision<->language attention.
    Logits are shifted by their max over the WHOLE tensor (batch and heads)
    and clipped at +-50000, as stable_softmax_2d does."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int,
                 num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.v_proj = nn.Linear(v_dim, embed_dim)
        self.l_proj = nn.Linear(l_dim, embed_dim)
        self.values_v_proj = nn.Linear(v_dim, embed_dim)
        self.values_l_proj = nn.Linear(l_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, v_dim)
        self.out_l_proj = nn.Linear(embed_dim, l_dim)

    def forward(self, v, lang, attention_mask_v=None, attention_mask_l=None):
        b, nv, _ = v.shape
        nl = lang.shape[1]
        h = self.num_heads
        e = self.v_proj.out_features
        hd = e // h
        q = (self.v_proj(v) * hd**-0.5).reshape(b, nv, h, hd)
        k = self.l_proj(lang).reshape(b, nl, h, hd)
        vv = self.values_v_proj(v).reshape(b, nv, h, hd)
        vl = self.values_l_proj(lang).reshape(b, nl, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)  # (B, H, Nv, Nl)
        logits = (logits - logits.max()).clamp(-50000, 50000)
        lt = logits.transpose(2, 3)  # (B, H, Nl, Nv)
        lt = (lt - lt.max(dim=-1, keepdim=True).values).clamp(-50000, 50000)
        if attention_mask_v is not None:
            lt = lt.masked_fill(attention_mask_v[:, None, None, :], _NEG)
        attn_l = lt.softmax(dim=-1)
        if attention_mask_l is not None:
            logits = logits.masked_fill(attention_mask_l[:, None, None, :],
                                        _NEG)
        attn_v = logits.softmax(dim=-1)
        out_v = torch.einsum("bhqk,bkhd->bqhd", attn_v, vl).reshape(b, nv, e)
        out_l = torch.einsum("bhqk,bkhd->bqhd", attn_l, vv).reshape(b, nl, e)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """fuse_modules.py:244-274: pre-LN, layer-scale gammas (1e-4 at init).
    Returns the NORMED inputs plus the scaled updates, as the JAX model."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int,
                 num_heads: int, init_values: float = 1e-4):
        super().__init__()
        self.layer_norm_v = nn.LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = nn.LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_values))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_values))

    def forward(self, v, lang, attention_mask_v=None, attention_mask_l=None):
        vn, ln = self.layer_norm_v(v), self.layer_norm_l(lang)
        dv, dl = self.attn(vn, ln, attention_mask_v, attention_mask_l)
        return vn + self.gamma_v * dv, ln + self.gamma_l * dl


class _FFN(nn.Module):
    """linear1 -> relu -> linear2, the FFN of every layer below."""

    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)

    def ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class TextEncoderLayer(_FFN):
    """transformer_vanilla.py TransformerEncoderLayer (post-norm)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__(d_model, dim_feedforward)
        self.nhead = nhead
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, src_mask=None, pos=None):
        """src (B, L, C); src_mask True = masked, (B, L, L) or (L, L)."""
        q = src if pos is None else src + pos
        if src_mask is not None and src_mask.dim() == 3:
            src_mask = src_mask.repeat_interleave(self.nhead, dim=0)
        src = self.norm1(src + self.self_attn(q, q, src, attn_mask=src_mask))
        return self.norm2(src + self.ffn(src))


class EncoderLayer(_FFN):
    """DeformableTransformerEncoderLayer (deformable_transformer.py:938-993)."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int):
        super().__init__(d_model, d_ffn)
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes,
                key_padding_mask=None):
        src2 = self.self_attn(src + pos, reference_points, src,
                              spatial_shapes, key_padding_mask)
        src = self.norm1(src + src2)
        return self.norm2(src + self.ffn(src))


class DecoderLayer(_FFN):
    """DeformableTransformerDecoderLayer (deformable_transformer.py:
    996-1133): masked self-attn -> text cross-attn -> deformable cross-attn
    -> FFN."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int):
        super().__init__(d_model, d_ffn)
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.ca_text = MultiheadAttention(d_model, n_heads)
        self.catext_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, memory,
                spatial_shapes, memory_key_padding_mask, memory_text,
                text_attention_mask, self_attn_mask=None):
        """All (B, L, C); reference_points (B, Lq, n_levels, 4)."""
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt,
                                              attn_mask=self_attn_mask))
        tgt2 = self.ca_text(tgt + query_pos, memory_text, memory_text,
                            key_padding_mask=text_attention_mask)
        tgt = self.catext_norm(tgt + tgt2)
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, memory,
                               spatial_shapes, memory_key_padding_mask)
        tgt = self.norm1(tgt + tgt2)
        return self.norm3(tgt + self.ffn(tgt))


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """(..., F) -> (..., F): sin of the even features and cos of the odd
    ones, interleaved (stack(..., -1).flatten)."""
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def _dim_t(n: int, temperature: float, device) -> torch.Tensor:
    d = torch.arange(n, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(d, 2, rounding_mode="floor") / n)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int = 256,
                       temperature: float = 10000,
                       exchange_xy: bool = True) -> torch.Tensor:
    """utils.py:26-55; pos (..., n) -> (..., n * num_pos_feats)."""
    dim_t = _dim_t(num_pos_feats, temperature, pos.device)
    parts = [_interleave_sin_cos(pos[..., i:i + 1] * (2 * math.pi) / dim_t)
             for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def gen_sineembed_for_position(pos: torch.Tensor) -> torch.Tensor:
    """utils.py:193-219; pos (..., 2|4) -> (..., 256|512), in the order
    y, x, w, h."""
    dim_t = _dim_t(128, 10000, pos.device)

    def emb(x):
        return _interleave_sin_cos(x[..., None] * (2 * math.pi) / dim_t)

    parts = [emb(pos[..., 1]), emb(pos[..., 0])]
    if pos.shape[-1] == 4:
        parts += [emb(pos[..., 2]), emb(pos[..., 3])]
    return torch.cat(parts, dim=-1)


def gen_encoder_output_proposals(memory, memory_padding_mask, spatial_shapes):
    """utils.py:58-114 (two-stage proposal grid).  Proposals are +inf at
    padding and where a coordinate leaves (0.01, 0.99), as in the JAX model
    (sigmoid(inf) = 1 downstream); memory is zeroed there."""
    n = memory.shape[0]
    dev = memory.device
    proposals = []
    cur = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        mask = memory_padding_mask[:, cur:cur + h * w].reshape(n, h, w)
        valid_h = (~mask[:, :, 0]).sum(dim=1).float()
        valid_w = (~mask[:, 0, :]).sum(dim=1).float()
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2)
        scale = torch.stack([valid_w, valid_h], dim=-1).reshape(n, 1, 1, 2)
        grid = (grid[None] + 0.5) / scale
        wh = torch.ones_like(grid) * 0.05 * (2.0**lvl)
        proposals.append(torch.cat([grid, wh], dim=-1).reshape(n, -1, 4))
        cur += h * w
    props = torch.cat(proposals, dim=1)
    valid = ((props > 0.01) & (props < 0.99)).all(dim=-1, keepdim=True)
    props = torch.log(props / (1 - props))
    invalid = memory_padding_mask[..., None] | ~valid
    props = props.masked_fill(invalid, math.inf)
    return memory.masked_fill(invalid, 0.0), props


def contrastive_logits(x, text, text_token_mask):
    """ContrastiveAssign (unipose.py:573-621): x @ text^T, -inf at padding."""
    res = torch.einsum("bqc,btc->bqt", x, text)
    return res.masked_fill(~text_token_mask[:, None, :], -math.inf)


def encoder_reference_points(spatial_shapes, valid_ratios):
    """TransformerEncoder.get_reference_points (deformable_transformer.py:
    579-590).  valid_ratios (B, L, 2) -> (B, sum(HW), L, 2).  The cell
    centres 0.5, 1.5, ... are exact, as the JAX linspace's are."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry, rx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], dim=-1))  # (B, HW, 2)
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None] * valid_ratios[:, None]
