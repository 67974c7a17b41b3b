"""UniPose (ED-Pose): open-vocabulary keypoint detection, inference path.

Port of ``canonswap_tpu/models/xpose/unipose.py`` (the reference's
src/utils/dependencies/XPose/models/UniPose/unipose.py:26-520, dn off): the
Swin-T backbone and input projections, the text side, the deformable encoder
with vision<->text fusion, the two-stage query selection, the box decoder
layers, the expansion of the top groups into (1 box + K keypoint) queries
and the final heads.  Inputs and outputs are the JAX model's:

  image (B, H, W, 3) normalized; img_mask (B, H, W) bool True = padding;
  ins_text (B, T, 512) CLIP instance embeddings (zero-padded);
  text_token_mask (B, T) True = real token; position_ids (B, T);
  kpt_text (B, K, 512) CLIP keypoint embeddings; kpt_vis (B, K) 1.0 = used.
  -> pred_logits (B, G, T), pred_boxes (B, G, 4) cxcywh,
     pred_keypoints (B, G, 3K) in xy...zz order,
  and the two selections, for checks: query_scores (B, sum HW) and
  query_idx (B, num_queries); group_scores (B, num_queries) and
  group_idx (B, G).

Both selections take the top k of a score in a stable descending sort, so
ties go to the lower index as ``lax.top_k`` sends them; query i pairs
``tgt_embed[i]`` with the i-th selected proposal, so the ORDER matters.

Module names are the reference checkpoint's (``backbone.0``,
``input_proj.{l}.0/.1``, ``transformer.encoder.layers.{i}``,
``transformer.decoder.hw``, ``bbox_embed.0``, ...); the heads shared across
decoder layers (``bbox_embed``, ``pose_embed``, ``pose_hw_embed``) are one
module under index 0.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from canonswap_torch.models.xpose.swin import SwinConfig, SwinTransformer
from canonswap_torch.models.xpose.transformer import (
    MLP, BiAttentionBlock, DecoderLayer, EncoderLayer, TextEncoderLayer,
    contrastive_logits, encoder_reference_points,
    gen_encoder_output_proposals, gen_sineembed_for_position,
    get_sine_pos_embed, inverse_sigmoid,
)


@dataclasses.dataclass(frozen=True)
class UniPoseConfig:
    """The port's copy of the JAX package's ``UniPoseConfig`` (a test holds
    them equal).  The defaults are the reference's UniPose_SwinT.py."""

    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    num_queries: int = 900
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    num_body_points: int = 68
    num_group: int = 50
    num_box_decoder_layers: int = 2
    swin: SwinConfig = SwinConfig()


# A small UniPose for tests and the card-vs-CPU check.  hidden_dim stays 256:
# the text position embedding is 256 wide whatever the width (get_sine_pos_
# embed's num_pos_feats, deformable_transformer.py:643).  3 decoder layers
# so the keypoint stage runs; more than 17 keypoint slots so ``hw_append``
# exists, as the converter of the reference checkpoint reads it.
TINY = UniPoseConfig(
    enc_layers=2, dec_layers=3, dim_feedforward=64, num_queries=48,
    num_body_points=20, num_group=4,
    swin=SwinConfig(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4)))


def nearest_resize_mask(mask: torch.Tensor, size: tuple[int, int]):
    """(B, H, W) bool -> (B, oh, ow) with torch's ``nearest`` integer floor
    mapping src = dst * in // out (the JAX ``nearest_resize``), not a float
    scale that can pick another row."""
    _, h, w = mask.shape
    oh, ow = size
    rows = torch.arange(oh, device=mask.device) * h // oh
    cols = torch.arange(ow, device=mask.device) * w // ow
    return mask[:, rows][:, :, cols]


def pos_embed_sine_hw(mask: torch.Tensor, num_pos_feats: int = 128,
                      temp_h: float = 20, temp_w: float = 20):
    """PositionEmbeddingSineHW (position_encoding.py:66-115), normalize=True.
    mask (B, H, W) True = padding -> (B, H, W, 2 * num_pos_feats)."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(dim=1)
    x_embed = not_mask.cumsum(dim=2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    def emb(e, temp):
        d = torch.arange(num_pos_feats, dtype=torch.float32, device=e.device)
        dim_t = temp ** (2 * torch.div(d, 2, rounding_mode="floor")
                         / num_pos_feats)
        p = e[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).flatten(-2)

    return torch.cat([emb(y_embed, temp_h), emb(x_embed, temp_w)], dim=-1)


def keypoint_group_attn_mask(kpt_vis: torch.Tensor, num_group: int):
    """mask_generate.py:prepare_for_mask at inference: block-diagonal over
    ``num_group`` groups of (1 + K) queries; within a group, query i attends
    j iff kpt_mask_i == kpt_mask_j.  kpt_vis (B, K) -> (B, G*(K+1),
    G*(K+1)), True = masked."""
    b, k = kpt_vis.shape
    kpt_mask = torch.cat([torch.ones_like(kpt_vis[:, :1]), kpt_vis], dim=1)
    equal = kpt_mask[:, :, None] == kpt_mask[:, None, :]  # (B, K+1, K+1)
    n = num_group * (k + 1)
    eye = torch.eye(num_group, dtype=torch.bool, device=kpt_vis.device)
    allowed = eye[None, :, None, :, None] & equal[:, None, :, None, :]
    return ~allowed.reshape(b, n, n)


def top_k_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, largest first,
    ties to the lower index (``lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, k) -> (B, k, C)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class _Encoder(nn.Module):
    def __init__(self, c: UniPoseConfig):
        super().__init__()
        d = c.hidden_dim
        self.layers = nn.ModuleList(
            EncoderLayer(d, c.dim_feedforward, c.num_feature_levels,
                         c.nheads, c.enc_n_points)
            for _ in range(c.enc_layers))
        self.text_layers = nn.ModuleList(
            TextEncoderLayer(d, c.nheads // 2, c.dim_feedforward // 2)
            for _ in range(c.enc_layers))
        self.fusion_layers = nn.ModuleList(
            BiAttentionBlock(d, d, c.dim_feedforward // 2, c.nheads // 2)
            for _ in range(c.enc_layers))


class _Decoder(nn.Module):
    def __init__(self, c: UniPoseConfig):
        super().__init__()
        d = c.hidden_dim
        self.layers = nn.ModuleList(
            DecoderLayer(d, c.dim_feedforward, c.num_feature_levels,
                         c.nheads, c.dec_n_points)
            for _ in range(c.dec_layers))
        self.norm = nn.LayerNorm(d, eps=1e-5)
        # gen_sineembed_for_position gives 128 features per coordinate
        self.ref_point_head = MLP(4 * 128, d, d, 2)
        # the reference splits the per-keypoint wh weights 17 + (K - 17)
        # (decoder init :764-768), as the JAX model does
        self.hw = nn.Embedding(min(17, c.num_body_points), 2)
        if c.num_body_points > 17:
            self.hw_append = nn.Embedding(c.num_body_points - 17, 2)


class _Transformer(nn.Module):
    """The reference's ``transformer`` submodule's parameters; UniPose's
    forward runs them."""

    def __init__(self, c: UniPoseConfig):
        super().__init__()
        d = c.hidden_dim
        self.level_embed = nn.Parameter(torch.zeros(c.num_feature_levels, d))
        self.encoder = _Encoder(c)
        self.decoder = _Decoder(c)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=1e-5)
        self.tgt_embed = nn.Embedding(c.num_queries, d)
        self.enc_out_bbox_embed = MLP(d, d, 4, 3)


class UniPose(nn.Module):
    def __init__(self, cfg: UniPoseConfig = UniPoseConfig()):
        super().__init__()
        c = self.cfg = cfg
        d = c.hidden_dim
        self.backbone = nn.ModuleList([SwinTransformer(c.swin)])
        self.projection = MLP(512, d, d, 3)
        self.projection_kpt = MLP(512, d, d, 3)
        feats = [c.swin.num_features[i] for i in c.swin.out_indices]
        # one projection per backbone level, and one stride-2 conv on the
        # last backbone feature for the extra level
        self.input_proj = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(f, d, 1), nn.GroupNorm(32, d, eps=1e-5))
             for f in feats]
            + [nn.Sequential(nn.Conv2d(feats[-1], d, 3, stride=2, padding=1),
                             nn.GroupNorm(32, d, eps=1e-5))])
        self.transformer = _Transformer(c)
        self.bbox_embed = nn.ModuleList([MLP(d, d, 4, 3)])
        self.pose_embed = nn.ModuleList([MLP(d, d, 2, 3)])
        self.pose_hw_embed = nn.ModuleList([MLP(d, d, 2, 3)])

    def _levels(self, image, img_mask):
        """The four feature levels, flattened: (src, mask, pos) each
        (B, sum HW, .), the spatial shapes and the valid ratios (B, L, 2)."""
        d = self.cfg.hidden_dim
        feats = self.backbone[0](image)
        maps = [feats[s].permute(0, 3, 1, 2)
                for s in self.cfg.swin.out_indices]
        maps.append(maps[-1])  # the extra level's conv reads the last one
        srcs, masks, poss = [], [], []
        for proj, f in zip(self.input_proj, maps):
            src = proj(f).permute(0, 2, 3, 1)  # (B, h, w, d)
            m = nearest_resize_mask(img_mask, tuple(src.shape[1:3]))
            srcs.append(src)
            masks.append(m)
            poss.append(pos_embed_sine_hw(m, d // 2))
        b = image.shape[0]
        level_embed = self.transformer.level_embed
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat = torch.cat([s.reshape(b, -1, d) for s in srcs], dim=1)
        mask_flat = torch.cat([m.reshape(b, -1) for m in masks], dim=1)
        pos_flat = torch.cat([p.reshape(b, -1, d) + level_embed[i][None, None]
                              for i, p in enumerate(poss)], dim=1)
        # valid ratios (deformable_transformer.py:293-300)
        valid_ratios = torch.stack([torch.stack(
            [(~m[:, 0, :]).float().sum(dim=1) / m.shape[2],
             (~m[:, :, 0]).float().sum(dim=1) / m.shape[1]], dim=-1)
            for m in masks], dim=1)
        return src_flat, mask_flat, pos_flat, spatial_shapes, valid_ratios

    def forward(self, image, img_mask, ins_text, text_token_mask,
                position_ids, kpt_text, kpt_vis) -> dict:
        c = self.cfg
        tr = self.transformer
        b, d, k, g = image.shape[0], c.hidden_dim, c.num_body_points, c.num_group

        # ---- text side ------------------------------------------------
        encoded_text = self.projection(ins_text)         # (B, T, d)
        kpt_embed = self.projection_kpt(kpt_text)        # (B, K, d)
        t_len = encoded_text.shape[1]
        # each text token attends to itself only
        text_self_mask = ~torch.eye(t_len, dtype=torch.bool,
                                    device=image.device)
        pos_text = get_sine_pos_embed(position_ids[..., None].float(),
                                      num_pos_feats=256, exchange_xy=False)
        text_pad = ~text_token_mask

        # ---- backbone, projections, encoder --------------------------
        src_flat, mask_flat, pos_flat, spatial_shapes, valid_ratios = \
            self._levels(image, img_mask)
        refs_enc = encoder_reference_points(spatial_shapes, valid_ratios)
        out, mem_text = src_flat, encoded_text
        enc = tr.encoder
        for fusion, text, layer in zip(enc.fusion_layers, enc.text_layers,
                                       enc.layers):
            out, mem_text = fusion(out, mem_text, attention_mask_v=mask_flat,
                                   attention_mask_l=text_pad)
            mem_text = text(mem_text, src_mask=text_self_mask, pos=pos_text)
            out = layer(out, pos_flat, refs_enc, spatial_shapes, mask_flat)
        memory = out

        # ---- two-stage query selection ------------------------------
        out_mem, out_props = gen_encoder_output_proposals(
            memory, mask_flat, spatial_shapes)
        out_mem = tr.enc_output_norm(tr.enc_output(out_mem))
        query_scores = contrastive_logits(out_mem, mem_text,
                                          text_token_mask).max(dim=-1).values
        query_idx = top_k_stable(query_scores, c.num_queries)
        ref_unsig = tr.enc_out_bbox_embed(out_mem) + out_props
        reference_points = _gather_rows(ref_unsig, query_idx).sigmoid()
        output = tr.tgt_embed.weight[None].expand(b, -1, -1)

        # ---- decoder ----------------------------------------------------
        dec = tr.decoder
        bbox_embed = self.bbox_embed[0]
        pose_embed, pose_hw_embed = self.pose_embed[0], self.pose_hw_embed[0]
        kpt_group_mask = keypoint_group_attn_mask(kpt_vis, g)
        ratios4 = torch.cat([valid_ratios, valid_ratios], dim=-1)[:, None]
        n2 = g * (k + 1)
        slot = torch.arange(n2, device=image.device)
        idx_box, kpt_index = slot[slot % (k + 1) == 0], slot[slot % (k + 1) != 0]
        self_mask = group_scores = group_idx = hs_last = ref_last = None
        for layer_id, layer in enumerate(dec.layers):
            ref_in = reference_points[:, :, None] * ratios4  # (B, nq, L, 4)
            query_pos = dec.ref_point_head(
                gen_sineembed_for_position(ref_in[:, :, 0, :]))
            output = layer(output, query_pos, ref_in, memory, spatial_shapes,
                           mask_flat, mem_text, text_pad,
                           self_attn_mask=self_mask)

            if layer_id < c.num_box_decoder_layers:
                # the iteration heads run on the RAW layer output
                new_refs = (bbox_embed(output)
                            + inverse_sigmoid(reference_points)).sigmoid()

            if layer_id == c.num_box_decoder_layers - 1:
                # expand the top groups to (1 box + K keypoint) queries
                # (deformable_transformer.py:869-894)
                group_scores = contrastive_logits(
                    output, mem_text, text_token_mask).max(dim=-1).values
                group_idx = top_k_stable(group_scores, g)
                ref_box = _gather_rows(new_refs, group_idx)    # (B, G, 4)
                out_box = _gather_rows(output, group_idx)      # (B, G, d)
                kpt_q = kpt_embed[:, None].expand(b, g, k, d)
                kpt_xy = (inverse_sigmoid(ref_box[..., None, :2])
                          + pose_embed(kpt_q)[..., :2]).sigmoid()
                hw_all = dec.hw.weight if k <= 17 else torch.cat(
                    [dec.hw.weight, dec.hw_append.weight], dim=0)
                kpt_wh = hw_all.sigmoid()[None, None] * ref_box[..., None, 2:]
                ref_kpt = torch.cat([kpt_xy, kpt_wh], dim=-1)
                reference_points = torch.cat(
                    [ref_box[:, :, None], ref_kpt], dim=2).reshape(b, n2, 4)
                output = torch.cat([out_box[:, :, None], kpt_q],
                                   dim=2).reshape(b, n2, d)
                self_mask = kpt_group_mask.repeat_interleave(c.nheads, dim=0)
            elif layer_id >= c.num_box_decoder_layers:
                # refine box and keypoints of the grouped queries (raw
                # output; decoder forward :896-934)
                ref_sig = inverse_sigmoid(reference_points)
                new_box = (bbox_embed(output[:, idx_box])
                           + ref_sig[:, idx_box]).sigmoid()
                hs_kpt = output[:, kpt_index]
                delta = torch.cat([pose_embed(hs_kpt)[..., :2],
                                   pose_hw_embed(hs_kpt)], dim=-1)
                new_kpt = (ref_sig[:, kpt_index] + delta).sigmoid()
                reference_points = torch.cat(
                    [new_box[:, :, None], new_kpt.reshape(b, g, k, 4)],
                    dim=2).reshape(b, n2, 4)
                # the final heads read this layer's NORMED hs with its input
                # refs (unipose.py:420-485 zips hs with reference[:-1])
                hs_last, ref_last = dec.norm(output), ref_sig
            if layer_id < c.num_box_decoder_layers - 1:
                reference_points = new_refs

        # ---- final heads (unipose.py:420-485, last layer only) ----------
        hs_box = hs_last[:, idx_box]
        pred_logits = contrastive_logits(hs_box, mem_text, text_token_mask)
        pred_boxes = (bbox_embed(hs_box) + ref_last[:, idx_box]).sigmoid()
        kpt_xy = (pose_embed(hs_last[:, kpt_index])
                  + ref_last[:, kpt_index][..., :2]).sigmoid()
        vis = torch.ones_like(kpt_xy[..., :1]).sigmoid()
        xyz = torch.cat([kpt_xy, vis], dim=-1).reshape(b, g, k, 3)
        # keypoint_xyzxyz_to_xyxyzz (util/keypoint_ops.py:18-28)
        pred_kpts = torch.cat([xyz[..., :2].reshape(b, g, 2 * k),
                               xyz[..., 2]], dim=-1)
        return {
            "pred_logits": pred_logits,
            "pred_boxes": pred_boxes,
            "pred_keypoints": pred_kpts,
            "query_scores": query_scores,
            "query_idx": query_idx,
            "group_scores": group_scores,
            "group_idx": group_idx,
        }
