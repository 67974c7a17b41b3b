"""The JAX UniPose's variable tree -> the port's ``UniPose`` state_dict.

The inverse of ``canonswap_tpu/models/xpose/convert.py::convert_unipose``,
which reads the reference checkpoint (xpose.pth's 'model' dict): the port's
keys are that checkpoint's, so :func:`unipose_from_jax` of the JAX tree
gives the state_dict the checkpoint itself would load.  The heads shared
across decoder layers are read under index 0 (``bbox_embed.0``,
``pose_embed.0``, ``pose_hw_embed.0``).
"""

from __future__ import annotations

import torch

from canonswap_torch.models.xpose.unipose import UniPoseConfig
from canonswap_torch.runtime.weights import _Reader


def _mlp(r: _Reader, path: str, key: str, n: int) -> None:
    for i in range(n):
        r.dense(f"{path}/layers_{i}", f"{key}.layers.{i}")


def _mha(r: _Reader, path: str, key: str) -> None:
    r.array(f"{path}/in_proj_weight", f"{key}.in_proj_weight")
    r.array(f"{path}/in_proj_bias", f"{key}.in_proj_bias")
    r.dense(f"{path}/out_proj", f"{key}.out_proj")


def _msda(r: _Reader, path: str, key: str) -> None:
    for name in ("sampling_offsets", "attention_weights", "value_proj",
                 "output_proj"):
        r.dense(f"{path}/{name}", f"{key}.{name}")


def _swin(r: _Reader, cfg: UniPoseConfig) -> None:
    b = "backbone.0"
    r.conv("backbone/patch_embed", f"{b}.patch_embed.proj")
    r.affine("backbone/patch_norm", f"{b}.patch_embed.norm")
    depths = cfg.swin.depths
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, dst = f"backbone/stage{i}_block{j}", f"{b}.layers.{i}.blocks.{j}"
            r.affine(f"{src}/norm1", f"{dst}.norm1")
            r.affine(f"{src}/norm2", f"{dst}.norm2")
            r.array(f"{src}/attn/relative_position_bias_table",
                    f"{dst}.attn.relative_position_bias_table")
            r.dense(f"{src}/attn/qkv", f"{dst}.attn.qkv")
            r.dense(f"{src}/attn/proj", f"{dst}.attn.proj")
            r.dense(f"{src}/fc1", f"{dst}.mlp.fc1")
            r.dense(f"{src}/fc2", f"{dst}.mlp.fc2")
        if i < len(depths) - 1:
            r.affine(f"backbone/merge{i}/norm", f"{b}.layers.{i}.downsample.norm")
            r.dense(f"backbone/merge{i}/reduction",
                    f"{b}.layers.{i}.downsample.reduction")
    for i in cfg.swin.out_indices:
        r.affine(f"backbone/out_norm{i}", f"{b}.norm{i}")


def unipose_from_jax(variables: dict, cfg: UniPoseConfig
                     ) -> dict[str, torch.Tensor]:
    """``variables``: the JAX ``UniPose(cfg)``'s {'params': tree} (numpy or
    jax arrays).  Returns the port's ``UniPose(cfg)`` state_dict."""
    r = _Reader(variables)
    t = "transformer"
    _swin(r, cfg)
    _mlp(r, "projection", "projection", 3)
    _mlp(r, "projection_kpt", "projection_kpt", 3)
    for li in range(4):
        r.conv(f"input_proj_{li}_conv", f"input_proj.{li}.0")
        r.affine(f"input_proj_{li}_gn", f"input_proj.{li}.1")
    r.array("level_embed", f"{t}.level_embed")
    r.dense("enc_output", f"{t}.enc_output")
    r.affine("enc_output_norm", f"{t}.enc_output_norm")
    r.array("tgt_embed", f"{t}.tgt_embed.weight")
    _mlp(r, "enc_out_bbox_embed", f"{t}.enc_out_bbox_embed", 3)
    for i in range(cfg.enc_layers):
        e = f"{t}.encoder.layers.{i}"
        _msda(r, f"enc_{i}/self_attn", f"{e}.self_attn")
        for name in ("norm1", "norm2"):
            r.affine(f"enc_{i}/{name}", f"{e}.{name}")
        for name in ("linear1", "linear2"):
            r.dense(f"enc_{i}/{name}", f"{e}.{name}")
        x = f"{t}.encoder.text_layers.{i}"
        _mha(r, f"text_{i}/self_attn", f"{x}.self_attn")
        for name in ("norm1", "norm2"):
            r.affine(f"text_{i}/{name}", f"{x}.{name}")
        for name in ("linear1", "linear2"):
            r.dense(f"text_{i}/{name}", f"{x}.{name}")
        f = f"{t}.encoder.fusion_layers.{i}"
        for name in ("layer_norm_v", "layer_norm_l"):
            r.affine(f"fusion_{i}/{name}", f"{f}.{name}")
        for name in ("gamma_v", "gamma_l"):
            r.array(f"fusion_{i}/{name}", f"{f}.{name}")
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                     "out_v_proj", "out_l_proj"):
            r.dense(f"fusion_{i}/attn/{name}", f"{f}.attn.{name}")
    for i in range(cfg.dec_layers):
        dk = f"{t}.decoder.layers.{i}"
        _msda(r, f"dec_{i}/cross_attn", f"{dk}.cross_attn")
        _mha(r, f"dec_{i}/ca_text", f"{dk}.ca_text")
        _mha(r, f"dec_{i}/self_attn", f"{dk}.self_attn")
        for name in ("norm1", "catext_norm", "norm2", "norm3"):
            r.affine(f"dec_{i}/{name}", f"{dk}.{name}")
        for name in ("linear1", "linear2"):
            r.dense(f"dec_{i}/{name}", f"{dk}.{name}")
    r.affine("decoder_norm", f"{t}.decoder.norm")
    _mlp(r, "ref_point_head", f"{t}.decoder.ref_point_head", 2)
    r.array("hw", f"{t}.decoder.hw.weight")
    if r.has("hw_append"):
        r.array("hw_append", f"{t}.decoder.hw_append.weight")
    for head in ("bbox_embed", "pose_embed", "pose_hw_embed"):
        _mlp(r, head, f"{head}.0", 3)
    return r.sd
