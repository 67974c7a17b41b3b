"""Weights for the port: a reference checkpoint, or JAX variable trees, ->
the port's ``state_dict``.

:func:`load_reference_checkpoint` reads the reference's
``combined_weights.pth`` (or the dict it holds) in torch alone.

:func:`from_jax` is the inverse of the JAX package's converters
(``canonswap_tpu/runtime/weights.py::convert_*``): its per-network trees
``{"params", "batch_stats"}`` (numpy or jax arrays) become the torch keys of
the reference checkpoint, which are the port's own.  Conventions undone here:

- conv kernels (*k, I, O) -> (O, I, *k); depthwise (kh, kw, 1, C) ->
  (C, 1, kh, kw);
- Dense kernels (I, O) -> Linear weights (O, I);
- BatchNorm scale/bias and batch_stats mean/var -> weight/bias and
  running_mean/running_var (num_batches_tracked 0); LayerNorm and GroupNorm
  scale/bias -> weight/bias;
- GRN gamma/beta (C,) -> (1, 1, 1, C);
- adaptive conv weight/bias -> weight/bias_param;
- single-slope PReLU alphas (ArcFace) () -> (1,) weights.

Besides the core's six networks: the sidecars' and the face stack's nets
(``landmark_from_jax``, ``landmark_net_from_jax``, ``segformer_from_jax``,
``scrfd_from_jax``, ``arcface_from_jax``), and a whole JAX session's
(:func:`session_from_jax`).

Spectral norm stays baked into the SPADE convs' ``weight``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def strip_prefixes(sd: dict) -> dict:
    """Drop the ``module.`` (DistributedDataParallel) and ``_orig_mod.``
    (``torch.compile``) prefixes, as the reference's
    ``remove_ddp_dumplicate_key`` does."""
    out = {}
    for k, v in sd.items():
        for pre in ("module.", "_orig_mod."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def bake_spectral_norm(sd: dict) -> dict:
    """Replace each spectral-normalized ``X.weight_orig`` / ``X.weight_u`` /
    ``X.weight_v`` by ``X.weight = weight_orig / sigma``, with
    ``sigma = u . (W_mat v)`` and ``W_mat = weight_orig.reshape(out, -1)``:
    what ``torch.nn.utils.spectral_norm`` computes in eval mode from the
    stored vectors."""
    out = dict(sd)
    for key in [k for k in sd if k.endswith(".weight_orig")]:
        base = key[: -len("_orig")]
        w = out.pop(key)
        u, v = out.pop(f"{base}_u"), out.pop(f"{base}_v")
        sigma = torch.dot(u, torch.mv(w.reshape(w.shape[0], -1), v))
        out[base] = w / sigma
    return out


def load_reference_checkpoint(checkpoint: str | os.PathLike | dict
                              ) -> dict[str, torch.Tensor]:
    """The reference's ``combined_weights.pth`` (a path, or the dict of six
    torch state_dicts it holds) -> the port's ``CanonSwapCore`` state_dict,
    keys ``{net}.{key}``, for ``load_state_dict(strict=True)``.

    Per network: the ``module.``/``_orig_mod.`` prefixes are stripped,
    spectral norm is baked (:func:`bake_spectral_norm`), and the SPADE
    decoder's bare ``conv_img`` takes the port's ``conv_img.0`` (the conv
    before the pixel shuffle).  Torch alone: the file is read on the CPU,
    with ``weights_only`` (tensors and containers, no code)."""
    if not isinstance(checkpoint, dict):
        checkpoint = torch.load(checkpoint, map_location="cpu",
                                weights_only=True)
    missing = [net for net in FROM_JAX if net not in checkpoint]
    if missing:
        raise KeyError(f"checkpoint lacks the networks {missing}; it has "
                       f"{sorted(checkpoint)}")
    out = {}
    for net in FROM_JAX:  # the six networks, CanonSwapCore's submodules
        sd = bake_spectral_norm(strip_prefixes(checkpoint[net]))
        if net == "spade_generator":
            sd = {("conv_img.0" + k[len("conv_img"):]
                   if k.startswith("conv_img.") and not
                   k.startswith("conv_img.0.") else k): v
                  for k, v in sd.items()}
        for key, value in sd.items():
            out[f"{net}.{key}"] = value
    return out


class _Reader:
    """Reads leaves of one network's JAX tree into a torch state_dict."""

    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(root, path: str):
        for part in path.split("/"):
            root = root[part]
        return root

    def has(self, path: str) -> bool:
        try:
            self._node(self.params, path)
        except KeyError:
            return False
        return True

    def count(self, fmt: str) -> int:
        i = 0
        while self.has(fmt.format(i)):
            i += 1
        return i

    def _put(self, key: str, value) -> None:
        self.sd[key] = torch.from_numpy(np.array(value))  # a C-order copy

    def conv(self, path: str, key: str) -> None:
        leaf = self._node(self.params, path)
        k = np.asarray(leaf["kernel"])
        n = k.ndim
        self._put(f"{key}.weight", k.transpose(n - 1, n - 2, *range(n - 2)))
        if "bias" in leaf:
            self._put(f"{key}.bias", leaf["bias"])

    def conv_dw(self, path: str, key: str) -> None:
        leaf = self._node(self.params, path)
        self._put(f"{key}.weight", np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in leaf:
            self._put(f"{key}.bias", leaf["bias"])

    def dense(self, path: str, key: str) -> None:
        leaf = self._node(self.params, path)
        self._put(f"{key}.weight", np.asarray(leaf["kernel"]).T)
        if "bias" in leaf:
            self._put(f"{key}.bias", leaf["bias"])

    def array(self, path: str, key: str) -> None:
        """A parameter stored as it is (embeddings, tables, gammas)."""
        self._put(key, self._node(self.params, path))

    def affine(self, path: str, key: str) -> None:
        """LayerNorm / GroupNorm scale, bias."""
        leaf = self._node(self.params, path)
        self._put(f"{key}.weight", leaf["scale"])
        self._put(f"{key}.bias", leaf["bias"])

    def bn(self, path: str, key: str) -> None:
        self.affine(path, key)
        stats = self._node(self.stats, path)
        self._put(f"{key}.running_mean", stats["mean"])
        self._put(f"{key}.running_var", stats["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    # blocks ---------------------------------------------------------------

    def same_block(self, path: str, key: str) -> None:
        self.conv(f"{path}/Conv_0", f"{key}.conv")
        self.bn(f"{path}/BatchNorm_0", f"{key}.norm")

    def res_block(self, path: str, key: str) -> None:
        self.bn(f"{path}/BatchNorm_0", f"{key}.norm1")
        self.conv(f"{path}/Conv_0", f"{key}.conv1")
        self.bn(f"{path}/BatchNorm_1", f"{key}.norm2")
        self.conv(f"{path}/Conv_1", f"{key}.conv2")

    def res_block_leak_gn(self, path: str, key: str) -> None:
        self.conv(f"{path}/conv1", f"{key}.conv1")
        self.affine(f"{path}/gn1", f"{key}.gn1")
        self.conv(f"{path}/conv2", f"{key}.conv2")
        self.affine(f"{path}/gn2", f"{key}.gn2")
        if self.has(f"{path}/shortcut"):
            self.conv(f"{path}/shortcut", f"{key}.shortcut")

    def spade(self, path: str, key: str) -> None:
        self.conv(f"{path}/mlp_shared", f"{key}.mlp_shared.0")
        self.conv(f"{path}/mlp_gamma", f"{key}.mlp_gamma")
        self.conv(f"{path}/mlp_beta", f"{key}.mlp_beta")

    def spade_resblock(self, path: str, key: str) -> None:
        for i in (0, 1):
            self.spade(f"{path}/norm_{i}", f"{key}.norm_{i}")
            self.conv(f"{path}/conv_{i}", f"{key}.conv_{i}")
        if self.has(f"{path}/conv_s"):
            self.spade(f"{path}/norm_s", f"{key}.norm_s")
            self.conv(f"{path}/conv_s", f"{key}.conv_s")

    def adaptive_conv(self, path: str, key: str) -> None:
        leaf = self._node(self.params, path)
        self._put(f"{key}.weight", np.asarray(leaf["weight"]).transpose(3, 2, 0, 1))
        self._put(f"{key}.bias_param", leaf["bias"])
        self.dense(f"{path}/style_fc0", f"{key}.style_fc.0")
        self.dense(f"{path}/style_fc1", f"{key}.style_fc.2")
        self.conv(f"{path}/mask_conv", f"{key}.mask_conv.0")


def appearance_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    r.same_block("first", "first")
    for i in range(r.count("down{}")):
        r.same_block(f"down{i}", f"down_blocks.{i}")
    r.conv("second", "second")
    for i in range(r.count("res3d_{}")):
        r.res_block(f"res3d_{i}", f"resblocks_3d.3dr{i}")
    return r.sd


def motion_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    d, t = "detector/", "detector."
    r.conv(d + "stem_conv", t + "downsample_layers.0.0")
    r.affine(d + "stem_norm", t + "downsample_layers.0.1")
    for i in range(1, 4):
        r.affine(d + f"down{i}_norm", t + f"downsample_layers.{i}.0")
        r.conv(d + f"down{i}_conv", t + f"downsample_layers.{i}.1")
    for i in range(4):
        for j in range(r.count(d + f"stage{i}_block{{}}")):
            b, k = d + f"stage{i}_block{j}", t + f"stages.{i}.{j}"
            r.conv_dw(f"{b}/dwconv", f"{k}.dwconv")
            r.affine(f"{b}/norm", f"{k}.norm")
            r.dense(f"{b}/pwconv1", f"{k}.pwconv1")
            grn = r._node(r.params, f"{b}/grn")
            for name in ("gamma", "beta"):
                r._put(f"{k}.grn.{name}",
                       np.asarray(grn[name]).reshape(1, 1, 1, -1))
            r.dense(f"{b}/pwconv2", f"{k}.pwconv2")
    r.affine(d + "head_norm", t + "norm")
    for head in ("fc_kp", "fc_pitch", "fc_yaw", "fc_roll", "fc_t", "fc_exp",
                 "fc_scale"):
        r.dense(d + head, t + head)
    return r.sd


def warping_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    dm = "dense_motion_network"
    hg = f"{dm}/hourglass"
    r.conv(f"{dm}/compress", f"{dm}.compress")
    r.bn(f"{dm}/norm", f"{dm}.norm")
    for i in range(r.count(hg + "/encoder/down{}")):
        r.same_block(f"{hg}/encoder/down{i}",
                     f"{dm}.hourglass.encoder.down_blocks.{i}")
    for j in range(r.count(hg + "/decoder/up{}")):
        r.same_block(f"{hg}/decoder/up{j}",
                     f"{dm}.hourglass.decoder.up_blocks.{j}")
    r.conv(f"{hg}/decoder/Conv_0", f"{dm}.hourglass.decoder.conv")
    r.bn(f"{hg}/decoder/BatchNorm_0", f"{dm}.hourglass.decoder.norm")
    r.conv(f"{dm}/mask", f"{dm}.mask")
    r.conv(f"{dm}/occlusion", f"{dm}.occlusion")
    r.same_block("third", "third")
    r.conv("fourth", "fourth")
    return r.sd


def spade_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    r.conv("fc", "fc")
    for name in [f"G_middle_{i}" for i in range(6)] + ["up_0", "up_1"]:
        r.spade_resblock(name, name)
    # the pixel-shuffle head is nn.Sequential(conv, PixelShuffle)
    r.conv("conv_img", "conv_img.0")
    return r.sd


def transfer_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    for i in range(r.count("bottleneck2d_{}")):
        for conv in ("conv1", "conv2"):
            r.adaptive_conv(f"bottleneck2d_{i}/{conv}",
                            f"BottleNeck_2d.{i}.{conv}")
    for i in range(r.count("res3d_{}")):
        r.res_block(f"res3d_{i}", f"resblocks_3d.3dr{i}")
    return r.sd


def refine_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    for i in range(3):
        r.res_block_leak_gn(f"res3d_in_{i}", f"resblocks1.{i}")
        r.res_block(f"res2d_{i}", f"resblocks2.{i}")
        r.res_block_leak_gn(f"res3d_out_{i}", f"resblocks3.{i}")
    return r.sd


def landmark_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """``MobileLandmarkNet``'s JAX variables -> the port's
    ``models/landmark.py::MobileLandmarkNet`` state_dict (the names are the
    JAX tree's)."""
    r = _Reader(variables)
    r.conv("stem", "stem")
    r.array("stem_act/alpha", "stem_act.alpha")
    for i in range(r.count("dw{}")):
        r.conv_dw(f"dw{i}/dw", f"dw{i}.dw")
        r.array(f"dw{i}/dw_act/alpha", f"dw{i}.dw_act.alpha")
        r.conv(f"dw{i}/pw", f"dw{i}.pw")
        r.array(f"dw{i}/pw_act/alpha", f"dw{i}.pw_act.alpha")
    r.conv_dw("gdc", "gdc")
    r.dense("fc0", "fc0")
    r.array("fc0_act/alpha", "fc0_act.alpha")
    r.dense("head", "head")
    return r.sd


def landmark_net_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The residual ``LandmarkNet``'s JAX variables (flax's automatic names
    inside a block: Conv_0, GroupNorm_0, Conv_1, GroupNorm_1) -> the port's
    ``models/landmark.py::LandmarkNet`` state_dict."""
    r = _Reader(variables)
    r.conv("Conv_0", "stem")
    for i in range(r.count("block{}")):
        for name in (f"block{i}", f"block{i}b"):
            for j in (0, 1):
                r.conv(f"{name}/Conv_{j}", f"{name}.conv{j}")
                r.affine(f"{name}/GroupNorm_{j}", f"{name}.norm{j}")
            if r.has(f"{name}/short"):
                r.conv(f"{name}/short", f"{name}.short")
    r.dense("fc0", "fc0")
    r.dense("head", "head")
    return r.sd


def scrfd_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """SCRFD's JAX variables (params and batch_stats) -> the port's
    ``models/scrfd.py::SCRFD`` state_dict (the names are the JAX tree's)."""
    r = _Reader(variables)

    def conv_bn(path, key):
        r.conv(f"{path}/conv", f"{key}.conv")
        r.bn(f"{path}/bn", f"{key}.bn")

    for i in range(3):
        conv_bn(f"backbone/stem{i}", f"backbone.stem{i}")
    for i in range(r.count("backbone/layer{}_0")):
        for j in range(r.count(f"backbone/layer{i}_{{}}")):
            p, k = f"backbone/layer{i}_{j}", f"backbone.layer{i}_{j}"
            conv_bn(f"{p}/conv1", f"{k}.conv1")
            r.conv(f"{p}/conv2", f"{k}.conv2")
            r.bn(f"{p}/bn2", f"{k}.bn2")
            if r.has(f"{p}/downsample"):
                r.conv(f"{p}/downsample", f"{k}.downsample")
                r.bn(f"{p}/downsample_bn", f"{k}.downsample_bn")
    levels = r.count("neck/lateral{}")
    for i in range(levels):
        r.conv(f"neck/lateral{i}", f"neck.lateral{i}")
        r.conv(f"neck/fpn_conv{i}", f"neck.fpn_conv{i}")
    for i in range(1, levels):
        r.conv(f"neck/down_conv{i}", f"neck.down_conv{i}")
        r.conv(f"neck/pafpn_conv{i}", f"neck.pafpn_conv{i}")
    for i in range(r.count("head/conv{}")):
        r.conv(f"head/conv{i}", f"head.conv{i}")
        r.bn(f"head/bn{i}", f"head.bn{i}")
    for name in ("cls", "reg", "kps"):
        r.conv(f"head/{name}", f"head.{name}")
    return r.sd


def arcface_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """ArcFace's JAX variables -> the reference's ArcFace state_dict keys,
    the port's ``models/arcface.py::ArcFaceResNet`` (the inverse of
    ``canonswap_tpu/runtime/weights.py::convert_arcface``)."""
    r = _Reader(variables)

    def prelu(path, key):
        r._put(f"{key}.weight",
               np.asarray(r._node(r.params, path)["alpha"]).reshape(1))

    r.conv("conv1", "conv1")
    r.bn("bn1", "bn1")
    prelu("prelu", "prelu")
    for li in range(1, 5):
        for bi in range(r.count(f"layer{li}_{{}}")):
            p, k = f"layer{li}_{bi}", f"layer{li}.{bi}"
            r.bn(f"{p}/bn0", f"{k}.bn0")
            r.conv(f"{p}/conv1", f"{k}.conv1")
            r.bn(f"{p}/bn1", f"{k}.bn1")
            prelu(f"{p}/prelu", f"{k}.prelu")
            r.conv(f"{p}/conv2", f"{k}.conv2")
            r.bn(f"{p}/bn2", f"{k}.bn2")
            if r.has(f"{p}/se"):
                r.dense(f"{p}/se/fc0", f"{k}.se.fc.0")
                prelu(f"{p}/se/prelu", f"{k}.se.fc.1")
                r.dense(f"{p}/se/fc1", f"{k}.se.fc.2")
            if r.has(f"{p}/ds_conv"):
                r.conv(f"{p}/ds_conv", f"{k}.downsample.0")
                r.bn(f"{p}/ds_bn", f"{k}.downsample.1")
    r.bn("bn2", "bn2")
    r.dense("fc", "fc")
    r.bn("bn3", "bn3")
    return r.sd


def segformer_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX ``Segformer``'s variables -> HF
    ``SegformerForSemanticSegmentation`` keys, the port's
    ``models/parsing.py::Segformer`` state_dict (the inverse of
    ``canonswap_tpu/models/parsing.py::convert_hf_segformer``)."""
    r = _Reader(variables)
    e = "segformer.encoder"
    for i in range(r.count("patch_embed{}")):
        r.conv(f"patch_embed{i}", f"{e}.patch_embeddings.{i}.proj")
        r.affine(f"patch_norm{i}", f"{e}.patch_embeddings.{i}.layer_norm")
        for j in range(r.count(f"stage{i}_block{{}}")):
            b, t = f"stage{i}_block{j}", f"{e}.block.{i}.{j}"
            r.affine(f"{b}/norm1", f"{t}.layer_norm_1")
            for name in ("query", "key", "value"):
                r.dense(f"{b}/attn/{name}", f"{t}.attention.self.{name}")
            if r.has(f"{b}/attn/sr"):
                r.conv(f"{b}/attn/sr", f"{t}.attention.self.sr")
                r.affine(f"{b}/attn/sr_norm", f"{t}.attention.self.layer_norm")
            r.dense(f"{b}/attn/out", f"{t}.attention.output.dense")
            r.affine(f"{b}/norm2", f"{t}.layer_norm_2")
            r.dense(f"{b}/ffn/dense1", f"{t}.mlp.dense1")
            r.conv_dw(f"{b}/ffn/dwconv", f"{t}.mlp.dwconv.dwconv")
            r.dense(f"{b}/ffn/dense2", f"{t}.mlp.dense2")
        r.affine(f"stage_norm{i}", f"{e}.layer_norm.{i}")
    for i in range(r.count("linear_c{}")):
        r.dense(f"linear_c{i}", f"decode_head.linear_c.{i}.proj")
    r.conv("linear_fuse", "decode_head.linear_fuse")
    r.bn("bn", "decode_head.batch_norm")
    r.conv("classifier", "decode_head.classifier")
    return r.sd


FROM_JAX = {
    "appearance_feature_extractor": appearance_from_jax,
    "motion_extractor": motion_from_jax,
    "warping_module": warping_from_jax,
    "spade_generator": spade_from_jax,
    "transfer": transfer_from_jax,
    "refine": refine_from_jax,
}


def from_jax(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX core's variables (a dict of six trees keyed like the
    checkpoint) -> the port's ``CanonSwapCore`` state_dict."""
    out = {}
    for net, fn in FROM_JAX.items():
        for key, value in fn(variables[net]).items():
            out[f"{net}.{key}"] = value
    return out


def session_from_jax(session, trees: dict[str, Any]) -> None:
    """A JAX ``FaceSwapSession``'s weights into a port session, strict keys.

    ``trees`` holds the JAX session's variable trees (numpy or jax arrays):
    ``core`` (``params``, the six networks), ``scrfd``
    (``face_analysis.det_params``), ``landmark203`` and ``landmark106``
    (the runners' ``params``), ``parsing`` (``parsing_params``) and
    ``arcface`` (``arcface_params``).  The landmark trees go through the
    converter of the port runner's trunk; the core is cast to the session's
    compute dtype on load."""
    landmark = {"mobile": landmark_from_jax,
                "residual": landmark_net_from_jax}
    targets = (
        (session.core, from_jax, "core"),
        (session.face_analysis.det_model, scrfd_from_jax, "scrfd"),
        (session.landmark203.net, landmark[session.landmark203.trunk],
         "landmark203"),
        (session.lmk106.net, landmark[session.lmk106.trunk], "landmark106"),
        (session.parsing.model, segformer_from_jax, "parsing"),
        (session.arcface.net, arcface_from_jax, "arcface"),
    )
    for module, convert, name in targets:
        module.load_state_dict(convert(trees[name]), strict=True)
