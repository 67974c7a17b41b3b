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
``scrfd_from_jax``, ``arcface_from_jax``), the stitching nets
(:func:`stitching_from_jax`, and :func:`load_stitching_checkpoint` for the
reference's file), and a whole JAX session's (:func:`session_from_jax`).
:func:`to_jax` goes the other way for the core, so the port writes the JAX
package's ``.npz``.

Spectral norm stays baked into the SPADE convs' ``weight``; with live
spectral norm (``SpadeConfig.spectral_norm``) the ``spectral`` collection's
``u`` is the conv's ``u`` buffer.
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
        self.spectral = variables.get("spectral", {})
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(root, path: str):
        for part in path.split("/"):
            root = root[part]
        return root

    def has(self, path: str, key: str | None = None) -> bool:
        """Whether the tree holds ``path``; ``key`` names the same module
        in the state_dict, for :class:`_Writer`."""
        try:
            self._node(self.params, path)
        except KeyError:
            return False
        return True

    def count(self, fmt: str, key_fmt: str | None = None) -> int:
        i = 0
        while self.has(fmt.format(i), None if key_fmt is None
                       else key_fmt.format(i)):
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
        try:  # live spectral norm's power-iteration vector
            self._put(f"{key}.u", self._node(self.spectral, path)["u"])
        except KeyError:
            pass

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

    def grn(self, path: str, key: str) -> None:
        grn = self._node(self.params, path)
        for name in ("gamma", "beta"):
            self._put(f"{key}.{name}", np.asarray(grn[name]).reshape(1, 1, 1, -1))

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
        if self.has(f"{path}/shortcut", f"{key}.shortcut"):
            self.conv(f"{path}/shortcut", f"{key}.shortcut")

    def spade(self, path: str, key: str) -> None:
        self.conv(f"{path}/mlp_shared", f"{key}.mlp_shared.0")
        self.conv(f"{path}/mlp_gamma", f"{key}.mlp_gamma")
        self.conv(f"{path}/mlp_beta", f"{key}.mlp_beta")

    def spade_resblock(self, path: str, key: str) -> None:
        for i in (0, 1):
            self.spade(f"{path}/norm_{i}", f"{key}.norm_{i}")
            self.conv(f"{path}/conv_{i}", f"{key}.conv_{i}")
        if self.has(f"{path}/conv_s", f"{key}.conv_s"):
            self.spade(f"{path}/norm_s", f"{key}.norm_s")
            self.conv(f"{path}/conv_s", f"{key}.conv_s")

    def adaptive_conv(self, path: str, key: str) -> None:
        leaf = self._node(self.params, path)
        self._put(f"{key}.weight", np.asarray(leaf["weight"]).transpose(3, 2, 0, 1))
        self._put(f"{key}.bias_param", leaf["bias"])
        self.dense(f"{path}/style_fc0", f"{key}.style_fc.0")
        self.dense(f"{path}/style_fc1", f"{key}.style_fc.2")
        self.conv(f"{path}/mask_conv", f"{key}.mask_conv.0")


class _Writer(_Reader):
    """The inverse of :class:`_Reader`: one network's torch state_dict into
    its JAX tree (``params``, ``batch_stats``, ``spectral``) of numpy
    arrays.  The blocks are the reader's; each leaf goes the other way, and
    a structural query looks for the module's key in the state_dict."""

    def __init__(self, sd: dict):
        self.src = {k: v.detach().cpu().numpy() for k, v in sd.items()}
        self.params: dict = {}
        self.stats: dict = {}
        self.spectral: dict = {}

    def has(self, path: str, key: str | None = None) -> bool:
        return any(k.startswith(key + ".") for k in self.src)

    @staticmethod
    def _set(root: dict, path: str, leaf: str, value) -> None:
        for part in path.split("/"):
            root = root.setdefault(part, {})
        root[leaf] = np.ascontiguousarray(value)

    def _leaf(self, path, leaf, key, root=None) -> None:
        self._set(self.params if root is None else root, path, leaf,
                  self.src[key])

    def conv(self, path: str, key: str) -> None:
        w = self.src[f"{key}.weight"]
        n = w.ndim
        self._set(self.params, path, "kernel",
                  w.transpose(*range(2, n), 1, 0))
        if f"{key}.bias" in self.src:
            self._leaf(path, "bias", f"{key}.bias")
        if f"{key}.u" in self.src:
            self._leaf(path, "u", f"{key}.u", self.spectral)

    def conv_dw(self, path: str, key: str) -> None:
        self._set(self.params, path, "kernel",
                  self.src[f"{key}.weight"].transpose(2, 3, 1, 0))
        if f"{key}.bias" in self.src:
            self._leaf(path, "bias", f"{key}.bias")

    def dense(self, path: str, key: str) -> None:
        self._set(self.params, path, "kernel", self.src[f"{key}.weight"].T)
        if f"{key}.bias" in self.src:
            self._leaf(path, "bias", f"{key}.bias")

    def affine(self, path: str, key: str) -> None:
        self._leaf(path, "scale", f"{key}.weight")
        self._leaf(path, "bias", f"{key}.bias")

    def bn(self, path: str, key: str) -> None:
        self.affine(path, key)
        self._leaf(path, "mean", f"{key}.running_mean", self.stats)
        self._leaf(path, "var", f"{key}.running_var", self.stats)

    def grn(self, path: str, key: str) -> None:
        for name in ("gamma", "beta"):
            self._set(self.params, path, name,
                      self.src[f"{key}.{name}"].reshape(-1))

    def adaptive_conv(self, path: str, key: str) -> None:
        self._set(self.params, path, "weight",
                  self.src[f"{key}.weight"].transpose(2, 3, 1, 0))
        self._leaf(path, "bias", f"{key}.bias_param")
        self.dense(f"{path}/style_fc0", f"{key}.style_fc.0")
        self.dense(f"{path}/style_fc1", f"{key}.style_fc.2")
        self.conv(f"{path}/mask_conv", f"{key}.mask_conv.0")

    def variables(self) -> dict:
        out = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        if self.spectral:
            out["spectral"] = self.spectral
        return out


def _appearance(r: _Reader) -> None:
    r.same_block("first", "first")
    for i in range(r.count("down{}", "down_blocks.{}")):
        r.same_block(f"down{i}", f"down_blocks.{i}")
    r.conv("second", "second")
    for i in range(r.count("res3d_{}", "resblocks_3d.3dr{}")):
        r.res_block(f"res3d_{i}", f"resblocks_3d.3dr{i}")


def _motion(r: _Reader) -> None:
    d, t = "detector/", "detector."
    r.conv(d + "stem_conv", t + "downsample_layers.0.0")
    r.affine(d + "stem_norm", t + "downsample_layers.0.1")
    for i in range(1, 4):
        r.affine(d + f"down{i}_norm", t + f"downsample_layers.{i}.0")
        r.conv(d + f"down{i}_conv", t + f"downsample_layers.{i}.1")
    for i in range(4):
        for j in range(r.count(d + f"stage{i}_block{{}}",
                               t + f"stages.{i}.{{}}")):
            b, k = d + f"stage{i}_block{j}", t + f"stages.{i}.{j}"
            r.conv_dw(f"{b}/dwconv", f"{k}.dwconv")
            r.affine(f"{b}/norm", f"{k}.norm")
            r.dense(f"{b}/pwconv1", f"{k}.pwconv1")
            r.grn(f"{b}/grn", f"{k}.grn")
            r.dense(f"{b}/pwconv2", f"{k}.pwconv2")
    r.affine(d + "head_norm", t + "norm")
    for head in ("fc_kp", "fc_pitch", "fc_yaw", "fc_roll", "fc_t", "fc_exp",
                 "fc_scale"):
        r.dense(d + head, t + head)


def _warping(r: _Reader) -> None:
    dm = "dense_motion_network"
    hg = f"{dm}/hourglass"
    r.conv(f"{dm}/compress", f"{dm}.compress")
    r.bn(f"{dm}/norm", f"{dm}.norm")
    for i in range(r.count(hg + "/encoder/down{}",
                           f"{dm}.hourglass.encoder.down_blocks.{{}}")):
        r.same_block(f"{hg}/encoder/down{i}",
                     f"{dm}.hourglass.encoder.down_blocks.{i}")
    for j in range(r.count(hg + "/decoder/up{}",
                           f"{dm}.hourglass.decoder.up_blocks.{{}}")):
        r.same_block(f"{hg}/decoder/up{j}",
                     f"{dm}.hourglass.decoder.up_blocks.{j}")
    r.conv(f"{hg}/decoder/Conv_0", f"{dm}.hourglass.decoder.conv")
    r.bn(f"{hg}/decoder/BatchNorm_0", f"{dm}.hourglass.decoder.norm")
    r.conv(f"{dm}/mask", f"{dm}.mask")
    r.conv(f"{dm}/occlusion", f"{dm}.occlusion")
    r.same_block("third", "third")
    r.conv("fourth", "fourth")


def _spade(r: _Reader) -> None:
    r.conv("fc", "fc")
    for name in [f"G_middle_{i}" for i in range(6)] + ["up_0", "up_1"]:
        r.spade_resblock(name, name)
    # the pixel-shuffle head is nn.Sequential(conv, PixelShuffle)
    r.conv("conv_img", "conv_img.0")


def _transfer(r: _Reader) -> None:
    for i in range(r.count("bottleneck2d_{}", "BottleNeck_2d.{}")):
        for conv in ("conv1", "conv2"):
            r.adaptive_conv(f"bottleneck2d_{i}/{conv}",
                            f"BottleNeck_2d.{i}.{conv}")
    for i in range(r.count("res3d_{}", "resblocks_3d.3dr{}")):
        r.res_block(f"res3d_{i}", f"resblocks_3d.3dr{i}")


def _refine(r: _Reader) -> None:
    for i in range(3):
        r.res_block_leak_gn(f"res3d_in_{i}", f"resblocks1.{i}")
        r.res_block(f"res2d_{i}", f"resblocks2.{i}")
        r.res_block_leak_gn(f"res3d_out_{i}", f"resblocks3.{i}")


def _read(body, variables: dict) -> dict[str, torch.Tensor]:
    r = _Reader(variables)
    body(r)
    return r.sd


def appearance_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    return _read(_appearance, variables)


def motion_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    return _read(_motion, variables)


def warping_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    return _read(_warping, variables)


def spade_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    return _read(_spade, variables)


def transfer_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    return _read(_transfer, variables)


def refine_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    return _read(_refine, variables)


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


_BODIES = {
    "appearance_feature_extractor": _appearance,
    "motion_extractor": _motion,
    "warping_module": _warping,
    "spade_generator": _spade,
    "transfer": _transfer,
    "refine": _refine,
}


def to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse of :func:`from_jax`: the port's ``CanonSwapCore``
    state_dict -> the JAX core's variables, six trees of numpy arrays keyed
    like the checkpoint, the layout ``canonswap_tpu.runtime.checkpoint.
    save_npz`` writes.  ``num_batches_tracked`` has no JAX leaf."""
    out = {}
    for net, body in _BODIES.items():
        w = _Writer({k[len(net) + 1:]: v for k, v in state_dict.items()
                     if k.startswith(net + ".")})
        body(w)
        out[net] = w.variables()
    return out


def stitching_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX ``StitchingModule``'s variables (``params`` of ``stitching``,
    ``eye`` and ``lip``, each ``fc{i}`` and ``out``) -> the port's
    ``models/stitching.py::StitchingModule`` state_dict."""
    out = {}
    for net, tree in variables["params"].items():
        r = _Reader({"params": tree})
        n = r.count("fc{}")
        for i in range(n):
            r.dense(f"fc{i}", f"mlp.{2 * i}")
        r.dense("out", f"mlp.{2 * n}")
        out.update({f"{net}.{k}": v for k, v in r.sd.items()})
    return out


def load_stitching_checkpoint(path: str | os.PathLike
                              ) -> dict[str, torch.Tensor]:
    """The stitching and retargeting checkpoint -> the port's
    ``StitchingModule`` state_dict: the reference's ``.pth`` (a dict of the
    ``retarget_shoulder``, ``retarget_eye`` and ``retarget_mouth``
    state_dicts, keys ``mlp.{2i}``; torch alone, ``weights_only``) or the
    ``.npz`` that ``python -m canonswap_tpu.cli.convert stitching`` writes
    (its '/'-flattened JAX tree; numpy alone)."""
    from canonswap_torch.models.stitching import CHECKPOINT_KEYS
    from canonswap_torch.runtime.checkpoint import load_npz

    path = os.fspath(path)
    if path.endswith(".npz"):
        return stitching_from_jax(load_npz(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {f"{net}.{k}": v for net, theirs in CHECKPOINT_KEYS.items()
            for k, v in strip_prefixes(ckpt[theirs]).items()}


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
