"""A JAX ``FaceSwapSession`` and a port session on the same weights, at
TINY in f32 on the CPU, for the session and pipeline parity tests.

The JAX session is built with ``fast_init`` (zero trees, no init pass) and
every tree is redrawn by ``randomized``; ``session_from_jax`` carries the
trees into the port session.  The reduced sidecars are
``tests/test_pipeline_e2e.py``'s: SCRFD at (128, 128), ArcFace (1, 1, 1,
1), a four-stage Segformer, the residual landmark trunk at (8, 12, 16,
24)."""

from __future__ import annotations

import jax
import numpy as np

from canonswap_torch import configs as PC
from canonswap_torch.models import parsing as PP
from canonswap_torch.pipelines import session as PS
from canonswap_torch.runtime.weights import session_from_jax
from canonswap_tpu.configs import model_config as JMC
from canonswap_tpu.configs import pipeline_config as JPC
from canonswap_tpu.models import parsing as JP
from canonswap_tpu.pipelines import session as JS
from tests.helpers.torch_parity import randomized

PARSING = dict(hidden_sizes=(8, 12, 20, 32), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 5, 8), decoder_hidden=32)
COMMON = dict(det_size=(128, 128), arcface_layers=(1, 1, 1, 1),
              landmark_widths=(8, 12, 16, 24), landmark_trunk="residual")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def build_pair(batch_size: int = 2, seed: int = 0, **inference):
    """(JAX session, port session), f32, the same weights."""
    js = JS.FaceSwapSession(
        JPC.InferenceConfig(batch_size=batch_size,
                            flag_use_half_precision=False, **inference),
        JPC.CropConfig(), JMC.TINY, parsing_cfg=JP.SegformerConfig(**PARSING),
        fast_init=True, **COMMON)
    trees = {
        "core": randomized(_np(js.params), seed + 1),
        "scrfd": randomized(_np(js.face_analysis.det_params), seed + 2),
        "landmark203": randomized(_np(js.landmark203.params), seed + 3),
        "landmark106": randomized(_np(js.lmk106.params), seed + 4),
        "parsing": randomized(_np(js.parsing_params), seed + 5),
        "arcface": randomized(_np(js.arcface_params), seed + 6),
    }
    js.params = trees["core"]
    js.face_analysis.det_params = trees["scrfd"]
    js.landmark203.params = trees["landmark203"]
    js.lmk106.params = trees["landmark106"]
    js.parsing_params = trees["parsing"]
    js.arcface_params = trees["arcface"]
    ps = PS.FaceSwapSession(
        PC.InferenceConfig(batch_size=batch_size,
                           flag_use_half_precision=False, **inference),
        PC.CropConfig(), PC.TINY, parsing_cfg=PP.SegformerConfig(**PARSING),
        fast_init=True, device="cpu", **COMMON)
    session_from_jax(ps, trees)
    return js, ps


def force_id_crop(js, ps, img: np.ndarray, monkeypatch) -> np.ndarray:
    """Both sessions' ID cropper returns the JAX session's ID crop of
    ``img`` (held within one grey level of it in
    tests/test_torch_scrfd.py, where the face's kps differ at 2e-4): a grey
    level on the 112 crop moves ArcFace's embedding past 2e-4."""
    import torch

    crop = js.id_cropper.get_single(img, crop_size=112, max_num=1)[0][0]
    monkeypatch.setattr(js.id_cropper, "get_single",
                        lambda *a, **k: ([crop], [None]))
    monkeypatch.setattr(ps.id_cropper, "get_single",
                        lambda *a, **k: ([torch.from_numpy(crop)], [None]))
    return crop
