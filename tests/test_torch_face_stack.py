"""The per-clip face stack's entry points run on the card unless the caller
asks for the CPU.

``FaceAnalysis``, ``Landmark106Runner``, ``ArcFaceRunner`` (with
``source_id``) and ``Cropper`` take ``device="cuda"`` by default: without a
card they raise instead of running on the CPU (checked here with
``torch.cuda.is_available`` patched to false), and on the card (marker
``cuda``) each builds there and returns its tensors there.  This file
imports neither JAX nor the test helpers, so the card's machine runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_face_stack.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canonswap_torch.configs import CropConfig
from canonswap_torch.models.arcface import ArcFaceRunner
from canonswap_torch.models.landmark import (Landmark106Runner,
                                             Landmark203Runner)
from canonswap_torch.runtime.cropper import Cropper
from canonswap_torch.runtime.face_analysis import (FaceAnalysis,
                                                   FaceIDCropper, source_id)

ENTRY_POINTS = {
    "FaceAnalysis": lambda: FaceAnalysis(det_size=(128, 128)),
    "Landmark106Runner": lambda: Landmark106Runner(),
    "ArcFaceRunner": lambda: ArcFaceRunner(layers=(1, 1, 1, 1)),
    "Cropper": lambda: Cropper(
        CropConfig(), FaceAnalysis(det_size=(128, 128), device="cpu"),
        Landmark203Runner(device="cpu")),
}


def _image(seed: int = 0, shape=(128, 128, 3)) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_the_cpu_by_name_runs_the_whole_stack():
    """Each entry point with ``device="cpu"``: the source ID and a crop
    (the crop with one face: the seeded detector finds many)."""
    lmk106 = Landmark106Runner(device="cpu")
    fa = FaceAnalysis(lmk106=lmk106, det_size=(128, 128), device="cpu")
    sid = source_id(FaceIDCropper(fa), ArcFaceRunner(layers=(1, 1, 1, 1),
                                                     device="cpu"),
                    _image(1), latent_dim=32)
    assert sid.shape == (1, 32) and sid.device.type == "cpu"
    assert float(sid.norm()) == pytest.approx(1.0, abs=1e-6)
    cropper = Cropper(CropConfig(dsize=128, max_face_num=1), fa,
                      Landmark203Runner(device="cpu"), network_input_size=64,
                      device="cpu")
    ret = cropper.crop_source_image(_image(2))
    assert ret["img_crop_256x256"].shape == (64, 64, 3)
    assert ret["img_crop_256x256"].dtype == torch.uint8
    assert ret["lmk_crop"].shape == (203, 2)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # for this test only: later tests keep their own setting
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
def test_face_analysis_and_source_id_default_to_the_card(cuda):
    fa = FaceAnalysis(lmk106=Landmark106Runner(), det_size=(128, 128))
    assert next(fa.det_model.parameters()).device.type == "cuda"
    boxes, kps = fa.detect(_image(3))
    assert boxes.shape[1] == 5 and kps.shape[1:] == (5, 2)
    faces = fa.get(_image(3), max_face_num=1)
    assert faces and faces[0].landmark_2d_106.shape == (106, 2)
    arcface = ArcFaceRunner(layers=(1, 1, 1, 1))
    sid = source_id(FaceIDCropper(fa), arcface, _image(4))
    assert sid.device.type == "cuda" and sid.shape == (1, 512)
    assert abs(float(sid.norm()) - 1.0) <= 1e-5


@pytest.mark.cuda
def test_landmark106_runner_defaults_to_the_card(cuda):
    runner = Landmark106Runner()
    assert next(runner.net.parameters()).device.type == "cuda"
    crop, _ = runner.crop(_image(5), [30.0, 30.0, 90.0, 100.0])
    assert crop.device.type == "cuda" and crop.shape == (192, 192, 3)
    pts = runner.get(_image(5), [30.0, 30.0, 90.0, 100.0])
    assert pts.shape == (106, 2) and np.isfinite(pts).all()


@pytest.mark.cuda
def test_cropper_defaults_to_the_card(cuda):
    fa = FaceAnalysis(lmk106=Landmark106Runner(), det_size=(128, 128))
    cropper = Cropper(CropConfig(max_face_num=1), fa, Landmark203Runner())
    assert cropper.device.type == "cuda"
    out = cropper.crop_source_video([_image(6), _image(7)])
    assert len(out["frame_crop_lst"]) == 2
    for crop in out["frame_crop_lst"]:
        assert crop.device.type == "cuda" and crop.shape == (256, 256, 3)
        assert crop.dtype == torch.uint8
    assert isinstance(out["M_c2o_lst"][0], np.ndarray)
