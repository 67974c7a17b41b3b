"""The session and the CLI run on the card unless the caller asks for the
CPU, and a swap through ``swap_e2e`` on the card equals the same run on
the CPU.

Without a card, ``FaceSwapSession()`` and the CLI raise (checked here with
``torch.cuda.is_available`` patched to false).  On the card (marker
``cuda``), a ``.npy`` clip swapped at TINY in f32 on the square blend path
(no tracking crop: nothing amplifies a last-bit difference into another
crop) gives frames within one grey level of the CPU's, on at most
``255 * 2e-4`` (5.1 %) of the values: the card-vs-CPU bound of 2e-4 on
the [0, 1] images, quantized by truncation.  Both runs take the CPU's ID
crop: SCRFD's keypoints differ between the two in their last digits, the
112 crop's transform by about 6e-5, the crop then by a grey level at a
rounding step, and ArcFace's embedding past 2e-4 (the CPU tests force the
ID crop the same way).  This file imports neither
JAX nor the test helpers, so the card's machine runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canonswap_torch.cli import main as CLI
from canonswap_torch.configs import TINY, ArgumentConfig, InferenceConfig
from canonswap_torch.models.parsing import SegformerConfig
from canonswap_torch.pipelines import swap_e2e
from canonswap_torch.pipelines.session import FaceSwapSession
from canonswap_torch.utils import io as IO

SMALL = dict(model_cfg=TINY, det_size=(128, 128), arcface_layers=(1, 1, 1, 1),
             parsing_cfg=SegformerConfig(hidden_sizes=(8, 12, 20, 32),
                                         depths=(1, 1, 1, 1),
                                         num_heads=(1, 2, 5, 8),
                                         decoder_hidden=32),
             landmark_widths=(8, 12, 16, 24), landmark_trunk="residual")


def _media(d, seed=0):
    g = np.random.default_rng(seed)
    IO.save_image_rgb(str(d / "src.ppm"),
                      g.integers(0, 256, (200, 180, 3), np.uint8))
    np.save(d / "sq.npy", g.integers(0, 256, (3, 64, 64, 3), np.uint8))


def test_session_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceSwapSession(**SMALL)


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    _media(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["swap", "-s", str(tmp_path / "src.ppm"), "-t",
                  str(tmp_path / "sq.npy"), "-o", str(tmp_path / "out")])


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_session_defaults_to_the_card(cuda):
    s = FaceSwapSession(InferenceConfig(batch_size=2), **SMALL)
    assert s.device.type == "cuda"
    assert next(s.core.parameters()).device.type == "cuda"
    assert next(s.core.parameters()).dtype == torch.bfloat16
    frames = s.prepare_frames(np.zeros((2, 64, 64, 3), np.uint8))
    assert frames.device.type == "cuda" and frames.dtype == torch.bfloat16


@pytest.mark.cuda
def test_swap_e2e_on_the_card_equals_the_cpu(cuda, tmp_path):
    _media(tmp_path)
    results, crop = {}, None
    for dev in ("cpu", "cuda"):
        s = FaceSwapSession(InferenceConfig(batch_size=2,
                                            flag_use_half_precision=False),
                            device=dev, **SMALL)
        if crop is None:
            crop = s.id_cropper.get_single(
                IO.load_image_rgb(str(tmp_path / "src.ppm")))[0][0]
        s.id_cropper.get_single = lambda *a, **k: ([crop.to(dev)], [None])
        args = ArgumentConfig(source=str(tmp_path / "src.ppm"),
                              driving=str(tmp_path / "sq.npy"),
                              output_dir=str(tmp_path / dev))
        (tmp_path / "sq.pkl").unlink(missing_ok=True)
        results[dev] = [np.load(p) for p in swap_e2e.execute(s, args)]
    for got, want in zip(results["cuda"], results["cpu"]):
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() <= 255 * 2e-4, (diff > 0).mean()
