"""The port's Cropper on an animal face (its XPose branch) vs the JAX
package's, at ``unipose.TINY``, f32 on the CPU.

Both Croppers take their landmarks from XPose on the same weights (the
port's seeded init through ``convert_unipose``), for a 64 x 80 image that
sits in the (64, 96) canvas at scale 1, so both canvases are equal.  The
landmarks are held as ``tests/test_torch_xpose.py`` holds the runner (2e-4
of the image's size); the 512 crop and its 256 area resize, taken at
transforms that move with those landmarks, within one grey level; the
transforms at rtol 1e-4 (landmarks 2e-4 apart, divided by a face box of
tens of pixels).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from canonswap_torch import configs as PC
from canonswap_torch.models.xpose import unipose as PU
from canonswap_torch.models.xpose.runner import XPoseRunner
from canonswap_torch.nn.init import init_random_
from canonswap_torch.runtime import cropper as PCR
from canonswap_tpu.configs import pipeline_config as JC
from canonswap_tpu.models.xpose import runner as JR
from canonswap_tpu.models.xpose import swin as JS
from canonswap_tpu.models.xpose import unipose as JU
from canonswap_tpu.models.xpose.convert import convert_unipose
from canonswap_tpu.runtime import cropper as JCR
from tests.helpers.torch_parity import assert_close, np_state_dict, rng

CANVAS = (64, 96)
T_LEN = 8


def test_crop_source_image_animal_face():
    cfg = PU.TINY
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["swin"] = JS.SwinConfig(**dataclasses.asdict(cfg.swin))
    jcfg = JU.UniPoseConfig(**fields)
    model = init_random_(PU.UniPose(cfg), 0).eval().requires_grad_(False)
    g = rng(31)
    img = (g.random((64, 80, 3)) * 255).astype(np.uint8)
    embed = (g.standard_normal((2, 512), dtype=np.float32),
             g.standard_normal((9, 512), dtype=np.float32))
    jr = JR.XPoseRunner(params=convert_unipose(np_state_dict(model), jcfg),
                        cfg=jcfg, canvas=CANVAS, max_text_len=T_LEN)
    pr = XPoseRunner(state_dict=model.state_dict(), cfg=cfg, canvas=CANVAS,
                     max_text_len=T_LEN, device="cpu")
    jr.embeddings[9] = pr.embeddings[9] = embed
    jc = JCR.Cropper(JC.CropConfig(), None, None, image_type="animal_face",
                     animal_landmark_runner=jr)
    pc = PCR.Cropper(PC.CropConfig(), None, None, image_type="animal_face",
                     animal_landmark_runner=pr, device="cpu")
    want = jc.crop_source_image(img)
    got = pc.crop_source_image(img)
    assert want is not None and got is not None
    assert got["lmk_crop"].shape == (9, 2)
    assert_close(got["lmk_crop"], want["lmk_crop"], rtol=2e-4,
                 atol=2e-4 * 80)
    for k in ("M_o2c", "M_c2o"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    for k in ("img_crop", "img_crop_256x256"):
        diff = np.abs(got[k].numpy().astype(int) - want[k].astype(int))
        assert got[k].dtype.is_floating_point is False and diff.max() <= 1
