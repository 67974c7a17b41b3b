"""The port's SCRFD-10GF and FaceAnalysis vs the JAX package's, f32 on the CPU.

The JAX variables are flax's init at full width (SCRFD has no narrower
form) with every leaf drawn anew (``randomized``, BatchNorm statistics
included), carried to the port by ``runtime/weights.py::scrfd_from_jax``.
Modules and the whole net on a 128 x 128 input at rtol = atol = 2e-4 (the
port's tolerance; convs sum in another order); the letterbox within one
grey level of cv2 (1/128 after the normalization); FaceAnalysis.detect on
an image of exactly ``det_size`` (no resize on either side) with equal
detections, boxes and keypoints at 2e-4 of the image's size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.models import scrfd as PS
from canonswap_torch.runtime import face_analysis as PF
from canonswap_torch.runtime.weights import scrfd_from_jax
from canonswap_tpu.models import scrfd as JS
from canonswap_tpu.runtime import face_analysis as JF
from tests.helpers.torch_parity import assert_close, randomized, rng, t

SIZE = 128


@pytest.fixture(scope="module")
def nets():
    """(JAX variables, port net) on the same random weights."""
    v = randomized(jax.jit(JS.SCRFD().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))), seed=3)
    port = PS.SCRFD().eval().requires_grad_(False)
    port.load_state_dict(scrfd_from_jax(v), strict=True)
    return v, port


def _sub(v, *path):
    """The variables of the submodule at ``path`` (the neck has no
    batch_stats)."""
    out = {}
    for col in ("params", "batch_stats"):
        node = v[col]
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out


def _nchw(x):
    return t(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _x(shape, seed):
    return rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("path,module,shape", [
    (("backbone", "stem0"), JS.ConvBNReLU(28, stride=2), (2, 32, 32, 3)),
    (("backbone", "layer0_1"), JS.BasicBlock(56), (2, 16, 16, 56)),
    (("backbone", "layer1_0"), JS.BasicBlock(88, stride=2), (2, 16, 18, 56)),
    (("backbone", "layer3_0"), JS.BasicBlock(224, stride=2), (1, 8, 8, 88)),
], ids=["conv_bn_relu", "block", "block_avg_down", "block_widen"])
def test_backbone_modules(nets, path, module, shape):
    v, port = nets
    x = _x(shape, 1)
    want = module.apply(_sub(v, *path), jnp.asarray(x))
    mod = port
    for p in path:
        mod = getattr(mod, p)
    assert_close(_nhwc(mod(_nchw(x))), want)


def test_backbone_neck_head(nets):
    v, port = nets
    x = _x((2, SIZE, SIZE, 3), 2)
    feats = JS.ResNetV1e().apply(_sub(v, "backbone"), jnp.asarray(x))
    got = port.backbone(_nchw(x))
    assert [tuple(f.shape[2:]) for f in got] == [(16, 16), (8, 8), (4, 4)]
    for a, b in zip(got, feats):
        assert_close(_nhwc(a), b)
    neck = JS.PAFPN().apply(_sub(v, "neck"), feats)
    got_neck = port.neck([_nchw(np.asarray(f)) for f in feats])
    for a, b in zip(got_neck, neck):
        assert_close(_nhwc(a), b)
    head = JS.SCRFDHead().apply(_sub(v, "head"), neck[1])
    got_head = port.head(_nchw(np.asarray(neck[1])))
    for k in ("score", "bbox", "kps"):
        assert got_head[k].shape == head[k].shape
        assert_close(got_head[k], head[k])


def test_whole_scrfd(nets):
    v, port = nets
    x = _x((2, SIZE, SIZE, 3), 3)
    want = jax.jit(JS.SCRFD().apply)(v, jnp.asarray(x))
    got = port(_nchw(x))
    assert sorted(got) == [8, 16, 32]
    for s in (8, 16, 32):
        for k in ("score", "bbox", "kps"):
            assert_close(got[s][k], want[s][k])


@pytest.mark.parametrize("shape,size", [
    ((300, 200, 3), (128, 128)), ((200, 300, 3), (128, 128)),
    ((720, 1280, 3), (512, 512)), ((128, 128, 3), (128, 128))])
def test_preprocess_within_one_grey_level(shape, size):
    img = (rng(4).random(shape) * 255).astype(np.uint8)
    want, want_scale = JS.preprocess(img, size)
    got, got_scale = PS.preprocess(t(img), size)
    assert got.shape == (1, 3, size[1], size[0]) and got.dtype == \
        torch.float32
    assert got_scale == want_scale
    diff = np.abs(_nhwc(got) - want)
    assert diff.max() <= 1 / 128 + 1e-6


def test_detect_matches_jax(nets):
    """SCRFD + decode + NMS at a 128 x 128 det_size on a seeded image of
    that size: the same detections in the same order."""
    v, port = nets
    img = (rng(5).random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
    jfa = JF.FaceAnalysis(det_params=v, det_size=(SIZE, SIZE),
                          det_thresh=0.5)
    pfa = PF.FaceAnalysis(det_state_dict=port.state_dict(),
                          det_size=(SIZE, SIZE), det_thresh=0.5,
                          device="cpu")
    want_b, want_k = jfa.detect(img)
    got_b, got_k = pfa.detect(img)
    assert got_b.shape == want_b.shape and got_b.shape[0] > 0
    assert_close(got_b, want_b, rtol=2e-4, atol=2e-4 * SIZE)
    assert_close(got_k, want_k, rtol=2e-4, atol=2e-4 * SIZE)
    faces = pfa.get(img, flag_do_landmark_2d_106=False, max_face_num=3)
    want_faces = jfa.get(img, flag_do_landmark_2d_106=False, max_face_num=3)
    assert len(faces) == len(want_faces) == 3
    for a, b in zip(faces, want_faces):
        assert_close(a.bbox, b.bbox, rtol=2e-4, atol=2e-4 * SIZE)


def test_sort_faces_matches_jax():
    g = rng(6)
    boxes = g.random((6, 4)) * 50
    boxes[:, 2:] += boxes[:, :2]
    for direction in ("left-right", "right-left", "top-bottom", "bottom-top",
                      "small-large", "large-small",
                      "distance-from-retarget-face", "unknown"):
        got = PF.sort_faces([PF.Face(b, None, 0.0) for b in boxes],
                            direction, face_center=(20.0, 30.0))
        want = JF.sort_faces([JF.Face(b, None, 0.0) for b in boxes],
                             direction, face_center=(20.0, 30.0))
        assert [f.bbox.tolist() for f in got] == [f.bbox.tolist()
                                                  for f in want]


def test_id_cropper_matches_jax(nets):
    """The best face's (and every face's) 112 multiview crop: the same
    transforms, crops within one grey level of cv2.warpAffine."""
    v, port = nets
    img = (rng(7).random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
    jcrop = JF.FaceIDCropper(JF.FaceAnalysis(
        det_params=v, det_size=(SIZE, SIZE), det_thresh=0.5))
    pcrop = PF.FaceIDCropper(PF.FaceAnalysis(
        det_state_dict=port.state_dict(), det_size=(SIZE, SIZE),
        det_thresh=0.5, device="cpu"))
    for method in ("get_single", "get_multi"):
        want = getattr(jcrop, method)(img, max_num=3)
        got = getattr(pcrop, method)(img, max_num=3)
        assert len(got[0]) == len(want[0]) >= 1
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
        for a, b in zip(got[0], want[0]):
            assert a.dtype == torch.uint8 and a.shape == (112, 112, 3)
            assert np.abs(a.numpy().astype(int) - b.astype(int)).max() <= 1
