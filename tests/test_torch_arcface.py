"""The port's ArcFace vs the JAX package's, f32 on the CPU, and the source-ID
step.

Two weight paths.  JAX to port: flax's init at layers (1, 1, 1, 1) with
every leaf drawn anew (``randomized``), through ``runtime/weights.py::
arcface_from_jax``; the SE block, the IR blocks and the whole net (embedding
and mid) at rtol = atol = 2e-4, the port's tolerance.  Reference to both: the
port's seeded ``state_dict``, whose keys are the reference checkpoint's,
through the JAX package's ``convert_arcface`` and back through
``arcface_from_jax`` unchanged, and both nets on it at 2e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.models import arcface as PA
from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops import resize as PR
from canonswap_torch.runtime import face_analysis as PF
from canonswap_torch.runtime.weights import arcface_from_jax
from canonswap_tpu.models import arcface as JA
from canonswap_tpu.ops import resize as JR
from canonswap_tpu.runtime.weights import convert_arcface
from tests.helpers.torch_parity import (assert_close, np_state_dict,
                                        randomized, rng, t)

LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, JAX variables, port net) on the same random weights."""
    jnet = JA.ArcFaceResNet(layers=LAYERS)
    v = randomized(jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 112, 112, 3))), seed=2)
    port = PA.ArcFaceResNet(LAYERS).eval().requires_grad_(False)
    port.load_state_dict(arcface_from_jax(v), strict=True)
    return jnet, v, port


def _nchw(x):
    return t(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _vars(v, name):
    out = {"params": v["params"][name]}
    if name in v.get("batch_stats", {}):
        out["batch_stats"] = v["batch_stats"][name]
    return out


def test_se_block(nets):
    _, v, port = nets
    x = rng(1).standard_normal((2, 9, 9, 128), dtype=np.float32)
    want = JA.SEBlock().apply({"params": v["params"]["layer2_0"]["se"]},
                              jnp.asarray(x))
    assert_close(_nhwc(port.layer2[0].se(_nchw(x))), want)


@pytest.mark.parametrize("name,planes,stride,ds,shape", [
    ("layer1_0", 64, 1, False, (2, 14, 14, 64)),
    ("layer2_0", 128, 2, True, (2, 14, 14, 64)),
    ("layer4_0", 512, 2, True, (1, 7, 7, 256))])
def test_ir_block(nets, name, planes, stride, ds, shape):
    _, v, port = nets
    x = rng(2).standard_normal(shape, dtype=np.float32)
    want = JA.IRBlock(planes, stride, True, ds).apply(_vars(v, name),
                                                      jnp.asarray(x))
    layer, idx = name.split("_")
    assert_close(_nhwc(getattr(port, layer)[int(idx)](_nchw(x))), want)


def test_whole_net_and_get_id(nets):
    jnet, v, port = nets
    x = rng(3).standard_normal((2, 112, 112, 3), dtype=np.float32)
    emb, mid = jax.jit(jnet.apply)(v, jnp.asarray(x))
    got_emb, got_mid = port(_nchw(x))
    assert got_emb.shape == (2, 512) and got_mid.shape == (2, 256 * 7 * 7)
    assert_close(got_emb, emb)
    assert_close(got_mid, mid)
    # get_id: nearest resize to 112 first (from 150 and from 90)
    for side in (150, 90):
        img = rng(side).standard_normal((2, side, side, 3), dtype=np.float32)
        want = JA.get_id(jnet, v, jnp.asarray(img))
        got = PA.get_id(port, _nchw(img))
        assert_close(got, want)
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_reference_state_dict_through_convert_arcface():
    """The port's seeded state_dict has the reference's keys: the JAX
    converter reads it as a reference checkpoint, ``arcface_from_jax``
    gives it back exactly, and both nets agree on it."""
    port = init_random_(PA.ArcFaceResNet(LAYERS), 4).eval()
    sd = np_state_dict(port)
    assert "layer2.0.se.fc.1.weight" in sd and "layer2.0.downsample.1." \
        "running_var" in sd and "bn3.running_mean" in sd
    v = convert_arcface(sd)
    back = arcface_from_jax(v)
    strict = PA.ArcFaceResNet(LAYERS)
    strict.load_state_dict(back, strict=True)
    for k, value in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(back[k], value), k
    x = rng(5).standard_normal((1, 112, 112, 3), dtype=np.float32)
    emb, mid = jax.jit(JA.ArcFaceResNet(layers=LAYERS).apply)(
        v, jnp.asarray(x))
    with torch.inference_mode():
        got_emb, got_mid = port(_nchw(x))
    assert_close(got_emb, emb)
    assert_close(got_mid, mid)


def test_id_blob_matches_the_session():
    """ImageNet normalization of a uint8 crop, as the session computes it
    (pipelines/session.py:292-293)."""
    from canonswap_tpu.pipelines.session import IMAGENET_MEAN, IMAGENET_STD

    crop = (rng(6).random((112, 112, 3)) * 255).astype(np.uint8)
    want = (crop.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    got = PF.id_blob(t(crop))
    assert got.shape == (1, 3, 112, 112)
    assert_close(_nhwc(got)[0], want, rtol=1e-6, atol=1e-6)


def test_runner_embed_and_device_default(nets, monkeypatch):
    _, _, port = nets
    runner = PA.ArcFaceRunner(port.state_dict(), layers=LAYERS,
                              device="cpu")
    x = rng(7).standard_normal((1, 3, 112, 112), dtype=np.float32)
    with torch.inference_mode():
        want = port(t(x))[0]
    assert torch.equal(runner.embed(t(x)), want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.ArcFaceRunner(layers=LAYERS)


class _OneCrop:
    """An ID cropper that returns one given crop (or no face)."""

    def __init__(self, crop):
        self.crop = crop

    def get_single(self, img, crop_size=112, max_num=0):
        return None if self.crop is None else ([self.crop], [None])


def test_source_id_matches_the_session_steps(nets):
    """After the ID crop (held in tests/test_torch_scrfd.py): the session's
    normalization, ArcFace, the cut to latent_dim and L2 normalization
    (pipelines/session.py:289-300), on the JAX side step by step."""
    from canonswap_tpu.pipelines.session import IMAGENET_MEAN, IMAGENET_STD

    jnet, v, port = nets
    crop = (rng(8).random((112, 112, 3)) * 255).astype(np.uint8)
    x = (crop.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    emb, _ = jax.jit(jnet.apply)(v, jnp.asarray(x)[None])
    runner = PA.ArcFaceRunner(port.state_dict(), layers=LAYERS,
                              device="cpu")
    for dim in (512, 32):
        want = np.asarray(emb)[..., :dim]
        want = want / np.linalg.norm(want, axis=-1, keepdims=True)
        got = PF.source_id(_OneCrop(t(crop)), runner, None, latent_dim=dim)
        assert got.shape == (1, dim)
        assert_close(got, want)
    with pytest.raises(RuntimeError, match="No face detected"):
        PF.source_id(_OneCrop(None), runner, None)


@pytest.mark.parametrize("shape,out", [((2, 14, 14, 8), (7, 7)),
                                       ((2, 15, 11, 8), (7, 7)),
                                       ((1, 9, 20, 3), (4, 6))])
def test_pools_and_nearest_resize_match_jax(shape, out):
    """adaptive_avg_pool (divisible and torch's uneven bins), nearest_resize
    (down and up), the padded max pool of SCRFD's stem."""
    x = rng(9).standard_normal(shape, dtype=np.float32)
    assert_close(_nhwc(PR.adaptive_avg_pool(_nchw(x), out)),
                 JR.adaptive_avg_pool(jnp.asarray(x), out))
    for size in (out, (shape[1] * 2 + 1, shape[2] + 3)):
        np.testing.assert_array_equal(
            _nhwc(PR.nearest_resize(_nchw(x), size)),
            np.asarray(JR.nearest_resize(jnp.asarray(x), size)))
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                     constant_values=-jnp.inf)
    np.testing.assert_array_equal(
        _nhwc(PR.max_pool(_nchw(x), (3, 3), (2, 2), padding=1)),
        np.asarray(JR.max_pool(padded, (3, 3), strides=(2, 2))))
