"""The port's Segformer face parsing and mask post-processing vs the JAX
package's, f32 on the CPU, rtol = atol = 2e-4 (the port's tolerance).

The JAX variables are flax's init at ``TINY`` (the widths of
tests/test_parsing_parity.py) with every leaf drawn anew from a seed
(``randomized``), carried to the port by ``runtime/weights.py::
segformer_from_jax``.  Masks are argmaxes: the port's and JAX's logits differ
by float rounding, so a mask may differ where the top two upsampled logits
are within 1e-5 of each other, and nowhere else.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.models import parsing as PP
from canonswap_torch.ops import affine as PA
from canonswap_torch.ops.resize import bilinear_resize
from canonswap_torch.runtime.weights import segformer_from_jax
from canonswap_tpu.models import parsing as JP
from canonswap_tpu.ops import affine as JA
from canonswap_tpu.ops.resize import bilinear_resize as jax_bilinear_resize
from tests.helpers.torch_parity import assert_close, randomized, rng, t

TIE = 1e-5


def jax_config(cfg: PP.SegformerConfig) -> JP.SegformerConfig:
    return JP.SegformerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX variables, port model) on the same random weights."""
    jm = JP.Segformer(jax_config(PP.TINY))
    v = randomized(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 3))), seed=1)
    port = PP.Segformer(PP.TINY).eval().requires_grad_(False)
    port.load_state_dict(segformer_from_jax(v), strict=True)
    return jm, v, port


def _block(v, i, j=0):
    return v["params"][f"stage{i}_block{j}"]


# ---- modules -----------------------------------------------------------------


@pytest.mark.parametrize("stage,hw", [(0, (16, 16)), (0, (18, 14)),
                                      (1, (8, 8)), (1, (9, 7)), (3, (2, 2))],
                         ids=["sr8", "sr8_indivisible", "sr4",
                              "sr4_indivisible", "sr1"])
def test_efficient_attention_matches_jax(tiny, stage, hw):
    """Indivisible sizes take flax's SAME padding in the ``sr`` conv."""
    _, v, port = tiny
    c = PP.TINY
    dim = c.hidden_sizes[stage]
    x = rng(stage).standard_normal((2, *hw, dim), dtype=np.float32)
    ref = JP.EfficientAttention(dim, c.num_heads[stage], c.sr_ratios[stage])
    want = ref.apply({"params": _block(v, stage)["attn"]}, jnp.asarray(x))
    got = port.segformer.encoder.block[stage][0].attention(t(x))
    assert_close(got, want)


def test_same_pad_matches_flax():
    """SAME for a (r, r)-strided conv: ceil(n / r) outputs, the low side
    padded by half the total."""
    x = torch.zeros((1, 1, 18, 13))
    assert PP._same_pad(x, 8, 8).shape[-2:] == (24, 16)
    assert PP._same_pad(x, 2, 2).shape[-2:] == (18, 14)
    padded = PP._same_pad(torch.ones((1, 1, 18, 13)), 8, 8)
    assert padded[0, 0, 3:21, 1:14].all() and padded.sum() == 18 * 13


def test_mix_ffn_matches_jax(tiny):
    _, v, port = tiny
    dim = PP.TINY.hidden_sizes[1]
    x = rng(5).standard_normal((2, 9, 7, dim), dtype=np.float32)
    want = JP.MixFFN(dim, PP.TINY.mlp_ratio).apply(
        {"params": _block(v, 1)["ffn"]}, jnp.asarray(x))
    assert_close(port.segformer.encoder.block[1][0].mlp(t(x)), want)


@pytest.mark.parametrize("stage", [0, 2])
def test_block_matches_jax(tiny, stage):
    _, v, port = tiny
    c = PP.TINY
    dim = c.hidden_sizes[stage]
    x = rng(6 + stage).standard_normal((2, 10, 12, dim), dtype=np.float32)
    ref = JP.SegformerBlock(dim, c.num_heads[stage], c.sr_ratios[stage],
                            c.mlp_ratio)
    want = ref.apply({"params": _block(v, stage)}, jnp.asarray(x))
    assert_close(port.segformer.encoder.block[stage][0](t(x)), want)


@pytest.mark.parametrize("hw", [(64, 64), (70, 54)],
                         ids=["divisible", "sr_indivisible"])
def test_segformer_matches_jax(tiny, hw):
    """The whole TINY forward; at 70 x 54 the stages are 18 x 14, 9 x 7,
    5 x 4 and 3 x 2, none divisible by its ``sr`` ratio."""
    jm, v, port = tiny
    x = rng(10).standard_normal((2, *hw, 3), dtype=np.float32)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    got = port(t(x))
    assert got.shape == want.shape
    assert_close(got, want)


@pytest.mark.parametrize("shape,size", [((2, 3, 16, 16), (64, 64)),
                                        ((1, 5, 5, 7), (18, 14)),
                                        ((1, 19, 64, 64), (512, 512)),
                                        ((1, 4, 8, 8), (8, 8))])
def test_bilinear_resize_matches_jax_when_upsampling(shape, size):
    x = rng(11).standard_normal(shape, dtype=np.float32)
    want = jax_bilinear_resize(jnp.asarray(np.moveaxis(x, 1, -1)), size)
    got = bilinear_resize(t(x), size)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want,
                               rtol=1e-5, atol=1e-5)


def test_bilinear_resize_refuses_a_downsample():
    """A size that shrinks one side no longer raises: it antialiases there,
    as ``jax.image.resize`` does (down in height, up in width here)."""
    x = rng(13).standard_normal((1, 2, 16, 16), dtype=np.float32)
    want = jax_bilinear_resize(jnp.asarray(np.moveaxis(x, 1, -1)), (8, 32))
    got = bilinear_resize(t(x), (8, 32))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want,
                               rtol=1e-5, atol=1e-5)


def test_preprocess_matches_jax():
    frames = (rng(12).random((2, 16, 16, 3)) * 255).astype(np.uint8)
    assert_close(PP.preprocess(t(frames)), JP.preprocess(jnp.asarray(frames)),
                 rtol=1e-6, atol=1e-6)


# ---- masks -------------------------------------------------------------------


def _near_ties(logits_nhwc: np.ndarray, size) -> np.ndarray:
    """Pixels whose top two upsampled logits are within TIE."""
    up = np.asarray(jax_bilinear_resize(jnp.asarray(logits_nhwc), size))
    top2 = np.sort(up, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= TIE


def test_face_mask_matches_jax():
    logits = rng(13).standard_normal((2, 16, 16, 19), dtype=np.float32)
    want = np.asarray(JP.face_mask_from_logits(jnp.asarray(logits), (64, 64)))
    got = PP.face_mask_from_logits(t(logits), (64, 64)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    differ = got[..., 0] != want[..., 0]
    assert not (differ & ~_near_ties(logits, (64, 64))).any()
    assert 0.05 < want.mean() < 0.95


def test_face_mask_ties_go_to_the_first_index():
    """Equal top logits: argmax takes the lower class, as jnp.argmax."""
    logits = np.zeros((1, 4, 4, 19), np.float32)
    logits[..., 0] = logits[..., 1] = 1.0  # background ties skin: background
    logits[0, :2, :, 13] = logits[0, :2, :, 2] = 2.0  # hair ties brow: brow
    want = np.asarray(JP.face_mask_from_logits(jnp.asarray(logits), (8, 8)))
    got = PP.face_mask_from_logits(t(logits), (8, 8)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, :4].all() and not got[0, 4:].any()


def test_soft_erosion_matches_jax():
    x = np.zeros((2, 64, 48, 1), np.float32)
    x[0, 10:50, 8:40] = 1.0
    x[1, 20:60, 5:30] = 1.0
    x[1, 30:40, 10:20] = 0.0
    assert_close(PA._radial_kernel(21), JA._radial_kernel(21))
    want = JA.soft_erosion(jnp.asarray(x), 21, 0.9, 3)
    got = PA.soft_erosion(t(x), 21, 0.9, 3)
    assert_close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_parse_masks_matches_the_jax_composition(tiny):
    """FaceParser.parse_masks against pipelines/session.py:306-311 on the
    same weights: preprocess, Segformer, face_mask_from_logits at 2S,
    soft_erosion (jitted, as the session runs it).  The hard masks agree
    outside near ties; the soft masks of the images without a flipped
    pixel at 2e-4 (a flip moves the per-image renormalization)."""
    jm, v, port = tiny
    s = 64
    crops = (rng(14).random((2, s, s, 3)) * 255).astype(np.uint8)
    logits = jax.jit(jm.apply)(v, JP.preprocess(jnp.asarray(crops)))
    want_mask = np.asarray(JP.face_mask_from_logits(logits, (2 * s, 2 * s)))
    want = np.asarray(jax.jit(functools.partial(
        JA.soft_erosion, kernel_size=21, threshold=0.9,
        iterations=3))(jnp.asarray(want_mask))[0])
    parser = PP.FaceParser(PP.TINY, state_dict=port.state_dict(),
                           output_size=2 * s, device="cpu")
    got_logits = parser.logits(crops)
    assert_close(got_logits, logits)
    got_mask = PP.face_mask_from_logits(got_logits, (2 * s, 2 * s)).numpy()
    flipped = (got_mask != want_mask)[..., 0]
    assert not (flipped & ~_near_ties(np.asarray(logits), (2 * s, 2 * s))
                ).any()
    got = parser.parse_masks(crops).numpy()
    assert got.shape == (2, 2 * s, 2 * s, 1)
    assert got.min() >= 0.0 and got.max() <= 1.0
    clean = ~flipped.any(axis=(1, 2))
    assert clean.any()
    assert_close(got[clean], want[clean])


def test_face_parser_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.FaceParser(PP.TINY)


# ---- HF checkpoints ----------------------------------------------------------


def test_hf_state_dict_loads_strictly_and_matches_hf():
    """A HF SegformerForSemanticSegmentation's state_dict loads into the
    port unchanged and gives HF's logits (tests/test_parsing_parity.py's
    limits: HF's block norms take epsilon 1e-5 where the JAX package, and
    so the port, take 1e-6)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf_cfg = transformers.SegformerConfig(
        num_labels=19, depths=[1, 1, 1, 1], hidden_sizes=[16, 24, 40, 64],
        num_attention_heads=[1, 2, 5, 8], decoder_hidden_size=64,
        sr_ratios=[8, 4, 2, 1], drop_path_rate=0.0)
    hf = transformers.SegformerForSemanticSegmentation(hf_cfg).eval()
    port = PP.Segformer(PP.TINY).eval()
    port.load_state_dict(hf.state_dict(), strict=True)
    x = torch.rand(2, 3, 64, 64)
    with torch.no_grad():
        want = hf(pixel_values=x).logits
        got = port(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-4)
