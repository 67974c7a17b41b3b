"""Per-network parity of the port vs the JAX package at TINY widths, f32:
motion extractor (+ refine_kp_info), appearance encoder, SPADE decoder.

Both sides run the port's seeded random weights, the JAX side through
``canonswap_tpu.runtime.weights.convert_*``, at rtol = atol = 2e-4."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from canonswap_tpu.configs.model_config import TINY as JTINY
from canonswap_tpu.models.appearance import (
    AppearanceFeatureExtractor as JaxAppearance)
from canonswap_tpu.models.motion import MotionExtractor as JaxMotion
from canonswap_tpu.models.motion import refine_kp_info as jax_refine_kp_info
from canonswap_tpu.models.spade_decoder import SPADEDecoder as JaxSpade
from canonswap_tpu.runtime import weights as JW
from canonswap_torch.configs import TINY
from canonswap_torch.models.appearance import AppearanceFeatureExtractor
from canonswap_torch.models.motion import MotionExtractor, refine_kp_info
from canonswap_torch.models.spade_decoder import SPADEDecoder
from canonswap_torch.nn.init import init_random_
from tests.helpers.torch_parity import (
    assert_close, jax_variables, ncdhw_to_ndhwc, ndhwc_to_ncdhw, rng, t)


def _frames(seed=0, b=2):
    return rng(seed).random((b, TINY.input_size, TINY.input_size, 3),
                            dtype=np.float32)


def test_motion_extractor_and_refine_kp_info():
    m = init_random_(MotionExtractor(TINY.motion), 11).eval()
    frames = _frames(1)
    raw_jax = jax.jit(JaxMotion(JTINY.motion).apply)(
        jax_variables(m, JW.convert_motion), jnp.asarray(frames))
    with torch.no_grad():
        raw = m(t(ndhwc_to_ncdhw(frames)))
    assert set(raw) == set(raw_jax)
    for k in raw:
        assert_close(raw[k], raw_jax[k])
    info, info_jax = refine_kp_info(raw), jax_refine_kp_info(raw_jax)
    for k in ("kp", "exp", "pitch", "yaw", "roll", "t", "scale"):
        assert info[k].dtype == torch.float32
        assert tuple(info[k].shape) == info_jax[k].shape
        assert_close(info[k], info_jax[k])


def test_motion_extractor_bf16_keeps_keypoints_f32():
    m = init_random_(MotionExtractor(TINY.motion), 11).eval().bfloat16()
    with torch.no_grad():
        info = refine_kp_info(m(t(ndhwc_to_ncdhw(_frames(1))).bfloat16()))
    assert all(v.dtype == torch.float32 for v in info.values())
    assert info["kp"].shape == (2, TINY.motion.num_kp, 3)


def test_appearance_encoder():
    m = init_random_(AppearanceFeatureExtractor(TINY.appearance), 12).eval()
    frames = _frames(2)
    want = jax.jit(JaxAppearance(JTINY.appearance).apply)(
        jax_variables(m, JW.convert_appearance), jnp.asarray(frames))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(frames)))
    a = TINY.appearance
    assert got.shape == (2, a.reshape_channel, a.reshape_depth, 16, 16)
    assert_close(ncdhw_to_ndhwc(got), want)


def test_spade_decoder():
    m = init_random_(SPADEDecoder(TINY.spade), 13).eval()
    feat = rng(3).standard_normal((2, 16, 16, 64), dtype=np.float32)
    want = jax.jit(JaxSpade(JTINY.spade).apply)(
        jax_variables(m, JW.convert_spade), jnp.asarray(feat))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(feat)))
    assert got.shape == (2, 3, 128, 128)  # 2x, 2x, then pixel shuffle 2x
    assert_close(ncdhw_to_ndhwc(got), want)
