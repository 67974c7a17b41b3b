"""The core's remaining strips and the downsampling resize vs the JAX
package, on the CPU.

``swap_step(with_debug=True)`` (``out``, and the canonical ``rec_can`` and
``swap_can`` decoded before refine), ``conv_decode`` (with and without the
occlusion map) and ``reanimate_step`` against the jitted JAX functions at
TINY, f32, B=2, on the port's seeded weights converted for JAX: rtol =
atol = 2e-4 (the same f32 sums in another order).  ``bilinear_resize`` at
512 -> 256, the v2i downsample, against ``jax.image.resize`` at 1e-6."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.configs import TINY
from canonswap_torch.ops.pose import rotation_matrix
from canonswap_torch.ops.resize import bilinear_resize
from canonswap_torch.runtime import core as C
from canonswap_tpu.configs.model_config import TINY as JTINY
from canonswap_tpu.ops.resize import bilinear_resize as jax_bilinear_resize
from canonswap_tpu.runtime import core as JC
from canonswap_tpu.runtime import weights as JW
from tests.helpers.torch_parity import (assert_close, ndhwc_to_ncdhw,
                                        np_state_dict, rng, t)

B = 2
JCORE = JC.CanonSwapCore(JTINY)


@pytest.fixture(scope="module")
def nets():
    core = C.CanonSwapCore(TINY, seed=11, device="cpu")
    sd = np_state_dict(core)
    params = JW.convert_combined_checkpoint({
        net: {k[len(net) + 1:]: v for k, v in sd.items()
              if k.startswith(net + ".")} for net in JW._CONVERTERS})
    return core, params


def _inputs(seed):
    g = rng(seed)
    frames = g.random((B, TINY.input_size, TINY.input_size, 3),
                      dtype=np.float32)
    sid = g.standard_normal((1, TINY.swap.latent_dim), dtype=np.float32)
    return frames, sid / np.linalg.norm(sid)


def _volume(seed, b=B):
    a = TINY.appearance
    hw = TINY.input_size // 2**a.num_down_blocks
    return rng(seed).standard_normal(
        (b, a.reshape_depth, hw, hw, a.reshape_channel), dtype=np.float32)


def test_swap_step_with_debug_matches_jax(nets):
    core, params = nets
    frames, sid = _inputs(1)
    motion_j = jax.jit(JC.extract_motion, static_argnums=0)(
        JCORE, params, jnp.asarray(frames))
    want = JC.swap_step_jit(JCORE, params, jnp.asarray(frames),
                            jnp.asarray(sid), motion_j, with_debug=True)
    motion = {k: t(np.asarray(v)) for k, v in motion_j.items()}
    with torch.inference_mode():
        got = C.swap_step(core, t(frames), t(sid), motion, with_debug=True)
        plain = C.swap_step(core, t(frames), t(sid), motion)
    assert sorted(got) == sorted(want) == ["out", "rec_can", "swap_can"]
    side = TINY.output_size
    for k in got:
        assert got[k].shape == (B, side, side, 3)
        assert_close(got[k], np.asarray(want[k]))
    assert list(plain) == ["out"] and torch.equal(plain["out"], got["out"])


def test_swap_with_motion_with_debug_as_uint8_matches_jax(nets):
    """The fused entry point with both options: every strip quantized on
    the device as the JAX package does (clip(255 v), truncated); a value
    within 2e-4 of a step may land one grey level apart."""
    core, params = nets
    frames, sid = _inputs(2)
    want, _ = JC.swap_with_motion_jit(JCORE, params, jnp.asarray(frames),
                                      jnp.asarray(sid), with_debug=True,
                                      as_uint8=True)
    got, _ = C.swap_with_motion(core, t(frames), t(sid), with_debug=True,
                                as_uint8=True)
    for k in ("out", "rec_can", "swap_can"):
        assert got[k].dtype == torch.uint8
        diff = np.abs(got[k].numpy().astype(int)
                      - np.asarray(want[k]).astype(int))
        assert diff.max() <= 1, k


@pytest.mark.parametrize("with_occlusion", [True, False])
def test_conv_decode_matches_jax(nets, with_occlusion):
    core, params = nets
    vol = _volume(3)
    hw = vol.shape[2]
    occ = rng(4).random((B, hw, hw, 1), dtype=np.float32)
    want = JC.conv_decode_jit(JCORE, params, jnp.asarray(vol),
                              jnp.asarray(occ) if with_occlusion else None)
    occ_t = t(np.ascontiguousarray(np.moveaxis(occ, -1, 1)))
    with torch.inference_mode():
        got = C.conv_decode(core, t(ndhwc_to_ncdhw(vol)),
                            occ_t if with_occlusion else None)
    assert got.shape == (B, TINY.output_size, TINY.output_size, 3)
    assert_close(got, np.asarray(want))


def test_reanimate_step_matches_jax(nets):
    """One swapped canonical volume (1, ...) re-animated by B driving
    expressions; the pose from random angles through rotation_matrix."""
    core, params = nets
    g = rng(5)
    k = TINY.motion.num_kp
    vol = _volume(6, b=1)
    x_swap = (0.3 * g.standard_normal((1, k, 3))).astype(np.float32)
    kp_swap = (0.3 * g.standard_normal((1, k, 3))).astype(np.float32)
    angles = [(20 * g.standard_normal((1, 1))).astype(np.float32)
              for _ in range(3)]
    rot = rotation_matrix(*(t(a) for a in angles)).numpy()
    t_swap = (0.1 * g.standard_normal((1, 3))).astype(np.float32)
    t_swap[:, 2] = 0.0
    scale = (1 + 0.1 * g.standard_normal((1, 1))).astype(np.float32)
    delta = (0.05 * g.standard_normal((B + 1, k, 3))).astype(np.float32)
    want = JC.reanimate_step_jit(JCORE, params, *map(jnp.asarray, (
        vol, x_swap, kp_swap, rot, t_swap, scale, delta)))
    with torch.inference_mode():
        got = C.reanimate_step(core, t(ndhwc_to_ncdhw(vol)), t(x_swap),
                               t(kp_swap), t(rot), t(t_swap), t(scale),
                               t(delta))
    assert got.shape == (B + 1, TINY.output_size, TINY.output_size, 3)
    assert_close(got, np.asarray(want))


def test_warp_out_without_occlusion_is_the_unmasked_decoder_input(nets):
    core, _ = nets
    vol = t(ndhwc_to_ncdhw(_volume(7)))
    hw = vol.shape[-1]
    occ = torch.full((B, 1, hw, hw), 0.5)
    with torch.inference_mode():
        full = core.warping_module.warp_out(vol)
        half = core.warping_module.warp_out(vol, occ)
    assert torch.allclose(half, 0.5 * full)


@pytest.mark.parametrize("shape,size", [((1, 3, 512, 512), (256, 256)),
                                        ((2, 4, 64, 48), (20, 30)),
                                        ((1, 3, 33, 17), (8, 17))],
                         ids=["v2i_512_256", "fractional", "one_side"])
def test_bilinear_resize_downsample_matches_jax(shape, size):
    """A downsample antialiases as ``jax.image.resize(method="linear")``
    does; f32 in, f32 out, within 1e-6."""
    x = rng(8).random(shape, dtype=np.float32)
    want = jax_bilinear_resize(jnp.asarray(np.moveaxis(x, 1, -1)), size)
    got = bilinear_resize(t(x), size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_bilinear_resize_downsample_keeps_bf16():
    """bf16 in: computed in f32 and rounded once to bf16, as XLA sums the
    scaled weights in f32; the f32 result rounded to bf16 exactly."""
    x = t(rng(9).random((1, 3, 64, 64), dtype=np.float32)).bfloat16()
    got = bilinear_resize(x, (32, 32))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, bilinear_resize(x.float(), (32, 32)).bfloat16())
