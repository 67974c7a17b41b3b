"""The port's ops and blocks vs the JAX package, at small shapes in f32.

Layouts differ (the port is NCDHW, the JAX package channels-last), so each
test moves the channel axis before comparing."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_tpu.nn import blocks as JB
from canonswap_tpu.ops import heatmap as JH
from canonswap_tpu.ops import pose as JP
from canonswap_tpu.ops import resize as JR
from canonswap_tpu.ops.grid_sample import _axis_resample_matrix
from canonswap_tpu.ops.modulated_conv import (
    adaptive_blend_conv as jax_adaptive_blend_conv)
from canonswap_tpu.runtime import weights as JW
from canonswap_torch.models.dense_motion import build_hourglass_input
from canonswap_torch.nn import blocks as B
from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops import heatmap as H
from canonswap_torch.ops import modulated_conv as MC
from canonswap_torch.ops import pose as P
from canonswap_torch.ops import resize as R
from canonswap_torch.ops.grid_sample import axis_resample_matrix
from tests.helpers.torch_parity import (
    assert_close, ncdhw_to_ndhwc, ndhwc_to_ncdhw, np_state_dict, rng, t)


def test_volume_to_2d_and_back():
    x = rng(0).standard_normal((2, 4, 3, 5, 6), dtype=np.float32)  # B,D,H,W,C
    want = np.asarray(JR.volume_to_2d(jnp.asarray(x)))  # (B, H, W, C*D)
    vol = t(ndhwc_to_ncdhw(x))
    flat = R.volume_to_2d(vol)
    assert_close(ncdhw_to_ndhwc(flat), want, rtol=0, atol=0)
    torch.testing.assert_close(R.volume_from_2d(flat, 4), vol, rtol=0, atol=0)


@pytest.mark.parametrize("factors", [(2, 2), (1, 2, 2)])
def test_nearest_upsample_and_avg_pool(factors):
    shape = (2, 3, 4, 5) if len(factors) == 2 else (2, 3, 4, 5, 6)
    x = rng(1).standard_normal(shape, dtype=np.float32)  # channels-last
    up = R.nearest_upsample(t(ndhwc_to_ncdhw(x)), factors)
    assert_close(ncdhw_to_ndhwc(up),
                 JR.nearest_upsample(jnp.asarray(x), factors), rtol=0, atol=0)
    y = rng(2).standard_normal(
        (2, *(4 * f for f in factors), 3), dtype=np.float32)
    pooled = R.avg_pool(t(ndhwc_to_ncdhw(y)), factors)
    assert_close(ncdhw_to_ndhwc(pooled), JR.avg_pool(jnp.asarray(y), factors),
                 rtol=1e-6, atol=1e-6)


def test_pixel_shuffle_matches_jax():
    """The decoder's head is torch's nn.PixelShuffle: same channel order as
    the JAX package's pixel_shuffle."""
    x = rng(3).standard_normal((2, 5, 6, 12), dtype=np.float32)  # NHWC
    got = torch.nn.PixelShuffle(2)(t(ndhwc_to_ncdhw(x)))
    assert_close(ncdhw_to_ndhwc(got), JR.pixel_shuffle(jnp.asarray(x), 2),
                 rtol=0, atol=0)


def test_coordinate_grid_and_kp2gaussian():
    assert_close(H.make_coordinate_grid_3d((3, 5, 7)),
                 JH.make_coordinate_grid_3d((3, 5, 7)), rtol=0, atol=1e-7)
    kp = rng(4).normal(0, 0.4, (2, 3, 3)).astype(np.float32)
    assert_close(H.kp2gaussian(t(kp), (4, 6, 5), 0.01),
                 JH.kp2gaussian(jnp.asarray(kp), (4, 6, 5), 0.01),
                 rtol=1e-5, atol=1e-6)


def test_pose_math():
    g = rng(5)
    bins = g.standard_normal((3, 66), dtype=np.float32)
    assert_close(P.headpose_to_degree(t(bins)),
                 JP.headpose_to_degree(jnp.asarray(bins)), rtol=1e-5, atol=1e-4)
    pitch, yaw, roll = (g.uniform(-60, 60, (3, 1)).astype(np.float32)
                        for _ in range(3))
    assert_close(P.rotation_matrix(t(pitch), t(yaw), t(roll)),
                 JP.rotation_matrix(*map(jnp.asarray, (pitch, yaw, roll))),
                 rtol=1e-5, atol=1e-6)
    kp = g.normal(0, 0.3, (3, 5, 3)).astype(np.float32)
    exp = g.normal(0, 0.05, (3, 5, 3)).astype(np.float32)
    tr = g.normal(0, 0.1, (3, 3)).astype(np.float32)
    scale = g.uniform(0.8, 1.2, (3, 1)).astype(np.float32)
    args = (kp, pitch[:, 0], yaw[:, 0], roll[:, 0], tr, exp, scale)
    assert_close(P.transform_keypoint(*map(t, args)),
                 JP.transform_keypoint(*map(jnp.asarray, args)),
                 rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cin,cout", [(6, 7), (12, 12)])
def test_adaptive_blend_conv(cin, cout):
    g = rng(6)
    x = g.standard_normal((2, 9, 10, cin), dtype=np.float32)  # NHWC
    w = (g.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)  # HWIO
    style = g.standard_normal((2, cin), dtype=np.float32)
    mask = g.uniform(0, 1, (2, 9, 10, 1)).astype(np.float32)
    bias = g.standard_normal(cout).astype(np.float32)
    want = jax_adaptive_blend_conv(*map(jnp.asarray, (x, w, style, mask, bias)))
    got = MC.adaptive_blend_conv(
        t(ndhwc_to_ncdhw(x)), t(w.transpose(3, 2, 0, 1)), t(style),
        t(ndhwc_to_ncdhw(mask)), t(bias))
    assert_close(ncdhw_to_ndhwc(got), want)


def test_axis_resample_matrix():
    shift = np.array([0.0, 0.37, -1.3, 2.5], np.float32)
    got = axis_resample_matrix(8, t(shift))
    want = jax.vmap(lambda s: _axis_resample_matrix(8, s, jnp.float32))(
        jnp.asarray(shift))
    assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_build_hourglass_input():
    from canonswap_tpu.models.dense_motion import (
        build_hourglass_input as jax_build)

    g = rng(7)
    feat = g.standard_normal((2, 4, 6, 8, 3), dtype=np.float32)  # B,D,H,W,Cc
    kp_d = g.normal(0, 0.3, (2, 5, 3)).astype(np.float32)
    kp_s = g.normal(0, 0.3, (2, 5, 3)).astype(np.float32)
    want = jax_build(jnp.asarray(feat), jnp.asarray(kp_d), jnp.asarray(kp_s))
    got = build_hourglass_input(t(ndhwc_to_ncdhw(feat)), t(kp_d), t(kp_s))
    assert got.shape == (2, 6 * 4, 4, 6, 8)
    assert_close(ncdhw_to_ndhwc(got), want, rtol=1e-5, atol=1e-5)


def test_instance_norm():
    x = rng(8).normal(1.0, 2.0, (2, 6, 7, 5)).astype(np.float32)
    assert_close(ncdhw_to_ndhwc(B.instance_norm(t(ndhwc_to_ncdhw(x)))),
                 JB.instance_norm(jnp.asarray(x)), rtol=1e-5, atol=1e-5)


def _tree(fn, sd, **kw):
    tb = JW._TreeBuilder()
    fn(tb, "blk", sd, "", **kw)
    v = tb.variables()
    return {k: tree["blk"] for k, tree in v.items()}


def _strip(sd):
    """Keys of a module's own state_dict, with a leading '.' for the
    converters' '{tkey}.name' formatting under an empty tkey."""
    return {f".{k}": v for k, v in sd.items()}


def test_res_block_3d_leak_gn_with_shortcut():
    m = init_random_(B.ResBlock3dLeakGN(4, 8), 1).eval()
    x = rng(9).standard_normal((2, 3, 6, 5, 4), dtype=np.float32)
    variables = _tree(JW._res_block_leak_gn, _strip(np_state_dict(m)))
    want = JB.ResBlock3dLeakGN(8).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(x)))
    assert_close(ncdhw_to_ndhwc(got), want)


def test_hourglass():
    m = init_random_(B.Hourglass(4, 5, 2, 16), 2).eval()
    x = rng(10).standard_normal((2, 3, 8, 8, 5), dtype=np.float32)
    variables = _tree(JW._hourglass, _strip(np_state_dict(m)), num_blocks=2)
    want = JB.Hourglass(4, 5, 2, 16).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(x)))
    assert got.shape == (2, 4 + 5, 3, 8, 8)
    assert_close(ncdhw_to_ndhwc(got), want)


def test_spade_resnet_block_learned_shortcut():
    m = init_random_(B.SPADEResnetBlock(8, 4, 6), 3).eval()
    g = rng(11)
    x = g.standard_normal((2, 8, 8, 8), dtype=np.float32)
    seg = g.standard_normal((2, 4, 4, 6), dtype=np.float32)
    variables = _tree(JW._spade_resblock, _strip(np_state_dict(m)),
                      learned_shortcut=True)
    want = JB.SPADEResnetBlock(8, 4).apply(variables, jnp.asarray(x),
                                           jnp.asarray(seg))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(x)), t(ndhwc_to_ncdhw(seg)))
    assert_close(ncdhw_to_ndhwc(got), want)
