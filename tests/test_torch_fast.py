"""The fast bundle in the port vs the JAX package, on the CPU, f32.

The fast bundle is the JAX session's ``dense_motion_scale=2, flag_int8``:
half-resolution dense motion, W8A8 convs in appearance, swap, refine and
SPADE, and the W8A8 warp.  Covered here: each int8 module at widths where
the gate fires, dense motion and the warping network at ``field_scale=2``,
the W8A8 warp inside ``WarpingNetwork.warp``, the whole ``swap_with_motion``
at ``fast_bundle(TINY)``, the weights round trip and the config mapping.

Bounds.  The module cases hold the port's 2e-4.  A W8A8 conv is exact given
the same input (tests/test_torch_qconv.py), but an input that differs by an
ulp between the two frameworks (a norm or conv upstream summed in another
order) can land on the other side of a rounding tie and flip one
activation quantum, which moves outputs by about sx * max|w| ~ 1e-3.  The
module cases are small enough that no quantum flips at their seeds; the
whole path is not, and has its own bound, stated there.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_tpu.configs import model_config as J
from canonswap_tpu.models.dense_motion import (
    DenseMotionNetwork as JaxDenseMotion)
from canonswap_tpu.models.warping import WarpingNetwork as JaxWarping
from canonswap_tpu.nn import blocks as JB
from canonswap_tpu.nn.conv3d import pack_hw2, unpack_hw2
from canonswap_tpu.ops.modulated_conv import (
    adaptive_blend_conv as jax_adaptive_blend_conv)
from canonswap_tpu.ops.pallas.warp import grid_sample_3d_onehot
from canonswap_tpu.runtime import core as JC
from canonswap_tpu.runtime import weights as JW
from canonswap_torch import configs as P
from canonswap_torch.models.dense_motion import DenseMotionNetwork
from canonswap_torch.models.warping import WarpingNetwork
from canonswap_torch.nn import blocks as B
from canonswap_torch.nn.init import init_random_
from canonswap_torch.ops.cuda.qconv import QCONV
from canonswap_torch.ops.cuda.warp import WARP3D, WARP3D_Q
from canonswap_torch.ops.modulated_conv import adaptive_blend_conv
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime.weights import from_jax
from tests.helpers.torch_parity import (
    assert_close, jax_variables, ncdhw_to_ndhwc, ndhwc_to_ncdhw, np_state_dict,
    rng, t)

rep = dataclasses.replace
FAST_TINY = P.fast_bundle(P.TINY)
# the JAX package's CPU fast configuration (bench.py's e2e_fast off the TPU:
# its W8A8 warp is a Pallas kernel, so the warp is the exact one)
JAX_FAST_TINY = rep(
    J.TINY,
    warping=rep(J.TINY.warping, dense_motion_scale=2),
    appearance=rep(J.TINY.appearance, int8_conv=True),
    swap=rep(J.TINY.swap, int8_conv=True),
    spade=rep(J.TINY.spade, int8_conv=True),
)


def _block_variables(module, convert, *args) -> dict:
    """A port block's weights as the JAX block's variables, through the JAX
    package's own block converter."""
    sd = {f"blk.{k}": v for k, v in np_state_dict(module).items()}
    tb = JW._TreeBuilder()
    convert(tb, "blk", sd, "blk", *args)
    return {k: v["blk"] for k, v in tb.variables().items()}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return t(ndhwc_to_ncdhw(x))


# --- int8 modules ----------------------------------------------------------


def test_adaptive_blend_conv_int8():
    g = rng(30)
    x = g.standard_normal((2, 8, 8, 128), dtype=np.float32)
    w = (g.standard_normal((3, 3, 128, 96)) / 34).astype(np.float32)
    style = g.standard_normal((2, 128), dtype=np.float32)
    mask = g.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    bias = g.standard_normal(96, dtype=np.float32) * 0.1
    want = jax.jit(lambda *a: jax_adaptive_blend_conv(*a, int8=True))(
        x, w, style, mask, bias)
    got = adaptive_blend_conv(_nchw(x), t(w.transpose(3, 2, 0, 1)), t(style),
                              _nchw(mask), t(bias), int8=True)
    assert_close(ncdhw_to_ndhwc(got), want)


def test_res_block_2d_int8():
    m = init_random_(B.ResBlock2d(128, int8=True), 31).eval()
    x = rng(32).standard_normal((2, 8, 8, 128), dtype=np.float32)
    want = jax.jit(JB.ResBlock2d(int8=True).apply)(
        _block_variables(m, JW._res_block), x)
    with torch.no_grad():
        got = m(_nchw(x))
    assert_close(ncdhw_to_ndhwc(got), want)


def test_res_block_3d_int8():
    """The JAX chains run the block pack_hw2-packed: the same W8A8 conv."""
    m = init_random_(B.ResBlock3d(32, int8=True), 33).eval()
    x = rng(34).standard_normal((2, 4, 8, 8, 32), dtype=np.float32)
    jm = JB.ResBlock3d(packed=True, int8=True)
    want = jax.jit(lambda v, a: unpack_hw2(jm.apply(v, pack_hw2(a))))(
        _block_variables(m, JW._res_block), x)
    with torch.no_grad():
        got = m(_nchw(x))
    assert_close(ncdhw_to_ndhwc(got), want)


def test_res_block_3d_leak_gn_int8():
    m = init_random_(B.ResBlock3dLeakGN(32, 32, int8=True), 35).eval()
    x = rng(36).standard_normal((2, 4, 8, 8, 32), dtype=np.float32)
    jm = JB.ResBlock3dLeakGN(32, packed=True, int8=True)
    want = jax.jit(lambda v, a: unpack_hw2(jm.apply(v, pack_hw2(a))))(
        _block_variables(m, JW._res_block_leak_gn), x)
    with torch.no_grad():
        got = m(_nchw(x))
    assert_close(ncdhw_to_ndhwc(got), want)


def test_spade_resnet_block_int8_learned_shortcut():
    """fin 128 -> fout 64: conv_0, conv_s and every SPADE's gamma|beta run
    W8A8 (inputs of 128 channels); conv_1 (64 channels) stays exact."""
    m = init_random_(B.SPADEResnetBlock(128, 64, 32, int8=True), 39).eval()
    g = rng(40)
    x = g.standard_normal((2, 8, 8, 128), dtype=np.float32)
    seg = g.standard_normal((2, 4, 4, 32), dtype=np.float32)
    want = jax.jit(JB.SPADEResnetBlock(128, 64, int8=True).apply)(
        _block_variables(m, JW._spade_resblock, True), x, seg)
    with torch.no_grad():
        got = m(_nchw(x), _nchw(seg))
    assert_close(ncdhw_to_ndhwc(got), want)


# --- half-resolution dense motion and the warp -----------------------------


def _kp(seed, b=2):
    g = rng(seed)
    k = P.TINY.warping.num_kp
    return (g.normal(0, 0.3, (b, k, 3)).astype(np.float32),
            g.normal(0, 0.3, (b, k, 3)).astype(np.float32))


def _volume(seed, hw=16):
    a = P.TINY.appearance
    return rng(seed).standard_normal((2, a.reshape_depth, hw, hw,
                                      a.reshape_channel), dtype=np.float32)


@pytest.fixture(scope="module")
def warping_half():
    m = init_random_(WarpingNetwork(rep(P.TINY.warping, dense_motion_scale=2)),
                     40).eval()
    return m, jax_variables(m, JW.convert_warping)


def test_dense_motion_half_resolution(warping_half):
    m, variables = warping_half
    vol = _volume(41)
    kp_d, kp_s = _kp(42)
    w = P.TINY.warping
    jm = JaxDenseMotion(J.TINY.warping.dense_motion, num_kp=w.num_kp,
                        field_scale=2)
    want = jax.jit(jm.apply)(
        {k: v["dense_motion_network"] for k, v in variables.items()},
        jnp.asarray(vol), jnp.asarray(kp_d), jnp.asarray(kp_s))
    with torch.no_grad():
        got = m.dense_motion_network(_nchw(vol), t(kp_d), t(kp_s))
    assert got["mask"].shape == (2, w.num_kp + 1, 8, 8, 8)
    assert_close(got["deformation"], want["deformation"])
    assert_close(got["mask"], np.moveaxis(np.asarray(want["mask"]), -1, 1))
    assert_close(ncdhw_to_ndhwc(got["occlusion_map"]), want["occlusion_map"])


def test_warp_half_resolution(warping_half):
    """``WarpingNetwork.warp`` at field_scale 2 with the exact warp (the
    JAX package's CPU warp)."""
    m, variables = warping_half
    vol = _volume(43)
    kp_d, kp_s = _kp(44)
    jm = JaxWarping(rep(J.TINY.warping, dense_motion_scale=2))
    warped_j, occ_j, _ = jax.jit(
        lambda v, *a: jm.apply(v, *a, method="warp"))(
        variables, jnp.asarray(vol), jnp.asarray(kp_d), jnp.asarray(kp_s))
    with torch.no_grad():
        warped, occ, _ = m.warp(_nchw(vol), t(kp_d), t(kp_s))
    assert_close(ncdhw_to_ndhwc(occ), occ_j)
    assert_close(ncdhw_to_ndhwc(warped), warped_j)


def test_field_scale_guard_raises():
    """The hourglass halves the plane num_blocks (2) times: a 4x4 field is
    too small, as in the JAX package."""
    m = WarpingNetwork(rep(P.TINY.warping, dense_motion_scale=2)).eval()
    kp_d, kp_s = _kp(45)
    with pytest.raises(ValueError, match="too small"):
        m.dense_motion_network(_nchw(_volume(46, hw=6)), t(kp_d), t(kp_s))


def test_w8a8_warp_after_jax_dense_motion():
    """JAX dense motion then the Pallas W8A8 warp (interpret mode) against
    the port's ``WarpingNetwork.warp`` with ``warp_quant``.  The two
    deformations differ by ulps (2e-4 above), and where one lands on a
    rounding tie of round(127 * t_y * t_x) a tap weight moves by 1/127: that
    output point moves by at most step * max|q| / 127 = max|vol| / 127 in
    every channel.  Bound: no point beyond that, and a relative norm error
    below 1e-4 (a handful of points of 16384)."""
    m = init_random_(WarpingNetwork(FAST_TINY.warping), 47).eval()
    variables = jax_variables(m, JW.convert_warping)
    vol = _volume(48)
    kp_d, kp_s = _kp(49)
    jm = JaxWarping(rep(J.TINY.warping, dense_motion_scale=2))
    _, _, dense_j = jax.jit(lambda v, *a: jm.apply(v, *a, method="warp"))(
        variables, jnp.asarray(vol), jnp.asarray(kp_d), jnp.asarray(kp_s))
    want = np.asarray(jax.jit(lambda v, g: grid_sample_3d_onehot(
        v, g, quant=True, interpret=True))(vol, dense_j["deformation"]))
    with torch.no_grad():
        got = ncdhw_to_ndhwc(m.warp(_nchw(vol), t(kp_d), t(kp_s))[0])
    err = np.abs(got - want)
    assert err.max() <= np.abs(vol).max() / 127 * 1.001
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


# --- the whole path --------------------------------------------------------


def _port_params(core):
    sd = np_state_dict(core)
    nets = {net: {k[len(net) + 1:]: v for k, v in sd.items()
                  if k.startswith(net + ".")} for net in JW._CONVERTERS}
    return JW.convert_combined_checkpoint(nets)


def test_swap_with_motion_fast_tiny():
    """``swap_with_motion`` at fast_bundle(TINY) with the exact warp against
    the JAX package's CPU fast configuration, B=2, from the same weights.

    The motion does not pass through int8 and holds 2e-4.  The images pass
    through 45 W8A8 convs, and the random weights amplify a flipped
    activation quantum (see the module docstring) from layer to layer, so
    the bound is on the error's mean: below 2 % of the image range, and
    below a fifth of the JAX package's own fast-vs-exact difference, which
    shows that the port computes the same quantized function, not the
    exact one."""
    cfg = rep(FAST_TINY, warping=rep(FAST_TINY.warping, warp_quant=False))
    core = C.CanonSwapCore(cfg, seed=50, device="cpu")
    params = _port_params(core)
    g = rng(51)
    frames = g.random((2, 64, 64, 3), dtype=np.float32)
    sid = g.standard_normal((1, P.TINY.swap.latent_dim), dtype=np.float32)
    sid /= np.linalg.norm(sid)
    out_j, motion_j = JC.swap_with_motion_jit(
        JC.CanonSwapCore(JAX_FAST_TINY), params, jnp.asarray(frames),
        jnp.asarray(sid))
    exact_j, _ = JC.swap_with_motion_jit(
        JC.CanonSwapCore(J.TINY), params, jnp.asarray(frames),
        jnp.asarray(sid))
    out, motion = C.swap_with_motion(core, t(frames), t(sid))
    for k in ("kp", "scale", "x_t"):
        assert_close(motion[k], motion_j[k])
    got, want = out["out"].numpy(), np.asarray(out_j["out"])
    assert got.shape == (2, 128, 128, 3) and np.isfinite(got).all()
    err = float(np.abs(got - want).mean())
    fast_vs_exact = float(np.abs(want - np.asarray(exact_j["out"])).mean())
    assert err <= 0.02 and err <= fast_vs_exact / 5, (err, fast_vs_exact)


def test_fast_tiny_launch_counts_on_cpu():
    """CPU tensors take the plain versions: no kernel launches."""
    core = C.CanonSwapCore(FAST_TINY, seed=52, device="cpu")
    g = rng(53)
    frames = t(g.random((1, 64, 64, 3), dtype=np.float32))
    sid = t(g.standard_normal((1, P.TINY.swap.latent_dim), dtype=np.float32))
    before = (QCONV.launches, WARP3D.launches, WARP3D_Q.launches)
    out, _ = C.swap_with_motion(core, frames, sid)
    assert (QCONV.launches, WARP3D.launches, WARP3D_Q.launches) == before
    assert torch.isfinite(out["out"]).all()


def test_from_jax_round_trip_fast_tiny():
    """The fast bundle keeps the parameter tree: the fast core's weights go
    to JAX and back exactly, and load into an exact core strictly."""
    core = C.CanonSwapCore(FAST_TINY, seed=54, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, _port_params(core))
    back = from_jax(params)
    want = core.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    exact = C.CanonSwapCore(P.TINY, seed=None, device="cpu")
    exact.load_state_dict(back, strict=True)


def _session_mapping(cfg: J.CanonSwapModelConfig) -> J.CanonSwapModelConfig:
    """What ``FaceSwapSession.__init__`` (pipelines/session.py) makes of a
    model config under InferenceConfig(dense_motion_scale=2,
    flag_int8=True) on a TPU, written out without building a session."""
    cfg = rep(cfg, warping=rep(cfg.warping, dense_motion_scale=2))
    cfg = rep(cfg, appearance=rep(cfg.appearance, int8_conv=True),
              swap=rep(cfg.swap, int8_conv=True),
              spade=rep(cfg.spade, int8_conv=True))
    return rep(cfg, warping=rep(cfg.warping, warp_impl="pallas_quant"))


@pytest.mark.parametrize("preset", ["CANONICAL", "TINY"])
def test_fast_bundle_is_the_session_mapping(preset):
    from canonswap_tpu.configs.pipeline_config import InferenceConfig

    fields = {f.name for f in dataclasses.fields(InferenceConfig)}
    assert {"dense_motion_scale", "flag_int8", "warp_impl"} <= fields
    port, ref = P.fast_bundle(getattr(P, preset)), _session_mapping(
        getattr(J, preset))
    assert port.warping.dense_motion_scale == ref.warping.dense_motion_scale
    assert port.warping.warp_quant == (ref.warping.warp_impl == "pallas_quant")
    for sub in ("appearance", "swap", "spade"):
        assert getattr(port, sub).int8_conv == getattr(ref, sub).int8_conv
    assert not ref.warping.dense_motion.int8_conv
    assert ref.spade.norm_scale == 1
