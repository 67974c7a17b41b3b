"""The port's main path, ``swap_with_motion``, vs the JAX package's at TINY,
B=2, f32: once from the port's seeded weights (converted for JAX), once from
JAX's own ``CanonSwapCore(TINY).init_params`` (converted for the port by
``from_jax``).  rtol = atol = 2e-4 on the [0, 1] images and the motion."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_tpu.configs.model_config import TINY as JTINY
from canonswap_tpu.runtime import core as JC
from canonswap_tpu.runtime import weights as JW
from canonswap_torch.configs import TINY
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime.weights import from_jax
from tests.helpers.torch_parity import assert_close, np_state_dict, rng, t

B = 2


def _inputs(seed):
    g = rng(seed)
    frames = g.random((B, TINY.input_size, TINY.input_size, 3),
                      dtype=np.float32)
    sid = g.standard_normal((1, TINY.swap.latent_dim), dtype=np.float32)
    return frames, sid / np.linalg.norm(sid)


def _jax_swap(params, frames, sid, as_uint8=False):
    out, motion = JC.swap_with_motion_jit(
        JC.CanonSwapCore(JTINY), params, jnp.asarray(frames), jnp.asarray(sid),
        as_uint8=as_uint8)
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in motion.items()})


def _compare(core, params, seed):
    frames, sid = _inputs(seed)
    out_j, motion_j = _jax_swap(params, frames, sid)
    out, motion = C.swap_with_motion(core, t(frames), t(sid))
    assert out["out"].shape == (B, TINY.output_size, TINY.output_size, 3)
    assert_close(out["out"], out_j["out"])
    for k in ("kp", "exp", "pitch", "yaw", "roll", "t", "scale", "x_t"):
        assert_close(motion[k], motion_j[k])


def _port_params(core):
    sd = np_state_dict(core)
    nets = {net: {k[len(net) + 1:]: v for k, v in sd.items()
                  if k.startswith(net + ".")} for net in JW._CONVERTERS}
    return JW.convert_combined_checkpoint(nets)


@pytest.fixture(scope="module")
def jax_init_params():
    """JAX's own random init (flax init executes the forward: jitted)."""
    return jax.jit(JC.CanonSwapCore(JTINY).init_params)(jax.random.PRNGKey(0))


def test_swap_with_motion_from_port_weights():
    core = C.CanonSwapCore(TINY, seed=3, device="cpu")
    _compare(core, _port_params(core), seed=1)


def test_swap_with_motion_from_jax_init(jax_init_params):
    core = C.CanonSwapCore(TINY, seed=None, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jax_init_params)
    core.load_state_dict(from_jax(params), strict=True)
    _compare(core, jax_init_params, seed=2)


def test_uint8_output_matches_jax():
    """Quantized on the device as the JAX package does: clip(255 v) then
    truncation; a value on a step boundary may land one step apart."""
    core = C.CanonSwapCore(TINY, seed=4, device="cpu")
    frames, sid = _inputs(5)
    out_j, _ = _jax_swap(_port_params(core), frames, sid, as_uint8=True)
    out, _ = C.swap_with_motion(core, t(frames), t(sid), as_uint8=True)
    got = out["out"].numpy()
    assert got.dtype == np.uint8 and got.shape == out_j["out"].shape
    assert np.abs(got.astype(int) - out_j["out"].astype(int)).max() <= 1


# bf16 against the JAX package: the port's bf16 run is held to this multiple
# of the JAX package's own bf16-vs-f32 drift on the same weights and inputs.
# Two bf16 evaluations of one function round at different places: PyTorch
# rounds every op's result to bf16, while XLA on the CPU keeps f32 between
# the ops it fuses (excess precision), and the two sum convolutions in
# another order.  Through TINY's random weights each network amplifies a
# rounding difference to the size of the whole bf16 drift, so the two bf16
# runs differ by about one drift (0.9 to 1.2 of it at seeds 6, 8 and 12).
# A cast in another place that changed the function, a stage left in f32 or
# run in bf16 on one side only, or a wrong weight, sits far outside that.
BF16_DRIFT_MULTIPLE = 2.0


def _bf16_tree(params):
    """The JAX session's half precision (``session.py:165-170``): every
    floating leaf cast to bf16."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, params)


def test_bf16_swap_with_motion_matches_jax():
    """``swap_with_motion`` in bf16, port vs the jitted JAX core on the same
    weights and inputs (bf16 params and frames, as the JAX session runs
    them): images (max and mean abs on [0, 1]) and keypoints within
    BF16_DRIFT_MULTIPLE of the JAX package's own bf16-vs-f32 drift."""
    core = C.CanonSwapCore(TINY, seed=6, device="cpu")
    params = _port_params(core)
    frames, sid = _inputs(7)
    out32, motion32 = _jax_swap(params, frames, sid)
    out16, motion16 = _jax_swap(_bf16_tree(params),
                                frames.astype(jnp.bfloat16), sid)
    out, motion = C.swap_with_motion(core.bfloat16(), t(frames).bfloat16(),
                                     t(sid))
    assert out["out"].dtype == torch.bfloat16
    got = out["out"].float().numpy()
    ref16 = np.asarray(out16["out"], np.float32)
    drift = np.abs(ref16 - np.asarray(out32["out"], np.float32))
    err = np.abs(got - ref16)
    assert np.isfinite(got).all() and got.shape == ref16.shape
    assert err.max() <= BF16_DRIFT_MULTIPLE * drift.max(), (err.max(),
                                                            drift.max())
    assert err.mean() <= BF16_DRIFT_MULTIPLE * drift.mean(), (err.mean(),
                                                              drift.mean())
    for k in ("kp", "x_t"):
        ref = np.asarray(motion16[k], np.float32)
        k_drift = np.abs(ref - motion32[k]).max()
        k_err = np.abs(motion[k].numpy() - ref).max()
        assert k_err <= BF16_DRIFT_MULTIPLE * k_drift, (k, k_err, k_drift)


def test_bf16_core_runs_with_f32_keypoints():
    core = C.CanonSwapCore(TINY, seed=6, device="cpu").bfloat16()
    frames, sid = _inputs(7)
    out, motion = C.swap_with_motion(core, t(frames).bfloat16(), t(sid))
    assert out["out"].dtype == torch.bfloat16
    assert torch.isfinite(out["out"].float()).all()
    assert all(v.dtype == torch.float32 for v in motion.values())
