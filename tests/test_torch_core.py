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
    core = C.CanonSwapCore(TINY, seed=3)
    _compare(core, _port_params(core), seed=1)


def test_swap_with_motion_from_jax_init(jax_init_params):
    core = C.CanonSwapCore(TINY, seed=None)
    params = jax.tree_util.tree_map(np.asarray, jax_init_params)
    core.load_state_dict(from_jax(params), strict=True)
    _compare(core, jax_init_params, seed=2)


def test_uint8_output_matches_jax():
    """Quantized on the device as the JAX package does: clip(255 v) then
    truncation; a value on a step boundary may land one step apart."""
    core = C.CanonSwapCore(TINY, seed=4)
    frames, sid = _inputs(5)
    out_j, _ = _jax_swap(_port_params(core), frames, sid, as_uint8=True)
    out, _ = C.swap_with_motion(core, t(frames), t(sid), as_uint8=True)
    got = out["out"].numpy()
    assert got.dtype == np.uint8 and got.shape == out_j["out"].shape
    assert np.abs(got.astype(int) - out_j["out"].astype(int)).max() <= 1


def test_bf16_core_runs_with_f32_keypoints():
    core = C.CanonSwapCore(TINY, seed=6).bfloat16()
    frames, sid = _inputs(7)
    out, motion = C.swap_with_motion(core, t(frames).bfloat16(), t(sid))
    assert out["out"].dtype == torch.bfloat16
    assert torch.isfinite(out["out"].float()).all()
    assert all(v.dtype == torch.float32 for v in motion.values())
