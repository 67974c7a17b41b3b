"""Per-network parity of the port vs the JAX package at TINY widths, f32:
dense motion, the warping network (``warp``, ``warp_out``, forward), the
swap module and the refine module.

The JAX WarpingNetwork runs ``warp_impl="packed"`` (TINY's default), the
same trilinear function as the port's warp, as the JAX tests run it on CPU.
Keypoints are N(0, 0.3^2), the range trained motion extractors emit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_tpu.configs.model_config import TINY as JTINY
from canonswap_tpu.models.refine import RefineModule as JaxRefine
from canonswap_tpu.models.swap import SwapModule as JaxSwap
from canonswap_tpu.models.warping import WarpingNetwork as JaxWarping
from canonswap_tpu.runtime import weights as JW
from canonswap_torch.configs import TINY
from canonswap_torch.models.refine import RefineModule
from canonswap_torch.models.swap import SwapModule
from canonswap_torch.models.warping import WarpingNetwork
from canonswap_torch.nn.init import init_random_
from tests.helpers.torch_parity import (
    assert_close, jax_variables, ncdhw_to_ndhwc, ndhwc_to_ncdhw, rng, t)

C = TINY.appearance.reshape_channel
D = TINY.appearance.reshape_depth


def _volume(seed, b=2, hw=16):
    return rng(seed).standard_normal((b, D, hw, hw, C), dtype=np.float32)


@pytest.fixture(scope="module")
def warping():
    m = init_random_(WarpingNetwork(TINY.warping), 21).eval()
    return m, jax_variables(m, JW.convert_warping)


def _kp(seed, b=2):
    g = rng(seed)
    k = TINY.warping.num_kp
    return (g.normal(0, 0.3, (b, k, 3)).astype(np.float32),
            g.normal(0, 0.3, (b, k, 3)).astype(np.float32))


def test_warp(warping):
    m, variables = warping
    vol = _volume(1)
    kp_d, kp_s = _kp(2)
    jm = JaxWarping(JTINY.warping)
    warped_j, occ_j, dense_j = jax.jit(
        lambda v, *a: jm.apply(v, *a, method="warp"))(
        variables, jnp.asarray(vol), jnp.asarray(kp_d), jnp.asarray(kp_s))
    with torch.no_grad():
        warped, occ, dense = m.warp(t(ndhwc_to_ncdhw(vol)), t(kp_d), t(kp_s))
    assert_close(dense["deformation"], dense_j["deformation"])
    assert_close(dense["mask"], np.moveaxis(np.asarray(dense_j["mask"]), -1, 1))
    assert_close(ncdhw_to_ndhwc(occ), occ_j)
    assert_close(ncdhw_to_ndhwc(warped), warped_j)


def test_warp_out(warping):
    m, variables = warping
    vol = _volume(3)
    occ = rng(4).uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    jm = JaxWarping(JTINY.warping)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, method="warp_out"))(
        variables, jnp.asarray(vol), jnp.asarray(occ))
    with torch.no_grad():
        got = m.warp_out(t(ndhwc_to_ncdhw(vol)), t(ndhwc_to_ncdhw(occ)))
    assert got.shape == (2, 64, 16, 16)
    assert_close(ncdhw_to_ndhwc(got), want)


def test_warping_forward(warping):
    m, variables = warping
    vol = _volume(5)
    kp_d, kp_s = _kp(6)
    want = jax.jit(JaxWarping(JTINY.warping).apply)(
        variables, jnp.asarray(vol), jnp.asarray(kp_d), jnp.asarray(kp_s))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(vol)), t(kp_d), t(kp_s))
    assert_close(ncdhw_to_ndhwc(got["out"]), want["out"])
    assert_close(got["deformation"], want["deformation"])


def test_swap_module():
    m = init_random_(SwapModule(TINY.swap, C, D), 22).eval()
    vol = _volume(7)
    lat = rng(8).standard_normal((2, TINY.swap.latent_dim), dtype=np.float32)
    lat /= np.linalg.norm(lat, axis=1, keepdims=True)
    want = jax.jit(JaxSwap(JTINY.swap).apply)(
        jax_variables(m, JW.convert_transfer), jnp.asarray(vol),
        jnp.asarray(lat))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(vol)), t(lat))
    assert_close(ncdhw_to_ndhwc(got), want)


def test_refine_module():
    m = init_random_(RefineModule(C, D), 23).eval()
    vol = _volume(9)
    want = jax.jit(JaxRefine(slab_channels=C).apply)(
        jax_variables(m, JW.convert_refine), jnp.asarray(vol))
    with torch.no_grad():
        got = m(t(ndhwc_to_ncdhw(vol)))
    assert_close(ncdhw_to_ndhwc(got), want)
