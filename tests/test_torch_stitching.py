"""The port's stitching and retargeting against the JAX package, at TINY in
f32 on the CPU: the three nets, ``adjust_driving_kp`` under every
combination of its flags, ``swap_with_motion`` with stitching, and the
loaders of the reference's ``.pth`` and of the ``.npz`` that
``canonswap_tpu.cli.convert stitching`` writes.  rtol = atol = 2e-4.

The JAX nets' variables are ``init_stitching_params`` with every leaf
redrawn (``randomized``); the port takes them through
``stitching_from_jax``.  Keypoints and ratios are made with numpy from a
seed; the lip ratios' second column straddles ``normalize_lip``'s 0.03."""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.configs import CANONICAL, StitchingConfig, TINY
from canonswap_torch.models.stitching import CHECKPOINT_KEYS, StitchingModule
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime import weights as PW
from canonswap_tpu.configs.model_config import TINY as JTINY
from canonswap_tpu.runtime import checkpoint as JCK
from canonswap_tpu.runtime import core as JC
from canonswap_tpu.runtime import weights as JW
from tests.helpers.torch_parity import (assert_close, np_state_dict,
                                        one_torch_thread, randomized, rng, t)

K = TINY.motion.num_kp
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread(one_torch_thread):
    pass


@pytest.fixture(scope="module")
def jax_stitching():
    tree = JC.CanonSwapCore(JTINY).init_stitching_params(
        jax.random.PRNGKey(0))
    return randomized(jax.tree_util.tree_map(np.asarray, tree), 3)


@pytest.fixture(scope="module")
def port_stitching(jax_stitching):
    st = StitchingModule(K, TINY.stitching)
    st.load_state_dict(PW.stitching_from_jax(jax_stitching), strict=True)
    return st.eval().requires_grad_(False)


def _kp_and_ratios(seed=0):
    g = rng(seed)
    kp = (0.3 * g.standard_normal((B, K, 3))).astype(np.float32)
    kp_d = (0.3 * g.standard_normal((B, K, 3))).astype(np.float32)
    eye = g.uniform(0.0, 0.5, (B, 3)).astype(np.float32)
    lip = g.uniform(0.0, 0.5, (B, 2)).astype(np.float32)
    lip[:2, 1] = [0.01, 0.02]  # below the normalize_lip threshold
    return kp, kp_d, eye, lip


def test_sizes_follow_the_config_and_the_keypoints():
    """At 21 keypoints the nets have StitchingConfig's sizes (the
    reference's models.yaml); their Linears are mlp.{2i}."""
    st = StitchingModule(CANONICAL.motion.num_kp, CANONICAL.stitching)
    cfg = StitchingConfig()
    for net, (n_in, hidden, n_out) in (("stitching", cfg.stitching),
                                       ("eye", cfg.eye), ("lip", cfg.lip)):
        linears = [m for m in getattr(st, net).mlp
                   if isinstance(m, torch.nn.Linear)]
        sizes = [linears[0].in_features] + [m.out_features for m in linears]
        assert sizes == [n_in, *hidden, n_out]
    assert "eye.mlp.10.weight" in st.state_dict()


def test_nets_match_jax(jax_stitching, port_stitching):
    kp, kp_d, eye, lip = _kp_and_ratios()
    jm = JC.CanonSwapCore(JTINY).stitching
    for method, args in (("stitch", (kp, kp_d)), ("retarget_eye", (kp, eye)),
                         ("retarget_lip", (kp, lip))):
        want = jm.apply(jax_stitching, *map(jnp.asarray, args),
                        method=method)
        got = getattr(port_stitching, method)(*map(t, args))
        assert got.shape == (B, K, 3)
        assert_close(got, np.asarray(want))


FLAGS = list(itertools.product([False, True], repeat=4))


@pytest.mark.parametrize("use_eye,use_lip,use_stitching,normalize_lip", FLAGS)
def test_adjust_driving_kp_matches_jax(jax_stitching, port_stitching, use_eye,
                                       use_lip, use_stitching, normalize_lip):
    x_t, _, eye, lip = _kp_and_ratios(1)
    kw = dict(use_stitching=use_stitching, normalize_lip=normalize_lip)
    want = JC.adjust_driving_kp_jit(
        JC.CanonSwapCore(JTINY), jax_stitching, jnp.asarray(x_t),
        jnp.asarray(eye) if use_eye else None,
        jnp.asarray(lip) if use_lip else None, **kw)
    got = C.adjust_driving_kp(port_stitching, t(x_t),
                              t(eye) if use_eye else None,
                              t(lip) if use_lip else None, **kw)
    assert_close(got, np.asarray(want))
    if not (use_eye or use_lip or use_stitching):
        assert torch.equal(got, t(x_t))


def test_swap_with_motion_with_stitching_matches_jax(jax_stitching,
                                                     port_stitching):
    """The images at the adjusted keypoints; the motion returned is the
    extracted one, and adjusting its x_t gives the JAX motion's (the JAX
    core returns the adjusted x_t)."""
    core = C.CanonSwapCore(TINY, seed=5, device="cpu")
    sd = np_state_dict(core)
    params = JW.convert_combined_checkpoint(
        {net: {k[len(net) + 1:]: v for k, v in sd.items()
               if k.startswith(net + ".")} for net in JW._CONVERTERS})
    g = rng(6)
    frames = g.random((B, TINY.input_size, TINY.input_size, 3),
                      dtype=np.float32)
    sid = g.standard_normal((1, TINY.swap.latent_dim), dtype=np.float32)
    sid /= np.linalg.norm(sid)
    _, _, eye, lip = _kp_and_ratios(7)
    kw = dict(use_stitching=True, normalize_lip=True)
    out_j, motion_j = JC.swap_with_motion_jit(
        JC.CanonSwapCore(JTINY), params, jnp.asarray(frames),
        jnp.asarray(sid), stitching_params=jax_stitching,
        eye_ratio=jnp.asarray(eye), lip_ratio=jnp.asarray(lip), **kw)
    out, motion = C.swap_with_motion(core, t(frames), t(sid),
                                     stitching=port_stitching,
                                     eye_ratio=t(eye), lip_ratio=t(lip), **kw)
    assert_close(out["out"], np.asarray(out_j["out"]))
    for k in ("kp", "exp", "t", "scale"):
        assert_close(motion[k], np.asarray(motion_j[k]))
    assert_close(C.adjust_driving_kp(port_stitching, motion["x_t"], t(eye),
                                     t(lip), **kw),
                 np.asarray(motion_j["x_t"]))
    # without stitching the images differ: the adjustment took effect
    plain, _ = C.swap_with_motion(core, t(frames), t(sid))
    assert float((plain["out"] - out["out"]).abs().max()) > 1e-3


def _reference_checkpoint(seed=8) -> dict:
    """A state_dict per net under the reference's keys (one behind a DDP
    ``module.`` prefix), from a seeded port module."""
    st = StitchingModule(K, TINY.stitching)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in st.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    sd = st.state_dict()
    ckpt = {theirs: {k[len(net) + 1:]: v for k, v in sd.items()
                     if k.startswith(net + ".")}
            for net, theirs in CHECKPOINT_KEYS.items()}
    ckpt["retarget_eye"] = {f"module.{k}": v
                            for k, v in ckpt["retarget_eye"].items()}
    return sd, ckpt


def test_pth_loader_reads_the_reference_checkpoint(tmp_path):
    """torch alone, strict keys; the same weights as the JAX converter's."""
    sd, ckpt = _reference_checkpoint()
    torch.save(ckpt, tmp_path / "stitching.pth")
    got = PW.load_stitching_checkpoint(tmp_path / "stitching.pth")
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    via_jax = PW.stitching_from_jax(JW.convert_stitching_checkpoint(
        {k: {kk: vv.numpy() for kk, vv in v.items()}
         for k, v in ckpt.items()}))
    for k, v in sd.items():
        assert torch.equal(via_jax[k], v), k


def test_npz_loader_reads_the_jax_converters_file(tmp_path):
    """The file ``python -m canonswap_tpu.cli.convert stitching`` writes:
    the converted tree through the JAX package's save_npz."""
    sd, ckpt = _reference_checkpoint(9)
    JCK.save_npz(str(tmp_path / "s.npz"), JW.convert_stitching_checkpoint(
        {k: {kk: vv.numpy() for kk, vv in v.items()}
         for k, v in ckpt.items()}))
    got = PW.load_stitching_checkpoint(str(tmp_path / "s.npz"))
    st = StitchingModule(K, TINY.stitching)
    st.load_state_dict(got, strict=True)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
