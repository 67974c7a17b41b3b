"""The port's configs, CLI parser and FaceSwapSession vs the JAX package's,
on the CPU.

``ArgumentConfig`` and ``InferenceConfig`` equal the JAX dataclasses field
for field (names, order, types, defaults), and the two CLI parsers give
the same namespace for every mode.  A JAX session at TINY (fast_init, its
trees redrawn) is carried into a port session by ``session_from_jax``
(``tests/helpers/torch_sessions.py``); then ``get_source_id`` (on the JAX
session's ID crop), ``prepare_frames``, ``parse_masks``, ``motion_template``,
``swap_with_motion(with_debug=True)`` and ``swap_batch`` agree at rtol =
atol = 2e-4, f32."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch import configs as PC
from canonswap_torch.cli import main as PCLI
from canonswap_torch.pipelines import session as PS
from canonswap_tpu.cli import main as JCLI
from canonswap_tpu.configs import pipeline_config as JPC
from canonswap_tpu.runtime import checkpoint as JCK
from tests.helpers.torch_parity import assert_close, rng, t
from tests.helpers.torch_sessions import build_pair, force_id_crop

B = 2


@pytest.fixture(scope="module")
def pair():
    return build_pair(batch_size=B)


# ---- configs and the CLI ----------------------------------------------------


@pytest.mark.parametrize("name", ["ArgumentConfig", "InferenceConfig",
                                  "CropConfig"])
def test_configs_equal_jax_field_for_field(name):
    def fields(cls):
        return [(f.name, str(f.type), f.default,
                 f.default_factory if f.default_factory
                 is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]

    assert fields(getattr(PC, name)) == fields(getattr(JPC, name))
    kw = {"batch_size": 4, "scale": 2.0, "det_thresh": 0.3, "crf": 20,
          "not_a_field": 1}
    assert dataclasses.asdict(PC.partial_fields(getattr(PC, name), kw)) == \
        dataclasses.asdict(JPC.partial_fields(getattr(JPC, name), kw))


@pytest.mark.parametrize("mode", ["swap", "v2i", "multi", "stream"])
def test_cli_parsers_agree(mode):
    argvs = [
        [mode, "-s", "a.ppm", "-t", "b.npy"],
        [mode, "--source", "a.png", "--driving", "b.mp4", "-o", "out",
         "--batch-size", "4", "--flag-int8", "true", "--dense-motion-scale",
         "2", "--checkpoint", "w.pth", "--flag-pasteback", "no",
         "--det-thresh", "0.2", "--fast-init", "1"],
    ]
    for argv in argvs:
        got = vars(PCLI.build_parser().parse_args(argv))
        want = vars(JCLI.build_parser().parse_args(argv))
        assert got == want
    with pytest.raises(SystemExit):
        PCLI.build_parser().parse_args(["nope", "-s", "a", "-t", "b"])


def test_cli_checks_the_paths_first(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.ppm"):
        PCLI.main(["swap", "-s", str(tmp_path / "nope.ppm"), "-t", "x.npy"])
    src = tmp_path / "s.ppm"
    src.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(FileNotFoundError, match="gone.npy"):
        PCLI.main(["v2i", "-s", str(src), "-t", str(tmp_path / "gone.npy")])


# ---- the session's flags ----------------------------------------------------


def _session(seed=0, fast_init=True, **inference):
    return PS.FaceSwapSession(PC.InferenceConfig(**inference),
                              model_cfg=PC.TINY, det_size=(64, 64),
                              arcface_layers=(1, 1, 1, 1),
                              parsing_cfg=PS.P.SegformerConfig(
                                  hidden_sizes=(8, 12, 20, 32),
                                  depths=(1, 1, 1, 1),
                                  num_heads=(1, 2, 5, 8), decoder_hidden=32),
                              landmark_widths=(8, 12, 16, 24),
                              landmark_trunk="residual", fast_init=fast_init,
                              seed=seed, device="cpu")


@pytest.mark.parametrize("flags,error,match", [
    ({"flag_relative_motion": True}, ValueError, "flag_relative_motion"),
    ({"flag_stitching": True}, NotImplementedError, "A 6"),
    ({"flag_eye_retargeting": True}, NotImplementedError, "A 6"),
    ({"flag_lip_retargeting": True}, NotImplementedError, "A 6"),
    ({"debug_nans": True}, NotImplementedError, "A 8"),
    ({"spade_norm_scale": 2}, ValueError, "spade_norm_scale"),
    ({"warp_impl": "pallas"}, ValueError, "TPU"),
])
def test_flags_the_port_lacks_raise(flags, error, match):
    with pytest.raises(error, match=match):
        PS._model_config(PC.InferenceConfig(**flags), PC.TINY)


def test_speed_flags_build_the_fast_bundle():
    rep = dataclasses.replace
    cfg = PS._model_config(PC.InferenceConfig(dense_motion_scale=2), PC.TINY)
    assert cfg == rep(PC.TINY, warping=rep(PC.TINY.warping,
                                           dense_motion_scale=2))
    cfg = PS._model_config(PC.InferenceConfig(flag_int8=True), PC.TINY)
    assert cfg.warping.warp_quant and cfg.swap.int8_conv
    assert cfg.warping.dense_motion_scale == 1
    both = PS._model_config(PC.InferenceConfig(dense_motion_scale=2,
                                               flag_int8=True), PC.TINY)
    assert both == PC.fast_bundle(PC.TINY)
    assert PS._model_config(PC.InferenceConfig(), PC.TINY) == PC.TINY


def test_fast_init_is_zero_and_half_precision_is_bf16():
    s = _session(flag_use_half_precision=True)
    assert s.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in s.core.state_dict().values()
               if v.is_floating_point())
    for net in (s.arcface.net, s.parsing.model, s.landmark203.net,
                s.lmk106.net, s.face_analysis.det_model):
        assert all(not v.any() for v in net.state_dict().values()
                   if v.is_floating_point())
    seeded = _session(seed=5, fast_init=False,
                      flag_use_half_precision=False)
    want = PS.C.CanonSwapCore(PC.TINY, seed=5 + PS.SEED_OFFSETS["core"],
                              device="cpu").state_dict()
    got = seeded.core.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_npz_from_the_jax_converter_loads(pair, tmp_path):
    """A .npz of the JAX core's trees ('/'-flattened, as ``cli.convert
    combined`` writes it) loads through ``from_jax`` with strict keys;
    .msgpack raises."""
    js, ps = pair
    path = str(tmp_path / "core.npz")
    JCK.save_npz(path, js.params)
    s = _session(flag_use_half_precision=False, checkpoint=path)
    want = ps.core.state_dict()
    got = s.core.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="msgpack"):
        _session(checkpoint=str(tmp_path / "core.msgpack"))


# ---- the session's stages against the JAX session's ------------------------


def _crops(seed, n=B, side=64):
    return (rng(seed).random((n, side, side, 3)) * 255).astype(np.uint8)


def test_get_source_id_matches_jax(pair, monkeypatch):
    js, ps = pair
    img = (rng(1).random((200, 180, 3)) * 255).astype(np.uint8)
    force_id_crop(js, ps, img, monkeypatch)
    want = np.asarray(js.get_source_id(img))
    got = ps.get_source_id(img)
    assert got.shape == want.shape == (1, PC.TINY.swap.latent_dim)
    assert_close(got, want)


def test_prepare_frames_is_the_f32_division(pair):
    js, ps = pair
    crops = _crops(2)
    got = ps.prepare_frames(crops)
    assert got.dtype == torch.float32
    assert torch.equal(got, t(crops.astype(np.float32) / 255.0))
    # the JAX session multiplies by 1/255 where its native library is
    # built: within one f32 ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(
        js.prepare_frames(crops)), rtol=1.2e-7, atol=0)
    # bf16: divided in f32, then rounded once, as the JAX session does
    ps.compute_dtype = torch.bfloat16
    try:
        half = ps.prepare_frames(t(crops))
    finally:
        ps.compute_dtype = torch.float32
    want = jnp.asarray(crops.astype(np.float32) / 255.0).astype(jnp.bfloat16)
    assert torch.equal(half.float(), t(np.asarray(want.astype(jnp.float32))))


def test_parse_masks_matches_jax(pair):
    js, ps = pair
    crops = _crops(3)
    want = np.asarray(js.parse_masks(crops))
    got = ps.parse_masks(crops)
    assert got.shape == want.shape == (B, 128, 128, 1)
    assert_close(got, want)
    q = ps.parse_masks_uint8(crops)
    assert q.dtype == torch.uint8
    assert np.abs(q.numpy().astype(int) - js.parse_masks_uint8(crops)
                  .astype(int)).max() <= 1


def test_swap_with_motion_and_swap_batch_match_jax(pair, monkeypatch):
    js, ps = pair
    img = (rng(4).random((200, 180, 3)) * 255).astype(np.uint8)
    force_id_crop(js, ps, img, monkeypatch)
    sid_j, sid = js.get_source_id(img), ps.get_source_id(img)
    crops = _crops(5)
    f_j, f = js.prepare_frames(crops), ps.prepare_frames(crops)
    want, motion_j = js.swap_with_motion(f_j, sid_j, with_debug=True)
    got, motion = ps.swap_with_motion(f, sid, with_debug=True)
    assert sorted(got) == ["out", "rec_can", "swap_can"]
    for k in got:
        assert got[k].dtype == torch.float32
        assert_close(got[k], np.asarray(want[k]))
    for k in motion_j:
        assert_close(motion[k], np.asarray(motion_j[k]))
    template = {k: np.asarray(v) for k, v in js.motion_template(f_j).items()}
    for k, v in ps.motion_template(f).items():
        assert_close(v, template[k])
    want_b = js.swap_batch(f_j, sid_j, template, with_debug=True)
    got_b = ps.swap_batch(f, sid, template, with_debug=True)
    for k in got_b:
        assert_close(got_b[k], np.asarray(want_b[k]))
    q, _ = ps.swap_with_motion(f, sid, as_uint8=True)
    assert list(q) == ["out"] and q["out"].dtype == torch.uint8
