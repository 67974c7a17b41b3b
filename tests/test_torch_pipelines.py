"""The port's four pipelines vs the JAX package's, frame by frame, at TINY
in f32 on the CPU.

Both sessions hold the same weights (``tests/helpers/torch_sessions.py``)
and both sides get the same seeded frames: the port reads them from a ``.npy`` clip and a ``.ppm`` source, the JAX side through its ``utils/
video.py`` functions patched to return them (cv2's mp4 is lossy), and its
encoders patched to capture the frames.  Each ID crop is the JAX
session's (``force_id_crop``).  What differs between the two by a grey
level is forced to the JAX side's value, as ``tests/test_torch_cropper.py``
holds the Cropper teacher-forced: ``swap_e2e``'s crop path, ``swap_v2i``'s
source and driving crops get the JAX Cropper's results, and ``swap_multi``
and ``streaming`` the JAX side's detections and ``crop_image`` results in
call order.  ``swap_e2e`` on a square clip without the crop runs free
(64 x 64 frames, so the resize to the network's input is the identity):
its tracking feeds only the template's ratios.

Tolerances, with their reasons: the motion template at rtol = atol = 2e-4
(the port's); uint8 frames within one grey level where the pipeline
quantizes a generator output (``clip(255 v)`` truncated: a value within
2e-4 of a step lands one level apart), and the count of differing values
at most ``255 * 2e-4``, 5.1 %, of them (the share of values within 2e-4
of a step, for values spread over the steps).  Where a quantized mask
blends (``paste_back``), a mask value one level apart moves the blend by
at most one more level: two grey levels there, counted the same way."""

from __future__ import annotations

import os.path as osp

import numpy as np
import pytest
import torch

from canonswap_torch import configs as PC
from canonswap_torch.pipelines import streaming as PST
from canonswap_torch.pipelines import swap_e2e as PE
from canonswap_torch.pipelines import swap_multi as PM
from canonswap_torch.pipelines import swap_v2i as PV2I
from canonswap_torch.utils import geometry as PG
from canonswap_torch.utils import io as PIO
from canonswap_torch.utils.ratios import calc_eye_close_ratio
from canonswap_tpu.configs import pipeline_config as JPC
from canonswap_tpu.pipelines import streaming as JST
from canonswap_tpu.pipelines import swap_e2e as JE
from canonswap_tpu.pipelines import swap_multi as JM
from canonswap_tpu.pipelines import swap_v2i as JV2I
from canonswap_tpu.utils import geometry as JG
from canonswap_tpu.utils import io as JIO
from canonswap_tpu.utils import video as JV
from tests.helpers.torch_parity import assert_close, rng
from tests.helpers.torch_sessions import build_pair, force_id_crop

B = 2
# the share of uint8 values that may differ (see the module docstring)
SHARE = 255 * 2e-4


@pytest.fixture(scope="module")
def pair():
    return build_pair(batch_size=B)


@pytest.fixture
def media(tmp_path):
    src = (rng(0).random((200, 180, 3)) * 255).astype(np.uint8)
    PIO.save_image_rgb(str(tmp_path / "src.ppm"), src)
    JIO.save_image_rgb(str(tmp_path / "src.png"), src)  # lossless
    return tmp_path, src


def _clip(seed, shape):
    return (rng(seed).random(shape) * 255).astype(np.uint8)


def _jax_io(monkeypatch, frames) -> dict:
    """The JAX pipelines' clip input and every output (path -> frames),
    without a codec."""
    got = {}

    class Writer:
        def __init__(self, path, fps, crf=18):
            got[path] = []
            self.path = path

        def write(self, frame):
            got[self.path].append(np.array(frame))

        def close(self):
            pass

    def images2video(images, wfp, fps=25.0, crf=18):
        got[wfp] = [np.array(f) for f in images]

    monkeypatch.setattr(JV, "load_video", lambda p, n=-1: list(frames))
    monkeypatch.setattr(JV, "iter_video", lambda p: iter(list(frames)))
    monkeypatch.setattr(JV, "get_fps", lambda p, d=25.0: 25.0)
    monkeypatch.setattr(JV, "has_audio_stream", lambda p: False)
    monkeypatch.setattr(JV, "images2video", images2video)
    monkeypatch.setattr(JV, "VideoWriterRGB", Writer)
    monkeypatch.setattr(JIO, "save_image_rgb",
                        lambda p, img: got.__setitem__(p, [np.array(img)]))
    return got


def _args(cfg, d, driving, out):
    return cfg.ArgumentConfig(source=str(d / ("src.ppm" if cfg is PC
                                              else "src.png")),
                              driving=str(d / driving),
                              output_dir=str(d / out))


def _assert_uint8_close(got, want, levels=1, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= levels, (what, diff.max())
    assert (diff > 0).mean() <= SHARE, (what, (diff > 0).mean())


def _assert_concat_close(got, want, side, what=""):
    """A concat strip: the driving crop upsampled by ``resize_like_cv2``
    (within one grey level of cv2's fixed-point weights, at any count),
    then the generator's strips as ``_assert_uint8_close``."""
    got, want = np.asarray(got), np.stack(want)
    assert got.shape == want.shape
    assert np.abs(got[:, :, :side].astype(int)
                  - want[:, :, :side].astype(int)).max() <= 1, what
    _assert_uint8_close(got[:, :, side:], want[:, :, side:], what=what)


def _template(path):
    return PIO.load(path)


# ---- swap_e2e ---------------------------------------------------------------


def test_swap_e2e_square_blend_path_runs_free(pair, media, monkeypatch):
    """No crop on a square clip: tracking (for the template's ratios), the
    identity resize, the swap with its debug strips, the blend through the
    mask, the concat strip; then a second run from each side's template."""
    js, ps = pair
    d, src = media
    frames = _clip(1, (3, 64, 64, 3))
    np.save(d / "sq.npy", frames)
    force_id_crop(js, ps, src, monkeypatch)
    captured = _jax_io(monkeypatch, frames)
    for run in range(2):
        w_j = JE.execute(js, _args(JPC, d, "sq_j.mp4", "out_j"))
        w_p = PE.execute(ps, _args(PC, d, "sq.npy", "out_p"))
        assert w_p == (str(d / "out_p" / "src--sq.npy"),
                       str(d / "out_p" / "src--sq_concat.npy"))
        got, got_concat = (np.load(p) for p in w_p)
        assert got.shape == (3, 128, 128, 3)
        assert got_concat.shape == (3, 128, 512, 3)
        _assert_uint8_close(got, captured[w_j[0]], what=f"result {run}")
        _assert_concat_close(got_concat, captured[w_j[1]], 128,
                             what=f"concat {run}")
        tpl, tpl_j = _template(str(d / "sq.pkl")), _template(
            str(d / "sq_j.pkl"))
        assert tpl.keys() == tpl_j.keys()
        assert tpl["n_frames"] == tpl_j["n_frames"] == 3
        for k, v in tpl_j["motion"].items():
            assert_close(tpl["motion"][k], v)
    # the ratios are the port's own tracked landmarks' (its tracking is held
    # teacher-forced in tests/test_torch_cropper.py)
    lmks = ps.cropper.calc_lmks_from_cropped_video(torch.from_numpy(frames))
    for ratio, lmk in zip(tpl["c_eyes_lst"], lmks, strict=True):
        assert np.array_equal(ratio, calc_eye_close_ratio(lmk[None]))


def test_swap_e2e_smoothed_template(pair, media, monkeypatch):
    """``flag_smooth_motion``: the template first, Kalman-smoothed along
    the frames (``utils/smoothing.py``, held to the JAX copy in
    tests/test_torch_cropper.py), then the swap from it; a smoothed
    template is not cached, on either side."""
    js, ps = pair
    d, src = media
    frames = _clip(7, (3, 64, 64, 3))
    np.save(d / "sm.npy", frames)
    force_id_crop(js, ps, src, monkeypatch)
    for s in (js, ps):
        monkeypatch.setattr(s.inference_cfg, "flag_smooth_motion", True)
    captured = _jax_io(monkeypatch, frames)
    w_j = JE.execute(js, _args(JPC, d, "sm_j.mp4", "out_j"))
    w_p = PE.execute(ps, _args(PC, d, "sm.npy", "out_p"))
    _assert_uint8_close(np.load(w_p[0]), captured[w_j[0]], what="result")
    assert not osp.exists(d / "sm_j.pkl") and not osp.exists(d / "sm.pkl")


def _crop_result_to_port(ret):
    return {k: [torch.from_numpy(np.ascontiguousarray(c)) for c in v]
            if k == "frame_crop_lst" else v for k, v in ret.items()}


def test_swap_e2e_crop_path_with_the_jax_crops(pair, media, monkeypatch):
    """A 3:4 clip takes the crop path; both sides crop as the JAX Cropper
    does, then swap, parse and paste back (B=2: a padded last batch)."""
    js, ps = pair
    d, src = media
    frames = _clip(2, (3, 120, 160, 3))
    np.save(d / "drv.npy", frames)
    force_id_crop(js, ps, src, monkeypatch)
    ret = js.cropper.crop_source_video(list(frames))
    assert len(ret["frame_crop_lst"]) == 3
    monkeypatch.setattr(js.cropper, "crop_source_video", lambda f: ret)
    monkeypatch.setattr(ps.cropper, "crop_source_video",
                        lambda f: _crop_result_to_port(ret))
    captured = _jax_io(monkeypatch, frames)
    w_j = JE.execute(js, _args(JPC, d, "drv_j.mp4", "out_j"))
    w_p = PE.execute(ps, _args(PC, d, "drv.npy", "out_p"))
    got, got_concat = (np.load(p) for p in w_p)
    assert got.shape == (3, 120, 160, 3)
    _assert_uint8_close(got, captured[w_j[0]], levels=2, what="pasted")
    _assert_concat_close(got_concat, captured[w_j[1]], 128, what="concat")
    for k, v in _template(str(d / "drv_j.pkl"))["motion"].items():
        assert_close(_template(str(d / "drv.pkl"))["motion"][k], v)


def test_swap_e2e_image_target_keeps_its_format(pair, media, monkeypatch):
    """An image target gives images in its own format (.ppm here)."""
    js, ps = pair
    d, src = media
    force_id_crop(js, ps, src, monkeypatch)
    PIO.save_image_rgb(str(d / "tgt.ppm"), _clip(3, (64, 64, 3)))
    wfp, wfp_concat = PE.execute(ps, _args(PC, d, "tgt.ppm", "out_img"))
    assert wfp.endswith("src--tgt.ppm") and wfp_concat.endswith(
        "src--tgt_concat.ppm")
    assert PIO.load_image_rgb(wfp).shape == (128, 128, 3)
    assert PIO.load_image_rgb(wfp_concat).shape == (128, 512, 3)
    assert not osp.exists(d / "tgt.pkl")  # templates are for clips


# ---- swap_v2i ---------------------------------------------------------------


def test_swap_v2i_with_the_jax_crops(pair, media, monkeypatch):
    js, ps = pair
    d, src = media
    frames = _clip(4, (3, 120, 160, 3))
    np.save(d / "drv.npy", frames)
    force_id_crop(js, ps, frames[0], monkeypatch)  # the driving identity
    ret_s = js.cropper.crop_source_image(src)
    ret_d = js.cropper.crop_source_video(list(frames))
    assert ret_s is not None and len(ret_d["frame_crop_lst"]) == 3
    monkeypatch.setattr(js.cropper, "crop_source_image", lambda img: ret_s)
    monkeypatch.setattr(js.cropper, "crop_source_video", lambda f: ret_d)
    ret_s_p = dict(ret_s, img_crop_256x256=torch.from_numpy(
        ret_s["img_crop_256x256"]))
    monkeypatch.setattr(ps.cropper, "crop_source_image",
                        lambda img: ret_s_p)
    monkeypatch.setattr(ps.cropper, "crop_source_video",
                        lambda f: _crop_result_to_port(ret_d))
    captured = _jax_io(monkeypatch, frames)
    w_j = JV2I.execute(js, _args(JPC, d, "drv_j.mp4", "out_j"))
    w_p = PV2I.execute(ps, _args(PC, d, "drv.npy", "out_p"))
    got, got_concat = (np.load(p) for p in w_p)
    assert got.shape == (3, 200, 180, 3)
    assert got_concat.shape == (3, 128, 256, 3)
    _assert_uint8_close(got, captured[w_j[0]], levels=2, what="pasted")
    _assert_concat_close(got_concat, captured[w_j[1]], 128, what="concat")
    for name in ("source_can", "swap_can"):
        _assert_uint8_close(
            PIO.load_image_rgb(str(d / "out_p" / f"{name}.ppm")),
            captured[str(d / "out_j" / f"{name}.jpg")][0], what=name)


# ---- swap_multi and streaming: tracking forced to the JAX side's -----------


def _replay_crops(monkeypatch):
    """Records the JAX ``crop_image`` results in call order (the landmark
    tracker's 224 crops and the faces' crops); the port's ``crop_image``
    returns them in the same order."""
    calls = []
    real = JG.crop_image

    def record(*a, **k):
        ret = real(*a, **k)
        calls.append(ret)
        return ret

    def replay(*a, **k):
        ret = calls.pop(0)
        return dict(ret, img_crop=torch.from_numpy(ret["img_crop"]))

    monkeypatch.setattr(JG, "crop_image", record)
    monkeypatch.setattr(PG, "crop_image", replay)
    return calls


def test_swap_multi_with_the_jax_tracks(pair, media, monkeypatch):
    js, ps = pair
    d, src = media
    frames = _clip(5, (3, 120, 160, 3))
    np.save(d / "drv.npy", frames)
    force_id_crop(js, ps, src, monkeypatch)
    faces = js.face_analysis.get(frames[0], flag_do_landmark_2d_106=True,
                                 direction="large-small", max_face_num=2)
    assert len(faces) == 2
    monkeypatch.setattr(js.face_analysis, "get", lambda *a, **k: faces)
    monkeypatch.setattr(ps.face_analysis, "get", lambda *a, **k: faces)
    calls = _replay_crops(monkeypatch)
    captured = _jax_io(monkeypatch, frames)
    w_j = JM.execute(js, _args(JPC, d, "drv_j.mp4", "out_j"), max_faces=2)
    # per face: the tracker's own 224 crop on frame 0, then on each of the
    # 3 frames the tracker's crop and the face's
    assert len(calls) == 2 * (1 + 3 * 2)
    w_p = PM.execute(ps, _args(PC, d, "drv.npy", "out_p"), max_faces=2)
    assert not calls
    got = np.load(w_p)
    assert got.shape == (3, 120, 160, 3)
    # two faces pasted one after the other: two grey levels each
    _assert_uint8_close(got, captured[w_j], levels=4, what="multi")


def test_streaming_with_the_jax_tracks(pair, media, monkeypatch):
    """The three threads; frame 0's detection and each crop forced to the
    JAX side's, in call order (3 frames in batches of 2: the last batch
    padded by its last frame, tracked as the JAX producer tracks it)."""
    js, ps = pair
    d, src = media
    frames = _clip(6, (3, 120, 160, 3))
    np.save(d / "drv.npy", frames)
    force_id_crop(js, ps, src, monkeypatch)
    detected = []
    real_detect = js.cropper._detect_lmk

    def record_detect(f):
        detected.append(real_detect(f))
        return detected[-1]

    monkeypatch.setattr(js.cropper, "_detect_lmk", record_detect)
    monkeypatch.setattr(ps.cropper, "_detect_lmk",
                        lambda f: detected.pop(0))
    calls = _replay_crops(monkeypatch)
    captured = _jax_io(monkeypatch, frames)
    w_j = JST.execute(js, _args(JPC, d, "drv_j.mp4", "out_j"))
    # the tracker's 224 crop and the face's, on 4 frames (3 and the pad)
    assert len(calls) == 4 * 2 and detected[0] is not None
    w_p = PST.execute(ps, _args(PC, d, "drv.npy", "out_p"))
    assert not calls and not detected
    got = np.load(w_p)
    assert got.shape == (3, 120, 160, 3)
    _assert_uint8_close(got, np.stack(captured[w_j.replace(
        ".npy", ".mp4")]), levels=2, what="stream")


def test_streaming_raises_a_producer_error(pair, media, monkeypatch):
    _, ps = pair
    d, src = media
    np.save(d / "bad.npy", np.zeros((3, 8, 8, 3), np.float32))
    monkeypatch.setattr(ps, "get_source_id", lambda img: None)
    with pytest.raises(ValueError, match="uint8"):
        PST.execute(ps, _args(PC, d, "bad.npy", "out_bad"))
