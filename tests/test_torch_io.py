"""The port's host utilities vs the JAX package's, on the CPU: image and
clip I/O, the motion template, the batched reader, the ratios, the helpers,
logging and timing.

Bit for bit: the PPM and ``.npy`` round trips (numpy alone), the cv2 paths
(the same cv2 calls as the JAX package's), the templates across the two
packages, the batched reader's batches, the ratios (the same numpy code).
``resize_to_limit`` and ``concat_frames`` resize through
``resize_like_cv2``, within one grey level of cv2's fixed point.  Without
cv2 a codec format raises an ImportError naming the file."""

from __future__ import annotations

import builtins
import sys

import cv2
import numpy as np
import pytest
import torch

from canonswap_torch.utils import helper as PH
from canonswap_torch.utils import io as PIO
from canonswap_torch.utils import ratios as PR
from canonswap_torch.utils import rlog as PLOG
from canonswap_torch.utils import timing as PT
from canonswap_torch.utils import video as PV
from canonswap_tpu.utils import helper as JH
from canonswap_tpu.utils import io as JIO
from canonswap_tpu.utils import ratios as JR
from canonswap_tpu.utils import video as JV


def _frames(seed=0, shape=(5, 24, 40, 3)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.fixture
def no_cv2(monkeypatch):
    """cv2 (and ffmpeg) made unavailable, as on a machine without them."""
    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    monkeypatch.setattr(builtins, "__import__", fake_import)
    monkeypatch.setattr(PV.shutil, "which", lambda name: None)


# ---- images -----------------------------------------------------------------


def test_ppm_round_trips_bit_for_bit(tmp_path):
    img = _frames(1, (1, 31, 17, 3))[0]
    path = str(tmp_path / "a.ppm")
    PIO.save_image_rgb(path, img)
    got = PIO.load_image_rgb(path)
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    # a standard P6 file: cv2 reads the same pixels (BGR)
    assert np.array_equal(cv2.imread(path)[..., ::-1], img)


def test_ppm_header_comments_and_bad_files(tmp_path):
    img = _frames(2, (1, 3, 4, 3))[0]
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n4 3\n# another\n255\n" + img.tobytes())
    assert np.array_equal(PIO.read_ppm(str(path)), img)
    (tmp_path / "p3.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="P6"):
        PIO.read_ppm(str(tmp_path / "p3.ppm"))
    (tmp_path / "short.ppm").write_bytes(b"P6\n4 3\n255\n" + b"\0" * 5)
    with pytest.raises(ValueError, match="truncated"):
        PIO.read_ppm(str(tmp_path / "short.ppm"))
    with pytest.raises(FileNotFoundError, match="nope.ppm"):
        PIO.load_image_rgb(str(tmp_path / "nope.ppm"))


def test_png_goes_through_cv2_as_in_jax(tmp_path):
    img = _frames(3, (1, 20, 30, 3))[0]
    path = str(tmp_path / "a.png")
    PIO.save_image_rgb(path, img)
    assert np.array_equal(JIO.load_image_rgb(path), img)
    assert np.array_equal(PIO.load_image_rgb(path), img)


def test_codec_formats_without_cv2_raise_naming_the_file(tmp_path, no_cv2):
    png = tmp_path / "src.png"
    png.write_bytes(b"\x89PNG")
    with pytest.raises(ImportError, match="src.png.*cv2.*ppm"):
        PIO.load_image_rgb(str(png))
    mp4 = tmp_path / "clip.mp4"
    mp4.write_bytes(b"\0" * 16)
    for fn in (PV.load_video, PV.get_fps):
        with pytest.raises(ImportError, match="clip.mp4.*npy"):
            fn(str(mp4))
    with pytest.raises(ImportError, match="out.mp4"):
        PV.VideoWriterRGB(str(tmp_path / "out.mp4"), 25)
    # the formats that need no codec still work
    clip = _frames(4)
    PV.images2video(clip, str(tmp_path / "c.npy"))
    assert np.array_equal(np.load(tmp_path / "c.npy"), clip)
    PIO.save_image_rgb(str(tmp_path / "a.ppm"), clip[0])


def test_extension_tables_extend_the_jax_ones():
    assert set(JIO.IMAGE_EXTS) | {".ppm"} == set(PIO.IMAGE_EXTS)
    assert set(JIO.VIDEO_EXTS) | {".npy"} == set(PIO.VIDEO_EXTS)
    for path in ("a.JPG", "b.png", "c.ppm", "d.mp4", "e.npy", "f.pkl",
                 "g.txt"):
        assert PIO.is_image(path) == (JIO.is_image(path)
                                      or path.endswith(".ppm"))
        assert PIO.is_video(path) == (JIO.is_video(path)
                                      or path.endswith(".npy"))
        assert PIO.is_template(path) == JIO.is_template(path)
        assert PIO.basename("/x/y/" + path) == JIO.basename("/x/y/" + path)


@pytest.mark.parametrize("shape,max_dim,division",
                         [((300, 200, 3), 128, 2), ((101, 257, 3), 4096, 4),
                          ((90, 60, 3), 64, 3)])
def test_resize_to_limit_within_one_grey_level(shape, max_dim, division):
    img = _frames(5, (1, *shape))[0]
    got = PIO.resize_to_limit(img, max_dim, division)
    want = JIO.resize_to_limit(img, max_dim, division)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---- motion templates ------------------------------------------------------


def _template(seed=6):
    g = np.random.default_rng(seed)
    motion = {k: g.standard_normal(s).astype(np.float32)
              for k, s in (("kp", (3, 5, 3)), ("x_t", (3, 5, 3)),
                           ("scale", (3, 1)), ("t", (3, 3)))}
    lmk = g.random((3, 203, 2)).astype(np.float32) * 64
    return {"n_frames": 3, "output_fps": 25, "motion": motion,
            "c_eyes_lst": [JR.calc_eye_close_ratio(m[None]) for m in lmk],
            "c_lip_lst": [JR.calc_lip_close_ratio(m[None]) for m in lmk]}


def _assert_same_template(got, want):
    assert got.keys() == want.keys()
    assert got["n_frames"] == want["n_frames"]
    assert got["output_fps"] == want["output_fps"]
    for k in want["motion"]:
        assert np.array_equal(got["motion"][k], want["motion"][k])
    for k in ("c_eyes_lst", "c_lip_lst"):
        for a, b in zip(got[k], want[k], strict=True):
            assert np.array_equal(a, b)


def test_templates_cross_between_the_packages(tmp_path):
    tpl = _template()
    JIO.dump(str(tmp_path / "jax.pkl"), tpl)
    _assert_same_template(PIO.load(str(tmp_path / "jax.pkl")), tpl)
    PIO.dump(str(tmp_path / "sub" / "port.pkl"), tpl)
    _assert_same_template(JIO.load(str(tmp_path / "sub" / "port.pkl")), tpl)
    with pytest.raises(ValueError, match="Unknown template"):
        PIO.dump(str(tmp_path / "t.json"), tpl)


# ---- clips ------------------------------------------------------------------


def test_npy_clip_round_trips_bit_for_bit(tmp_path):
    clip = _frames(7)
    path = str(tmp_path / "clip.npy")
    with PV.VideoWriterRGB(path, 30) as w:
        for frame in clip:
            w.write(frame)
    assert w.n_frames == len(clip)
    assert np.array_equal(np.load(path), clip)
    got = PV.load_video(path)
    assert len(got) == len(clip) and all(
        np.array_equal(a, b) for a, b in zip(got, clip))
    assert np.array_equal(np.stack(PV.load_video(path, 2)), clip[:2])
    assert np.array_equal(np.stack(list(PV.iter_video(path))), clip)
    assert PV.get_fps(path) == 25.0  # a .npy clip has no rate: the default
    assert PV.frame_size(path) == (40, 24)
    assert not PV.has_audio_stream(path)
    with pytest.raises(ValueError, match="frame"):
        with PV.VideoWriterRGB(str(tmp_path / "bad.npy"), 25) as w:
            w.write(clip[0])
            w.write(clip[0, :10])


def test_npy_clip_of_the_wrong_layout_raises(tmp_path):
    np.save(tmp_path / "f.npy", np.zeros((2, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        PV.load_video(str(tmp_path / "f.npy"))
    with pytest.raises(FileNotFoundError, match="none.npy"):
        PV.load_video(str(tmp_path / "none.npy"))


@pytest.fixture
def mp4(tmp_path):
    """A cv2-written mp4 (lossy), and its frame count."""
    path = str(tmp_path / "drv.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (40, 24))
    for frame in _frames(8):
        w.write(frame)
    w.release()
    return path


def test_the_cv2_path_reads_what_jax_reads(mp4):
    want = JV.load_video(mp4)
    got = PV.load_video(mp4)
    assert len(got) == len(want) == 5
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(np.stack(PV.load_video(mp4, 3)),
                          np.stack(JV.load_video(mp4, 3)))
    assert PV.get_fps(mp4) == JV.get_fps(mp4)
    assert PV.frame_size(mp4) == (40, 24)
    assert PH.is_square_video(mp4) == JH.is_square_video(mp4) is False


def test_mp4_writer_through_cv2(tmp_path, monkeypatch):
    """Without ffmpeg an .mp4 is written by cv2, as the JAX writer does."""
    monkeypatch.setattr(PV.shutil, "which", lambda name: None)
    clip = _frames(9, (4, 32, 48, 3))
    PV.images2video(clip, str(tmp_path / "p.mp4"))
    JV.images2video(clip, str(tmp_path / "j.mp4"))
    got, want = (PV.load_video(str(tmp_path / f)) for f in ("p.mp4", "j.mp4"))
    assert len(got) == 4 and all(np.array_equal(a, b)
                                 for a, b in zip(got, want))


@pytest.mark.parametrize("batch", [2, 3, 5, 8])
def test_batched_reader_matches_jax(mp4, tmp_path, batch):
    want = list(JV.BatchedVideoReader(mp4, batch))
    for path in (mp4, str(tmp_path / "c.npy")):
        if path.endswith(".npy"):
            np.save(path, np.stack(JV.load_video(mp4)))
        reader = PV.BatchedVideoReader(path, batch)
        assert reader.fps == 25
        got = list(reader)
        assert [v for _, v in got] == [v for _, v in want]
        for (a, _), (b, _) in zip(got, want):
            assert a.shape == (batch, 24, 40, 3)
            assert np.array_equal(a, b)


def test_batched_reader_raises_the_decode_error(tmp_path):
    np.save(tmp_path / "f.npy", np.zeros((2, 4, 4, 3), np.float32))
    reader = PV.BatchedVideoReader(str(tmp_path / "f.npy"), 2)
    with pytest.raises(ValueError, match="uint8"):
        list(reader)
    reader._thread.join(timeout=10)
    assert not reader._thread.is_alive()


def test_concat_frames_matches_jax():
    a = _frames(10, (2, 32, 20, 3))
    b = _frames(11, (2, 16, 10, 3))
    c = _frames(12, (2, 32, 8, 3))
    got = PV.concat_frames(list(a), list(b), list(c))
    want = JV.concat_frames(list(a), list(b), list(c))
    assert len(got) == 2
    for x, y in zip(got, want):
        assert x.shape == y.shape == (32, 48, 3)
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1


def test_audio_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(PV.shutil, "which", lambda name: None)
    assert not PV.has_audio_stream(str(tmp_path / "a.mp4"))
    assert not PV.add_audio_to_video("a.mp4", "b.mp4", "c.mp4")


# ---- ratios, helpers, logging, timing ---------------------------------------


def test_ratios_equal_jax():
    lmk = np.random.default_rng(13).random((4, 203, 2)).astype(np.float32)
    src = np.random.default_rng(14).random((203, 2)).astype(np.float32)
    for name in ("calc_eye_close_ratio", "calc_lip_close_ratio"):
        assert np.array_equal(getattr(PR, name)(lmk), getattr(JR, name)(lmk))
    target = np.full((4, 1), 0.3, np.float32)
    assert np.array_equal(PR.calc_eye_close_ratio(lmk, target),
                          JR.calc_eye_close_ratio(lmk, target))
    c_eye, c_lip = JR.calc_eye_close_ratio(lmk[:1]), JR.calc_lip_close_ratio(
        lmk[:1])
    assert np.array_equal(PR.calc_combined_eye_ratio(c_eye, src),
                          JR.calc_combined_eye_ratio(c_eye, src))
    assert np.array_equal(PR.calc_combined_lip_ratio(c_lip, src),
                          JR.calc_combined_lip_ratio(c_lip, src))


def test_motion_multiplier_equals_jax():
    g = np.random.default_rng(15)
    a, b = g.standard_normal((21, 3)), g.standard_normal((21, 3))
    assert PH.calc_motion_multiplier(a, b) == JH.calc_motion_multiplier(a, b)


def test_is_square_video_on_a_npy_clip(tmp_path):
    np.save(tmp_path / "sq.npy", np.zeros((1, 8, 8, 3), np.uint8))
    np.save(tmp_path / "wide.npy", np.zeros((1, 8, 9, 3), np.uint8))
    assert PH.is_square_video(str(tmp_path / "sq.npy"))
    assert not PH.is_square_video(str(tmp_path / "wide.npy"))


def test_log_prints_with_and_without_rich(capsys, monkeypatch):
    PLOG.log("with rich")
    assert "with rich" in capsys.readouterr().out
    monkeypatch.setattr(PLOG, "_console", lambda: None)
    PLOG.log("plain", 1)
    assert capsys.readouterr().out == "plain 1\n"


def test_stage_timer_and_profile_trace(tmp_path):
    timer = PT.StageTimer()
    synced = []
    with timer.stage("device", items=8, sync=lambda: synced.append(1)):
        torch.ones(4).sum()
    with timer.stage("device", items=8):
        pass
    with pytest.raises(RuntimeError):
        with timer.stage("fails"):
            raise RuntimeError("x")
    assert synced == [1]
    assert timer.counts == {"device": 2, "fails": 1}
    assert timer.items["device"] == 16
    report = timer.report()
    assert "device" in report and "items/s" in report
    with PT.profile_trace(None):
        pass
    with PT.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").exists()

