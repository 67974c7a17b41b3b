"""The port's Cropper, paste-back and their helpers vs the JAX package's, on
the CPU.

Tolerances, each with its reason:

- ``CropConfig`` field for field, ``smooth`` and the face-alignment
  geometry at rtol 1e-6 (the same numpy code);
- the cv2 stand-ins within one grey level: the area resize (at integer
  factors bit for bit, at fractional ones cv2 sums in another order), the
  warps (cv2's 1/32-pixel positions and fixed-point weights);
- the float mask warp within 1e-5 (cv2 warps a float image unrounded);
- the batched mask ops and ``paste_back_batch`` at 2e-4, the port's
  tolerance;
- ``paste_back`` bit for bit against the native C++ paste-back except at
  rounding ties: where the exact value lies within 1/32 of a grey level of
  a rounding step (f32 positions carry about 1e-4 pixel of rounding, times
  crop gradients of up to 255 grey levels a pixel), and within one grey
  level of the JAX cv2 fallback, which warps to uint8 first and truncates;
- the Cropper's tracking teacher-forced: each landmark call of the port
  gets the JAX side's input of that call, its output is held within the
  runner's derived bound (``tests/helpers/torch_parity.py::
  crop_step_bound``; the crops it sees are within one grey level of
  cv2's), and the JAX output goes on, so a grey level on one frame cannot
  move the next frame's crop.  The crops are then within one grey level,
  the transforms and landmarks equal.
"""

from __future__ import annotations

import dataclasses
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch import configs as PC
from canonswap_torch.models import landmark as PL
from canonswap_torch.ops import affine as PA
from canonswap_torch.ops.resize import area_resize_like_cv2
from canonswap_torch.runtime import cropper as PCR
from canonswap_torch.runtime import face_analysis as PF
from canonswap_torch.runtime.weights import (landmark_net_from_jax,
                                             scrfd_from_jax)
from canonswap_torch.utils import face_align as PFA
from canonswap_torch.utils import geometry as PG
from canonswap_torch.utils import smoothing as PSM
from canonswap_tpu.configs import pipeline_config as JC
from canonswap_tpu.models import landmark as JL
from canonswap_tpu.models import scrfd as JS
from canonswap_tpu.ops import affine as JA
from canonswap_tpu.runtime import cropper as JCR
from canonswap_tpu.runtime import face_analysis as JF
from canonswap_tpu.runtime import native as NAT
from canonswap_tpu.utils import face_align as JFA
from canonswap_tpu.utils import geometry as JG
from canonswap_tpu.utils import smoothing as JSM
from tests.helpers.torch_parity import (assert_close, crop_step_bound,
                                        randomized, rng, t)

FINE = dict(rtol=1e-6, atol=1e-6)


def _grey_diff(got, want) -> int:
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return int(np.abs(got.astype(int) - want.astype(int)).max())


# ---- configs, alignment, smoothing ------------------------------------------


def test_crop_config_field_for_field():
    port = [(f.name, f.default) for f in dataclasses.fields(PC.CropConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JC.CropConfig)]
    assert port == ref
    kw = {"dsize": 256, "scale": 2.0, "not_a_field": 1}
    assert dataclasses.asdict(PC.partial_fields(PC.CropConfig, kw)) == \
        dataclasses.asdict(JC.partial_fields(JC.CropConfig, kw))


def _kps(seed, spread=6.0):
    base = np.array([[40.0, 50.0], [72.0, 49.0], [56.0, 70.0], [43.0, 90.0],
                     [70.0, 91.0]])
    return (base * 1.7 + 30 + spread * rng(seed).standard_normal((5, 2))
            ).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_face_align_matches_jax(seed):
    lmk = _kps(seed)
    np.testing.assert_allclose(PFA.umeyama_similarity(lmk, PFA.ARCFACE_DST),
                               JFA.umeyama_similarity(lmk, JFA.ARCFACE_DST),
                               **FINE)
    for size in (112, 128, 224):
        np.testing.assert_allclose(PFA.estimate_norm_arcface(lmk, size),
                                   JFA.estimate_norm_arcface(lmk, size),
                                   **FINE)
    for mode in ("newarc", "ffhq"):
        got, got_i = PFA.estimate_norm_multiview(lmk, 112, mode)
        want, want_i = JFA.estimate_norm_multiview(lmk, 112, mode)
        assert got_i == want_i
        np.testing.assert_allclose(got, want, **FINE)
    img = (rng(seed).random((240, 200, 3)) * 255).astype(np.uint8)
    for mode in ("arcface", "newarc"):
        got, got_m = PFA.norm_crop(t(img), lmk, 112, mode)
        want, want_m = JFA.norm_crop(img, lmk, 112, mode)
        np.testing.assert_allclose(got_m, want_m, **FINE)
        assert _grey_diff(got, want) <= 1
    with pytest.raises(ValueError, match="5 landmarks"):
        PFA.estimate_norm_arcface(lmk[:4])


def test_smooth_matches_jax():
    x = rng(3).standard_normal((12, 4, 3)).astype(np.float32)
    for var in (3e-7, 1e-3):
        got = PSM.smooth(x, observation_variance=var)
        want = JSM.smooth(x, observation_variance=var)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **FINE)


# ---- the cv2 stand-ins ------------------------------------------------------


@pytest.mark.parametrize("shape,size", [
    ((512, 512, 3), (256, 256)), ((300, 400, 3), (100, 100)),
    ((64, 64, 3), (16, 16)), ((63, 90, 3), (21, 30)),
    ((512, 512, 3), (200, 200)), ((97, 131, 3), (40, 50)),
    ((100, 60, 3), (30, 25)), ((720, 1280, 3), (256, 256))],
    ids=["2x", "3x_4x", "4x", "3x", "frac_2.56", "frac_mixed",
         "frac_3.3_2.4", "frac_720p"])
def test_area_resize_within_one_grey_level_of_cv2(shape, size):
    img = (rng(8).random(shape) * 255).astype(np.uint8)
    want = cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_AREA)
    got = area_resize_like_cv2(t(img), size)
    assert _grey_diff(got, want) <= 1
    if shape[0] % size[0] == 0 and shape[1] % size[1] == 0:
        np.testing.assert_array_equal(got.numpy(), want)  # integer factors
    with pytest.raises(ValueError, match="downscales only"):
        area_resize_like_cv2(t(img), (shape[0] + 1, shape[1]))


def _face_pts(n=106, seed=9, center=(160.0, 120.0), spread=30.0):
    return (np.asarray(center) + spread * rng(seed).standard_normal(
        (n, 2))).astype(np.float32)


def test_parse_bbox_and_average_bbox_match_jax():
    pts = _face_pts()
    got = PG.parse_bbox_from_landmark(pts, 2.2, 0.1, -0.1)
    want = JG.parse_bbox_from_landmark(pts, 2.2, 0.1, -0.1)
    for k in ("center", "size", "bbox", "bbox_rot"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-4)
    assert got["angle"] == pytest.approx(want["angle"], rel=1e-6)
    boxes = [[1.0, 2.0, 30.0, 40.0], [3.0, 1.0, 33.0, 44.0]]
    assert PG.average_bbox(boxes) == JG.average_bbox(boxes)
    assert PG.average_bbox([]) is None


def test_crop_by_mo2c_and_by_bbox_match_jax():
    img = (rng(10).random((240, 320, 3)) * 255).astype(np.uint8)
    pts = _face_pts()
    mo2c, _ = JG.estimate_similar_transform(pts, 256, scale=2.3)
    got = PG.crop_image_mo2c(t(img), pts, mo2c, dsize=256)
    want = JG.crop_image_mo2c(img, pts, mo2c, dsize=256)
    assert _grey_diff(got["img_crop"], want["img_crop"]) <= 1
    for k in ("pt_crop", "M_o2c", "M_c2o"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-4)
    bbox = [100.5, 60.25, 230.5, 190.25]
    got = PG.crop_image_by_bbox(t(img), bbox, lmk=pts, dsize=128)
    want = JG.crop_image_by_bbox(img, bbox, lmk=pts, dsize=128)
    assert _grey_diff(got["img_crop"], want["img_crop"]) <= 1
    for k in ("lmk_crop", "M_o2c", "M_c2o"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-4)
    assert PG.crop_image_by_bbox(t(img), bbox)["lmk_crop"] is None


def _paste_case(seed, h=180, w=320, side=128):
    """A frame, a crop, its crop-to-frame transform and a feathered disc
    mask in the crop (512-crop-like geometry at a smaller size)."""
    g = rng(seed)
    ori = (g.random((h, w, 3)) * 255).astype(np.uint8)
    crop = (g.random((side, side, 3)) * 255).astype(np.uint8)
    pts = _face_pts(203, seed, center=(w / 2, h / 2), spread=h / 7)
    _, m_c2o = JG.estimate_similar_transform(pts, side, scale=2.3,
                                             vy_ratio=-0.125)
    yy, xx = np.mgrid[0:side, 0:side]
    r = np.hypot(yy - side / 2, xx - side / 2)
    disc = np.clip((0.4 * side - r) / (0.08 * side), 0, 1)
    mask = np.repeat(disc[..., None], 3, -1).astype(np.float32)
    return ori, crop, m_c2o, mask


def test_float_and_uint8_mask_warps():
    ori, _, m_c2o, mask = _paste_case(11)
    dsize = (ori.shape[1], ori.shape[0])
    got = PG.prepare_paste_back(t(mask), m_c2o, dsize, if_float=True)
    want = JG.prepare_paste_back(mask, m_c2o, dsize, if_float=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_close(got, want, rtol=0, atol=1e-5)
    mask_u8 = (mask * 255).astype(np.uint8)
    got = PG.prepare_paste_back(t(mask_u8), m_c2o, dsize)
    want = JG.prepare_paste_back(mask_u8, m_c2o, dsize)
    assert_close(got, want, rtol=0, atol=1 / 255 + 1e-7)
    assert PG.warp_affine(t(mask[..., 0]), m_c2o, dsize).shape == \
        ori.shape[:2]


@pytest.mark.parametrize("seed", [12, 13])
def test_paste_back_follows_the_native_arithmetic(seed):
    if not NAT.available():
        pytest.fail("the native paste-back did not build")
    ori, crop, m_c2o, mask = _paste_case(seed)
    dsize = (ori.shape[1], ori.shape[0])
    mask_ori = JG.prepare_paste_back(mask, m_c2o, dsize, if_float=True)
    got = PG.paste_back(t(crop), m_c2o, t(ori), t(mask_ori)).numpy()
    native = NAT.paste_back(crop, m_c2o, ori, mask_ori)
    value = PG.paste_back_value(crop, m_c2o, ori, mask_ori)
    near_tie = np.abs(value - np.floor(value) - 0.5) < 1 / 32
    differ = got != native
    print(f"{int(differ.sum())} of {got.size} values differ from the "
          f"native path, all at ties; {int(near_tie.sum())} near ties")
    assert _grey_diff(got, native) <= 1
    assert not (differ & ~near_tie).any()
    # where the mask is 0 the frame is untouched, bit for bit
    zero = mask_ori[..., 0] <= 0
    assert zero.any() and (got[zero] == ori[zero]).all()
    # the cv2 fallback: a uint8 warp first, the blend truncated
    cv2_path = np.clip(mask_ori * JG.warp_affine(crop, m_c2o, dsize)
                       + (1 - mask_ori) * ori, 0, 255).astype(np.uint8)
    assert _grey_diff(got, cv2_path) <= 1
    # a 2D mask and a float crop take the same path
    got2 = PG.paste_back(t(crop.astype(np.float32)), m_c2o, t(ori),
                         t(mask_ori[..., 0]))
    np.testing.assert_array_equal(got2.numpy(), got)


# ---- the batched mask ops ---------------------------------------------------


@pytest.mark.parametrize("k", [5, 4, 3])
def test_mask_ops_match_jax(k):
    g = rng(14)
    m = (g.random((2, 20, 24, 1)) > 0.7).astype(np.float32)
    soft = g.random((2, 20, 24, 1)).astype(np.float32)
    for port, ref, x in ((PA.dilate_mask, JA.dilate_mask, m),
                         (PA.erode_mask, JA.erode_mask, 1 - m),
                         (PA.smooth_mask, JA.smooth_mask, soft)):
        assert_close(port(t(x), k), ref(jnp.asarray(x), k))


def test_blend_and_batched_paste_back_match_jax():
    g = rng(15)
    fg = g.random((2, 32, 32, 3)).astype(np.float32)
    bg = g.random((2, 16, 16, 3)).astype(np.float32)
    mask = g.random((2, 32, 32, 1)).astype(np.float32)
    assert_close(PA.blend_images(t(fg), t(bg), t(mask)),
                 JA.blend_images(jnp.asarray(fg), jnp.asarray(bg),
                                 jnp.asarray(mask)))
    assert_close(PA.blend_images(t(fg), t(fg[:, ::-1].copy()), t(mask)),
                 JA.blend_images(jnp.asarray(fg), jnp.asarray(
                     fg[:, ::-1].copy()), jnp.asarray(mask)))
    crops = g.random((2, 40, 40, 3)).astype(np.float32)
    originals = g.random((2, 60, 90, 3)).astype(np.float32)
    masks = g.random((2, 60, 90, 1)).astype(np.float32)
    ms = []
    for i in range(2):
        pts = _face_pts(203, 20 + i, center=(45.0, 30.0), spread=6.0)
        ms.append(JG.estimate_similar_transform(pts, 40, scale=2.0)[1])
    ms = np.stack(ms)
    want = jax.jit(JA.paste_back_batch)(*map(jnp.asarray,
                                             (crops, ms, originals, masks)))
    got = PA.paste_back_batch(t(crops), t(ms), t(originals), t(masks))
    assert got.shape == (2, 60, 90, 3)
    assert_close(got, want)


# ---- the Cropper, teacher-forced --------------------------------------------

DET = 128  # det_size, and the frames' size: the letterbox is then the identity
WIDTHS = (8, 16, 16, 32)


def _clip(n=4, seed=16):
    g = rng(seed)
    yy, xx = np.mgrid[0:DET, 0:DET].astype(np.float32)
    out = []
    for i in range(n):
        base = np.stack([np.sin((xx + 2 * i) / (9 + 3 * c)) * np.cos(
            (yy - i) / (13 + 2 * c)) for c in range(3)], -1)
        out.append(np.clip(127 + 90 * base + 10 * g.standard_normal(
            (DET, DET, 3)), 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def stack():
    """The JAX and the port's face stacks on the same random weights:
    SCRFD at full width, both landmark runners on the residual trunk at
    narrow widths."""
    sv = randomized(jax.jit(JS.SCRFD().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, DET, DET, 3))), seed=17)
    lv = {}
    for n, size, seed in ((106, 192, 18), (203, 224, 19)):
        net = JL.LandmarkNet(num_points=n, widths=WIDTHS)
        lv[n] = randomized(net.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, size, size, 3))), seed)
    j106 = JL.Landmark106Runner(params=lv[106], widths=WIDTHS,
                                trunk="residual")
    j203 = JL.Landmark203Runner(params=lv[203], widths=WIDTHS,
                                trunk="residual")
    p106 = PL.Landmark106Runner(landmark_net_from_jax(lv[106]),
                                trunk="residual", widths=WIDTHS,
                                device="cpu")
    p203 = PL.Landmark203Runner(landmark_net_from_jax(lv[203]),
                                trunk="residual", widths=WIDTHS,
                                device="cpu")
    jfa = JF.FaceAnalysis(det_params=sv, lmk106=j106, det_size=(DET, DET),
                          det_thresh=0.5)
    pfa = PF.FaceAnalysis(scrfd_from_jax(sv), lmk106=p106,
                          det_size=(DET, DET), det_thresh=0.5, device="cpu")
    return types.SimpleNamespace(j106=j106, j203=j203, p106=p106, p203=p203,
                                 jfa=jfa, pfa=pfa)


def _recorded(obj, name, calls):
    real = getattr(obj, name)

    def record(*args):
        out = real(*args)
        calls.append((args, out))
        return out
    return record


def _forced(obj, name, calls, check):
    """The port's runner method, fed the JAX call's inputs in order: its
    output is checked against the JAX output, and the JAX output goes on."""
    real = getattr(obj, name)
    it = iter(calls)

    def forced(img, arg):
        (j_img, j_arg), j_out = next(it)
        check(real, img, arg, j_img, j_arg, j_out)
        return j_out
    return forced


def _check106(stack):
    jr, pr = stack.j106, stack.p106

    def check(real, img, bbox, j_img, j_bbox, j_out):
        img = img.numpy()
        np.testing.assert_array_equal(img, j_img)
        assert_close(bbox, j_bbox, rtol=2e-4, atol=2e-4 * DET)
        M = jr.crop_transform(j_bbox)
        want_crop = JG.warp_affine(j_img, M, 192)
        got_crop = pr.crop(img, j_bbox)[0].numpy()
        assert _grey_diff(got_crop, want_crop) <= 1
        pred = np.asarray(jr._apply(jr.params, jnp.asarray(
            want_crop.astype(np.float32)[None])))[0]
        minv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
        bound = 96 * crop_step_bound(pr.net, want_crop, got_crop, pred,
                                     1.0).reshape(-1, 2) @ np.abs(
                                         minv[:, :2]).T
        err = np.abs(real(img, j_bbox) - j_out)
        print(f"106: {int((got_crop != want_crop).sum())} crop values "
              f"differ; max |d pts| {err.max():.3g} px, bound there "
              f"{bound.reshape(-1)[err.argmax()]:.3g}")
        assert (err <= bound).all()
    return check


def _check203(stack):
    jr, pr = stack.j203, stack.p203

    def check(real, img, lmk, j_img, j_lmk, j_out):
        img = img.numpy()
        np.testing.assert_array_equal(img, j_img)
        np.testing.assert_array_equal(lmk, j_lmk)
        got_crop, m_c2o = pr.crop(img, j_lmk)
        got_crop = got_crop.numpy()
        want = JG.crop_image(j_img, j_lmk, dsize=224, scale=1.5,
                             vy_ratio=-0.1)
        assert _grey_diff(got_crop, want["img_crop"]) <= 1
        np.testing.assert_allclose(m_c2o, want["M_c2o"], rtol=1e-6,
                                   atol=1e-4)
        pred = np.asarray(jr._apply(jr.params, jnp.asarray(
            (want["img_crop"].astype(np.float32) / 255.0)[None])))[0]
        bound = 224 * crop_step_bound(
            pr.net, want["img_crop"], got_crop, pred, 1 / 255).reshape(
                -1, 2) @ np.abs(m_c2o[:2, :2]).T
        err = np.abs(real(img, j_lmk) - j_out)
        print(f"203: {int((got_crop != want['img_crop']).sum())} crop "
              f"values differ; max |d pts| {err.max():.3g} px, bound there "
              f"{bound.reshape(-1)[err.argmax()]:.3g}")
        assert (err <= bound).all()
    return check


def _teacher_forced(stack, monkeypatch, run_jax, run_port):
    """Runs the JAX side recording its landmark calls, then the port's with
    each call forced to the JAX inputs; returns both results and the calls."""
    calls = {"106": [], "203": []}
    monkeypatch.setattr(stack.j106, "get",
                        _recorded(stack.j106, "get", calls["106"]))
    monkeypatch.setattr(stack.j203, "run",
                        _recorded(stack.j203, "run", calls["203"]))
    want = run_jax()
    monkeypatch.setattr(stack.p106, "get", _forced(
        stack.p106, "get", calls["106"], _check106(stack)))
    monkeypatch.setattr(stack.p203, "run", _forced(
        stack.p203, "run", calls["203"], _check203(stack)))
    return run_port(), want, calls


CFG = dict(max_face_num=2)


def test_crop_source_image_teacher_forced(stack, monkeypatch):
    img = _clip(1)[0]
    jc = JCR.Cropper(JC.CropConfig(**CFG), stack.jfa, stack.j203)
    pc = PCR.Cropper(PC.CropConfig(**CFG), stack.pfa, stack.p203,
                     device="cpu")
    got, want, calls = _teacher_forced(
        stack, monkeypatch, lambda: jc.crop_source_image(img),
        lambda: pc.crop_source_image(img))
    assert want is not None and len(calls["106"]) >= 1
    assert _grey_diff(got["img_crop"], want["img_crop"]) <= 1
    assert _grey_diff(got["img_crop_256x256"],
                      want["img_crop_256x256"]) <= 1
    for k in ("lmk_crop", "lmk_crop_256x256", "M_o2c", "M_c2o", "pt_crop"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-4)


def test_crop_source_video_teacher_forced(stack, monkeypatch):
    clip = _clip(4)
    jc = JCR.Cropper(JC.CropConfig(**CFG), stack.jfa, stack.j203)
    pc = PCR.Cropper(PC.CropConfig(**CFG), stack.pfa, stack.p203,
                     device="cpu")
    got, want, calls = _teacher_forced(
        stack, monkeypatch, lambda: jc.crop_source_video(clip),
        lambda: pc.crop_source_video(clip))
    assert len(calls["203"]) == len(clip) == len(want["frame_crop_lst"])
    assert len(got["frame_crop_lst"]) == len(clip)
    for g_crop, w_crop in zip(got["frame_crop_lst"],
                              want["frame_crop_lst"]):
        assert g_crop.device.type == "cpu" and g_crop.shape == (256, 256, 3)
        assert _grey_diff(g_crop, w_crop) <= 1
    for k in ("lmk_crop_lst", "M_c2o_lst", "M_o2c_lst"):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4)


def _mo2c(n):
    """Given crop transforms, one a frame."""
    return [JG.estimate_similar_transform(
        _face_pts(203, 40 + i, center=(64.0, 60.0), spread=12.0), 512,
        scale=2.3)[0] for i in range(n)]


@pytest.mark.parametrize("method", ["crop_driving_video",
                                    "crop_video_with_mo2c",
                                    "calc_lmks_from_cropped_video"])
def test_other_tracking_methods_teacher_forced(stack, monkeypatch, method):
    """The driving-video crop (the averaged box), the crop by given
    transforms and the tracking alone, teacher-forced as above."""
    clip = _clip(3)
    args = {"crop_driving_video": (clip, 128),
            "crop_video_with_mo2c": (clip, _mo2c(3)),
            "calc_lmks_from_cropped_video": (clip,)}[method]
    jc = JCR.Cropper(JC.CropConfig(**CFG), stack.jfa, stack.j203)
    pc = PCR.Cropper(PC.CropConfig(**CFG), stack.pfa, stack.p203,
                     device="cpu")
    got, want, calls = _teacher_forced(
        stack, monkeypatch, lambda: getattr(jc, method)(*args),
        lambda: getattr(pc, method)(*args))
    assert len(calls["203"]) == len(clip)
    if method == "calc_lmks_from_cropped_video":
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    assert len(got["frame_crop_lst"]) == len(want["frame_crop_lst"]) == 3
    for g_crop, w_crop in zip(got["frame_crop_lst"],
                              want["frame_crop_lst"]):
        assert _grey_diff(g_crop, w_crop) <= 1
    for k in ("lmk_crop_lst", "M_c2o_lst", "M_o2c_lst"):
        for a, b in zip(got.get(k, []), want.get(k, [])):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-4)
    assert len(got["M_c2o_lst"]) == len(want["M_c2o_lst"])


def test_entry_points_need_a_card_or_the_cpu_by_name(stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PF.FaceAnalysis()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCR.Cropper(PC.CropConfig(), stack.pfa, stack.p203)
    with pytest.raises(ValueError, match="XPoseRunner"):
        PCR.Cropper(PC.CropConfig(), stack.pfa, stack.p203,
                    image_type="animal_face", device="cpu")
