"""The port's landmark nets and runners vs the JAX package's, f32 on the CPU.

The JAX variables are flax's init at full width with every leaf drawn anew
from a seed (``randomized``), carried to the port by
``runtime/weights.py::landmark_from_jax``.  Modules and the whole net are
held at rtol = atol = 2e-4 (the port's tolerance); the geometry copy at f32
resolution; the torch crop and resize within one grey level of cv2.

The whole ``run`` cannot be held at 2e-4: its crop is the torch warp's,
which may differ from cv2's by one grey level at some pixels.  Its bound is
derived from that difference: for each prediction m,
|d pred_m| <= 2 * sum over the differing pixel values i of |d pred_m / d x_i|
* 1/255 + 2e-4 * (1 + |pred_m|), the gradient taken at the cv2 crop (first
order; the factor 2 covers the PReLU kinks a one-grey-level step may cross)
plus the net's tolerance (``tests/helpers/torch_parity.py::
crop_step_bound``, forward mode over the differing values); the points are
224 * A * pred plus a shift, A the crop-to-image transform's linear part, so
|d pts| <= 224 * |A| |d pred|.

The 106-point runner (mobile trunk at 192, full width) and the residual
trunk (at narrow widths, its test-speed knob) are held the same way: the
residual net's modules and whole forward at 2e-4; the runner's net and
decode on the JAX crop at 2e-4; its ``get`` within the same bound, whose
input is the raw 0..255 crop, so one grey level is a step of 1, and whose
points are 96 * (pred + 1) mapped back by the crop's inverse.
"""

from __future__ import annotations

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.models import landmark as PL
from canonswap_torch.ops.resize import resize_like_cv2
from canonswap_torch.runtime.weights import (landmark_from_jax,
                                             landmark_net_from_jax)
from canonswap_torch.utils import geometry as PG
from canonswap_tpu.models import landmark as JL
from canonswap_tpu.utils import geometry as JG
from tests.helpers.torch_parity import (assert_close, crop_step_bound,
                                        randomized, rng, t)

SIZE = 224


@pytest.fixture(scope="module")
def nets():
    """(JAX net, JAX variables, port net) on the same random weights."""
    jnet = JL.MobileLandmarkNet(num_points=203)
    v = randomized(jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, SIZE, SIZE, 3))), seed=1)
    port = PL.MobileLandmarkNet(203).eval().requires_grad_(False)
    port.load_state_dict(landmark_from_jax(v), strict=True)
    return jnet, v, port


def _nhwc(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), 1, -1)


# ---- geometry ---------------------------------------------------------------


def _landmarks(n: int, seed: int, center=(160.0, 120.0), spread=40.0):
    g = rng(seed)
    return (np.asarray(center) + spread * g.standard_normal((n, 2))).astype(
        np.float32)


@pytest.mark.parametrize("n", [5, 9, 68, 101, 106, 203])
def test_geometry_matches_jax(n):
    pts = _landmarks(n, seed=n)
    for use_lip in (True, False):
        np.testing.assert_array_equal(PG._eye_lip_points(pts, use_lip),
                                      JG._eye_lip_points(pts, use_lip))
        got = PG.parse_rect_from_landmark(pts, 1.7, 0.1, -0.2, use_lip)
        want = JG.parse_rect_from_landmark(pts, 1.7, 0.1, -0.2, use_lip)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for rot in (True, False):
        got = PG.estimate_similar_transform(pts, SIZE, flag_do_rot=rot)
        want = JG.estimate_similar_transform(pts, SIZE, flag_do_rot=rot)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(PG.transform_pts(pts, got[0]),
                                   JG.transform_pts(pts, want[0]),
                                   rtol=1e-6, atol=1e-4)


def _frames(h=240, w=320, seed=2):
    """A noise frame and a smooth one, uint8 RGB."""
    noise = (rng(seed).random((h, w, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127 + 100 * np.sin(xx / 23.0 + c) * np.cos(yy / 31.0)
                       for c in range(3)], -1).astype(np.uint8)
    return {"noise": noise, "smooth": smooth}


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("spread", [20.0, 60.0, 200.0],
                         ids=["zoom_in", "near_1x", "zoom_out"])
def test_crop_within_one_grey_level_of_cv2(kind, spread):
    img = _frames()[kind]
    pts = _landmarks(203, seed=7, spread=spread)
    got = PG.crop_image(t(img), pts, dsize=SIZE)
    want = JG.crop_image(img, pts, dsize=SIZE)
    diff = np.abs(got["img_crop"].numpy().astype(int)
                  - want["img_crop"].astype(int))
    assert got["img_crop"].dtype == torch.uint8 and diff.max() <= 1
    for key in ("pt_crop", "M_o2c", "M_c2o"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("shape,size", [
    ((720, 1280, 3), (224, 224)), ((240, 320, 3), (224, 224)),
    ((100, 150, 3), (64, 96)), ((30, 40, 3), (64, 48))])
def test_resize_within_one_grey_level_of_cv2(shape, size):
    img = (rng(8).random(shape) * 255).astype(np.uint8)
    got = resize_like_cv2(t(img), size).numpy()
    want = cv2.resize(img, (size[1], size[0]))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---- modules ----------------------------------------------------------------


def test_prelu_matches_jax(nets):
    _, v, port = nets
    x = rng(3).standard_normal((2, 16, 5, 6), dtype=np.float32)
    want = JL._PReLU().apply({"params": v["params"]["stem_act"]},
                             jnp.asarray(_nhwc(x)))
    assert_close(_nhwc(port.stem_act(t(x))), want)
    x2 = rng(4).standard_normal((3, 256), dtype=np.float32)
    want = JL._PReLU().apply({"params": v["params"]["fc0_act"]},
                             jnp.asarray(x2))
    assert_close(port.fc0_act(t(x2)), want)


@pytest.mark.parametrize("i", [0, 1, 11], ids=["s1", "s2", "s2_wide"])
def test_dwsep_matches_jax(nets, i):
    _, v, port = nets
    block = getattr(port, f"dw{i}")
    c_in = block.dw.in_channels
    x = rng(5 + i).standard_normal((2, c_in, 14, 14), dtype=np.float32)
    ref = JL._DWSep(block.pw.out_channels, stride=PL.PLAN[i][1])
    want = ref.apply({"params": v["params"][f"dw{i}"]}, jnp.asarray(_nhwc(x)))
    assert_close(_nhwc(block(t(x))), want)


def test_net_matches_jax(nets):
    jnet, v, port = nets
    x = rng(9).random((2, SIZE, SIZE, 3), dtype=np.float32)
    want = jax.jit(jnet.apply)(v, jnp.asarray(x))
    got = port(t(x))
    assert got.shape == (2, 406)
    assert port.gdc.kernel_size == (7, 7)
    assert_close(got, want)


# ---- the runner -------------------------------------------------------------


@pytest.fixture(scope="module")
def runners(nets):
    _, v, port = nets
    jr = JL.Landmark203Runner(params=v)
    pr = PL.Landmark203Runner(state_dict=port.state_dict(), device="cpu")
    return jr, pr


BRANCHES = {"previous_landmarks": _landmarks(203, seed=11, spread=45.0),
            "no_landmarks": None}


def _jax_crop(img, lmk):
    """The JAX runner's crop and M_c2o (landmark.py:249-260)."""
    if lmk is None:
        s = max(img.shape[:2]) / SIZE
        return (cv2.resize(img, (SIZE, SIZE)),
                np.diag([s, s, 1.0]).astype(np.float32))
    got = JG.crop_image(img, lmk, dsize=SIZE, scale=1.5, vy_ratio=-0.1)
    return got["img_crop"], got["M_c2o"]


def _pts_bound(pred_bound: np.ndarray, m_c2o: np.ndarray) -> np.ndarray:
    """|d pts| per point and axis for a per-prediction bound."""
    return SIZE * pred_bound.reshape(-1, 2) @ np.abs(m_c2o[:2, :2]).T


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_runner_net_and_decode_match_jax_on_the_same_crop(runners, branch):
    jr, pr = runners
    img, lmk = _frames()["noise"], BRANCHES[branch]
    crop, m_c2o = _jax_crop(img, lmk)
    want_pred = np.asarray(jr._apply(
        jr.params, jnp.asarray((crop.astype(np.float32) / 255.0)[None])))[0]
    got_pred = pr.net((t(crop).float() / 255.0)[None])[0].numpy()
    assert_close(got_pred, want_pred)
    got = PG.transform_pts(pr.predict(t(crop)), m_c2o)
    want = jr.run(img, lmk)
    assert got.shape == want.shape == (203, 2)
    bound = _pts_bound(2e-4 * (1 + np.abs(want_pred)), m_c2o)
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_runner_run_within_the_crop_bound(runners, branch):
    jr, pr = runners
    img, lmk = _frames()["noise"], BRANCHES[branch]
    want_crop, m_c2o = _jax_crop(img, lmk)
    got_crop, got_m = pr.crop(img, lmk)
    got_crop = got_crop.numpy()
    np.testing.assert_allclose(got_m, m_c2o, rtol=1e-6, atol=1e-4)
    assert np.abs(got_crop.astype(int) - want_crop.astype(int)).max() <= 1
    pred = np.asarray(jr._apply(jr.params, jnp.asarray(
        (want_crop.astype(np.float32) / 255.0)[None])))[0]
    bound = _pts_bound(crop_step_bound(pr.net, want_crop, got_crop, pred,
                                       1 / 255), m_c2o)
    got, want = pr.run(img, lmk), jr.run(img, lmk)
    err = np.abs(got - want)
    print(f"{branch}: {int((got_crop != want_crop).sum())} crop values "
          f"differ; max |d pts| {err.max():.3g} px, bound there "
          f"{bound.reshape(-1)[err.argmax()]:.3g}, smallest bound "
          f"{bound.min():.3g}")
    assert got.shape == (203, 2) and np.isfinite(got).all()
    assert (err <= bound).all()


def test_runner_tracks_from_its_own_points(runners):
    """Frame to frame: each run takes the previous run's points."""
    _, pr = runners
    frames = _frames()
    pts = pr.run(frames["smooth"])
    for _ in range(2):
        pts = pr.run(frames["noise"], pts)
        assert pts.shape == (203, 2) and np.isfinite(pts).all()


def test_runner_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.Landmark203Runner()


# ---- the residual trunk and the trunk switch --------------------------------

WIDTHS = (8, 16, 16, 32)


@pytest.fixture(scope="module")
def residual():
    """(JAX LandmarkNet, its variables, port LandmarkNet) at narrow widths."""
    jnet = JL.LandmarkNet(num_points=106, widths=WIDTHS)
    v = randomized(jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 96, 96, 3))), seed=4)
    port = PL.LandmarkNet(106, widths=WIDTHS).eval().requires_grad_(False)
    port.load_state_dict(landmark_net_from_jax(v), strict=True)
    return jnet, v, port


@pytest.mark.parametrize("name,c_in,stride", [("block0", 8, 1),
                                              ("block1", 8, 2),
                                              ("block3b", 32, 1)])
def test_trunk_block_matches_jax(residual, name, c_in, stride):
    _, v, port = residual
    block = getattr(port, name)
    features = block.conv1.out_channels
    x = rng(21).standard_normal((2, c_in, 12, 10), dtype=np.float32)
    want = JL._TrunkBlock(features, stride=stride).apply(
        {"params": v["params"][name]}, jnp.asarray(_nhwc(x)))
    assert (block.short is not None) == (stride != 1 or c_in != features)
    assert_close(_nhwc(block(t(x))), want)


def test_residual_net_matches_jax(residual):
    jnet, v, port = residual
    for side in (96, 64):
        x = rng(22).random((2, side, side, 3), dtype=np.float32)
        want = jax.jit(jnet.apply)(v, jnp.asarray(x))
        got = port(t(x))
        assert got.shape == (2, 212)
        assert_close(got, want)


def test_make_trunk_choices_and_errors():
    assert isinstance(PL._make_trunk(106, "mobile", None, 192),
                      PL.MobileLandmarkNet)
    net = PL._make_trunk(203, "residual", None, 224)
    assert isinstance(net, PL.LandmarkNet) and net.widths == \
        PL.DEFAULT_WIDTHS == JL._DEFAULT_WIDTHS
    with pytest.raises(ValueError, match="widths only applies"):
        PL._make_trunk(106, "mobile", (8, 16), 192)
    with pytest.raises(ValueError, match="widths only applies"):
        JL._make_trunk(106, "mobile", (8, 16))
    with pytest.raises(ValueError, match="unknown landmark trunk"):
        PL._make_trunk(106, "resnet", None, 192)
    with pytest.raises(ValueError, match="unknown landmark trunk"):
        PL.Landmark106Runner(trunk="resnet", device="cpu")


# ---- the 106-point runner ---------------------------------------------------

SIZE106 = 192
BOXES = {"box": np.array([120.0, 70.0, 200.0, 170.0], np.float32),
         "zero_size": np.array([150.0, 100.0, 150.0, 100.0], np.float32),
         "inverted": np.array([200.0, 170.0, 120.0, 70.0], np.float32)}


@pytest.fixture(scope="module")
def runners106():
    jnet = JL.MobileLandmarkNet(num_points=106)
    v = randomized(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE106, SIZE106, 3))), seed=5)
    jr = JL.Landmark106Runner(params=v)
    pr = PL.Landmark106Runner(state_dict=landmark_from_jax(v), device="cpu")
    return jr, pr


def _jax_crop106(jr, img, bbox):
    M = jr.crop_transform(bbox)
    return JG.warp_affine(img, M, SIZE106), M


@pytest.mark.parametrize("box", sorted(BOXES))
def test_runner106_net_and_decode_match_jax_on_the_same_crop(runners106,
                                                             box):
    jr, pr = runners106
    img, bbox = _frames()["noise"], BOXES[box]
    crop, M = _jax_crop106(jr, img, bbox)
    np.testing.assert_allclose(pr.crop_transform(bbox), M, rtol=1e-6)
    want_pred = np.asarray(jr._apply(
        jr.params, jnp.asarray(crop.astype(np.float32)[None])))[0]
    got = pr.predict(t(crop))
    assert_close((got / 96.0 - 1.0).reshape(-1), want_pred, rtol=2e-4,
                 atol=2e-4 * (1 + np.abs(want_pred)).max())
    Minv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    want = jr.get(img, bbox)
    got_pts = PG.transform_pts(got, Minv)
    bound = 96 * (2e-4 * (1 + np.abs(want_pred))).reshape(-1, 2) @ np.abs(
        Minv[:, :2]).T
    assert got_pts.shape == want.shape == (106, 2)
    assert (np.abs(got_pts - want) <= bound).all()


@pytest.mark.parametrize("box", sorted(BOXES))
def test_runner106_get_within_the_crop_bound(runners106, box):
    jr, pr = runners106
    img, bbox = _frames()["noise"], BOXES[box]
    want_crop, M = _jax_crop106(jr, img, bbox)
    got_crop, _ = pr.crop(img, bbox)
    got_crop = got_crop.numpy()
    assert np.abs(got_crop.astype(int) - want_crop.astype(int)).max() <= 1
    pred = np.asarray(jr._apply(jr.params, jnp.asarray(
        want_crop.astype(np.float32)[None])))[0]
    pred_bound = crop_step_bound(pr.net, want_crop, got_crop, pred, 1.0)
    Minv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    bound = 96 * pred_bound.reshape(-1, 2) @ np.abs(Minv[:, :2]).T
    got, want = pr.get(img, bbox), jr.get(img, bbox)
    err = np.abs(got - want)
    print(f"{box}: {int((got_crop != want_crop).sum())} crop values differ; "
          f"max |d pts| {err.max():.3g} px, bound there "
          f"{bound.reshape(-1)[err.argmax()]:.3g}")
    assert got.shape == (106, 2) and np.isfinite(got).all()
    assert (err <= bound).all()


def test_runner106_takes_a_device_tensor(runners106):
    _, pr = runners106
    img = _frames()["smooth"]
    np.testing.assert_array_equal(pr.get(t(img), BOXES["box"]),
                                  pr.get(img, BOXES["box"]))


def test_runner106_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.Landmark106Runner()
