"""The pipelines with stitching and retargeting on, port against the JAX
package, at TINY in f32 on the CPU.

Both sessions run ``flag_stitching``, ``flag_eye_retargeting``,
``flag_lip_retargeting`` and ``flag_normalize_lip``, on the weights of
``tests/helpers/torch_sessions.py::build_pair`` and the same redrawn
stitching nets (``randomized``, carried by ``stitching_from_jax``).  What
differs between the two by a grey level is forced to the JAX side's, as in
``tests/test_torch_pipelines.py``, whose helpers and tolerances these tests
take: the ID crop, the driving crops and tracks, and the source crop whose
landmarks give the retargeting ratios.

``swap_e2e`` twice: the first run (motion fused, template dumped) held to
the JAX first run; the second run (from the template).  The JAX package
dumps the adjusted keypoints and adjusts them again on its cached run, so
its second run differs from its first; the port dumps the extracted
keypoints, and its second run equals its first bit for bit."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from canonswap_torch import configs as PC
from canonswap_torch.pipelines import swap_e2e as PE
from canonswap_torch.runtime import checkpoint as PCK
from canonswap_torch.runtime.weights import stitching_from_jax
from canonswap_torch.utils import io as PIO
from canonswap_tpu.configs import pipeline_config as JPC
from canonswap_tpu.pipelines import swap_e2e as JE
from canonswap_tpu.utils import io as JIO
from tests.helpers.torch_parity import (assert_close, one_torch_thread,
                                        randomized, rng)
from tests.helpers.torch_sessions import build_pair, force_id_crop
from tests.test_torch_pipelines import (_args, _assert_concat_close,
                                        _assert_uint8_close, _clip,
                                        _crop_result_to_port, _jax_io, media)
from tests.test_torch_pipelines import \
    test_streaming_with_the_jax_tracks as _streaming
from tests.test_torch_pipelines import \
    test_swap_multi_with_the_jax_tracks as _multi

FLAGS = dict(flag_stitching=True, flag_eye_retargeting=True,
             flag_lip_retargeting=True, flag_normalize_lip=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread(one_torch_thread):
    pass


@pytest.fixture(scope="module")
def pair():
    js, ps = build_pair(batch_size=2, **FLAGS)
    js.stitching_params = randomized(
        jax.tree_util.tree_map(np.asarray, js.stitching_params), 7)
    ps.stitching.load_state_dict(stitching_from_jax(js.stitching_params),
                                 strict=True)
    return js, ps


@pytest.fixture(scope="module")
def e2e_runs(pair, tmp_path_factory):
    """Two runs of each side's swap_e2e on a 3:4 clip (the crop path):
    {run: (JAX result, port result, JAX concat, port concat)} and the two
    templates."""
    js, ps = pair
    d = tmp_path_factory.mktemp("stitch")
    src = (rng(0).random((200, 180, 3)) * 255).astype(np.uint8)
    PIO.save_image_rgb(str(d / "src.ppm"), src)
    JIO.save_image_rgb(str(d / "src.png"), src)
    frames = _clip(2, (3, 120, 160, 3))
    np.save(d / "drv.npy", frames)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        force_id_crop(js, ps, src, mp)
        ret = js.cropper.crop_source_video(list(frames))
        ret_s = js.cropper.crop_source_image(src)
        assert ret_s is not None and len(ret["frame_crop_lst"]) == 3
        mp.setattr(js.cropper, "crop_source_video", lambda f: ret)
        mp.setattr(ps.cropper, "crop_source_video",
                   lambda f: _crop_result_to_port(ret))
        mp.setattr(js.cropper, "crop_source_image", lambda img: ret_s)
        mp.setattr(ps.cropper, "crop_source_image", lambda img: ret_s)
        captured = _jax_io(mp, frames)
        for run in (1, 2):
            w_j = JE.execute(js, _args(JPC, d, "drv_j.mp4", f"out_j{run}"))
            w_p = PE.execute(ps, _args(PC, d, "drv.npy", f"out_p{run}"))
            runs[run] = (np.stack(captured[w_j[0]]), np.load(w_p[0]),
                         np.stack(captured[w_j[1]]), np.load(w_p[1]))
    templates = (PIO.load(str(d / "drv_j.pkl")), PIO.load(str(d / "drv.pkl")))
    return runs, templates


def test_swap_e2e_first_run_matches_jax(e2e_runs):
    """Retargeted, stitched, pasted back: within the uint8 bounds of
    tests/test_torch_pipelines.py.  The port's template holds the extracted
    motion: all but x_t equal to the JAX template's, x_t not (the JAX one
    is adjusted)."""
    runs, (tpl_j, tpl_p) = e2e_runs
    want, got, want_concat, got_concat = runs[1]
    assert got.shape == (3, 120, 160, 3)
    _assert_uint8_close(got, want, levels=2, what="pasted")
    _assert_concat_close(got_concat, list(want_concat), 128, what="concat")
    for k, v in tpl_j["motion"].items():
        if k != "x_t":
            assert_close(tpl_p["motion"][k], v)
    assert np.abs(tpl_p["motion"]["x_t"] - tpl_j["motion"]["x_t"]).max() \
        > 1e-3


def test_jax_cached_run_adjusts_twice(e2e_runs):
    """The JAX package as it is: its run from the template adjusts the
    already adjusted keypoints, so its frames move."""
    runs = e2e_runs[0]
    first, second = runs[1][2], runs[2][2]  # the concat strips
    assert np.abs(first.astype(int) - second.astype(int)).max() > 8


def test_port_cached_run_equals_its_first_run(e2e_runs):
    runs = e2e_runs[0]
    assert np.array_equal(runs[1][1], runs[2][1])
    assert np.array_equal(runs[1][3], runs[2][3])


def test_swap_multi_with_stitching(pair, media, monkeypatch):
    """swap_multi gets the stitching through the session (no ratios)."""
    _multi(pair, media, monkeypatch)


def test_streaming_with_stitching(pair, media, monkeypatch):
    """streaming gets the stitching through the session (no ratios)."""
    _streaming(pair, media, monkeypatch)


def test_session_loads_a_stitching_checkpoint(pair, tmp_path):
    """``load_stitching_checkpoint``: the .npz the JAX converter writes."""
    js, ps = pair
    tree = randomized(js.stitching_params, 8)
    PCK.save_npz(str(tmp_path / "s.npz"), tree)
    before = {k: v.clone() for k, v in ps.stitching.state_dict().items()}
    try:
        ps.load_stitching_checkpoint(str(tmp_path / "s.npz"))
        want = stitching_from_jax(tree)
        for k, v in ps.stitching.state_dict().items():
            assert np.array_equal(v.numpy(), want[k].numpy()), k
    finally:
        ps.stitching.load_state_dict(before)
