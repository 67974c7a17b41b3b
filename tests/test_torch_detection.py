"""The port's fixed-capacity SCRFD decode vs the JAX package's, on the CPU.

Anchors, distances and IoU are the same f32 arithmetic on both sides and
are held at 1e-6; NMS keep masks and top-k selections must be equal (ties
included: JAX's ``lax.top_k`` keeps the lower index first, the port sorts
stably); boxes and keypoints on identical head outputs at the port's
tolerance, 2e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.ops import detection as PD
from canonswap_tpu.ops import detection as JD
from tests.helpers.torch_parity import assert_close, rng, t

EXACT = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w,stride,a", [(16, 16, 8, 2), (5, 7, 16, 2),
                                          (3, 4, 32, 1)])
def test_anchor_centers(h, w, stride, a):
    got = PD.anchor_centers(h, w, stride, a)
    want = JD.anchor_centers(h, w, stride, a)
    assert got.shape == (h * w * a, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_distances():
    g = rng(1)
    pts = (g.random((50, 2)) * 100).astype(np.float32)
    d4 = (g.random((3, 50, 4)) * 20).astype(np.float32)
    d10 = (g.standard_normal((3, 50, 10)) * 10).astype(np.float32)
    want_b = jax.vmap(lambda d: JD.distance2bbox(jnp.asarray(pts), d))(d4)
    want_k = jax.vmap(lambda d: JD.distance2kps(jnp.asarray(pts), d))(d10)
    assert_close(PD.distance2bbox(t(pts), t(d4)), want_b, **EXACT)
    got_k = PD.distance2kps(t(pts), t(d10))
    assert got_k.shape == (3, 50, 5, 2)
    assert_close(got_k, want_k, **EXACT)


def _boxes(n, seed, degenerate=True):
    g = rng(seed)
    xy = g.random((n, 2)) * 100
    wh = g.random((n, 2)) * 40
    if degenerate:  # zero-size and inverted boxes, as a seeded head gives
        wh[: n // 8] = 0.0
        wh[n // 8: n // 4] *= -1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_matrix():
    b = _boxes(64, 2)
    got = PD._iou_matrix(t(b))
    assert_close(got, JD._iou_matrix(jnp.asarray(b)), **EXACT)
    assert bool(torch.isfinite(got).all())


def _nms_cases():
    g = rng(3)
    ties = _boxes(32, 4, degenerate=False)
    ties[8:16] = ties[0]  # duplicates of box 0
    ties[16:20] = ties[1] + 0.5  # near-duplicates
    scores_ties = np.sort(g.random(32).astype(np.float32))[::-1].copy()
    scores_ties[4:12] = scores_ties[4]  # equal scores
    padded = _boxes(32, 5)
    scores_pad = np.sort(g.random(32).astype(np.float32))[::-1].copy()
    scores_pad[20:] = 0.0  # padding past the threshold
    same = np.tile(_boxes(1, 6, degenerate=False), (16, 1))
    scores_same = np.linspace(1.0, 0.1, 16, dtype=np.float32)
    return {"ties": (ties, scores_ties), "padding": (padded, scores_pad),
            "all_suppressed": (same, scores_same),
            "random": (_boxes(128, 7), np.sort(g.random(128).astype(
                np.float32))[::-1].copy())}


@pytest.mark.parametrize("case", sorted(_nms_cases()))
@pytest.mark.parametrize("thresh", [0.4, 0.0])
def test_nms_fixed_keep_masks_equal(case, thresh):
    boxes, scores = _nms_cases()[case]
    want = np.asarray(jax.jit(JD.nms_fixed, static_argnums=2)(
        jnp.asarray(boxes), jnp.asarray(scores), thresh))
    got = PD.nms_fixed(t(boxes), t(scores), thresh)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "all_suppressed":
        assert got.numpy().tolist() == [True] + [False] * 15


def test_nms_fixed_batched():
    cases = _nms_cases()
    boxes = np.stack([cases["ties"][0], cases["padding"][0]])
    scores = np.stack([cases["ties"][1], cases["padding"][1]])
    got = PD.nms_fixed(t(boxes), t(scores))
    for i in range(2):
        want = np.asarray(JD.nms_fixed(jnp.asarray(boxes[i]),
                                       jnp.asarray(scores[i])))
        np.testing.assert_array_equal(got[i].numpy(), want)


def _head_outputs(size, b, seed, dup=False):
    """Identical per-stride head outputs for both sides: scores in [0, 1],
    distances in stride units (a few negative, as a seeded head gives)."""
    g = rng(seed)
    out = {}
    for s in (8, 16, 32):
        n = (size // s) ** 2 * 2
        score = g.random((b, n, 1)).astype(np.float32)
        if dup:  # equal scores across anchors: top-k order by index
            score = np.round(score * 4) / 4
        out[s] = {"score": score,
                  "bbox": (g.random((b, n, 4)) * 3 - 0.2).astype(np.float32),
                  "kps": g.standard_normal((b, n, 10)).astype(np.float32)}
    return out


@pytest.mark.parametrize("thresh,dup", [(0.5, False), (0.1, False),
                                        (0.9, True), (0.6, True)])
def test_decode_scrfd_matches_jax(thresh, dup):
    size = 128
    outs = _head_outputs(size, 2, seed=int(thresh * 10) + dup, dup=dup)
    want = JD.decode_scrfd(
        jax.tree_util.tree_map(jnp.asarray, outs), input_size=(size, size),
        score_thresh=thresh)
    got = PD.decode_scrfd(
        {s: {k: t(v) for k, v in o.items()} for s, o in outs.items()},
        input_size=(size, size), score_thresh=thresh)
    np.testing.assert_array_equal(got["scores"].numpy(),
                                  np.asarray(want["scores"]))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert got["bboxes"].shape == (2, 128, 4)
    assert got["kps"].shape == (2, 128, 5, 2)
    assert_close(got["bboxes"], want["bboxes"])
    assert_close(got["kps"], want["kps"])
    assert int(got["valid"].sum()) > 0
