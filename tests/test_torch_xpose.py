"""The port's XPose/UniPose vs the JAX package's, on the same weights and
numpy inputs, f32 on the CPU, rtol = atol = 2e-4 (the port's tolerance).

The weights are the port's seeded init at ``unipose.TINY`` (2 encoder and 3
decoder layers, so the keypoint stage runs; 20 keypoint slots, so
``hw_append`` exists as the reference checkpoint's converter reads it),
taken to JAX by ``convert_unipose``.  Each module is held against its JAX
counterpart on its own, then the whole forward, the runner, the weight
conversion and the preprocessing.  The JAX forward runs jitted once per
module-scoped fixture; its two top-k selections are recorded through
``jax.debug.callback`` and must equal the port's, in order.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonswap_torch.models.xpose import swin as PS
from canonswap_torch.models.xpose import transformer as PT
from canonswap_torch.models.xpose import unipose as PU
from canonswap_torch.models.xpose.convert import unipose_from_jax
from canonswap_torch.models.xpose.runner import XPoseRunner
from canonswap_torch.nn.init import init_random_
from canonswap_tpu.models.xpose import runner as JR
from canonswap_tpu.models.xpose import swin as JS
from canonswap_tpu.models.xpose import transformer as JT
from canonswap_tpu.models.xpose import unipose as JU
from canonswap_tpu.models.xpose.convert import convert_unipose
from canonswap_tpu.ops.resize import nearest_resize
from tests.helpers.torch_parity import assert_close, np_state_dict, rng, t

CFG = PU.TINY
CANVAS = (64, 96)
T_LEN = 8
NUM_KPT = 9
# levels of a (64, 96) canvas: Swin stages 1..3 and the extra stride-2 level
SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))


def jax_config(cfg: PU.UniPoseConfig) -> JU.UniPoseConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["swin"] = JS.SwinConfig(**dataclasses.asdict(cfg.swin))
    return JU.UniPoseConfig(**fields)


@pytest.fixture(scope="module")
def tiny():
    """(port model, JAX config, JAX variables) on the port's seeded init."""
    model = init_random_(PU.UniPose(CFG), 0).eval().requires_grad_(False)
    variables = convert_unipose(np_state_dict(model), jax_config(CFG))
    return model, jax_config(CFG), variables


def jit_apply(module, params, fn=None):
    """The jitted ``module.apply``; ``fn(module_apply, *args)`` binds static
    arguments."""
    def run(p, *args):
        def call(*a, **kw):
            return module.apply({"params": p}, *a, **kw)
        return call(*args) if fn is None else fn(call, *args)
    return lambda *args: jax.jit(run)(params, *args)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---- configs ----------------------------------------------------------------


@pytest.mark.parametrize("port,ref", [
    (PU.UniPoseConfig(), JU.UniPoseConfig()),
    (PS.SwinConfig(), JS.SwinConfig()),
    (PU.TINY, jax_config(PU.TINY))])
def test_configs_match_the_jax_dataclasses(port, ref):
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for name in names:
        got, want = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        else:
            assert got == want, name
    if isinstance(port, PS.SwinConfig):
        assert port.num_features == ref.num_features


# ---- Swin ------------------------------------------------------------------


def test_swin_masks_and_index_match_jax():
    np.testing.assert_array_equal(PS.rel_pos_index(7), JS._rel_pos_index(7))
    for hp, wp, ws, shift in ((14, 21, 7, 3), (7, 7, 7, 3), (28, 14, 7, 3),
                              (12, 8, 4, 2)):
        got = PS.shift_attn_mask(hp, wp, ws, shift, "cpu").numpy()
        np.testing.assert_array_equal(got, JS._shift_attn_mask(hp, wp, ws,
                                                               shift))


@pytest.mark.parametrize("j", [0, 1], ids=["window", "shifted"])
def test_swin_block(tiny, j):
    """A 10 x 13 map: padded to 14 x 14, rolled by 3 in the shifted one."""
    model, _, v = tiny
    block = model.backbone[0].layers[0].blocks[j]
    hh, ww, dim = 10, 13, CFG.swin.embed_dim
    x = rng(1 + j).standard_normal((2, hh * ww, dim), dtype=np.float32)
    ref = JS.SwinBlock(dim, CFG.swin.num_heads[0], CFG.swin.window_size,
                       shift_size=block.shift_size,
                       mlp_ratio=CFG.swin.mlp_ratio)
    want = jit_apply(ref, v["params"]["backbone"][f"stage0_block{j}"],
                     lambda call, a: call(a, hh, ww))(x)
    assert_close(block(t(x), hh, ww), want)


def test_patch_merging_odd_sizes(tiny):
    model, _, v = tiny
    merge = model.backbone[0].layers[0].downsample
    hh, ww, dim = 7, 9, CFG.swin.embed_dim
    x = rng(3).standard_normal((2, hh * ww, dim), dtype=np.float32)
    want = jit_apply(JS.PatchMerging(dim), v["params"]["backbone"]["merge0"],
                     lambda call, a: call(a, hh, ww)[0])(x)
    got, hh2, ww2 = merge(t(x), hh, ww)
    assert (hh2, ww2) == (4, 5)
    assert_close(got, want)


def test_swin_backbone(tiny):
    model, jcfg, v = tiny
    img = rng(4).standard_normal((1, *CANVAS, 3), dtype=np.float32)
    want = jit_apply(JS.SwinTransformer(jcfg.swin), v["params"]["backbone"])(
        img)
    got = model.backbone[0](t(img))
    assert sorted(got) == sorted(want) == list(CFG.swin.out_indices)
    for stage, feat in got.items():
        assert_close(feat, want[stage])


# ---- transformer pieces ------------------------------------------------------


@pytest.mark.parametrize("form", ["2d_mask", "3d_mask_and_padding"])
def test_multihead_attention(tiny, form):
    """Masked logits take the float's min: a fully masked row (query 0 in
    the 2-d form) is uniform, not NaN."""
    model, _, v = tiny
    mha = model.transformer.decoder.layers[0].self_attn
    g = rng(5)
    b, lq, lk, h = 2, 5, 7, CFG.nheads
    q = g.standard_normal((b, lq, 256), dtype=np.float32)
    k = g.standard_normal((b, lk, 256), dtype=np.float32)
    val = g.standard_normal((b, lk, 256), dtype=np.float32)
    if form == "2d_mask":
        mask = g.random((lq, lk)) < 0.4
        mask[0] = True
        kpm = None
    else:
        mask = g.random((b * h, lq, lk)) < 0.3
        kpm = np.zeros((b, lk), bool)
        kpm[1, -3:] = True
    want = jit_apply(JT.MultiheadAttention(256, h),
                     v["params"]["dec_0"]["self_attn"])(q, k, val, mask, kpm)
    got = mha(t(q), t(k), t(val), t(mask), None if kpm is None else t(kpm))
    assert torch.isfinite(got).all()
    assert_close(got, want)


def test_bi_attention_block(tiny):
    """Global-max shift, +-50000 clip, both masks; random layer-scale gammas
    so the fusion's updates reach the output."""
    model, _, v = tiny
    block = model.transformer.encoder.fusion_layers[0]
    g = rng(6)
    vis = g.standard_normal((2, 30, 256), dtype=np.float32)
    lang = g.standard_normal((2, T_LEN, 256), dtype=np.float32)
    mask_v = np.zeros((2, 30), bool)
    mask_v[0, 20:] = True
    mask_l = np.ones((2, T_LEN), bool)
    mask_l[:, :3] = False
    ref = JT.BiAttentionBlock(256, 256, CFG.dim_feedforward // 2,
                              CFG.nheads // 2)
    want = jit_apply(ref, v["params"]["fusion_0"])(vis, lang, mask_v, mask_l)
    got = block(t(vis), t(lang), t(mask_v), t(mask_l))
    for a, b in zip(got, want):
        assert_close(a, b)


def _memory(seed):
    g = rng(seed)
    rows = sum(h * w for h, w in SHAPES)
    mem = g.standard_normal((2, rows, 256), dtype=np.float32)
    mask = np.zeros((2, rows), bool)
    mask[1, g.choice(rows, 20, replace=False)] = True
    return g, mem, mask


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn(tiny, ref_dim):
    """2-d references (the encoder's), 4-d boxes (the decoder's); padded
    value rows zeroed."""
    model, _, v = tiny
    g, mem, mask = _memory(7)
    q = g.standard_normal((2, 11, 256), dtype=np.float32)
    refs = g.uniform(0.05, 0.95, (2, 11, 4, ref_dim)).astype(np.float32)
    layer, path = ((model.transformer.encoder.layers[0].self_attn,
                    ("enc_0", "self_attn")) if ref_dim == 2 else
                   (model.transformer.decoder.layers[0].cross_attn,
                    ("dec_0", "cross_attn")))
    ref = JT.MSDeformAttn(256, CFG.num_feature_levels, CFG.nheads,
                          CFG.enc_n_points)
    want = jit_apply(ref, v["params"][path[0]][path[1]],
                     lambda call, *a: call(*a[:3], SHAPES, a[3]))(
        q, refs, mem, mask)
    assert_close(layer(t(q), t(refs), t(mem), SHAPES, t(mask)), want)


def test_text_encoder_layer(tiny):
    """The text self-mask is ~eye: each token attends to itself only."""
    model, _, v = tiny
    g = rng(8)
    src = g.standard_normal((2, T_LEN, 256), dtype=np.float32)
    pos = g.standard_normal((2, T_LEN, 256), dtype=np.float32)
    mask = ~np.eye(T_LEN, dtype=bool)
    ref = JT.TextEncoderLayer(256, CFG.nheads // 2, CFG.dim_feedforward // 2)
    want = jit_apply(ref, v["params"]["text_0"])(src, mask, pos)
    got = model.transformer.encoder.text_layers[0](t(src), t(mask), t(pos))
    assert_close(got, want)


def test_encoder_layer(tiny):
    model, _, v = tiny
    g, mem, mask = _memory(9)
    pos = g.standard_normal(mem.shape, dtype=np.float32)
    ratios = np.array([[[1.0, 1.0]] * 4, [[0.8, 0.75]] * 4], np.float32)
    refs = _np(PT.encoder_reference_points(SHAPES, t(ratios)))
    ref = JT.EncoderLayer(256, CFG.dim_feedforward, CFG.num_feature_levels,
                          CFG.nheads, CFG.enc_n_points)
    want = jit_apply(ref, v["params"]["enc_0"],
                     lambda call, *a: call(*a[:3], SHAPES, a[3]))(
        mem, pos, refs, mask)
    got = model.transformer.encoder.layers[0](t(mem), t(pos), t(refs),
                                              SHAPES, t(mask))
    assert_close(got, want)


def test_decoder_layer(tiny):
    """Group self-mask (B*H, Lq, Lq), text padding, 4-d references."""
    model, _, v = tiny
    g, mem, mask = _memory(10)
    lq = 2 * 3
    tgt = g.standard_normal((2, lq, 256), dtype=np.float32)
    qpos = g.standard_normal((2, lq, 256), dtype=np.float32)
    refs = g.uniform(0.1, 0.9, (2, lq, 4, 4)).astype(np.float32)
    text = g.standard_normal((2, T_LEN, 256), dtype=np.float32)
    text_pad = np.zeros((2, T_LEN), bool)
    text_pad[:, 5:] = True
    kvis = np.array([[1.0, 0.0], [1.0, 1.0]], np.float32)
    self_mask = np.repeat(_np(PU.keypoint_group_attn_mask(t(kvis), 2)),
                          CFG.nheads, axis=0)
    ref = JT.DecoderLayer(256, CFG.dim_feedforward, CFG.num_feature_levels,
                          CFG.nheads, CFG.dec_n_points)
    want = jit_apply(ref, v["params"]["dec_1"],
                     lambda call, *a: call(*a[:4], SHAPES, *a[4:]))(
        tgt, qpos, refs, mem, mask, text, text_pad, self_mask)
    got = model.transformer.decoder.layers[1](
        t(tgt), t(qpos), t(refs), t(mem), SHAPES, t(mask), t(text),
        t(text_pad), t(self_mask))
    assert_close(got, want)


def test_proposals_keep_their_infinities():
    """+inf at padding and out-of-range proposals, memory zeroed there."""
    g, mem, mask = _memory(11)
    mask[0, :12] = True  # the first rows of level 0 of sample 0
    want_mem, want_props = JT.gen_encoder_output_proposals(
        jnp.asarray(mem), jnp.asarray(mask), SHAPES)
    got_mem, got_props = PT.gen_encoder_output_proposals(t(mem), t(mask),
                                                         SHAPES)
    want_props = np.asarray(want_props)
    assert np.isposinf(want_props).any() and not np.isnan(want_props).any()
    np.testing.assert_array_equal(np.isposinf(_np(got_props)),
                                  np.isposinf(want_props))
    assert_close(got_props, want_props)
    assert_close(got_mem, want_mem)


def test_sine_embeddings_and_small_helpers():
    g = rng(12)
    pos4 = g.random((2, 5, 4), dtype=np.float32)
    for exchange in (True, False):
        assert_close(PT.get_sine_pos_embed(t(pos4), 64, exchange_xy=exchange),
                     JT.get_sine_pos_embed(jnp.asarray(pos4), 64,
                                           exchange_xy=exchange))
    ids = np.array([[1, 1, 0, 0]], np.float32)[..., None]
    assert_close(PT.get_sine_pos_embed(t(ids), 256, exchange_xy=False),
                 JT.get_sine_pos_embed(jnp.asarray(ids), 256,
                                       exchange_xy=False))
    for n in (2, 4):
        assert_close(PT.gen_sineembed_for_position(t(pos4[..., :n])),
                     JT.gen_sineembed_for_position(jnp.asarray(pos4[..., :n])))
    mask = np.ones((2, 9, 13), bool)
    mask[0, :7, :10] = False
    mask[1, :, :] = False
    assert_close(PU.pos_embed_sine_hw(t(mask), 64),
                 JU.pos_embed_sine_hw(jnp.asarray(mask), 64))
    x = g.uniform(-0.2, 1.2, (3, 7)).astype(np.float32)
    assert_close(PT.inverse_sigmoid(t(x)), JT.inverse_sigmoid(jnp.asarray(x)))
    ratios = np.array([[[1.0, 1.0]] * 4, [[0.8, 0.75]] * 4], np.float32)
    assert_close(PT.encoder_reference_points(SHAPES, t(ratios)),
                 JT.encoder_reference_points(SHAPES, jnp.asarray(ratios)))
    a = g.standard_normal((2, 5, 16), dtype=np.float32)
    b = g.standard_normal((2, 6, 16), dtype=np.float32)
    tm = np.array([[1, 1, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0]], bool)
    want = np.asarray(JT.contrastive_logits(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(tm)))
    got = _np(PT.contrastive_logits(t(a), t(b), t(tm)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert_close(got, want)


def test_group_mask_and_mask_resize():
    kvis = np.zeros((2, 5), np.float32)
    kvis[0, :3] = 1.0
    kvis[1, :] = 1.0
    np.testing.assert_array_equal(
        _np(PU.keypoint_group_attn_mask(t(kvis), 3)),
        np.asarray(JU.keypoint_group_attn_mask(jnp.asarray(kvis), 3)))
    mask = np.ones((1, 800, 1344), bool)
    mask[0, :600, :1000] = False
    for size in ((100, 168), (50, 84), (25, 42), (13, 21)):
        want = np.asarray(nearest_resize(
            jnp.asarray(mask[..., None].astype(np.float32)), size))[..., 0]
        np.testing.assert_array_equal(
            _np(PU.nearest_resize_mask(t(mask), size)), want > 0.5)


# ---- the whole model and the runner --------------------------------------


def _runner_inputs():
    """An image at scale 1 in the canvas (64 x 80 of 64 x 96): the JAX
    runner's cv2 resize and the port's torch resize are then both the
    identity, so the two canvases are equal."""
    g = rng(13)
    img = (g.random((64, 80, 3)) * 255).astype(np.uint8)
    ins = g.standard_normal((2, 512), dtype=np.float32)
    kpt = g.standard_normal((NUM_KPT, 512), dtype=np.float32)
    return img, ins, kpt


@pytest.fixture(scope="module")
def jax_run(tiny):
    """The JAX runner on the port's weights: its model inputs and outputs,
    its two top-k selections (indices and scores), and its results."""
    _, jcfg, variables = tiny
    img, ins, kpt = _runner_inputs()
    topk, calls = [], []
    real_top_k = jax.lax.top_k

    def recording_top_k(x, k):
        vals, idx = real_top_k(x, k)
        jax.debug.callback(
            lambda s, i: topk.append((np.asarray(s), np.asarray(i))), x, idx)
        return vals, idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", recording_top_k)
        runner = JR.XPoseRunner(params=variables, cfg=jcfg, canvas=CANVAS,
                                max_text_len=T_LEN)
        apply = runner._apply

        def recording_apply(*args):
            out = apply(*args)
            calls.append(([np.array(a) for a in args[1:]],
                          {k: np.asarray(v) for k, v in out.items()}))
            return out

        runner._apply = recording_apply
        result = runner.get_unipose_output(img, NUM_KPT, box_threshold=-1.0,
                                           ins_embed=ins, kpt_embed=kpt)
        landmarks = runner.run(img, NUM_KPT, box_threshold=-1.0,
                               ins_embed=ins, kpt_embed=kpt)
        jax.effects_barrier()
    inputs, outputs = calls[0]
    return types.SimpleNamespace(inputs=inputs, outputs=outputs,
                                 topk=topk[:2], result=result,
                                 landmarks=landmarks)


def assert_same_selection(what, got_idx, got_scores, want_idx, want_scores):
    """Equal top-k indices, in order.  On a difference, say where and how
    close the JAX scores were there: a near-tie that float drift flipped
    reads differently from a wrong selection."""
    if np.array_equal(got_idx, want_idx):
        return
    b, j = np.argwhere(got_idx != want_idx)[0]
    ranked = np.sort(want_scores[b])[::-1]
    k = want_idx.shape[-1]
    drift = float(np.abs(got_scores - want_scores).max())
    raise AssertionError(
        f"{what}: selection differs first at sample {b}, rank {j} (port "
        f"{got_idx[b, j]}, JAX {want_idx[b, j]}); JAX's scores at ranks "
        f"{max(j - 1, 0)}..{j + 1}: {ranked[max(j - 1, 0):j + 2]}, margin at "
        f"the k={k} boundary {ranked[k - 1] - ranked[k]}; the port's scores "
        f"are up to {drift} from JAX's")


def test_unipose_forward_matches_jax(tiny, jax_run):
    """Boxes, keypoints and sigmoid(logits) at 2e-4, and the query (900 of
    the proposals at full width) and group (50 of 900) selections equal in
    order."""
    model, _, _ = tiny
    with torch.inference_mode():
        got = model(*[t(a) for a in jax_run.inputs])
    want = jax_run.outputs
    (q_scores, q_idx), (g_scores, g_idx) = jax_run.topk
    assert got["query_idx"].shape == (1, CFG.num_queries)
    assert_same_selection("query selection", _np(got["query_idx"]),
                          _np(got["query_scores"]), q_idx, q_scores)
    assert_same_selection("group selection", _np(got["group_idx"]),
                          _np(got["group_scores"]), g_idx, g_scores)
    assert_close(got["query_scores"], q_scores, rtol=2e-4, atol=2e-4 * max(
        1.0, float(np.abs(q_scores).max())))
    assert_close(got["pred_boxes"], want["pred_boxes"])
    assert_close(got["pred_keypoints"], want["pred_keypoints"])
    assert_close(got["pred_logits"].sigmoid(),
                 np.asarray(jax.nn.sigmoid(want["pred_logits"])))
    assert got["pred_keypoints"].shape == (1, CFG.num_group,
                                           3 * CFG.num_body_points)


def test_runner_matches_jax(tiny, jax_run):
    model, _, _ = tiny
    img, ins, kpt = _runner_inputs()
    runner = XPoseRunner(state_dict=model.state_dict(), cfg=CFG,
                         canvas=CANVAS, max_text_len=T_LEN, device="cpu")
    boxes, kpts, scores = runner.get_unipose_output(
        img, NUM_KPT, box_threshold=-1.0, ins_embed=ins, kpt_embed=kpt)
    want = jax_run.result
    assert boxes.shape == want[0].shape and kpts.shape[-1] == 2 * NUM_KPT
    for a, b in zip((boxes, kpts, scores), want):
        assert_close(a, b)
    lmk = runner.run(img, NUM_KPT, box_threshold=-1.0, ins_embed=ins,
                     kpt_embed=kpt)
    assert lmk.shape == (NUM_KPT, 2) and np.isfinite(lmk).all()
    # pixel coordinates: 2e-4 of the image's size
    assert_close(lmk, jax_run.landmarks, rtol=2e-4, atol=2e-4 * 80)


def test_unipose_from_jax_round_trip(tiny):
    """port state_dict -> convert_unipose -> unipose_from_jax gives it back
    exactly, and loads into a fresh model strictly."""
    model, _, variables = tiny
    back = unipose_from_jax(variables, CFG)
    want = model.state_dict()
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    PU.UniPose(CFG).load_state_dict(back, strict=True)


@pytest.mark.parametrize("shape,canvas", [
    ((100, 150, 3), (64, 96)),   # down
    ((30, 40, 3), (64, 128)),    # up, padded on the right
    ((64, 80, 3), (64, 96))])    # scale 1
def test_preprocess_matches_the_jax_runner(shape, canvas):
    """Bilinear half-pixel in torch, rounded to uint8, against cv2's
    INTER_LINEAR on uint8: at most one grey level apart, i.e. 1/255 over
    the smallest ImageNet std after the normalization."""
    img = (rng(14).random(shape) * 255).astype(np.uint8)
    want, want_mask, want_hw = JR.XPoseRunner.preprocess(
        types.SimpleNamespace(canvas=canvas), img)
    runner = XPoseRunner(cfg=CFG, canvas=canvas, max_text_len=T_LEN,
                         device="cpu")
    got, mask, hw = runner.preprocess(img)
    assert hw == want_hw and got.shape == (1, *canvas, 3)
    np.testing.assert_array_equal(_np(mask)[0], want_mask)
    bound = (1 / 255) / min(JR.IMAGENET_STD) + 1e-6
    assert float(np.abs(_np(got)[0] - want).max()) <= bound


def test_runner_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XPoseRunner(cfg=CFG, canvas=CANVAS, max_text_len=T_LEN)
