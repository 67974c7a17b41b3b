"""The port's training step, live spectral norm, ``to_jax`` and the
``.npz`` checkpoints against the JAX package, at TINY in f32 on the CPU.

One JAX parameter tree (``CanonSwapCore(TINY).init_params`` at key 0,
jitted, every leaf then redrawn by ``randomized``) and one numpy-seeded B=2
batch serve the file's step tests, through one jitted JAX step in f64
(``jax.value_and_grad(train.loss_fn)``, then optax's
``clip_by_global_norm(1.0)`` and ``adam(1e-4)``, under
``jax.enable_x64``): the reference.  The port's core gets the tree through
``from_jax`` and takes the same step in f32, and in f64.  The leaves are
redrawn because flax's init (zero biases, identity BatchNorms) leaves exact
zeros in front of the leaky ReLUs wherever the warp samples outside the
volume, and there the two frameworks take different one-sided derivatives
(JAX slope 1 at 0, PyTorch the negative slope): the gradients of
``warping_module/third`` then differ by 83 % of their largest, in f64 too.

Tolerances.  The loss terms at rtol = atol = 2e-4 (the port's).  The two
f64 steps agree within 2e-4 of each leaf's largest gradient or 1e-6 of the
tree's (the JAX motion extractor casts its keypoints to f32 under x64
too).  The port's f32 gradients, and its parameters after the Adam step,
within that plus three times the port's own f32 rounding on each leaf (its
f32 step against its f64 one).  The allowance, and its reason: a backward
pass through the whole generator rounds to a fraction of the tree's
largest gradient, not of each leaf's, so on most leaves an f32 gradient
lies 1e-3 to 3e-2 of the leaf's largest from the f64 one (measured, in
either package); most on the leaves whose gradient is 1e-6 to 1e-3 of the
tree's (the SPADE norms' ``mlp_*``, the dense-motion hourglass's
BatchNorms and convs, ``transfer``'s ``mask_conv`` and ``style_fc*``,
``refine``'s norms) and on the biases whose exact gradient is zero because
a normalization follows them (the SPADE blocks' ``conv_0`` / ``conv_1``
and ``fc`` biases, the conv biases of ``refine/res3d_in_*`` and
``res3d_out_*``).  Measured at this tree and batch, the largest error is
0.3 (gradients) and 0.5 (parameters) of its bound."""

from __future__ import annotations

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from canonswap_torch.configs import SpadeConfig, TINY
from canonswap_torch.models.spade_decoder import SPADEDecoder
from canonswap_torch.nn.spectral import SNConv2d, spectral_normalize
from canonswap_torch.pipelines.session import load_core_checkpoint
from canonswap_torch.runtime import checkpoint as PCK
from canonswap_torch.runtime import core as C
from canonswap_torch.runtime import train as T
from canonswap_torch.runtime import weights as PW
from canonswap_tpu.configs import model_config as JMC
from canonswap_tpu.models.spade_decoder import SPADEDecoder as JSPADEDecoder
from canonswap_tpu.nn import spectral as JS
from canonswap_tpu.runtime import checkpoint as JCK
from canonswap_tpu.runtime import core as JC
from canonswap_tpu.runtime import train as JT
from tests.helpers.torch_parity import (assert_close, one_torch_thread,
                                        randomized, rng, t)

B = 2
LEAF_TOL = 2e-4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread(one_torch_thread):
    pass


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    return PCK.flatten(tree, prefix)


@pytest.fixture(scope="module")
def jax_params():
    return randomized(_np(jax.jit(JC.CanonSwapCore(JMC.TINY).init_params)(
        jax.random.PRNGKey(0))), 1)


@pytest.fixture(scope="module")
def batch():
    g = rng(0)
    frames = g.random((B, TINY.input_size, TINY.input_size, 3),
                      dtype=np.float32)
    sid = g.standard_normal((B, TINY.swap.latent_dim), dtype=np.float32)
    return frames, sid


def _jax_step(params, batch, dtype):
    """The JAX step's metrics, gradients and parameters after Adam."""
    core = JC.CanonSwapCore(JMC.TINY)
    tx = JT.make_optimizer(LR)

    @jax.jit
    def step(params, frames, sid):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: JT.loss_fn(core, p, frames, sid), has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return metrics, grads, optax.apply_updates(params, updates)

    cast = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), params)
    metrics, grads, new = step(cast, *(jnp.asarray(x, dtype) for x in batch))
    return ({k: float(v) for k, v in metrics.items()},
            _leaves(_np(grads)), _leaves(_np(new)))


def _port_step(params, batch, dtype):
    """The port's step: the same three."""
    core = C.CanonSwapCore(TINY, seed=None, device="cpu")
    core.load_state_dict(PW.from_jax(params), strict=True)
    core.to(dtype)
    leaves = T.trainable(core)
    frames, sid = (t(x).to(dtype) for x in batch)
    metrics = T.train_step(core, leaves, T.make_optimizer(leaves, LR), frames,
                           sid)
    # train_step clipped the gradients in place: undo the clip's scale
    scale = T.MAX_GRAD_NORM / max(T.MAX_GRAD_NORM, float(metrics["grad_norm"]))
    grads = PW.to_jax({k: v.grad / scale for k, v in leaves.items()})
    return ({k: float(v) for k, v in metrics.items()}, _leaves(grads),
            _leaves(PW.to_jax(core.state_dict())))


@pytest.fixture(scope="module")
def steps(jax_params, batch):
    """{(package, dtype): (metrics, gradients, parameters after Adam)}."""
    out = {("port", 32): _port_step(jax_params, batch, torch.float32),
           ("port", 64): _port_step(jax_params, batch, torch.float64)}
    with jax.enable_x64(True):
        out["jax", 64] = _jax_step(jax_params, batch, jnp.float64)
    return out


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _f64_bounds(want: dict) -> dict:
    """Per leaf: 2e-4 of its largest |value| or 1e-6 of the tree's."""
    top = max(float(np.abs(v).max()) for v in want.values())
    return {k: max(LEAF_TOL * float(np.abs(v).max()), 1e-6 * top)
            for k, v in want.items()}


def _assert_leaves_match(steps, part: int) -> None:
    """The port's f32 step against the JAX f64 step on every leaf of
    ``part`` (1: gradients, 2: parameters after Adam), within the f64
    bound plus three times the port's own f32-vs-f64 distance there (the
    module docstring)."""
    p32, p64, want = (steps[k][part] for k in (
        ("port", 32), ("port", 64), ("jax", 64)))
    assert p32.keys() == want.keys()
    bounds = _f64_bounds(want)
    for k, w in want.items():
        err = _dist(p32[k], w)
        bound = bounds[k] + 3 * _dist(p32[k], p64[k])
        assert err <= bound, (k, err, bound)


def test_loss_terms_match_jax(steps):
    want = steps["jax", 64][0]
    for k, got in steps["port", 32][0].items():
        if k != "grad_norm":
            assert_close(np.float32(got), np.float32(want[k]))


def test_gradients_match_jax(steps):
    """Every leaf the JAX step differentiates, batch_stats included."""
    _assert_leaves_match(steps, 1)
    # the gradients' norm is above 1, so the clip is exercised
    assert steps["port", 32][0]["grad_norm"] > 1.0


def test_parameters_after_one_step_match_jax(steps):
    _assert_leaves_match(steps, 2)


def test_f64_steps_agree(steps):
    """Without f32 rounding the two steps agree: the loss terms at 1e-6,
    every gradient within 2e-4 of its leaf's largest or 1e-6 of the tree's.
    Not tighter: the JAX motion extractor casts its keypoints to f32 under
    x64 too (``canonswap_tpu/models/motion.py:43``), which rounds the
    gradients upstream of them at up to 9e-7 of the tree's largest
    (measured)."""
    (pm, pg, _), (jm, jg, _) = steps["port", 64], steps["jax", 64]
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-6)
    bounds = _f64_bounds(jg)
    for k, want in jg.items():
        assert _dist(pg[k], want) <= bounds[k], k


def test_loss_falls_over_five_steps():
    """As tests/test_train_and_parallel.py shows for JAX: lr 1e-3 on a fixed
    batch, five steps (the range prior spikes near step 2, then settles)."""
    core = C.CanonSwapCore(TINY, seed=0, device="cpu")
    leaves = T.trainable(core)
    opt = T.make_optimizer(leaves, lr=1e-3)
    g = rng(1)
    frames = t(g.random((B, TINY.input_size, TINY.input_size, 3),
                        dtype=np.float32))
    sid = t(g.standard_normal((B, TINY.swap.latent_dim), dtype=np.float32))
    losses = [float(T.train_step(core, leaves, opt, frames, sid)["loss"])
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_matches_optax(scale):
    """Below the bound nothing moves; above it every leaf scales by 1/norm."""
    g = rng(2)
    arrays = [g.standard_normal(s).astype(np.float32) * scale
              for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(a) for a in arrays], None)
    grads = [t(a.copy()) for a in arrays]
    norm = T.clip_by_global_norm(grads)
    assert_close(norm, np.float32(np.sqrt(sum((a ** 2).sum()
                                              for a in arrays))))
    for got, w in zip(grads, want, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_adam_matches_optax_over_three_steps():
    g = rng(3)
    p0 = g.standard_normal((4, 6)).astype(np.float32)
    grads = [g.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(1e-4)
    p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    leaf = t(p0.copy()).requires_grad_()
    opt = T.make_optimizer({"w": leaf})
    for gr in grads:
        upd, state = tx.update(jnp.asarray(gr), state, p)
        p = optax.apply_updates(p, upd)
        leaf.grad = t(gr)
        opt.step()
    np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(p),
                               rtol=1e-6, atol=1e-7)


# --- live spectral norm -------------------------------------------------------


def _kernel_and_u(seed, shape=(16, 8, 3, 3)):
    g = rng(seed)
    w = g.standard_normal(shape).astype(np.float32) * 0.2
    u = g.standard_normal(shape[0]).astype(np.float32)
    return w, u / np.linalg.norm(u)


def test_spectral_normalize_matches_jax():
    """The normalized weight and the new u after one power iteration
    (torch's (O, I, kh, kw) against the JAX (kh, kw, I, O))."""
    w, u = _kernel_and_u(4)
    w_sn, u_new = spectral_normalize(t(w), t(u))
    jw, ju = JS.spectral_normalize(jnp.asarray(w.transpose(2, 3, 1, 0)),
                                   jnp.asarray(u))
    assert_close(w_sn, np.asarray(jw).transpose(3, 2, 0, 1))
    assert_close(u_new, np.asarray(ju))


def test_spectral_gradient_matches_jax():
    """sigma is differentiated through the weight along every path, as JAX
    differentiates spectral_normalize."""
    w, u = _kernel_and_u(5)
    g = rng(6).standard_normal(w.shape).astype(np.float32)
    wt = t(w).requires_grad_()
    (spectral_normalize(wt, t(u))[0] * t(g)).sum().backward()
    jg = jax.grad(lambda k: jnp.sum(JS.spectral_normalize(k, jnp.asarray(u))[0]
                                    * jnp.asarray(g.transpose(2, 3, 1, 0))))(
        jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert_close(wt.grad, np.asarray(jg).transpose(3, 2, 0, 1))


def test_snconv_forward_and_u_update_match_jax():
    """SNConv2d against the JAX SNConv: the output, u advanced in training
    mode (the JAX module's mutable ``spectral``), untouched in eval."""
    x = rng(7).standard_normal((2, 6, 8, 8)).astype(np.float32)
    jm = JS.SNConv(5, (3, 3))
    jvars = _np(jm.init(jax.random.PRNGKey(1),
                        jnp.asarray(x.transpose(0, 2, 3, 1))))
    conv = SNConv2d(6, 5, 3)
    conv.load_state_dict({
        "weight": t(jvars["params"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": t(jvars["params"]["bias"].copy()),
        "u": t(jvars["spectral"]["u"].copy())})
    jy, mut = jm.apply(jvars, jnp.asarray(x.transpose(0, 2, 3, 1)),
                       mutable=["spectral"])
    conv.eval()
    u0 = conv.u.clone()
    assert_close(conv(t(x)).detach().permute(0, 2, 3, 1), np.asarray(jy))
    assert torch.equal(conv.u, u0)
    conv.train()
    conv(t(x))
    assert_close(conv.u, np.asarray(mut["spectral"]["u"]))
    assert not torch.allclose(conv.u, u0)


def test_spade_decoder_with_spectral_norm_matches_jax():
    """``SpadeConfig.spectral_norm``: the SPADE blocks' convs live-normalized,
    the JAX tree's ``spectral`` u carried by ``from_jax``; the output, and
    every u after one training-mode forward."""
    jcfg = JMC.SpadeConfig(block_expansion=8, max_features=16,
                           out_channels=8, spectral_norm=True)
    feat = rng(8).standard_normal((1, 8, 8, 16)).astype(np.float32)
    jdec = JSPADEDecoder(jcfg)
    jvars = _np(jax.jit(jdec.init)(jax.random.PRNGKey(2), jnp.asarray(feat)))
    assert "spectral" in jvars
    jy, mut = jax.jit(lambda v, f: jdec.apply(v, f, mutable=["spectral"]))(
        jvars, jnp.asarray(feat))
    dec = SPADEDecoder(SpadeConfig(block_expansion=8, max_features=16,
                                   out_channels=8, spectral_norm=True))
    dec.load_state_dict(PW.spade_from_jax(jvars), strict=True)
    dec.eval()
    got = dec(t(feat.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    assert_close(got.detach(), np.asarray(jy))
    dec.train()
    dec(t(feat.transpose(0, 3, 1, 2)))
    want = PW.spade_from_jax(dict(jvars, spectral=_np(mut["spectral"])))
    got = dec.state_dict()
    us = [k for k in want if k.endswith(".u")]
    assert len(us) == 2 * 8 + 2  # conv_0, conv_1 per block; two conv_s
    for k in us:
        assert_close(got[k], want[k].numpy())


# --- to_jax and the .npz checkpoints -------------------------------------------


def test_to_jax_inverts_from_jax_on_the_jax_tree(jax_params):
    """JAX tree -> port state_dict -> JAX tree: every leaf equal."""
    back = PW.to_jax(PW.from_jax(jax_params))
    want = _leaves(jax_params)
    got = _leaves(back)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_from_jax_inverts_to_jax_on_the_port_state_dict():
    """Port state_dict -> JAX tree -> port state_dict: every entry equal,
    and the JAX tree is the one ``init_params`` lays out."""
    core = C.CanonSwapCore(TINY, seed=9, device="cpu")
    sd = core.state_dict()
    back = PW.from_jax(PW.to_jax(sd))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_npz_files_load_across_the_packages(jax_params, tmp_path):
    """A file the port writes loads with the JAX package's load_npz into the
    tree the port wrote; a file the JAX package writes loads with the
    port's; and the session's loader reads it into a core, strict keys."""
    core = C.CanonSwapCore(TINY, seed=10, device="cpu")
    tree = PW.to_jax(core.state_dict())
    PCK.save_npz(str(tmp_path / "port.npz"), tree)
    assert JCK.tree_equal(JCK.load_npz(str(tmp_path / "port.npz")), tree)
    JCK.save_npz(str(tmp_path / "jax.npz"), jax_params)
    assert JCK.tree_equal(PCK.load_npz(str(tmp_path / "jax.npz")),
                          jax_params)
    other = C.CanonSwapCore(TINY, seed=None, device="cpu")
    load_core_checkpoint(other, str(tmp_path / "port.npz"))
    for k, v in core.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


# --- the CLI ------------------------------------------------------------------


def _data_dir(tmp_path):
    from canonswap_torch.utils import io as PIO

    d = tmp_path / "data"
    d.mkdir()
    g = rng(11)
    np.save(d / "clip.npy", (g.random((3, 40, 48, 3)) * 255).astype(np.uint8))
    PIO.write_ppm(str(d / "img.ppm"),
                  (g.random((50, 30, 3)) * 255).astype(np.uint8))
    return d


def test_train_cli_writes_a_checkpoint_the_session_loads(tmp_path, capsys):
    from canonswap_torch.cli import train as TR

    d = _data_dir(tmp_path)
    frames = TR.load_frames(str(d), TINY.input_size)
    assert frames.shape == (4, 64, 64, 3) and frames.dtype == np.float32
    ckpt = tmp_path / "ckpt.npz"
    args = ["--data-dir", str(d), "--batch", "2", "--tiny", "--device", "cpu",
            "--ckpt-out", str(ckpt), "--log-every", "1"]
    TR.main(args + ["--steps", "2"])
    assert osp.exists(ckpt)
    out = capsys.readouterr().out
    assert "step 2/2 loss=" in out and "Saved checkpoint" in out
    core = C.CanonSwapCore(TINY, seed=None, device="cpu")
    load_core_checkpoint(core, str(ckpt))
    trained = core.state_dict()
    seeded = C.CanonSwapCore(TINY, seed=0, device="cpu").state_dict()
    assert any(not torch.equal(trained[k], seeded[k]) for k in seeded)
    # the resume path starts from the file
    TR.main(args + ["--steps", "1", "--resume", str(ckpt)])
    assert "Resumed from" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ROADMAP A 8"):
        TR.main(args + ["--steps", "1", "--model-axis", "2"])
