"""Gradients through the port's CUDA kernels.

The exact warp on the card is an autograd function whose backward is the
hand-written kernel ``warp3d_backward`` (``csrc/warp3d.cu``); its plain
version is the autograd gradient of ``F.grid_sample`` in f32.  The W8A8
warp, the W8A8 conv and MSDA have no backward and raise under grad on an
input that requires it, rather than return a result without a
``grad_fn``.

Random grids here avoid exact integer sample coordinates: at an integer the
trilinear tents have a kink, where the kernel, ``F.grid_sample`` and XLA may
each take another one-sided derivative.  Gradients are compared by max abs
error over max |ref| <= 1e-5: the kernel accumulates grad_vol with f32
atomics, in an order that changes from run to run.

The file imports nothing of the test tree and imports JAX only inside its
JAX test, so the ``cuda`` cases (the kernel against the plain gradient, the
guards on the card, one CANONICAL train step) run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_grad.py
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from canonswap_torch.ops.cuda import ms_deform_attn as MSDA
from canonswap_torch.ops.cuda import qconv as QC
from canonswap_torch.ops.cuda import warp as W

GRAD_TOL = 1e-5


def avoid_kinks(grid: torch.Tensor, sizes) -> torch.Tensor:
    """Move every grid value whose sample coordinate ((g + 1) * size - 1) / 2
    lies within 1e-3 of an integer by 4e-3 / size (2e-3 in coordinates)."""
    out = grid.clone()
    for a, size in enumerate(sizes):  # sizes in grid order (W, H, D)
        c = ((out[..., a].double() + 1) * size - 1) / 2
        near = (c - c.round()).abs() < 1e-3
        out[..., a] = torch.where(near, out[..., a] + 4e-3 / size,
                                  out[..., a])
    return out


def case(vshape, gshape, r, seed=0):
    """(vol, grid) f32 on the CPU, the grid in [-r, r] off the kinks."""
    g = torch.Generator().manual_seed(seed)
    vol = torch.randn(vshape, generator=g)
    grid = (torch.rand(gshape, generator=g) * 2 - 1) * r
    d, h, w = vshape[2:]
    return vol, avoid_kinks(grid, (w, h, d))


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# --- on the CPU -------------------------------------------------------------


def test_plain_backward_matches_jax_gradient():
    """The plain gradient (F.grid_sample's) equals the JAX package's:
    ``jax.grad`` of ``grid_sample_3d_ref``, off the kinks, points outside
    the volume included."""
    import jax
    import jax.numpy as jnp

    from canonswap_tpu.ops.grid_sample import grid_sample_3d_ref

    vol, grid = case((2, 4, 5, 6, 7), (2, 3, 4, 5, 3), 1.2, seed=1)
    gout = torch.randn((2, 4, 3, 4, 5), generator=torch.Generator()
                       .manual_seed(2))
    gv, gg = W.warp3d_backward_plain(vol, grid, gout)

    def f(v, g):  # the JAX reference takes NDHWC and returns NDHWC
        out = grid_sample_3d_ref(v, g)
        return jnp.sum(out * jnp.asarray(np.moveaxis(gout.numpy(), 1, -1)))

    jv, jg = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(np.moveaxis(vol.numpy(), 1, -1)), jnp.asarray(grid))
    assert rel(gv, torch.from_numpy(np.moveaxis(np.array(jv), -1, 1).copy())) \
        <= GRAD_TOL
    assert rel(gg, torch.from_numpy(np.array(jg))) <= GRAD_TOL


def test_autograd_function_calls_the_backward_entry(monkeypatch):
    """``Warp3d`` launches the forward, saves its inputs, and in backward
    calls the backward entry once with contiguous f32 tensors of the right
    shapes; the launches are replaced by the plain versions here."""
    calls = []

    def fwd(vol, grid, out):
        calls.append(("fwd", tuple(vol.shape), tuple(grid.shape),
                      tuple(out.shape)))
        out.copy_(W.grid_sample_3d_plain(vol, grid))

    def bwd(vol, grid, gout, gvol, ggrid):  # writes both outputs whole
        calls.append(("bwd", tuple(vol.shape), tuple(grid.shape),
                      tuple(gout.shape), tuple(gvol.shape),
                      tuple(ggrid.shape), gout.is_contiguous(),
                      gvol.is_contiguous() and ggrid.is_contiguous()))
        v, g = W.warp3d_backward_plain(vol, grid, gout)
        gvol.copy_(v)
        ggrid.copy_(g)

    monkeypatch.setattr(W, "_check_cuda_args", lambda vol, grid: None)
    monkeypatch.setattr(W, "_launch_forward", fwd)
    monkeypatch.setattr(W, "_launch_backward", bwd)
    vol, grid = case((2, 3, 4, 5, 6), (2, 2, 3, 4, 3), 1.1)
    vol.requires_grad_()
    grid.requires_grad_()
    out = W.Warp3d.apply(vol, grid)
    assert out.grad_fn is not None and out.shape == (2, 3, 2, 3, 4)
    gout = torch.randn(out.shape).permute(0, 1, 4, 3, 2).contiguous() \
        .permute(0, 1, 4, 3, 2)  # a non-contiguous incoming gradient
    out.backward(gout)
    assert calls == [
        ("fwd", (2, 3, 4, 5, 6), (2, 2, 3, 4, 3), (2, 3, 2, 3, 4)),
        ("bwd", (2, 3, 4, 5, 6), (2, 2, 3, 4, 3), (2, 3, 2, 3, 4),
         (2, 3, 4, 5, 6), (2, 2, 3, 4, 3), True, True)]
    gv, gg = W.warp3d_backward_plain(vol, grid, gout)
    assert rel(vol.grad, gv) == 0.0 and rel(grid.grad, gg) == 0.0


def test_autograd_function_returns_only_the_needed_gradients(monkeypatch):
    monkeypatch.setattr(W, "_check_cuda_args", lambda vol, grid: None)
    monkeypatch.setattr(W, "_launch_forward", lambda v, g, o: o.copy_(
        W.grid_sample_3d_plain(v, g)))
    monkeypatch.setattr(W, "_launch_backward", lambda v, g, go, gv, gg: (
        gv.fill_(1.0), gg.fill_(2.0)))
    vol, grid = case((1, 2, 3, 3, 3), (1, 2, 2, 2, 3), 1.0)
    W.Warp3d.apply(vol, grid.requires_grad_()).sum().backward()
    assert vol.grad is None and bool((grid.grad == 2.0).all())


def test_cuda_wrapper_routes_grad_through_the_function(monkeypatch):
    """Under grad mode with an input that requires grad the wrapper takes
    the autograd function (f32 only, else it raises naming the op); with no
    grad needed it launches the forward alone."""
    monkeypatch.setattr(W, "_check_cuda_args", lambda vol, grid: None)
    monkeypatch.setattr(W, "_launch_forward", lambda v, g, o: o.copy_(
        W.grid_sample_3d_plain(v, g)))
    vol, grid = case((1, 2, 3, 3, 3), (1, 2, 2, 2, 3), 1.0)
    assert W.grid_sample_3d_cuda(vol, grid).grad_fn is None
    assert W.grid_sample_3d_cuda(vol.requires_grad_(), grid).grad_fn \
        is not None
    with torch.no_grad():
        assert W.grid_sample_3d_cuda(vol, grid).grad_fn is None
    with pytest.raises(TypeError, match="warp3d_backward takes float32"):
        W.grid_sample_3d_cuda(vol.detach().bfloat16().requires_grad_(),
                              grid)


def test_backward_wrapper_refuses_what_the_kernel_does_not_take(
        monkeypatch):
    launched = []
    monkeypatch.setattr(W, "_check_cuda_args", lambda vol, grid: None)
    monkeypatch.setattr(W, "_launch_backward", lambda *a: launched.append(a))
    vol, grid = case((1, 2, 3, 3, 3), (1, 2, 2, 2, 3), 1.0)
    gout = torch.zeros((1, 2, 2, 2, 2))
    with pytest.raises(TypeError, match="float32 only"):
        W.warp3d_backward_cuda(vol.bfloat16(), grid, gout)
    with pytest.raises(ValueError, match="contiguous grad_out"):
        W.warp3d_backward_cuda(vol, grid, gout[..., :1])
    assert not launched
    W.warp3d_backward_cuda(vol, grid, gout)
    assert len(launched) == 1


@pytest.mark.parametrize("c", [1, 4, 5, 32, 33])
def test_backward_scratch_layout(c):
    """Cp is C rounded up to 4; the scratch is the channels-last volume and
    the accumulator, (2, B, D, H, W, Cp) f32 contiguous on vol's device,
    the accumulator starting on 16 bytes (its corner rows are float4s)."""
    vol = torch.zeros((2, c, 3, 5, 7))
    cp, scratch = W.backward_scratch(vol)
    assert cp % 4 == 0 and c <= cp < c + 4
    assert tuple(scratch.shape) == (2, 2, 3, 5, 7, cp)
    assert scratch.dtype == torch.float32 and scratch.is_contiguous()
    assert scratch.device == vol.device
    assert scratch[1].data_ptr() % 16 == 0 and scratch[0].data_ptr() % 16 == 0


def test_backward_launch_passes_shapes_and_scratch(monkeypatch):
    """The C entry gets vol, grid, grad_out, grad_vol, grad_grid and the
    scratch by address, then B, C, Cp, D, H, W, Do, Ho, Wo: the output grid
    may differ from the volume in every axis."""
    seen = []
    monkeypatch.setattr(W.WARP3D_BWD, "launch_on",
                        lambda device, *a: seen.append((device, a)))
    vol = torch.zeros((2, 5, 3, 7, 9))
    grid = torch.zeros((2, 4, 6, 11, 3))
    gout = torch.zeros((2, 5, 4, 6, 11))
    gv, gg = torch.empty_like(vol), torch.empty_like(grid)
    W._launch_backward(vol, grid, gout, gv, gg)
    ((device, args),) = seen
    assert device == vol.device
    assert args[:5] == tuple(t.data_ptr() for t in (vol, grid, gout, gv, gg))
    assert args[5] not in args[:5]
    assert args[6:] == (2, 5, 8, 3, 7, 9, 4, 6, 11)


def test_backward_wrapper_leaves_the_outputs_to_the_kernel(monkeypatch):
    """grad_vol and grad_grid are allocated empty (no zeros_like, no
    memset: the kernel writes them whole) and returned as the launch left
    them; with nothing to sample (C = 0 or an empty volume) there is no
    launch and both are zeros."""
    def no_zeros(*a, **k):
        raise AssertionError("zeros_like: the kernel writes grad_vol whole")

    launched = []

    def launch(vol, grid, gout, gv, gg):
        launched.append((gv.data_ptr(), gg.data_ptr()))
        gv.fill_(7.0)
        gg.fill_(-3.0)

    monkeypatch.setattr(W, "_check_cuda_args", lambda vol, grid: None)
    monkeypatch.setattr(W, "_launch_backward", launch)
    monkeypatch.setattr(torch, "zeros_like", no_zeros)
    vol, grid = case((1, 3, 4, 5, 6), (1, 2, 3, 4, 3), 1.0)
    gv, gg = W.warp3d_backward_cuda(vol, grid, torch.ones((1, 3, 2, 3, 4)))
    assert launched == [(gv.data_ptr(), gg.data_ptr())]
    assert bool((gv == 7.0).all()) and bool((gg == -3.0).all())
    assert gv.shape == vol.shape and gg.shape == grid.shape
    assert gv.is_contiguous() and gg.is_contiguous()
    for vshape in ((1, 0, 4, 5, 6), (1, 3, 0, 5, 6)):
        v = torch.ones(vshape)
        gout = torch.ones((1, vshape[1], 2, 3, 4))
        gv, gg = W.warp3d_backward_cuda(v, grid, gout)
        assert gv.shape == vshape and bool((gg == 0).all())
        assert bool((gv == 0).all())
    assert len(launched) == 1


def _quant_warp_args(requires_grad):
    vol, grid = case((1, 2, 3, 3, 3), (1, 2, 2, 2, 3), 1.0)
    return (vol.requires_grad_(requires_grad), grid)


def _qconv_args(requires_grad):
    x = torch.zeros((1, 4, 5, 5))
    w = torch.zeros((4, 4, 3, 3), requires_grad=requires_grad)
    return (x, w, torch.zeros(4))


def _msda_args(requires_grad):
    value = torch.zeros((1, 4, 1, 8), requires_grad=requires_grad)
    loc = torch.zeros((1, 3, 1, 1, 2, 2))
    attn = torch.zeros((1, 3, 1, 1, 2))
    return (value, [(2, 2)], loc, attn)


GUARDED = {
    "warp3d_q": (W, "WARP3D_Q", W.grid_sample_3d_quant_cuda,
                 _quant_warp_args),
    "qconv": (QC, "QCONV", QC.conv_w8a8_cuda, _qconv_args),
    "ms_deform_attn": (MSDA, "MSDA", MSDA.ms_deform_attn_cuda, _msda_args),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernels_without_a_backward_raise_under_grad(name, monkeypatch):
    """Before any check or launch: the launch is a stub that records."""
    module, attr, fn, make_args = GUARDED[name]
    launched = []
    monkeypatch.setattr(getattr(module, attr), "launch_on",
                        lambda *a: launched.append(a))
    with pytest.raises(RuntimeError, match="has no backward") as err:
        fn(*make_args(True))
    assert "int8 flags off" in str(err.value) and "XPose" in str(err.value)
    assert not launched
    # without grad mode, or with no input that requires grad, the guard is
    # silent and the CUDA checks refuse the CPU tensors
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*make_args(True))
    with pytest.raises(ValueError, match="CUDA"):
        fn(*make_args(False))
    assert not launched


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def smooth(b, d, h, w, scale, seed, kinks=False):
    """Identity (cell centres) plus a small random displacement; off the
    kinks unless ``kinks``."""
    g = torch.Generator().manual_seed(seed)
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) / n * 2 - 1
            for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    ident = torch.stack([xx, yy, zz], -1)[None].float()
    grid = ident + (torch.rand((b, d, h, w, 3), generator=g) * 2 - 1) * scale
    return grid if kinks else avoid_kinks(grid, (w, h, d))


def turned_grid(b, d, h, w, turn=0.2, scale=0.9, shift=0.05):
    """The cell centres turned by ``turn`` rad about z, scaled and shifted:
    a smooth field whose neighbouring points fall on neighbouring voxels."""
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) / n * 2 - 1
            for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    cos, sin = math.cos(turn), math.sin(turn)
    gx = scale * (cos * xx - sin * yy) + shift
    gy = scale * (sin * xx + cos * yy) + shift
    grid = torch.stack([gx, gy, zz * scale + shift], -1)[None]
    return grid.expand(b, -1, -1, -1, -1).float().contiguous()


BWD_CASES = {
    # (vol shape, field, its range or displacement, output grid (Do, Ho, Wo)
    # where it differs from the volume's)
    # the training path's shape (CANONICAL, B=1 here), both fields
    "canonical_smooth": ((1, 32, 16, 64, 64), "smooth", 0.05, None),
    "canonical_random": ((1, 32, 16, 64, 64), "uniform", 1.0, None),
    # ragged, many points outside the volume
    "ragged_outside": ((2, 5, 3, 7, 9), "uniform", 1.6, (4, 6, 5)),
    # the smooth field with 10 % of its points redrawn uniform in [-1, 1]
    "mixed": ((1, 32, 16, 64, 64), "mixed", 0.05, None),
    # the cell centres turned by 0.2 rad, scaled by 0.9: a head turning
    "turned": ((1, 32, 16, 64, 64), "turned", 0.0, None),
    # a violent deformation: displacements up to half the volume
    "overflow": ((1, 32, 16, 64, 64), "smooth", 0.5, None),
    # every point outside the volume on every axis: both gradients 0
    "all_outside": ((2, 8, 4, 8, 8), "outside", 1.4, None),
    # the cell centres exactly: every coordinate an integer, at the tents'
    # kinks, where the kernel takes the cell above as F.grid_sample does
    "integer_coordinates": ((1, 32, 16, 64, 64), "identity", 0.0, None),
    # C not a multiple of 4, at the training shape's spatial size
    "ragged_c5": ((1, 5, 16, 64, 64), "smooth", 0.05, None),
    # two channel chunks with a tail, tiles overhanging Ho and Wo
    "tile_edges_c40": ((1, 40, 5, 9, 37), "uniform", 1.1, (3, 7, 45)),
}


def bwd_case(name):
    """(vol, grid) of a BWD_CASES case, f32 on the CPU."""
    vshape, kind, r, out = BWD_CASES[name]
    b, _, d, h, w = vshape
    if kind == "uniform":
        return case(vshape, (b, *(out or (d, h, w)), 3), r, seed=5)
    vol, _ = case(vshape, (1, 1, 1, 1, 3), 1.0, seed=3)
    if kind == "turned":
        return vol, avoid_kinks(turned_grid(b, d, h, w), (w, h, d))
    if kind == "outside":
        g = torch.rand((b, d, h, w, 3),
                       generator=torch.Generator().manual_seed(4)) * 2 - 1
        return vol, g.sign() * r + g * 0.1  # |g| > 1.4 on every axis
    grid = smooth(b, d, h, w, r, seed=4, kinks=kind == "identity")
    if kind == "mixed":
        g = torch.Generator().manual_seed(5)
        rand = avoid_kinks(torch.rand(grid.shape, generator=g) * 2 - 1,
                           (w, h, d))
        pick = torch.rand((*grid.shape[:-1], 1), generator=g) < 0.1
        grid = torch.where(pick, rand, grid)
    return vol, grid


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_kernel_matches_plain(cuda, name):
    vol, grid = bwd_case(name)
    gout = torch.randn((*vol.shape[:2], *grid.shape[1:4]),
                       generator=torch.Generator().manual_seed(6))
    vol, grid, gout = vol.to(cuda), grid.to(cuda), gout.to(cuda)
    before = W.WARP3D_BWD.launches
    gv, gg = W.warp3d_backward_cuda(vol, grid, gout)
    torch.cuda.synchronize()
    assert W.WARP3D_BWD.launches == before + 1
    pv, pg = W.warp3d_backward_plain(vol, grid, gout)
    assert rel(gv, pv) <= GRAD_TOL, rel(gv, pv)
    assert rel(gg, pg) <= GRAD_TOL, rel(gg, pg)
    if BWD_CASES[name][1] == "outside":
        assert not bool(gv.any()) and not bool(gg.any())


def test_backward_cases_reach_what_they_name():
    """On the CPU, what each card case is for: the share of points inside
    the volume, the integer coordinates, the output grids' shapes."""
    inside = {}
    for name in BWD_CASES:
        vol, grid = bwd_case(name)
        assert grid.shape[0] == vol.shape[0] and grid.shape[-1] == 3
        inside[name] = float((grid.abs() <= 1).all(-1).float().mean())
    assert inside["all_outside"] == 0.0 and inside["canonical_smooth"] > 0.9
    assert 0.8 < inside["mixed"] < 1.0
    _, grid = bwd_case("integer_coordinates")
    d, h, w = grid.shape[1:4]
    for a, size in enumerate((w, h, d)):
        c = ((grid[..., a].double() + 1) * size - 1) / 2
        assert float((c - c.round()).abs().max()) < 1e-4
    assert bwd_case("tile_edges_c40")[1].shape[1:4] == (3, 7, 45)
    assert bwd_case("ragged_c5")[0].shape[1] == 5


@pytest.mark.cuda
def test_autograd_through_the_kernel_on_the_card(cuda):
    """A warp output from inputs that require grad has a grad_fn, and its
    gradients are the plain version's: the fault of a kernel that cut
    autograd is repaired."""
    vol, grid = case((2, 8, 4, 16, 16), (2, 4, 16, 16, 3), 1.05, seed=7)
    vol = vol.to(cuda).requires_grad_()
    grid = grid.to(cuda).requires_grad_()
    fwd, bwd = W.WARP3D.launches, W.WARP3D_BWD.launches
    out = W.grid_sample_3d(vol, grid)
    assert out.grad_fn is not None
    gout = torch.randn(out.shape, device=cuda)
    out.backward(gout)
    torch.cuda.synchronize()
    assert (W.WARP3D.launches - fwd, W.WARP3D_BWD.launches - bwd) == (1, 1)
    pv, pg = W.warp3d_backward_plain(vol, grid, gout)
    assert rel(vol.grad, pv) <= GRAD_TOL
    assert rel(grid.grad, pg) <= GRAD_TOL
    with pytest.raises(TypeError, match="warp3d_backward takes float32"):
        W.grid_sample_3d(vol.detach().bfloat16().requires_grad_(),
                         grid.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernels_without_a_backward_raise_on_the_card(cuda, name):
    _, _, fn, make_args = GUARDED[name]
    args = [a.to(cuda) if isinstance(a, torch.Tensor) else a
            for a in make_args(False)]
    args[0] = args[0].requires_grad_() if args[0].is_floating_point() \
        else args[0]
    if name == "qconv":
        args[1] = args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(*args)


@pytest.mark.cuda
def test_canonical_train_step_on_the_card(cuda):
    """One ``runtime/train.py`` step at CANONICAL f32, B=2: the two warps
    run the kernel forward and its backward, nothing else launches, the
    loss is finite, and the appearance encoder (upstream of the warps only)
    gets a nonzero finite gradient.  The motion heads are scaled toward
    in-range keypoints (seeded weights put them near |x_t| = 10, where the
    warp samples zero padding and passes no gradient)."""
    from canonswap_torch.configs import CANONICAL
    from canonswap_torch.runtime import core as C
    from canonswap_torch.runtime import train as T

    core = C.CanonSwapCore(CANONICAL, seed=0, device="cpu")
    det = core.motion_extractor.detector
    with torch.no_grad():
        for name in ("fc_kp", "fc_pitch", "fc_yaw", "fc_roll", "fc_t",
                     "fc_exp", "fc_scale"):
            getattr(det, name).weight *= 0.01
            getattr(det, name).bias.zero_()
        det.fc_kp.bias.uniform_(-0.5, 0.5,
                                generator=torch.Generator().manual_seed(1))
        det.fc_scale.bias.fill_(1.0)
    core.to(cuda)
    leaves = T.trainable(core)
    opt = T.make_optimizer(leaves)
    g = torch.Generator().manual_seed(2)
    frames = torch.rand((2, 256, 256, 3), generator=g).to(cuda)
    sid = torch.randn((2, CANONICAL.swap.latent_dim), generator=g).to(cuda)
    kernels = (W.WARP3D, W.WARP3D_BWD, W.WARP3D_Q, QC.QCONV, MSDA.MSDA)
    before = [k.launches for k in kernels]
    metrics = T.train_step(core, leaves, opt, frames, sid)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [2, 2, 0, 0,
                                                                  0]
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for name, p in core.appearance_feature_extractor.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
        assert bool((p.grad != 0).any()), name
