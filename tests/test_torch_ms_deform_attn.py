"""The port's multi-scale deformable attention: plain version vs the JAX
package (``ms_deform_attn_ref`` and the Pallas kernel in interpret mode), the
wrapper's device rule and checks, and (on a card) the CUDA kernel vs the
plain version.

The JAX cases are tests/test_ms_deform_attn.py's shapes, plus a ragged case
(Lq = 7, not a multiple of the Pallas block; locations outside [0, 1]; value
rows zeroed as a padding mask zeroes them), a wide one (D = 40, more
channels than a warp has lanes), one with more samples per query than a
warp has lanes (L * P = 36) and XPose's per-head shape (D = 32, L = P = 4)
at small levels.  Tolerance 1e-5: the same f32 sums in
another order.  JAX is imported inside those tests only, and the file
imports nothing else of the test tree, so the CUDA cases also run where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ms_deform_attn.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canonswap_torch.ops.cuda import ms_deform_attn as MS

TOL = 1e-5

# (N, M, D, spatial shapes, Lq, P, location range, zeroed value rows)
CASES = {
    "base": (2, 2, 8, ((6, 4), (3, 2)), 5, 4, (0.01, 0.99), 0),
    "ragged": (1, 3, 16, ((5, 7), (3, 4), (1, 2)), 7, 3, (-0.3, 1.3), 9),
    "wide": (1, 2, 40, ((4, 6), (2, 3)), 6, 2, (-0.1, 1.1), 4),
    # 36 samples per query: more than a warp's lanes, two passes
    "many_points": (1, 2, 8, ((4, 5), (3, 3), (2, 2)), 5, 12, (-0.1, 1.1), 3),
    # XPose's per-head shape (D = 32, L = P = 4: the kernel's unrolled
    # instantiation) at four small levels; Lq = 13 is no multiple of a
    # query tile (8 to 64)
    "xpose_head": (1, 2, 32, ((8, 12), (4, 6), (2, 3), (1, 2)), 13, 4,
                   (-0.2, 1.2), 5),
}
# on the card also: the XPose shape at N = 2
CUDA_CASES = {**CASES,
              "xpose_head_n2": (2, 2, 32, ((8, 12), (4, 6), (2, 3), (1, 2)),
                                13, 4, (-0.2, 1.2), 5)}

# the full-width shapes: Swin-T levels of the (800, 1344) canvas, M=8, D=32,
# L=P=4; Lq in the encoder and the two decoder stages
FULL_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))
FULL_LQ = {"encoder": 22323, "decoder_box": 900, "decoder_kpt": 3450}


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def make_inputs(n, m, d, shapes, lq, p, loc_range, zeroed, seed=0):
    g = np.random.default_rng(seed)
    rows = sum(h * w for h, w in shapes)
    value = g.standard_normal((n, rows, m, d), dtype=np.float32)
    if zeroed:
        value[:, g.choice(rows, zeroed, replace=False)] = 0.0
    loc = g.uniform(*loc_range, (n, lq, m, len(shapes), p, 2)).astype(
        np.float32)
    w = g.uniform(0, 1, (n, lq, m, len(shapes), p)).astype(np.float32)
    w = w / w.sum(axis=(3, 4), keepdims=True)
    return value, loc, w


def _case(name):
    n, m, d, shapes, lq, p, rng, zeroed = CUDA_CASES[name]
    return shapes, make_inputs(n, m, d, shapes, lq, p, rng, zeroed)


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_ref(name):
    import jax.numpy as jnp

    from canonswap_tpu.ops.ms_deform_attn import ms_deform_attn_ref

    shapes, (value, loc, w) = _case(name)
    want = np.asarray(ms_deform_attn_ref(jnp.asarray(value), shapes,
                                         jnp.asarray(loc), jnp.asarray(w)))
    got = MS.ms_deform_attn_plain(t(value), shapes, t(loc), t(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    import jax.numpy as jnp

    from canonswap_tpu.ops.pallas.ms_deform_attn import ms_deform_attn_pallas

    shapes, (value, loc, w) = _case(name)
    want = np.asarray(ms_deform_attn_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w),
        block_q=4, interpret=True))
    got = MS.ms_deform_attn_plain(t(value), shapes, t(loc), t(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    shapes, (value, loc, w) = _case("ragged")
    before = MS.MSDA.launches
    out = MS.ms_deform_attn(t(value), shapes, t(loc), t(w))
    assert MS.MSDA.launches == before
    torch.testing.assert_close(
        out, MS.ms_deform_attn_plain(t(value), shapes, t(loc), t(w)),
        rtol=0, atol=0)
    assert out.shape == (1, 7, 3 * 16)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Shapes, then dtype, then devices: on a machine without a card the
    CUDA path raises on each before it would build anything."""
    shapes, (value, loc, w) = _case("base")
    v, lo, wt = t(value), t(loc), t(w)
    with pytest.raises(ValueError, match="CUDA"):
        MS.ms_deform_attn_cuda(v, shapes, lo, wt)
    # a tensor on another device than the CPU takes the CUDA path
    with pytest.raises(ValueError, match="CUDA"):
        MS.ms_deform_attn(v, shapes, lo.to("meta"), wt)
    with pytest.raises(TypeError, match="float32"):
        MS.ms_deform_attn_cuda(v.double(), shapes, lo, wt)
    with pytest.raises(ValueError, match="do not fit"):
        MS.ms_deform_attn_cuda(v, shapes, lo, wt[..., :2])
    with pytest.raises(ValueError, match="cover"):
        MS.ms_deform_attn_cuda(v, ((6, 4), (3, 3)), lo, wt)
    with pytest.raises(ValueError, match="spatial shapes"):
        MS.ms_deform_attn_cuda(v, shapes[:1], lo, wt)


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(cuda, *arrays):
    return [t(a).to(cuda) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernel_matches_plain(cuda, name):
    shapes, arrays = _case(name)
    v, lo, wt = _on(cuda, *arrays)
    before = MS.MSDA.launches
    got = MS.ms_deform_attn(v, shapes, lo, wt)
    assert MS.MSDA.launches == before + 1
    want = MS.ms_deform_attn_plain(v, shapes, lo, wt)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _max_rel(got.cpu(), want.cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(FULL_LQ))
def test_kernel_matches_plain_at_full_width(cuda, stage):
    v, lo, wt = _on(cuda, *make_inputs(1, 8, 32, FULL_SHAPES, FULL_LQ[stage],
                                       4, (-0.05, 1.05), 500, seed=1))
    got = MS.ms_deform_attn_cuda(v, FULL_SHAPES, lo, wt)
    want = MS.ms_deform_attn_plain(v, FULL_SHAPES, lo, wt)
    torch.cuda.synchronize()
    assert got.shape == (1, FULL_LQ[stage], 256)
    assert _max_rel(got.cpu(), want.cpu()) <= TOL


@pytest.mark.cuda
def test_kernel_far_locations_give_zero(cuda):
    shapes, arrays = _case("base")
    v, lo, wt = _on(cuda, *arrays)
    far = torch.full_like(lo, 7.0)
    far[..., 1] = -3.0
    assert torch.count_nonzero(MS.ms_deform_attn(v, shapes, far, wt)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged", "xpose_head"])
def test_kernel_nan_location_adds_zero(cuda, name):
    """A NaN location's sample adds exactly 0 (its corners are outside):
    the call equals, bit for bit, the call with that sample's location kept
    finite and its weight set to 0.  Both instantiations of the kernel."""
    shapes, arrays = _case(name)
    v, lo, wt = _on(cuda, *arrays)
    nan_loc, zero_w = lo.clone(), wt.clone()
    nan_loc[0, 3, 1, 0, 1, 0] = float("nan")  # x of one sample
    nan_loc[0, 5, 0, 1, 2, 1] = float("nan")  # y of another
    zero_w[0, 3, 1, 0, 1] = 0.0
    zero_w[0, 5, 0, 1, 2] = 0.0
    got = MS.ms_deform_attn(v, shapes, nan_loc, wt)
    want = MS.ms_deform_attn(v, shapes, lo, zero_w)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    shapes, arrays = _case("base")
    v, lo, wt = _on(cuda, *arrays)
    with pytest.raises(TypeError):
        MS.ms_deform_attn(v.half(), shapes, lo, wt)
    with pytest.raises(ValueError, match="contiguous"):
        MS.ms_deform_attn(v.transpose(2, 3).contiguous().transpose(2, 3),
                          shapes, lo, wt)
    with pytest.raises(ValueError, match="CUDA"):
        MS.ms_deform_attn(v, shapes, lo.cpu(), wt)
