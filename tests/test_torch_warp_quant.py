"""The port's W8A8 trilinear warp (the fast bundle's): plain version vs the
Pallas kernel, the wrapper's device rule, and (on a card) the CUDA kernel
vs the plain version.

The JAX cases hold the plain version to ``grid_sample_3d_onehot(...,
quant=True, interpret=True)`` at rel <= 1e-6 (expected exact: the same int8
volume, tap weights and integer sums, the same f32 roundings), on
tests/test_warp_pallas.py's quant shape at ranges 1.0 and 1.4, on a
small-motion field that takes the windowed branch (``run_win_q``), at
C = 48 and on an all-zero volume.  JAX is
imported inside those tests only, and the file imports nothing else of the
test tree, so the CUDA cases also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_quant.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canonswap_torch.ops.cuda import warp as W


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9))


def _uniform(r: float, seed: int = 0):
    g = np.random.default_rng(seed)
    vol = g.standard_normal((2, 8, 16, 16, 32), dtype=np.float32)
    grid = g.uniform(-r, r, (2, 8, 16, 16, 3)).astype(np.float32)
    return vol, grid


def _small_motion(seed: int = 3):
    """Identity plus +-0.03 at h = 64: every tap lies inside its 32-row
    window, so the Pallas kernel takes the windowed branch."""
    g = np.random.default_rng(seed)
    d, h, w = 8, 64, 16
    vol = g.standard_normal((2, d, h, w, 32), dtype=np.float32)
    axes = [(np.arange(n) + 0.5) / n * 2 - 1 for n in (d, h, w)]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    ident = np.stack([xx, yy, zz], -1)[None]
    grid = np.clip(ident + g.uniform(-0.03, 0.03, (2, d, h, w, 3)), -1, 1)
    return vol, grid.astype(np.float32)


def _channels48(seed: int = 5):
    """C = 48: no multiple of 32, so the kernel's second 32-channel pass
    covers 16 channels of its channels-last copy."""
    g = np.random.default_rng(seed)
    vol = g.standard_normal((2, 8, 16, 16, 48), dtype=np.float32)
    grid = g.uniform(-1.1, 1.1, (2, 8, 16, 16, 3)).astype(np.float32)
    return vol, grid


def _zeros(seed: int = 6):
    """An all-zero volume: the step is 1e-12, every quantum 0."""
    _, grid = _uniform(1.0, seed)
    return np.zeros((2, 8, 16, 16, 32), np.float32), grid


CASES = {"uniform_r1.0": lambda: _uniform(1.0),
         "uniform_r1.4": lambda: _uniform(1.4, seed=1),
         "small_motion_windowed": _small_motion,
         "channels48": _channels48,
         "zeros": _zeros}


def _plain(vol_ndhwc, grid):
    out = W.grid_sample_3d_quant(t(np.moveaxis(vol_ndhwc, -1, 1)), t(grid))
    return np.moveaxis(out.numpy(), 1, -1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_quant_interpret(name):
    import jax
    import jax.numpy as jnp

    from canonswap_tpu.ops.pallas.warp import (
        _unnormalize, _window_fits, grid_sample_3d_onehot, window_geometry)

    vol, grid = CASES[name]()
    if name.startswith("small_motion"):
        b, d, h, w, c = vol.shape
        rpb, win_r, zsnap, win_z = window_geometry(d, h, w, c)
        g = jnp.asarray(grid).reshape(b, -1, 3)
        assert bool(_window_fits(
            _unnormalize(g[..., 0], w), _unnormalize(g[..., 1], h),
            _unnormalize(g[..., 2], d), d, h, w, win_r, win_z, zsnap, rpb))
    want = np.asarray(jax.jit(lambda v, g: grid_sample_3d_onehot(
        v, g, quant=True, interpret=True))(vol, grid))
    got = _plain(vol, grid)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


def test_plain_is_close_to_the_exact_warp():
    """test_warp_pallas.py's quant bound against the exact trilinear
    sample: within 2 % (relative norm)."""
    vol, grid = _uniform(1.0)
    v, g = t(np.moveaxis(vol, -1, 1)), t(grid)
    assert rel_err(W.grid_sample_3d_quant_plain(v, g),
                   W.grid_sample_3d_plain(v, g)) < 2e-2


def test_cpu_tensors_take_the_plain_version():
    vol, grid = _uniform(1.0)
    v, g = t(np.moveaxis(vol, -1, 1)), t(grid)
    before = (W.WARP3D.launches, W.WARP3D_Q.launches)
    out = W.grid_sample_3d_quant(v, g)
    assert (W.WARP3D.launches, W.WARP3D_Q.launches) == before
    assert out.shape == (2, 32, 8, 16, 16)


def test_plain_bf16_rounds_once():
    vol, grid = _uniform(1.4, seed=1)
    v, g = t(np.moveaxis(vol, -1, 1)).bfloat16(), t(grid).bfloat16()
    out = W.grid_sample_3d_quant_plain(v, g)
    assert out.dtype == torch.bfloat16
    want = W.grid_sample_3d_quant_plain(v.float(), g.float()).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    vol, grid = _uniform(1.0)
    with pytest.raises(ValueError, match="CUDA"):
        W.grid_sample_3d_quant_cuda(t(np.moveaxis(vol, -1, 1)), t(grid))


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ragged(seed: int = 4):
    g = np.random.default_rng(seed)
    vol = g.standard_normal((1, 4, 8, 24, 16), dtype=np.float32)
    grid = g.uniform(-1.1, 1.1, (1, 6, 8, 24, 3)).astype(np.float32)
    return vol, grid


def _channels4(seed: int = 7):
    """C = 4 (12 channels of zero padding in the int8 copy) and 105 output
    points: B * P no multiple of the gather's block."""
    g = np.random.default_rng(seed)
    vol = g.standard_normal((1, 3, 5, 7, 4), dtype=np.float32)
    grid = g.uniform(-1.1, 1.1, (1, 3, 5, 7, 3)).astype(np.float32)
    return vol, grid


def _ties(seed: int = 8):
    """max |vol| = 127 makes the step exactly 1 (f32(127 * f32(1/127) +
    1e-12) = 1), so elements at k + 0.5 lie exactly on a rounding tie of
    vol / step (round half to even, not away from zero); every value is
    exact in bf16 too."""
    g = np.random.default_rng(seed)
    vol = np.round(g.uniform(-63, 63, (2, 8, 16, 16, 32)) * 4) / 4
    vol = vol.astype(np.float32)
    vol[0, 0, 0, 0, 0] = 127.0
    vol[1, 0, 0, 0, 0] = -127.0
    grid = g.uniform(-1.0, 1.0, (2, 8, 16, 16, 3)).astype(np.float32)
    return vol, grid


CUDA_CASES = {**CASES, "ragged_r1.1": _ragged, "channels4": _channels4,
              "ties": _ties}


def test_ties_case_lies_on_rounding_ties():
    from canonswap_torch.ops.quant import sample_step

    vol, _ = _ties()
    v = t(np.moveaxis(vol, -1, 1))
    assert sample_step(v).tolist() == [1.0, 1.0]
    assert sample_step(v.bfloat16()).tolist() == [1.0, 1.0]
    assert torch.equal(v.bfloat16().float(), v)
    frac = v - torch.floor(v)
    assert int((frac == 0.5).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernel_matches_plain(cuda, name, dtype):
    """Every rounding where the plain version rounds: bit-identical."""
    vol, grid = CUDA_CASES[name]()
    v = t(np.moveaxis(vol, -1, 1)).to(cuda, dtype)
    g = t(grid).to(cuda, dtype)
    before = W.WARP3D_Q.launches
    got = W.grid_sample_3d_quant(v, g)
    assert W.WARP3D_Q.launches == before + 1
    want = W.grid_sample_3d_quant_plain(v, g)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_far_grids_sample_zero_padding(cuda):
    vol, grid = _uniform(1.0)
    v = t(np.moveaxis(vol, -1, 1)).to(cuda)
    far = torch.full_like(t(grid).to(cuda), 40.0)
    far[..., 1] = -55.0
    assert torch.count_nonzero(W.grid_sample_3d_quant(v, far)) == 0
