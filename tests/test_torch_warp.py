"""The port's trilinear warp: plain version vs the JAX package, the wrapper's
device rule and checks, and (on a card) the CUDA kernel vs the plain version.

The JAX cases use the shapes and ranges of tests/test_warp_pallas.py and
hold the plain version to rel <= 1e-6 against both ``grid_sample_3d_ref``
and the Pallas kernel in interpret mode.  JAX is imported inside those tests
only, and the file imports nothing else of the test tree, so the CUDA cases
also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_warp.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canonswap_torch.ops.cuda import warp as W

# (vol NDHWC, grid, range): tests/test_warp_pallas.py's cases
CASES = {
    "cube_r1.0": ((2, 8, 16, 16, 32), (2, 8, 16, 16, 3), 1.0),
    "cube_r1.4": ((2, 8, 16, 16, 32), (2, 8, 16, 16, 3), 1.4),
    "tall_r1.0": ((1, 8, 32, 16, 32), (1, 8, 32, 16, 3), 1.0),
    "ragged_r1.1": ((1, 4, 8, 24, 16), (1, 6, 8, 24, 3), 1.1),
}


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| (test_warp_pallas' measure)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9))


def _case(name: str, seed: int = 0):
    vshape, gshape, r = CASES[name]
    g = np.random.default_rng(seed)
    vol = g.standard_normal(vshape, dtype=np.float32)
    grid = g.uniform(-r, r, gshape).astype(np.float32)
    return vol, grid


def _small_motion(seed: int = 3):
    """Identity plus +-0.03 (test_warp_pallas' windowed case)."""
    g = np.random.default_rng(seed)
    d, h, w = 8, 32, 16
    vol = g.standard_normal((2, d, h, w, 32), dtype=np.float32)
    axes = [(np.arange(n) + 0.5) / n * 2 - 1 for n in (d, h, w)]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    ident = np.stack([xx, yy, zz], -1)[None]
    grid = np.clip(ident + g.uniform(-0.03, 0.03, (2, d, h, w, 3)), -1, 1)
    return vol, grid.astype(np.float32)


def _plain(vol_ndhwc: np.ndarray, grid: np.ndarray) -> np.ndarray:
    vol = t(np.moveaxis(vol_ndhwc, -1, 1))
    return np.moveaxis(W.grid_sample_3d(vol, t(grid)).numpy(), 1, -1)


def _inputs(name):
    return _small_motion() if name == "small_motion" else _case(name)


ALL = sorted(CASES) + ["small_motion"]


@pytest.mark.parametrize("name", ALL)
def test_plain_matches_jax_ref(name):
    import jax.numpy as jnp

    from canonswap_tpu.ops.grid_sample import grid_sample_3d_ref

    vol, grid = _inputs(name)
    want = np.asarray(grid_sample_3d_ref(jnp.asarray(vol), jnp.asarray(grid)))
    got = _plain(vol, grid)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("name", ALL)
def test_plain_matches_pallas_interpret(name):
    import jax.numpy as jnp

    from canonswap_tpu.ops.pallas.warp import grid_sample_3d_onehot

    vol, grid = _inputs(name)
    want = np.asarray(grid_sample_3d_onehot(
        jnp.asarray(vol), jnp.asarray(grid), interpret=True))
    got = _plain(vol, grid)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


def test_cpu_tensors_take_the_plain_version():
    vol, grid = _case("ragged_r1.1")
    v = t(np.moveaxis(vol, -1, 1))
    before = W.WARP3D.launches
    out = W.grid_sample_3d(v, t(grid))
    assert W.WARP3D.launches == before
    torch.testing.assert_close(out, W.grid_sample_3d_plain(v, t(grid)),
                               rtol=0, atol=0)
    assert out.shape == (1, 16, 6, 8, 24)


def test_plain_bf16_computes_in_f32_and_rounds_once():
    vol, grid = _case("ragged_r1.1")
    v, g = t(np.moveaxis(vol, -1, 1)), t(grid)
    out = W.grid_sample_3d_plain(v.bfloat16(), g.bfloat16())
    assert out.dtype == torch.bfloat16
    want = W.grid_sample_3d_plain(v.bfloat16().float(), g.bfloat16().float())
    torch.testing.assert_close(out, want.bfloat16(), rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    vol, grid = _case("ragged_r1.1")
    with pytest.raises(ValueError, match="CUDA"):
        W.grid_sample_3d_cuda(t(np.moveaxis(vol, -1, 1)), t(grid))


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # for this test only: later tests keep their own setting
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("name", ALL)
def test_kernel_matches_plain(cuda, name, dtype, tol):
    """f32: the same sums in another order.  bf16: both sides sum in f32 and
    round once, so they differ by at most one bf16 ulp (2**-7 relative)."""
    vol, grid = _inputs(name)
    v = t(np.moveaxis(vol, -1, 1)).to(cuda, dtype)
    g = t(grid).to(cuda, dtype)
    before = W.WARP3D.launches
    got = W.grid_sample_3d(v, g)
    assert W.WARP3D.launches == before + 1
    want = W.grid_sample_3d_plain(v, g)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert got.dtype == dtype and got.shape == want.shape
    assert float(err) <= tol


@pytest.mark.cuda
def test_kernel_bf16_smooth_field_across_blocks(cuda):
    """bf16 at the kind of field dense motion emits (identity plus up to
    0.05), the main path's 32 channels, over points that fill several
    1024-point blocks and end inside one; within one bf16 ulp."""
    g = torch.Generator().manual_seed(7)
    b, c, d, h, w = 2, 32, 5, 24, 40
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) / n * 2 - 1
            for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    ident = torch.stack([xx, yy, zz], -1)[None]
    disp = (torch.rand((b, d, h, w, 3), generator=g) * 2 - 1) * 0.05
    grid = (ident + disp).to(cuda, torch.bfloat16)
    vol = torch.randn((b, c, d, h, w), generator=g).to(cuda, torch.bfloat16)
    got = W.grid_sample_3d(vol, grid)
    want = W.grid_sample_3d_plain(vol, grid)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max() / want.double().abs().max()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float(err) <= 2.0**-7


@pytest.mark.cuda
def test_kernel_mixed_dtypes_and_far_grids(cuda):
    """f32 volume with a bf16 grid, and grids far outside [-1, 1] (all taps
    in the zero padding)."""
    vol, grid = _case("cube_r1.0")
    v = t(np.moveaxis(vol, -1, 1)).to(cuda)
    g = t(grid).to(cuda).bfloat16()
    torch.testing.assert_close(W.grid_sample_3d(v, g),
                               W.grid_sample_3d_plain(v, g),
                               rtol=1e-5, atol=1e-5)
    far = torch.full_like(t(grid).to(cuda), 40.0)
    far[..., 1] = -55.0
    assert torch.count_nonzero(W.grid_sample_3d(v, far)) == 0


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    v = torch.zeros((1, 4, 2, 3, 5), device=cuda)
    g = torch.zeros((1, 2, 3, 5, 3), device=cuda)
    with pytest.raises(TypeError):
        W.grid_sample_3d(v.half(), g)
    with pytest.raises(ValueError):
        W.grid_sample_3d(v.transpose(3, 4), g)
    with pytest.raises(ValueError):
        W.grid_sample_3d(v, g[..., :2])
