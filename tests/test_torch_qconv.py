"""The port's W8A8 conv: plain version vs the JAX package, the wrapper's
device rule and checks, and (on a card) the CUDA kernel vs the plain version.

The JAX cases run the JAX functions under ``jax.jit``, as the models run
them: XLA evaluates ``max / 127 + 1e-12`` and the dequant plus bias as fused
multiply-adds, and the port follows that arithmetic, so the expected error
is 0; the bound is rel <= 1e-6.  ``conv3d_packed`` (pack_hw2 layout) and
``conv3d_stacked`` with ``int8=True`` are the JAX package's int8 3D chains:
their 4*Cout packed weight steps are the Cout steps tiled, so they equal a
plain W8A8 3D conv.  JAX is imported inside those tests only, and the file
imports nothing else of the test tree, so the CUDA cases also run where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_qconv.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canonswap_torch.ops import qconv as Q
from canonswap_torch.ops.cuda import qconv as QC


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9))


def _conv2d_case(k: int, bias: bool, seed: int = 0, cin=24, cout=40, hw=16):
    g = np.random.default_rng(seed)
    x = g.standard_normal((2, hw, hw, cin), dtype=np.float32)
    w = (g.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)
    b = g.standard_normal(cout).astype(np.float32) if bias else None
    return x, w, b


def _plain_nhwc(x, w_hwio, b):
    """The plain version on JAX-layout arrays, back in JAX's layout."""
    out = Q.conv_w8a8_plain(t(np.moveaxis(x, -1, 1)),
                            t(np.moveaxis(w_hwio, (-1, -2), (0, 1))),
                            None if b is None else t(b))
    return np.moveaxis(out.numpy(), 1, -1)


# (k, bias, Cin, Cout): every kernel size with Cin 24 (not a multiple of 32)
# and Cout 40, then the kernel's other shape classes: Cout > 256 with Cin a
# multiple of 128 (the wide tile, A by TMA im2col), Cout <= 32 (the narrow
# tile) and Cin a multiple of 32 but not of 128 (A gathered by cp.async)
PLAIN_CASES = [(k, bias, 24, 40) for k in (1, 3, 7) for bias in (True, False)]
PLAIN_CASES += [(3, True, 128, 260), (3, False, 32, 16), (1, True, 96, 64)]


@pytest.mark.parametrize(
    "k,bias,cin,cout", PLAIN_CASES,
    ids=[f"{k}-{bias}" + ("" if (cin, cout) == (24, 40) else
                          f"-cin{cin}-cout{cout}")
         for k, bias, cin, cout in PLAIN_CASES])
def test_plain_matches_conv2d_w8a8(k, bias, cin, cout):
    import jax

    from canonswap_tpu.ops.qconv import conv2d_w8a8

    x, w, b = _conv2d_case(k, bias, seed=k, cin=cin, cout=cout)
    want = np.asarray(jax.jit(conv2d_w8a8)(x, w, b))
    got = _plain_nhwc(x, w, b)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


def _volume_case(seed: int = 5):
    g = np.random.default_rng(seed)
    x = g.standard_normal((2, 4, 8, 8, 8), dtype=np.float32)
    w = (g.standard_normal((3, 3, 3, 8, 8)) * 0.1).astype(np.float32)
    b = g.standard_normal(8).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("form", ["packed", "stacked"])
def test_plain_matches_the_int8_3d_chains(form):
    """The test that the ROADMAP's old caveat was wrong: the packed int8
    conv's per-packed-channel steps are the per-Cout steps tiled four
    times, and the activation max is that of the unpacked volume."""
    import jax

    from canonswap_tpu.nn.conv3d import (
        conv3d_packed, conv3d_stacked, pack_hw2, unpack_hw2)

    x, w, b = _volume_case()
    if form == "packed":
        fn = lambda x, w, b: unpack_hw2(  # noqa: E731
            conv3d_packed(pack_hw2(x), w, b, int8=True))
    else:
        fn = lambda x, w, b: conv3d_stacked(x, w, b, int8=True)  # noqa: E731
    want = np.asarray(jax.jit(fn)(x, w, b))
    got = Q.conv_w8a8_plain(t(np.moveaxis(x, -1, 1)),
                            t(np.moveaxis(w, (-1, -2), (0, 1))), t(b))
    got = np.moveaxis(got.numpy(), 1, -1)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-6


def test_plain_matches_qconv2d_pallas_interpret():
    """tests/test_qconv_pallas.py's case and bound (the Pallas kernel
    multiplies by 1/sx instead of dividing, so it is not bit-exact)."""
    import jax

    from canonswap_tpu.ops.pallas.qconv import qconv2d_pallas

    x, w, b = _conv2d_case(3, True, seed=6, cin=256, cout=128)
    want = np.asarray(jax.jit(
        lambda *a: qconv2d_pallas(*a, interpret=True))(x, w, b))
    assert rel_err(_plain_nhwc(x, w, b), want) < 1e-6


def test_int8_worthwhile_is_the_jax_gate():
    import jax.numpy as jnp

    from canonswap_tpu.ops.qconv import int8_worthwhile

    for n, h, c in [(1, 128, 128), (1, 129, 128), (2, 64, 127),
                    (2, 64, 512), (1, 256, 512)]:
        ref = int8_worthwhile(jnp.zeros((n, h, h, c)))
        assert Q.int8_worthwhile(torch.zeros((n, c, h, h))) == ref


def test_step_is_exact_max_over_127_fma():
    """The per-sample step: fma(max|x|, f32(1/127), 1e-12) in f32, from an
    exact max (bf16 inputs widen exactly)."""
    from canonswap_torch.ops.quant import INV127, sample_step

    x = t(np.random.default_rng(7).standard_normal((3, 5, 7), np.float32))
    amax = x.abs().amax(dim=(1, 2)).double()
    want = (amax * np.float64(np.float32(1 / 127.0))
            + np.float64(np.float32(1e-12))).float()
    assert torch.equal(sample_step(x), want)
    assert INV127 == float(np.float32(1 / 127.0))
    xb = x.bfloat16()
    assert torch.equal(sample_step(xb), sample_step(xb.float()))


def test_cpu_tensors_take_the_plain_version():
    x, w, b = _conv2d_case(3, True, seed=8)
    xt = t(np.moveaxis(x, -1, 1))
    wt = t(np.moveaxis(w, (-1, -2), (0, 1)))
    before = QC.QCONV.launches
    out = Q.conv_w8a8(xt, wt, t(b))
    assert QC.QCONV.launches == before
    torch.testing.assert_close(out, Q.conv_w8a8_plain(xt, wt, t(b)),
                               rtol=0, atol=0)


def test_plain_bf16_quantizes_the_stored_weight():
    """bf16 x and weight: the steps come from the bf16 values, the sums are
    the same integers, and the result is rounded once to bf16."""
    x, w, b = _conv2d_case(3, True, seed=9)
    xt = t(np.moveaxis(x, -1, 1)).bfloat16()
    wt = t(np.moveaxis(w, (-1, -2), (0, 1))).bfloat16()
    out = Q.conv_w8a8_plain(xt, wt, t(b))
    assert out.dtype == torch.bfloat16
    want = Q.conv_w8a8_plain(xt.float(), wt.float(), t(b)).bfloat16()
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_refuses_what_it_does_not_take():
    x = torch.zeros((1, 4, 6, 6))
    with pytest.raises(ValueError, match="odd"):
        Q.conv_w8a8(x, torch.zeros((2, 4, 2, 2)))
    with pytest.raises(ValueError, match="channels"):
        Q.conv_w8a8(x, torch.zeros((2, 3, 3, 3)))
    with pytest.raises(ValueError, match="rank"):
        Q.conv_w8a8(x, torch.zeros((2, 4, 3, 3, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        QC.conv_w8a8_cuda(x, torch.zeros((2, 4, 3, 3)))


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # for this test only: later tests keep their own setting
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


# (x shape, Cout, kernel, bias): 2D and 3D, ragged H/W, Cin not a multiple
# of 4 or 32, every tile width (Cout <= 32, <= 128, more) and both A paths
# (TMA im2col: 2D with Cin a multiple of 128; else cp.async gathers), and
# the kernel's boundaries: Cout one past a tile (33, 257), M not a multiple
# of the 128-point tile, P not a multiple of it (a sample boundary inside a
# tile), K one stage (128 bytes) exactly on both A paths, K ending inside a
# stage (Cin 96), and the 3D chains' halo kernel
CUDA_CASES = {
    "2d_k3_512": ((2, 512, 16, 16), 512, (3, 3), True),
    "2d_k1_nobias": ((2, 256, 12, 20), 96, (1, 1), False),
    "2d_k7_ragged": ((1, 6, 13, 11), 40, (7, 7), False),
    "3d_k3_32": ((2, 32, 4, 16, 16), 32, (3, 3, 3), True),
    "3d_ragged": ((1, 10, 3, 7, 9), 20, (3, 3, 3), True),
    "2d_cout33": ((2, 128, 10, 10), 33, (3, 3), True),
    "2d_cout257": ((1, 256, 9, 15), 257, (3, 3), False),
    "2d_k1_one_stage": ((3, 128, 7, 9), 64, (1, 1), True),
    "3d_k1_one_stage": ((2, 128, 3, 5, 7), 40, (1, 1, 1), True),
    "2d_cin96_two_tiles": ((2, 96, 11, 13), 300, (3, 3), True),
    # the 3D chains' halo kernel: 32 channels, W = 64, H a multiple of 4
    "3d_halo": ((2, 32, 3, 8, 64), 32, (3, 3, 3), True),
    "3d_halo_cin20": ((1, 20, 2, 4, 64), 20, (3, 3, 3), False),
    "3d_halo_k133": ((1, 32, 2, 4, 64), 16, (1, 3, 3), True),
    "2d_halo": ((2, 32, 4, 64), 24, (3, 3), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernel_matches_plain(cuda, name, dtype):
    """Same integers, same steps, one fused multiply-add: bit-identical,
    save where the plain version's f64 multiply-add lands on an f32 tie."""
    shape, cout, k, bias = CUDA_CASES[name]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(cuda, dtype)
    w = (torch.randn((cout, shape[1], *k), generator=g) * 0.05).to(cuda, dtype)
    b = torch.randn(cout, generator=g).to(cuda) if bias else None
    before = QC.QCONV.launches
    got = Q.conv_w8a8(x, w, b)
    assert QC.QCONV.launches == before + 1
    want = Q.conv_w8a8_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.double() - want.double()).abs().max()
    assert float(err) <= 1e-6 * float(want.double().abs().max())


@pytest.mark.cuda
def test_kernel_requantizes_a_changed_weight(cuda):
    x = torch.randn((1, 32, 8, 8), device=cuda)
    w = torch.randn((16, 32, 3, 3), device=cuda) * 0.05
    first = Q.conv_w8a8(x, w)
    w.mul_(-2.0)
    torch.testing.assert_close(Q.conv_w8a8(x, w),
                               Q.conv_w8a8_plain(x, w), rtol=1e-6, atol=1e-6)
    assert not torch.equal(first, Q.conv_w8a8(x, w))


@pytest.mark.cuda
def test_kernel_takes_mixed_dtypes(cuda):
    """f32 x with a bf16 weight and bias: each read in its own dtype."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 64, 9, 14), generator=g).to(cuda)
    w = (torch.randn((48, 64, 3, 3), generator=g) * 0.05).to(cuda).bfloat16()
    b = torch.randn(48, generator=g).to(cuda).bfloat16()
    got = Q.conv_w8a8(x, w, b)
    want = Q.conv_w8a8_plain(x, w, b)
    assert got.dtype == torch.float32
    err = (got.double() - want.double()).abs().max()
    assert float(err) <= 1e-6 * float(want.double().abs().max())


@pytest.mark.cuda
def test_kernel_follows_a_module_cast(cuda):
    """A conv run in f32, then cast to bf16 with ``Module.to`` (which keeps
    the parameter's version counter): the kernel reads the bf16 weight."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(128, 64, 3, padding=1).to(cuda)
    x = torch.randn((2, 128, 8, 8), device=cuda)
    with torch.no_grad():
        Q.conv_w8a8(x, conv.weight, conv.bias)
        conv.to(torch.bfloat16)
        xb = x.bfloat16()
        got = Q.conv_w8a8(xb, conv.weight, conv.bias)
        want = Q.conv_w8a8_plain(xb, conv.weight, conv.bias)
    assert got.dtype == torch.bfloat16
    err = (got.double() - want.double()).abs().max()
    assert float(err) <= 1e-6 * float(want.double().abs().max())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 4, 6, 6), device=cuda)
    w = torch.zeros((2, 4, 3, 3), device=cuda)
    with pytest.raises(TypeError):
        Q.conv_w8a8(x.half(), w)
    with pytest.raises(ValueError):
        Q.conv_w8a8(x.transpose(2, 3), w)
    with pytest.raises(ValueError):
        Q.conv_w8a8(x, w.cpu())
