"""The toolchain probes: the plain versions against the Pallas probes of
``tools/profile_r2b.py`` and ``tools/profile_r2c.py`` in interpret mode, the
wrappers' device rule and checks, the probe entry point, the build's
sharing of one source among kernels, and (on a card) each kernel against
its plain version.

The Pallas kernels and their wrappers are nested inside the tools'
``stages()``, so they are read from the tools' source with ``ast`` and run
as written, with ``pl.pallas_call`` in interpret mode.  Limits: the gather
and the doubling equal, NaNs included; the matmul within 1e-5 of max |ref|
(the same f32 products summed in another order against f64).  JAX is
imported inside those tests only, and the file imports nothing else of the
test tree, so the CUDA cases also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_probes.py
"""

from __future__ import annotations

import ast
import functools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from canonswap_torch.ops.cuda import build as BLD
from canonswap_torch.ops.cuda import probes as PR
from canonswap_torch.tools import profile_r2

REPO = Path(__file__).resolve().parents[1]
MM_TOL = 1e-5


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def pallas_probe(tool: str, *names: str):
    """The named functions of ``tools/<tool>``, defined as written, with
    ``pl.pallas_call`` in interpret mode; returns the last one."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tree = ast.parse((REPO / "tools" / tool).read_text())
    defs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    ns = {"jax": jax, "jnp": jnp, "pltpu": pltpu,
          "pl": types.SimpleNamespace(
              pallas_call=functools.partial(pl.pallas_call, interpret=True),
              BlockSpec=pl.BlockSpec)}
    module = ast.Module(body=[defs[n] for n in names], type_ignores=[])
    exec(compile(module, str(REPO / "tools" / tool), "exec"), ns)
    return ns[names[-1]]


def gather_inputs(shape=(2, 64, 128), seed=0):
    """x and indices in [-1.25 R, 1.25 R): in range, wrapping (negative)
    and out of range (NaN)."""
    g = np.random.default_rng(seed)
    rows = shape[1]
    x = g.standard_normal(shape, dtype=np.float32)
    idx = g.integers(-(5 * rows) // 4, (5 * rows) // 4, shape).astype(np.int32)
    return x, idx


def dbl_input(shape=(32, 64), seed=1):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    x.flat[:3] = [np.nan, np.inf, -0.0]
    return x


def mm_inputs(m=64, k=64, n=32, seed=2):
    g = np.random.default_rng(seed)
    return (g.standard_normal((m, k), dtype=np.float32),
            g.standard_normal((k, n), dtype=np.float32))


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the plain versions against the Pallas probes --------------------------


def test_gather_plain_matches_pallas_interpret():
    import jax
    import jax.numpy as jnp

    dyn_gather = pallas_probe("profile_r2b.py", "dg_kernel", "dyn_gather")
    x, idx = gather_inputs()
    want = np.asarray(jax.vmap(dyn_gather)(jnp.asarray(x), jnp.asarray(idx)))
    got = PR.dyn_gather_plain(t(x), t(idx)).numpy()
    rows = x.shape[1]
    assert (idx < 0).any() and ((idx < -rows) | (idx >= rows)).any()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got, want)


def test_gather_plain_matches_pallas_interpret_past_the_strip():
    """At R above the strip's limit (where the kernel takes its direct
    path) the plain version still equals the Pallas probe."""
    import jax
    import jax.numpy as jnp

    dyn_gather = pallas_probe("profile_r2b.py", "dg_kernel", "dyn_gather")
    x, idx = gather_inputs((1, 1900, 40), seed=10)
    assert not PR.gather_strip_ok(1900, 40)
    want = np.asarray(jax.vmap(dyn_gather)(jnp.asarray(x), jnp.asarray(idx)))
    got = PR.dyn_gather_plain(t(x), t(idx)).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got, want)


def test_dbl_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    dbl = pallas_probe("profile_r2c.py", "dbl_kernel", "dbl")
    x = dbl_input()
    want = np.asarray(dbl(jnp.asarray(x)))
    got = PR.dbl_plain(t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.signbit(got), np.signbit(want))


def test_mm_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    mm = pallas_probe("profile_r2c.py", "mm_kernel", "mm")
    a, b = mm_inputs()
    want = np.asarray(mm(jnp.asarray(a), jnp.asarray(b)))
    got = PR.mm_plain(t(a), t(b)).numpy()
    assert got.shape == want.shape == (64, 32) and got.dtype == np.float32
    assert _max_rel(got, want) <= MM_TOL


# ---- wrappers on the CPU -----------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    x, idx = gather_inputs((1, 5, 7))
    a, b = mm_inputs(9, 5, 3)
    before = [k.launches for k in (PR.GATHER, PR.DOUBLE, PR.MATMUL)]
    paths = dict(PR.GATHER_PATHS)
    for got, want in (
            (PR.dyn_gather(t(x), t(idx)), PR.dyn_gather_plain(t(x), t(idx))),
            (PR.dbl(t(x)), PR.dbl_plain(t(x))),
            (PR.mm(t(a), t(b)), PR.mm_plain(t(a), t(b)))):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert [k.launches for k in (PR.GATHER, PR.DOUBLE, PR.MATMUL)] == before
    assert PR.GATHER_PATHS == paths


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Shapes, then dtypes, then devices: on a machine without a card the
    CUDA paths raise on each before they would build anything."""
    x, idx = (t(v) for v in gather_inputs((1, 5, 7)))
    a, b = (t(v) for v in mm_inputs(9, 5, 3))
    with pytest.raises(ValueError, match="one shape"):
        PR.dyn_gather_cuda(x, idx[:, :4])
    with pytest.raises(ValueError, match="one shape"):
        PR.dyn_gather_plain(x[0], idx[0])
    with pytest.raises(TypeError, match="int32"):
        PR.dyn_gather_cuda(x, idx.long())
    with pytest.raises(ValueError, match="CUDA"):
        PR.dyn_gather_cuda(x, idx)
    with pytest.raises(ValueError, match="CUDA"):
        PR.dyn_gather(x, idx.to("meta"))  # not on the CPU: the kernel's path
    with pytest.raises(TypeError, match="float32"):
        PR.dbl_cuda(x.double())
    with pytest.raises(ValueError, match="CUDA"):
        PR.dbl_cuda(x)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        PR.mm_cuda(a, b.T)
    with pytest.raises(TypeError, match="float32"):
        PR.mm_cuda(a, b.half())
    with pytest.raises(ValueError, match="CUDA"):
        PR.mm(a, b.to("meta"))


def test_build_all_starts_one_nvcc_per_shared_source(monkeypatch):
    """The three probe kernels share csrc/probes.cu: one build, whose time
    and log each of them reports."""
    started, loaded = [], []
    kernels = [BLD.CudaKernel("probes.cu", sym, []) for sym in
               ("probes_gather", "probes_double", "probes_matmul")]
    kernels.append(BLD.CudaKernel("warp3d.cu", "warp3d_forward", []))

    def start(self):
        started.append(self.source.name)
        return (self,)

    def finish(self, _k):
        self.build_seconds, self.build_log = 1.5, f"log of {self.source.name}"

    monkeypatch.setattr(BLD.CudaKernel, "_library_path", lambda self: Path(
        f"/nonexistent/lib{self.source.stem}.so"))
    monkeypatch.setattr(BLD.CudaKernel, "_start_build", start)
    monkeypatch.setattr(BLD.CudaKernel, "_finish_build", finish)
    monkeypatch.setattr(BLD.CudaKernel, "load",
                        lambda self: loaded.append(self.symbol))
    BLD.build_all(kernels)
    assert sorted(started) == ["probes.cu", "warp3d.cu"]
    assert loaded == [k.symbol for k in kernels]
    assert [k.build_log for k in kernels[:3]] == ["log of probes.cu"] * 3
    assert all(k.build_seconds == 1.5 for k in kernels)


# ---- the gather's shape rule -------------------------------------------------


def test_gather_strip_limit_is_the_shared_memory_of_a_block():
    """R_MAX rows of 128 bytes and the 8-byte barrier fit the 232,448
    bytes a Hopper block may use; one row more does not."""
    r_max = PR.GATHER_R_MAX
    assert r_max == 1815
    assert r_max * 128 + 8 <= 232_448 < (r_max + 1) * 128 + 8


@pytest.mark.parametrize("rows, cols, strip", [
    (1024, 2048, True),            # the probe's shape
    (PR.GATHER_R_MAX, 96, True),   # the last strip shape
    (PR.GATHER_R_MAX + 1, 96, False),  # the first direct shape
    (1900, 40, False),
    (1, 100, True),
    (37, 1, True),                 # one column: a strip of width 1
    (37, 7, True),                 # narrower than one strip
    (37, 45, True),                # one whole strip and a ragged one
    (37, 2**31 - 1, True),         # the widest C the checks admit
    (0, 8, False),                 # no rows: nothing to stage
    (8, 0, False),
], ids=["probe", "r_max", "r_max_plus_1", "r1900", "r1", "c1", "c7", "c45",
        "c_int_max", "r0", "c0"])
def test_gather_strip_rule(rows, cols, strip):
    """The strip path where the strip fits, whatever C; the direct path
    past R_MAX rows."""
    assert PR.gather_strip_ok(rows, cols) is strip


# ---- the probe entry point ---------------------------------------------------


def test_stages_are_the_jax_tools_probes():
    """Names, shapes and dtypes of the JAX tools' Pallas stages
    (profile_r2b.py:201-207, profile_r2c.py:64-65, 81-83); the doubling
    and the matmul run on the CPU through their entry points."""
    got = dict(profile_r2.stages("cpu"))
    assert list(got) == ["pallas_dynamic_gather_16x", "pallas_simple_vpu",
                         "pallas_simple_mxu"]
    fn, (x, idx) = got["pallas_dynamic_gather_16x"]
    assert fn is PR.dyn_gather and profile_r2.B == 16
    assert x.shape == idx.shape == (16, 1024, 2048)
    assert (x.dtype, idx.dtype) == (torch.float32, torch.int32)
    assert torch.equal(x[0], x[15]) and torch.equal(idx[0], idx[15])
    assert int(idx.min()) >= 0 and int(idx.max()) < 1024
    fn, (xs,) = got["pallas_simple_vpu"]
    assert fn is PR.dbl and xs.shape == (256, 512)
    assert torch.equal(fn(xs), xs * 2)
    fn, (a, b) = got["pallas_simple_mxu"]
    assert fn is PR.mm and a.shape == b.shape == (512, 512)
    assert _max_rel(fn(a, b), a.double() @ b.double()) <= MM_TOL


def test_probe_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_r2.main([])


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nan_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(
        got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 5, 37), (16, 1024, 2048)],
                         ids=["small", "ragged", "full"])
def test_gather_kernel_matches_plain(cuda, shape):
    x, idx = (t(v).to(cuda) for v in gather_inputs(shape, seed=3))
    before = PR.GATHER.launches
    got = PR.dyn_gather(x, idx)
    assert PR.GATHER.launches == before + 1
    want = PR.dyn_gather_plain(x, idx)
    torch.cuda.synchronize()
    assert bool(got.isnan().any()) and _nan_equal(got, want)


def _gather_path(x: torch.Tensor, idx: torch.Tensor):
    before = dict(PR.GATHER_PATHS)
    out = PR.dyn_gather(x, idx)
    return out, [p for p, n in PR.GATHER_PATHS.items() if n != before[p]]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, path, unaligned", [
    ((2, PR.GATHER_R_MAX, 96), "strip", False),
    ((2, PR.GATHER_R_MAX + 1, 96), "direct", False),
    ((2, 300, 45), "strip", False),
    ((3, 50, 7), "strip", False),
    ((4, 1, 100), "strip", False),
    ((3, 37, 45), "strip", True),
    ((2, 37, 48), "strip", True),
], ids=["r_max", "r_max_plus_1", "c45", "c7", "r1", "unaligned",
        "unaligned_c48"])
def test_gather_kernel_paths(cuda, shape, path, unaligned):
    """Each shape takes the path the rule gives it and equals the plain
    version bit for bit, NaNs in the same places.  unaligned: x lies one
    float off a 16-byte line (x[1:] of a larger block), so the strip is
    staged without the bulk copies."""
    x, idx = (t(v) for v in gather_inputs(shape, seed=11))
    if unaligned:
        flat = torch.zeros(x.numel() + 1)
        flat[1:] = x.flatten()
        x = flat.to(cuda)[1:].view(shape)
        assert x.data_ptr() % 16 != 0
    else:
        x = x.to(cuda)
    idx = idx.to(cuda)
    got, taken = _gather_path(x, idx)
    want = PR.dyn_gather_plain(x, idx)
    torch.cuda.synchronize()
    assert taken == [path]
    assert bool(got.isnan().any()) and _nan_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256 * 512, 1001], ids=["full", "ragged"])
def test_dbl_kernel_matches_plain(cuda, n):
    x = t(dbl_input((n,), seed=4)).to(cuda)
    for xv in (x, x[1:]):  # x[1:] is not 16-byte aligned: one at a time
        got = PR.dbl(xv)
        assert _nan_equal(got, PR.dbl_plain(xv))
        num = ~xv.isnan()
        assert torch.equal(got[num].signbit(), xv[num].signbit())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mkn", [(512, 512, 512), (70, 45, 33), (64, 1, 5), (129, 3, 257),
            (33, 70, 0), (33, 0, 70), (100, 64, 30), (50, 30, 64)],
    ids=["full", "ragged", "k1", "k_under_split", "n0", "k0", "vec_a_only",
         "vec_b_only"])
def test_mm_kernel_matches_plain(cuda, mkn):
    """Within 1e-5 of max |ref| against f64; exact where the output is
    empty (no launch) or all zero (K = 0)."""
    a, b = (t(v).to(cuda) for v in mm_inputs(*mkn, seed=5))
    before = PR.MATMUL.launches
    got = PR.mm(a, b)
    assert PR.MATMUL.launches == before + (got.numel() > 0)
    want = PR.mm_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    if got.numel() == 0 or mkn[1] == 0:
        assert torch.equal(got.cpu(), want.cpu())
    else:
        assert _max_rel(got.cpu(), want.cpu()) <= MM_TOL


@pytest.mark.cuda
def test_mm_kernel_takes_a_misaligned_a(cuda):
    """A contiguous a whose pointer is 4 bytes off 16: the 4-byte copies."""
    a, b = mm_inputs(64, 64, 48, seed=6)
    flat = torch.zeros(64 * 64 + 1)
    flat[1:] = t(a).flatten()
    av = flat.to(cuda)[1:].view(64, 64)
    assert av.data_ptr() % 16 != 0
    got = PR.mm(av, t(b).to(cuda))
    assert _max_rel(got.cpu(), a.astype(np.float64) @ b) <= MM_TOL


@pytest.mark.cuda
def test_mm_kernel_repeats_bit_for_bit(cuda):
    """The cluster sums its partial tiles in a fixed order: two calls give
    the same bits."""
    a, b = (t(v).to(cuda) for v in mm_inputs(512, 512, 512, seed=7))
    assert torch.equal(PR.mm(a, b), PR.mm(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dbl", "mm"])
def test_kernels_launch_on_the_current_stream(cuda, name):
    """Under ``torch.cuda.stream(s)`` the kernel runs on s: its input is
    copied there behind a long sleep over a NaN-filled buffer, so a launch
    on another stream would read NaNs."""
    if name == "dbl":
        fn, plain, args = PR.dbl, PR.dbl_plain, (t(dbl_input((256, 512),
                                                           seed=8)),)
    else:
        fn, plain, args = PR.mm, PR.mm_plain, tuple(
            t(v) for v in mm_inputs(128, 96, 64, seed=9))
    args = tuple(v.to(cuda) for v in args)
    first = torch.full_like(args[0], float("nan"))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        first.copy_(args[0])
        got = fn(first, *args[1:])
    side.synchronize()
    want = plain(*args)
    if name == "dbl":
        assert _nan_equal(got, want)
    else:
        assert _max_rel(got.cpu(), want.cpu()) <= MM_TOL


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x, idx = (t(v).to(cuda) for v in gather_inputs((1, 5, 7)))
    with pytest.raises(ValueError, match="contiguous"):
        PR.dyn_gather(x.transpose(1, 2).contiguous().transpose(1, 2), idx)
    with pytest.raises(ValueError, match="CUDA"):
        PR.dyn_gather(x, idx.cpu())
    with pytest.raises(TypeError, match="float32"):
        PR.mm(x[0].half(), x[0].T.contiguous())
