"""The one launch path of the port's CUDA kernels, ``CudaKernel.launch_on``.

On the CPU, with a fake C entry point in place of a built library: the
stream is passed last, launches are counted, a nonzero return raises, and
the current device is switched only where the tensors' device is another.
A source scan holds every wrapper of ``canonswap_torch/ops/cuda/`` to that
path.  The file imports nothing of JAX or of the test tree.
"""

from __future__ import annotations

import contextlib
import re
from pathlib import Path

import pytest
import torch

from canonswap_torch.ops.cuda import build as BLD

CUDA_OPS = Path(BLD.__file__).resolve().parent


@pytest.fixture
def fake(monkeypatch):
    """A kernel whose C entry point records its arguments and returns the
    next of ``fake.returns`` (0 once used up); device 0 is current and a
    device's stream is 0x5000 + its index."""
    calls, returns = [], []

    def entry(*args):
        calls.append(args)
        return returns.pop(0) if returns else 0

    monkeypatch.setattr(BLD.CudaKernel, "load", lambda self: entry)
    monkeypatch.setattr(BLD, "_current_device", lambda: 0)
    monkeypatch.setattr(BLD, "_raw_stream", lambda index: 0x5000 + index)
    kernel = BLD.CudaKernel("probes.cu", "probes_double", [])
    kernel.calls, kernel.returns = calls, returns
    return kernel


def test_launch_on_passes_the_stream_last_and_counts(fake):
    fake.launch_on(torch.device("cuda", 0), 11, 22, 3)
    fake.launch_on(torch.device("cuda", 0), 44, 55, 6)
    assert fake.calls == [(11, 22, 3, 0x5000), (44, 55, 6, 0x5000)]
    assert fake.launches == 2


def test_launch_on_raises_on_a_cuda_error_and_does_not_count(fake):
    fake.returns.append(700)
    with pytest.raises(RuntimeError, match="probes_double failed to launch: "
                       "CUDA error 700"):
        fake.launch_on(torch.device("cuda", 0), 1, 2, 3)
    assert fake.launches == 0
    fake.launch_on(torch.device("cuda", 0), 1, 2, 3)
    assert fake.launches == 1


@pytest.mark.parametrize("index,switched", [(0, []), (1, [1])],
                         ids=["current", "other"])
def test_launch_on_switches_device_only_when_needed(fake, monkeypatch, index,
                                                    switched):
    """On the current device no context is entered; on another, the call
    and its stream lookup run inside ``torch.cuda.device(index)``."""
    entered, inside = [], []

    @contextlib.contextmanager
    def device(i):
        entered.append(i)
        inside.append(True)
        yield
        inside.pop()

    def stream(i):
        assert bool(inside) == bool(switched)
        return 0x5000 + i

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(BLD, "_raw_stream", stream)
    fake.launch_on(torch.device("cuda", index), 7)
    assert entered == switched
    assert fake.calls == [(7, 0x5000 + index)]


def test_launch_on_uses_the_bound_entry_point_after_the_first_load(monkeypatch):
    """Once loaded, a launch reads the bound function and never loads
    again."""
    loads = []
    kernel = BLD.CudaKernel("probes.cu", "probes_double", [])

    def load(self):
        loads.append(self.symbol)
        self._fn = lambda *args: 0
        return self._fn

    monkeypatch.setattr(BLD.CudaKernel, "load", load)
    monkeypatch.setattr(BLD, "_current_device", lambda: 0)
    monkeypatch.setattr(BLD, "_raw_stream", lambda index: 1)
    for _ in range(3):
        kernel.launch_on(torch.device("cuda", 0), 1)
    assert loads == ["probes_double"] and kernel.launches == 3


@pytest.mark.parametrize("path", sorted(p.name for p in CUDA_OPS.glob("*.py")
                                        if p.name not in ("__init__.py",
                                                          "build.py")))
def test_wrappers_launch_only_through_launch_on(path):
    """No wrapper module switches devices or looks up a stream itself, and
    each one that launches a kernel does so through ``launch_on``."""
    src = (CUDA_OPS / path).read_text()
    assert "torch.cuda.device(" not in src
    assert "current_stream(" not in src
    assert not re.search(r"\.launch\(", src)
    assert "CudaKernel(" in src and ".launch_on(" in src


def test_launch_cost_needs_a_card(monkeypatch):
    from canonswap_torch.tools import launch_cost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_cost.main([])


def test_the_lookups_are_pytorchs_raw_calls():
    """The device and stream lookups are PyTorch's private calls, bound once
    (None on a CPU-only build, which has no CUDA tensor to launch on)."""
    assert BLD._current_device is getattr(torch._C, "_cuda_getDevice", None)
    assert BLD._raw_stream is getattr(torch._C, "_cuda_getCurrentRawStream",
                                      None)


def test_build_looks_up_no_stream_object():
    """The launch path reads the stream as a raw handle: ``build.py`` builds
    no ``torch.cuda.Stream`` and calls no ``current_stream``."""
    src = (CUDA_OPS / "build.py").read_text()
    assert "current_stream(" not in src and "Stream(" not in src
