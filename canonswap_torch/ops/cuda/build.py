"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Every kernel lives in ``canonswap_torch/csrc/`` with a plain C entry point.
It is compiled for Hopper (``sm_90a``) at first use, into
``canonswap_torch/build/`` (git-ignored), under a name keyed by the hash of
the source, the headers beside it (``csrc/*.cuh``) and the flags, so a
changed source or header builds anew and an unchanged one loads at once.
Nothing here runs at import time: this module imports on a machine without
nvcc or a GPU, where only the kernels' plain versions run.

Every wrapper launches through :meth:`CudaKernel.launch_on`, on PyTorch's
current stream of the tensors' device, passed to the C entry point as its
last argument.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# the current device's index and a device's current stream as a raw handle,
# the calls PyTorch's own generated code makes (None on a CPU-only build,
# which has no CUDA tensor to launch on)
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels build "
            "only where the CUDA toolkit is installed")
    return path


class CudaKernel:
    """One C entry point of one ``csrc/*.cu`` file, built at first use.

    ``launches`` counts the launches made through :meth:`launch_on`; a caller
    that wants to show a code path went through the kernel resets it to 0
    before the path and reads it after.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds: float | None = None  # None: loaded, not built
        self.build_log = ""
        self._fn = None
        self._lib = None

    def _library_path(self) -> Path:
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{key}.so"

    def _start_build(self):
        """Start nvcc on the source; returns what :meth:`_finish_build`
        waits on."""
        lib = self._library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp, lib, time.perf_counter()

    def _finish_build(self, proc, tmp: Path, lib: Path, t0: float) -> None:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} "
                f"(exit {proc.returncode}):\n{stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders race safely
        self.build_seconds = time.perf_counter() - t0
        self.build_log = stderr

    def load(self):
        """Build (if needed) and load the library; returns the C function."""
        if self._fn is not None:
            return self._fn
        lib = self._library_path()
        if not lib.exists():
            self._finish_build(*self._start_build())
        # PyDLL: the call keeps the GIL (an entry point only enqueues work),
        # which saves releasing and taking it again around every launch
        self._lib = ctypes.PyDLL(str(lib))
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch_on(self, device: torch.device, *args) -> None:
        """Call the C entry point with ``args`` and the current stream of
        ``device`` (a CUDA device with its index, as ``tensor.device``
        gives it) last; raise if it reports a CUDA error.  The current
        device is switched only where it is not ``device`` already."""
        index = device.index
        if index == _current_device():
            err = (self._fn or self.load())(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = (self._fn or self.load())(*args, _raw_stream(index))
        if err:
            self._raise(err)
        self.launches += 1

    def _raise(self, err: int) -> None:
        errstr = getattr(self._lib, f"{self.source.stem}_error_string", None)
        msg = ""
        if errstr is not None:
            errstr.restype = ctypes.c_char_p
            errstr.argtypes = [ctypes.c_int]
            msg = errstr(err).decode()
        raise RuntimeError(
            f"{self.symbol} failed to launch: CUDA error {err} {msg}")


def forbid_grad(op: str, *tensors) -> None:
    """Raise where a kernel without a backward would cut autograd: under
    grad mode, on an input that requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward: the JAX trainer runs with the int8 "
            "flags off (the exact warp, whose backward is a kernel) and "
            "XPose is inference only; call it under torch.no_grad() or "
            "on inputs that do not require grad")


def build_all(kernels) -> None:
    """Build the kernels whose libraries are missing, one nvcc process per
    source (kernels that share a source share its build), all started at
    once, then load every one.  Every nvcc is waited for before a failed
    build raises."""
    by_library: dict[Path, list[CudaKernel]] = {}
    for k in kernels:
        if k._fn is None and not k._library_path().exists():
            by_library.setdefault(k._library_path(), []).append(k)
    started = [(group, group[0]._start_build())
               for group in by_library.values()]
    errors = []
    for group, build in started:
        try:
            group[0]._finish_build(*build)
        except RuntimeError as e:
            errors.append(e)
            continue
        for k in group[1:]:
            k.build_seconds, k.build_log = (group[0].build_seconds,
                                            group[0].build_log)
    if errors:
        raise errors[0]
    for k in kernels:
        k.load()
