"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Every kernel lives in ``canonswap_torch/csrc/`` with a plain C entry point.
It is compiled for Hopper (``sm_90a``) at first use, into
``canonswap_torch/build/`` (git-ignored), under a name keyed by the source's
hash and the flags, so a changed source builds anew and an unchanged one
loads at once.  Nothing here runs at import time: this module imports on a
machine without nvcc or a GPU, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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

    ``launches`` counts the launches made through :meth:`launch`; a caller
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
        key = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
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
        self._lib = ctypes.CDLL(str(lib))
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if it reports a CUDA error."""
        err = self.load()(*args)
        if err != 0:
            errstr = getattr(self._lib, f"{self.source.stem}_error_string",
                             None)
            msg = ""
            if errstr is not None:
                errstr.restype = ctypes.c_char_p
                errstr.argtypes = [ctypes.c_int]
                msg = errstr(err).decode()
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {err} {msg}")
        self.launches += 1


def build_all(kernels) -> None:
    """Build the kernels whose libraries are missing, one nvcc process per
    source, all started at once, then load every one.  Every nvcc is waited
    for before a failed build raises."""
    pending = [k for k in kernels
               if k._fn is None and not k._library_path().exists()]
    started = [(k, k._start_build()) for k in pending]
    errors = []
    for k, build in started:
        try:
            k._finish_build(*build)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for k in kernels:
        k.load()
