"""Per-stage wall clock and an optional ``torch.profiler`` trace.

The port's counterpart of ``canonswap_tpu/utils/timing.py``: named stage
timers with items per second, and a context manager that captures a trace
of the host and the card into a directory.  A stage that ends in device
work synchronizes inside it (``stage(..., sync=...)``), since PyTorch
returns before the card finishes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock per named stage; reports items/s per stage.
    Stages may be timed from several threads at once."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.items: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, sync=None):
        """Times the block; ``sync`` (e.g. ``torch.cuda.synchronize``) is
        called at its end, before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
            if sync is not None:
                sync()
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                self.items[name] += items

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> str:
        lines = []
        with self._lock:
            totals = sorted(self.totals.items(), key=lambda kv: -kv[1])
        for name, total in totals:
            line = f"{name:30s} {total:8.3f}s  x{self.counts[name]}"
            if self.items[name]:
                line += f"  {self.items[name] / total:8.1f} items/s"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace (host, and the card where there is
    one) into ``log_dir`` as a Chrome trace when it is set; no-op
    otherwise."""
    if not log_dir:
        yield
        return
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
