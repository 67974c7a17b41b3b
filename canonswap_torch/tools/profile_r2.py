"""The toolchain probes on the card: the port's counterpart of the Pallas
stages of ``tools/profile_r2b.py`` and ``tools/profile_r2c.py``.

    python -m canonswap_torch.tools.profile_r2 [stage ...]

Runs each probe kernel (``ops/cuda/probes.py``) at the JAX tools' shapes,
under their stage names, and prints one JSON line per stage,
``{"stage", "ms_per_step", "batch"}``, the time of one call from CUDA
events (median over 5 runs of the mean of 20 calls, after a warm-up).
``batch`` is the tools' B.  Stage names given as arguments select stages.
It writes no file.  The tools' other stages measure TPU layouts and have
no counterpart here.
"""

from __future__ import annotations

import json
import sys

import torch

from canonswap_torch.ops.cuda.probes import dbl, dyn_gather, mm
from canonswap_torch.runtime.device import resolve_device

B = 16  # the JAX tools' batch


def stages(device: str | torch.device = "cuda", seed: int = 0):
    """Yield (stage name, (fn, inputs)) at the JAX tools' shapes, the
    inputs made on the CPU from ``seed`` and moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    # profile_r2b.py:201-207: one (1024, 2048) f32 block and int32 row
    # indices in [0, 1024), broadcast to B (made contiguous here: the
    # kernel reads (B, R, C) arrays)
    x = torch.randn((1024, 2048), generator=gen)
    idx = torch.randint(0, 1024, (1024, 2048), generator=gen,
                        dtype=torch.int32)
    xb = x.expand(B, -1, -1).contiguous().to(dev)
    ib = idx.expand(B, -1, -1).contiguous().to(dev)
    yield "pallas_dynamic_gather_16x", (dyn_gather, (xb, ib))
    # profile_r2c.py:64-65
    yield "pallas_simple_vpu", (dbl, (torch.randn((256, 512),
                                                  generator=gen).to(dev),))
    # profile_r2c.py:81-83
    a = torch.randn((512, 512), generator=gen).to(dev)
    b = torch.randn((512, 512), generator=gen).to(dev)
    yield "pallas_simple_mxu", (mm, (a, b))


def time_ms(fn, inputs, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls (CUDA
    events), after one warm-up call."""
    fn(*inputs)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*inputs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def main(argv: list[str] | None = None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    for name, (fn, inputs) in stages("cuda"):
        if only and name not in only:
            continue
        rec = {"stage": name, "ms_per_step": time_ms(fn, inputs), "batch": B}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
