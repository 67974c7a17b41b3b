"""Host cost of one launch through the doubling probe's wrapper, step by step.

    python -m canonswap_torch.tools.launch_cost            # every step
    PYTHONPATH=<checkout> python3 <this file> --whole       # another tree

On the card, at the doubling probe's (256, 512) f32 input, times each step
that a wrapper of ``ops/cuda/`` takes, or once took, to launch its kernel,
the whole wrapper (``ops/cuda/probes.py::dbl_cuda``) and one PyTorch call of
the same function (``torch.mul(x, 2.0)``).  Each is called in 10 rounds of
100 calls; a round is timed with ``time.perf_counter`` after a synchronize,
with no synchronize inside it.  Prints one JSON line: the median
microseconds per call of each step.  It writes no file.

``--whole`` times only the whole wrapper and ``torch.mul``, with nothing
but ``dbl_cuda`` taken from the package: run by path with another
checkout's root on ``PYTHONPATH``, it times that checkout's wrapper.

Steps:
  checks          the wrapper's dtype, device and layout checks
  empty_like      the output's allocation
  x_device        reading ``x.device`` (a new ``torch.device`` each time)
  data_ptrs       the two ``data_ptr()`` reads
  device_context  entering and leaving ``with torch.cuda.device(x.device)``
  stream_object   ``torch.cuda.current_stream(x.device).cuda_stream``
  current_device  ``torch._C._cuda_getDevice()``
  raw_stream      ``torch._C._cuda_getCurrentRawStream(index)``
  ctypes_launch   the bound C entry point alone (the kernel's launch)
  launch_on       ``CudaKernel.launch_on``: the launch path of every wrapper
  dbl_cuda        the whole wrapper
  torch_mul       ``torch.mul(x, 2.0)``
"""

from __future__ import annotations

import json
import sys
import time

import torch

from canonswap_torch.ops.cuda import probes as PR

ROUNDS, CALLS = 10, 100


def host_us(fn, rounds: int = ROUNDS, calls: int = CALLS) -> float:
    """Median over ``rounds`` of the host microseconds per call of ``fn``,
    ``calls`` calls a round, with no synchronize inside a round."""
    fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per_call)[len(per_call) // 2]


def measure(seed: int = 0, whole: bool = False) -> dict:
    """{step: host us per call} for the doubling probe's launch (module
    docstring); only ``dbl_cuda`` and ``torch_mul`` where ``whole``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((256, 512), generator=gen).to("cuda")
    steps = {"dbl_cuda": lambda: PR.dbl_cuda(x),
             "torch_mul": lambda: torch.mul(x, 2.0)}
    if whole:
        return {name: host_us(step) for name, step in steps.items()}
    out = torch.empty_like(x)
    index = x.device.index
    fn = PR.DOUBLE.load()
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def device_context():
        with torch.cuda.device(x.device):
            pass

    steps = {
        "checks": lambda: PR._check_cuda("dbl", (x,), (torch.float32,)),
        "empty_like": lambda: torch.empty_like(x),
        "x_device": lambda: x.device,
        "data_ptrs": lambda: (x.data_ptr(), out.data_ptr()),
        "device_context": device_context,
        "stream_object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "current_device": torch._C._cuda_getDevice,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "ctypes_launch": lambda: fn(xp, op, n, stream),
        "launch_on": lambda: PR.DOUBLE.launch_on(x.device, xp, op, n),
        **steps,
    }
    return {name: host_us(step) for name, step in steps.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("launch_cost: no CUDA device")
    whole = "--whole" in argv
    print(json.dumps({"tool": "launch_cost", "input": [256, 512],
                      "rounds": ROUNDS, "calls": CALLS,
                      "wrapper": PR.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "host_us_per_call": measure(whole=whole)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
