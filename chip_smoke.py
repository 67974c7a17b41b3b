"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: card name and power limit, torch/CUDA versions; the seven
     kernels built at once (one nvcc per source: the three probes share
     one) and their build times;
  2. kernel vs plain: each CUDA kernel against its plain PyTorch version at
     the main paths' shapes, f32 and bf16, and timed at B=8 CANONICAL: the
     exact warp (against its plain version), the W8A8 warp (against its plain
     version and the exact kernel, on both fields in both dtypes, with the
     device time of each kernel of one call, parts_ms, the call's device
     time in a CUDA graph and its host cost) and the W8A8 conv (against
     cuDNN's bf16 conv of the same shape, and its plain f64 version; the
     device time of each of its parts, parts_ms, from one torch.profiler
     pass over one call per site);
  3. main path: CanonSwapCore(CANONICAL) in bf16 with seeded random weights,
     three frame batches through swap_with_motion, the warp's launches counted;
  4. main path fast: the same with fast_bundle(CANONICAL) (half-resolution
     dense motion, W8A8 convs, the W8A8 warp), every kernel's launches
     counted per batch;
  5. card vs CPU: the port at TINY in f32 on the card and on the CPU, for
     the exact path and for fast_bundle(TINY); the fast path also on the
     card with the plain versions in place of the W8A8 kernels, and on the
     CPU in f64, to tell the kernels' error from drift upstream of the
     quantizers;
  6. xpose path: XPoseRunner at full width (UniPoseConfig(), canvas
     (800, 1344), f32) on one 720p frame, three timed images, the
     deformable attention kernel's 12 launches per image counted;
  7. msda kernel: that kernel against its plain version at small ragged
     shapes, at the full-width shapes on random locations (timed, with the
     rate of the 128-byte corner lines), and on the inputs the xpose path
     gave it, timed there beside the plain version and its bound, with the
     line rate, host cost and CUDA-graph device time;
  8. xpose card vs CPU: UniPose at TINY on both, equal top-k selections,
     outputs within 2e-4;
  9. probe kernels: the gather, doubling and matmul probes against their
     plain versions at the JAX tools' shapes (the gather also at a small
     ragged shape with negative and out-of-range indices; the matmul also
     at ragged shapes, twice bit for bit, and on a fresh stream), timed
     beside their plain versions, library calls and bounds, with each
     call's host cost and its device time from a CUDA graph; then the
     probe path, canonswap_torch.tools.profile_r2's stages through its
     entry point;
 10. sidecars path: Landmark203Runner at full width tracking 16 frames of a
     seeded 720p clip, and FaceParser (Segformer MiT-B1, 19 labels) on
     B=8 seeded 256 crops, f32, timed on the host clock, no kernel
     launched;
 11. sidecars card vs CPU: Segformer at TINY and MobileLandmarkNet at a
     small input, outputs within 2e-4, masks equal but at near ties.
Before the last line, one line lists every kernel with its launches on the
main paths, its error against its plain version, its time, the plain
version's, its bound and a library call's time where one computes the same
function (the probes also their host cost and graph-replayed time).  Any
failure exits nonzero.  The last line is the run's one-line verdict.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# f32 tolerance: both sides compute the same f32 sums in another order
F32_TOL = 1e-5
# bf16 tolerance: both sides compute in f32 and round once to bf16; a last
# f32 bit that differs can flip that one rounding, which is one bf16 ulp:
# at most 2**-7 of the value, so 2**-7 of the largest output magnitude
BF16_TOL = 2.0**-7
# W8A8 warp: kernel and plain version quantize, sum integers and round in
# f32 at the same places: bit-identical
WARP_Q_TOL = 0.0
# W8A8 conv: the same integers and steps; the plain version takes the fused
# dequant multiply-add in f64 and rounds twice, which can differ from the
# kernel's f32 fma by one f32 ulp where the f64 sum lands on an f32 tie
# (about 2**-29 of the outputs): 1e-6 of the largest output
QCONV_TOL = 1e-6
# H100 SXM peaks (dense, 700 W; NVIDIA's data sheet): int8 tensor cores,
# float32 outside the tensor cores (the rate of the gather kernels' f32
# arithmetic), and device memory
INT8_PEAK_TOPS = 1979.0
F32_PEAK_TFLOPS = 67.0
HBM_TB_S = 3.35

# The W8A8 conv at the fast main path's B=8 CANONICAL shapes: (label, x
# shape, Cout, kernel, bias, sites per batch).  86 launches per batch: 36 in
# the 3D chains (appearance 6, swap 6, refine 6 blocks, 2 convs each), 14
# adaptive convs (7 blocks x 2, on the 2B-stacked input), 6 in refine's 2D
# blocks, 18 + 6 in the SPADE middles (conv_0/conv_1 and two gamma|beta per
# block), 6 in up_0 (conv_0, conv_1, conv_s and three gamma|beta).
QCONV_SITES = [
    ("adaptive", (16, 512, 64, 64), 512, (3, 3), False, 14),
    ("refine_2d_spade_middle", (8, 512, 64, 64), 512, (3, 3), True, 18),
    ("spade_gamma_beta_64", (8, 128, 64, 64), 1024, (3, 3), True, 12),
    ("spade_gamma_beta_128", (8, 128, 128, 128), 512, (3, 3), True, 3),
    ("up_0_conv_0", (8, 512, 128, 128), 256, (3, 3), True, 1),
    ("up_0_conv_1", (8, 256, 128, 128), 256, (3, 3), True, 1),
    ("up_0_conv_s", (8, 512, 128, 128), 256, (1, 1), False, 1),
    ("chain_3d", (8, 32, 16, 64, 64), 32, (3, 3, 3), True, 36),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, peak_tera_ops: float):
    """The least time the card could take for a call: the bytes it must
    move (each input read once, each output written once) over the memory
    rate, or its operations over their type's peak rate, whichever is
    larger.  Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / (HBM_TB_S * 1e12) * 1e3
    t_ops = ops / (peak_tera_ops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def warp_bound(vol, grid, out):
    """A trilinear warp's bound: 8 corner multiply-adds per output."""
    return bound_ms(nbytes(vol, grid, out), 16.0 * out.numel(),
                    F32_PEAK_TFLOPS)


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max |want|, max |got - want|), in f64."""
    got, want = got.double(), want.double()
    abs_err = float((got - want).abs().max())
    return abs_err / max(float(want.abs().max()), 1e-30), abs_err


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def host_us(fn, rounds: int = 10, calls: int = 100) -> float:
    """A call's host cost: the median over ``rounds`` of the host
    microseconds per call (``time.perf_counter``) of ``calls`` calls with no
    synchronize among them."""
    fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(per_call))


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """A call's device time with the host removed: ``iters`` calls captured
    in one CUDA graph (warmed up on a side stream and captured on
    torch.cuda.graph's own, as PyTorch's graph docs require), replayed
    ``reps`` times, each replay timed with events; the median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times))


def smooth_grid(b, d, h, w, scale, gen, device, dtype):
    """Identity (align_corners=False cell centres) plus a small random
    displacement: the kind of field dense motion emits."""
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) / n * 2 - 1
            for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    ident = torch.stack([xx, yy, zz], -1)[None].float()
    disp = (torch.rand((b, d, h, w, 3), generator=gen) * 2 - 1) * scale
    return (ident + disp).to(device=device, dtype=dtype).contiguous()


KERNEL_NAMES = ("warp3d", "warp3d_q", "qconv", "ms_deform_attn",
                "dyn_gather", "dbl", "mm")


def kernels():
    from canonswap_torch.ops.cuda.ms_deform_attn import MSDA
    from canonswap_torch.ops.cuda.probes import DOUBLE, GATHER, MATMUL
    from canonswap_torch.ops.cuda.qconv import QCONV
    from canonswap_torch.ops.cuda.warp import WARP3D, WARP3D_Q

    return WARP3D, WARP3D_Q, QCONV, MSDA, GATHER, DOUBLE, MATMUL


def launch_counts() -> tuple[int, ...]:
    """Launches so far of each kernel, in KERNEL_NAMES' order."""
    return tuple(k.launches for k in kernels())


def only(**counts) -> tuple[int, ...]:
    """The launch counts of a path that runs the named kernels and no
    other, in KERNEL_NAMES' order."""
    return tuple(counts.get(name, 0) for name in KERNEL_NAMES)


def reset_launch_counts() -> None:
    for k in kernels():
        k.launches = 0


def phase_device() -> None:
    from canonswap_torch.ops.cuda.build import build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_all(kernels())
    load_s = time.perf_counter() - t0
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_s={k.source.name: k.build_seconds for k in kernels()},
         build_and_load_s=load_s)
    for log in dict.fromkeys(k.build_log for k in kernels()):
        print(log.strip(), flush=True)


def phase_kernel() -> dict:
    from canonswap_torch.ops.cuda.warp import (
        grid_sample_3d_cuda, grid_sample_3d_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = []
    # (label, vol NCDHW shape, grid shape, grid range)
    shapes = [
        ("canonical_r1.0", (2, 32, 16, 64, 64), (2, 16, 64, 64, 3), 1.0),
        ("canonical_r1.4", (2, 32, 16, 64, 64), (2, 16, 64, 64, 3), 1.4),
        ("ragged", (1, 16, 4, 8, 24), (1, 6, 8, 24, 3), 1.1),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for label, vshape, gshape, rng in shapes:
            vol = torch.randn(vshape, generator=gen).to(dev, dtype)
            grid = ((torch.rand(gshape, generator=gen) * 2 - 1) * rng).to(
                dev, dtype)
            got = grid_sample_3d_cuda(vol, grid)
            want = grid_sample_3d_plain(vol, grid)
            torch.cuda.synchronize()
            rel, _ = max_rel_err(got, want)
            cases.append({"case": label, "dtype": str(dtype), "rel": rel,
                          "tol": tol})
            worst[dtype] = max(worst[dtype], rel)
            if not rel <= tol:
                emit("kernel_vs_plain", cases=cases, ok=False)
                raise AssertionError(
                    f"warp3d vs plain {label} {dtype}: rel {rel} > {tol}")
    # at the main path's shape: B=8 CANONICAL, both call sites' (D, H, W)
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        vol = torch.randn((8, 32, 16, 64, 64), generator=gen).to(dev, dtype)
        for field, grid in (
            ("smooth", smooth_grid(8, 16, 64, 64, 0.05, gen, dev, dtype)),
            ("random", ((torch.rand((8, 16, 64, 64, 3), generator=gen) * 2
                         - 1)).to(dev, dtype)),
        ):
            got = grid_sample_3d_cuda(vol, grid)
            want = grid_sample_3d_plain(vol, grid)
            rel, abs_err = max_rel_err(got, want)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            if not rel <= tol:
                raise AssertionError(
                    f"warp3d vs plain B=8 {field} {dtype}: rel {rel} > {tol}")
            # plain, kernel, kernel, plain: compare within one call
            p1 = time_ms(lambda: grid_sample_3d_plain(vol, grid))
            k1 = time_ms(lambda: grid_sample_3d_cuda(vol, grid))
            k2 = time_ms(lambda: grid_sample_3d_cuda(vol, grid))
            p2 = time_ms(lambda: grid_sample_3d_plain(vol, grid))
            # the library call computing the same function on the same
            # tensors, as a yardstick
            lib = time_ms(lambda: torch.nn.functional.grid_sample(
                vol, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False))
            bound, bound_by = warp_bound(vol, grid, got)
            timings[f"{field}_{str(dtype).split('.')[-1]}"] = {
                "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                "library_ms": lib, "bound_ms": bound, "bound_by": bound_by,
                "rel": rel, "max_abs_err": abs_err}
    emit("kernel_vs_plain", cases=cases, timings_b8=timings,
         worst_rel_f32=worst[torch.float32],
         worst_rel_bf16=worst[torch.bfloat16], ok=True)
    return timings


def phase_warp_q_kernel() -> dict:
    """The W8A8 warp against its plain version, f32 and bf16, and timed at
    B=8 CANONICAL beside its plain version and the exact kernel."""
    from canonswap_torch.ops.cuda.warp import (
        grid_sample_3d_cuda, grid_sample_3d_quant_cuda,
        grid_sample_3d_quant_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    cases, worst = [], 0.0
    shapes = [
        ("canonical_r1.0", (2, 32, 16, 64, 64), (2, 16, 64, 64, 3), 1.0),
        ("canonical_r1.4", (2, 32, 16, 64, 64), (2, 16, 64, 64, 3), 1.4),
        ("ragged", (1, 16, 4, 8, 24), (1, 6, 8, 24, 3), 1.1),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for label, vshape, gshape, rng in shapes:
            vol = torch.randn(vshape, generator=gen).to(dev, dtype)
            grid = ((torch.rand(gshape, generator=gen) * 2 - 1) * rng).to(
                dev, dtype)
            got = grid_sample_3d_quant_cuda(vol, grid)
            want = grid_sample_3d_quant_plain(vol, grid)
            torch.cuda.synchronize()
            rel, abs_err = max_rel_err(got, want)
            cases.append({"case": label, "dtype": str(dtype), "rel": rel,
                          "max_abs_err": abs_err, "tol": WARP_Q_TOL})
            worst = max(worst, abs_err)
            if not abs_err <= WARP_Q_TOL:
                emit("kernel_vs_plain", kernel="warp3d_q", cases=cases,
                     ok=False)
                raise AssertionError(
                    f"warp3d_q vs plain {label} {dtype}: max abs {abs_err}")
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        vol = torch.randn((8, 32, 16, 64, 64), generator=gen).to(dev, dtype)
        for field, grid in (
            ("smooth", smooth_grid(8, 16, 64, 64, 0.05, gen, dev, dtype)),
            ("random", ((torch.rand((8, 16, 64, 64, 3), generator=gen) * 2
                         - 1)).to(dev, dtype)),
        ):
            got = grid_sample_3d_quant_cuda(vol, grid)
            want = grid_sample_3d_quant_plain(vol, grid)
            _, abs_err = max_rel_err(got, want)
            if not abs_err <= WARP_Q_TOL:
                raise AssertionError(
                    f"warp3d_q vs plain B=8 {field} {dtype}: {abs_err}")
            def call(vol=vol, grid=grid):
                return grid_sample_3d_quant_cuda(vol, grid)

            p1 = time_ms(lambda: grid_sample_3d_quant_plain(vol, grid))
            k1 = time_ms(call)
            k2 = time_ms(call)
            p2 = time_ms(lambda: grid_sample_3d_quant_plain(vol, grid))
            exact = time_ms(lambda: grid_sample_3d_cuda(vol, grid))
            bound, bound_by = warp_bound(vol, grid, got)
            timings[f"{field}_{str(dtype).split('.')[-1]}"] = {
                "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                "exact_kernel_ms": exact, "bound_ms": bound,
                "bound_by": bound_by, "max_abs_err": abs_err,
                "parts_ms": device_parts_ms(call), "graph_ms": graph_ms(call),
                "host_us": host_us(call)}
    emit("kernel_vs_plain", kernel="warp3d_q", cases=cases,
         timings_b8=timings, worst_max_abs_err=worst, ok=True)
    return {"timings": timings, "worst": worst}


def phase_qconv_kernel() -> dict:
    """The W8A8 conv against its plain version at every shape of the fast
    path (B=2, the adaptive conv's stacked 2B = 4) and a ragged case, f32
    and bf16; then at the B=8 shapes the main path gives it (bf16), checked
    the same way and timed beside cuDNN's bf16 conv of the same shape, the
    plain version's weight quantization and the plain f64 version, with the
    device time of each of the call's parts (parts_ms)."""
    import torch.nn.functional as F

    from canonswap_torch.ops.cuda.qconv import conv_w8a8_cuda
    from canonswap_torch.ops.qconv import conv_w8a8_plain
    from canonswap_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)

    def operands(shape, cout, k, bias, dtype):
        x = torch.randn(shape, generator=gen).to(dev, dtype)
        fan_in = shape[1] * int(np.prod(k))
        w = (torch.randn((cout, shape[1], *k), generator=gen)
             / fan_in**0.5).to(dev, dtype)
        b = (torch.randn(cout, generator=gen) * 0.05).to(dev, dtype) \
            if bias else None
        return x, w, b

    checks = [(label, (shape[0] // 4, *shape[1:]), cout, k, bias)
              for label, shape, cout, k, bias, _ in QCONV_SITES]
    checks.append(("ragged_k7_cin6", (2, 6, 37, 29), 16, (7, 7), False))
    cases, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, cout, k, bias in checks:
            x, w, b = operands(shape, cout, k, bias, dtype)
            got = conv_w8a8_cuda(x, w, b)
            want = conv_w8a8_plain(x, w, b)
            torch.cuda.synchronize()
            rel, abs_err = max_rel_err(got, want)
            cases.append({"case": label, "shape": list(shape),
                          "dtype": str(dtype), "rel": rel,
                          "max_abs_err": abs_err, "tol": QCONV_TOL})
            worst = max(worst, abs_err)
            if not rel <= QCONV_TOL:
                emit("kernel_vs_plain", kernel="qconv", cases=cases, ok=False)
                raise AssertionError(
                    f"qconv vs plain {label} {dtype}: rel {rel}")
    # at the main path's B=8 shapes: checked, then timed.  The kernel's call
    # quantizes the weight too; the plain version's weight quantization in
    # torch ops is timed beside it, for what running it as torch ops costs.
    timings, conv_ms, cudnn_ms, wq_ms, calls = {}, 0.0, 0.0, 0.0, {}
    for label, shape, cout, k, bias, sites in QCONV_SITES:
        x, w, b = operands(shape, cout, k, bias, torch.bfloat16)
        got = conv_w8a8_cuda(x, w, b)
        want = conv_w8a8_plain(x, w, b)
        rel, abs_err = max_rel_err(got, want)
        worst = max(worst, abs_err)
        if not rel <= QCONV_TOL:
            raise AssertionError(f"qconv vs plain B=8 {label}: rel {rel}")
        moved = nbytes(x, w, got) + (0 if b is None else nbytes(b))
        del got, want
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        pad = tuple(n // 2 for n in k)
        c1 = time_ms(lambda: conv(x, w, b, padding=pad))
        k1 = time_ms(lambda: conv_w8a8_cuda(x, w, b))
        k2 = time_ms(lambda: conv_w8a8_cuda(x, w, b))
        c2 = time_ms(lambda: conv(x, w, b, padding=pad))
        wq = time_ms(lambda: quantize_weight(w))
        plain = time_ms(lambda: conv_w8a8_plain(x, w, b), iters=2, reps=3)
        calls[label] = lambda x=x, w=w, b=b: conv_w8a8_cuda(x, w, b)
        ops = 2.0 * x.numel() // shape[1] * cout * shape[1] * np.prod(k)
        bound, bound_by = bound_ms(moved, ops, INT8_PEAK_TOPS)
        kms = float(np.median([k1, k2]))
        timings[label] = {
            "kernel_ms": [k1, k2], "cudnn_bf16_ms": [c1, c2],
            "plain_weight_quantize_ms": wq, "plain_f64_ms": plain,
            "rel": rel, "max_abs_err": abs_err, "tera_ops": ops / 1e12,
            "kernel_tops": ops / kms / 1e9,
            "int8_peak_share": ops / kms / 1e9 / INT8_PEAK_TOPS,
            "bound_ms": bound, "bound_by": bound_by,
            "sites_per_batch": sites}
        conv_ms += sites * kms
        cudnn_ms += sites * float(np.median([c1, c2]))
        wq_ms += sites * wq
    for label, parts in qconv_parts_ms(calls).items():
        timings[label]["parts_ms"] = parts
    emit("kernel_vs_plain", kernel="qconv", cases=cases, timings_b8=timings,
         worst_max_abs_err=worst, sites_kernel_ms_per_batch=conv_ms,
         sites_cudnn_bf16_ms_per_batch=cudnn_ms,
         sites_plain_weight_quantize_ms_per_batch=wq_ms, ok=True)
    return {"timings": timings, "worst": worst}


def device_parts_ms(fn) -> list:
    """[kernel name, device ms] of every device event of one call of ``fn``,
    in time order, from one torch.profiler pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise AssertionError("profile: no device event")
    return [[e.name[:60], e.time_range.elapsed_us() / 1e3] for e in dev]


# the W8A8 conv's parts, in launch order, by a substring of their CUDA
# kernel names; the last is the GEMM (the ring kernel or the halo kernel)
QCONV_PARTS = (("memset", "Memset"), ("absmax", "absmax_kernel"),
               ("quantize_weight", "quantize_weight_kernel"),
               ("quantize_act", "quantize_act_kernel"), ("gemm", "qconv_"))


def qconv_parts_ms(calls: dict) -> dict:
    """Device ms of each part of one W8A8 conv call, by kernel name, for
    each ``{label: fn}``: one torch.profiler pass over one call of each fn;
    the device events, in time order, fall into calls of five parts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in dev]
    if len(dev) != len(QCONV_PARTS) * len(calls) or not all(
            sub in name for name, (_, sub) in
            zip(names, QCONV_PARTS * len(calls))):
        raise AssertionError(f"qconv profile: device events {names}")
    out = {}
    for i, label in enumerate(calls):
        out[label] = {part: dev[i * len(QCONV_PARTS) + j].time_range
                      .elapsed_us() / 1e3
                      for j, (part, _) in enumerate(QCONV_PARTS)}
    return out


def qconv_sites(cfg) -> int:
    """W8A8 conv launches per batch of the fast path, from the JAX
    package's gates (int8_worthwhile: Cin >= 128 and H <= 128)."""
    a, sw, sp = cfg.appearance, cfg.swap, cfg.spade
    hw = cfg.input_size // 2**a.num_down_blocks  # the volume's plane

    def big(cin, h):
        return int(cin >= 128 and h <= 128)

    cd = a.reshape_channel * a.reshape_depth
    n = 2 * a.num_resblocks + 2 * sw.n_resblocks_3d + 2 * 6  # 3D chains
    n += 2 * sw.n_blocks * big(cd, hw) + 6 * big(cd, hw)  # adaptive, refine
    ic = min(sp.max_features, sp.block_expansion * 2**sp.num_down_blocks)
    n += 6 * (2 * big(2 * ic, hw) + 2 * big(128, hw))  # G_middle_0..5
    n += 2 * big(2 * ic, 2 * hw) + big(ic, 2 * hw) + 3 * big(128, 2 * hw)
    return n


def synthetic_motion(b, k, gen, device, dtype):
    """In-range motion (bench.py's): posed keypoints N(0, 0.25^2), canonical
    ones 0.1 away, unit scale, so the warp gathers inside the volume."""
    x_t = torch.randn((b, k, 3), generator=gen) * 0.25
    kp = x_t + torch.randn((b, k, 3), generator=gen) * 0.1
    return {"x_t": x_t.to(device, dtype), "kp": kp.to(device, dtype),
            "scale": torch.ones((b, 1)).to(device, dtype)}


def stage_times(core, frames, sid) -> dict:
    """Device ms of each stage of one swap_with_motion batch (CUDA events)."""
    from canonswap_torch.runtime import core as C

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        return out, (start, end)

    ev = {}
    sid = sid.expand(frames.shape[0], -1).to(frames.dtype)
    with torch.inference_mode():
        motion, ev["extract_motion"] = timed(
            lambda: C.extract_motion(core, frames))
        f_s, ev["appearance"] = timed(
            lambda: C.appearance_features(core, frames))
        x_can = (motion["scale"][..., None] * motion["kp"]).to(frames.dtype)
        x_t = motion["x_t"].to(frames.dtype)
        (f_can, _), ev["warp_to_canonical"] = timed(
            lambda: C.warp_to_canonical(core, f_s, x_t, x_can))
        f_swap, ev["inject_identity"] = timed(
            lambda: C.inject_identity(core, f_can, sid))
        f_ref, ev["refine"] = timed(lambda: C.refine_volume(core, f_swap))
        _, ev["warp_decode"] = timed(
            lambda: C.warp_decode(core, f_ref, x_can, x_t))
    torch.cuda.synchronize()
    return {k: s.elapsed_time(e) for k, (s, e) in ev.items()}


def phase_main_path() -> dict:
    from canonswap_torch.configs import CANONICAL
    from canonswap_torch.ops.cuda.warp import WARP3D
    from canonswap_torch.runtime import core as C

    dev, dtype, b = torch.device("cuda"), torch.bfloat16, 8
    t0 = time.perf_counter()
    core = C.CanonSwapCore(CANONICAL, seed=0).to(dtype)
    init_s = time.perf_counter() - t0
    s = CANONICAL.input_size
    gen = torch.Generator().manual_seed(1)
    batches = [torch.rand((b, s, s, 3), generator=gen).to(dev, dtype)
               for _ in range(4)]
    sid = torch.nn.functional.normalize(
        torch.randn((1, CANONICAL.swap.latent_dim), generator=gen), dim=-1
    ).to(dev)
    # set-up: one batch for cuDNN's algorithm choice and the kernel build
    C.swap_with_motion(core, batches[0], sid, as_uint8=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms, per_batch = [], []
    for frames in batches[1:]:
        before = WARP3D.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, motion = C.swap_with_motion(core, frames, sid, as_uint8=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        per_batch.append(WARP3D.launches - before)
        img = out["out"]
        if img.shape != (b, 2 * s, 2 * s, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"main path output {img.shape} {img.dtype}")
    launches = launch_counts()
    if per_batch != [2, 2, 2] or launches != only(warp3d=6):
        raise AssertionError(
            f"warp launches per batch {per_batch} != 2, or the exact path "
            f"launched another kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    img_f = img.float()
    # the same path at in-range motion: the warp gathers inside the volume
    motion_syn = synthetic_motion(b, CANONICAL.motion.num_kp, gen, dev, dtype)
    with torch.inference_mode():
        syn = C.swap_step(core, batches[1], sid, motion_syn)["out"]
    if not bool(torch.isfinite(syn.float()).all()):
        raise AssertionError("swap_step at in-range motion: non-finite output")
    stages = stage_times(core, batches[1], sid)
    med = float(np.median(ms))
    emit("main_path", config="CANONICAL", dtype="bf16", batch=b,
         init_s=init_s, ms_per_batch=ms, median_ms=med,
         frames_per_s=b / (med / 1e3), warp_launches_per_batch=per_batch,
         max_memory_allocated=peak, stage_ms=stages,
         stage_sum_ms=sum(stages.values()),
         out_mean=float(img_f.mean()), out_std=float(img_f.std()),
         x_t_absmax=float(motion["x_t"].abs().max()),
         in_range_out_mean=float(syn.float().mean()),
         in_range_out_std=float(syn.float().std()))
    return {"launches": launches[0], "batches": batches, "sid": sid,
            "img": img, "median_ms": med, "stage_ms": stages}


def phase_main_path_fast(exact: dict) -> dict:
    """fast_bundle(CANONICAL) in bf16, B=8, from the exact run's seed and
    frames: launches per batch, timing, and |fast - exact| for information
    (the weights are random)."""
    from canonswap_torch.configs import CANONICAL, fast_bundle
    from canonswap_torch.runtime import core as C

    dev, dtype, b = torch.device("cuda"), torch.bfloat16, 8
    cfg = fast_bundle(CANONICAL)
    want = only(warp3d_q=2, qconv=qconv_sites(cfg))
    t0 = time.perf_counter()
    core = C.CanonSwapCore(cfg, seed=0).to(dtype)
    init_s = time.perf_counter() - t0
    s = CANONICAL.input_size
    batches, sid = exact["batches"], exact["sid"]
    C.swap_with_motion(core, batches[0], sid, as_uint8=True)  # set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms, per_batch = [], []
    for frames in batches[1:]:
        before = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, _ = C.swap_with_motion(core, frames, sid, as_uint8=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        per_batch.append(tuple(
            n - m for n, m in zip(launch_counts(), before)))
        img = out["out"]
        if img.shape != (b, 2 * s, 2 * s, 3) or img.dtype != torch.uint8:
            raise AssertionError(f"fast path output {img.shape} {img.dtype}")
    launches = launch_counts()
    if per_batch != [want] * 3:
        raise AssertionError(
            f"fast path launches per batch ({KERNEL_NAMES}) {per_batch} != "
            f"{want}")
    peak = torch.cuda.max_memory_allocated()
    fast_vs_exact = float(
        (img.float() - exact["img"].float()).abs().mean())
    gen = torch.Generator().manual_seed(5)
    motion_syn = synthetic_motion(b, CANONICAL.motion.num_kp, gen, dev, dtype)
    with torch.inference_mode():
        syn = C.swap_step(core, batches[1], sid, motion_syn)["out"]
    if not bool(torch.isfinite(syn.float()).all()):
        raise AssertionError("fast swap_step at in-range motion: non-finite")
    stages = stage_times(core, batches[1], sid)
    med = float(np.median(ms))
    emit("main_path_fast", config="fast_bundle(CANONICAL)", dtype="bf16",
         batch=b, init_s=init_s, ms_per_batch=ms, median_ms=med,
         frames_per_s=b / (med / 1e3), exact_median_ms=exact["median_ms"],
         launches_per_batch=[list(p) for p in per_batch],
         launches_order=list(KERNEL_NAMES),
         max_memory_allocated=peak, stage_ms=stages,
         stage_sum_ms=sum(stages.values()), exact_stage_ms=exact["stage_ms"],
         mean_abs_uint8_fast_vs_exact=fast_vs_exact,
         in_range_out_mean=float(syn.float().mean()),
         in_range_out_std=float(syn.float().std()))
    return {"launches": launches}


def phase_card_vs_cpu() -> None:
    """The port at TINY in f32, TF32 off: kernel on the card, plain
    versions on the CPU, same weights and inputs.  Bound: the port's
    tolerance against the JAX package, 2e-4 (max abs, images in [0, 1]):
    both sides compute in f32, with conv algorithms that sum in another
    order."""
    from canonswap_torch.configs import TINY
    from canonswap_torch.ops.cuda.warp import WARP3D
    from canonswap_torch.runtime import core as C

    reset_launch_counts()
    bound = 2e-4
    dev = torch.device("cuda")
    cpu_core = C.CanonSwapCore(TINY, seed=5, device="cpu")
    gpu_core = C.CanonSwapCore(TINY, seed=5)
    gen = torch.Generator().manual_seed(2)
    frames = torch.rand((2, TINY.input_size, TINY.input_size, 3),
                        generator=gen)
    sid = torch.nn.functional.normalize(
        torch.randn((1, TINY.swap.latent_dim), generator=gen), dim=-1)
    motion = synthetic_motion(2, TINY.motion.num_kp, gen, "cpu", torch.float32)
    before = WARP3D.launches
    with torch.inference_mode():
        want = C.swap_with_motion(cpu_core, frames, sid)[0]["out"]
        got = C.swap_with_motion(gpu_core, frames.to(dev), sid.to(dev))[0][
            "out"].cpu()
        want_syn = C.swap_step(cpu_core, frames, sid, motion)["out"]
        got_syn = C.swap_step(gpu_core, frames.to(dev), sid.to(dev), {
            k: v.to(dev) for k, v in motion.items()})["out"].cpu()
    if WARP3D.launches - before != 4:
        raise AssertionError("TINY on the card did not launch the warp 4x")
    rel, abs_err = max_rel_err(got, want)
    rel_syn, abs_syn = max_rel_err(got_syn, want_syn)
    emit("card_vs_cpu", config="TINY", dtype="f32", bound_max_abs=bound,
         swap_with_motion_max_abs=abs_err, swap_with_motion_rel=rel,
         in_range_swap_step_max_abs=abs_syn, in_range_swap_step_rel=rel_syn)
    if not (abs_err <= bound and abs_syn <= bound):
        raise AssertionError(
            f"card vs CPU: max abs {abs_err}, {abs_syn} > {bound}")


def phase_card_vs_cpu_fast() -> None:
    """fast_bundle(TINY) in f32, TF32 off, the same weights and inputs, two
    image sets (swap_with_motion and swap_step at in-range motion), images
    in [0, 1].  At TINY the 3D chains, the SPADE convs and gamma|beta run
    int8 (Cin >= 128); swap's and refine's 2D convs do not (Cin = 64).
    Three comparisons:

    1. kernels vs plain on the card: the card's core once with the W8A8
       kernels and once with their plain versions on the same CUDA tensors.
       Every other op is the same op on the same card, and each kernel
       equals its plain version at every checked shape, so a difference is
       a kernel's: bound max abs 2e-4, the port's tolerance.
    2. drift on the CPU: the plain path in f32 against the same path in f64.
       An ulp-level change upstream of a quantizer moves an activation by
       one quantum where it falls near a rounding tie (about 1e-3 of an
       output), and the random weights amplify that through the 45 W8A8
       convs.  This measures the amplification, with no kernel involved.
    3. card vs CPU: the kernels' run against the CPU's f32 run.  The card's
       f32 convs sum in another order than the CPU's, an ulp-level change of
       the same kind as 2.  Bound: the mean |card - CPU| of each set at most
       3x that set's mean f32-vs-f64 drift (two draws of one amplification,
       so their ratio scatters: 1.1 and 1.8 in the first card runs) and at
       most 0.05."""
    from unittest import mock

    import canonswap_torch.ops.cuda.warp as W
    import canonswap_torch.ops.qconv as Q
    from canonswap_torch.configs import TINY, fast_bundle
    from canonswap_torch.runtime import core as C

    plain_bound, drift_factor, cap = 2e-4, 3.0, 0.05
    cfg = fast_bundle(TINY)
    dev = torch.device("cuda")
    cpu_core = C.CanonSwapCore(cfg, seed=5, device="cpu")
    gpu_core = C.CanonSwapCore(cfg, seed=5)
    f64_core = C.CanonSwapCore(cfg, seed=5, device="cpu").double()
    gen = torch.Generator().manual_seed(2)
    frames = torch.rand((2, TINY.input_size, TINY.input_size, 3),
                        generator=gen)
    sid = torch.nn.functional.normalize(
        torch.randn((1, TINY.swap.latent_dim), generator=gen), dim=-1)
    motion = synthetic_motion(2, TINY.motion.num_kp, gen, "cpu", torch.float32)

    def run(core, device, dtype):
        """(swap_with_motion, swap_step) images of ``core``, on the CPU."""
        to = lambda v: v.to(device, dtype)  # noqa: E731
        with torch.inference_mode():
            a = C.swap_with_motion(core, to(frames), to(sid))[0]["out"]
            b = C.swap_step(core, to(frames), to(sid),
                            {k: to(v) for k, v in motion.items()})["out"]
        return a.cpu().double(), b.cpu().double()

    reset_launch_counts()
    card = run(gpu_core, dev, torch.float32)
    launches = launch_counts()
    want = only(warp3d_q=4, qconv=2 * qconv_sites(cfg))
    if launches != want:
        raise AssertionError(
            f"fast TINY on the card launched ({KERNEL_NAMES}) {launches}, "
            f"not {want}")
    with mock.patch.object(Q, "conv_w8a8_cuda", Q.conv_w8a8_plain), \
            mock.patch.object(W, "grid_sample_3d_quant_cuda",
                              W.grid_sample_3d_quant_plain):
        card_plain = run(gpu_core, dev, torch.float32)
    if launch_counts() != launches:
        raise AssertionError("the plain run on the card launched a kernel")
    cpu = run(cpu_core, "cpu", torch.float32)
    cpu64 = run(f64_core, "cpu", torch.float64)
    names = ("swap_with_motion", "in_range_swap_step")
    stats = {}
    for name, k, p, c, c64 in zip(names, card, card_plain, cpu, cpu64):
        stats[name] = {
            "kernels_vs_plain_on_card_max_abs": float((k - p).abs().max()),
            "cpu_f32_vs_f64_mean_abs": float((c - c64).abs().mean()),
            "card_vs_cpu_mean_abs": float((k - c).abs().mean()),
            "card_vs_cpu_max_abs": float((k - c).abs().max())}
    emit("card_vs_cpu_fast", config="fast_bundle(TINY)", dtype="f32",
         launches=list(launches), bound_kernels_vs_plain_max_abs=plain_bound,
         bound_card_vs_cpu_mean_abs=f"min({cap}, {drift_factor} x drift)",
         **stats)
    for name, st in stats.items():
        if not st["kernels_vs_plain_on_card_max_abs"] <= plain_bound:
            raise AssertionError(f"fast TINY {name}: kernels vs plain on the "
                                 f"card {st} over {plain_bound}")
        bound = min(cap, drift_factor * st["cpu_f32_vs_f64_mean_abs"])
        if not st["card_vs_cpu_mean_abs"] <= bound:
            raise AssertionError(
                f"fast TINY {name}: card vs CPU {st} over {bound}")


# XPose at full width: the reference's canvas (animal_landmark_runner.py:
# short side 800, long side <= 1333, as canonswap_tpu's runner records it),
# one 720p frame letterboxed into it, 9 keypoints
XPOSE_CANVAS = (800, 1344)
XPOSE_IMAGE = (720, 1280)
XPOSE_KEYPOINTS = 9
# (label, Lq) of the deformable attention's calls per forward at full
# width: 6 encoder layers, 2 box decoder layers (900 queries), 4 keypoint
# decoder layers (50 groups of 1 + 68 queries)
MSDA_CALLS = (("encoder", 22323, 6), ("decoder_box", 900, 2),
              ("decoder_kpt", 3450, 4))
MSDA_PER_FORWARD = sum(n for _, _, n in MSDA_CALLS)


def clip_like_embeddings(seed: int, n_kpt: int):
    """Seeded stand-ins for the CLIP text embeddings (unit rows, 512 wide):
    one instance prompt and n_kpt keypoint prompts."""
    g = np.random.default_rng(seed)
    ins = g.standard_normal((1, 512))
    kpt = g.standard_normal((n_kpt, 512))
    return [(a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
            for a in (ins, kpt)]


def module_times(model, fn) -> dict:
    """Device ms per kind of UniPose module over one call of ``fn`` (CUDA
    events from forward hooks).  "msda" is the deformable attention inside
    the encoder and decoder layers, counted in those layers too."""
    enc, dec = model.transformer.encoder, model.transformer.decoder
    groups = {
        "backbone": [model.backbone[0]], "input_proj": list(model.input_proj),
        "fusion": list(enc.fusion_layers), "text": list(enc.text_layers),
        "encoder_layers": list(enc.layers), "decoder_layers": list(dec.layers),
        "msda": [m.self_attn for m in enc.layers]
        + [m.cross_attn for m in dec.layers]}
    events = {k: [] for k in groups}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    handles = []
    for name, mods in groups.items():
        for mod in mods:
            handles.append(mod.register_forward_pre_hook(
                lambda _m, _a, name=name: events[name].append([event()])))
            handles.append(mod.register_forward_hook(
                lambda _m, _a, _o, name=name: events[name][-1].append(
                    event())))
    try:
        start = event()
        fn()
        end = event()
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    out = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in events.items()}
    out["forward"] = start.elapsed_time(end)
    return out


def capture_msda_inputs(fn) -> dict:
    """The deformable attention kernel's inputs in one call of ``fn``, the
    first of each query count: {Lq: (value, shapes, locations, weights)}."""
    from unittest import mock

    import canonswap_torch.ops.cuda.ms_deform_attn as MS

    seen = {}
    real = MS.ms_deform_attn_cuda

    def recording(value, shapes, loc, w):
        if loc.shape[1] not in seen:
            seen[loc.shape[1]] = (value.clone(), shapes, loc.clone(),
                                  w.clone())
        return real(value, shapes, loc, w)

    with mock.patch.object(MS, "ms_deform_attn_cuda", recording):
        fn()
    return seen


def phase_xpose_path() -> dict:
    """XPoseRunner at full width on the card (UniPoseConfig() defaults:
    Swin-T, hidden 256, 6 + 6 layers, 900 queries, 68 keypoint slots, 50
    groups; canvas (800, 1344), 350 text slots, B = 1, f32, seeded weights),
    9 keypoints with seeded CLIP-shaped embeddings: one warm-up, three timed
    images, the deformable attention's launches counted per image."""
    from canonswap_torch.models.xpose.runner import XPoseRunner
    from canonswap_torch.models.xpose.unipose import UniPoseConfig
    from canonswap_torch.ops.cuda.ms_deform_attn import MSDA

    cfg, k = UniPoseConfig(), XPOSE_KEYPOINTS
    t0 = time.perf_counter()
    runner = XPoseRunner(cfg=cfg, canvas=XPOSE_CANVAS, max_text_len=350,
                         seed=0)
    init_s = time.perf_counter() - t0
    img = (np.random.default_rng(6).random((*XPOSE_IMAGE, 3))
           * 255).astype(np.uint8)
    ins, kpt = clip_like_embeddings(7, k)

    def detect():
        return runner.get_unipose_output(img, k, ins_embed=ins,
                                         kpt_embed=kpt)

    detect()  # set-up: cuBLAS and cuDNN choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms, per_image = [], []
    for _ in range(3):
        before = MSDA.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        boxes, kpts, scores = detect()  # ends in a copy to the host
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        per_image.append(MSDA.launches - before)
    launches = launch_counts()
    if (per_image != [MSDA_PER_FORWARD] * 3
            or launches != only(ms_deform_attn=3 * MSDA_PER_FORWARD)):
        raise AssertionError(
            f"xpose: deformable attention launches per image {per_image} != "
            f"{MSDA_PER_FORWARD}, or another kernel launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    m = len(boxes)
    if not (1 <= m <= cfg.num_group and boxes.shape == (m, 4)
            and kpts.shape == (m, 2 * k) and scores.shape == (m,)):
        raise AssertionError(f"xpose detections {boxes.shape} {kpts.shape} "
                             f"{scores.shape}")
    if not all(np.isfinite(a).all() for a in (boxes, kpts, scores)):
        raise AssertionError("xpose detections are not finite")
    raw = runner.predict(img, k, ins_embed=ins, kpt_embed=kpt)
    g, nk = cfg.num_group, cfg.num_body_points
    want_shapes = {"pred_boxes": (1, g, 4), "pred_keypoints": (1, g, 3 * nk),
                   "pred_logits": (1, g, 350), "query_scores": (1, 22323),
                   "query_idx": (1, cfg.num_queries),
                   "group_idx": (1, g)}
    for name, shape in want_shapes.items():
        if tuple(raw[name].shape) != shape:
            raise AssertionError(f"xpose {name} {tuple(raw[name].shape)}")
    for name in ("pred_boxes", "pred_keypoints"):
        if not bool(torch.isfinite(raw[name]).all()):
            raise AssertionError(f"xpose {name} is not finite")
    if not bool(torch.isfinite(raw["pred_logits"].sigmoid()).all()):
        raise AssertionError("xpose sigmoid(pred_logits) is not finite")
    lmk = runner.run(img, k, ins_embed=ins, kpt_embed=kpt)
    h0, w0 = XPOSE_IMAGE
    if (lmk is None or lmk.shape != (k, 2) or not np.isfinite(lmk).all()
            or not ((lmk >= 0).all() and (lmk[:, 0] <= w0).all()
                    and (lmk[:, 1] <= h0).all())):
        raise AssertionError(f"xpose run(): {lmk}")
    stages = module_times(
        runner.model, lambda: runner.predict(img, k, ins_embed=ins,
                                             kpt_embed=kpt))
    captured = capture_msda_inputs(
        lambda: runner.predict(img, k, ins_embed=ins, kpt_embed=kpt))
    med = float(np.median(ms))
    emit("xpose_path", config="UniPoseConfig()", canvas=list(XPOSE_CANVAS),
         image=list(XPOSE_IMAGE), keypoints=k, dtype="f32", batch=1,
         init_s=init_s, ms_per_image=ms, median_ms=med,
         images_per_s=1e3 / med, msda_launches_per_image=per_image,
         max_memory_allocated=peak, module_ms=stages, detections=m,
         top_score=float(scores.max()), landmarks=lmk.tolist())
    return {"launches": launches[3], "captured": captured,
            "median_ms": med}


def _msda_cases(gen):
    """Small cases: tests/test_ms_deform_attn.py's shapes, a ragged one
    (locations outside [0, 1], zeroed value rows, Lq = 7), a wide one
    (D = 40) and one of 36 samples per query (two passes of the warp's
    lanes), as (label, value, shapes, locations, weights)."""
    cases = []
    for label, (n, m, d, shapes, lq, p, lo, hi, zeroed) in {
        "base": (2, 2, 8, ((6, 4), (3, 2)), 5, 4, 0.01, 0.99, 0),
        "ragged": (1, 3, 16, ((5, 7), (3, 4), (1, 2)), 7, 3, -0.3, 1.3, 9),
        "wide": (1, 2, 40, ((4, 6), (2, 3)), 6, 2, -0.1, 1.1, 4),
        "many_points": (1, 2, 8, ((4, 5), (3, 3), (2, 2)), 5, 12, -0.1, 1.1,
                        3),
    }.items():
        rows = sum(h * w for h, w in shapes)
        value = torch.randn((n, rows, m, d), generator=gen)
        value[:, torch.randperm(rows, generator=gen)[:zeroed]] = 0.0
        loc = lo + (hi - lo) * torch.rand((n, lq, m, len(shapes), p, 2),
                                          generator=gen)
        w = torch.rand((n, lq, m, len(shapes), p), generator=gen)
        w = w / w.sum(dim=(3, 4), keepdim=True)
        cases.append((label, value, shapes, loc, w))
    return cases


def phase_msda_kernel(captured: dict) -> dict:
    """The deformable attention kernel against its plain version on the
    card, f32: the small cases, the full-width shapes at random locations
    (some outside [0, 1]; timed too, with the rate of the corner lines they
    touch), and the inputs the full-width path gave it (one call per query
    count), checked, then timed beside the plain version with the bound of
    each call, the line rate, the call's host cost and its device time in a
    CUDA graph."""
    from canonswap_torch.ops.cuda.ms_deform_attn import (
        ms_deform_attn_cuda, ms_deform_attn_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    cases = []

    def check(label, value, shapes, loc, w):
        got = ms_deform_attn_cuda(value, shapes, loc, w)
        want = ms_deform_attn_plain(value, shapes, loc, w)
        torch.cuda.synchronize()
        rel, abs_err = max_rel_err(got, want)
        cases.append({"case": label, "lq": loc.shape[1], "rel": rel,
                      "max_abs_err": abs_err, "tol": F32_TOL})
        if not rel <= F32_TOL:
            emit("msda_kernel", cases=cases, ok=False)
            raise AssertionError(f"msda vs plain {label}: rel {rel}")
        return got, abs_err

    for label, value, shapes, loc, w in _msda_cases(gen):
        check(label, value.to(dev), shapes, loc.to(dev), w.to(dev))
    def line_gbytes(value, loc):
        """The 128-byte lines the corner reads touch: 4 corners per sample,
        one line per 32 channels."""
        n, _, m, d = value.shape
        return (4 * 128 * n * loc.shape[1] * m * loc.shape[3] * loc.shape[4]
                * (-(-d // 32)) / 1e9)

    # random locations: no neighbour reuse, the L2 floor of the gathers
    shapes = captured[22323][1]
    value = torch.randn((1, 22323, 8, 32), generator=gen).to(dev)
    random = {}
    for label, lq, _ in MSDA_CALLS:
        loc = (torch.rand((1, lq, 8, 4, 4, 2), generator=gen) * 1.1
               - 0.05).to(dev)
        w = torch.rand((1, lq, 8, 4, 4), generator=gen).to(dev)
        w = w / w.sum(dim=(3, 4), keepdim=True)
        check(f"{label}_random", value, shapes, loc, w)
        kms = time_ms(lambda: ms_deform_attn_cuda(value, shapes, loc, w))
        random[label] = {"lq": lq, "kernel_ms": kms,
                         "corner_line_gbytes": line_gbytes(value, loc),
                         "line_gbytes_per_s": line_gbytes(value, loc) / kms
                         * 1e3}
    timings, worst = {}, 0.0
    with torch.inference_mode():
        for label, lq, calls in MSDA_CALLS:
            value, shapes, loc, w = captured[lq]
            got, abs_err = check(f"{label}_path", value, shapes, loc, w)
            worst = max(worst, abs_err)
            def call(value=value, shapes=shapes, loc=loc, w=w):
                return ms_deform_attn_cuda(value, shapes, loc, w)

            p1 = time_ms(lambda: ms_deform_attn_plain(value, shapes, loc, w))
            k1 = time_ms(call)
            k2 = time_ms(call)
            p2 = time_ms(lambda: ms_deform_attn_plain(value, shapes, loc, w))
            n, _, m, d = value.shape
            samples = loc.shape[3] * loc.shape[4]
            # per (query, head, sample, channel): 4 corner multiply-adds and
            # the attention weight's multiply-add
            ops = 10.0 * n * lq * m * samples * d
            bound, bound_by = bound_ms(nbytes(value, loc, w, got), ops,
                                       F32_PEAK_TFLOPS)
            kms = float(np.median([k1, k2]))
            timings[label] = {
                "lq": lq, "calls_per_forward": calls, "kernel_ms": [k1, k2],
                "plain_ms": [p1, p2], "bound_ms": bound, "bound_by": bound_by,
                "bound_share": bound / kms, "mbytes": nbytes(
                    value, loc, w, got) / 1e6, "gflop": ops / 1e9,
                "corner_line_gbytes": line_gbytes(value, loc),
                "line_gbytes_per_s": line_gbytes(value, loc) / kms * 1e3,
                "graph_ms": graph_ms(call), "host_us": host_us(call),
                "max_abs_err": abs_err}
    emit("msda_kernel", cases=cases, timings=timings, random=random,
         worst_path_max_abs_err=worst, kernel_ms_per_forward=sum(
             t["calls_per_forward"] * float(np.median(t["kernel_ms"]))
             for t in timings.values()), ok=True)
    return {"timings": timings, "worst": worst}


def phase_xpose_card_vs_cpu() -> None:
    """UniPose at TINY (canonswap_torch/models/xpose/unipose.py), the card
    against the CPU, same seed and inputs: the image fills the canvas at
    scale 1, so both canvases are the image itself.  The two selections
    (the query and group top-k) must be equal, in order; boxes, keypoints
    and sigmoid(logits) within 2e-4 max abs, the port's tolerance against
    the JAX package: both sides compute in f32 (TF32 off), with sums in
    another order."""
    from canonswap_torch.models.xpose.runner import XPoseRunner
    from canonswap_torch.models.xpose.unipose import TINY

    bound, canvas, k = 2e-4, (64, 96), XPOSE_KEYPOINTS
    img = (np.random.default_rng(9).random((64, 80, 3)) * 255).astype(
        np.uint8)
    ins, kpt = clip_like_embeddings(10, k)
    runners = {dev: XPoseRunner(cfg=TINY, canvas=canvas, max_text_len=8,
                                seed=3, device=dev) for dev in ("cpu", "cuda")}
    reset_launch_counts()
    got = runners["cuda"].predict(img, k, ins_embed=ins, kpt_embed=kpt)
    got = {n: v.cpu() for n, v in got.items()}
    launches = launch_counts()
    if launches != only(ms_deform_attn=TINY.enc_layers + TINY.dec_layers):
        raise AssertionError(f"TINY xpose on the card launched {launches}")
    want = runners["cpu"].predict(img, k, ins_embed=ins, kpt_embed=kpt)
    if launch_counts() != launches:
        raise AssertionError("the CPU run launched a kernel")
    for sel, scores in (("query_idx", "query_scores"),
                        ("group_idx", "group_scores")):
        if not torch.equal(got[sel], want[sel]):
            ranked = want[scores].sort(dim=-1, descending=True)[0][0]
            j = int((got[sel] != want[sel]).nonzero()[0, 1])
            raise AssertionError(
                f"xpose card vs CPU: {sel} differs first at rank {j}; CPU "
                f"scores there {ranked[max(j - 1, 0):j + 2].tolist()}, card "
                f"scores up to {float((got[scores] - want[scores]).abs().max())}"
                f" from the CPU's")
    errs = {name: float((fn(got[name]) - fn(want[name])).abs().max())
            for name, fn in (("pred_boxes", lambda x: x),
                             ("pred_keypoints", lambda x: x),
                             ("pred_logits", torch.sigmoid))}
    emit("xpose_card_vs_cpu", config="TINY", dtype="f32",
         bound_max_abs=bound, launches=list(launches),
         selections_equal=True, max_abs=errs)
    if not all(e <= bound for e in errs.values()):
        raise AssertionError(f"xpose card vs CPU: {errs} over {bound}")


def nan_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit-identical values and NaNs in the same places."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(
        got.nan_to_num(), want.nan_to_num())


# the matmul at ragged (M, K, N): K under the cluster's split of 8 (empty
# eighths), K = 0 (zeros out), N = 0, M or N under one 64 x 64 tile, 16-byte
# copies for a only or b only
MM_RAGGED = ((70, 45, 33), (64, 1, 5), (129, 3, 257), (33, 70, 0),
             (33, 0, 70), (100, 64, 30), (50, 30, 64))


def on_side_stream(fn, *args):
    """``fn(*args)`` under ``with torch.cuda.stream(s)`` on a fresh stream
    s, after a copy of the first input made on s behind a long sleep there:
    a launch on any other stream would read that input still filled with
    NaN.  Returns the output after ``s.synchronize()``."""
    first = torch.full_like(args[0], float("nan"))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        first.copy_(args[0])
        out = fn(first, *args[1:])
    side.synchronize()
    return out


def mm_checks(gen, dev, fail) -> list:
    """The matmul kernel at MM_RAGGED and at a 16-byte-misaligned a, against
    the f64 plain version (exact where the output is empty or all zero);
    two calls at the probe's shape bit-identical; a call on a fresh
    stream; the doubling on a fresh stream."""
    from canonswap_torch.ops.cuda import probes as PR

    cases = []

    def check(label, a, b, got):
        want = PR.mm_plain(a, b)
        torch.cuda.synchronize()
        if want.numel() == 0 or float(want.abs().max()) == 0.0:
            rel, ok = 0.0, torch.equal(got, want)
        else:
            rel, _ = max_rel_err(got, want)
            ok = rel <= F32_TOL
        cases.append({"case": label, "mkn": [a.shape[0], a.shape[1],
                                             b.shape[1]], "rel": rel,
                      "ok": ok})
        if not ok:
            fail(f"mm {label}: {cases[-1]}")

    for m, k, n in MM_RAGGED:
        a = torch.randn((m, k), generator=gen).to(dev)
        b = torch.randn((k, n), generator=gen).to(dev)
        check("ragged", a, b, PR.mm_cuda(a, b))
    a = torch.randn(64 * 64 + 1, generator=gen).to(dev)[1:].view(64, 64)
    b = torch.randn((64, 48), generator=gen).to(dev)
    check("a_misaligned", a, b, PR.mm_cuda(a, b))
    a = torch.randn((512, 512), generator=gen).to(dev)
    b = torch.randn((512, 512), generator=gen).to(dev)
    first, second = PR.mm_cuda(a, b), PR.mm_cuda(a, b)
    torch.cuda.synchronize()
    cases.append({"case": "repeat_bit_identical",
                  "equal": torch.equal(first, second)})
    if not cases[-1]["equal"]:
        fail("mm: two calls at (512, 512) @ (512, 512) differ")
    check("side_stream", a, b, on_side_stream(PR.mm_cuda, a, b))
    x = torch.randn((256, 512), generator=gen).to(dev)
    got = on_side_stream(PR.dbl_cuda, x)
    cases.append({"case": "dbl_side_stream",
                  "equal": nan_equal(got, PR.dbl_plain(x))})
    if not cases[-1]["equal"]:
        fail("dbl on a fresh stream differs from x * 2")
    return cases


def phase_probe_kernels() -> dict:
    """The three probe kernels against their plain versions: the gather at
    a small ragged shape with negative and out-of-range indices and at the
    probe's (16, 1024, 2048), bit-identical with NaNs in the same places;
    the doubling at (256, 512), bit-identical; the matmul at (512, 512) @
    (512, 512) and at ragged shapes within 1e-5 of max |ref| against the
    f64 plain version, bit-identical over two calls, right on a fresh
    stream.  Each timed at the probe's shape beside its plain version, a
    library call and its bound, and split into host cost (host_us) and
    device time (graph_ms) for kernel and library call.  Then the probe
    path: profile_r2's stages through the entry point, one launch of each
    probe kernel and none of the others, and the tool's own timed lines."""
    from canonswap_torch.ops.cuda import probes as PR
    from canonswap_torch.tools import profile_r2

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    cases = []

    def fail(msg):
        emit("probe_kernels", cases=cases, ok=False)
        raise AssertionError(msg)

    # ragged: indices in [-1.25 R, 1.25 R), some wrapping, some NaN
    x = torch.randn((3, 37, 45), generator=gen).to(dev)
    idx = torch.randint(-46, 46, (3, 37, 45), generator=gen,
                        dtype=torch.int32).to(dev)
    got, want = PR.dyn_gather_cuda(x, idx), PR.dyn_gather_plain(x, idx)
    torch.cuda.synchronize()
    cases.append({"case": "gather_ragged", "nan": int(want.isnan().sum()),
                  "equal": nan_equal(got, want)})
    if not (cases[-1]["equal"] and cases[-1]["nan"] > 0):
        fail(f"dyn_gather vs plain, ragged: {cases[-1]}")
    cases += mm_checks(gen, dev, fail)

    stages = dict(profile_r2.stages(dev, seed=12))
    _, (xg, ig) = stages["pallas_dynamic_gather_16x"]
    _, (xd,) = stages["pallas_simple_vpu"]
    _, (a, b) = stages["pallas_simple_mxu"]
    ig64 = ig.long()  # torch.gather's index type
    timings = {}
    for name, kernel, plain, library, args, lib_args, ops in (
            ("dyn_gather", PR.dyn_gather_cuda, PR.dyn_gather_plain,
             lambda x, i: torch.gather(x, 1, i), (xg, ig), (xg, ig64), 0.0),
            ("dbl", PR.dbl_cuda, PR.dbl_plain,
             lambda x: torch.mul(x, 2.0), (xd,), (xd,), float(xd.numel())),
            ("mm", PR.mm_cuda, PR.mm_plain, torch.matmul, (a, b), (a, b),
             2.0 * a.shape[0] * a.shape[1] * b.shape[1])):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if name == "mm":
            rel, abs_err = max_rel_err(got, want)
            ok = rel <= F32_TOL
        else:
            rel, abs_err = 0.0, float(
                (got - want).nan_to_num().abs().max())
            ok = nan_equal(got, want)
        cases.append({"case": f"{name}_full", "shape": [list(t.shape)
                                                        for t in args],
                      "rel": rel, "max_abs_err": abs_err, "ok": ok})
        if not ok:
            fail(f"{name} vs plain at the probe's shape: {cases[-1]}")
        # in turns: plain, library, kernel, kernel, library, plain
        p1 = time_ms(lambda: plain(*args))
        l1 = time_ms(lambda: library(*lib_args))
        k1 = time_ms(lambda: kernel(*args))
        k2 = time_ms(lambda: kernel(*args))
        l2 = time_ms(lambda: library(*lib_args))
        p2 = time_ms(lambda: plain(*args))
        bound, bound_by = bound_ms(nbytes(*args, got), ops, F32_PEAK_TFLOPS)
        kms = float(np.median([k1, k2]))
        graph = graph_ms(lambda: kernel(*args))
        timings[name] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                         "library_ms": float(np.median([l1, l2])),
                         "library_ms_runs": [l1, l2], "bound_ms": bound,
                         "bound_by": bound_by, "bound_share": bound / kms,
                         "host_us": host_us(lambda: kernel(*args)),
                         "library_host_us": host_us(
                             lambda: library(*lib_args)),
                         "graph_ms": graph,
                         "library_graph_ms": graph_ms(
                             lambda: library(*lib_args)),
                         "graph_bound_share": bound / graph,
                         "mbytes": nbytes(*args, got) / 1e6,
                         "gflop": ops / 1e9, "max_abs_err": abs_err}
    del got, want, ig64
    # the probe path: each stage once through the entry point
    reset_launch_counts()
    for name, (fn, args) in stages.items():
        out = fn(*args)
        torch.cuda.synchronize()
        # the first input's shape, but the matmul's columns are b's
        if out.shape != args[0].shape[:-1] + (args[-1].shape[-1],):
            fail(f"probe stage {name}: output {tuple(out.shape)}")
    launches = launch_counts()
    if launches != only(dyn_gather=1, dbl=1, mm=1):
        fail(f"probe path launched ({KERNEL_NAMES}) {launches}")
    emit("probe_kernels", cases=cases, timings=timings,
         library_gather_index="int64", path_launches=list(launches),
         ok=True)
    del stages, xg, ig
    profile_r2.main([])  # the tool's lines: {"stage", "ms_per_step", ...}
    return {"timings": timings, "launches": launches}


SIDECAR_CLIP = (16, 720, 1280)  # frames, height, width
SIDECAR_CROPS = (8, 256)  # batch, side


def seeded_clip(seed: int) -> np.ndarray:
    """A 720p clip: a smooth pattern drifting a few pixels a frame, plus
    noise, uint8 RGB (T, H, W, 3)."""
    t, h, w = SIDECAR_CLIP
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(t):
        base = np.stack([np.sin((xx + 3 * i) / (40 + 9 * c)) * np.cos(
            (yy - 2 * i) / (55 + 7 * c)) for c in range(3)], -1)
        noise = g.standard_normal((h, w, 3), dtype=np.float32)
        frames.append(np.clip(127 + 90 * base + 12 * noise, 0, 255))
    return np.stack(frames).astype(np.uint8)


def phase_sidecars_path() -> dict:
    """The per-frame sidecars at full width, f32 (the JAX session's
    precision), through their entry points on the card:
    Landmark203Runner (MobileLandmarkNet(203) at 224) tracking a seeded
    720p clip, frame 0 without landmarks and each later frame from the
    previous frame's points, ms per frame on the host clock (upload, crop,
    net and the copy back); FaceParser (SegformerConfig(): MiT-B1, 19
    labels) on B=8 seeded 256 crops, ms per batch (median of 3, ending in
    the copy to the host), with the device ms of its parts.  Neither
    launches a kernel of the port."""
    from canonswap_torch.models import parsing as PP
    from canonswap_torch.models.landmark import Landmark203Runner
    from canonswap_torch.ops.affine import soft_erosion

    t0 = time.perf_counter()
    lmk_runner = Landmark203Runner(seed=1)
    lmk_init_s = time.perf_counter() - t0
    clip = seeded_clip(13)
    lmk_runner.run(clip[0])  # set-up: cuDNN's choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    pts, frame_ms = None, []
    for frame in clip:
        t1 = time.perf_counter()
        pts = lmk_runner.run(frame, pts)  # ends in the copy to the host
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        if pts.shape != (203, 2) or not np.isfinite(pts).all():
            raise AssertionError(f"landmarks {pts.shape}, finite "
                                 f"{np.isfinite(pts).all()}")
    lmk_peak = torch.cuda.max_memory_allocated()
    # the crop's share: upload and warp of the same frames, synchronized
    crop_ms = []
    for frame in clip:
        t1 = time.perf_counter()
        lmk_runner.crop(frame, pts)
        torch.cuda.synchronize()
        crop_ms.append((time.perf_counter() - t1) * 1e3)

    t0 = time.perf_counter()
    parser = PP.FaceParser(PP.SegformerConfig(), seed=0)
    parse_init_s = time.perf_counter() - t0
    b, side = SIDECAR_CROPS
    g = np.random.default_rng(14)
    batches = [(g.random((b, side, side, 3)) * 255).astype(np.uint8)
               for _ in range(4)]
    parser.parse_masks(batches[0])  # set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_ms = []
    for crops in batches[1:]:
        t1 = time.perf_counter()
        masks = parser.parse_masks(crops).cpu()
        batch_ms.append((time.perf_counter() - t1) * 1e3)
        if masks.shape != (b, 2 * side, 2 * side, 1):
            raise AssertionError(f"masks {tuple(masks.shape)}")
        if not (bool(torch.isfinite(masks).all()) and float(masks.min()) >= 0
                and float(masks.max()) <= 1):
            raise AssertionError("masks not finite in [0, 1]")
    parse_peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    if launches != only():
        raise AssertionError(f"the sidecars launched ({KERNEL_NAMES}) "
                             f"{launches}")
    # device ms of the parser's parts on one batch (CUDA events)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        crops = torch.as_tensor(batches[1]).to("cuda")
        ev[0].record()
        logits = parser.model(PP.preprocess(crops))
        ev[1].record()
        mask = PP.face_mask_from_logits(logits, (2 * side, 2 * side))
        ev[2].record()
        soft_erosion(mask, 21, 0.9, 3)
        ev[3].record()
    torch.cuda.synchronize()
    parts = dict(zip(("segformer", "mask_upsample_argmax", "soft_erosion"),
                     (ev[i].elapsed_time(ev[i + 1]) for i in range(3))))
    emit("sidecars_path", dtype="f32", clip=list(SIDECAR_CLIP),
         landmark={"config": "MobileLandmarkNet(203), 224", "init_s":
                   lmk_init_s, "ms_per_frame": frame_ms, "median_ms":
                   float(np.median(frame_ms)), "crop_ms_median": float(
                       np.median(crop_ms)), "max_memory_allocated": lmk_peak,
                   "last_points_mean": pts.mean(0).tolist()},
         parsing={"config": "SegformerConfig() (MiT-B1, 19 labels)",
                  "batch": b, "crop": side, "init_s": parse_init_s,
                  "ms_per_batch": batch_ms, "median_ms": float(
                      np.median(batch_ms)), "part_ms": parts,
                  "max_memory_allocated": parse_peak,
                  "mask_mean": float(masks.mean())},
         launches=list(launches))
    return {"landmark_ms": float(np.median(frame_ms)),
            "parse_ms": float(np.median(batch_ms))}


def phase_sidecars_card_vs_cpu() -> None:
    """Segformer at TINY (tests/test_parsing_parity.py's widths) and
    MobileLandmarkNet(203) at a 64 input, the card against the CPU, same
    seeded weights and inputs, f32, TF32 off: logits and landmark outputs
    within 2e-4 max abs (the port's tolerance against the JAX package:
    the same f32 sums in another order); masks equal except where the
    CPU's top two upsampled logits are within 1e-5."""
    from canonswap_torch.models import parsing as PP
    from canonswap_torch.models.landmark import MobileLandmarkNet
    from canonswap_torch.nn.init import init_random_
    from canonswap_torch.ops.resize import bilinear_resize

    bound, tie = 2e-4, 1e-5
    g = np.random.default_rng(15)
    crops = (g.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    parsers = {dev: PP.FaceParser(PP.TINY, seed=4, output_size=128,
                                  device=dev) for dev in ("cpu", "cuda")}
    reset_launch_counts()
    logits = {dev: p.logits(crops).cpu() for dev, p in parsers.items()}
    masks = {dev: PP.face_mask_from_logits(v, (128, 128))
             for dev, v in logits.items()}
    up = bilinear_resize(logits["cpu"].permute(0, 3, 1, 2), (128, 128))
    top2 = up.topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= tie
    flipped = masks["cuda"][..., 0] != masks["cpu"][..., 0]
    soft = {dev: p.parse_masks(crops).cpu() for dev, p in parsers.items()}
    net = init_random_(MobileLandmarkNet(203, input_size=64), 5).eval()
    x = torch.from_numpy(g.random((2, 64, 64, 3), dtype=np.float32))
    with torch.inference_mode():
        lmk = {"cpu": net(x), "cuda": net.to("cuda")(x.to("cuda")).cpu()}
    launches = launch_counts()
    errs = {"logits_max_abs": float((logits["cuda"] - logits["cpu"]).abs()
                                    .max()),
            "landmark_max_abs": float((lmk["cuda"] - lmk["cpu"]).abs().max())}
    clean = ~flipped.any(dim=(1, 2))
    errs["soft_mask_max_abs_unflipped"] = float(
        (soft["cuda"][clean] - soft["cpu"][clean]).abs().max()) \
        if clean.any() else None
    emit("sidecars_card_vs_cpu", config="Segformer TINY, MobileLandmarkNet "
         "at 64", dtype="f32", bound_max_abs=bound, tie=tie, max_abs=errs,
         masks_flipped=int(flipped.sum()), near_ties=int(near_tie.sum()),
         launches=list(launches))
    if launches != only():
        raise AssertionError(f"sidecars TINY launched {launches}")
    if bool((flipped & ~near_tie).any()):
        raise AssertionError("sidecars card vs CPU: a mask differs away from "
                             "a near tie")
    if not all(e is None or e <= bound for e in errs.values()):
        raise AssertionError(f"sidecars card vs CPU: {errs} over {bound}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    timings = phase_kernel()
    warp_q = phase_warp_q_kernel()
    qconv = phase_qconv_kernel()
    main_path = phase_main_path()
    fast = phase_main_path_fast(main_path)
    del main_path["batches"], main_path["img"]
    phase_card_vs_cpu()
    phase_card_vs_cpu_fast()
    xpose = phase_xpose_path()
    msda = phase_msda_kernel(xpose.pop("captured"))
    phase_xpose_card_vs_cpu()
    probes = phase_probe_kernels()
    phase_sidecars_path()
    phase_sidecars_card_vs_cpu()
    bf16 = timings["smooth_bfloat16"]
    bf16_q = warp_q["timings"]["smooth_bfloat16"]
    adaptive = qconv["timings"]["adaptive"]
    enc = msda["timings"]["encoder"]
    print(json.dumps({"kernels": [{
        "name": "warp3d", "route": "cuda",
        "source": "canonswap_torch/csrc/warp3d.cu",
        "replaces": "canonswap_tpu/ops/pallas/warp.py:378",
        "launches": main_path["launches"],
        "max_abs_err": bf16["max_abs_err"],
        "ms": float(np.median(bf16["kernel_ms"])),
        "plain_ms": float(np.median(bf16["plain_ms"])),
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    }, {
        "name": "warp3d_q", "route": "cuda",
        "source": "canonswap_torch/csrc/warp3d_q.cu",
        "replaces": "canonswap_tpu/ops/pallas/warp.py:71",
        "launches": fast["launches"][1],
        "max_abs_err": warp_q["worst"],
        "ms": float(np.median(bf16_q["kernel_ms"])),
        "plain_ms": float(np.median(bf16_q["plain_ms"])),
        "bound_ms": bf16_q["bound_ms"], "bound_by": bf16_q["bound_by"],
        "library_ms": None,
        "exact_kernel_ms": bf16_q["exact_kernel_ms"],
    }, {
        "name": "qconv", "route": "cuda",
        "source": "canonswap_torch/csrc/qconv.cu",
        "replaces": "canonswap_tpu/ops/pallas/qconv.py:107",
        "launches": fast["launches"][2],
        "max_abs_err": qconv["worst"],
        "ms": float(np.median(adaptive["kernel_ms"])),
        "plain_ms": adaptive["plain_f64_ms"],
        "bound_ms": adaptive["bound_ms"], "bound_by": adaptive["bound_by"],
        "library_ms": None,
        "cudnn_bf16_ms": float(np.median(adaptive["cudnn_bf16_ms"])),
    }, {
        "name": "ms_deform_attn", "route": "cuda",
        "source": "canonswap_torch/csrc/ms_deform_attn.cu",
        "replaces": "canonswap_tpu/ops/pallas/ms_deform_attn.py:100",
        "launches": xpose["launches"],
        "max_abs_err": msda["worst"],
        "ms": float(np.median(enc["kernel_ms"])),
        "plain_ms": float(np.median(enc["plain_ms"])),
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name, "route": "cuda",
        "source": "canonswap_torch/csrc/probes.cu", "replaces": replaces,
        "launches": probes["launches"][KERNEL_NAMES.index(name)],
        "max_abs_err": probes["timings"][name]["max_abs_err"],
        "ms": float(np.median(probes["timings"][name]["kernel_ms"])),
        "plain_ms": float(np.median(probes["timings"][name]["plain_ms"])),
        "bound_ms": probes["timings"][name]["bound_ms"],
        "bound_by": probes["timings"][name]["bound_by"],
        "library_ms": probes["timings"][name]["library_ms"],
        "host_us": probes["timings"][name]["host_us"],
        "library_host_us": probes["timings"][name]["library_host_us"],
        "graph_ms": probes["timings"][name]["graph_ms"],
        "library_graph_ms": probes["timings"][name]["library_graph_ms"],
    } for name, replaces in (("dyn_gather", "tools/profile_r2b.py:192"),
                             ("dbl", "tools/profile_r2c.py:56"),
                             ("mm", "tools/profile_r2c.py:71"))]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
