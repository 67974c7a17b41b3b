"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: card name and power limit, torch/CUDA versions; the eight
     kernels built at once (one nvcc per source: the three probes share
     one, the exact warp and its backward another) and their build times;
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
     plain versions at the JAX tools' shapes (the gather also at small
     ragged shapes with negative and out-of-range indices, at the last
     strip shape and the first direct one, R = 1 and two unaligned views,
     each case with the path it took; the matmul also at ragged shapes,
     twice bit for bit, and on a fresh stream), timed beside their plain
     versions, library calls and bounds, with each call's host cost and
     its device time from a CUDA graph; the gather and torch.gather on
     three index patterns, with the sectors of x the kernel reads; then
     the probe path, canonswap_torch.tools.profile_r2's stages through its
     entry point;
 10. sidecars path: Landmark203Runner at full width tracking 16 frames of a
     seeded 720p clip, and FaceParser (Segformer MiT-B1, 19 labels) on
     B=8 seeded 256 crops, f32, timed on the host clock, no kernel
     launched;
 11. sidecars card vs CPU: Segformer at TINY and MobileLandmarkNet at a
     small input, outputs within 2e-4, masks equal but at near ties;
 12. clip path: a 16-frame seeded 720p clip from frames in host memory to
     swapped frames in host memory, strung by hand from a FaceSwapSession's
     components (CANONICAL bf16, full-width sidecars): the source ID
     (SCRFD, the ID crop, ArcFace (3, 4, 23, 3)), the Cropper (SCRFD and
     the 106 points on frame 0, 203-point tracking, the 512 crop, the area
     resize to 256), the main path's generator on two batches of 8, face
     parsing and the paste-back on the card; times per part, frames/s, the
     exact warp's launches counted;
 13. clip card vs CPU: SCRFD at full width on 128 x 128 (equal top-k
     selections and NMS keep masks), ArcFace (1, 1, 1, 1), the 106-point
     net, within 2e-4; paste_back equal but at rounding ties;
 14. codec tools: whether cv2, PIL and ffmpeg are installed (the pipelines
     need none of them);
 15. pipeline swap: swap_e2e.execute, the user's swap, through the same
     session on that clip written as a .npy and its source frame as a .ppm,
     twice (the second from the dumped motion template, timed, StageTimer's
     parts), its frames held to the first run's and to clip_path's;
 16. pipeline v2i and multi: swap_v2i.execute on 8 frames and
     swap_multi.execute on the 16 through the same session; a .mp4 with
     cv2 hidden raises naming the file;
 17. pipeline stream fast: streaming.execute with the fast bundle's flags in
     a session of its own, the three kernels' launches per batch counted;
 18. CLI swap: python -m canonswap_torch.cli.main swap on 8 frames, as a
     subprocess;
 19. pipeline stitch: swap_e2e.execute twice in a session of the clip
     cell's with stitching, eye and lip retargeting and normalize_lip on:
     the cached run's frames equal the first's, and differ from the
     unflagged run's inside the warped mask;
 20. warp bwd kernel: the exact warp's backward kernel against its plain
     gradient (F.grid_sample's autograd backward) at a ragged shape with
     points outside the volume and at CANONICAL B=8 f32 on the smooth and a
     random field, timed there beside the plain version, the library
     backward and its bound;
 21. train step: runtime/train.py at CANONICAL f32, B=8, five steps (the
     motion heads held in range by stated constants), launches per step;
     first its gradients through the kernel backward against those through
     the plain backward on the same tensors;
 22. train card vs CPU: one step at TINY f32, the loss and gradients on
     the card against the CPU;
 23. train CLI: python -m canonswap_torch.cli.train --steps 3 --batch 2 as
     a subprocess; its .npz loads into a session's core.
Before the last line, one line lists every kernel with its launches on the
main paths (and on the pipelines), its error against its plain version,
its time, the plain version's, its bound and a library call's time where
one computes the same function (the probes also their host cost and
graph-replayed time).  Any failure exits nonzero.  The last line is the
run's one-line verdict.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import tempfile
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
                "dyn_gather", "dbl", "mm", "warp3d_backward")


def kernels():
    from canonswap_torch.ops.cuda.ms_deform_attn import MSDA
    from canonswap_torch.ops.cuda.probes import DOUBLE, GATHER, MATMUL
    from canonswap_torch.ops.cuda.qconv import QCONV
    from canonswap_torch.ops.cuda.warp import WARP3D, WARP3D_BWD, WARP3D_Q

    return WARP3D, WARP3D_Q, QCONV, MSDA, GATHER, DOUBLE, MATMUL, WARP3D_BWD


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


def direct_sectors(idx: torch.Tensor) -> int:
    """The 32-byte sectors of x that a one-thread-per-element gather reads:
    for each warp (32 consecutive flat outputs), the distinct sectors of the
    elements x[b, j, c] it reads."""
    _, rows, cols = idx.shape
    j = idx.long()
    j = torch.where(j < 0, j + rows, j).clamp(0, rows - 1)
    b = torch.arange(idx.shape[0], device=idx.device).view(-1, 1, 1)
    c = torch.arange(cols, device=idx.device).view(1, 1, -1)
    sector = ((b * rows + j) * cols + c).flatten() // 8
    pad = -sector.numel() % 32
    sector = torch.cat([sector, sector[-1:].expand(pad)]).view(-1, 32)
    sector = sector.sort(dim=1).values
    return int(sector.shape[0] + (sector[:, 1:] != sector[:, :-1]).sum())


def gather_patterns(x: torch.Tensor, idx: torch.Tensor) -> dict:
    """The gather kernel and torch.gather (int64 indices) at x's shape on
    three index patterns: ``random`` (the probe's own), ``identity``
    (idx[b, r, c] = r: a coalesced copy, the memory floor of the same
    bytes) and ``row0`` (every index 0: one row, held in L2).  Each entry:
    time_ms, graph_ms, bytes (inputs once, output once), bound_ms; the
    kernel's entries also its path, the 32-byte sectors of x it reads (on
    the strip path each row of a strip whole, so x once) and their rate
    over graph_ms.  ``random_kernel_unaligned``: the kernel on the probe's
    indices with x one float off a 16-byte line (no bulk copies)."""
    from canonswap_torch.ops.cuda import probes as PR

    batch, rows, cols = x.shape
    patterns = {
        "random": idx,
        "identity": torch.arange(rows, dtype=torch.int32, device=x.device)
        .view(1, -1, 1).expand(batch, rows, cols).contiguous(),
        "row0": torch.zeros_like(idx),
    }
    table = {}
    for pattern, ip in patterns.items():
        ip64 = ip.long()
        for name, fn, args in (
                ("kernel", PR.dyn_gather_cuda, (x, ip)),
                ("torch_gather", lambda a, i: torch.gather(a, 1, i),
                 (x, ip64))):
            moved = nbytes(*args, x)
            entry = {"time_ms": time_ms(lambda: fn(*args)),
                     "graph_ms": graph_ms(lambda: fn(*args)),
                     "bytes": moved,
                     "bound_ms": bound_ms(moved, 0.0, F32_PEAK_TFLOPS)[0]}
            if name == "kernel":
                _, path = gather_path(fn, *args)
                # the strip path copies each row of a strip whole: x once
                sectors = (direct_sectors(ip) if path == "direct"
                           else batch * rows * -(-cols // 8))
                entry.update(path=path, x_sectors=sectors,
                             x_sector_bytes=32 * sectors,
                             x_sector_tb_per_s=32 * sectors
                             / (entry["graph_ms"] * 1e-3) / 1e12)
            table[f"{pattern}_{name}"] = entry
        del ip64
    # the probe's indices with x one float off a 16-byte line: the strip is
    # staged by 4-byte cp.async instead of bulk copies
    flat = torch.empty(x.numel() + 1, device=x.device)
    flat[1:] = x.flatten()
    xu = flat[1:].view(x.shape)
    _, path = gather_path(PR.dyn_gather_cuda, xu, idx)
    table["random_kernel_unaligned"] = {
        "time_ms": time_ms(lambda: PR.dyn_gather_cuda(xu, idx)),
        "graph_ms": graph_ms(lambda: PR.dyn_gather_cuda(xu, idx)),
        "path": path}
    return table


def gather_path(fn, *args):
    """``fn(*args)`` and the gather path it launched ("strip" or
    "direct"), from the wrapper's per-path counts."""
    from canonswap_torch.ops.cuda import probes as PR

    before = dict(PR.GATHER_PATHS)
    out = fn(*args)
    taken = [p for p, n in PR.GATHER_PATHS.items() if n != before[p]]
    return out, (taken[0] if len(taken) == 1 else f"launched {taken}")


def gather_checks(gen, dev, fail) -> list:
    """The gather kernel against its plain version, bit-identical with
    NaNs in the same places, indices in [-1.25 R, 1.25 R) (some wrapping,
    some NaN): a ragged (3, 37, 45); R = GATHER_R_MAX (the last strip
    shape) and R_MAX + 1 (the first direct shape) at B = 2, C = 96; ragged
    strips narrower than one strip (C = 45 and 7); R = 1; x[1:] of a
    (3, 37, 45) block and a (2, 37, 48) view one float off a 16-byte line
    (neither takes the bulk copies).  Each case records its path; R_MAX + 1
    must take the direct path and every other case the strip."""
    from canonswap_torch.ops.cuda import probes as PR

    r_max = PR.GATHER_R_MAX
    cases = []

    def inputs(shape):
        rows = shape[1]
        x = torch.randn(shape, generator=gen)
        idx = torch.randint(-(5 * rows) // 4, (5 * rows) // 4, shape,
                            generator=gen, dtype=torch.int32)
        return x.to(dev), idx.to(dev)

    def check(label, x, idx, path):
        got, taken = gather_path(PR.dyn_gather_cuda, x, idx)
        want = PR.dyn_gather_plain(x, idx)
        torch.cuda.synchronize()
        cases.append({"case": label, "shape": list(x.shape), "path": taken,
                      "aligned": x.data_ptr() % 16 == 0,
                      "nan": int(want.isnan().sum()),
                      "equal": nan_equal(got, want)})
        if not (cases[-1]["equal"] and cases[-1]["nan"] > 0
                and taken == path):
            fail(f"dyn_gather vs plain, {label}: {cases[-1]} "
                 f"(wanted the {path} path)")

    check("gather_ragged", *inputs((3, 37, 45)), "strip")
    check("gather_r_max", *inputs((2, r_max, 96)), "strip")
    check("gather_r_max_plus_1", *inputs((2, r_max + 1, 96)), "direct")
    check("gather_c45", *inputs((2, 300, 45)), "strip")
    check("gather_c7", *inputs((3, 50, 7)), "strip")
    check("gather_r1", *inputs((4, 1, 100)), "strip")
    x, idx = inputs((3, 37, 45))
    check("gather_unaligned", x[1:], idx[1:], "strip")
    flat = torch.randn(2 * 37 * 48 + 1, generator=gen).to(dev)
    check("gather_unaligned_c48", flat[1:].view(2, 37, 48),
          inputs((2, 37, 48))[1], "strip")
    return cases


def phase_probe_kernels() -> dict:
    """The three probe kernels against their plain versions: the gather at
    the shapes of gather_checks and at the probe's (16, 1024, 2048), which
    must take the strip path, bit-identical with NaNs in the same places;
    the doubling at (256, 512), bit-identical; the matmul at (512, 512) @
    (512, 512) and at ragged shapes within 1e-5 of max |ref| against the
    f64 plain version, bit-identical over two calls, right on a fresh
    stream.  Each timed at the probe's shape beside its plain version, a
    library call and its bound, and split into host cost (host_us) and
    device time (graph_ms) for kernel and library call; the gather's
    index-pattern table (gather_patterns).  Then the probe
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

    cases += gather_checks(gen, dev, fail)
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
        got, path = gather_path(kernel, *args)
        want = plain(*args)
        torch.cuda.synchronize()
        if name == "dyn_gather" and path != "strip":
            fail(f"dyn_gather at the probe's shape took the {path} path")
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
    timings["dyn_gather"]["path"] = "strip"
    del got, want, ig64
    patterns = gather_patterns(xg, ig)
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
         gather_patterns=patterns, library_gather_index="int64",
         path_launches=list(launches), ok=True)
    del stages, xg, ig
    profile_r2.main([])  # the tool's lines: {"stage", "ms_per_step", ...}
    return {"timings": timings, "launches": launches}


SIDECAR_CLIP = (16, 720, 1280)  # frames, height, width
SIDECAR_CROPS = (8, 256)  # batch, side


def seeded_clip(seed: int, shape=SIDECAR_CLIP) -> np.ndarray:
    """A 720p clip: a smooth pattern drifting a few pixels a frame, plus
    noise, uint8 RGB (T, H, W, 3)."""
    t, h, w = shape
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


CLIP_DET_SIZE = (512, 512)  # the session's det_size (w, h)
CLIP_BATCH = 8  # InferenceConfig's batch
# the ID crops and the clip's seeds (seeded_clip)
CLIP_SOURCE_SEED, CLIP_SEED = 21, 13
# Stated constants on the seeded face stack, so that the seeded clip holds a
# face-sized track.  Seeded, SCRFD scores every anchor between sigmoid(-0.7)
# and sigmoid(1.55), so at CropConfig's threshold 0.1 all 128 candidates
# pass; its boxes come out inverted (x2 < x1), the 106-point crop shrinks to
# its zero-size guard, the landmark heads put every point within a few
# pixels of one another, and the track collapses below a pixel.  Set here,
# in the phase, not in the package; the weights' other values are the
# seed's.
# Added to SCRFD's score logits: the top few anchors pass (logits above
# 1.503: 4 on frame 0 and 4 on the source frame before NMS), as a trained
# detector finds a face or two.
CLS_BIAS = -3.7
# Added to SCRFD's distance logits: boxes about 6 strides a side (frame 0's
# faces come out at stride 16, about 236 pixels of the 720p frame).
REG_BIAS = 3.0
# The landmark heads' seeded weights are scaled by these, and their biases
# set to a face layout (face_layout): the seeded part moves each point by
# about 0.8 pixel of the 106 crop and 0.4 pixel of the 203 crop, so the
# points keep a face's shape and still follow the image.
LMK106_WEIGHT_SCALE, LMK203_WEIGHT_SCALE = 0.1, 0.02
# The 512 crop's side in the frame, as a share of the frame's height, that
# the track must hold on every frame: a face's crop, not a pixel's.
CROP_SIDE_RANGE = (0.25, 1.5)


def face_layout(n: int, left_eye, right_eye, lip) -> np.ndarray:
    """(n, 2) points of an upright face in the unit square: a contour on
    the circle that fills the square, the eye points at (0.3, 0.4) and
    (0.7, 0.4), the lip points at (0.5, 0.78) (the indices that
    ``utils/geometry.py``'s crop reads for an n-point set)."""
    k = np.arange(n) * 2 * np.pi / n
    u = np.stack([0.5 + 0.5 * np.sin(k), 0.5 - 0.5 * np.cos(k)], -1)
    u[left_eye], u[right_eye], u[lip] = (0.3, 0.4), (0.7, 0.4), (0.5, 0.78)
    return u


def set_head(head, pred: np.ndarray, weight_scale: float) -> None:
    """A landmark net's last layer: weights scaled, bias = ``pred``."""
    with torch.no_grad():
        head.weight *= weight_scale
        head.bias.copy_(torch.from_numpy(pred.reshape(-1)))


def hold_a_face(fa, tracker) -> None:
    """Sets the stated constants above on the seeded SCRFD and landmark
    heads.  The 106 layout fills the detection box, the middle 2/3 of its
    192 crop: pred = points / 96 - 1.  The 203 layout is where its own crop
    (224, scale 1.5, vy_ratio -0.1: the box 1.5 times the points' extent,
    its centre 0.1 of its side above theirs) puts the points back, so
    tracking holds the crop: pred = points / 224."""
    with torch.no_grad():
        fa.det_model.head.cls.bias += CLS_BIAS
        fa.det_model.head.reg.bias += REG_BIAS
    pts = (face_layout(106, [33, 35, 40, 39], [87, 89, 94, 93], [52, 61])
           - 0.5) * 128 + 96
    set_head(fa.lmk106.net.head, pts / 96 - 1, LMK106_WEIGHT_SCALE)
    pts = (face_layout(203, [0, 6, 12, 18], [24, 30, 36, 42], [48, 66])
           - 0.5) * (224 / 1.5) + (112, 112 + 0.1 * 224)
    set_head(tracker.net.head, pts / 224, LMK203_WEIGHT_SCALE)


def timed_frames(frames, stamps: list):
    """Yields ``frames``, stamping the host clock as each is asked for: the
    gaps between stamps are the consumer's time per frame."""
    for frame in frames:
        stamps.append(time.perf_counter())
        yield frame


def clip_session(**inference):
    """A FaceSwapSession at CANONICAL with the full-width sidecars on the
    card, bf16 generator, and the stated constants of ``hold_a_face`` on
    its SCRFD and landmark heads.  At seed 0 the session's components take
    the seeds the clip path always had (``pipelines/session.py::
    SEED_OFFSETS``): the generator is the main path's, seed 0."""
    from canonswap_torch.configs import InferenceConfig
    from canonswap_torch.pipelines.session import FaceSwapSession

    t0 = time.perf_counter()
    session = FaceSwapSession(InferenceConfig(**inference),
                              det_size=CLIP_DET_SIZE, seed=0)
    hold_a_face(session.face_analysis, session.landmark203)
    session.init_s = time.perf_counter() - t0
    return session


def phase_clip_path(session) -> dict:
    """One clip from frames in host memory to swapped frames in host memory,
    through the port's entry points, strung by hand from ``session``'s
    components (``clip_session``): the face stack at full width in f32
    (TF32 off, the JAX session's precision) and the main path's generator
    (CANONICAL, bf16, exact):

    - the source ID: ``FaceIDCropper`` (SCRFD-10GF at det_size (512, 512),
      ``CropConfig``'s threshold 0.1) and ``ArcFaceRunner`` (3, 4, 23, 3) at
      112 on a seeded 720p source frame, through ``source_id``;
    - ``Cropper.crop_source_video`` over the 16-frame seeded 720p clip:
      SCRFD and ``Landmark106Runner`` (mobile, 192) on frame 0, the
      203-point tracker on every frame, the 512 crop and its area resize
      to 256;
    - ``swap_with_motion`` on two batches of 8 crops with that ID;
    - ``FaceParser.parse_masks`` (MiT-B1) on the same crops, then
      ``prepare_paste_back`` and ``paste_back`` of each swapped 512 crop
      into its frame on the card at the clip's own ``M_c2o``, and one copy
      of the 16 frames to the host.

    The seeded stack carries the stated constants of ``hold_a_face``.  The
    whole is run twice (the first run is set-up: cuDNN's choices) and the
    second is timed on the host clock, each part ending in a synchronize;
    detection is split into the net and the decode + NMS by CUDA events,
    and NMS alone is timed too.  Hard checks: a face on frame 0, a finite
    unit-norm ID, 16 uint8 (720, 1280, 3) frames, every frame's crop
    face-sized (CROP_SIDE_RANGE), the frames changed inside the warped mask
    and untouched wherever it is 0, and the exact warp launched 2 times per
    batch with no other kernel."""
    from canonswap_torch.models import scrfd as S
    from canonswap_torch.ops.cuda.warp import WARP3D
    from canonswap_torch.ops.detection import decode_scrfd, nms_fixed
    from canonswap_torch.runtime import core as C
    from canonswap_torch.runtime.face_analysis import source_id
    from canonswap_torch.utils import geometry as G

    core = session.core
    cfg = core.cfg
    dtype = next(core.parameters()).dtype
    n, h, w = SIDECAR_CLIP
    crop_cfg = session.crop_cfg  # the 512 crop at CANONICAL
    fa, cropper = session.face_analysis, session.cropper
    id_cropper, arcface = session.id_cropper, session.arcface  # (3, 4, 23, 3)
    parser = session.parsing
    init_s = session.init_s
    clip = seeded_clip(CLIP_SEED)
    source = seeded_clip(CLIP_SOURCE_SEED, (1, h, w))[0]

    def swap_clip() -> dict:
        ms, stamps, launches = {}, [], []
        clock = [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            ms[name] = ms.get(name, 0.0) + (now - clock[0]) * 1e3
            clock[0] = now

        start = clock[0]
        sid = source_id(id_cropper, arcface, source, cfg.swap.latent_dim)
        lap("source_id")
        frames = torch.from_numpy(clip).to("cuda")  # the one upload
        lap("upload")
        crops = cropper.crop_source_video(timed_frames(frames, stamps))
        lap("crop")
        stamps.append(clock[0])
        out_frames, masks_ori = [], []
        for lo in range(0, n, CLIP_BATCH):
            batch = torch.stack(crops["frame_crop_lst"][lo:lo + CLIP_BATCH])
            before = WARP3D.launches
            x = (batch.float() / 255.0).to(dtype)
            out, _ = C.swap_with_motion(core, x, sid, as_uint8=True)
            lap("generator")
            launches.append(WARP3D.launches - before)
            masks = parser.parse_masks(batch)
            lap("parsing")
            for j in range(batch.shape[0]):
                m_c2o = crops["M_c2o_lst"][lo + j]
                mask_ori = G.prepare_paste_back(masks[j], m_c2o, (w, h),
                                                if_float=True)
                out_frames.append(G.paste_back(out["out"][j], m_c2o,
                                               frames[lo + j], mask_ori))
                masks_ori.append(mask_ori[..., 0])
            lap("paste_back")
        result = torch.stack(out_frames).cpu().numpy()  # the one copy back
        lap("download")
        wall = (time.perf_counter() - start) * 1e3
        return {"result": result, "sid": sid, "crops": crops, "ms": ms,
                "wall_ms": wall, "frame_ms": np.diff(stamps) * 1e3,
                "warp_launches_per_batch": launches,
                "masks_ori": torch.stack(masks_ori), "frames": frames}

    with torch.inference_mode():
        cold = swap_clip()  # set-up
        del cold["masks_ori"], cold["frames"]
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        run = swap_clip()
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts()
        # detection of frame 0, split by CUDA events: net, decode + NMS, NMS
        frame0 = run["frames"][0]
        boxes, _ = fa.detect(frame0)
        if boxes.shape[0] < 1:
            raise AssertionError("clip_path: no face on frame 0")
        faces = fa.get(frame0, flag_do_landmark_2d_106=False)
        det = {"net": [], "decode_nms": [], "nms": [], "lmk106": []}
        for _ in range(3):
            blob, _ = S.preprocess(frame0, CLIP_DET_SIZE)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            outs = fa.det_model(blob)
            ev[1].record()
            res = decode_scrfd(outs, input_size=CLIP_DET_SIZE,
                               score_thresh=crop_cfg.det_thresh)
            ev[2].record()
            nms_fixed(res["bboxes"], res["scores"])
            ev[3].record()
            torch.cuda.synchronize()
            for i, k in enumerate(("net", "decode_nms", "nms")):
                det[k].append(ev[i].elapsed_time(ev[i + 1]))
            t1 = time.perf_counter()
            fa.lmk106.get(frame0, faces[0].bbox)  # ends in the copy back
            det["lmk106"].append((time.perf_counter() - t1) * 1e3)
        valid0 = int(res["valid"].sum())
        mask = run["masks_ori"].cpu().numpy()
    sid, result = run["sid"], run["result"]
    norm = float(torch.linalg.vector_norm(sid.float()))
    if not (bool(torch.isfinite(sid).all()) and abs(norm - 1.0) <= 1e-5
            and sid.shape == (1, cfg.swap.latent_dim)):
        raise AssertionError(f"clip_path: source ID {tuple(sid.shape)}, "
                             f"norm {norm}")
    if result.shape != (n, h, w, 3) or result.dtype != np.uint8 or len(
            run["crops"]["frame_crop_lst"]) != n:
        raise AssertionError(f"clip_path: output {result.shape} "
                             f"{result.dtype}, {len(run['crops'])} crops")
    sides = [cfg.output_size / np.linalg.norm(m[0, :2]) / h
             for m in run["crops"]["M_o2c_lst"]]
    if not all(CROP_SIDE_RANGE[0] <= s <= CROP_SIDE_RANGE[1] for s in sides):
        raise AssertionError(f"clip_path: crop side / frame height {sides} "
                             f"outside {CROP_SIDE_RANGE}")
    moved = (result != clip).any(-1)
    zero = mask <= 0
    inside = int(moved[mask >= 0.5].sum())
    outside = int(moved[zero].sum())
    if not zero.any() or inside == 0 or outside:
        raise AssertionError(
            f"clip_path: {inside} pixels changed where the mask is >= 0.5, "
            f"{outside} where it is 0 ({int(zero.sum())} such pixels)")
    per_batch = run["warp_launches_per_batch"]
    if per_batch != [2] * (n // CLIP_BATCH) or launches != only(
            warp3d=2 * (n // CLIP_BATCH)):
        raise AssertionError(f"clip_path: warp launches per batch "
                             f"{per_batch}, all launches {launches}")
    frame_ms = run["frame_ms"]
    batches = n // CLIP_BATCH
    emit("clip_path", clip=list(SIDECAR_CLIP), det_size=list(CLIP_DET_SIZE),
         det_thresh=crop_cfg.det_thresh, crop_dsize=crop_cfg.dsize,
         generator=f"{type(core).__name__} {dtype}", batch=CLIP_BATCH,
         init_s=init_s, faces_frame0=int(boxes.shape[0]),
         valid_after_nms_frame0=valid0,
         face_box_frame0=[float(v) for v in faces[0].bbox],
         detect_ms={k: float(np.median(v)) for k, v in det.items()},
         source_id_ms=run["ms"]["source_id"],
         upload_ms=run["ms"]["upload"],
         crop_frame0_ms=float(frame_ms[0]),
         track_crop_ms_per_frame=float(np.mean(frame_ms[1:])),
         track_crop_ms_frames=[float(v) for v in frame_ms],
         generator_ms_per_batch=run["ms"]["generator"] / batches,
         parsing_ms_per_batch=run["ms"]["parsing"] / batches,
         paste_back_ms_per_frame=run["ms"]["paste_back"] / n,
         download_ms=run["ms"]["download"], parts_ms=run["ms"],
         wall_ms=run["wall_ms"], frames_per_s=n / (run["wall_ms"] / 1e3),
         cold_wall_ms=cold["wall_ms"], max_memory_allocated=peak,
         warp_launches_per_batch=per_batch, launches=list(launches),
         launches_order=list(KERNEL_NAMES), source_id_norm=norm,
         crop_side_over_frame_height=[float(v) for v in sides],
         mask_positive_pixels=int((mask > 0).sum()),
         changed_pixels_mask_over_half=inside, mask_zero_pixels=int(
             zero.sum()), changed_pixels=int(moved.sum()),
         out_mean=float(result.mean()))
    return {"launches": launches, "wall_ms": run["wall_ms"],
            "parts_ms": run["ms"], "result": result}


def feathered_disc(side: int) -> np.ndarray:
    """A (side, side, 1) f32 mask: 1 inside 0.4 side of the centre, falling
    to 0 over 0.08 side (a face region's feathered edge)."""
    yy, xx = np.mgrid[0:side, 0:side]
    r = np.hypot(yy - side / 2, xx - side / 2)
    return np.clip((0.4 * side - r) / (0.08 * side), 0, 1)[
        ..., None].astype(np.float32)


def phase_clip_card_vs_cpu() -> None:
    """The clip path's modules on the card and on the CPU, same seeded
    weights and inputs, f32, TF32 off, within 2e-4 max abs (the port's
    tolerance against the JAX package: the same f32 sums in another order):
    SCRFD at full width on a 128 x 128 input, with equal top-k selections
    and NMS keep masks after the decode; ArcFace at layers (1, 1, 1, 1) on
    the embedding and mid; Landmark106Runner's net on one crop; and
    paste_back on a small frame, equal but where the exact blend lies within
    1/32 of a grey level of a rounding step."""
    from canonswap_torch.models import scrfd as S
    from canonswap_torch.models.arcface import ArcFaceResNet
    from canonswap_torch.models.landmark import Landmark106Runner
    from canonswap_torch.nn.init import init_random_
    from canonswap_torch.ops.detection import decode_scrfd
    from canonswap_torch.utils import geometry as G

    bound, tie = 2e-4, 1 / 32
    g = np.random.default_rng(23)
    reset_launch_counts()
    errs = {}
    with torch.inference_mode():
        det = init_random_(S.SCRFD(), 7).eval()
        x = torch.from_numpy(g.standard_normal((2, 3, 128, 128),
                                               dtype=np.float32))
        outs = {"cpu": det(x)}
        outs["cuda"] = {s: {k: v.cpu() for k, v in o.items()}
                        for s, o in det.to("cuda")(x.to("cuda")).items()}
        errs["scrfd"] = max(float((outs["cuda"][s][k] - outs["cpu"][s][k])
                                  .abs().max()) for s in outs["cpu"]
                            for k in outs["cpu"][s])
        dec = {d: decode_scrfd(o, input_size=(128, 128), score_thresh=0.5)
               for d, o in outs.items()}
        same_selection = bool(torch.equal(dec["cuda"]["index"],
                                          dec["cpu"]["index"]))
        same_keep = bool(torch.equal(dec["cuda"]["valid"],
                                     dec["cpu"]["valid"]))
        errs["scrfd_boxes"] = float((dec["cuda"]["bboxes"]
                                     - dec["cpu"]["bboxes"]).abs().max()
                                    ) / 128
        arc = init_random_(ArcFaceResNet((1, 1, 1, 1)), 8).eval()
        x = torch.from_numpy(g.standard_normal((2, 3, 112, 112),
                                               dtype=np.float32))
        want = arc(x)
        got = [v.cpu() for v in arc.to("cuda")(x.to("cuda"))]
        errs["arcface_embedding"] = float((got[0] - want[0]).abs().max())
        errs["arcface_mid"] = float((got[1] - want[1]).abs().max())
        crop = torch.from_numpy((g.random((1, 192, 192, 3)) * 255).astype(
            np.float32).round())
        nets = {d: Landmark106Runner(seed=3, device=d).net
                for d in ("cpu", "cuda")}
        errs["landmark106"] = float((nets["cuda"](crop.to("cuda")).cpu()
                                     - nets["cpu"](crop)).abs().max())
    ori = (g.random((90, 160, 3)) * 255).astype(np.uint8)
    side = 64
    crop8 = (g.random((side, side, 3)) * 255).astype(np.uint8)
    m_c2o = np.array([[0.9, -0.2, 40.3], [0.2, 0.9, 5.7], [0, 0, 1]],
                     np.float32)
    mask = G.prepare_paste_back(torch.from_numpy(feathered_disc(side)),
                                m_c2o, (160, 90), if_float=True)
    pasted = {d: G.paste_back(torch.from_numpy(crop8).to(d), m_c2o,
                              torch.from_numpy(ori).to(d), mask.to(d))
              .cpu().numpy() for d in ("cpu", "cuda")}
    value = G.paste_back_value(crop8, m_c2o, ori, mask.numpy())
    near_tie = np.abs(value - np.floor(value) - 0.5) < tie
    differ = pasted["cuda"] != pasted["cpu"]
    launches = launch_counts()
    emit("clip_card_vs_cpu", config="SCRFD-10GF at 128, ArcFace (1, 1, 1, "
         "1), Landmark106Runner's net at 192, paste_back (90, 160)",
         dtype="f32", bound_max_abs=bound, max_abs=errs,
         same_topk_selection=same_selection, same_nms_keep=same_keep,
         valid=int(dec["cpu"]["valid"].sum()),
         paste_back_values_differ=int(differ.sum()),
         paste_back_near_ties=int(near_tie.sum()),
         paste_back_max_diff=int(np.abs(pasted["cuda"].astype(int)
                                        - pasted["cpu"].astype(int)).max()),
         launches=list(launches))
    if launches != only():
        raise AssertionError(f"clip card vs CPU launched {launches}")
    if not (same_selection and same_keep):
        raise AssertionError("clip card vs CPU: SCRFD's top-k selection or "
                             "NMS keep mask differs")
    if bool((differ & ~near_tie).any()):
        raise AssertionError("clip card vs CPU: paste_back differs away "
                             "from a rounding tie")
    if not all(e <= bound for e in errs.values()):
        raise AssertionError(f"clip card vs CPU: {errs} over {bound}")


def phase_tools() -> None:
    """Whether cv2, PIL and ffmpeg are on this machine: the pipelines must
    not need them (``.ppm`` and ``.npy`` need no codec)."""
    import importlib.util
    import shutil

    found = {"cv2": importlib.util.find_spec("cv2") is not None,
             "PIL": importlib.util.find_spec("PIL") is not None,
             "ffmpeg": shutil.which("ffmpeg") is not None}
    emit("codec_tools", found=found)


class Finite:
    """Wraps a function of ``runtime/core.py`` for one phase: records
    whether each float output it returned was finite (the pipelines quantize
    to uint8, where a NaN would pass unseen)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls, self.finite = 0, True

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        for v in out.values() if isinstance(out, dict) else [out]:
            self.finite &= bool(torch.isfinite(v.float()).all())
        self.calls += 1
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def write_media(d: str, n_frames: int) -> tuple[str, str]:
    """The clip phases' seeded source frame as a .ppm and the first
    ``n_frames`` of their 720p clip as a .npy in ``d``."""
    from canonswap_torch.utils import io as IO

    src = f"{d}/src.ppm"
    IO.save_image_rgb(src, seeded_clip(CLIP_SOURCE_SEED,
                                       (1, *SIDECAR_CLIP[1:]))[0])
    clip = f"{d}/clip{n_frames}.npy"
    np.save(clip, seeded_clip(CLIP_SEED)[:n_frames])
    return src, clip


def phase_pipeline_swap(session, clip_run: dict, d: str) -> dict:
    """``swap_e2e.execute``, the user's swap, at CANONICAL bf16 exact with
    the full-width sidecars (``clip_session``) on the 16-frame seeded 720p
    clip as a .npy and its source frame as a .ppm: twice, the first run
    dumps the motion template and the second loads it.  The second is
    timed (StageTimer's parts, each ending in a synchronize) with its peak
    memory.  Hard checks: both outputs, 16 x (720, 1280, 3) and 16 x (512,
    2048, 3) uint8; the template dumped; the second run's frames equal the
    first's bit for bit (the same operations on the same inputs: the
    template holds the first run's f32 motion, read back exactly); the
    frames equal ``clip_path``'s bit for bit (the same session, inputs and
    operations; the debug strips run beside them); pixels changed where
    the warped mask is >= 0.5 and none where it is 0; the exact warp
    launched 2 times per batch of 8 and no other kernel."""
    import os

    from canonswap_torch.configs import ArgumentConfig
    from canonswap_torch.pipelines import swap_e2e
    from canonswap_torch.utils import geometry as G
    from canonswap_torch.utils.timing import StageTimer

    n, h, w = SIDECAR_CLIP
    src, clip_path = write_media(d, n)
    args = ArgumentConfig(source=src, driving=clip_path,
                          output_dir=f"{d}/out")
    crops = {}
    real_crop = session.cropper.crop_source_video

    def recorded(frames):
        crops.update(real_crop(frames))
        return crops

    session.cropper.crop_source_video = recorded
    runs = []
    try:
        for i in range(2):
            timer = StageTimer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            paths = swap_e2e.execute(session, args, timer=timer)
            wall = (time.perf_counter() - t0) * 1e3
            runs.append({"wall_ms": wall, "launches": launch_counts(),
                         "peak": torch.cuda.max_memory_allocated(),
                         "parts_ms": {k: v * 1e3 for k, v
                                      in timer.totals.items()},
                         "report": timer.report(),
                         "out": [np.load(p) for p in paths]})
            if i == 0:
                template = os.path.exists(clip_path[:-4] + ".pkl")
    finally:
        session.cropper.crop_source_video = real_crop
    result, concat = runs[1]["out"]
    side = session.model_cfg.output_size
    batches = n // CLIP_BATCH
    with torch.inference_mode():
        mask = torch.cat([
            torch.stack([G.prepare_paste_back(
                m, crops["M_c2o_lst"][lo + j], (w, h), if_float=True)[..., 0]
                for j, m in enumerate(session.parse_masks(torch.stack(
                    crops["frame_crop_lst"][lo:lo + CLIP_BATCH])))])
            for lo in range(0, n, CLIP_BATCH)]).cpu().numpy()
    frames = seeded_clip(CLIP_SEED)
    moved = (result != frames).any(-1)
    zero = mask <= 0
    inside, outside = int(moved[mask >= 0.5].sum()), int(moved[zero].sum())
    same_runs = all(np.array_equal(a, b)
                    for a, b in zip(runs[0]["out"], runs[1]["out"]))
    vs_clip = np.abs(result.astype(int) - clip_run["result"].astype(int))
    wall = runs[1]["wall_ms"]
    emit("pipeline_swap", entry="swap_e2e.execute", clip=list(SIDECAR_CLIP),
         batch=CLIP_BATCH, generator="CANONICAL bf16 exact",
         session_init_s=session.init_s,
         walls_ms=[r["wall_ms"] for r in runs], wall_ms=wall,
         frames_per_s=n / (wall / 1e3), clip_path_wall_ms=clip_run["wall_ms"],
         clip_path_parts_ms=clip_run["parts_ms"],
         parts_ms=runs[1]["parts_ms"], cold_parts_ms=runs[0]["parts_ms"],
         max_memory_allocated=runs[1]["peak"],
         launches=[list(r["launches"]) for r in runs],
         launches_order=list(KERNEL_NAMES), template_dumped=template,
         result_shape=list(result.shape), concat_shape=list(concat.shape),
         second_run_equal=same_runs,
         vs_clip_path_max_diff=int(vs_clip.max()),
         vs_clip_path_values_differ=int((vs_clip > 0).sum()),
         changed_pixels_mask_over_half=inside, mask_zero_pixels=int(
             zero.sum()), changed_pixels=int(moved.sum()))
    print(runs[1]["report"], flush=True)
    if (result.shape != (n, h, w, 3) or concat.shape != (n, side, 4 * side, 3)
            or result.dtype != np.uint8 or concat.dtype != np.uint8):
        raise AssertionError(f"pipeline_swap: outputs {result.shape} "
                             f"{result.dtype}, {concat.shape}")
    if not template:
        raise AssertionError("pipeline_swap: no motion template dumped")
    if not same_runs:
        raise AssertionError("pipeline_swap: the run from the template "
                             "differs from the first")
    if vs_clip.max() > 0:
        raise AssertionError(f"pipeline_swap: {int((vs_clip > 0).sum())} "
                             f"values differ from clip_path's, by up to "
                             f"{int(vs_clip.max())}")
    if not zero.any() or inside == 0 or outside:
        raise AssertionError(
            f"pipeline_swap: {inside} pixels changed where the mask is "
            f">= 0.5, {outside} where it is 0")
    if any(r["launches"] != only(warp3d=2 * batches) for r in runs):
        raise AssertionError(f"pipeline_swap: launches "
                             f"{[r['launches'] for r in runs]}")
    return {"launches": runs[1]["launches"][0], "wall_ms": wall,
            "result": result, "mask": mask}


def phase_pipeline_v2i_multi(session, d: str) -> dict:
    """``swap_v2i.execute`` on the seeded source and the clip's first 8
    frames, and ``swap_multi.execute`` on the 16-frame clip, through the
    same session.  Hard checks: the outputs' shapes; every float the
    generator returned finite (``Finite``); pixels changed; the exact warp's
    launches (v2i: 1 for the source's canonical warp and 1 per batch of
    re-animation; multi: 2 per batch per face) and no other kernel; with
    cv2 hidden, a .mp4 driving file raises an ImportError that names it."""
    from canonswap_torch.configs import ArgumentConfig
    from canonswap_torch.pipelines import swap_e2e, swap_multi, swap_v2i
    from canonswap_torch.runtime import core as C
    from canonswap_torch.utils import io as IO

    n, h, w = SIDECAR_CLIP
    src, clip16 = f"{d}/src.ppm", f"{d}/clip{n}.npy"
    _, clip8 = write_media(d, CLIP_BATCH)
    source = IO.load_image_rgb(src)
    out = {}
    with Finite(C, "reanimate_step") as fin_v2i, \
            Finite(C, "conv_decode") as fin_can:
        reset_launch_counts()
        t0 = time.perf_counter()
        paths = swap_v2i.execute(session, ArgumentConfig(
            source=src, driving=clip8, output_dir=f"{d}/v2i"))
        out["v2i_ms"] = (time.perf_counter() - t0) * 1e3
        out["v2i_launches"] = launch_counts()
    res, concat = (np.load(p) for p in paths)
    side = session.model_cfg.output_size
    cans = [IO.load_image_rgb(f"{d}/v2i/{k}.ppm")
            for k in ("source_can", "swap_can")]
    faces = session.face_analysis.get(seeded_clip(CLIP_SEED)[0])
    with Finite(C, "swap_step") as fin_multi:
        reset_launch_counts()
        t0 = time.perf_counter()
        multi = np.load(swap_multi.execute(session, ArgumentConfig(
            source=src, driving=clip16, output_dir=f"{d}/multi")))
        out["multi_ms"] = (time.perf_counter() - t0) * 1e3
        out["multi_launches"] = launch_counts()
    faces_n = min(len(faces), 4)
    # a .mp4 driving file without cv2 (hidden here where it is installed)
    with open(f"{d}/clip.mp4", "wb") as f:
        f.write(b"\0" * 64)
    mp4_error, cv2_module = None, sys.modules.get("cv2")
    sys.modules["cv2"] = None  # import cv2 now raises ImportError
    try:
        swap_e2e.execute(session, ArgumentConfig(
            source=src, driving=f"{d}/clip.mp4", output_dir=f"{d}/mp4"))
    except ImportError as e:
        mp4_error = str(e)
    finally:
        if cv2_module is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = cv2_module
    frames = seeded_clip(CLIP_SEED)
    emit("pipeline_v2i_multi", entry="swap_v2i.execute, swap_multi.execute",
         v2i_frames=CLIP_BATCH, v2i_ms=out["v2i_ms"],
         v2i_result_shape=list(res.shape), v2i_concat_shape=list(
             concat.shape), can_shapes=[list(c.shape) for c in cans],
         v2i_changed_pixels=int((res != source).any(-1).sum()),
         v2i_finite=fin_v2i.finite and fin_can.finite,
         v2i_launches=list(out["v2i_launches"]), multi_faces=faces_n,
         multi_ms=out["multi_ms"], multi_shape=list(multi.shape),
         multi_changed_pixels=int((multi != frames).any(-1).sum()),
         multi_finite=fin_multi.finite,
         multi_launches=list(out["multi_launches"]),
         launches_order=list(KERNEL_NAMES), mp4_without_cv2=mp4_error)
    if (res.shape != (CLIP_BATCH, h, w, 3)
            or concat.shape != (CLIP_BATCH, side, 2 * side, 3)
            or any(c.shape != (side, side, 3) for c in cans)
            or multi.shape != (n, h, w, 3)):
        raise AssertionError("pipeline_v2i_multi: output shapes")
    if not (fin_v2i.finite and fin_can.finite and fin_multi.finite
            and fin_v2i.calls == 1 and fin_multi.calls == 2 * faces_n):
        raise AssertionError("pipeline_v2i_multi: a non-finite output")
    if not ((res != source).any() and (multi != frames).any()):
        raise AssertionError("pipeline_v2i_multi: no pixel changed")
    if (out["v2i_launches"] != only(warp3d=2)
            or out["multi_launches"] != only(warp3d=4 * faces_n)):
        raise AssertionError(f"pipeline_v2i_multi: launches {out}")
    if not (mp4_error and "clip.mp4" in mp4_error):
        raise AssertionError("pipeline_v2i_multi: a .mp4 without cv2 did "
                             f"not raise naming the file: {mp4_error}")
    return {"launches": out["v2i_launches"][0] + out["multi_launches"][0]}


def phase_pipeline_stream_fast(d: str) -> dict:
    """``streaming.execute`` with the fast bundle's flags
    (``dense_motion_scale=2, flag_int8=True``) on the 16-frame clip, in a
    session of its own (``clip_session``): twice, the second timed with
    StageTimer's report.  Hard checks: 16 (720, 1280, 3) frames, pixels
    changed, and per batch exactly 0 / 2 / 86 launches of the exact warp,
    the W8A8 warp and the W8A8 conv (and no other kernel)."""
    from canonswap_torch.configs import ArgumentConfig
    from canonswap_torch.pipelines import streaming
    from canonswap_torch.utils.timing import StageTimer

    n, h, w = SIDECAR_CLIP
    session = clip_session(dense_motion_scale=2, flag_int8=True)
    per_batch = []
    real_swap = session.swap_with_motion

    def counted(*args, **kwargs):
        before = launch_counts()
        got = real_swap(*args, **kwargs)
        per_batch.append([a - b for a, b in zip(launch_counts(), before)])
        return got

    session.swap_with_motion = counted
    args = ArgumentConfig(source=f"{d}/src.ppm", driving=f"{d}/clip{n}.npy",
                          output_dir=f"{d}/stream")
    walls = []
    for _ in range(2):
        timer = StageTimer()
        per_batch.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        path = streaming.execute(session, args, timer=timer)
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    res = np.load(path)
    emit("pipeline_stream_fast", entry="streaming.execute",
         config="fast_bundle(CANONICAL) bf16", session_init_s=session.init_s,
         walls_ms=walls, wall_ms=walls[1], frames_per_s=n / (walls[1] / 1e3),
         parts_ms={k: v * 1e3 for k, v in timer.totals.items()},
         launches_per_batch=per_batch, launches=list(launches),
         launches_order=list(KERNEL_NAMES), result_shape=list(res.shape),
         changed_pixels=int((res != seeded_clip(CLIP_SEED)).any(-1).sum()))
    want = list(only(warp3d_q=2, qconv=86))
    if res.shape != (n, h, w, 3) or not (res != seeded_clip(CLIP_SEED)).any():
        raise AssertionError(f"pipeline_stream_fast: output {res.shape}")
    if per_batch != [want] * (n // CLIP_BATCH) or launches != only(
            warp3d_q=2 * n // CLIP_BATCH, qconv=86 * n // CLIP_BATCH):
        raise AssertionError(f"pipeline_stream_fast: launches per batch "
                             f"{per_batch}, all {launches}")
    return {"launches": launches, "wall_ms": walls[1]}


def phase_cli_swap(d: str) -> None:
    """``python -m canonswap_torch.cli.main swap -s src.ppm -t clip8.npy -o
    out --batch-size 8`` as a subprocess on the card, with the package's
    seeded weights (no ``hold_a_face``: structure only).  Hard checks: exit
    0, both outputs with 8 frames of (720, 1280, 3) and (512, 2048, 3), and
    the pipeline's log lines."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    out = f"{d}/cli"
    cmd = [sys.executable, "-m", "canonswap_torch.cli.main", "swap", "-s",
           f"{d}/src.ppm", "-t", f"{d}/clip{CLIP_BATCH}.npy", "-o", out,
           "--batch-size", str(CLIP_BATCH)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    stem = f"{out}/src--clip{CLIP_BATCH}"
    shapes = {k: list(np.load(p).shape) if os.path.exists(p) else None
              for k, p in (("result", f"{stem}.npy"),
                           ("concat", f"{stem}_concat.npy"))}
    lines = ["Get source ID", f"Driving video cropped: {CLIP_BATCH} frames",
             "Dumped motion template", "Results:"]
    seen = {line: line in proc.stdout for line in lines}
    emit("cli_swap", cmd=" ".join(cmd[1:]), rc=proc.returncode, wall_s=wall,
         shapes=shapes, log_lines=seen, stdout_tail=proc.stdout[-600:],
         stderr_tail=proc.stderr[-600:])
    if proc.returncode or shapes != {
            "result": [CLIP_BATCH, *SIDECAR_CLIP[1:], 3],
            "concat": [CLIP_BATCH, 512, 2048, 3]} or not all(seen.values()):
        raise AssertionError(f"cli_swap: rc {proc.returncode}, {shapes}, "
                             f"{seen}")


# --- training: the exact warp's backward and the train step -----------------

# training phases: the train CLI's default batch, five steps
TRAIN_BATCH = 8
TRAIN_STEPS = 5
# stated constants on the seeded motion extractor's heads (hold_keypoints):
# every head's weights scaled by this, the canonical keypoints' bias
# uniform in +-KP_RANGE
KP_HEAD_WEIGHT_SCALE = 0.01
KP_RANGE = 0.5
# the kernel's gradients against the plain backward's, through the whole
# step: the two differ only in the warp backward's f32 sum order (atomics,
# in both), carried through the same backward upstream; of each leaf's
# largest, or, where that order moves a leaf further between two runs of
# one backward, TRAIN_SPREAD_MULT times the largest such movement among
# TRAIN_GRAD_RUNS runs of each.  Measured: the one-value bias of the last
# adaptive block's mask conv (transfer.BottleNeck_2d.4.conv2.mask_conv.0)
# sums a whole batch's mask map that cancels, and moves by 1.4e-4 to 2.4e-4
# of itself between two runs of the same backward.  With independent
# orders, a one-value leaf exceeds 6 times the largest of six such
# movements about once in a thousand calls.
TRAIN_GRAD_TOL = 1e-4
TRAIN_GRAD_RUNS = 3
TRAIN_SPREAD_MULT = 6.0
# a leaf whose largest gradient is below this share of the tree's is an
# exact zero in rounding noise (a conv bias followed by a normalization):
# both runs must hold it there, their noise is not compared
ZERO_GRAD_SHARE = 1e-6


def warp_bwd_bound(vol, grid, gout):
    """The backward's bound: vol, grid and grad_out read once, grad_vol and
    grad_grid written once; per output value and corner, the grad_vol
    product and three partial derivatives' multiply-adds (8 operations)."""
    return bound_ms(nbytes(vol, grid, gout) + nbytes(vol, grid),
                    64.0 * gout.numel(), F32_PEAK_TFLOPS)


def phase_warp_bwd_kernel() -> dict:
    """``warp3d_backward`` against the plain gradient (``F.grid_sample``'s
    autograd backward in f32): grad_vol and grad_grid, max abs over max
    |ref| <= 1e-5, at a small ragged shape with points outside the volume
    and at CANONICAL B=8 f32 (the training path's shape) on the smooth
    in-range field and a random one; timed there beside the plain version
    (its forward and backward), the library backward
    (``aten::grid_sampler_3d_backward``) and the bound."""
    from canonswap_torch.ops.cuda.warp import (warp3d_backward_cuda,
                                               warp3d_backward_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(30)
    cases, timings = [], {}

    def check(label, vol, grid, gout):
        gv, gg = warp3d_backward_cuda(vol, grid, gout)
        pv, pg = warp3d_backward_plain(vol, grid, gout)
        torch.cuda.synchronize()
        (rv, av), (rg, ag) = max_rel_err(gv, pv), max_rel_err(gg, pg)
        cases.append({"case": label, "grad_vol_rel": rv, "grad_grid_rel": rg,
                      "tol": F32_TOL})
        if not (rv <= F32_TOL and rg <= F32_TOL):
            emit("warp_bwd_kernel", cases=cases, ok=False)
            raise AssertionError(f"warp3d_backward vs plain {label}: "
                                 f"grad_vol {rv}, grad_grid {rg} > {F32_TOL}")
        return max(av, ag)

    vol = torch.randn((2, 5, 3, 7, 9), generator=gen).to(dev)
    grid = ((torch.rand((2, 4, 6, 5, 3), generator=gen) * 2 - 1) * 1.6).to(dev)
    check("ragged_outside", vol, grid, torch.randn(
        (2, 5, 4, 6, 5), generator=gen).to(dev))
    b = TRAIN_BATCH
    vol = torch.randn((b, 32, 16, 64, 64), generator=gen).to(dev)
    gout = torch.randn((b, 32, 16, 64, 64), generator=gen).to(dev)
    worst = 0.0
    for field, grid in (
        ("smooth", smooth_grid(b, 16, 64, 64, 0.05, gen, dev, torch.float32)),
        ("random", (torch.rand((b, 16, 64, 64, 3), generator=gen) * 2
                    - 1).to(dev)),
    ):
        worst = max(worst, check(f"canonical_{field}", vol, grid, gout))
        p1 = time_ms(lambda: warp3d_backward_plain(vol, grid, gout), iters=5)
        k1 = time_ms(lambda: warp3d_backward_cuda(vol, grid, gout))
        k2 = time_ms(lambda: warp3d_backward_cuda(vol, grid, gout))
        p2 = time_ms(lambda: warp3d_backward_plain(vol, grid, gout), iters=5)
        lib = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
            gout, vol, grid, 0, 0, False, [True, True]))
        bound, bound_by = warp_bwd_bound(vol, grid, gout)
        timings[field] = {
            "kernel_ms": [k1, k2], "plain_ms": [p1, p2], "library_ms": lib,
            "bound_ms": bound, "bound_by": bound_by,
            "inside_share": float((grid.abs() <= 1).all(-1).float().mean())}
    emit("warp_bwd_kernel", cases=cases, timings_b8=timings,
         max_abs_err=worst, ok=True)
    return {"timings": timings, "max_abs_err": worst}


def hold_keypoints(core, gen) -> None:
    """Sets the stated constants above on the seeded motion extractor's
    heads, so the keypoints the warps consume lie inside the sampling grid
    (seeded weights put them near |x_t| = 10, where the warp samples zero
    padding and its gradient is zero): every head's weights times
    KP_HEAD_WEIGHT_SCALE, the canonical keypoints' bias uniform in
    +-KP_RANGE, the expression's, translation's and pose bins' biases 0
    (a flat bin softmax is 0 degrees), the scale's bias 1."""
    det = core.motion_extractor.detector
    kp = (torch.rand(det.fc_kp.bias.shape, generator=gen) * 2 - 1) * KP_RANGE
    with torch.no_grad():
        for name in ("fc_kp", "fc_pitch", "fc_yaw", "fc_roll", "fc_t",
                     "fc_exp", "fc_scale"):
            head = getattr(det, name)
            head.weight *= KP_HEAD_WEIGHT_SCALE
            head.bias.zero_()
        det.fc_kp.bias.copy_(kp.to(det.fc_kp.bias.device))
        det.fc_scale.bias.fill_(1.0)


def record_inside_share(core, shares: list) -> None:
    """Wraps the core's warp to record each call's share of sample points
    inside the volume (a device scalar, read later)."""
    sample = core.warping_module.sample

    def recorded(vol, grid):
        shares.append((grid.detach().abs() <= 1).all(-1).float().mean())
        return sample(vol, grid)

    core.warping_module.sample = recorded


def phase_train_step() -> dict:
    """``runtime/train.py`` at CANONICAL f32 with seeded weights (the motion
    heads held by ``hold_keypoints``), B=8 seeded 256 frames, a seeded ID
    latent.  First, on the same tensors, the step's gradients through the
    kernel backward and through the plain one swapped in, TRAIN_GRAD_RUNS
    times each (cuDNN deterministic, so the warp backward is the one
    difference): every leaf within TRAIN_GRAD_TOL of its largest gradient,
    or within TRAIN_SPREAD_MULT times the largest run-to-run spread of
    either (leaves at rounding zero: both there), and a nonzero finite
    gradient on every
    parameter of the appearance encoder and the dense motion network, the
    two upstream of the warps.  Then five steps: ms per step (median of the
    last three), peak memory, the loss and its terms each step (finite),
    launches per step (exact warp 2, its backward 2, nothing else), the
    share of each warp's sample points inside the volume."""
    from canonswap_torch.configs import CANONICAL
    from canonswap_torch.ops.cuda import warp as W
    from canonswap_torch.runtime import core as C
    from canonswap_torch.runtime import train as T

    dev, b, s = torch.device("cuda"), TRAIN_BATCH, CANONICAL.input_size
    gen = torch.Generator().manual_seed(40)
    t0 = time.perf_counter()
    core = C.CanonSwapCore(CANONICAL, seed=0, device="cpu")
    hold_keypoints(core, gen)
    core.to(dev)
    init_s = time.perf_counter() - t0
    leaves = T.trainable(core)
    opt = T.make_optimizer(leaves)
    frames = torch.rand((b, s, s, 3), generator=gen).to(dev)
    sid = torch.randn((b, CANONICAL.swap.latent_dim), generator=gen).to(dev)
    shares: list = []
    record_inside_share(core, shares)

    def gradients():
        opt.zero_grad(set_to_none=True)
        loss, _ = T.loss_fn(core, frames, sid)
        loss.backward()
        return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                .detach().clone() for k, v in leaves.items()}

    def plain_launch(vol, grid, gout, gvol, ggrid):
        pv, pg = W.warp3d_backward_plain(vol, grid, gout)
        gvol.add_(pv)
        ggrid.copy_(pg)

    torch.backends.cudnn.deterministic = True
    real_launch = W._launch_backward
    try:
        reset_launch_counts()
        g_kernel = [gradients() for _ in range(TRAIN_GRAD_RUNS)]
        grad_launches = launch_counts()
        W._launch_backward = plain_launch
        g_plain = [gradients() for _ in range(TRAIN_GRAD_RUNS)]
    finally:
        W._launch_backward = real_launch
        torch.backends.cudnn.deterministic = False
    top = max(float(g.abs().max()) for g in g_plain[0].values())
    worst, zero_leaves, by_spread, bad = 0.0, [], [], []
    for k, want in g_plain[0].items():
        got = g_kernel[0][k]
        lm = float(want.abs().max())
        if lm < ZERO_GRAD_SHARE * top:
            zero_leaves.append(k)
            if float(got.abs().max()) >= ZERO_GRAD_SHARE * top:
                bad.append(k)
            continue
        err = float((got - want).abs().max())
        worst = max(worst, err / lm)
        if err <= TRAIN_GRAD_TOL * lm:
            continue
        spread = max(float((a[k] - b[k]).abs().max())
                     for g in (g_kernel, g_plain)
                     for a, b in itertools.combinations(g, 2))
        by_spread.append([k, err / lm, spread / lm])
        if not err <= TRAIN_SPREAD_MULT * spread:
            bad.append(k)
    g_kernel = g_kernel[0]
    upstream = [(f"appearance_feature_extractor.{k}", p) for k, p in
                core.appearance_feature_extractor.named_parameters()] + [
        (f"warping_module.dense_motion_network.{k}", p) for k, p in
        core.warping_module.dense_motion_network.named_parameters()]
    dead = [k for k, _ in upstream
            if not (bool(torch.isfinite(g_kernel[k]).all())
                    and bool((g_kernel[k] != 0).any()))]
    del g_kernel, g_plain

    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        shares.clear()
        reset_launch_counts()
        t1 = time.perf_counter()
        metrics = T.train_step(core, leaves, opt, frames, sid)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t1) * 1e3,
                      **{k: float(v) for k, v in metrics.items()},
                      "launches": list(launch_counts()),
                      "inside_share": [float(x) for x in shares]})
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median([st["ms"] for st in steps[-3:]]))
    emit("train_step", config="CANONICAL", dtype="f32", batch=b,
         init_s=init_s, ms_per_step=ms, frames_per_s=b / (ms / 1e3),
         max_memory_allocated=peak, steps=steps,
         launches_order=list(KERNEL_NAMES),
         grad_vs_plain_worst_rel=worst, grad_tol=TRAIN_GRAD_TOL,
         grad_leaves=len(leaves), zero_grad_leaves=len(zero_leaves),
         leaves_held_by_spread=by_spread,
         grad_launches=list(grad_launches), failing_leaves=bad,
         upstream_params=len(upstream), upstream_without_gradient=dead)
    want = only(warp3d=2, warp3d_backward=2)
    terms = ("loss", "l1", "kp_prior", "range_prior", "grad_norm")
    if bad or dead:
        raise AssertionError(f"train_step: gradients off the plain "
                             f"backward's {bad}; upstream parameters "
                             f"without a nonzero finite gradient {dead}")
    runs = 2 * TRAIN_GRAD_RUNS
    if grad_launches != only(warp3d=runs, warp3d_backward=runs) or any(
            tuple(st["launches"]) != want for st in steps):
        raise AssertionError(f"train_step: launches per step "
                             f"{[st['launches'] for st in steps]}, "
                             f"{grad_launches}")
    if not all(np.isfinite(st[k]) for st in steps for k in terms):
        raise AssertionError("train_step: a non-finite loss term")
    if min(st["inside_share"][0] for st in steps) < 0.5:
        raise AssertionError("train_step: the keypoints left the grid")
    del core, leaves, opt
    torch.cuda.empty_cache()
    return {"launches_per_step": steps[-1]["launches"][
        KERNEL_NAMES.index("warp3d_backward")], "ms_per_step": ms}


def phase_train_card_vs_cpu() -> None:
    """One step's loss and gradients at TINY f32 (seeded weights, the motion
    heads held by ``hold_keypoints``; B=2 seeded frames), on the card and
    on the CPU.  The loss terms within 2e-4.  The gradients against the
    CPU's f64 run of the same step (its warp computes in f32): within 2e-4
    of each leaf's largest plus three times what rounding alone moves
    there: the CPU f32 run's distance from the f64 one, the spread between
    two CPU f32 runs whose warp grids are nudged one ulp up and one down,
    and the spread between two card runs, with cuDNN's convolutions and
    with PyTorch's own (cuDNN off: another order of the same f32 sums).
    Reasons: the card's convolutions round otherwise than the CPU's, by
    up to several times the CPU's own f32 error on the small leaves
    (measured: 3.5 times on the SPADE norms' leaves); and a sample
    coordinate within an ulp of an integer
    sits on a tent's kink, where the card (nvcc contracts the coordinate
    ((g + 1) * size - 1) / 2 into a fused multiply-add, in the kernel as
    in F.grid_sample's CUDA backward) and the CPU round to either side and
    take other one-sided derivatives; a near-identity deformation puts
    many points there, and their grid gradients flow back into the dense
    motion network and the appearance encoder.  At TINY the nudge alone
    moves those leaves' gradients by 0.5 to 2 % of their largest (measured
    on the CPU), and the f32 rounding of the whole backward pass by up to
    0.5 %."""
    from canonswap_torch.configs import TINY
    from canonswap_torch.runtime import core as C
    from canonswap_torch.runtime import train as T

    gen = torch.Generator().manual_seed(41)
    frames = torch.rand((2, TINY.input_size, TINY.input_size, 3),
                        generator=gen)
    sid = torch.randn((2, TINY.swap.latent_dim), generator=gen)

    def step(device, dtype, nudge=0.0):
        core = C.CanonSwapCore(TINY, seed=7, device="cpu")
        hold_keypoints(core, torch.Generator().manual_seed(42))
        core.to(device, dtype)
        if nudge:
            sample = core.warping_module.sample

            def nudged(vol, grid):
                g = grid.detach()
                return sample(vol, grid + (torch.nextafter(
                    g, torch.full_like(g, nudge)) - g))

            core.warping_module.sample = nudged
        leaves = T.trainable(core)
        loss, metrics = T.loss_fn(core, frames.to(device, dtype),
                                  sid.to(device, dtype))
        loss.backward()
        return ({k: float(v.detach()) for k, v in metrics.items()},
                {k: v.grad.detach().double().cpu() for k, v in leaves.items()})

    reset_launch_counts()
    card = step(torch.device("cuda"), torch.float32)
    launches = launch_counts()
    torch.backends.cudnn.enabled = False
    try:
        card_native = step(torch.device("cuda"), torch.float32)
    finally:
        torch.backends.cudnn.enabled = True
    cpu = torch.device("cpu")
    cpu32, exact = step(cpu, torch.float32), step(cpu, torch.float64)
    up, down = (step(cpu, torch.float32, n) for n in (np.inf, -np.inf))
    loss_err = max(abs(card[0][k] - cpu32[0][k]) for k in cpu32[0])
    top = max(float(g.abs().max()) for g in exact[1].values())
    worst, over, bad = 0.0, 0, []
    for k, want in exact[1].items():
        lm = float(want.abs().max())
        err = float((card[1][k] - want).abs().max())
        rounding = sum(float((a[1][k] - b[1][k]).abs().max()) for a, b in (
            (cpu32, exact), (up, down), (card, card_native)))
        if lm >= ZERO_GRAD_SHARE * top:
            worst = max(worst, err / lm)
        over += err > 2e-4 * lm
        if not err <= 2e-4 * lm + 3 * rounding:
            bad.append((k, err, lm, rounding))
    emit("train_card_vs_cpu", config="TINY", dtype="f32", batch=2,
         loss_card=card[0], loss_cpu=cpu32[0], loss_max_abs_err=loss_err,
         leaves=len(exact[1]), leaves_over_2e_4_of_their_largest=over,
         worst_card_vs_f64_rel=worst, failing_leaves=bad[:10],
         zero_grad_share=ZERO_GRAD_SHARE,
         launches=list(launches), launches_order=list(KERNEL_NAMES))
    if not loss_err <= 2e-4 or bad:
        raise AssertionError(f"train_card_vs_cpu: loss {loss_err}, "
                             f"gradients {bad[:5]}")
    if launches != only(warp3d=2, warp3d_backward=2):
        raise AssertionError(f"train_card_vs_cpu: launches {launches}")


def phase_pipeline_stitch(d: str, unflagged: dict):
    """``swap_e2e.execute`` in the clip cell's session with
    ``flag_stitching``, ``flag_eye_retargeting``, ``flag_lip_retargeting``
    and ``flag_normalize_lip`` on (seeded stitching nets), on the 16-frame
    clip under another name (a template of its own): twice, fused then
    from the template.  Hard checks: the two runs' frames equal bit for bit
    (the template holds the unadjusted motion); the frames differ from the
    unflagged run's (``pipeline_swap``) where the warped mask is >= 0.5 and
    equal it where the mask is 0; the exact warp launched 2 times per batch
    and no other kernel.  Returns the session."""
    import os

    from canonswap_torch.configs import ArgumentConfig
    from canonswap_torch.pipelines import swap_e2e

    n = SIDECAR_CLIP[0]
    session = clip_session(flag_stitching=True, flag_eye_retargeting=True,
                           flag_lip_retargeting=True, flag_normalize_lip=True)
    clip = f"{d}/clip_stitch.npy"
    np.save(clip, seeded_clip(CLIP_SEED))
    args = ArgumentConfig(source=f"{d}/src.ppm", driving=clip,
                          output_dir=f"{d}/out_stitch")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        paths = swap_e2e.execute(session, args)
        runs.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "launches": launch_counts(),
                     "out": [np.load(p) for p in paths]})
    template = os.path.exists(clip[:-4] + ".pkl")
    same = all(np.array_equal(a, b)
               for a, b in zip(runs[0]["out"], runs[1]["out"]))
    result, mask = runs[0]["out"][0], unflagged["mask"]
    moved = (result != unflagged["result"]).any(-1)
    inside, outside = int(moved[mask >= 0.5].sum()), int(moved[mask <= 0]
                                                         .sum())
    emit("pipeline_stitch", entry="swap_e2e.execute",
         flags=["flag_stitching", "flag_eye_retargeting",
                "flag_lip_retargeting", "flag_normalize_lip"],
         session_init_s=session.init_s,
         walls_ms=[r["wall_ms"] for r in runs],
         frames_per_s=n / (runs[1]["wall_ms"] / 1e3),
         launches=[list(r["launches"]) for r in runs],
         launches_order=list(KERNEL_NAMES), template_dumped=template,
         second_run_equal=same, changed_vs_unflagged_mask_over_half=inside,
         changed_vs_unflagged_mask_zero=outside)
    if not (template and same):
        raise AssertionError(f"pipeline_stitch: template {template}, the "
                             f"cached run equal to the first {same}")
    if inside == 0 or outside:
        raise AssertionError(f"pipeline_stitch: {inside} pixels differ from "
                             f"the unflagged run where the mask is >= 0.5, "
                             f"{outside} where it is 0")
    if any(r["launches"] != only(warp3d=2 * (n // CLIP_BATCH)) for r in runs):
        raise AssertionError(f"pipeline_stitch: launches "
                             f"{[r['launches'] for r in runs]}")
    return session


def phase_train_cli(d: str, session) -> None:
    """``python -m canonswap_torch.cli.train --data-dir <dir of a seeded
    .npy clip> --steps 3 --batch 2`` as a subprocess on the card (CANONICAL,
    seeded weights).  Hard checks: exit 0, its step log lines, and the
    ``.npz`` it writes loads into a session's core (strict keys)."""
    import os

    from canonswap_torch.pipelines.session import load_core_checkpoint

    repo = os.path.dirname(os.path.abspath(__file__))
    data = f"{d}/train_data"
    os.makedirs(data, exist_ok=True)
    np.save(f"{data}/clip.npy", seeded_clip(CLIP_SEED)[:4])
    ckpt = f"{d}/train_ckpt.npz"
    cmd = [sys.executable, "-m", "canonswap_torch.cli.train", "--data-dir",
           data, "--steps", "3", "--batch", "2", "--ckpt-out", ckpt,
           "--log-every", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    lines = ["step 3/3 loss=", "Saved checkpoint to"]
    seen = {line: line in proc.stdout for line in lines}
    loaded = False
    if proc.returncode == 0 and os.path.exists(ckpt):
        load_core_checkpoint(session.core, ckpt)
        loaded = True
    emit("train_cli", cmd=" ".join(cmd[1:]), rc=proc.returncode, wall_s=wall,
         log_lines=seen, loaded_into_session=loaded,
         stdout_tail=proc.stdout[-600:], stderr_tail=proc.stderr[-600:])
    if proc.returncode or not all(seen.values()) or not loaded:
        raise AssertionError(f"train_cli: rc {proc.returncode}, {seen}, "
                             f"loaded {loaded}")


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
    session = clip_session()
    clip = phase_clip_path(session)
    phase_clip_card_vs_cpu()
    phase_tools()
    with tempfile.TemporaryDirectory() as d:
        pipe = phase_pipeline_swap(session, clip, d)
        v2i_multi = phase_pipeline_v2i_multi(session, d)
        del session
        torch.cuda.empty_cache()
        stream = phase_pipeline_stream_fast(d)
        phase_cli_swap(d)
        stitch_session = phase_pipeline_stitch(d, pipe)
        del pipe["result"], pipe["mask"]
        # after every torch.profiler pass: once the autograd engine has run
        # on the card, a later profiler pass recorded no device event
        bwd = phase_warp_bwd_kernel()
        train = phase_train_step()
        phase_train_card_vs_cpu()
        phase_train_cli(d, stitch_session)
        del stitch_session
    bf16 = timings["smooth_bfloat16"]
    bf16_q = warp_q["timings"]["smooth_bfloat16"]
    adaptive = qconv["timings"]["adaptive"]
    enc = msda["timings"]["encoder"]
    smooth_bwd = bwd["timings"]["smooth"]
    print(json.dumps({"kernels": [{
        "name": "warp3d", "route": "cuda",
        "source": "canonswap_torch/csrc/warp3d.cu",
        "replaces": "canonswap_tpu/ops/pallas/warp.py:378",
        "launches": main_path["launches"],
        "clip_path_launches": clip["launches"][0],
        "pipeline_launches": pipe["launches"] + v2i_multi["launches"],
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
        "stream_launches": stream["launches"][1],
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
        "stream_launches": stream["launches"][2],
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
        **({"path": probes["timings"][name]["path"],
            "bound_share": probes["timings"][name]["bound_share"]}
           if name == "dyn_gather" else {}),
        "host_us": probes["timings"][name]["host_us"],
        "library_host_us": probes["timings"][name]["library_host_us"],
        "graph_ms": probes["timings"][name]["graph_ms"],
        "library_graph_ms": probes["timings"][name]["library_graph_ms"],
    } for name, replaces in (("dyn_gather", "tools/profile_r2b.py:192"),
                             ("dbl", "tools/profile_r2c.py:56"),
                             ("mm", "tools/profile_r2c.py:71"))] + [{
        "name": "warp3d_backward", "route": "cuda",
        "source": "canonswap_torch/csrc/warp3d.cu",
        "replaces": "none (the JAX trainer differentiates its XLA warp: "
                    "canonswap_tpu/runtime/train.py:71)",
        "launches": train["launches_per_step"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": float(np.median(smooth_bwd["kernel_ms"])),
        "plain_ms": float(np.median(smooth_bwd["plain_ms"])),
        "bound_ms": smooth_bwd["bound_ms"],
        "bound_by": smooth_bwd["bound_by"],
        "library_ms": smooth_bwd["library_ms"],
        "random_field_ms": float(np.median(
            bwd["timings"]["random"]["kernel_ms"])),
        "random_field_library_ms": bwd["timings"]["random"]["library_ms"],
        "train_ms_per_step": train["ms_per_step"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
