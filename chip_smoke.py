"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: card name and power limit, torch/CUDA versions, kernel build time;
  2. kernel vs plain: the CUDA warp against its plain PyTorch version, f32
     and bf16, and both timed at the main path's shape (B=8 CANONICAL);
  3. main path: CanonSwapCore(CANONICAL) in bf16 with seeded random weights,
     three frame batches through swap_with_motion, the warp's launches counted;
  4. card vs CPU: the port at TINY in f32 on the card and on the CPU.
Any failure exits nonzero.  The last line is the run's one-line verdict.
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def smooth_grid(b, d, h, w, scale, gen, device, dtype):
    """Identity (align_corners=False cell centres) plus a small random
    displacement: the kind of field dense motion emits."""
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) / n * 2 - 1
            for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    ident = torch.stack([xx, yy, zz], -1)[None].float()
    disp = (torch.rand((b, d, h, w, 3), generator=gen) * 2 - 1) * scale
    return (ident + disp).to(device=device, dtype=dtype).contiguous()


def phase_device() -> None:
    from canonswap_torch.ops.cuda.warp import WARP3D

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    WARP3D.load()
    load_s = time.perf_counter() - t0
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         warp3d_build_s=WARP3D.build_seconds, warp3d_load_s=load_s)
    print(WARP3D.build_log.strip(), flush=True)


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
            timings[f"{field}_{str(dtype).split('.')[-1]}"] = {
                "kernel_ms": [k1, k2], "plain_ms": [p1, p2], "rel": rel,
                "max_abs_err": abs_err}
    emit("kernel_vs_plain", cases=cases, timings_b8=timings,
         worst_rel_f32=worst[torch.float32],
         worst_rel_bf16=worst[torch.bfloat16], ok=True)
    return timings


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
    core = C.CanonSwapCore(CANONICAL, seed=0).to(dev, dtype)
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
    WARP3D.launches = 0
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
    launches = WARP3D.launches
    if per_batch != [2, 2, 2]:
        raise AssertionError(f"warp launches per batch {per_batch} != 2")
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

    bound = 2e-4
    dev = torch.device("cuda")
    cpu_core = C.CanonSwapCore(TINY, seed=5)
    gpu_core = C.CanonSwapCore(TINY, seed=5).to(dev)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    timings = phase_kernel()
    main_path = phase_main_path()
    phase_card_vs_cpu()
    bf16 = timings["smooth_bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "warp3d", "route": "cuda",
        "source": "canonswap_torch/csrc/warp3d.cu",
        "replaces": "canonswap_tpu/ops/pallas/warp.py:378",
        "launches": main_path["launches"],
        "max_abs_err": bf16["max_abs_err"],
        "ms": float(np.median(bf16["kernel_ms"])),
        "plain_ms": float(np.median(bf16["plain_ms"])),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
