"""Training CLI: self-reconstruction fine-tuning of the whole generator.

The port's counterpart of ``canonswap_tpu/cli/train.py`` on one device:
frames from the images and clips of a directory, resized to the model's
input and drawn at random into fixed-size batches, stepped by
``runtime/train.py`` (Adam behind a global-norm clip of 1) with a fixed
seeded ID latent, and saved as the JAX package's ``.npz`` layout (through
``runtime/weights.py::to_jax``), which the port's session loads
(``--checkpoint``).  ``.ppm`` images and ``.npy`` clips ((N, H, W, 3) uint8
RGB) need no codec; other formats go through cv2 where it is installed.

Usage (on the card; ``--device cpu --tiny`` for a small run on the CPU):
  python -m canonswap_torch.cli.train --data-dir frames/ --steps 1000 \\
      --batch 8 --ckpt-out ckpt.npz [--resume ckpt.npz]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np
import torch


def load_frames(data_dir: str, size: int) -> np.ndarray:
    """Every frame of the directory's images and clips (clips: their first
    256 frames), resized to (size, size): (N, size, size, 3) f32 in [0, 1]."""
    from canonswap_torch.ops.resize import resize_like_cv2
    from canonswap_torch.utils import io as IO
    from canonswap_torch.utils import video as V

    paths = sorted(p for p in glob.glob(osp.join(data_dir, "*"))
                   if IO.is_image(p) or IO.is_video(p))
    if not paths:
        raise FileNotFoundError(f"no images or clips in {data_dir}")
    frames = []
    for p in paths:
        imgs = ([IO.load_image_rgb(p)] if IO.is_image(p)
                else V.load_video(p, n_frames=256))
        frames += [resize_like_cv2(torch.from_numpy(np.ascontiguousarray(f)),
                                   (size, size)).numpy() for f in imgs]
    return np.stack(frames).astype(np.float32) / 255.0


def iter_batches(frames: np.ndarray, batch: int, seed: int = 0):
    """Endless batches of ``batch`` frames drawn with replacement."""
    rng = np.random.default_rng(seed)
    while True:
        yield frames[rng.integers(0, len(frames), batch)]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="canonswap-torch-train")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-out", default="canonswap_ckpt.npz")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--tiny", action="store_true", help="tiny config (tests)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    if ns.model_axis != 1:
        raise ValueError(
            f"--model-axis {ns.model_axis}: the port trains on one device; "
            "model parallelism across cards waits for multi-GPU support "
            "(ROADMAP A 8)")

    from canonswap_torch.configs import CANONICAL, TINY
    from canonswap_torch.pipelines.session import load_core_checkpoint
    from canonswap_torch.runtime import core as C
    from canonswap_torch.runtime import train as T
    from canonswap_torch.runtime.checkpoint import save_npz
    from canonswap_torch.runtime.device import resolve_device
    from canonswap_torch.runtime.weights import to_jax
    from canonswap_torch.utils.rlog import log
    from canonswap_torch.utils.timing import StageTimer

    cfg = TINY if ns.tiny else CANONICAL
    core = C.CanonSwapCore(cfg, seed=0, device="cpu")
    if ns.resume:
        load_core_checkpoint(core, ns.resume)
        log(f"Resumed from {ns.resume}")
    dev = resolve_device(ns.device)
    core.to(dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    leaves = T.trainable(core)
    opt = T.make_optimizer(leaves, ns.lr)
    batches = iter_batches(load_frames(ns.data_dir, cfg.input_size),
                           ns.batch)
    # self-reconstruction with a fixed random ID latent per run; a full
    # recipe would feed ArcFace embeddings of the batch's identities
    sid = torch.randn((ns.batch, cfg.swap.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)

    timer = StageTimer()
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    for i in range(ns.steps):
        frames = torch.from_numpy(next(batches)).to(dev)
        with timer.stage("train_step", items=ns.batch, sync=sync):
            metrics = T.train_step(core, leaves, opt, frames, sid)
        if (i + 1) % ns.log_every == 0 or i == 0:
            log(f"step {i + 1}/{ns.steps} "
                f"loss={float(metrics['loss']):.4f} "
                f"l1={float(metrics['l1']):.4f}")

    save_npz(ns.ckpt_out, to_jax(core.state_dict()))
    log(f"Saved checkpoint to {ns.ckpt_out}")
    log(timer.report())


if __name__ == "__main__":
    main()
