"""The training step: self-reconstruction of the whole generator.

Port of ``canonswap_tpu/runtime/train.py`` on one device.  The loss swaps
each frame with its own motion and a given ID latent and must give the frame
back: L1 on the output pooled by 2, plus 0.1 times the keypoint prior, plus
the range prior on the posed and the canonical keypoints hinged at 0.9.
The step differentiates every leaf the JAX trainer does (every parameter and
every BatchNorm's running statistics: flax's ``batch_stats`` sit in the
same tree and get gradients through the eval-mode normalization), clips
the gradients to a global norm of 1 as optax's ``clip_by_global_norm``
does, and takes an Adam step with optax's defaults.

BatchNorm stays in eval mode, as in the JAX step.  Live spectral norm's
``u`` (``SpadeConfig.spectral_norm``) advances once per step.  On the card
the two warps of a step run the exact warp's kernel forward and its
hand-written backward (``ops/cuda/warp.py``); the int8 kernels have no
backward and raise under grad.
"""

from __future__ import annotations

import torch

from canonswap_torch.nn.blocks import BatchNorm2d, BatchNorm3d
from canonswap_torch.nn.spectral import SNConv2d
from canonswap_torch.ops.resize import avg_pool
from canonswap_torch.runtime import core as C

MAX_GRAD_NORM = 1.0


def trainable(core: C.CanonSwapCore) -> dict[str, torch.Tensor]:
    """Put ``core`` in training mode and return its trainable leaves by
    ``state_dict`` key: every parameter and every BatchNorm's running mean
    and variance, with requires_grad on (the core is built without).
    BatchNorm stays in eval mode; live spectral norm's convs go to training
    mode, so their ``u`` advances."""
    leaves = dict(core.named_parameters())
    for name, m in core.named_modules():
        if isinstance(m, (BatchNorm2d, BatchNorm3d)):
            leaves[f"{name}.running_mean"] = m.running_mean
            leaves[f"{name}.running_var"] = m.running_var
        elif isinstance(m, SNConv2d):
            m.train()
    for t in leaves.values():
        t.requires_grad_(True)
    return leaves


def make_optimizer(leaves: dict[str, torch.Tensor],
                   lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(list(leaves.values()), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def loss_fn(core: C.CanonSwapCore, frames: torch.Tensor,
            source_id: torch.Tensor):
    """frames (B, S, S, 3) in [0, 1], source_id (B or 1, latent) ->
    (loss, dict of loss, l1, kp_prior and range_prior)."""
    motion = C.extract_motion(core, frames)
    out = C.swap_step(core, frames, source_id, motion)["out"]
    # the output is twice the input's size (the pixel-shuffle head)
    recon = avg_pool(out.permute(0, 3, 1, 2), (2, 2)).permute(0, 2, 3, 1)
    l1 = (recon - frames).abs().mean()
    kp_prior = (motion["exp"] ** 2).mean() + (
        torch.relu(motion["kp"].abs() - 1.0) ** 2).mean()
    # the posed keypoints the warp consumes, and the canonical ones, kept
    # inside the sampling grid
    x_can = motion["scale"][..., None] * motion["kp"]
    range_prior = ((torch.relu(motion["x_t"].abs() - 0.9) ** 2).mean()
                   + (torch.relu(x_can.abs() - 0.9) ** 2).mean())
    loss = l1 + 0.1 * kp_prior + range_prior
    return loss, {"loss": loss, "l1": l1, "kp_prior": kp_prior,
                  "range_prior": range_prior}


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float = MAX_GRAD_NORM) -> torch.Tensor:
    """Scale the gradients in place by max_norm / max(max_norm, norm), as
    optax's ``clip_by_global_norm`` (``clip_grad_norm_`` adds 1e-6 to the
    norm, another clip); returns the norm before the clip.  No host
    synchronize."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


def train_step(core: C.CanonSwapCore, leaves: dict[str, torch.Tensor],
               opt: torch.optim.Optimizer, frames: torch.Tensor,
               source_id: torch.Tensor) -> dict[str, torch.Tensor]:
    """One step: the loss and its gradients, the clip, the Adam step.
    Returns the loss terms and the gradients' global norm (device
    tensors, detached)."""
    opt.zero_grad(set_to_none=False)
    loss, metrics = loss_fn(core, frames, source_id)
    loss.backward()
    for t in leaves.values():
        if t.grad is None:  # a leaf off the loss's graph: a zero gradient,
            t.grad = torch.zeros_like(t)  # which Adam steps, as optax does
    grads = [t.grad for t in leaves.values()]
    metrics["grad_norm"] = clip_by_global_norm(grads)
    opt.step()
    return {k: v.detach() for k, v in metrics.items()}
