"""Symmetric int8 quantization, shared by the W8A8 conv and the W8A8 warp.

The scheme of ``canonswap_tpu/ops/qconv.py::_quantize_act`` /
``_quantize_weight`` and of the quantized slab in
``canonswap_tpu/ops/pallas/warp.py``:

- step ``s = max|v| / 127 + 1e-12`` in f32, over the reduced axes;
- ``q = clip(round(v_f32 / s), -127, 127)``, an IEEE division and round half
  to even (``jnp.round`` and ``torch.round`` agree).

The step is computed as XLA evaluates the jitted JAX expression: the
division by the constant 127 becomes a multiplication by its f32 reciprocal,
fused with the ``+ 1e-12`` into one multiply-add.  So the steps agree bit
for bit with the reference as it runs under ``jax.jit``.  The division by
the step stays a division on both sides.
"""

from __future__ import annotations

import torch

# f32(1/127): XLA's folded reciprocal, and the W8A8 warp's dequant constant
INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
EPS = torch.tensor(1e-12, dtype=torch.float32).item()


def absmax_step(absmax: torch.Tensor) -> torch.Tensor:
    """max|v| -> the quantization step ``max / 127 + 1e-12`` in f32, as the
    fused multiply-add ``fma(max, f32(1/127), 1e-12)`` XLA makes of it (in
    f64, where the product is exact, then rounded to f32)."""
    return (absmax.double() * INV127 + EPS).float()


def quantize(v: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """``clip(round(v_f32 / step), -127, 127)`` as int8; ``step``
    broadcasts against ``v``."""
    return torch.clamp(torch.round(v.float() / step), -127, 127).to(torch.int8)


def sample_step(x: torch.Tensor) -> torch.Tensor:
    """(N, ...) -> (N,) f32 per-sample steps over all other axes."""
    dims = tuple(range(1, x.dim()))
    return absmax_step(torch.linalg.vector_norm(x, float("inf"), dim=dims))


def quantize_weight(weight: torch.Tensor):
    """(Cout, Cin, *k) -> (int8 weight, (Cout,) f32 steps): one step per
    output channel, from the weight as stored (bf16 under half precision,
    as the JAX package quantizes its bf16 params)."""
    step = sample_step(weight)
    return quantize(weight, step.view(-1, *([1] * (weight.dim() - 1)))), step
